"""Whether what the timed path returned is right: every answered frame
held against the plain reference (``benchmark/reference``).

Segmenter: the reference runs its float32 chain on the pool's frames, and
each served frame's detections, best confidence and occupancy lattice are
held against its frame's. Whether a frame has a detection at all is a
threshold on a score, and bf16 moves scores by up to ``conf_gap``'s limit:
where the reference's highest score lies that close to the threshold and
the two sides land on either side of it, the frame's segmentation is not
compared. Everywhere else a frame detected on one side only reads as its
full confidence gap and its whole lattice differing.

Planner and answer: the reference follows
each stream in frame order from the program's own lattice (the lattice is
where bf16 and float32 may part by a cell, which would make every later
stage differ for a reason the segmenter's numbers already judge), carrying
its own A* angle cache and instruction memory, and each frame's fields,
peaks, paths and answer are held against the program's. So the planner's
input is the program's lattice and detection count: where that lattice
equals the reference's own, the frame is checked from the frame to the
answer; where it differs, ``occ_share`` judges the difference.

The numbers, each with its limit from ``benchmark/limits/<cell>.json``:

* ``conf_gap``: the largest |best confidence - the reference's| (0 where
  a side has no detection);
* ``occ_share``: lattice cells whose occupancy differs, over all compared
  frames, in % of the cells the reference occupies there. A per-frame
  worst case swings: the mask is cropped to its box, so a box edge that
  moves by a fraction of a pixel flips a cell whatever the precision;
* ``ndet_gap``: the largest |detections - the reference's|;
* ``plan_frames``: frames whose walkable or artificial cells, peaks or path
  cells differ from the reference's;
* ``answer_frames``: frames whose answer differs;
* ``field_gap``: the largest |penalty - the reference's| over every cell;
* ``cost_gap``: the largest relative gap of a path's cost;
* ``state_gap``: after the last frame, for the stream that differs most,
  the entries by which the program's A* angle cache outnumbers or falls
  short of the reference's, plus the instants of its instruction memory
  that differ from the reference's: the state each frame hands the next;
* ``missing``: frames submitted and never answered.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("conf_gap", "occ_share", "ndet_gap", "plan_frames",
           "answer_frames", "field_gap", "cost_gap", "state_gap", "missing")


def reference_segmentation(root, config: dict, pool: np.ndarray, device, quant=None,
                           block: int = 8):
    """The reference chain's SegOut for every frame of the pool."""
    from benchmark.reference.msgpack import load_variables
    from benchmark.reference.segment import ReferenceSegmenter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ReferenceSegmenter(config, load_variables(root / config["weights"]),
                             pool.shape[1:3], device, quant=quant)
    out = []
    for i in range(0, len(pool), block):
        out += ref(pool[i:i + block])
    del ref
    return out


def segmenter_numbers(answers, seg, conf_threshold: float, conf_limit: float) -> dict:
    conf = 0.0
    ndet = differ = occupied = 0
    for a in answers:
        r = seg[a.pool_index]
        if (a.n_detections > 0) != (r.n_detections > 0) \
                and abs(r.top_score - conf_threshold) <= conf_limit:
            continue
        conf = max(conf, abs(a.best_conf - r.best_conf))
        differ += int(np.count_nonzero(a.occupancy != r.occupancy))
        occupied += int(np.count_nonzero(r.occupancy))
        ndet = max(ndet, abs(a.n_detections - r.n_detections))
    share = 100.0 * differ / occupied if occupied else (100.0 if differ else 0.0)
    return {"conf_gap": conf, "occ_share": share, "ndet_gap": ndet}


def state_gap(program: dict, ref) -> int:
    """Cache entries and memory instants by which one stream's carried
    state differs from the reference planner's after the same frames."""
    from benchmark.harness.serve import memory_form

    gap = abs(program["cache_keys"] - len(ref.astar._angle_cache))
    mine, theirs = program["memory"], memory_form(ref.analyser.previous_instructions)
    return gap + sum(mine.get(t) != theirs.get(t) for t in set(mine) | set(theirs))


def planner_numbers(answers, frame_hw, grid_size: int, engine: str,
                    state: list | None = None) -> dict:
    """Replay each stream's frames in order through the reference planner;
    with ``state``, hold each stream's carried state against the replay's."""
    from benchmark.reference.plan import ReferencePlanner

    by_stream: dict[int, list] = {}
    for a in answers:
        by_stream.setdefault(a.stream, []).append(a)
    plan = answer = worst_state = 0
    field = cost = 0.0
    for stream, frames in by_stream.items():
        frames.sort(key=lambda a: a.seq)
        ref = ReferencePlanner(frame_hw, grid_size, device_astar=engine == "exact_device")
        for a in frames:
            r = ref.frame(a.occupancy, a.n_detections, a.now_ms)
            same = (np.array_equal(a.walkable, r.walkable)
                    and np.array_equal(a.artificial, r.artificial)
                    and a.peaks == r.peaks and len(a.paths) == len(r.paths)
                    and all(np.array_equal(p[0], q[0]) for p, q in zip(a.paths, r.paths)))
            plan += not same
            answer += a.answer != r.answer
            field = max(field, float(np.max(np.abs(a.penalty - r.penalty), initial=0.0)))
            for (_, cp), (_, cr) in zip(a.paths, r.paths):
                cost = max(cost, abs(cp - cr) / max(abs(cr), 1e-30))
        if state is not None:
            worst_state = max(worst_state, state_gap(state[stream], ref))
    return {"plan_frames": plan, "answer_frames": answer, "field_gap": field,
            "cost_gap": cost, "state_gap": worst_state}


def check(root, cell, pool, answers, attempted: int, device, state):
    """(correct, {number: (value, limit)}, the reference's SegOut for each pool
    frame) over every answered frame."""
    seg = reference_segmentation(root, cell.config, pool, device)
    numbers = segmenter_numbers(answers, seg, cell.config["conf_threshold"],
                                cell.limits["conf_gap"])
    numbers.update(planner_numbers(
        answers, (cell.traffic["frame_height"], cell.traffic["frame_width"]),
        cell.config["grid_size"], cell.traffic["engine"], state))
    numbers["missing"] = attempted - len(answers)
    checks = {k: (numbers[k], cell.limits.get(k, 0)) for k in NUMBERS}
    correct = bool(answers) and all(v <= lim for v, lim in checks.values())
    return correct, checks, seg
