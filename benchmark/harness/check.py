"""Whether what the timed path returned is right: every answered frame
held against the plain reference (``benchmark/reference``).

Segmenter: the reference runs its float32 chain on the pool's frames, and
each served frame's detections, best confidence and occupancy lattice are
held against its frame's. The chain after the model is the configuration's
head kind's (``reference.segment.chain_for``): an instance head (YOLO-seg;
``"head": "instance"`` or no key) is decoded, suppressed and masked, a
per-pixel head (``"head": "semantic"``) has its class logits sampled at
the cell centres. For an instance head, whether a frame has a detection at
all is a threshold on a score, and bf16 moves scores by up to
``conf_gap``'s limit: where the reference's highest score lies that close
to the threshold and the two sides land on either side of it, the frame's
segmentation is not compared. Everywhere else, and for a per-pixel head,
which has no threshold, on every frame, a frame detected on one side only
reads as its full confidence gap and its whole lattice differing.

Planner and answer: the reference follows
each stream in frame order from the program's own lattice (the lattice is
where bf16 and float32 may part by a cell, which would make every later
stage differ for a reason the segmenter's numbers already judge), carrying
its own A* angle cache and instruction memory, and each frame's fields,
peaks, paths and answer are held against the program's. So the planner's
input is the program's lattice and detection count: where that lattice
equals the reference's own, the frame is checked from the frame to the
answer; where it differs, ``occ_share`` judges the difference.

A configuration with seeded weights (``harness/weights.py``) has no
trained detector: its scores crowd the threshold (its class logits crowd
one another), and a bf16 model and a float32 one part on which anchors
pass it (which class wins a cell). So its model is judged before the
threshold, by ``head_gap``, and what follows the model on the timed path
(decode, the NMS, masks, the lattice; or the sampled logits, the lattice)
from the program's own head outputs: after the window the served module
runs once on each step's frames (``serve.served_outputs``), the
reference's chain after the model (``reference.segment.chain_for``) takes
its outputs, and each answered frame's detections, best confidence and
lattice are held against that of its step and stream, by the three
numbers a trained configuration uses. The planner numbers hold as for a
trained one.

The numbers, each with its limit from ``benchmark/limits/<cell>.json``:

* ``head_gap`` (seeded weights only): for each head output (an instance
  head's box logits, class logits, mask coefficients and prototypes; a
  per-pixel head's logits) and each pool frame, the largest |program -
  reference| over the reference's RMS there; the largest of these. The
  program's side is the served module run after the window on the steps'
  frames (``serve.served_outputs``);
* ``conf_gap``: the largest |best confidence - the reference's| (0 where
  a side has no detection; for a per-pixel head, the winning walkable
  class's probability at the most confident occupied cell);
* ``occ_share``: lattice cells whose occupancy differs, over all compared
  frames, in % of the cells the reference occupies there. A per-frame
  worst case swings: the mask is cropped to its box, so a box edge that
  moves by a fraction of a pixel flips a cell whatever the precision (and
  two classes whose sampled logits lie close part on any rounding);
* ``ndet_gap``: the largest |detections - the reference's| (for a
  per-pixel head 1 where one side occupies a cell and the other none);
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

import dataclasses
import types

import numpy as np
import torch

from benchmark.harness.weights import seeded
from benchmark.reference.segment import HEADS, ExactFloat32, chain_for, head_kind

NUMBERS = ("conf_gap", "occ_share", "ndet_gap", "plan_frames", "answer_frames",
           "field_gap", "cost_gap", "state_gap", "missing")
SEEDED_NUMBERS = ("head_gap",) + NUMBERS


def numbers_of(config: dict) -> tuple:
    """The numbers that judge a configuration's cells."""
    return SEEDED_NUMBERS if seeded(config) else NUMBERS


def conf_threshold(config: dict) -> float | None:
    """An instance head's confidence threshold; None for a per-pixel head."""
    return config["conf_threshold"] if head_kind(config) == "instance" else None


def reference_segmentation(root, config: dict, variables: dict, pool: np.ndarray, device,
                           quant=None, rounding=None, block: int = 8, heads: bool = False):
    """The reference chain's SegOut for every frame of the pool, by the
    configuration's reference module with the weights ``variables``; with
    ``heads``, each with its flat head outputs."""
    from benchmark.harness.cell import reference_module
    from benchmark.reference.segment import ReferenceSegmenter

    out = []
    with ExactFloat32():
        ref = ReferenceSegmenter(config, reference_module(root, config), variables,
                                 pool.shape[1:3], device, quant=quant, rounding=rounding)
        for i in range(0, len(pool), block):
            out += ref(pool[i:i + block], heads=heads)
    return out


def served_segmentation(config: dict, frame_hw, served, device) -> tuple[dict, dict]:
    """The reference's chain after the model on the program's own head
    outputs ``served`` ((step, the step's pool indices, the served module's
    outputs), ``serve.served_outputs``): ({(step, stream): SegOut}, {pool
    index: the program's flat head outputs there, from the first step that
    serves it})."""
    chain = chain_for(config, frame_hw, device)
    segs, heads = {}, {}
    for step, indices, outs in served:      # the program's pass, outside the block
        if head_kind(config) == "semantic":
            outs = types.SimpleNamespace(logits=outs.logits.float())
        else:
            outs = types.SimpleNamespace(
                strides=outs.strides, protos=outs.protos.float(),
                **{h: [x.float() for x in getattr(outs, h)] for h in HEADS[:3]})
        with ExactFloat32():
            ref = chain.segment(outs, heads=True)
        for stream, (i, seg) in enumerate(zip(indices, ref, strict=True)):
            heads.setdefault(i, seg.heads)
            segs[step, stream] = dataclasses.replace(seg, heads=None)
    return segs, heads


def head_gap(program: list, reference: list) -> float:
    """The largest |program - reference| over the reference's RMS, over
    each frame's flat head outputs (an instance head's four, a per-pixel
    head's logits)."""
    gap = 0.0
    for mine, theirs in zip(program, reference, strict=True):
        for p, r in zip(mine, theirs, strict=True):
            rms = float(torch.sqrt(torch.mean(r.double() ** 2)))
            gap = max(gap, float(torch.max(torch.abs(p.double() - r.double()))) / rms)
    return gap


def segmenter_numbers(answers, refs, conf_threshold: float | None,
                      conf_limit: float) -> dict:
    """Each answer held against its reference SegOut, ``refs`` in the
    answers' order; ``conf_threshold`` None (a per-pixel head, which has
    none) skips no frame."""
    conf = 0.0
    ndet = differ = occupied = 0
    for a, r in zip(answers, refs, strict=True):
        if conf_threshold is not None and (a.n_detections > 0) != (r.n_detections > 0) \
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


def check(root, cell, pool, variables, answers, attempted: int, device, state, served=None):
    """(correct, {number: (value, limit)}, the reference's SegOut for each pool
    frame) over every answered frame, the reference holding the weights the
    program was served (``variables``); ``served``, the reference's chain on
    the served module's outputs (``served_segmentation``), judges a seeded
    configuration's segmenter."""
    is_seeded = seeded(cell.config)
    seg = reference_segmentation(root, cell.config, variables, pool, device, heads=is_seeded)
    if is_seeded:
        by_step, heads = served
        numbers = {"head_gap": head_gap([heads[i] for i in range(len(pool))],
                                        [s.heads for s in seg])}
        refs = [by_step[a.seq % len(pool), a.stream] for a in answers]
    else:
        numbers, refs = {}, [seg[a.pool_index] for a in answers]
    numbers.update(segmenter_numbers(answers, refs, conf_threshold(cell.config),
                                     cell.limits["conf_gap"]))
    numbers.update(planner_numbers(
        answers, (cell.traffic["frame_height"], cell.traffic["frame_width"]),
        cell.config["grid_size"], cell.traffic["engine"], state))
    numbers["missing"] = attempted - len(answers)
    checks = {k: (numbers[k], cell.limits.get(k, 0)) for k in numbers_of(cell.config)}
    correct = bool(answers) and all(v <= lim for v, lim in checks.values())
    return correct, checks, seg
