"""``check.check`` of a configuration with trained weights, on a fixed set of
answers: the reference's own, with a fault planted in each of several, on
the four frames of the CPU's traffic. The keys and values are those that
the check gave before a configuration could name its reference module or
take seeded weights."""

import pytest
import torch
from conftest import CPU_SEED, cpu_root

from benchmark.harness import check as check_mod
from benchmark.harness.cell import load_cell
from benchmark.harness.frames import make_pool, stream_offsets
from benchmark.harness.serve import Answer
from benchmark.harness.weights import flax_tree
from benchmark.reference.plan import ReferencePlanner

BEFORE = {"conf_gap": 0.0030000000000000027, "occ_share": 0.0832870627429206,
          "ndet_gap": 1, "plan_frames": 3, "answer_frames": 3, "field_gap": 1.0,
          "cost_gap": 2.999999999994902e-06, "state_gap": 20, "missing": 2}


def fixed_answers(cell, pool, seg):
    """Each stream's frames as the reference segments and plans them."""
    t, g = cell.traffic, cell.config["grid_size"]
    out = []
    for s, off in enumerate(stream_offsets(t)):
        planner = ReferencePlanner((t["frame_height"], t["frame_width"]), g,
                                   t["engine"] == "exact_device")
        for seq in range(len(pool)):
            i = (off + seq) % len(pool)
            r = seg[i]
            p = planner.frame(r.occupancy, r.n_detections, seq * t["frame_interval_ms"])
            out.append(Answer(s, seq, i, seq * t["frame_interval_ms"], r.occupancy.copy(),
                              r.n_detections, r.best_conf, p.walkable, p.artificial,
                              p.penalty, p.peaks, p.paths, p.answer))
    return out


def test_a_trained_configuration_is_checked_as_before(tmp_path):
    root = cpu_root(tmp_path)
    cell = load_cell(root, "cpu.batch2")
    pool = make_pool(cell.traffic, CPU_SEED)
    device = torch.device("cpu")
    variables = flax_tree(root, cell.config, device)
    answers = fixed_answers(cell, pool, check_mod.reference_segmentation(
        root, cell.config, variables, pool, device))
    answers[1].best_conf += 0.003
    answers[2].occupancy[10, 5:8] = ~answers[2].occupancy[10, 5:8]
    answers[3].walkable = ~answers[3].walkable
    answers[4].answer = "move_right"
    answers[5].n_detections = 1
    answers[7].penalty = answers[7].penalty + 2e-6
    answers[7].paths = [(c, cost * (1 + 3e-6)) for c, cost in answers[7].paths]
    state = [{"cache_keys": 3, "memory": {}}, {"cache_keys": 0, "memory": {}}]
    correct, checks, _ = check_mod.check(root, cell, pool, variables, answers,
                                         len(answers) + 2, device, state)
    assert not correct
    assert list(checks) == list(BEFORE)
    for k, want in BEFORE.items():
        value, limit = checks[k]
        assert value == pytest.approx(want, rel=1e-9, abs=1e-12), k
        assert limit == cell.limits[k]
