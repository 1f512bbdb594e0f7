"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of a run on the CPU (the harness's look for a
card skipped: ``run_cell`` on ``device="cpu"``) with one fault planted in
the port's serving objects before the window: an answer altered where it
is produced, a step that returns its state unchanged, half of a batch left
out. One card serves every cell, so there is no exchange between chips to
leave out. A sound run of the same cell comes out correct."""

import time

import pytest
from conftest import CPU_SEED, cpu_root

from benchmark.harness.runner import run_cell


def _run(root, cell, faults=None):
    line, checks = run_cell(root, cell, CPU_SEED, 1.5, False, "cpu", time.perf_counter(),
                            faults=faults)
    return line, {k: v for k, (v, _) in checks.items()}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cpu_root(tmp_path_factory.mktemp("faults"))


def alter_an_answer(loop):
    other = {"move_left": "move_right", "move_right": "continue_forward",
             "continue_forward": "move_left"}
    if loop.traffic["serving"] == "batched":
        retire = loop.processor.retire_frames

        def altered(handle, now_ms=0):
            out = retire(handle, now_ms)
            out[-1].final_answer = other[out[-1].final_answer]
            return out
        loop.processor.retire_frames = altered
    else:
        retire = loop.processor.retire_frame

        def altered(handle, now_ms=None, frame=None):
            out = retire(handle, now_ms=now_ms, frame=frame)
            out.final_answer = other[out.final_answer]
            return out
        loop.processor.retire_frame = altered


def state_unchanged(loop):
    """The A* angle cache, the state one frame hands the next, comes back as
    it went in: the host engine starts empty every frame, the device cache
    is never replaced."""
    if loop.traffic["serving"] == "batched":
        fp = loop.processor._fps[0]
        run_program = fp._run_program

        def unchanged(frames, cache):
            handle, _ = run_program(frames, cache)
            return handle, cache
        fp._run_program = unchanged
    else:
        fp = loop.processor
        guidance = fp._guidance

        def fresh(payload, exact_engine=None):
            fp._exact = fp._make_exact_engine()
            return guidance(payload, exact_engine)
        fp._guidance = fresh


def half_the_batch(loop):
    """Only the first half of the streams' frames go up; the rest of the
    batch is filled with copies of them."""
    submit = loop.processor.submit_frames

    def half(frames):
        frames = frames.copy()
        h = len(frames) // 2
        frames[h:] = frames[:h]
        return submit(frames)
    loop.processor.submit_frames = half


@pytest.mark.parametrize("cell", ["cpu.sync", "cpu.batch2"])
def test_sound_run_is_correct(root, cell):
    line, numbers = _run(root, cell)
    assert line["correct"], numbers
    streams = 2 if cell == "cpu.batch2" else 1
    # the warm-up step and at least one step of the window, whatever the CPU's speed
    assert line["failed"] == 0 and line["attempted"] >= 2 * streams


@pytest.mark.parametrize("cell", ["cpu.sync", "cpu.batch2"])
def test_an_altered_answer_is_caught(root, cell):
    line, numbers = _run(root, cell, alter_an_answer)
    assert not line["correct"]
    assert numbers["answer_frames"] > 0


def then_a_pool(fault):
    """``fault`` planted, then a whole pool's frames (steps) served before the
    window: the stream carries its state through every scene after the
    fault, however few frames a loaded CPU answers in the window."""
    def planted(loop):
        fault(loop)
        for _ in range(len(loop.pool)):
            loop.run(0.0)
    return planted


@pytest.mark.parametrize("cell", ["cpu.sync", "cpu.batch2"])
def test_state_returned_unchanged_is_caught(root, cell):
    line, numbers = _run(root, cell, then_a_pool(state_unchanged))
    assert not line["correct"], numbers
    assert numbers["state_gap"] > 0


def test_half_the_batch_left_out_is_caught(root):
    line, numbers = _run(root, "cpu.batch2", half_the_batch)
    assert not line["correct"], numbers
    assert numbers["conf_gap"] > 0.5
