"""Port parity for the wavefront engine and its relax kernel.

The port's plain relax twin must reach the JAX relaxation's fixed point bit
for bit, and the JAX Pallas kernel's (run in interpret mode, as
tests/test_pallas_kernels.py runs it); find_paths(use_pallas=True) must
return the same PathBatch. On the CPU the kernel's wrapper runs the twin;
the CUDA kernel itself is held against the twin by the tests marked
``cuda`` (they skip without a card) and by chip_smoke.py.

The CUDA kernel does not sweep in Jacobi order: it walks whole lines
sequentially, all lines at once. A slow numpy emulation of that update
order, under two schedules of the lines, must give the twin's field bit for
bit; it guards the argument the kernel's design rests on.

relax_sweep (the default of find_paths) re-associates the float32 sums along
a straight run, here by log-step doubling, in JAX by its associative scan,
so it is not bit-equal to relax or to the JAX relax_sweep. Tolerance, JAX's
own (tests/test_tpu_ops.py): the same reachability, rtol 1e-6 and atol 2e-3
on reachable states, and identical backtraced cells, lengths and validity.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.golden.pipeline import GoldenReplayPipeline  # noqa: E402
from vision_assist_tpu.io.scenarios import load_scenario, scenario_names  # noqa: E402
from vision_assist_tpu.ops import lattice as jlattice  # noqa: E402
from vision_assist_tpu.ops import peaks as jpeaks  # noqa: E402
from vision_assist_tpu.ops.pallas_wavefront import relax_pallas  # noqa: E402
from vision_assist_tpu.planning import wavefront as jwave  # noqa: E402
from vision_assist_tpu_torch.ops import cuda_wavefront  # noqa: E402
from vision_assist_tpu_torch.planning import wavefront  # noqa: E402

torch.set_num_threads(2)

SCENARIOS = scenario_names()
TURN_WEIGHT = 1e-4  # PathFinderConfig.wavefront_turn_weight


@pytest.fixture(scope="module")
def inputs():
    """Per scenario: walkable, float32 penalty, start, goals, goal validity."""
    out = {}
    for name in SCENARIOS:
        gold = GoldenReplayPipeline().process(load_scenario(name))
        walk = np.asarray(gold.walkable)
        pen = np.asarray(gold.penalty, np.float32)
        start = np.asarray(jwave.closest_walkable_cell(
            jnp.asarray(walk), jnp.asarray([360, 1280])))
        pk = jpeaks.find_peaks(jlattice.rasterize_cells(jnp.asarray(walk)))
        goals = np.stack([np.asarray(jwave.closest_walkable_cell(
            jnp.asarray(walk), jnp.asarray([x, y])))
            for x, y in zip(np.asarray(pk.centre_x), np.asarray(pk.centre_y))])
        out[name] = (walk, pen, start, goals, np.asarray(pk.valid))
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", SCENARIOS)
def test_relax_twin_bit_equal_to_jax_and_pallas(inputs, name):
    walk, pen, start, _, _ = inputs[name]
    ref = np.asarray(jwave.relax(jnp.asarray(walk), jnp.asarray(pen),
                                 jnp.asarray(start), angle_weight=TURN_WEIGHT))
    pal = np.asarray(relax_pallas(jnp.asarray(walk), jnp.asarray(pen),
                                  jnp.asarray(start), interpret=True))
    out = wavefront.relax(_t(walk), _t(pen), _t(start),
                          angle_weight=TURN_WEIGHT).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pal)
    # the kernel's wrapper on a CPU tensor is the same twin
    np.testing.assert_array_equal(
        cuda_wavefront.relax_cuda(_t(walk), _t(pen), _t(start)).numpy(), ref)


@pytest.mark.parametrize("name", SCENARIOS)
def test_find_paths_use_pallas_matches_jax(inputs, name):
    walk, pen, start, goals, gvalid = inputs[name]
    ref = jwave.find_paths(jnp.asarray(walk), jnp.asarray(pen),
                           jnp.asarray(start), jnp.asarray(goals),
                           jnp.asarray(gvalid), angle_weight=TURN_WEIGHT,
                           use_pallas=True)
    out = wavefront.find_paths(_t(walk), _t(pen), _t(start), _t(goals),
                               _t(gvalid), angle_weight=TURN_WEIGHT,
                               use_pallas=True)
    assert np.asarray(ref.valid).any()
    for f in ("cells", "lengths", "costs", "valid"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_find_paths_unreachable_and_invalid_goals():
    """An unreachable goal gives an invalid, -1 padded path of cost INF; an
    invalid goal keeps its traced cells but reports length 0 — as in JAX."""
    walk = np.zeros((8, 10), bool)
    walk[7, :6] = walk[2:8, 2] = True
    walk[0, 8] = walk[1, 8] = True                     # island
    pen = np.linspace(0, 1, 80, dtype=np.float32).reshape(8, 10) * walk
    start = np.array([7, 0], np.int32)
    goals = np.array([[2, 2], [0, 8], [7, 5], [7, 0]], np.int32)
    gvalid = np.array([True, True, False, True])
    ref = jwave.find_paths(jnp.asarray(walk), jnp.asarray(pen),
                           jnp.asarray(start), jnp.asarray(goals),
                           jnp.asarray(gvalid), angle_weight=TURN_WEIGHT,
                           max_len=16, use_pallas=True)
    out = wavefront.find_paths(_t(walk), _t(pen), _t(start), _t(goals),
                               _t(gvalid), angle_weight=TURN_WEIGHT,
                               max_len=16, use_pallas=True)
    for f in ("cells", "lengths", "costs", "valid"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert out.valid.tolist() == [True, False, False, True]


def test_backtrace_past_max_len_is_invalid():
    """A path longer than max_len is reported invalid, as in JAX."""
    walk = np.ones((1, 12), bool)
    pen = np.zeros((1, 12), np.float32)
    start, goals = np.array([0, 0]), np.array([[0, 11]])
    kw = dict(angle_weight=TURN_WEIGHT, max_len=8, use_pallas=True)
    ref = jwave.find_paths(jnp.asarray(walk), jnp.asarray(pen), jnp.asarray(start),
                           jnp.asarray(goals), jnp.asarray([True]), **kw)
    out = wavefront.find_paths(_t(walk), _t(pen), _t(start), _t(goals),
                               torch.tensor([True]), **kw)
    for f in ("cells", "lengths", "costs", "valid"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert not bool(out.valid[0])


def test_relax_field_batch_equals_single_streams(inputs):
    names = SCENARIOS[:4]
    turn = wavefront._scaled_turn(20, TURN_WEIGHT, 30.0, 1.5, 90.0)
    enter = torch.stack([wavefront.enter_cost(_t(inputs[n][0]), _t(inputs[n][1]),
                                              20, 0.5) for n in names])
    start = torch.stack([_t(inputs[n][2]) for n in names])
    dist, sweeps = wavefront.relax_field(enter, start, turn)
    for i in range(len(names)):
        one, s1 = wavefront.relax_field(enter[i:i + 1], start[i:i + 1], turn)
        np.testing.assert_array_equal(dist[i].numpy(), one[0].numpy())
        assert int(sweeps[i]) == int(s1[0]) > 1


def test_cpu_wrapper_counts_no_launch(inputs):
    walk, pen, start, _, _ = inputs["right_turn"]
    cuda_wavefront.reset_launches()
    cuda_wavefront.relax_cuda(_t(walk), _t(pen), _t(start))
    assert cuda_wavefront.launches == 0


# --- relax_sweep, the default relaxation -------------------------------------------


def _assert_same_field(got, ref, name):
    reach = ref < 1e30
    assert (got[~reach] > 1e30).all(), name
    np.testing.assert_allclose(got[reach], ref[reach], rtol=1e-6, atol=2e-3,
                               err_msg=name)


@pytest.mark.parametrize("name", SCENARIOS)
def test_relax_sweep_matches_jax_and_backtraces_like_relax(inputs, name):
    walk, pen, start, goals, _ = inputs[name]
    ref = np.asarray(jwave.relax_sweep(jnp.asarray(walk), jnp.asarray(pen),
                                       jnp.asarray(start), angle_weight=TURN_WEIGHT))
    swept = wavefront.relax_sweep(_t(walk), _t(pen), _t(start),
                                  angle_weight=TURN_WEIGHT)
    plain = wavefront.relax(_t(walk), _t(pen), _t(start), angle_weight=TURN_WEIGHT)
    _assert_same_field(swept.numpy(), ref, name)
    _assert_same_field(swept.numpy(), plain.numpy(), name)
    a = wavefront.backtrace(swept, _t(start), _t(goals), angle_weight=TURN_WEIGHT)
    b = wavefront.backtrace(plain, _t(start), _t(goals), angle_weight=TURN_WEIGHT)
    for got, want, f in zip(a, b, ("cells", "lengths", "costs", "valid")):
        if f != "costs":
            np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=f)


@pytest.mark.parametrize("name", SCENARIOS)
def test_find_paths_default_flags_match_jax(inputs, name):
    walk, pen, start, goals, gvalid = inputs[name]
    ref = jwave.find_paths(jnp.asarray(walk), jnp.asarray(pen),
                           jnp.asarray(start), jnp.asarray(goals),
                           jnp.asarray(gvalid), angle_weight=TURN_WEIGHT)
    out = wavefront.find_paths(_t(walk), _t(pen), _t(start), _t(goals),
                               _t(gvalid), angle_weight=TURN_WEIGHT)
    assert np.asarray(ref.valid).any()
    for f in ("cells", "lengths", "valid"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(out.costs.numpy(), np.asarray(ref.costs),
                               rtol=1e-6, atol=2e-3)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (6, 1), (7, 5), (33, 65)])
def test_relax_sweep_odd_shapes_match_jax(shape):
    rows, cols = shape
    rng = np.random.default_rng(rows * 100 + cols)
    walk = rng.random((rows, cols)) < 0.7
    pen = rng.random((rows, cols)).astype(np.float32) * walk
    start = np.array([rng.integers(0, rows), rng.integers(0, cols)], np.int32)
    walk[start[0], start[1]] = True
    ref = np.asarray(jwave.relax_sweep(jnp.asarray(walk), jnp.asarray(pen),
                                       jnp.asarray(start), angle_weight=TURN_WEIGHT))
    out = wavefront.relax_sweep(_t(walk), _t(pen), _t(start),
                                angle_weight=TURN_WEIGHT).numpy()
    _assert_same_field(out, ref, str(shape))


# --- the CUDA kernel's update order, emulated --------------------------------------


def _emulate_line_kernel(enter, start, turn, lockstep):
    """The relax kernel's passes in numpy float32 scalars: one chain per
    (direction, line) walks its line in the direction of travel, carrying
    its own direction's value and reading the other three directions at the
    parent cell from the shared state. ``lockstep`` advances every chain one
    cell at a time, all reading the state as it was before that step; else
    the chains run one after another. Both are orders the card may take."""
    f32, inf = np.float32, np.float32(wavefront.INF)
    rows, cols = enter.shape
    ent = np.full((rows + 2, cols + 2), inf, f32)
    ent[1:-1, 1:-1] = enter
    dist = np.full((4, rows + 2, cols + 2), inf, f32)
    dist[:, start[0] + 1, start[1] + 1] = 0
    chains = []
    for d, (dr, dc) in enumerate(wavefront.MOVES):
        for line in range(rows if dc else cols):
            along = range(cols if dc else rows)
            if dr + dc < 0:
                along = reversed(along)
            chains.append((d, [(line + 1, j + 1) if dc else (j + 1, line + 1)
                               for j in along]))

    def step(d, cell, x, seen):
        dr, dc = wavefront.MOVES[d]
        parent = (cell[0] - dr, cell[1] - dc)
        g = min(f32(seen[o][parent] + turn[o, d]) for o in range(4) if o != d)
        e, old = ent[cell], dist[d][cell]
        new = min(old, f32(g + e), f32(f32(x + turn[d, d]) + e))
        dist[d][cell] = new
        return new, new < old

    passes = 0
    with np.errstate(over="ignore"):
        while True:
            passes += 1
            changed = False
            if lockstep:
                carried = [inf] * len(chains)
                for j in range(max(rows, cols)):
                    seen = dist.copy()
                    for k, (d, cells) in enumerate(chains):
                        if j < len(cells):
                            carried[k], ch = step(d, cells[j], carried[k], seen)
                            changed |= ch
            else:
                for d, cells in chains:
                    x = inf
                    for cell in cells:
                        x, ch = step(d, cell, x, dist)
                        changed |= ch
            if not changed:
                return dist[:, 1:-1, 1:-1].transpose(1, 2, 0), passes


@pytest.mark.parametrize("lockstep", [True, False], ids=["lockstep", "one_by_one"])
@pytest.mark.parametrize("shape", [(5, 3), (7, 11), (9, 4), (12, 13)])
def test_line_order_emulation_bit_equal_to_twin(shape, lockstep):
    rows, cols = shape
    rng = np.random.default_rng(rows * 31 + cols)
    walk = rng.random((rows, cols)) < 0.7
    pen = rng.random((rows, cols)).astype(np.float32) * walk
    start = np.array([rng.integers(0, rows), rng.integers(0, cols)])
    walk[start[0], start[1]] = True
    # a turn weight large enough for turns to decide between paths
    turn = wavefront._scaled_turn(20, 0.05, 30.0, 1.5, 90.0)
    enter = wavefront.enter_cost(_t(walk), _t(pen), 20, 0.5)
    ref, sweeps = wavefront.relax_field(enter[None], _t(start)[None], turn)
    got, passes = _emulate_line_kernel(enter.numpy(), start, turn.numpy(), lockstep)
    np.testing.assert_array_equal(got, ref[0].numpy())
    assert (ref[0].numpy() < 1e30).sum() > 4          # the start is not alone
    assert passes <= int(sweeps[0])


# --- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the relax kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32), (64, 36), (20, 27), (3, 70)])
def test_relax_kernel_bit_equal_to_twin_on_card(cuda, shape):
    rows, cols = shape
    rng = np.random.default_rng(rows)
    b = 8
    walk = rng.random((b, rows, cols)) < 0.7
    pen = rng.random((b, rows, cols)).astype(np.float32) * walk
    start = np.stack([rng.integers(0, rows, b), rng.integers(0, cols, b)], -1)
    walk[np.arange(b), start[:, 0], start[:, 1]] = True
    turn = wavefront._scaled_turn(20, TURN_WEIGHT, 30.0, 1.5, 90.0, cuda)
    enter = wavefront.enter_cost(_t(walk).to(cuda), _t(pen).to(cuda), 20, 0.5)
    start_t = _t(start).to(cuda, torch.int32)
    cuda_wavefront.reset_launches()
    got, sweeps = cuda_wavefront.relax_field_cuda(enter, start_t, turn)
    torch.cuda.synchronize()
    assert cuda_wavefront.launches == 1
    ref, ref_sweeps = wavefront.relax_field(enter, start_t, turn)
    assert torch.equal(got, ref)
    # the kernel counts its own line passes: never more than Jacobi sweeps
    assert bool((sweeps >= 1).all()) and bool((sweeps <= ref_sweeps).all())
