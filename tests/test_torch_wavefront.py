"""Port parity for the wavefront engine and its relax kernel.

The port's plain relax twin must reach the JAX relaxation's fixed point bit
for bit, and the JAX Pallas kernel's (run in interpret mode, as
tests/test_pallas_kernels.py runs it); find_paths(use_pallas=True) must
return the same PathBatch. On the CPU the kernel's wrapper runs the twin;
the CUDA kernel itself is held against the twin by the tests marked
``cuda`` (they skip without a card) and by chip_smoke.py.
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


def test_cpu_wrapper_counts_no_launch_and_sweep_is_not_ported(inputs):
    walk, pen, start, goals, gvalid = inputs["right_turn"]
    cuda_wavefront.reset_launches()
    cuda_wavefront.relax_cuda(_t(walk), _t(pen), _t(start))
    assert cuda_wavefront.launches == 0
    with pytest.raises(NotImplementedError, match="relax_sweep"):
        wavefront.find_paths(_t(walk), _t(pen), _t(start), _t(goals), _t(gvalid))


# --- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the relax kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32), (64, 36)])
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
    assert torch.equal(sweeps, ref_sweeps)
