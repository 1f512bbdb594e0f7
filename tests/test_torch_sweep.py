"""Port parity for the fast-sweeping relaxation and its CUDA kernel.

The plain twin ``relax_sweep_field`` is held against JAX's ``relax_sweep``
under JAX's own tolerance (tests/test_tpu_ops.py, as
tests/test_torch_wavefront.py holds ``relax_sweep``: the same reachability,
rtol 1e-6 and atol 2e-3 on reachable states): the twin's doubling scan and
JAX's associative scan associate the float32 sums along a run differently.
The port's ``relax_sweep`` on CPU tensors is the twin, bit for bit.

The CUDA kernel (``csrc/relax_sweep.cu``) keeps a line of a scan in one warp,
position p = lane + 32*slot, and takes each level's partner by a shuffle or
from another slot. A numpy emulation of exactly that index arithmetic and
that level order must give the twin's field and pass counts bit for bit, on
odd shapes and on the 54x96 lattice of a 1080x1920 frame; it guards the
argument the kernel's bit-equality rests on. The kernel itself is held
against the twin by the tests marked ``cuda`` (they skip without a card) and
by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.golden.pipeline import GoldenReplayPipeline  # noqa: E402
from vision_assist_tpu.io.scenarios import load_scenario, scenario_names  # noqa: E402
from vision_assist_tpu.planning import wavefront as jwave  # noqa: E402
from vision_assist_tpu_torch.ops import cuda_sweep, cuda_wavefront  # noqa: E402
from vision_assist_tpu_torch.planning import wavefront  # noqa: E402

torch.set_num_threads(2)

TURN_WEIGHT = 1e-4  # PathFinderConfig.wavefront_turn_weight
WARP = 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _lattices(rows, cols, b, seed, density=0.7):
    """walkable (b, rows, cols), float32 penalty, start (b, 2), seeded."""
    rng = np.random.default_rng(seed)
    walk = rng.random((b, rows, cols)) < density
    pen = rng.random((b, rows, cols)).astype(np.float32) * walk
    start = np.stack([rng.integers(0, rows, b), rng.integers(0, cols, b)], -1)
    walk[np.arange(b), start[:, 0], start[:, 1]] = True
    return walk, pen, start.astype(np.int32)


def _field_inputs(walk, pen, start, turn_weight=TURN_WEIGHT, device="cpu"):
    turn = wavefront._scaled_turn(20, turn_weight, 30.0, 1.5, 90.0, device)
    enter = wavefront.enter_cost(_t(walk).to(device), _t(pen).to(device), 20, 0.5)
    return enter, _t(start).to(device), turn


def _assert_same_field(got, ref, name):
    reach = ref < 1e30
    assert (got[~reach] > 1e30).all(), name
    np.testing.assert_allclose(got[reach], ref[reach], rtol=1e-6, atol=2e-3,
                               err_msg=name)


@pytest.fixture(scope="module")
def scenarios():
    """Per scenario: walkable, float32 penalty, start."""
    out = {}
    for name in scenario_names():
        gold = GoldenReplayPipeline().process(load_scenario(name))
        walk = np.asarray(gold.walkable)
        start = np.asarray(jwave.closest_walkable_cell(
            jnp.asarray(walk), jnp.asarray([360, 1280])))
        out[name] = (walk, np.asarray(gold.penalty, np.float32), start)
    return out


# -- the plain twin ------------------------------------------------------------------


def test_twin_matches_jax_relax_sweep_and_is_the_cpu_path(scenarios):
    """All 13 scenarios as 13 streams of one twin call: each stream's field
    within JAX's tolerance of JAX's relax_sweep on that lattice, and the
    port's relax_sweep and the kernel's wrapper on CPU tensors give the
    twin's field bit for bit (the wrapper counts no launch)."""
    names = sorted(scenarios)
    walk, pen, start = (np.stack([scenarios[n][i] for n in names]) for i in range(3))
    enter, start_t, turn = _field_inputs(walk, pen, start)
    dist, passes = wavefront.relax_sweep_field(enter, start_t, turn)
    for i, name in enumerate(names):
        ref = np.asarray(jwave.relax_sweep(jnp.asarray(walk[i]), jnp.asarray(pen[i]),
                                           jnp.asarray(start[i]),
                                           angle_weight=TURN_WEIGHT))
        _assert_same_field(dist[i].numpy(), ref, name)
    assert torch.equal(wavefront.relax_sweep(_t(walk), _t(pen), _t(start),
                                             angle_weight=TURN_WEIGHT), dist)
    cuda_sweep.reset_launches()
    got, got_passes = cuda_sweep.relax_sweep_field_cuda(enter, start_t, turn)
    assert torch.equal(got, dist) and torch.equal(got_passes, passes)
    assert cuda_sweep.launches == 0
    assert passes.dtype == torch.int32 and bool((passes > 1).all())


@pytest.mark.parametrize("shape", [(1, 40), (40, 1), (7, 33), (32, 32)])
def test_twin_passes_are_each_streams_own(shape):
    """Streams that converge at different passes: in one batched call each
    stream's field and pass count are those of its call alone, and its
    count is the least cap that already gives the converged field, plus the
    pass that changed nothing."""
    rows, cols = shape
    walk, pen, start = _lattices(rows, cols, 4, seed=rows * 7 + cols, density=0.65)
    enter, start_t, turn = _field_inputs(walk, pen, start, turn_weight=0.05)
    dist, passes = wavefront.relax_sweep_field(enter, start_t, turn)
    for i in range(len(walk)):
        one, p1 = wavefront.relax_sweep_field(enter[i:i + 1], start_t[i:i + 1], turn)
        assert torch.equal(dist[i], one[0]) and int(passes[i]) == int(p1[0])
        needed = int(passes[i]) - 1
        if needed >= 1:
            capped, _ = wavefront.relax_sweep_field(enter[i:i + 1], start_t[i:i + 1],
                                                    turn, needed - 1)
            assert not torch.equal(capped[0], dist[i])
        capped, _ = wavefront.relax_sweep_field(enter[i:i + 1], start_t[i:i + 1], turn,
                                                max(needed, 0))
        assert torch.equal(capped[0], dist[i])
    assert len(set(passes.tolist())) > 1, passes.tolist()


@pytest.mark.parametrize("cap", [0, 1, 2, 3])
def test_twin_honours_max_passes(cap):
    """A cap of k passes gives each stream min(k, its own passes) and the
    field those passes leave, the same through relax_sweep(max_passes=k)."""
    walk, pen, start = _lattices(20, 27, 3, seed=11)
    enter, start_t, turn = _field_inputs(walk, pen, start, turn_weight=0.05)
    _, full = wavefront.relax_sweep_field(enter, start_t, turn)
    dist, passes = wavefront.relax_sweep_field(enter, start_t, turn, cap)
    assert passes.tolist() == [min(cap, int(p)) for p in full]
    assert torch.equal(wavefront.relax_sweep(_t(walk), _t(pen), _t(start),
                                             angle_weight=0.05, max_passes=cap), dist)
    for i in range(len(walk)):
        want = _emulate_sweep_kernel(enter[i].numpy(), start[i], turn.numpy(), cap)[0]
        np.testing.assert_array_equal(dist[i].numpy(), want)
    if cap == 0:
        assert bool((dist[dist != 0] == wavefront.INF).all())


@pytest.mark.parametrize("max_iters", [None, 1, 5])
def test_relax_on_the_cpu_is_unchanged(scenarios, max_iters):
    """``relax`` on CPU tensors is the Jacobi twin: JAX's relax bit for bit,
    with a cap of max_iters sweeps honoured as JAX honours it."""
    walk, pen, start = scenarios["right_turn"]
    ref = np.asarray(jwave.relax(jnp.asarray(walk), jnp.asarray(pen), jnp.asarray(start),
                                 angle_weight=TURN_WEIGHT, max_iters=max_iters))
    out = wavefront.relax(_t(walk), _t(pen), _t(start), angle_weight=TURN_WEIGHT,
                          max_iters=max_iters)
    np.testing.assert_array_equal(out.numpy(), ref)
    enter, start_t, turn = _field_inputs(walk[None], pen[None], start[None])
    cuda_wavefront.reset_launches()
    twin, _ = wavefront.relax_field(enter, start_t, turn, max_iters)
    np.testing.assert_array_equal(twin[0].numpy(), ref)
    assert cuda_wavefront.launches == 0


# -- the CUDA kernel's rule, emulated ----------------------------------------------------


def _partners(x, s, has):
    """Each slot position's partner s positions behind it in scan order,
    taken as the kernel takes it: x (lines, J, 32) with position
    p = lane + 32*j. For s < 32 a shuffle from lane (lane - s) mod 32, of
    slot j for lane >= s and slot j - 1 below; for s >= 32 slot j - s/32 of
    the same lane. Positions without a partner (``~has``) get NaN, which the
    caller must not use."""
    out = np.full_like(x, np.nan)
    lane = np.arange(WARP)
    if s < WARP:
        sh = np.roll(x, s, axis=-1)          # sh[..., l] = x[..., (l - s) mod 32]
        out[..., lane >= s] = sh[..., lane >= s]
        out[:, 1:, lane < s] = sh[:, :-1, lane < s]
    else:
        m = s // WARP
        out[:, m:] = x[:, :-m]
    assert not np.isnan(out[has]).any()
    return out


def _emulate_sweep_kernel(enter, start, turn, max_passes=None):
    """One stream of csrc/relax_sweep.cu in numpy float32: per pass the four
    scans right, left, down, up; in a scan each line of that direction laid
    out over (slot, lane), h at each cell, the one-step shift, then the
    doubling levels over (a, b) while s < n, every sum one float32
    addition. Only the lines the kernel's need flags mark are written (a
    line is marked when a cell of it changes, cleared when it is scanned);
    the scan of the others is computed too and must change nothing, which
    is the argument the kernel's skip rests on. Returns (dist (R, C, 4),
    passes, scans): scans the line scans run, of rows and of columns, as the
    kernel counts them."""
    f32 = np.float32
    inf = f32(wavefront.INF)
    rows, cols = enter.shape
    n_slots = -(-max(rows, cols) // WARP)
    dist = np.full((4, rows, cols), inf, f32)
    dist[:, start[0], start[1]] = 0
    need = np.ones((4, max(rows, cols)), bool)
    p = np.arange(WARP)[None, :] + WARP * np.arange(n_slots)[:, None]   # (J, 32)
    passes = 0
    scans = [0, 0]
    if max_passes is None:
        max_passes = rows * cols
    with np.errstate(over="ignore", invalid="ignore"):
        while passes < max_passes:
            passes += 1
            changed = False
            for d in range(4):
                across, rev = d < 2, d in (1, 3)
                n = cols if across else rows
                valid = p < n
                q = np.where(valid, (n - 1 - p) if rev else p, 0)      # index in line

                def lay(x, fill):
                    lines = x if across else x.T                       # (lines, n)
                    return np.where(valid, lines[:, q], fill).astype(f32)

                xs = [lay(dist[k], inf) for k in range(4)]
                h = np.minimum(np.minimum(xs[0] + turn[0, d], xs[1] + turn[1, d]),
                               np.minimum(xs[2] + turn[2, d], xs[3] + turn[3, d]))
                old = xs[d]
                b = lay(enter, f32(0))
                has = np.broadcast_to(valid & (p >= 1), old.shape)
                a = np.where(has, np.minimum(old, _partners(h, 1, has) + b), old)
                s = 1
                while s < n:
                    has = np.broadcast_to(valid & (p >= s), old.shape)
                    a_s, b_s = _partners(a, s, has), _partners(b, s, has)
                    a, b = (np.where(has, np.minimum(a, a_s + b), a),
                            np.where(has, b + b_s, b))
                    s *= 2
                moved = (a != old)[:, valid]                          # (lines, n)
                run = need[d, :len(moved)].copy()
                scans[0 if across else 1] += int(run.sum())
                assert not moved[~run].any(), "a skipped line would have changed"
                need[d, :len(moved)] = False
                changed |= bool(moved.any())
                lines = dist[d] if across else dist[d].T               # a view
                lines[np.ix_(np.flatnonzero(run), q[valid])] = a[:, valid][run]
                need[d & 2:(d & 2) + 2, :len(moved)] |= moved.any(axis=1)
                cross = 2 if across else 0
                need[cross:cross + 2, q[valid]] |= moved.any(axis=0)
            if not changed:
                break
    return dist.transpose(1, 2, 0), passes, scans


@pytest.mark.parametrize("shape", [(1, 40), (1, 70), (40, 1), (7, 33), (33, 7),
                                   (32, 32), (54, 96)])
def test_kernel_level_order_emulation_bit_equal_to_twin(shape):
    """The kernel's rule (slot layout, shuffles, level order, a stream's own
    early exit) against the twin on the same streams in one batched call:
    field and pass counts bit-equal. 1 x 70 and 54 x 96 have lines longer
    than a warp (slots and shifts of 32 and 64)."""
    rows, cols = shape
    b = 2 if rows * cols > 2000 else 3
    walk, pen, start = _lattices(rows, cols, b, seed=rows * 1000 + cols)
    enter, start_t, turn = _field_inputs(walk, pen, start, turn_weight=0.05)
    ref, ref_passes = wavefront.relax_sweep_field(enter, start_t, turn)
    for i in range(b):
        got, passes, scans = _emulate_sweep_kernel(enter[i].numpy(), start[i],
                                                   turn.numpy())
        np.testing.assert_array_equal(got, ref[i].numpy())
        assert passes == int(ref_passes[i])
        # the first pass scans every line; no pass scans more
        for ran, lines in zip(scans, (2 * rows, 2 * cols)):
            assert lines <= ran <= lines * passes
    assert (ref.numpy() < 1e30).sum() > 4 * b          # the starts are not alone


def test_kernel_emulation_on_the_1080p_corridor():
    """The corridor of tests/test_1080p_pipeline.py on its 54x96 lattice,
    with the served turn weight: the emulation's field and passes are the
    twin's."""
    occ = np.zeros((54, 96), bool)
    occ[20:54, 40:56] = True
    occ[20:30, 40:76] = True
    pen = np.where(occ, np.linspace(0, 1, 54 * 96, dtype=np.float32).reshape(54, 96), 0)
    start = np.array([53, 47], np.int32)
    enter, start_t, turn = _field_inputs(occ[None], pen[None].astype(np.float32),
                                         start[None])
    ref, ref_passes = wavefront.relax_sweep_field(enter, start_t, turn)
    got, passes, scans = _emulate_sweep_kernel(enter[0].numpy(), start, turn.numpy())
    np.testing.assert_array_equal(got, ref[0].numpy())
    assert passes == int(ref_passes[0]) >= 2
    # the need flags skip lines: fewer scans than every line of every pass
    assert scans[0] < 2 * 54 * passes and scans[1] < 2 * 96 * passes


# -- the wrapper and its operator --------------------------------------------------------


def test_wrapper_raises_off_the_cpu_and_the_card():
    walk, pen, start = _lattices(6, 7, 2, seed=3)
    enter, start_t, turn = _field_inputs(walk, pen, start)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_sweep.relax_sweep_field_cuda(enter.to("meta"), start_t.to("meta"),
                                          turn.to("meta"))


def _fake_cuda(*tensors):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return mode, [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in tensors]


def test_the_card_path_is_one_operator_with_no_host_sync():
    """Traced with CUDA tensors (fake ones: no card needed), relax_sweep is
    the entry costs and one call of the kernel's operator: no loop, so no
    host sync, and a CUDA graph can capture it. The fake gives the twin's
    shapes and dtypes. Lines longer than the kernel takes raise before any
    launch."""
    from torch.fx.experimental.proxy_tensor import make_fx

    walk, pen, start = _lattices(32, 32, 8, seed=5)
    mode, (w, p, s, big, turn) = _fake_cuda(_t(walk), _t(pen), _t(start),
                                            torch.zeros(1, 8, 300), torch.zeros(4, 4))
    with mode:
        graph = make_fx(lambda w, p, s: wavefront.relax_sweep(
            w, p, s, angle_weight=TURN_WEIGHT), tracing_mode="fake")(w, p, s).graph
        dist = wavefront.relax_sweep(w, p, s, angle_weight=TURN_WEIGHT)
        with pytest.raises(ValueError, match="lines of 1 to 256"):
            cuda_sweep.relax_sweep_field_cuda(big, s.narrow(0, 0, 1), turn)
    assert (dist.shape, dist.dtype) == ((8, 32, 32, 4), torch.float32)
    calls = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert sum("relax_sweep" in c for c in calls) == 1, calls
    assert not any(c.startswith(("aten._local_scalar_dense", "aten.item", "aten.any"))
                   for c in calls), calls
    assert cuda_sweep.launches == 0


# -- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the relax_sweep kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,b", [((32, 32), 1), ((32, 32), 8), ((54, 96), 1),
                                     ((64, 36), 13), ((1, 70), 3), ((70, 1), 3)])
def test_sweep_kernel_bit_equal_to_twin_on_card(cuda, shape, b):
    walk, pen, start = _lattices(*shape, b, seed=shape[0] + b)
    enter, start_t, turn = _field_inputs(walk, pen, start, device=cuda)
    cuda_sweep.reset_launches()
    got, passes = cuda_sweep.relax_sweep_field_cuda(enter, start_t, turn)
    torch.cuda.synchronize()
    assert cuda_sweep.launches == 1
    ref, ref_passes = wavefront.relax_sweep_field(enter, start_t, turn)
    assert torch.equal(got, ref) and torch.equal(passes, ref_passes)
    _, _, scans = torch.ops.vision_assist_tpu_torch.relax_sweep(
        enter, start_t.to(torch.int32), turn, shape[0] * shape[1])
    for i in range(b):
        want = _emulate_sweep_kernel(enter[i].cpu().numpy(), start[i],
                                     turn.cpu().numpy())[2]
        assert scans[i].tolist() == want
    capped, capped_passes = cuda_sweep.relax_sweep_field_cuda(enter, start_t, turn, 2)
    ref, ref_passes = wavefront.relax_sweep_field(enter, start_t, turn, 2)
    assert torch.equal(capped, ref) and torch.equal(capped_passes, ref_passes)


@pytest.mark.cuda
def test_relax_on_card_is_the_relax_kernel(cuda):
    walk, pen, start = _lattices(32, 32, 4, seed=9)
    args = (_t(walk).to(cuda), _t(pen).to(cuda), _t(start).to(cuda))
    cuda_wavefront.reset_launches()
    got = wavefront.relax(*args, angle_weight=TURN_WEIGHT)
    assert cuda_wavefront.launches == 1
    enter, start_t, turn = _field_inputs(walk, pen, start, device=cuda)
    assert torch.equal(got, wavefront.relax_field(enter, start_t, turn)[0])
    with pytest.raises(ValueError, match="max_iters"):
        wavefront.relax(*args, angle_weight=TURN_WEIGHT, max_iters=5)
