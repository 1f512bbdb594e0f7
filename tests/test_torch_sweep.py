"""Port parity for the fast-sweeping relaxation and its CUDA kernel.

The plain twin ``relax_sweep_field`` is held against JAX's ``relax_sweep``
under JAX's own tolerance (tests/test_tpu_ops.py, as
tests/test_torch_wavefront.py holds ``relax_sweep``: the same reachability,
rtol 1e-6 and atol 2e-3 on reachable states): the twin's doubling scan and
JAX's associative scan associate the float32 sums along a run differently.
The port's ``relax_sweep`` on CPU tensors is the twin, bit for bit.

The CUDA kernel (``csrc/relax_sweep.cu``) runs a stream on a cluster of k
CTAs, each warp the owner of at most one row and one column for the whole
launch, position p = lane + 32*slot, and takes each level's partner by a
shuffle or from another slot; the b levels of the doubling scan are made
once a launch, and the two directions of a line longer than a warp read one
kept set. A numpy emulation of exactly that ownership, that index arithmetic
and that level order must give the twin's field, pass counts and line scans
bit for bit, on odd shapes and on the 54x96 lattice of a 1080x1920 frame, at
several k; it guards the argument the kernel's bit-equality rests on. The
kernel itself is held against the twin by the tests marked ``cuda`` (they
skip without a card) and by chip_smoke.py.
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


def _levels_as_read(lines, rev, registers):
    """The b levels of the doubling scan as the kernel reads them, made once
    before the first pass. ``lines`` (L, n) entry costs in cell order; the
    scan runs in reverse when ``rev``. Returns b[k] (L, J, 32) at position
    p = lane + 32*slot of the scan layout, NaN where the kernel reads
    nothing (no partner at shift 2**k, or p >= n). In ``registers`` (lines
    of at most 32 cells) each direction makes its own levels in its scan
    layout; otherwise the line makes one forward set, kept in shared memory
    as b[k][i] = the sum ending at cell i, and a reverse scan reads its
    position p at cell n - 2 - p + 2**k."""
    f32 = np.float32
    n_lines, n = lines.shape
    n_slots = -(-n // WARP)
    p = np.arange(WARP)[None, :] + WARP * np.arange(n_slots)[:, None]   # (J, 32)
    valid = p < n

    def lay(order):
        return np.where(valid, lines[:, np.where(valid, order, 0)], f32(0)).astype(f32)

    def doubled(b):
        out, k = [b], 1
        with np.errstate(over="ignore", invalid="ignore"):
            while 2 ** k < n:
                s = 2 ** (k - 1)
                has = np.broadcast_to(valid & (p >= s), b.shape)
                b = np.where(has, b + _partners(b, s, has), b)
                out.append(b)
                k += 1
        return out

    if registers:                             # each direction its own
        made = doubled(lay(n - 1 - p if rev else p))
    else:                                     # shared memory: one forward set
        kept = [x[:, valid] for x in doubled(lay(p))]   # (L, n) in cell order
        made = [lay(n - 1 - p if rev else p)]
        for k in range(1, len(kept)):
            at = np.clip(n - 2 - p + 2 ** k if rev else p, 0, n - 1)
            made.append(np.where(valid, kept[k][:, np.where(valid, at, 0)], f32(0)))
    return [np.where(valid & (p >= 2 ** k), x, np.nan).astype(f32)
            for k, x in enumerate(made)]


def _emulate_sweep_kernel(enter, start, turn, max_passes=None, k=1):
    """One stream of csrc/relax_sweep.cu in numpy float32, over a cluster of
    k CTAs. CTA r's warp w owns row r*ceil(R/k) + w and column
    r*ceil(C/k) + w for the whole launch; every CTA holds a replica of the
    field. The b levels are made once, before the first pass
    (``_levels_as_read``). Per pass the four scans right, left, down, up; in
    a scan each line of that direction is laid out over (slot, lane) from
    its owner's replica: h at each cell, the one-step shift, then the
    doubling levels over a while s < n, every sum one float32 addition.
    Only the lines whose need flag is set in their owner's memory are
    written, into every replica; a change sets the flags of the crossing
    lines in the CTAs that own them and both flags of its own line, and the
    vote in the leader; a scan clears its own flag. The scan of the other
    lines is computed too and must change nothing, which is the argument
    the kernel's skip rests on. A barrier ends each orientation's half of a
    pass (a warp runs its line's two directions back to back), and there
    the replicas are equal.
    Returns (dist (R, C, 4), passes, scans): scans the line scans run, of
    rows and of columns, as the kernel counts them."""
    f32 = np.float32
    inf = f32(wavefront.INF)
    rows, cols = enter.shape
    n_lines, length = (rows, cols), (cols, rows)
    per = (-(-rows // k), -(-cols // k))
    owner = [np.arange(n_lines[o]) // per[o] for o in range(2)]
    slot = [np.arange(n_lines[o]) % per[o] for o in range(2)]
    replica = np.full((k, 4, rows, cols), inf, f32)
    replica[:, :, start[0], start[1]] = 0
    need = np.ones((k, 2, max(per), 2), bool)      # need[cta][orientation][warp][dir]
    levels = {d: _levels_as_read(enter if d < 2 else enter.T, d in (1, 3),
                                 length[d >> 1] <= WARP and n_lines[d >> 1] <= 3 * WARP)
              for d in range(4)}
    vote = 0                                       # the leader's
    passes = 0
    scans = [0, 0]
    if max_passes is None:
        max_passes = rows * cols
    with np.errstate(over="ignore", invalid="ignore"):
        while passes < max_passes:
            passes += 1
            for d in range(4):
                o, rev = d >> 1, d & 1
                n = length[o]
                p = np.arange(WARP)[None, :] + WARP * np.arange(-(-n // WARP))[:, None]
                valid = p < n
                q = np.where(valid, (n - 1 - p) if rev else p, 0)      # index in line

                def lay(x, fill):
                    lines = x if o == 0 else np.swapaxes(x, -1, -2)    # (.., lines, n)
                    return np.where(valid, lines[..., q], fill).astype(f32)

                own = replica[owner[o]]                                # each line's owner's
                xs = [np.stack([lay(own[i, c], inf)[i] for i in range(n_lines[o])])
                      for c in range(4)]
                h = np.minimum(np.minimum(xs[0] + turn[0, d], xs[1] + turn[1, d]),
                               np.minimum(xs[2] + turn[2, d], xs[3] + turn[3, d]))
                old = xs[d]
                b = levels[d]
                has = np.broadcast_to(valid & (p >= 1), old.shape)
                a = np.where(has, np.minimum(old, _partners(h, 1, has) + lay(
                    enter, f32(0))), old)
                s, lk = 1, 0
                while s < n:
                    has = np.broadcast_to(valid & (p >= s), old.shape)
                    assert not np.isnan(b[lk][has]).any()
                    a = np.where(has, np.minimum(a, _partners(a, s, has) + b[lk]), a)
                    s, lk = 2 * s, lk + 1
                moved = (a != old)[:, valid]                          # (lines, n)
                run = need[owner[o], o, slot[o], rev]
                scans[o] += int(run.sum())
                assert not moved[~run].any(), "a skipped line would have changed"
                moved &= run[:, None]
                for r in range(k):                                   # every replica
                    lines = replica[r, d] if o == 0 else replica[r, d].T      # a view
                    lines[np.ix_(np.flatnonzero(run), q[valid])] = a[:, valid][run]
                any_moved = moved.any(axis=1)
                need[owner[o][run], o, slot[o][run], rev] = any_moved[run]
                need[owner[o][any_moved], o, slot[o][any_moved], 1 - rev] = True
                at = q[valid][moved.any(axis=0)]                       # crossing lines
                need[owner[1 - o][at], 1 - o, slot[1 - o][at], :] = True
                if any_moved.any():
                    vote = passes
                if rev:                                                # the barrier
                    assert (replica == replica[:1]).all()
            if vote < passes:
                break
    return replica[0].transpose(1, 2, 0), passes, scans


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("shape", [(1, 40), (1, 70), (40, 1), (7, 33), (33, 7),
                                   (32, 32), (54, 96)])
def test_kernel_level_order_emulation_bit_equal_to_twin(shape, k):
    """The kernel's rule (lines owned by (CTA, warp) over a cluster of k
    CTAs, slot layout, shuffles, levels made once, level order, a stream's
    own early exit, the cluster's vote) against the twin on the same streams
    in one batched call: field and pass counts bit-equal. 1 x 70 and 54 x 96
    have lines longer than a warp (slots and shifts of 32 and 64). The line
    scans do not depend on k."""
    rows, cols = shape
    b = 2 if rows * cols > 2000 else 3
    walk, pen, start = _lattices(rows, cols, b, seed=rows * 1000 + cols)
    enter, start_t, turn = _field_inputs(walk, pen, start, turn_weight=0.05)
    ref, ref_passes = wavefront.relax_sweep_field(enter, start_t, turn)
    for i in range(b):
        got, passes, scans = _emulate_sweep_kernel(enter[i].numpy(), start[i],
                                                   turn.numpy(), k=k)
        if k > 1:
            assert scans == _emulate_sweep_kernel(enter[i].numpy(), start[i],
                                                  turn.numpy(), k=1)[2]
        np.testing.assert_array_equal(got, ref[i].numpy())
        assert passes == int(ref_passes[i])
        # the first pass scans every line; no pass scans more
        for ran, lines in zip(scans, (2 * rows, 2 * cols)):
            assert lines <= ran <= lines * passes
    assert (ref.numpy() < 1e30).sum() > 4 * b          # the starts are not alone


def test_kernel_emulation_on_the_1080p_corridor():
    """The corridor of tests/test_1080p_pipeline.py on its 54x96 lattice,
    with the served turn weight, over the cluster the launch picks there:
    the emulation's field and passes are the twin's."""
    occ = np.zeros((54, 96), bool)
    occ[20:54, 40:56] = True
    occ[20:30, 40:76] = True
    pen = np.where(occ, np.linspace(0, 1, 54 * 96, dtype=np.float32).reshape(54, 96), 0)
    start = np.array([53, 47], np.int32)
    enter, start_t, turn = _field_inputs(occ[None], pen[None].astype(np.float32),
                                         start[None])
    ref, ref_passes = wavefront.relax_sweep_field(enter, start_t, turn)
    k = cuda_sweep.cluster_size(54, 96)
    assert 1 < k <= cuda_sweep.MAX_CLUSTER
    got, passes, scans = _emulate_sweep_kernel(enter[0].numpy(), start, turn.numpy(), k=k)
    np.testing.assert_array_equal(got, ref[0].numpy())
    assert passes == int(ref_passes[0]) >= 2
    # the need flags skip lines: fewer scans than every line of every pass
    assert scans[0] < 2 * 54 * passes and scans[1] < 2 * 96 * passes


@pytest.mark.parametrize("rows,cols", [(1, 1), (2, 3), (5, 31), (32, 32), (33, 7),
                                       (37, 63), (64, 65), (54, 96), (97, 129),
                                       (3, 255), (256, 2)])
def test_once_a_launch_levels_equal_scan_levels(rows, cols):
    """The b levels as the kernel makes them once a launch and reads them
    (in registers, its own set a direction, for lines of at most a warp; in
    shared memory one forward set, the reverse scan reading the sum of the
    same cells at cell n - 2 - p + 2**k) are the twin's _scan_levels, bit
    for bit, at every position a level reads, in all four directions; odd
    lengths too, and lines of at most a warp both ways."""
    rng = np.random.default_rng(rows * 1000 + cols)
    # costs with many significant bits, so that another association shows
    enter = (rng.random((rows, cols)) * 7 + 0.05).astype(np.float32)
    for d, (dr, dc) in enumerate(wavefront.MOVES.tolist()):
        lines = enter if dc else enter.T
        rev = dr + dc < 0
        ref = wavefront._scan_levels(torch.from_numpy(np.ascontiguousarray(lines)), rev)
        n = lines.shape[1]
        for registers in ((False, True) if n <= WARP else (False,)):
            got = _levels_as_read(lines, rev, registers)
            assert len(got) == len(ref) == max(1, _n_levels(n))
            p = np.arange(WARP)[None, :] + WARP * np.arange(-(-n // WARP))[:, None]
            cells = np.where(p < n, (n - 1 - p) if rev else p, 0)
            for level, (g, r) in enumerate(zip(got, ref)):
                read = ~np.isnan(g)
                assert read.sum() == lines.shape[0] * max(0, n - 2 ** level)
                np.testing.assert_array_equal(g[read], r.numpy()[:, cells][read],
                                              err_msg=f"direction {d} level {level}")


def _n_levels(n):
    """Doubling levels of a line of n cells: shifts 1, 2, 4, ... below n."""
    return int(np.ceil(np.log2(n))) if n > 1 else 0


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


def test_cluster_sizes_and_shared_memory():
    """The launch's cluster: between the fewest CTAs that give each warp at
    most one line a side and 8, its shared memory (a replica of the field
    and the levels of the CTA's own lines longer than a warp, level 0 the
    entry costs) within a CTA's. The served 32x32 lattice and the 1080p and
    1440p ones are taken by the shared form; 4K UHD (108x192, 192x108) is
    not, and the launch takes the global form there, at the fewest CTAs, its
    levels of every line in device memory; lines longer than 256 cells
    raise."""
    assert cuda_sweep.shared_bytes(32, 32, 1) == 4 * 4 * 32 * 33
    # columns of 20 cells beside rows of 100: their levels leave the registers
    assert cuda_sweep.shared_bytes(20, 100, 4) == 4 * (4 * 20 * 101 + 5 * 7 * 100
                                                      + 25 * 5 * 20)
    per_rows, per_cols = 18, 32                    # 54x96 in clusters of 3
    assert cuda_sweep.shared_bytes(54, 96, 3) == 4 * (4 * 54 * 97 + per_rows * 7 * 96
                                                     + per_cols * 6 * 54)
    for rows, cols in ((1, 1), (32, 32), (64, 36), (54, 96), (72, 128), (1, 256),
                       (256, 1), (33, 7)):
        k = cuda_sweep.cluster_size(rows, cols)
        assert cuda_sweep.takes(rows, cols, k) and not cuda_sweep.takes(rows, cols, 9)
        assert cuda_sweep.min_cluster(rows, cols) <= k <= cuda_sweep.MAX_CLUSTER
        assert cuda_sweep.shared_bytes(rows, cols, k) <= cuda_sweep.SHARED_CAP
        assert k * cuda_sweep.WARPS >= max(rows, cols)
    assert not cuda_sweep.takes(54, 96, 2) and not cuda_sweep.takes(1, 257, 8)
    for rows, cols in ((108, 192), (192, 108)):
        assert not any(cuda_sweep.takes(rows, cols, k) for k in range(1, 9))
        assert cuda_sweep.cluster_size(rows, cols) == cuda_sweep.min_cluster(rows, cols) == 6
        assert cuda_sweep.launch_plan(rows, cols) == ("global", 6)
        assert cuda_sweep.level_bytes(rows, cols, 6) == 4 * (18 * 8 * 192 + 32 * 7 * 108)
        assert cuda_sweep.field_bytes(rows, cols) == 16 * rows * (cols | 1)
    assert cuda_sweep.launch_plan(72, 128) == ("shared", 7)
    assert cuda_sweep.launch_plan(256, 256) == ("global", 8)
    assert cuda_sweep.level_bytes(256, 256, 8) == 4 * 2 * 32 * 8 * 256
    # lines of a warp or less keep their levels too (none in registers)
    assert cuda_sweep.level_bytes(32, 32, 1) == 4 * 2 * 32 * 5 * 32
    for rows, cols in ((1, 257), (257, 3)):
        with pytest.raises(ValueError, match="lines of 1 to 256"):
            cuda_sweep.cluster_size(rows, cols)


def test_ptxas_instances_are_read():
    """The build's ptxas report is read an instance at a time: the slots of
    a row and of a column, registers, spill bytes."""
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118relax_sweep_kernelILi3ELi2ELb0EEE"
        "vPKfPKiS2_PfPiS5_S4_S4_iiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118relax_sweep_kernelILi3ELi2ELb0EEE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers, 396 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118relax_sweep_kernelILi8ELi1ELb0EEE"
        "vPKfPKiS2_PfPiS5_S4_S4_iiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118relax_sweep_kernelILi8ELi1ELb0EEE",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 396 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118relax_sweep_kernelILi8ELi8ELb1EEE"
        "vPKfPKiS2_PfPiS5_S4_S4_iiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118relax_sweep_kernelILi8ELi8ELb1EEE",
        "    48 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 396 bytes smem",
        # a build of the kernel before it had two forms
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118relax_sweep_kernelILi2ELi2EEE"
        "vPKfPKiS2_PfPiS5_iiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118relax_sweep_kernelILi2ELi2EEE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers, used 1 barriers, 396 bytes smem"])
    assert cuda_sweep.instances(log) == [
        {"form": "shared", "slots": (3, 2), "registers": 56, "stack": 0, "spill_stores": 0,
         "spill_loads": 0},
        {"form": "shared", "slots": (8, 1), "registers": 64, "stack": 8, "spill_stores": 4,
         "spill_loads": 12},
        {"form": "global", "slots": (8, 8), "registers": 64, "stack": 48, "spill_stores": 0,
         "spill_loads": 0},
        {"form": "shared", "slots": (2, 2), "registers": 48, "stack": 0, "spill_stores": 0,
         "spill_loads": 0}]


def test_profile_sweep_stamps_every_section():
    """utils/profile_sweep.py turns the kernel's markers into clock stamps:
    the four sections of a scan pass and the launch's setup, one report; and
    it reads the stamped kernel's lines back, per pass."""
    from vision_assist_tpu_torch.utils import profile_sweep

    src, names = profile_sweep.instrumented_source(cuda_sweep.SOURCE.read_text())
    assert names == ["loads, h and the shift", "levels", "store and need flags",
                     "barrier wait", "setup"]
    assert "// @profile " not in src and src.count("printf(") == 1
    assert src.count("prof_last_ = now_") == len(names) and "min(0u, blockDim.x - 32u)" in src
    assert "min(992u, blockDim.x - 32u)" in profile_sweep.instrumented_source(
        cuda_sweep.SOURCE.read_text(), warp=31)[0]
    text = ("noise\nsweep-profile stream 0 rank 1 passes 4 start 100 end 900 cycles "
            "48 80 12 400 1000\nsweep-profile stream 0 rank 0 passes 4 start 90 end 950 "
            "cycles 52 84 16 396 900\n")
    recs = profile_sweep.parse(text, names)
    assert [(r["rank"], r["ns"], r["per_pass"]["levels"]) for r in recs] == [
        (1, 800, 20.0), (0, 860, 21.0)]
    (line,) = profile_sweep.summary("x", names, recs)
    assert "2 CTA(s), passes 4" in line and "setup 950 cycles once" in line
    assert "levels 20" in line and "total 136" in line
    with pytest.raises(RuntimeError, match="not found once"):
        profile_sweep.instrumented_source(src)


def test_the_card_path_refuses_what_the_kernel_does_not_take():
    """On (fake) CUDA tensors the wrapper raises before any launch for a
    cluster outside [the fewest CTAs, 8], for lines longer than 256 cells
    and for a forced shared form that does not fit; a cluster it takes is
    passed to the shared form's operator, and a lattice no cluster's shared
    memory holds (4K UHD) goes to the global form's, at 6 CTAs a stream."""
    from torch.fx.experimental.proxy_tensor import make_fx

    mode, (e96, s1, turn, e4k, e257) = _fake_cuda(
        torch.zeros(1, 54, 96), torch.zeros(1, 2), torch.zeros(4, 4),
        torch.zeros(1, 108, 192), torch.zeros(1, 4, 257))
    with mode:
        for bad in (2, 9):
            with pytest.raises(ValueError, match="clusters of"):
                cuda_sweep.relax_sweep_field_cuda(e96, s1, turn, cluster=bad)
        with pytest.raises(ValueError, match="lines of 1 to 256"):
            cuda_sweep.relax_sweep_field_cuda(e257, s1, turn)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_sweep.relax_sweep_field_cuda(e4k, s1, turn, form="shared")
        graph = make_fx(lambda e, s, t: cuda_sweep.relax_sweep_field_cuda(
            e, s, t, cluster=4), tracing_mode="fake")(e96, s1, turn).graph
        graph4k = make_fx(lambda e, s, t: cuda_sweep.relax_sweep_field_cuda(
            e, s, t), tracing_mode="fake")(e4k, s1, turn).graph
    (op,) = [n for n in graph.nodes if "relax_sweep" in str(n.target)]
    assert "relax_sweep_global" not in str(op.target)
    assert op.args[-2:] == (54 * 96, 4)
    (op,) = [n for n in graph4k.nodes if "relax_sweep" in str(n.target)]
    assert "relax_sweep_global" in str(op.target)
    assert op.args[-2:] == (108 * 192, 6)
    assert cuda_sweep.launches == 0


# -- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the relax_sweep kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("shape,b", [((32, 32), 1), ((32, 32), 8), ((54, 96), 1),
                                     ((64, 36), 13), ((1, 70), 3), ((70, 1), 3)])
def test_sweep_kernel_bit_equal_to_twin_on_card(cuda, shape, b, cluster):
    """In clusters of ``cluster`` CTAs a stream (0: the launch's choice) the
    kernel's field and passes are the twin's and its line scans the
    emulation's; a cluster the lattice does not take (fewer CTAs than give
    each warp one line a side) raises."""
    walk, pen, start = _lattices(*shape, b, seed=shape[0] + b)
    enter, start_t, turn = _field_inputs(walk, pen, start, device=cuda)
    k = cluster or cuda_sweep.cluster_size(*shape)
    if k < cuda_sweep.min_cluster(*shape):
        with pytest.raises(ValueError):
            cuda_sweep.relax_sweep_field_cuda(enter, start_t, turn, cluster=k)
        return
    cuda_sweep.reset_launches()
    got, passes = cuda_sweep.relax_sweep_field_cuda(enter, start_t, turn, cluster=k)
    torch.cuda.synchronize()
    assert cuda_sweep.launches == 1
    ref, ref_passes = wavefront.relax_sweep_field(enter, start_t, turn)
    assert torch.equal(got, ref) and torch.equal(passes, ref_passes)
    _, _, scans = torch.ops.vision_assist_tpu_torch.relax_sweep(
        enter, start_t.to(torch.int32), turn, shape[0] * shape[1], k)
    for i in range(b):
        want = _emulate_sweep_kernel(enter[i].cpu().numpy(), start[i],
                                     turn.cpu().numpy(), k=k)[2]
        assert scans[i].tolist() == want
    capped, capped_passes = cuda_sweep.relax_sweep_field_cuda(enter, start_t, turn, 2,
                                                              cluster=k)
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
