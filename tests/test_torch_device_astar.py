"""The port's exact A* on the device against the JAX package's.

The same numpy inputs (walkable, float32 penalty, start, goals; built by the
JAX package's numpy golden helpers, as tests/test_device_astar.py builds
them) go through ``vision_assist_tpu.planning.device_astar`` (jitted, CPU)
and the port's plain PyTorch version, on the 13 scenario fixtures and six
seeded random 64x36 lattices. Cells, lengths and validity are integers and
must be equal, the cache's NaN pattern too; costs and cache values within
rtol 1e-5 (float32 ``acos`` and ``pow`` of XLA and PyTorch may differ in the
last place).

The CUDA kernel (csrc/astar.cu) cannot run here. Its rule for the window
maximum (one new window a node, the rest taken from the parent) is held by a
numpy float32 emulation of the kernel's algorithm against the plain version:
cells, lengths, pop and relaxation counts and cache pattern equal. The
kernel itself is held against the plain version on the card by one test
marked ``cuda`` (it skips without a card) and by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.config import replay_config  # noqa: E402
from vision_assist_tpu.golden.astar import closest_cell_to_point  # noqa: E402
from vision_assist_tpu.golden.lattice import (  # noqa: E402
    inject_artificial_cells,
    penalty_field,
)
from vision_assist_tpu.golden.peaks import find_peaks, rasterize_cells  # noqa: E402
from vision_assist_tpu.io.scenarios import load_scenario, scenario_names  # noqa: E402
from vision_assist_tpu.planning import device_astar as jax_astar  # noqa: E402
from vision_assist_tpu_torch.ops import cuda_astar  # noqa: E402
from vision_assist_tpu_torch.planning import device_astar  # noqa: E402

torch.set_num_threads(2)

CFG = replay_config()
MAX_LEN = CFG.pathfinder.max_path_len
CASES = list(scenario_names()) + [f"random{seed}" for seed in range(6)]
F = np.float32


def _inputs(name):
    """(walkable, penalty f32, start, goals) as numpy, at most 3 goals."""
    if name.startswith("random"):
        rng = np.random.default_rng(int(name[len("random"):]))
        occ = rng.random((64, 36)) > rng.uniform(0.25, 0.5)
    else:
        occ = load_scenario(name)
    g, h, w = CFG.grid.grid_size, CFG.frame_height, CFG.frame_width
    walkable, _ = inject_artificial_cells(
        occ, w, h, g, half_span=CFG.grid.artificial_half_span_cells,
        row_start_frac=CFG.grid.artificial_row_start_frac, replay_rounding=True)
    penalty = penalty_field(
        walkable, saturation_threshold=CFG.penalty.saturation_threshold,
        dominance_gain=CFG.penalty.dominance_gain).astype(np.float32)
    peaks = find_peaks(rasterize_cells(walkable, h, w, g), g)
    start = closest_cell_to_point(walkable, (w // 2, h), g)
    goals = [closest_cell_to_point(walkable, p.centre.to_tuple(), g) for p in peaks]
    assert start is not None and goals
    return walkable, penalty, start, goals[:3]


def _jax_paths(walkable, penalty, start, goals, valid, cache, **kw):
    batch, cache_out = jax_astar.device_astar_paths(
        jnp.asarray(walkable), jnp.asarray(penalty), jnp.asarray(start, jnp.int32),
        jnp.asarray(goals, jnp.int32).reshape(-1, 2), jnp.asarray(valid),
        jnp.asarray(cache), grid_size=CFG.grid.grid_size, max_len=MAX_LEN, **kw)
    return batch, np.asarray(cache_out)


def _torch_paths(walkable, penalty, start, goals, valid, cache, **kw):
    return device_astar.device_astar_paths_plain(
        torch.from_numpy(walkable), torch.from_numpy(penalty), torch.tensor(start),
        torch.tensor(goals).reshape(-1, 2), torch.tensor(valid),
        torch.from_numpy(np.asarray(cache)), return_counts=True,
        grid_size=CFG.grid.grid_size, max_len=MAX_LEN, **kw)


def _assert_same_batch(tb, jb, tcache, jcache):
    np.testing.assert_array_equal(tb.cells.numpy(), np.asarray(jb.cells))
    np.testing.assert_array_equal(tb.lengths.numpy(), np.asarray(jb.lengths))
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    np.testing.assert_allclose(tb.costs.numpy(), np.asarray(jb.costs), rtol=1e-5)
    np.testing.assert_array_equal(np.isnan(tcache), np.isnan(jcache))
    np.testing.assert_allclose(tcache, jcache, rtol=1e-5)


@pytest.fixture(scope="module")
def searched():
    """Each case searched once by the port's plain version, on first use:
    name -> (inputs, PathBatch, cache_out, counts)."""
    done = {}

    def get(name):
        if name not in done:
            inp = _inputs(name)
            valid = np.ones(len(inp[3]), bool)
            done[name] = (inp, *_torch_paths(*inp, valid,
                                             device_astar.empty_cache().numpy()))
        return done[name]
    return get


@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_jax(searched, name):
    inp, tb, tcache, _ = searched(name)
    valid = np.ones(len(inp[3]), bool)
    jb, jcache = _jax_paths(*inp, valid, jax_astar.empty_cache())
    assert tb.valid.all() or name.startswith("random")
    _assert_same_batch(tb, jb, tcache.numpy(), jcache)
    assert np.isnan(tcache[-1].item())            # the scratch slot stays NaN


def test_degrees_mode_matches_jax():
    """replicate_radians_cache_bug=False: the cache stores degrees."""
    inp = _inputs("sharp_right_on_path")
    valid = np.ones(len(inp[3]), bool)
    kw = dict(replicate_radians_cache_bug=False)
    tb, tcache, _ = _torch_paths(*inp, valid, device_astar.empty_cache().numpy(), **kw)
    jb, jcache = _jax_paths(*inp, valid, jax_astar.empty_cache(), **kw)
    _assert_same_batch(tb, jb, tcache.numpy(), jcache)
    assert np.nanmax(tcache.numpy()) > np.pi      # degrees, not radians


def test_cache_carried_across_goals_and_frames():
    """Goal k sees the cache warmed by goals 0..k-1, an invalid goal leaves
    it alone, and the next frame starts from the previous frame's cache."""
    jcache = np.asarray(jax_astar.empty_cache())
    tcache = device_astar.empty_cache().numpy()
    for name in ("two_global_peaks", "insane_case", "two_global_peaks"):
        walkable, penalty, start, goals = _inputs(name)
        goals = (goals + [start])[:3]
        valid = np.array([True, False, True][:len(goals)])
        jb, jcache = _jax_paths(walkable, penalty, start, goals, valid, jcache)
        tb, tcache_t, _ = _torch_paths(walkable, penalty, start, goals, valid, tcache)
        tcache = tcache_t.numpy()
        _assert_same_batch(tb, jb, tcache, jcache)
        assert not tb.valid[1] and tb.lengths[1] == 0 and torch.isinf(tb.costs[1])
    # A warm cache changes nothing it already holds.
    walkable, penalty, start, goals = _inputs("insane_case")
    _, again, counts = _torch_paths(walkable, penalty, start, goals[:1],
                                    np.ones(1, bool), tcache)
    np.testing.assert_array_equal(again.numpy(), tcache)
    assert counts[0][0] > 0


def test_start_equals_goal():
    walkable = torch.ones((8, 8), dtype=torch.bool)
    res = device_astar.device_astar(
        walkable, torch.zeros((8, 8)), torch.tensor([7, 4]), torch.tensor([7, 4]),
        device_astar.empty_cache(), max_len=64)
    ref = jax_astar.device_astar(
        jnp.ones((8, 8), bool), jnp.zeros((8, 8)), jnp.array([7, 4], jnp.int32),
        jnp.array([7, 4], jnp.int32), jax_astar.empty_cache(), max_len=64)
    assert int(res.length) == int(ref.length) == 1
    assert float(res.cost) == float(ref.cost) == 0.0
    np.testing.assert_array_equal(res.cells.numpy(), np.asarray(ref.cells))
    assert torch.isnan(res.cache).all()


@pytest.mark.parametrize("gap", [1, 3], ids=["one_row_gap", "three_row_gap"])
def test_unreachable_goal(gap):
    """Empty cells are relaxed one step deep but never expanded, so an island
    behind a gap is out of reach; the search ends with the open set empty."""
    walkable = np.zeros((8, 8), bool)
    walkable[7, :] = True
    walkable[7 - gap - 1, :] = True               # island
    goal = [7 - gap - 1, 4]
    penalty = np.zeros((8, 8), np.float32)
    res = device_astar.device_astar(
        torch.from_numpy(walkable), torch.from_numpy(penalty), torch.tensor([7, 4]),
        torch.tensor(goal), device_astar.empty_cache(), max_len=64)
    ref = jax_astar.device_astar(
        jnp.asarray(walkable), jnp.asarray(penalty), jnp.array([7, 4], jnp.int32),
        jnp.array(goal, jnp.int32), jax_astar.empty_cache(), max_len=64)
    assert int(res.length) == int(ref.length)
    np.testing.assert_array_equal(res.cells.numpy(), np.asarray(ref.cells))
    if gap == 3:
        assert int(res.length) == 0 and not np.isfinite(float(res.cost))
        assert (res.cells == -1).all()


def test_path_longer_than_max_len_is_invalid():
    walkable = torch.ones((1, 12), dtype=torch.bool)
    kw = dict(walkable=walkable, penalty=torch.zeros((1, 12)),
              start_rc=torch.tensor([0, 0]), goal_rc=torch.tensor([0, 11]),
              cache=device_astar.empty_cache())
    assert int(device_astar.device_astar(**kw, max_len=12).length) == 12
    short = device_astar.device_astar(**kw, max_len=8)
    assert int(short.length) == 0 and torch.isinf(short.cost)


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch(searched):
    inp, tb, tcache, counts = searched("right_turn")
    walkable, penalty, start, goals = inp
    cuda_astar.reset_launches()
    cells, lengths, costs, cache_out, stats = cuda_astar.astar_paths_cuda(
        torch.from_numpy(walkable)[None], torch.from_numpy(penalty)[None],
        torch.tensor(start)[None], torch.tensor(goals).reshape(1, -1, 2),
        torch.ones((1, len(goals)), dtype=torch.bool),
        device_astar.empty_cache()[None], max_len=MAX_LEN)
    assert cuda_astar.launches == 0
    assert torch.equal(cells[0], tb.cells) and torch.equal(lengths[0], tb.lengths)
    assert torch.equal(costs[0], tb.costs)
    assert stats[0].tolist() == [list(c) for c in counts]
    with pytest.raises(ValueError, match="bad shapes"):
        cuda_astar.astar_paths_cuda(
            torch.from_numpy(walkable)[None], torch.from_numpy(penalty)[None],
            torch.tensor(start)[None], torch.tensor(goals).reshape(1, -1, 2),
            torch.ones((1, len(goals) + 1), dtype=torch.bool),
            device_astar.empty_cache()[None])


# -- the kernel's algorithm, emulated in numpy float32 ---------------------------------

def _window_key(h):
    """csrc/astar.cu window_key: the cache key of the window a node adds,
    from the last six moves of its path, or None without an angle."""
    dr, dc = (0, 0, 1, -1), (1, -1, 0, 0)
    m1, m2, m4, m5, m6 = (h >> s & 3 for s in (0, 2, 6, 8, 10))
    nxt_dc, nxt_dr = dc[m1] + dc[m2], dr[m1] + dr[m2]
    prev_dc, prev_dr = dc[m4] + dc[m5] + dc[m6], dr[m4] + dr[m5] + dr[m6]
    if prev_dc ** 2 + prev_dr ** 2 == 0 or nxt_dc ** 2 + nxt_dr ** 2 == 0:
        return None
    return device_astar._cache_key(prev_dc, prev_dr, nxt_dc, nxt_dr)


def _key_vectors(key):
    """csrc/astar.cu window_radians: the two vectors back from a key."""
    return key // 175 - 3, key // 25 % 7 - 3, key // 5 % 5 - 2, key % 5 - 2


def _emulate_kernel(walk, pen, start, goals, valid, cache, bug=True, g=20.0,
                    grace=30.0, exponent=1.5, den=90.0, pw=0.5, aw=1.5,
                    segments=False):
    """csrc/astar.cu step for step: column-major state, (bits(f), t) pop key,
    the last six moves of a node's path in ``hist`` (2 bits a move, newest
    lowest), and the window maximum built from the parent's (``mbase``) and
    ONE new window a node, whose key is arithmetic on ``hist``.

    With ``segments`` the pop is the kernel's: the open set in at most 32
    segments of 128 << s cells, the least (key, t) of segment j kept by lane
    j; a pop takes the least of the 32, reads the popped node's segment
    again, and hands each pushed key to the lane that owns it. Every pop is
    held against the argmin over the whole open set."""
    rows, cols = walk.shape
    n = rows * cols
    shift = 7
    while (32 << shift) < n:
        shift += 1
    none = np.uint64(2 ** 64 - 1)
    cache = cache.astype(F).copy()
    k_goals = len(goals)
    cells = np.full((k_goals, MAX_LEN, 2), -1, np.int32)
    lengths = np.zeros(k_goals, np.int32)
    costs = np.full(k_goals, np.inf, F)
    stats = np.zeros((k_goals, 2), np.int64)
    walk_t, pen_t = walk.T.reshape(-1), pen.astype(F).T.reshape(-1)
    dt, dr, dc = (rows, -rows, 1, -1), (0, 0, 1, -1), (1, -1, 0, 0)
    gsz = F(g)
    st = start[1] * rows + start[0]
    for k in range(k_goals):
        if not valid[k]:
            continue
        gr, gc = goals[k]
        gt = gc * rows + gr

        def heur(t):
            return gsz * F(abs(t % rows - gr) + abs(t // rows - gc))

        gs, fo = np.full(n, np.inf, F), np.full(n, np.inf, F)
        opn, closed = np.zeros(n, bool), np.zeros(n, bool)
        mbase, hist, plen = np.zeros(n, F), np.zeros(n, np.int64), np.zeros(n, np.int64)
        gs[st], fo[st], opn[st], plen[st] = 0, heur(st), True, 1
        pops = relax = 0
        found = False

        def open_keys():
            return np.where(opn, (fo.view(np.uint32).astype(np.uint64) << np.uint64(32))
                            | np.arange(n, dtype=np.uint64), none)

        lane_min = np.full(32, none)
        lane_min[st >> shift] = open_keys()[st]
        while opn.any():
            keys = open_keys()
            cur = int(np.argmin(keys))
            if segments:
                assert lane_min.min() == keys[cur], (pops, cur)
                cur = int(lane_min.min() & np.uint64(0xffffffff))
            pops += 1
            if cur == gt:
                found = True
                break
            opn[cur], closed[cur] = False, True
            owner = cur >> shift
            lane_min[owner] = open_keys()[owner << shift:(owner + 1) << shift].min()
            if not (walk_t[cur] or cur == st):
                continue
            cc, cr = divmod(cur, rows)
            nts = [cur + dt[d] if 0 <= cr + dr[d] < rows and 0 <= cc + dc[d] < cols
                   and not closed[cur + dt[d]] else -1 for d in range(4)]
            if max(nts) < 0:
                continue
            m, h = int(plen[cur]), int(hist[cur])
            ma_first = ma_rest = F(0)
            if m >= 7:
                base = mbase[cur]
                ma_first = ma_rest = base
                key = _window_key(h)
                if key is not None:
                    first = rest = cache[key]
                    if np.isnan(first):
                        prev_dc, prev_dr, nxt_dc, nxt_dr = _key_vectors(key)
                        mp = np.sqrt(F(prev_dc * prev_dc + prev_dr * prev_dr))
                        mn = np.sqrt(F(nxt_dc * nxt_dc + nxt_dr * nxt_dr))
                        cosv = np.clip(F(prev_dc * nxt_dc + prev_dr * nxt_dr) / (mp * mn),
                                       F(-1), F(1))
                        rad = np.arccos(F(cosv))
                        first = F(rad * F(180.0 / np.pi))
                        rest = cache[key] = rad if bug else first
                    ma_first, ma_rest = max(base, first), max(base, rest)
            first_valid = True
            for d in range(4):
                nt = nts[d]
                if nt < 0:
                    continue
                ma, first_valid = (ma_first if first_valid else ma_rest), False
                apen = F(0) if ma <= F(grace) else np.power(F(ma / F(den)), F(exponent))
                cpen = pen_t[nt] if walk_t[nt] else F(0)
                mult = F(F(F(1) + F(F(pw) * cpen)) + F(F(aw) * apen))
                tent = F(gs[cur] + F(gsz * mult))
                relax += 1
                if tent < gs[nt]:
                    gs[nt], plen[nt], mbase[nt] = tent, m + 1, ma_rest
                    hist[nt] = (h << 2 | d) & 0xfff
                    if not opn[nt]:
                        fo[nt], opn[nt] = F(tent + heur(nt)), True
                        lane_min[nt >> shift] = min(lane_min[nt >> shift],
                                                    open_keys()[nt])
        stats[k] = (pops, relax)
        if found and plen[gt] <= MAX_LEN:
            t = gt
            for j in range(int(plen[gt]) - 1, -1, -1):
                cells[k, j] = (t % rows, t // rows)
                if j:
                    t -= dt[hist[t] & 3]
            lengths[k], costs[k] = plen[gt], gs[gt]
    return cells, lengths, costs, cache, stats


@pytest.mark.parametrize("name", CASES)
def test_kernel_rule_emulation_equals_plain_version(searched, name):
    inp, tb, tcache, counts = searched(name)
    cells, lengths, costs, cache, stats = _emulate_kernel(
        *inp, np.ones(len(inp[3]), bool), device_astar.empty_cache().numpy())
    np.testing.assert_array_equal(cells, tb.cells.numpy())
    np.testing.assert_array_equal(lengths, tb.lengths.numpy())
    assert stats.tolist() == [list(c) for c in counts]
    np.testing.assert_allclose(costs, tb.costs.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(np.isnan(cache), np.isnan(tcache.numpy()))
    np.testing.assert_allclose(cache, tcache.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", ["insane_case", "two_global_peaks", "random0",
                                  "random3", "obstacle_ahead"])
def test_kernel_segment_minima_pop_the_open_sets_argmin(searched, name):
    """The kernel's open set: 32 lane minima over segments, kept by one
    rescan and at most four hand-offs a pop, give the pop sequence of the
    argmin over the whole open set (asserted at every pop), so the result is
    the plain version's."""
    inp, tb, tcache, counts = searched(name)
    cells, lengths, _, cache, stats = _emulate_kernel(
        *inp, np.ones(len(inp[3]), bool), device_astar.empty_cache().numpy(),
        segments=True)
    np.testing.assert_array_equal(cells, tb.cells.numpy())
    np.testing.assert_array_equal(lengths, tb.lengths.numpy())
    assert stats.tolist() == [list(c) for c in counts]
    np.testing.assert_array_equal(np.isnan(cache), np.isnan(tcache.numpy()))


def test_kernel_window_key_table():
    """The key of the window a node adds is a function of its last six moves
    (12 bits of ``hist``), which the kernel tabulates; the key's arithmetic
    inverts to the two vectors, from which a fresh angle is computed."""
    dr, dc = (0, 0, 1, -1), (1, -1, 0, 0)
    seen = set()
    for h in range(1 << 12):
        key = _window_key(h)
        if key is None:
            continue
        assert 0 <= key < device_astar.CACHE_SIZE - 1
        m = [h >> s & 3 for s in (0, 2, 4, 6, 8, 10)]
        vectors = (dc[m[3]] + dc[m[4]] + dc[m[5]], dr[m[3]] + dr[m[4]] + dr[m[5]],
                   dc[m[0]] + dc[m[1]], dr[m[0]] + dr[m[1]])
        assert _key_vectors(key) == vectors
        seen.add(key)
    assert len(seen) > 100


@pytest.mark.parametrize("bug", [True, False], ids=["radians_bug", "degrees"])
def test_kernel_rule_emulation_with_carried_cache(bug):
    ecache = tcache = device_astar.empty_cache().numpy()
    for name in ("outrageous_case", "random2", "sharp_right_on_path"):
        inp = _inputs(name)
        valid = np.ones(len(inp[3]), bool)
        tb, tcache_t, counts = _torch_paths(*inp, valid, tcache,
                                            replicate_radians_cache_bug=bug)
        tcache = tcache_t.numpy()
        cells, lengths, _, ecache, stats = _emulate_kernel(*inp, valid, ecache, bug=bug)
        np.testing.assert_array_equal(cells, tb.cells.numpy())
        np.testing.assert_array_equal(lengths, tb.lengths.numpy())
        assert stats.tolist() == [list(c) for c in counts]
        np.testing.assert_array_equal(np.isnan(ecache), np.isnan(tcache))
        np.testing.assert_allclose(ecache, tcache, rtol=1e-5)


# -- on the card -------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_astar_kernel_equals_plain_version_on_card(cuda):
    cache_k = cache_p = device_astar.empty_cache(cuda)
    for name in ("insane_case", "two_global_peaks", "random3"):
        walkable, penalty, start, goals = _inputs(name)
        inp = (torch.from_numpy(walkable).to(cuda), torch.from_numpy(penalty).to(cuda),
               torch.tensor(start, device=cuda), torch.tensor(goals, device=cuda),
               torch.ones(len(goals), dtype=torch.bool, device=cuda))
        cuda_astar.reset_launches()
        got, cache_k = device_astar.device_astar_paths(*inp, cache_k, max_len=MAX_LEN)
        torch.cuda.synchronize()
        assert cuda_astar.launches == 1
        ref, cache_p = device_astar.device_astar_paths_plain(*inp, cache_p,
                                                             max_len=MAX_LEN)
        assert torch.equal(got.cells, ref.cells)
        assert torch.equal(got.lengths, ref.lengths)
        assert torch.equal(got.valid, ref.valid)
        assert torch.allclose(got.costs, ref.costs, rtol=1e-5, atol=0)
        assert torch.equal(cache_k.isnan(), cache_p.isnan())
        assert torch.allclose(cache_k, cache_p, rtol=1e-5, atol=0, equal_nan=True)
