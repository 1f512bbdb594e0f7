"""The exact A* on the device: the reference pathfinder, decision for decision.

The wavefront engine (planning/wavefront.py) is the fast batched search, but
it is Markovian and cannot reproduce the reference's exploration-order-
dependent behaviour on every fixture (insane_case). This engine replicates
PathFinder.py:119-186 with every quirk the host twin (golden/astar.py)
documents:

* pop = lexicographic argmin of (f_open, col, row) over the open set (the
  reference's heap order, ties broken on the raw pixel tuple (f, x, y));
* stale open-set priorities: an improved node that is already open keeps its
  old f (f_open is written on push only);
* the path-so-far angle analysis per relaxation over a 7-point sliding
  window, whose last point is in no window, so all four neighbours of a pop
  analyse the same windows;
* the radians/degrees cache bug: a fresh window contributes DEGREES but the
  cache stores RADIANS, so only the first valid neighbour of a pop can pay an
  angle penalty through a given window, and the cache is carried state across
  goals and frames;
* non-walkable cells are relaxed, pushed, popped and closed without
  expanding, and those dead-end relaxations still warm the cache.

The angle cache is a dense (7*7*5*5 + 1,) float32 table (NaN = absent, last
slot scratch and always NaN): prev vectors span 3 lattice steps, next vectors
2, and angles are scale-invariant, so cell-unit keys cover the key space.

Two routes, as for ``relax``. ``device_astar_paths_plain`` is plain
PyTorch, float32, any device: a transliteration of the JAX package's
``lax.while_loop`` body and of its ``window_angles``
(vision_assist_tpu/planning/device_astar.py), with the
integer control state (closed set, path lengths) kept on the host, so one
pop costs a few host reads. ``device_astar`` / ``device_astar_paths`` go
through the wrapper ``ops/cuda_astar.py``, which runs the plain version for
CPU tensors and, for CUDA tensors, the hand-written kernel ``csrc/astar.cu``
(one launch for all the goals of a frame); they never run the plain version
on the card.

Everything is float32; the reference computes in float64. On the 13 scenario
fixtures and the fuzz lattices the selected paths are identical; costs agree
to float32 round-off. The host twin remains the bit-exact oracle.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vision_assist_tpu_torch.planning.wavefront import PathBatch
from vision_assist_tpu_torch.utils.streams import stream

INF = float("inf")
DEG_PER_RAD = float(np.float32(180.0 / np.pi))


class DeviceAStarResult(NamedTuple):
    cells: torch.Tensor    # (L, 2) int32 (row, col), -1 padded
    length: torch.Tensor   # () int32, 0 = no path
    cost: torch.Tensor     # () f32, inf = no path
    cache: torch.Tensor    # (1226,) f32 angle cache (last slot is scratch)


def _cache_key(prev_dc, prev_dr, nxt_dc, nxt_dr):
    """Dense index for the angle cache. Vectors are (dx, dy) in CELL units:
    prev spans 3 steps (-3..3), next spans 2 (-2..2)."""
    return (((prev_dc + 3) * 7 + (prev_dr + 3)) * 25
            + (nxt_dc + 2) * 5 + (nxt_dr + 2))


CACHE_SIZE = 49 * 25 + 1   # +1 scratch slot for masked scatters


def empty_cache(device: torch.device | str | None = None) -> torch.Tensor:
    return torch.full((CACHE_SIZE,), float("nan"), dtype=torch.float32,
                      device=device)


class _Params(NamedTuple):
    grid_size: int = 20
    max_len: int = 512
    angle_window: int = 7
    angle_grace_deg: float = 30.0
    angle_exponent: float = 1.5
    angle_denominator: float = 90.0
    penalty_weight: float = 0.5
    angle_weight: float = 1.5
    replicate_radians_cache_bug: bool = True


def _window_terms(path: torch.Tensor, m: int, cols: int, p: _Params):
    """The cache-independent half of the window analysis for a path of
    length m (+1 appended neighbour, which enters no window): per window
    (key, use, radians, degrees), or None when the path has no window.
    Window centres are i = half .. (m+1) - half - 2."""
    half = p.angle_window // 2
    count = min(max(m + 1 - 2 * half - 1, 0), p.max_len)
    if count == 0:
        return None
    win = torch.arange(count, device=path.device)
    i = win + half
    last = p.max_len - 1
    p_i = path[i.clamp(max=last)]
    p_im = path[win]
    p_ip = path[(i + half).clamp(max=last)]
    p_i1 = path[(i + 1).clamp(max=last)]
    # pixel vector = cell vector * g; angles are scale-invariant
    prev_dc, prev_dr = p_i % cols - p_im % cols, p_i // cols - p_im // cols
    nxt_dc, nxt_dr = p_ip % cols - p_i1 % cols, p_ip // cols - p_i1 // cols

    dot = (prev_dc * nxt_dc + prev_dr * nxt_dr).to(torch.float32)
    mag_p = torch.sqrt((prev_dc * prev_dc + prev_dr * prev_dr).to(torch.float32))
    mag_n = torch.sqrt((nxt_dc * nxt_dc + nxt_dr * nxt_dr).to(torch.float32))
    nonzero = (mag_p > 0) & (mag_n > 0)
    cosv = (dot / torch.where(nonzero, mag_p * mag_n, 1.0)).clamp(-1.0, 1.0)
    radians = torch.acos(cosv)
    degrees = radians * DEG_PER_RAD

    key = _cache_key(prev_dc, prev_dr, nxt_dc, nxt_dr)
    # A path that outgrew max_len is corrupt (see _search); its clamped
    # windows may give vectors outside the key space. They are not used.
    use = nonzero & (key >= 0) & (key < CACHE_SIZE - 1)
    key_safe = torch.where(use, key, CACHE_SIZE - 1)
    return win, key_safe, use, radians, degrees


def _apply_cache(terms, cache: torch.Tensor, p: _Params):
    """The cache-dependent half: (max window angle in degrees, new cache),
    with same-call cache-write visibility. The first window with a fresh key
    within THIS call contributes degrees; later windows with the same key
    read the value the first stored (radians in bug mode)."""
    win, key_safe, use, radians, degrees = terms
    cached_val = cache[key_safe]
    fresh = torch.isnan(cached_val) & use
    first_at = torch.full((CACHE_SIZE,), p.max_len, dtype=win.dtype,
                          device=win.device).scatter_reduce_(
        0, torch.where(fresh, key_safe, CACHE_SIZE - 1), win, "amin")
    is_first = fresh & (first_at[key_safe] == win)

    store = radians if p.replicate_radians_cache_bug else degrees
    value = torch.where(fresh, torch.where(is_first, degrees, store), cached_val)
    max_angle = torch.where(use, value, -INF).max()
    max_angle = torch.where(use.any(), max_angle, 0.0)

    new_cache = cache.clone()
    new_cache[torch.where(is_first, key_safe, CACHE_SIZE - 1)] = torch.where(
        is_first, store, float("nan"))
    new_cache[CACHE_SIZE - 1] = float("nan")   # keep the scratch slot NaN
    return max_angle, new_cache


def _search(walk_h: np.ndarray, pen_f: torch.Tensor, start: int, goal: int,
            cache: torch.Tensor, p: _Params):
    """One exact search. walk_h (R, C) bool on the host, pen_f (R*C,) f32.
    Returns (flat path (max_len,) int64, length, cost () f32, cache, pops,
    relaxations); length 0 and cost inf when there is no path."""
    rows, cols = walk_h.shape
    n = rows * cols
    dev = pen_f.device
    g = float(p.grid_size)
    L = p.max_len
    goal_r, goal_c = divmod(goal, cols)
    walk_flat = walk_h.reshape(-1)

    def heuristic(idx: int) -> float:
        return g * float(abs(idx // cols - goal_r) + abs(idx % cols - goal_c))

    idx = torch.arange(n, device=dev)
    tie_static = (idx % cols) * rows + idx // cols      # (col, row) order
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    g_score = torch.full((n,), INF, dtype=torch.float32, device=dev)
    g_score[start] = 0.0
    f_open = torch.full((n,), INF, dtype=torch.float32, device=dev)
    f_open[start] = heuristic(start)
    in_open = torch.zeros((n,), dtype=torch.bool, device=dev)
    in_open[start] = True
    path_buf = torch.full((n, L), -1, dtype=torch.int64, device=dev)
    path_buf[start, 0] = start
    # Integer control state, on the host: it decides what runs, not a value.
    open_h = np.zeros(n, bool)
    open_h[start] = True
    closed_h = np.zeros(n, bool)
    path_len = np.zeros(n, np.int64)
    path_len[start] = 1

    pops = relaxations = 0
    found = False
    while True:
        # -- pop: lexicographic argmin of (f_open, col, row) ---------------------
        masked_f = torch.where(in_open, f_open, INF)
        fmin = masked_f.min()
        cur = int(torch.where(masked_f == fmin, tie_static, n * n).argmin())
        if not math.isfinite(float(fmin)):
            break                                        # exhausted
        pops += 1
        if cur == goal:
            found = True
            break
        in_open[cur] = False
        open_h[cur] = False
        closed_h[cur] = True
        # Dead-end pops (non-walkable, non-start) close without expanding.
        if not (walk_flat[cur] or cur == start):
            continue

        cur_path = path_buf[cur]
        cur_len = int(path_len[cur])
        cur_g = g_score[cur]
        terms = _window_terms(cur_path, cur_len, cols, p)
        cr, cc = divmod(cur, cols)
        # Neighbour order right, left, down, up (the reference's).
        for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nr, nc = cr + dr, cc + dc
            if not (0 <= nr < rows and 0 <= nc < cols):
                continue
            nxt = nr * cols + nc
            if closed_h[nxt]:
                continue
            relaxations += 1
            # The analysis warms the cache for valid relaxations only.
            max_angle = zero
            if terms is not None:
                max_angle, cache = _apply_cache(terms, cache, p)
            angle_pen = torch.where(
                max_angle <= p.angle_grace_deg, 0.0,
                (max_angle / p.angle_denominator) ** p.angle_exponent)
            cell_pen = pen_f[nxt] if walk_flat[nxt] else zero
            mult = (1.0 + p.penalty_weight * cell_pen
                    + p.angle_weight * angle_pen)
            tentative = cur_g + g * mult

            if bool(tentative < g_score[nxt]):
                g_score[nxt] = tentative
                # A path longer than max_len overwrites its last slot, as the
                # reference's buffer does; such a goal is reported invalid.
                path_buf[nxt] = cur_path
                path_buf[nxt, min(cur_len, L - 1)] = nxt
                path_len[nxt] = cur_len + 1
                # Push only if not already queued; stale priority kept.
                if not open_h[nxt]:
                    f_open[nxt] = tentative + heuristic(nxt)
                    in_open[nxt] = True
                    open_h[nxt] = True

    ok = found and path_len[goal] <= L
    length = int(path_len[goal]) if ok else 0
    flat = path_buf[goal].clone()
    flat[length:] = -1
    cost = g_score[goal].clone() if ok else torch.full_like(zero, INF)
    return flat, length, cost, cache, pops, relaxations


def _cells(flat: torch.Tensor, cols: int) -> torch.Tensor:
    """(..., L) flat indices (-1 padded) -> (..., L, 2) int32 (row, col)."""
    pad = flat < 0
    return torch.stack([torch.where(pad, -1, flat // cols),
                        torch.where(pad, -1, flat % cols)], dim=-1).to(torch.int32)


@torch.no_grad()
def device_astar_paths_plain(walkable, penalty, start_rc, goals_rc, goals_valid,
                             cache, return_counts: bool = False, **kwargs):
    """The plain PyTorch version of ``device_astar_paths``, on the tensors'
    device. With ``return_counts`` also a (K, 2) list of (pops, relaxations)
    per goal."""
    p = _Params(**kwargs)
    rows, cols = walkable.shape
    dev = walkable.device
    walk_h = walkable.cpu().numpy().astype(bool)
    pen_f = penalty.to(torch.float32).reshape(-1)
    sr, sc = (int(v) for v in start_rc.tolist())
    goals = goals_rc.tolist()
    valid_h = goals_valid.tolist()
    k_goals = len(goals)

    flat = torch.full((k_goals, p.max_len), -1, dtype=torch.int64, device=dev)
    lengths = torch.zeros((k_goals,), dtype=torch.int32, device=dev)
    costs = torch.full((k_goals,), INF, dtype=torch.float32, device=dev)
    counts = []
    cache = cache.to(torch.float32)
    for k, (goal, valid) in enumerate(zip(goals, valid_h)):
        if not valid:
            # Skipped: cannot touch the cache. The JAX loop searches such a
            # goal against the start cell, a one-pop no-op whose one-cell
            # path stays in ``cells`` under length 0; kept for equal payloads.
            flat[k, 0] = sr * cols + sc
            counts.append((0, 0))
            continue
        flat[k], length, costs[k], cache, pops, relax = _search(
            walk_h, pen_f, sr * cols + sc, int(goal[0]) * cols + int(goal[1]),
            cache, p)
        lengths[k] = length
        counts.append((pops, relax))
    batch = PathBatch(cells=_cells(flat, cols), lengths=lengths, costs=costs,
                      valid=goals_valid.bool() & (lengths > 0))
    if return_counts:
        return batch, cache, counts
    return batch, cache


def device_astar(walkable: torch.Tensor, penalty: torch.Tensor,
                 start_rc: torch.Tensor, goal_rc: torch.Tensor,
                 cache: torch.Tensor, *, grid_size: int = 20,
                 max_len: int = 512, angle_window: int = 7,
                 angle_grace_deg: float = 30.0, angle_exponent: float = 1.5,
                 angle_denominator: float = 90.0, penalty_weight: float = 0.5,
                 angle_weight: float = 1.5,
                 replicate_radians_cache_bug: bool = True
                 ) -> DeviceAStarResult:
    """One exact search. walkable (R, C) bool, penalty (R, C) f32,
    start/goal (2,) int (row, col), cache from empty_cache() or a prior
    result (cross-frame state). The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    batch, cache_out = device_astar_paths(
        walkable, penalty, start_rc, goal_rc[None],
        torch.ones((1,), dtype=torch.bool, device=walkable.device), cache,
        grid_size=grid_size, max_len=max_len, angle_window=angle_window,
        angle_grace_deg=angle_grace_deg, angle_exponent=angle_exponent,
        angle_denominator=angle_denominator, penalty_weight=penalty_weight,
        angle_weight=angle_weight,
        replicate_radians_cache_bug=replicate_radians_cache_bug)
    return DeviceAStarResult(cells=batch.cells[0], length=batch.lengths[0],
                             cost=batch.costs[0], cache=cache_out)


def device_astar_paths(walkable: torch.Tensor, penalty: torch.Tensor,
                       start_rc: torch.Tensor, goals_rc: torch.Tensor,
                       goals_valid: torch.Tensor, cache: torch.Tensor,
                       **kwargs) -> tuple[PathBatch, torch.Tensor]:
    """Sequential multi-goal search with the carried angle cache: the
    reference iterates peaks in order through ONE stateful PathFinder, so
    goal k's costs depend on the cache warmed by goals 0..k-1. Returns
    (PathBatch, cache_out).

    goals_rc (K, 2) int, goals_valid (K,) bool. Invalid goals are skipped
    without touching the cache and masked out of the result. Nothing is read
    back to the host on the card: the cache feeds the next frame's search
    before the host sees this frame's result.

    With a leading stream dimension on every tensor (walkable (S, R, C) ...
    cache (S, 1226)) the S streams search side by side, each with its own
    cache, in one launch on the card.
    """
    # The wrapper decides by the tensors' device: kernel or plain version.
    from vision_assist_tpu_torch.ops.cuda_astar import astar_paths_cuda

    single = walkable.dim() == 2
    args = (walkable, penalty, start_rc, goals_rc, goals_valid, cache)
    if single:
        args = tuple(x[None] for x in args)
    cells, lengths, costs, cache_out, _ = astar_paths_cuda(*args, **kwargs)
    batch = PathBatch(cells=cells, lengths=lengths, costs=costs,
                      valid=args[4].bool() & (lengths > 0))
    return (stream(batch, 0), cache_out[0]) if single else (batch, cache_out)
