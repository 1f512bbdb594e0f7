"""Batched pathfinding: direction-expanded min-plus wavefront.

State = (row, col, incoming direction). One single-source relaxation serves
every goal; each goal's path is then traced back through the converged
field. Everything is fixed-shape.

:func:`relax_field` is the plain PyTorch twin of the CUDA kernel in
``ops/cuda_wavefront.py``: Jacobi sweeps of
``dist[d] = min(dist[d], fl(fl(min_d'(fl(parent[d'] + T[d', d]))) + enter))``
from 0 at the start cell and INF elsewhere, until a sweep changes nothing or
``R*C`` sweeps have run. Both reach the same fixed point bit for bit.

:func:`relax_sweep_field` is the plain twin of the fast-sweeping kernel in
``ops/cuda_sweep.py`` (``csrc/relax_sweep.cu``): the same passes of four
directional min-plus scans, each scan in the kernel's level order, so the
two fields are bit-equal. :func:`relax` and :func:`relax_sweep` launch the
kernels on CUDA tensors and run the twins on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Large-but-finite float32 "infinity" (the reference's constant).
INF = 3.0e38

# Moves indexed d = 0..3: right, left, down, up — the reference's neighbour
# order. Entries are (dr, dc).
MOVES = np.array([(0, 1), (0, -1), (1, 0), (-1, 0)], dtype=np.int32)


def _turn_cost_matrix(angle_grace_deg: float, angle_exponent: float,
                      angle_denominator: float) -> np.ndarray:
    """T[d_prev, d_next] = angle-penalty term for the direction change."""
    t = np.zeros((4, 4), dtype=np.float32)
    for i in range(4):
        for j in range(4):
            vi, vj = MOVES[i], MOVES[j]
            dot = float(vi[0] * vj[0] + vi[1] * vj[1])
            ang = np.degrees(np.arccos(np.clip(dot, -1.0, 1.0)))
            t[i, j] = 0.0 if ang <= angle_grace_deg else (
                (ang / angle_denominator) ** angle_exponent)
    return t


def _scaled_turn(grid_size: float, angle_weight: float,
                 angle_grace_deg: float, angle_exponent: float,
                 angle_denominator: float, device=None) -> torch.Tensor:
    """The turn-cost matrix in field units — the one pricing of direction
    changes shared by the relaxation and backtrace."""
    return torch.from_numpy(
        _turn_cost_matrix(angle_grace_deg, angle_exponent, angle_denominator)
        * (grid_size * angle_weight)).to(device)


def enter_cost(walkable: torch.Tensor, penalty: torch.Tensor, grid_size: float,
               penalty_weight: float) -> torch.Tensor:
    """Cost of entering each cell, whatever the direction; INF off the
    walkable region."""
    return torch.where(
        walkable.bool(),
        grid_size * (1.0 + penalty_weight * penalty.float()),
        INF)


@dataclasses.dataclass
class PathBatch:
    """K padded paths over the lattice (forward order, (row, col) cells);
    with a leading stream dimension on every field for S streams."""

    cells: Any    # (K, L, 2) int32, -1 padded
    lengths: Any  # (K,) int32
    costs: Any    # (K,) float32
    valid: Any    # (K,) bool


def closest_walkable_cell(walkable: torch.Tensor, point_xy: torch.Tensor,
                          grid_size: int = 20) -> torch.Tensor:
    """(..., 2) (row, col) of the walkable cell whose centre is nearest each
    pixel point (..., 2); row-major first-minimum tie-breaking. Squared
    integer distances keep the comparison exact.

    walkable (R, C) serves every point; walkable (S, R, C) takes points
    (S, 2) or (S, K, 2), stream s's points looked up in stream s's lattice."""
    rows, cols = walkable.shape[-2], walkable.shape[-1]
    half = grid_size // 2
    dev = walkable.device
    cx = torch.arange(cols, dtype=torch.int64, device=dev) * grid_size + half
    cy = torch.arange(rows, dtype=torch.int64, device=dev) * grid_size + half
    p = point_xy.to(dev).long()
    dx = p[..., 0, None, None] - cx[None, :]
    dy = p[..., 1, None, None] - cy[:, None]
    d2 = dx * dx + dy * dy
    lead = walkable.shape[:-2]
    if p.shape[:len(lead)] != lead:
        raise ValueError(f"closest_walkable_cell: points {tuple(p.shape)} do not "
                         f"carry the lattices' streams {tuple(lead)}")
    walk = walkable.bool().reshape(*lead, *(1,) * (p.dim() - 1 - len(lead)),
                                   rows, cols)
    d2 = torch.where(walk, d2, 1 << 30)
    flat = torch.argmin(d2.flatten(-2), dim=-1)  # first occurrence: row-major
    return torch.stack([flat // cols, flat % cols], dim=-1).to(torch.int32)


def _shift_from_parent(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """x (..., R, C) sampled at each cell's parent (cell - (dr, dc)); INF
    off-lattice."""
    out = torch.full_like(x, INF)
    rows, cols = x.shape[-2], x.shape[-1]
    out[..., max(dr, 0):rows + min(dr, 0), max(dc, 0):cols + min(dc, 0)] = \
        x[..., max(-dr, 0):rows - max(dr, 0), max(-dc, 0):cols - max(dc, 0)]
    return out


def relax_field(enter: torch.Tensor, start: torch.Tensor, turn: torch.Tensor,
                max_sweeps: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the relax kernel.

    enter (B, R, C) f32, start (B, 2) int, turn (4, 4) f32 ->
    (dist (B, R, C, 4) f32, sweeps (B,) int32: the sweeps each stream ran,
    the last of them being the one that changed nothing)."""
    b, rows, cols = enter.shape
    dev = enter.device
    if max_sweeps is None:
        max_sweeps = rows * cols
    start = start.to(dev).long()
    dist = torch.full((b, 4, rows, cols), INF, dtype=torch.float32, device=dev)
    dist[torch.arange(b, device=dev), :, start[:, 0], start[:, 1]] = 0.0
    sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    for _ in range(max_sweeps):
        cands = []
        for d in range(4):
            parent = _shift_from_parent(dist, int(MOVES[d][0]), int(MOVES[d][1]))
            cands.append(torch.min(parent + turn[:, d, None, None], dim=1).values
                         + enter)
        new = torch.minimum(dist, torch.stack(cands, dim=1))
        sweeps += active.to(torch.int32)
        changed = (new < dist).flatten(1).any(dim=1)
        dist = new
        active &= changed
        if not bool(active.any()):
            break
    return dist.permute(0, 2, 3, 1).contiguous(), sweeps


def relax(walkable: torch.Tensor, penalty: torch.Tensor, start_rc: torch.Tensor,
          *, grid_size: int = 20, penalty_weight: float = 0.5,
          angle_weight: float = 1.5, angle_grace_deg: float = 30.0,
          angle_exponent: float = 1.5, angle_denominator: float = 90.0,
          max_iters: int | None = None) -> torch.Tensor:
    """Single-source cost-to-come field dist (R, C, 4) over (cell, incoming
    direction) states; (S, R, C) lattices with (S, 2) starts give
    (S, R, C, 4).

    On CUDA tensors the relax kernel computes it (``ops/cuda_wavefront.py``,
    one launch for all the streams), bit-equal to the plain twin
    :func:`relax_field`, which runs on CPU tensors. ``max_iters`` caps the
    twin's Jacobi sweeps; the kernel runs line passes, which cannot honour
    such a cap, so on the card a cap raises ``ValueError``."""
    single = walkable.dim() == 2
    turn = _scaled_turn(grid_size, angle_weight, angle_grace_deg,
                        angle_exponent, angle_denominator, walkable.device)
    enter = enter_cost(walkable, penalty, grid_size, penalty_weight)
    enter = enter[None] if single else enter
    start = start_rc.to(enter.device).reshape(-1, 2)
    if walkable.device.type == "cpu":
        dist, _ = relax_field(enter, start, turn, max_iters)
    elif max_iters is not None:
        raise ValueError("relax: max_iters counts Jacobi sweeps, which the relax "
                         "kernel does not run; a cap is taken on CPU tensors only")
    else:
        from vision_assist_tpu_torch.ops.cuda_wavefront import relax_field_cuda

        dist, _ = relax_field_cuda(enter, start, turn)
    return dist[0] if single else dist


def _ahead_behind(x: torch.Tensor, s: int, reverse: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Views of x along the last axis: the positions that have a neighbour
    s steps behind them in scan order, and those neighbours."""
    return (x[..., :-s], x[..., s:]) if reverse else (x[..., s:], x[..., :-s])


def _scan_levels(b: torch.Tensor, reverse: bool) -> list[torch.Tensor]:
    """The ``b`` halves of the doubling scan along the last axis: level k
    holds, at each position, the sum of ``b`` over the 2**k positions that
    end there in scan order, clipped at the line's start. They depend only
    on the entry costs, so one set serves every pass."""
    levels, s = [b], 1
    while 2 * s < b.shape[-1]:
        nxt = b.clone()
        here, behind = _ahead_behind(b, s, reverse)
        _ahead_behind(nxt, s, reverse)[0].copy_(here + behind)
        levels.append(nxt)
        b, s = nxt, 2 * s
    return levels


def _min_plus_scan(a: torch.Tensor, levels: list[torch.Tensor],
                   reverse: bool) -> torch.Tensor:
    """x[i] = min(a[i], x[i-1] + b[i]) along the last axis (x[i+1] for a
    reverse scan), in place on ``a``, by log-step doubling over the min-plus
    affine semigroup (a1, b1) * (a2, b2) = (min(a2, a1 + b2), b1 + b2)."""
    for k, b in enumerate(levels):
        here, behind = _ahead_behind(a, 2 ** k, reverse)
        torch.minimum(here, behind + _ahead_behind(b, 2 ** k, reverse)[0], out=here)
    return a


def relax_sweep_field(enter: torch.Tensor, start: torch.Tensor, turn: torch.Tensor,
                      max_passes: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the fast-sweeping kernel.

    enter (B, R, C) f32, start (B, 2) int, turn (4, 4) f32 ->
    (dist (B, R, C, 4) f32, passes (B,) int32: the passes each stream ran,
    the last of them being the one that changed nothing unless
    ``max_passes`` (default R*C) stopped it first).

    Each pass runs four directional scans in Gauss-Seidel order (right,
    left, down, up). The scan of direction d takes, at each cell, h the best
    cost of standing there ready to step in direction d, sets
    ``A[i] = min(old[i], h[i-1] + enter[i])`` along every line of that
    direction (position 0 of a line stays), then solves
    ``x[i] = min(A[i], x[i-1] + enter[i])`` for all lines together by
    :func:`_min_plus_scan`. The loop runs until no stream changes (one host
    sync per pass); a pass is a function of the field alone, so a stream
    that has converged keeps its field bit for bit through the passes it
    sits out, and its count stops where it converged. The scan
    re-associates the float32 sums along a run, so the field agrees with
    :func:`relax_field` to round-off on reachable states, not bit for bit.
    """
    n_streams, rows, cols = enter.shape
    dev = enter.device
    start = start.to(dev).long().reshape(n_streams, 2)
    dist = torch.full((n_streams, 4, rows, cols), INF, dtype=torch.float32,
                      device=dev)
    dist[torch.arange(n_streams, device=dev), :, start[:, 0], start[:, 1]] = 0.0
    # Scans run along the last axis: vertical moves see transposed views.
    across = [bool(dc) for _, dc in MOVES]
    reverse = [int(dr + dc) < 0 for dr, dc in MOVES]
    ent = [enter if across[d] else enter.transpose(-1, -2) for d in range(4)]
    levels = [_scan_levels(ent[d], reverse[d]) for d in range(4)]

    passes = torch.zeros(n_streams, dtype=torch.int32, device=dev)
    active = torch.ones(n_streams, dtype=torch.bool, device=dev)
    for _ in range(rows * cols if max_passes is None else max_passes):
        new = dist.clone()
        for d in range(4):  # Gauss-Seidel: later scans see earlier updates
            h = torch.min(new + turn[:, d, None, None], dim=1).values
            a, h = (new[:, d], h) if across[d] else (
                new[:, d].transpose(-1, -2), h.transpose(-1, -2))
            here, _ = _ahead_behind(a, 1, reverse[d])
            torch.minimum(here, _ahead_behind(h, 1, reverse[d])[1]
                          + _ahead_behind(ent[d], 1, reverse[d])[0], out=here)
            _min_plus_scan(a, levels[d], reverse[d])
        passes += active.to(torch.int32)
        active &= (new < dist).flatten(1).any(dim=1)
        dist = new
        if not bool(active.any()):
            break
    return dist.permute(0, 2, 3, 1).contiguous(), passes


def relax_sweep(walkable: torch.Tensor, penalty: torch.Tensor,
                start_rc: torch.Tensor, *, grid_size: int = 20,
                penalty_weight: float = 0.5, angle_weight: float = 1.5,
                angle_grace_deg: float = 30.0, angle_exponent: float = 1.5,
                angle_denominator: float = 90.0,
                max_passes: int | None = None) -> torch.Tensor:
    """Fast-sweeping form of :func:`relax`: the same min-plus fixed point in
    far fewer iterations, dist (R, C, 4); (S, R, C) lattices with (S, 2)
    starts give (S, R, C, 4).

    On CUDA tensors the fast-sweeping kernel computes it, all passes of all
    streams in one launch (``ops/cuda_sweep.py``); on CPU tensors its plain
    twin :func:`relax_sweep_field` does, bit for bit the same field. At most
    ``max_passes`` passes run (default R*C, which never binds).
    """
    from vision_assist_tpu_torch.ops.cuda_sweep import relax_sweep_field_cuda

    single = walkable.dim() == 2
    turn = _scaled_turn(grid_size, angle_weight, angle_grace_deg,
                        angle_exponent, angle_denominator, walkable.device)
    enter = enter_cost(walkable, penalty, grid_size, penalty_weight)
    dist, _ = relax_sweep_field_cuda(enter[None] if single else enter,
                                     start_rc.to(enter.device).reshape(-1, 2), turn,
                                     max_passes)
    return dist[0] if single else dist


def backtrace(dist: torch.Tensor, start_rc: torch.Tensor, goals_rc: torch.Tensor,
              *, grid_size: int = 20, angle_grace_deg: float = 30.0,
              angle_exponent: float = 1.5, angle_denominator: float = 90.0,
              angle_weight: float = 1.5, max_len: int = 512
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward-order paths start->goal for K goals from the converged field.

    Each state (r, c, d) has one parent state: the cell it came from and
    that cell's cheapest incoming direction under the turn cost (first
    minimum); the start cell is its own parent. The K walks of ``max_len``
    states are built by pointer doubling (log2(max_len) gathers), so the
    output is the full fixed-length walk with no early exit.

    Returns (cells (K, max_len, 2) int32 padded with -1, lengths (K,),
    costs (K,) f32, valid (K,) bool). With a leading stream dimension on
    dist (S, R, C, 4), start_rc (S, 2) and goals_rc (S, K, 2), on each
    result too.
    """
    single = dist.dim() == 3
    if single:
        dist, start_rc, goals_rc = dist[None], start_rc[None], goals_rc[None]
    n_streams, rows, cols, _ = dist.shape
    dev = dist.device
    turn = _scaled_turn(grid_size, angle_weight, angle_grace_deg,
                        angle_exponent, angle_denominator, dev)
    moves = torch.from_numpy(MOVES).to(dev).long()
    sr, sc = start_rc.to(dev).long().unbind(-1)              # (S,) each

    # Parent-state table over all R*C*4 states, flat index (r*C + c)*4 + d.
    r = torch.arange(rows, device=dev)[:, None, None]
    c = torch.arange(cols, device=dev)[None, :, None]
    d = torch.arange(4, device=dev)[None, None, :]
    pr = torch.clamp(r - moves[:, 0][d], 0, rows - 1)
    pc = torch.clamp(c - moves[:, 1][d], 0, cols - 1)
    parent_costs = dist[:, pr, pc] + turn.t()[d]         # (S, R, C, 4, 4 d')
    pd = torch.argmin(parent_costs, dim=-1)
    nxt = (pr * cols + pc) * 4 + pd
    here = (r * cols + c) * 4 + d
    at = (r == sr[:, None, None, None]) & (c == sc[:, None, None, None])
    nxt = torch.where(at, here, nxt).reshape(n_streams, -1)

    goals = goals_rc.to(dev).long()
    streams = torch.arange(n_streams, device=dev)[:, None]
    goal_dists = dist[streams, goals[..., 0], goals[..., 1]]   # (S, K, 4)
    d0 = torch.argmin(goal_dists, dim=-1)
    cost = goal_dists.gather(-1, d0[..., None])[..., 0]
    valid = cost < INF / 2

    k = goals.shape[1]
    walk = torch.empty((n_streams, k, max_len), dtype=torch.int64, device=dev)
    walk[..., 0] = (goals[..., 0] * cols + goals[..., 1]) * 4 + d0
    jump, filled = nxt, 1
    while filled < max_len:
        n = min(filled, max_len - filled)
        walk[..., filled:filled + n] = jump.gather(
            1, walk[..., :n].reshape(n_streams, -1)).reshape(n_streams, k, n)
        jump = jump.gather(1, jump)
        filled += n

    cell = walk // 4
    rc = torch.stack([cell // cols, cell % cols], dim=-1)   # (S, K, L, 2)
    at_start = (rc[..., 0] == sr[:, None, None]) & (rc[..., 1] == sc[:, None, None])
    reached = at_start.any(dim=-1)
    first = torch.argmax(at_start.to(torch.uint8), dim=-1)  # first arrival
    valid = valid & reached
    length = torch.where(valid, first + 1, 0)
    pos = first[..., None] - torch.arange(max_len, device=dev)
    keep = valid[..., None] & (pos >= 0)
    cells = torch.gather(rc, 2, torch.clamp(pos, min=0)[..., None].expand(
        -1, -1, -1, 2))
    cells = torch.where(keep[..., None], cells, -1).to(torch.int32)
    cost = torch.where(valid, cost, INF)
    out = (cells, length.to(torch.int32), cost, valid)
    return tuple(x[0] for x in out) if single else out


def find_paths(walkable: torch.Tensor, penalty: torch.Tensor,
               start_rc: torch.Tensor, goals_rc: torch.Tensor,
               goals_valid: torch.Tensor, *, grid_size: int = 20,
               max_len: int = 512, penalty_weight: float = 0.5,
               angle_weight: float = 1.5, angle_grace_deg: float = 30.0,
               angle_exponent: float = 1.5, angle_denominator: float = 90.0,
               use_pallas: bool = False, use_sweep: bool = True) -> PathBatch:
    """Paths from one start to K goal cells sharing a single relaxation;
    with a leading stream dimension on every tensor, S starts to their K
    goals each, the relaxation of all streams in one call.

    The relaxation defaults to the fast-sweeping form (:func:`relax_sweep`);
    ``use_sweep=False`` selects the plain per-cell relaxation
    (:func:`relax`), and ``use_pallas`` the relax kernel's wrapper. Each runs
    its kernel on a CUDA tensor, one launch for all the streams, and its
    plain twin on a CPU tensor.
    """
    kw = dict(grid_size=grid_size, penalty_weight=penalty_weight,
              angle_weight=angle_weight, angle_grace_deg=angle_grace_deg,
              angle_exponent=angle_exponent,
              angle_denominator=angle_denominator)
    if use_pallas:
        from vision_assist_tpu_torch.ops.cuda_wavefront import relax_cuda

        dist = relax_cuda(walkable, penalty, start_rc, **kw)
    elif use_sweep:
        dist = relax_sweep(walkable, penalty, start_rc, **kw)
    else:
        dist = relax(walkable, penalty, start_rc, **kw)

    cells, lengths, costs, valid = backtrace(
        dist, start_rc, goals_rc, grid_size=grid_size,
        angle_grace_deg=angle_grace_deg, angle_exponent=angle_exponent,
        angle_denominator=angle_denominator, angle_weight=angle_weight,
        max_len=max_len)
    valid = valid & goals_valid.to(valid.device)
    return PathBatch(cells=cells, lengths=torch.where(valid, lengths, 0),
                     costs=costs, valid=valid)
