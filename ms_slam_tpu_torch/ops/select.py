"""Sliding-window map-point selection: the MS-SLAM sparsification ILP.

Port of `ms_slam_tpu/ops/select.py`. The formulation, the three stages
(LP dual ascent, feasibility repair, batched safe-prune) and every constant
are the reference's; see its docstring for the derivation. Input layout:

  obs_pt   (K, N) int32   dense point slot (0..P-1) or -1
  obs_cell (K, N) int32   grid cell of the observation; >= n_cells marks a
                          row whose cells carry no coverage constraint
  obs_valid(K, N) bool, cost (P,) float32, p_valid (P,) bool,
  req_kf   (K,) int32     per-row coverage requirement

The reference's `lax.scan` and `fori_loop` are Python loops with fixed
trip counts (`n_iters`, `n_rounds`) and no host sync inside. Two rules pin
its tie behaviour:
- both rank tables come from a stable argsort (`jnp.argsort` is stable):
  near 1e6 the float32 spacing is 0.0625, so the sub-1 tiebreak term
  rounds away and equal-cost observations tie exactly;
- scatters go through `ops/indexing.py` (last write wins, out-of-range
  dropped).
A division by a compile-time constant is a multiplication by its float32
reciprocal here, because XLA compiles the reference's that way (the
tiebreak keys and the dual average differ in the last bit otherwise).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .indexing import add_at_, max_at_, set_at_


class SelectResult(NamedTuple):
    keep: torch.Tensor        # (P,) bool selected points
    lp_keep: torch.Tensor     # (P,) bool LP-rounded selection (pre-repair)
    kf_cover: torch.Tensor    # (K,) int32 final per-row kept observations


def _scatter_true(n: int, idx: torch.Tensor) -> torch.Tensor:
    """(n+1,) bool with True at idx (sentinel n absorbs masked entries)."""
    return set_at_(torch.zeros(n + 1, dtype=torch.bool, device=idx.device),
                   idx.reshape(-1), True)


def _rank_desc(key: torch.Tensor) -> torch.Tensor:
    """(K,N) position of each entry in its row's descending stable order."""
    K, N = key.shape
    order = torch.argsort(-key, dim=1, stable=True)
    ar = torch.arange(N, dtype=torch.int32, device=key.device)
    return torch.empty((K, N), dtype=torch.int32, device=key.device).scatter_(
        1, order, ar.expand(K, N))


def select_points(obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf,
                  lam: float = 500.0, lam_grid: float = 10.0,
                  n_cells: int = 64 * 48, n_iters: int = 60,
                  n_rounds: int = 24) -> SelectResult:
    """Solve one window's selection problem (float32 throughout)."""
    dev = obs_pt.device
    K, N = obs_pt.shape
    P = cost.shape[0]
    f32 = torch.float32
    lam, lam_grid = float(lam), float(lam_grid)
    obs_ok = obs_valid & (obs_pt >= 0)
    pt = torch.where(obs_ok, obs_pt, P).long()              # sentinel P
    ptc = obs_pt.clamp(0, P - 1).long()
    cell_ok = obs_ok & (obs_cell >= 0) & (obs_cell < n_cells)
    G = K * n_cells
    rows = torch.arange(K, device=dev)[:, None]
    gcell = torch.where(cell_ok, rows * n_cells + obs_cell, G).long()

    occupied = _scatter_true(G, gcell)
    occupied[G] = False

    req_f = req_kf.to(f32)
    cost_obs = cost[ptc]
    # unique float tie-break keys (costs are typically small integers)
    tiebreak = ptc.to(f32) * (1.0 / (P + 2.0))
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)

    # ---- stage 1: dual ascent on the LP relaxation ----
    cmax = torch.clamp(torch.max(torch.where(p_valid, cost, 0.0)), min=1.0)
    obs_okf = obs_ok.to(f32)

    def score_of(y_kf, y_cell):
        contrib = (y_kf[:, None] + y_cell[gcell]) * obs_okf
        return add_at_(torch.zeros(P + 1, dtype=f32, device=dev), pt,
                       contrib)[:P]

    half_at = n_iters - n_iters // 2            # averaging window start
    y_kf = torch.zeros(K, dtype=f32, device=dev)
    y_cell = torch.zeros(G + 1, dtype=f32, device=dev)
    acc_kf = torch.zeros_like(y_kf)
    acc_cell = torch.zeros_like(y_cell)
    occ_f = occupied.to(f32)
    req_den = torch.clamp(req_f, min=1.0)
    for t in range(n_iters):
        score = score_of(y_kf, y_cell)
        x = ((score > cost) & p_valid).to(f32)
        xv = x[ptc] * obs_okf
        cover_kf = xv.sum(1)
        cover_cell = add_at_(torch.zeros(G + 1, dtype=f32, device=dev),
                             gcell, xv)
        eta = cmax / (2.0 + 0.5 * t)
        y_kf = torch.clamp(y_kf + eta * (req_f - cover_kf) / req_den,
                           0.0, lam)
        y_cell = torch.clamp(y_cell + eta * (1.0 - cover_cell) * occ_f,
                             0.0, lam_grid)
        if t >= half_at:
            acc_kf = acc_kf + y_kf
            acc_cell = acc_cell + y_cell
    inv_n = 1.0 / float(max(n_iters - half_at, 1))
    lp_keep = (score_of(acc_kf * inv_n, acc_cell * inv_n) > cost) & p_valid

    # ---- stage 2: feasibility repair ----
    sel_obs = lp_keep[ptc] & obs_ok
    # per-row top-up to req: LP-selected observations first, then cheap
    prio = torch.where(obs_ok, sel_obs.to(f32) * 1e6 - cost_obs - tiebreak,
                       neg_inf)
    topup = _rank_desc(prio) < req_kf[:, None]
    keep_obs0 = (sel_obs | topup) & obs_ok
    # price-aware cell repair: cover an uncovered occupied cell only when
    # its cheapest covering point costs less than the lambda_grid slack
    covered0 = _scatter_true(G, torch.where(keep_obs0 & cell_ok, gcell, G))
    uncov = occupied & ~covered0
    cprio = torch.where(cell_ok & uncov[gcell], -cost_obs - tiebreak, neg_inf)
    cbest = max_at_(torch.full((G + 1,), float("-inf"), dtype=f32,
                               device=dev), gcell, cprio)
    cell_best = ((cprio == cbest[gcell]) & (cprio > neg_inf)
                 & (cost_obs < lam_grid))
    keep_obs = keep_obs0 | cell_best
    keep = _scatter_true(P, torch.where(keep_obs, pt, P))[:P] & p_valid

    # ---- stage 3: batched safe-prune rounds ----
    def scatter_or_p(mask_obs):
        return _scatter_true(P, torch.where(mask_obs, pt, P))[:P]

    for _ in range(n_rounds):
        kept_obs = keep[ptc] & obs_ok
        cover = kept_obs.sum(1)
        slack = torch.clamp(cover - req_kf, min=0)               # (K,)
        cell_cover = add_at_(
            torch.zeros(G + 1, dtype=torch.int32, device=dev),
            torch.where(kept_obs & cell_ok, gcell, G), 1)
        # gain of dropping p: its cost minus the lambda_grid slack for every
        # priced cell it is the sole cover of
        sole = kept_obs & cell_ok & (cell_cover[gcell] == 1)
        sole_cnt = add_at_(torch.zeros(P + 1, dtype=f32, device=dev),
                           torch.where(sole, pt, P), 1.0)[:P]
        gain = cost - lam_grid * sole_cnt
        # zero-cost points covering no sole cell are objective-indifferent:
        # drop them when row slack allows
        cand_p = keep & ((gain > 0) | ((cost <= 0) & (sole_cnt == 0)))
        # a point kept by a row with no slack can never drop this round
        cand_p = cand_p & ~scatter_or_p(kept_obs & (slack == 0)[:, None])
        cand_obs = cand_p[ptc] & kept_obs
        # per-row cap: candidates ranked by gain, admit rank < slack
        gprio = torch.where(cand_obs, gain[ptc] - tiebreak, neg_inf)
        row_admit = cand_obs & (_rank_desc(gprio) < slack[:, None])
        drop_p = cand_p & ~scatter_or_p(cand_obs & ~row_admit)
        # per-cell cap: at most one non-sole cover drops per priced cell
        dobs = drop_p[ptc] & kept_obs & cell_ok & (cell_cover[gcell] >= 2)
        dprio = torch.where(dobs, gain[ptc] - tiebreak, neg_inf)
        dbest = max_at_(torch.full((G + 1,), float("-inf"), dtype=f32,
                                   device=dev), gcell, dprio)
        drop_p = drop_p & ~scatter_or_p(dobs & (dprio < dbest[gcell]))
        keep = keep & ~drop_p

    kf_cover = (keep[ptc] & obs_ok).sum(1).to(torch.int32)
    return SelectResult(keep=keep, lp_keep=lp_keep, kf_cover=kf_cover)


def selection_cost(keep, cost, kf_cover, req_kf, lam, obs_pt=None,
                   obs_cell=None, obs_valid=None, lam_grid=0.0,
                   n_cells=None):
    """Objective value of a selection (for tests): point costs + lambda *
    per-row shortfall (+ lambda_grid * uncovered occupied cells)."""
    c = torch.sum(torch.where(keep, cost, 0.0))
    short = torch.sum(torch.clamp(req_kf - kf_cover, min=0) * lam)
    cell_pen = 0.0
    if obs_pt is not None and lam_grid:
        K, N = obs_pt.shape
        P = cost.shape[0]
        G = K * n_cells
        obs_ok = obs_valid & (obs_pt >= 0)
        priced = obs_ok & (obs_cell >= 0) & (obs_cell < n_cells)
        rows = torch.arange(K, device=obs_pt.device)[:, None]
        gcell = torch.where(priced, rows * n_cells + obs_cell, G).long()
        occupied = _scatter_true(G, gcell)
        occupied[G] = False
        kept = keep[obs_pt.clamp(0, P - 1).long()] & priced
        covered = _scatter_true(G, torch.where(kept, gcell, G))
        cell_pen = lam_grid * torch.sum(occupied & ~covered)
    return c + short + cell_pen
