"""The plain map-point selection of one sparsification window: which of the
window's points MS-SLAM keeps.

A frozen copy, in plain PyTorch float32, of the port's selection as it
stood when the benchmark was written (`ms_slam_tpu_torch/pipeline/
sparsification.py`: `build_window_tables`; `ops/select.py`:
`select_points`, the LP dual ascent, the feasibility repair and the
safe-prune rounds with every constant), with plain scatters in place of
the port's `ops/indexing.py`. It imports nothing of the port. It starts
from the map as it stood when the window was solved (the observation
table, the keypoints, the valid masks) and works out the window's
instance itself, so a later change to the port's tables or selector is
held against this copy.

`objective` is the selection's cost as MS-SLAM defines it: the kept points'
costs, lambda per missing observation under a keyframe's requirement, and
lambda_grid per occupied grid cell left uncovered.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32
I32 = torch.int32


class Window(NamedTuple):
    """One window as the port's sparsifier was handed it."""

    obs_mp: torch.Tensor      # (K, N) int32 map point per feature slot or -1
    kp_xy: torch.Tensor       # (K, N, 2) float32
    kf_valid: torch.Tensor    # (K,) bool
    mp_valid: torch.Tensor    # (M,) bool
    win_idx: torch.Tensor     # (W,) int32 keyframe slots
    win_mask: torch.Tensor    # (W,) bool
    n_req: int
    lam: float
    lam_grid: float
    grid_w: int
    grid_h: int
    img_w: int
    img_h: int
    pt_cap: int
    n_outkf: int


def _mark(n: int, idx: torch.Tensor) -> torch.Tensor:
    """(n + 1,) bool, True at idx (index n takes the masked entries)."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    out[idx.reshape(-1).long()] = True
    return out


def _add(n: int, idx: torch.Tensor, v, dtype) -> torch.Tensor:
    out = torch.zeros(n + 1, dtype=dtype, device=idx.device)
    v = torch.as_tensor(v, dtype=dtype, device=idx.device).expand(idx.shape)
    return out.index_add_(0, idx.reshape(-1).long(), v.reshape(-1))


def _max(n: int, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    out = torch.full((n + 1,), float("-inf"), dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, idx.reshape(-1).long(), v.reshape(-1),
                               reduce="amax")


def _rank_desc(key: torch.Tensor) -> torch.Tensor:
    """Position of each entry in its row's descending stable order."""
    K, N = key.shape
    order = torch.argsort(-key, dim=1, stable=True)
    ar = torch.arange(N, dtype=I32, device=key.device).expand(K, N)
    return torch.empty((K, N), dtype=I32, device=key.device).scatter_(
        1, order, ar)


def tables(w: Window):
    """The window's instance: (obs_pt, obs_cell, obs_ok, cost, pt_idx,
    pt_valid, req). Rows are the window's keyframes, then the out-of-window
    keyframes that see the most window points, each asked for its share of
    the requirement and free of the grid."""
    dev = w.obs_mp.device
    Kc, N = w.obs_mp.shape
    Mc = w.mp_valid.shape[0]
    n_cells = w.grid_w * w.grid_h
    wi = w.win_idx.long()
    win_mask = w.win_mask & w.kf_valid[wi]

    # the window's points, packed in slot order up to pt_cap
    obs = torch.where(win_mask[:, None], w.obs_mp[wi], -1)
    pmask = _mark(Mc, torch.where(obs >= 0, obs, Mc))[:Mc] & w.mp_valid
    pos = torch.cumsum(pmask.to(I32), 0) - 1
    keep_slot = pmask & (pos < w.pt_cap)
    pt_idx = torch.zeros(w.pt_cap, dtype=I32, device=dev)
    pt_idx[pos[keep_slot].long()] = torch.nonzero(keep_slot)[:, 0].to(I32)
    n_pt = int(min(int(pmask.sum()), w.pt_cap))
    pt_valid = torch.arange(w.pt_cap, device=dev) < n_pt
    inv = torch.full((Mc + 1,), -1, dtype=I32, device=dev)
    inv[pt_idx[:n_pt].long()] = torch.arange(n_pt, dtype=I32, device=dev)

    def dense(o):
        return inv[o.clamp(0, Mc).long()]

    obs_w = w.obs_mp[wi]
    pt_w = dense(obs_w)
    ok_w = (obs_w >= 0) & (pt_w >= 0) & win_mask[:, None]
    xy = w.kp_xy[wi]
    cx = torch.clamp((xy[..., 0] * w.grid_w / w.img_w).to(I32), 0,
                     w.grid_w - 1)
    cy = torch.clamp((xy[..., 1] * w.grid_h / w.img_h).to(I32), 0,
                     w.grid_h - 1)
    cell_w = cy * w.grid_w + cx

    in_win = _mark(Kc, torch.where(win_mask, wi, Kc))[:Kc]
    sees = (w.obs_mp >= 0) & (dense(w.obs_mp) >= 0)
    votes = (sees.sum(1) * w.kf_valid * ~in_win).to(I32)
    votes_out, out_idx = torch.sort(votes, descending=True, stable=True)
    votes_out, out_idx = votes_out[:w.n_outkf], out_idx[:w.n_outkf]
    out_mask = votes_out > 0
    obs_o = w.obs_mp[out_idx]
    pt_o = dense(obs_o)
    ok_o = (obs_o >= 0) & (pt_o >= 0) & out_mask[:, None]
    n_total = (obs_o >= 0).sum(1).to(I32)
    ratio = votes_out / torch.clamp(n_total, min=1)
    req_o = torch.ceil(ratio * w.n_req).to(I32) * out_mask

    obs_pt = torch.cat([pt_w, pt_o], 0)
    obs_cell = torch.cat([cell_w, torch.full_like(obs_o, n_cells)], 0)
    obs_ok = torch.cat([ok_w, ok_o], 0)
    req = torch.cat([torch.where(win_mask, w.n_req, 0).to(I32), req_o])

    # cost: the most observations any window point has, less the point's
    ob = torch.where(w.kf_valid[:, None], w.obs_mp, -1)
    n_obs = _add(Mc, torch.where(ob >= 0, ob, Mc), 1, I32)[:Mc]
    count = torch.where(pt_valid, n_obs[pt_idx.long()], 0)
    cost = (count.max() - count).to(F32)
    return obs_pt, obs_cell, obs_ok, cost, pt_idx, pt_valid, req


def select(obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf, lam,
           lam_grid, n_cells, n_iters: int = 60, n_rounds: int = 24):
    """(P,) bool: the points the selection keeps."""
    dev = obs_pt.device
    K, N = obs_pt.shape
    P = cost.shape[0]
    lam, lam_grid = float(lam), float(lam_grid)
    obs_ok = obs_valid & (obs_pt >= 0)
    pt = torch.where(obs_ok, obs_pt, P).long()
    ptc = obs_pt.clamp(0, P - 1).long()
    cell_ok = obs_ok & (obs_cell >= 0) & (obs_cell < n_cells)
    G = K * n_cells
    rows = torch.arange(K, device=dev)[:, None]
    gcell = torch.where(cell_ok, rows * n_cells + obs_cell, G).long()
    occupied = _mark(G, gcell)
    occupied[G] = False

    req_f = req_kf.to(F32)
    cost_obs = cost[ptc]
    tiebreak = ptc.to(F32) * (1.0 / (P + 2.0))
    neg_inf = torch.tensor(float("-inf"), dtype=F32, device=dev)

    # the LP relaxation's dual ascent, averaged over its second half
    cmax = torch.clamp(torch.max(torch.where(p_valid, cost, 0.0)), min=1.0)
    obs_okf = obs_ok.to(F32)

    def score_of(y_kf, y_cell):
        return _add(P, pt, (y_kf[:, None] + y_cell[gcell]) * obs_okf,
                    F32)[:P]

    half_at = n_iters - n_iters // 2
    y_kf = torch.zeros(K, dtype=F32, device=dev)
    y_cell = torch.zeros(G + 1, dtype=F32, device=dev)
    acc_kf = torch.zeros_like(y_kf)
    acc_cell = torch.zeros_like(y_cell)
    occ_f = occupied.to(F32)
    req_den = torch.clamp(req_f, min=1.0)
    for t in range(n_iters):
        x = ((score_of(y_kf, y_cell) > cost) & p_valid).to(F32)
        xv = x[ptc] * obs_okf
        cover_kf = xv.sum(1)
        cover_cell = _add(G, gcell, xv, F32)
        eta = cmax / (2.0 + 0.5 * t)
        y_kf = torch.clamp(y_kf + eta * (req_f - cover_kf) / req_den, 0.0,
                           lam)
        y_cell = torch.clamp(y_cell + eta * (1.0 - cover_cell) * occ_f, 0.0,
                             lam_grid)
        if t >= half_at:
            acc_kf = acc_kf + y_kf
            acc_cell = acc_cell + y_cell
    inv_n = 1.0 / float(max(n_iters - half_at, 1))
    lp_keep = (score_of(acc_kf * inv_n, acc_cell * inv_n) > cost) & p_valid

    # repair: each row topped up to its requirement, then a cheap cover for
    # an uncovered cell where that costs less than lambda_grid
    sel_obs = lp_keep[ptc] & obs_ok
    prio = torch.where(obs_ok, sel_obs.to(F32) * 1e6 - cost_obs - tiebreak,
                       neg_inf)
    keep_obs0 = (sel_obs | (_rank_desc(prio) < req_kf[:, None])) & obs_ok
    covered0 = _mark(G, torch.where(keep_obs0 & cell_ok, gcell, G))
    uncov = occupied & ~covered0
    cprio = torch.where(cell_ok & uncov[gcell], -cost_obs - tiebreak,
                        neg_inf)
    cbest = _max(G, gcell, cprio)
    cell_best = ((cprio == cbest[gcell]) & (cprio > neg_inf)
                 & (cost_obs < lam_grid))
    keep_obs = keep_obs0 | cell_best
    keep = _mark(P, torch.where(keep_obs, pt, P))[:P] & p_valid

    # prune: drop what costs more than it covers, as row slack allows
    def any_p(mask_obs):
        return _mark(P, torch.where(mask_obs, pt, P))[:P]

    for _ in range(n_rounds):
        kept_obs = keep[ptc] & obs_ok
        slack = torch.clamp(kept_obs.sum(1) - req_kf, min=0)
        cell_cover = _add(G, torch.where(kept_obs & cell_ok, gcell, G), 1,
                          I32)
        sole = kept_obs & cell_ok & (cell_cover[gcell] == 1)
        sole_cnt = _add(P, torch.where(sole, pt, P), 1.0, F32)[:P]
        gain = cost - lam_grid * sole_cnt
        cand_p = keep & ((gain > 0) | ((cost <= 0) & (sole_cnt == 0)))
        cand_p = cand_p & ~any_p(kept_obs & (slack == 0)[:, None])
        cand_obs = cand_p[ptc] & kept_obs
        gprio = torch.where(cand_obs, gain[ptc] - tiebreak, neg_inf)
        row_admit = cand_obs & (_rank_desc(gprio) < slack[:, None])
        drop_p = cand_p & ~any_p(cand_obs & ~row_admit)
        dobs = drop_p[ptc] & kept_obs & cell_ok & (cell_cover[gcell] >= 2)
        dprio = torch.where(dobs, gain[ptc] - tiebreak, neg_inf)
        dbest = _max(G, gcell, dprio)
        drop_p = drop_p & ~any_p(dobs & (dprio < dbest[gcell]))
        keep = keep & ~drop_p
    return keep


def objective(keep, obs_pt, obs_cell, obs_valid, cost, req_kf, lam,
              lam_grid, n_cells) -> float:
    """The selection's cost, in float64."""
    P = cost.shape[0]
    K = obs_pt.shape[0]
    obs_ok = obs_valid & (obs_pt >= 0)
    kept = keep[obs_pt.clamp(0, P - 1).long()] & obs_ok
    short = torch.clamp(req_kf.double() - kept.sum(1).double(), min=0)
    priced = obs_ok & (obs_cell >= 0) & (obs_cell < n_cells)
    G = K * n_cells
    rows = torch.arange(K, device=obs_pt.device)[:, None]
    gcell = torch.where(priced, rows * n_cells + obs_cell, G).long()
    occupied = _mark(G, gcell)[:G]
    covered = _mark(G, torch.where(kept & priced, gcell, G))[:G]
    return float(cost.double()[keep].sum() + lam * short.sum()
                 + lam_grid * (occupied & ~covered).sum())


def judge_window(w: Window, mp_valid_after: torch.Tensor) -> dict:
    """The reference's selection of one window against the program's: the
    program kept a window point where it is still valid after the solve."""
    obs_pt, obs_cell, obs_ok, cost, pt_idx, pt_valid, req = tables(w)
    n_cells = w.grid_w * w.grid_h
    ref = select(obs_pt, obs_cell, obs_ok, cost, pt_valid, req, w.lam,
                 w.lam_grid, n_cells)
    prog = mp_valid_after[pt_idx.long()] & pt_valid
    n = int(pt_valid.sum())
    args = (obs_pt, obs_cell, obs_ok, cost, req, w.lam, w.lam_grid, n_cells)
    return {"points": n, "differ": int((ref ^ prog)[pt_valid].sum()),
            "kept_ref": int(ref.sum()), "kept_prog": int(prog.sum()),
            "objective_ref": objective(ref, *args),
            "objective_prog": objective(prog, *args)}
