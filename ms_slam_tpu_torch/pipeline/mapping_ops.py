"""Structural map operations of the local-mapping stage.

Port of `ms_slam_tpu/pipeline/mapping_ops.py`: keyframe insertion with
stereo map-point spawning, batched triangulation against covisible
neighbours, duplicate fusion, the Schur window BA, point culling and
keyframe culling. The reference runs `keyframe_step` as one jit that
donates `ms`; here the same steps update the MapState tensors in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import map_state as M
from ..ops import ba, cameras, lie, matching, triangulate
from ..ops.indexing import add_at_, set_at_, top_k
from ..ops.orb import OrbConfig
from .frontend import Calib, FrameData

I32 = torch.int32


def _scale2(orb_cfg: OrbConfig, device):
    return torch.tensor([s * s for s in orb_cfg.level_scales()],
                        dtype=torch.float32, device=device)


def _P(R, t, n):
    return torch.cat([R, t[:, None]], 1).expand(n, 3, 4)


# ---------------------------------------------------------------------------
# Keyframe creation
# ---------------------------------------------------------------------------

def create_keyframe(ms: M.MapState, calib: Calib, slot: int,
                    frame: FrameData, R, t, matched_mp, kf_ord: int,
                    frame_id: int, depth_max: float):
    """Insert a keyframe; spawn map points for stereo features without a
    map-point match, up to depth_max. Returns (ms, n_new)."""
    f = frame.feats
    params = calib.params_array(R.device)
    close = (frame.depth > 0) & (frame.depth <= depth_max)
    new_mask = f.valid & close & (matched_mp < 0)
    M_cap = ms.mp_pos.shape[0]
    slots, ok = M.alloc_map_slots(ms, new_mask)
    obs = torch.where(matched_mp >= 0, matched_mp,
                      torch.where(slots < M_cap, slots, -1)).to(I32)

    ray = cameras.unproject(calib.model, params, f.xy)
    Xc = ray * frame.depth[:, None]
    Rwc = R.T
    Ow = -Rwc @ t
    Xw = Xc @ Rwc.T + Ow
    dist = torch.linalg.norm(Xw - Ow, dim=-1)
    normal = (Xw - Ow) / torch.clamp(dist, min=1e-9)[:, None]
    sf = 1.2
    n_lv = 8
    max_dist = dist * sf ** f.octave.to(torch.float32)
    min_dist = max_dist / (sf ** (n_lv - 1))

    ms = M.insert_keyframe(ms, slot, R, t, f.xy, f.octave, f.desc,
                           frame.u_right, frame.depth, f.valid, obs, frame_id,
                           kf_ord=kf_ord, angle=f.angle)
    n = new_mask.shape[0]
    ms = M.add_map_points(ms, slots, ok, Xw, f.desc, normal, min_dist,
                          max_dist, torch.full((n,), slot, dtype=I32,
                                               device=R.device),
                          torch.full((n,), kf_ord, dtype=I32,
                                     device=R.device), angle=f.angle)
    return ms, ok.sum().to(I32)


# ---------------------------------------------------------------------------
# Triangulation against covisible neighbours
# ---------------------------------------------------------------------------

def _tri_candidates(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                    kf_a: int, kf_b):
    """Side-effect-free half of triangulation against ONE neighbour:
    (good (N,), Xw (N,3), ib (N,))."""
    dev = ms.kf_R.device
    params = calib.params_array(dev)
    Ra, ta = ms.kf_R[kf_a], ms.kf_t[kf_a]
    Rb, tb = ms.kf_R[kf_b], ms.kf_t[kf_b]
    Rab = Rb @ Ra.T
    tab = tb - Rab @ ta
    b_ok = torch.linalg.norm(tab) > calib.bf / calib.params[0]

    free_a = ms.kp_valid[kf_a] & (ms.obs_mp[kf_a] < 0)
    free_b = ms.kp_valid[kf_b] & (ms.obs_mp[kf_b] < 0)
    s2 = _scale2(orb_cfg, dev)
    sig_b = s2[ms.kp_octave[kf_b].long()]
    xy_a, xy_b = ms.kp_xy[kf_a], ms.kp_xy[kf_b]
    epi = matching.epipolar_mask(calib.model, params, Rab, tab, xy_a, xy_b,
                                 sig_b)
    mm = matching.mutual_match(ms.kp_desc[kf_a], free_a, ms.kp_desc[kf_b],
                               free_b, max_dist=matching.TH_LOW, nn_ratio=0.6,
                               extra_mask=epi, angle_a=ms.kp_angle[kf_a],
                               angle_b=ms.kp_angle[kf_b])
    has = (mm.idx_b >= 0) & b_ok
    ib = mm.idx_b.clamp(min=0).long()

    xn_a = cameras.unproject(calib.model, params, xy_a)
    xn_b = cameras.unproject(calib.model, params, xy_b)[ib]
    N = xn_a.shape[0]
    Xw = triangulate.triangulate_dlt(xn_a, xn_b, _P(Ra, ta, N), _P(Rb, tb, N))

    Xca = lie.se3_apply(Ra, ta, Xw)
    Xcb = lie.se3_apply(Rb, tb, Xw)
    va = Xw - (-Ra.T @ ta)
    vb = Xw - (-Rb.T @ tb)
    cos_par = (torch.sum(va * vb, -1)
               / torch.clamp(torch.linalg.norm(va, dim=-1)
                             * torch.linalg.norm(vb, dim=-1), min=1e-9))
    uva = cameras.project(calib.model, params, Xca)
    uvb = cameras.project(calib.model, params, Xcb)
    ea = torch.sum((uva - xy_a) ** 2, -1) / s2[ms.kp_octave[kf_a].long()]
    eb = torch.sum((uvb - xy_b[ib]) ** 2, -1) / sig_b[ib]
    good = (has & (Xca[:, 2] > 0) & (Xcb[:, 2] > 0)
            & (cos_par < 0.9998) & (cos_par > 0)
            & (ea < 5.991) & (eb < 5.991))
    return good, Xw, ib


def _triangulate_batch(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                       kf_a: int, nb_idx, nb_ok, kf_ord: int):
    """Triangulate kf_a against all neighbours; each kf_a feature takes its
    first neighbour with a passing candidate. Returns (ms, n_new)."""
    cands = [_tri_candidates(ms, calib, orb_cfg, kf_a, b) for b in nb_idx]
    goods = torch.stack([c[0] for c in cands]) & nb_ok[:, None]   # (T,N)
    Xws = torch.stack([c[1] for c in cands])
    ibs = torch.stack([c[2] for c in cands])
    T, N = goods.shape
    dev = goods.device
    pick = torch.argmax(goods.to(torch.uint8), dim=0)   # first passing
    sel = goods.any(0)
    rows = torch.arange(N, device=dev)
    Xw = Xws[pick, rows]
    ib = ibs[pick, rows]
    nbr = nb_idx[pick]

    M_cap = ms.mp_pos.shape[0]
    slots, ok = M.alloc_map_slots(ms, sel)
    Ra, ta = ms.kf_R[kf_a], ms.kf_t[kf_a]
    va = Xw - (-Ra.T @ ta)
    dist = torch.linalg.norm(va, dim=-1)
    normal = va / torch.clamp(dist, min=1e-9)[:, None]
    max_dist = dist * 1.2 ** ms.kp_octave[kf_a].to(torch.float32)
    min_dist = max_dist / (1.2 ** 7)
    ms = M.add_map_points(ms, slots, ok, Xw, ms.kp_desc[kf_a], normal,
                          min_dist, max_dist,
                          torch.full((N,), kf_a, dtype=I32, device=dev),
                          torch.full((N,), kf_ord, dtype=I32, device=dev),
                          angle=ms.kp_angle[kf_a])
    slot_or_neg = torch.where(ok, slots, -1).to(I32)
    ms.obs_mp[kf_a] = torch.where(slot_or_neg >= 0, slot_or_neg,
                                  ms.obs_mp[kf_a])
    # the matched feature slot in each chosen neighbour (2-D scatter)
    Kc, Nc = ms.obs_mp.shape
    r_sel = torch.where(slot_or_neg >= 0, nbr, Kc)
    c_sel = torch.where(slot_or_neg >= 0, ib, Nc)
    set_at_(ms.obs_mp, (r_sel, c_sel), slot_or_neg)
    return ms, (sel & (slots < M_cap)).sum().to(I32)


def triangulate_with(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                     kf_a: int, kf_b: int, kf_ord: int):
    """New map points by epipolar-matched triangulation between two
    keyframes (ref LocalMapping::CreateNewMapPoints for one neighbour):
    `_triangulate_batch` against the one neighbour kf_b. Returns (ms,
    n_new)."""
    dev = ms.kf_R.device
    return _triangulate_batch(
        ms, calib, orb_cfg, kf_a, torch.tensor([kf_b], device=dev),
        torch.ones(1, dtype=torch.bool, device=dev), kf_ord)


# ---------------------------------------------------------------------------
# Fusion of duplicate points into a target keyframe
# ---------------------------------------------------------------------------

def _fuse_impl(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig, kf_t: int,
               cand_idx, cand_valid, n_obs=None) -> M.MapState:
    """Project candidate points into keyframe kf_t; matched features gain
    the observation, or trigger a duplicate merge keeping the
    better-observed point (ref ORBmatcher::Fuse + MapPoint::Replace)."""
    dev = ms.kf_R.device
    params = calib.params_array(dev)
    ci = cand_idx.long()
    pm = matching.search_by_projection(
        calib.model, params, ms.kf_R[kf_t], ms.kf_t[kf_t],
        calib.width, calib.height,
        ms.mp_pos[ci], ms.mp_normal[ci], ms.mp_min_dist[ci],
        ms.mp_max_dist[ci], ms.mp_desc[ci], cand_valid & ms.mp_valid[ci],
        ms.kp_xy[kf_t], ms.kp_octave[kf_t], ms.kp_desc[kf_t],
        ms.kp_valid[kf_t], th_radius=3.0, nn_ratio=1.0,
        scale_factor=orb_cfg.scale_factor, n_levels=orb_cfg.n_levels)
    cand_of_feat = torch.where(pm.mp_slot >= 0,
                               cand_idx[pm.mp_slot.clamp(min=0).long()], -1)
    cur = ms.obs_mp[kf_t].clone()
    if n_obs is None:
        n_obs = M.mp_obs_count(ms)
    add = (cand_of_feat >= 0) & (cur < 0)
    new_row = torch.where(add, cand_of_feat, cur)
    conflict = (cand_of_feat >= 0) & (cur >= 0) & (cand_of_feat != cur)
    cand_obs = n_obs[cand_of_feat.clamp(min=0).long()]
    cur_obs = n_obs[cur.clamp(min=0).long()]
    winner = torch.where(cand_obs >= cur_obs, cand_of_feat, cur)
    loser = torch.where(cand_obs >= cur_obs, cur, cand_of_feat)
    Mc = ms.mp_pos.shape[0]
    remap = set_at_(torch.arange(Mc, dtype=I32, device=dev),
                    torch.where(conflict, loser, Mc),
                    torch.where(conflict, winner, 0))
    loser_sl = torch.where(conflict, loser, Mc)
    set_at_(ms.mp_valid, loser_sl, False)
    set_at_(ms.mp_quarantine, loser_sl, 2)
    ms.obs_mp[kf_t] = new_row
    obs_all = ms.obs_mp
    obs_all.copy_(torch.where(obs_all >= 0,
                              remap[obs_all.clamp(min=0).long()], obs_all))
    return ms


# ---------------------------------------------------------------------------
# Local bundle adjustment over a covisibility window
# ---------------------------------------------------------------------------

class LocalBAOut(NamedTuple):
    ms: M.MapState
    n_factors: torch.Tensor
    n_outliers: torch.Tensor


def _local_ba_impl(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                   win_idx, win_mask, fix_idx, fix_mask, n_fixed: int,
                   pt_cap: int, n_iters: int = 8) -> LocalBAOut:
    """Window BA: optimize the window keyframes and their points, anchored
    by the fixed keyframes (ref Optimizer::LocalBundleAdjustment)."""
    dev = ms.kf_R.device
    params = calib.params_array(dev)
    Wk = win_idx.shape[0]
    cams = torch.cat([win_idx, fix_idx]).long()
    cam_mask = torch.cat([win_mask, fix_mask])
    cam_opt = torch.cat([win_mask, torch.zeros(n_fixed, dtype=torch.bool,
                                               device=dev)])
    pmask = M.local_map_mask(ms, win_idx.long(), win_mask)
    pt_idx, pt_valid = M.gather_local_points(ms, pmask, pt_cap)
    Mc = ms.mp_pos.shape[0]
    inv = set_at_(torch.full((Mc + 1,), -1, dtype=I32, device=dev),
                  torch.where(pt_valid, pt_idx, Mc),
                  torch.arange(pt_cap, dtype=I32, device=dev))

    obs = ms.obs_mp[cams]                                  # (C,N)
    f_pt_dense = inv[obs.clamp(0, Mc).long()]
    f_valid = (obs >= 0) & (f_pt_dense >= 0) & cam_mask[:, None] \
        & ms.kp_valid[cams]
    C, N = obs.shape
    f_cam = torch.arange(C, device=dev)[:, None].expand(C, N)
    f_sigma2 = _scale2(orb_cfg, dev)[ms.kp_octave[cams].long()]

    res = ba.ba_solve(
        calib.model, params, calib.bf, ms.kf_R[cams], ms.kf_t[cams], cam_opt,
        ms.mp_pos[pt_idx.long()], pt_valid,
        f_cam.reshape(-1), f_pt_dense.clamp(min=0).reshape(-1),
        ms.kp_xy[cams].reshape(C * N, 2), ms.kp_uright[cams].reshape(-1),
        f_sigma2.reshape(-1), f_valid.reshape(-1), n_iters=n_iters,
        cam_blocked=True)

    K = ms.kf_R.shape[0]
    wb = torch.where(win_mask, win_idx, K)
    set_at_(ms.kf_R, wb, res.kf_R[:Wk])
    set_at_(ms.kf_t, wb, res.kf_t[:Wk])
    set_at_(ms.mp_pos, torch.where(pt_valid, pt_idx, Mc), res.mp_pos)
    # erase outlier observations (ref post-BA erase)
    outlier = f_valid & ~res.f_inlier.reshape(C, N)
    obs_new = torch.where(outlier, -1, obs)
    set_at_(ms.obs_mp, torch.where(cam_mask, cams, K), obs_new)
    return LocalBAOut(ms=ms, n_factors=f_valid.sum().to(I32),
                      n_outliers=outlier.sum().to(I32))


def fuse_into(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig, kf_t,
              cand_idx, cand_valid) -> M.MapState:
    """Fuse candidate points into keyframe kf_t (loop closing's entry point
    to `_fuse_impl`; `ms` is updated in place)."""
    return _fuse_impl(ms, calib, orb_cfg, int(kf_t), cand_idx, cand_valid)


def local_ba(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig, win_idx,
             win_mask, fix_idx, fix_mask, n_fixed: int, pt_cap: int,
             n_iters: int = 8) -> LocalBAOut:
    """Window BA over the given keyframes (the weld BA's entry point to
    `_local_ba_impl`; `ms` is updated in place)."""
    return _local_ba_impl(ms, calib, orb_cfg, win_idx, win_mask, fix_idx,
                          fix_mask, n_fixed, pt_cap, n_iters)


def global_ba(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig, fixed_kf,
              n_sweeps: int = 3) -> M.MapState:
    """Whole-map refinement after a loop closure or a merge (ref
    RunGlobalBundleAdjustment): alternating resection-intersection over the
    full factor table (every observation of every valid keyframe), the
    anchor keyframe fixed. Returns a MapState with new pose and point
    tensors; the argument's are left as they were."""
    dev = ms.kf_R.device
    params = calib.params_array(dev)
    K, N = ms.obs_mp.shape
    obs = ms.obs_mp
    f_valid = (obs >= 0) & ms.kf_valid[:, None] & ms.kp_valid
    f_cam = torch.arange(K, device=dev)[:, None].expand(K, N)
    cam_opt = ms.kf_valid & (torch.arange(K, device=dev) != fixed_kf)
    R_n, t_n, P_n = ba.ba_alternate(
        calib.model, params, calib.bf, ms.kf_R, ms.kf_t, cam_opt,
        ms.mp_pos, ms.mp_valid, f_cam.reshape(-1),
        obs.clamp(min=0).reshape(-1), ms.kp_xy.reshape(K * N, 2),
        ms.kp_uright.reshape(-1),
        _scale2(orb_cfg, dev)[ms.kp_octave.long()].reshape(-1),
        f_valid.reshape(-1), n_sweeps=n_sweeps)
    return ms._replace(kf_R=R_n, kf_t=t_n, mp_pos=P_n)


# ---------------------------------------------------------------------------
# Fused per-keyframe mapping step (triangulate + fuse + window BA + cull)
# ---------------------------------------------------------------------------

class MappingStepOut(NamedTuple):
    ms: M.MapState
    info: torch.Tensor
    """(4 + 2*Wk,) int32: [n_new_mp, n_factors, n_ba_outliers, n_culled,
    window slots (-1 padded), culled KF slots (-1 padded)]."""
    n_obs: torch.Tensor = None
    obs_mask: torch.Tensor = None


def mapping_step(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                 kf_slot: int, kf_ord: int, n_tri: int, window_kf: int,
                 n_fixed: int, pt_cap: int, ba_iters: int, do_ba: bool = True,
                 cullable=None, red_th: float = 0.9) -> MappingStepOut:
    """One LocalMapping iteration (ref LocalMapping::Run body):
    triangulation, fusion, window BA, point and keyframe culling."""
    dev = ms.kf_R.device
    K = ms.kf_valid.shape[0]
    ms.mp_quarantine.copy_(torch.clamp(ms.mp_quarantine - 1, min=0))
    counts = M.covisibility_counts(ms, kf_slot)
    top_w, top_i = top_k(counts, window_kf - 1 + n_fixed)

    nb_ok = top_w[:n_tri] >= 10
    ms, n_tri_new = _triangulate_batch(ms, calib, orb_cfg, kf_slot,
                                       top_i[:n_tri], nb_ok, kf_ord)

    n_obs_tri = M.mp_obs_count(ms)
    nmask = set_at_(torch.zeros(K, dtype=torch.bool, device=dev),
                    torch.where(top_w[:n_tri] > 0, top_i[:n_tri], K), True)
    cand_mask = M.local_map_mask(ms, torch.arange(K, device=dev), nmask)
    c_idx, c_valid = M.gather_local_points(ms, cand_mask, pt_cap)
    ms = _fuse_impl(ms, calib, orb_cfg, kf_slot, c_idx, c_valid,
                    n_obs=n_obs_tri)

    # BA window + fixed anchors
    win_idx = torch.cat([torch.tensor([kf_slot], device=dev),
                         top_i[:window_kf - 1]])
    win_mask = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          top_w[:window_kf - 1] > 0])
    fix_idx = top_i[window_kf - 1:window_kf - 1 + n_fixed].clone()
    fix_mask = top_w[window_kf - 1:window_kf - 1 + n_fixed] > 0
    # no anchors: demote the oldest (min slot id) window keyframe
    no_anchor = ~fix_mask.any()
    oldest_pos = torch.argmin(torch.where(win_mask, win_idx, 1 << 30))
    demote = no_anchor & (win_mask.sum() > 1)
    win_mask[oldest_pos] = win_mask[oldest_pos] & ~demote
    fix_idx[0] = torch.where(demote, win_idx[oldest_pos], fix_idx[0])
    fix_mask[0] = fix_mask[0] | demote

    if do_ba:
        outba = _local_ba_impl(ms, calib, orb_cfg, win_idx, win_mask,
                               fix_idx, fix_mask, n_fixed, pt_cap, ba_iters)
        ms = outba.ms
        ba_factors, ba_outliers = outba.n_factors, outba.n_outliers
    else:
        ba_factors = torch.zeros((), dtype=I32, device=dev)
        ba_outliers = torch.zeros((), dtype=I32, device=dev)

    n_levels = orb_cfg.n_levels
    cum_oct = obs_count_by_octave(ms, n_levels)
    ms, n_culled, n_obs_all = _cull_impl(ms, kf_ord, cum_oct[:, n_levels - 1])

    # keyframe culling (ref LocalMapping::KeyFrameCulling): window
    # keyframes whose close tracked points are mostly observed by >=3 other
    # keyframes at the same or finer scale
    wi = win_idx.long()
    obs = ms.obs_mp[wi]                                   # (Wk,N)
    has = (obs >= 0) & ms.kp_valid[wi]
    if (calib.bf or 0.0) > 0.0:
        has &= (ms.kp_depth[wi] > 0) & (ms.kp_depth[wi] <= calib.th_depth)
    o = ms.kp_octave[wi].clamp(0, n_levels - 1).long()
    n_other = cum_oct[obs.clamp(min=0).long(),
                      torch.clamp(o + 1, max=n_levels - 1)] - 1
    red = has & (n_other >= 3)
    tot = has.sum(1)
    red_ratio = torch.where(tot > 0, red.sum(1) / torch.clamp(tot, min=1),
                            torch.zeros((), device=dev))
    cull_ok = (torch.ones_like(win_mask) if cullable is None
               else cullable[wi])
    kf_kill = (win_mask & (win_idx != kf_slot) & (win_idx != 0)
               & (red_ratio > red_th) & (tot > 50) & cull_ok)
    kill_mask = set_at_(torch.zeros(K, dtype=torch.bool, device=dev),
                        torch.where(kf_kill, win_idx, K), True)
    # keep the shared count table current through keyframe deletion
    Mc = ms.mp_pos.shape[0]
    dec_ok = (obs >= 0) & kf_kill[:, None]
    add_at_(n_obs_all, torch.where(dec_ok, obs, Mc), -1)
    ms = M.delete_keyframes(ms, kill_mask)
    win_mask = win_mask & ~kf_kill

    info = torch.cat([
        torch.stack([n_tri_new, ba_factors, ba_outliers,
                     n_culled]).to(I32),
        torch.where(win_mask, win_idx, -1).to(I32),
        torch.where(kf_kill, win_idx, -1).to(I32)])
    return MappingStepOut(ms=ms, info=info, n_obs=n_obs_all,
                          obs_mask=M.observer_mask(ms))


class KeyframeStepOut(NamedTuple):
    ms: M.MapState
    info: torch.Tensor
    """(18 + 2*Wk,) float32: [n_new_stereo, n_new_tri, n_factors,
    n_ba_outliers, n_culled, n_obs_kf, R_kf row-major (9), t_kf (3),
    window slots (-1 padded), culled KF slots (-1 padded)]."""
    n_obs: torch.Tensor = None
    obs_mask: torch.Tensor = None


def keyframe_step(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                  slot: int, frame: FrameData, R, t, matched_mp, kf_ord: int,
                  frame_id: int, depth_max: float, n_tri: int,
                  window_kf: int, n_fixed: int, pt_cap: int, ba_iters: int,
                  do_ba: bool = True, cullable=None,
                  red_th: float = 0.9) -> KeyframeStepOut:
    """Keyframe insertion + one local-mapping iteration, returning every
    scalar the host schedule needs in one packed array."""
    ms, n_stereo = create_keyframe(ms, calib, slot, frame, R, t, matched_mp,
                                   kf_ord, frame_id, depth_max)
    out = mapping_step(ms, calib, orb_cfg, slot, kf_ord, n_tri=n_tri,
                       window_kf=window_kf, n_fixed=n_fixed, pt_cap=pt_cap,
                       ba_iters=ba_iters, do_ba=do_ba, cullable=cullable,
                       red_th=red_th)
    ms = out.ms
    # reference matches for the keyframe decision: points with >= 3
    # observations (ref KeyFrame::TrackedMapPoints(minObs=3))
    row = ms.obs_mp[slot]
    n_obs = ((row >= 0) & (out.n_obs[row.clamp(min=0).long()] >= 3)).sum()
    info = torch.cat([
        torch.stack([n_stereo, out.info[0], out.info[1], out.info[2],
                     out.info[3], n_obs.to(I32)]).to(torch.float32),
        ms.kf_R[slot].reshape(9).float(), ms.kf_t[slot].float(),
        out.info[4:].float()])
    return KeyframeStepOut(ms=ms, info=info, n_obs=out.n_obs,
                           obs_mask=out.obs_mask)


# ---------------------------------------------------------------------------
# Culling
# ---------------------------------------------------------------------------

def _cull_impl(ms: M.MapState, current_kf_ord: int, n_obs=None):
    """MapPointCulling on young points (found/visible ratio, min
    observations); mature points die only with their last observation.
    Returns (ms, n_culled, n_obs with culled points zeroed)."""
    age = current_kf_ord - ms.mp_first_ord
    if n_obs is None:
        n_obs = M.mp_obs_count(ms)
    ratio = ms.mp_found.to(torch.float32) / torch.clamp(
        ms.mp_visible.to(torch.float32), min=1.0)
    young = age <= 3
    kill = ms.mp_valid & ((young & (ratio < 0.25))
                          | (young & (age >= 2) & (n_obs <= 2))
                          | (n_obs == 0))
    ms = M.delete_map_points(ms, kill)
    return ms, kill.sum().to(I32), torch.where(kill, 0, n_obs)


def cull_map_points(ms: M.MapState, current_kf_ord: int):
    """MapPointCulling over the whole pool (`_cull_impl` with the counts
    recomputed): (ms, n_culled)."""
    ms, n_culled, _ = _cull_impl(ms, current_kf_ord)
    return ms, n_culled


def obs_count_by_octave(ms: M.MapState, n_levels: int = 8):
    """(Mc, L) cumulative observation counts: entry [p, o] = observations
    of point p at octave <= o."""
    Mc = ms.mp_pos.shape[0]
    obs = ms.obs_mp
    ok = (obs >= 0) & ms.kp_valid & ms.kf_valid[:, None]
    oct_ = ms.kp_octave.clamp(0, n_levels - 1)
    counts = add_at_(torch.zeros((Mc + 1, n_levels), dtype=I32,
                                 device=obs.device),
                     (torch.where(ok, obs, Mc), oct_), 1)
    return torch.cumsum(counts[:Mc], dim=1, dtype=I32)


def keyframe_redundancy(ms: M.MapState, kf: int, n_levels: int = 8):
    """Fraction of a keyframe's tracked points seen by >=3 other keyframes
    at the same or finer scale, and the number of tracked points."""
    cum = obs_count_by_octave(ms, n_levels)
    obs = ms.obs_mp[kf]
    has = (obs >= 0) & ms.kp_valid[kf]
    o = ms.kp_octave[kf].clamp(0, n_levels - 1).long()
    n_other = cum[obs.clamp(min=0).long(),
                  torch.clamp(o + 1, max=n_levels - 1)] - 1
    redundant = has & (n_other >= 3)
    total = has.sum()
    return torch.where(total > 0, redundant.sum() / torch.clamp(total, min=1),
                       torch.zeros((), device=obs.device)), total
