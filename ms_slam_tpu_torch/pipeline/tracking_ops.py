"""Per-frame tracking compute.

Port of `ms_slam_tpu/pipeline/tracking_ops.py` (visual path): motion-model
association with motion-only LM, the widened retry and the appearance
fallback, the local-keyframe vote, local-map tracking, point statistics
and the keyframe-decision counters.

The reference switches the retry and the fallback with `lax.cond`; here
they are host branches on `n_inliers`, one device sync each (marked
`# sync:` below — the places a CUDA-graph capture would have to remove).
`track_full` updates the point statistics of `ms` in place (the reference
donates `ms`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import map_state as M
from ..ops import matching, pose_opt
from ..ops.indexing import add_at_, set_at_, top_k
from ..ops.orb import OrbConfig
from .frontend import Calib, FrameData


class TrackOut(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    matched_mp: torch.Tensor   # (N,) per-feature map point idx (-1 none)
    n_matched: torch.Tensor
    n_inliers: torch.Tensor


def track_points(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                 frame: FrameData, R0, t0, pt_idx, pt_valid,
                 th_radius: float, nn_ratio: float,
                 rotation_gate: bool = True, opt_rounds: int = 4,
                 opt_iters: int = 10) -> TrackOut:
    """Project candidate map points into the frame, associate, optimize the
    pose (ref SearchByProjection + PoseOptimization)."""
    params = calib.params_array(R0.device)
    f = frame.feats
    pi = pt_idx.long()
    pm = matching.search_by_projection(
        calib.model, params, R0, t0, calib.width, calib.height,
        ms.mp_pos[pi], ms.mp_normal[pi], ms.mp_min_dist[pi],
        ms.mp_max_dist[pi], ms.mp_desc[pi], pt_valid & ms.mp_valid[pi],
        f.xy, f.octave, f.desc, f.valid,
        th_radius=th_radius, nn_ratio=nn_ratio,
        scale_factor=orb_cfg.scale_factor, n_levels=orb_cfg.n_levels,
        pt_angle=ms.mp_angle[pi] if rotation_gate else None,
        f_angle=f.angle if rotation_gate else None)
    mp_of_feat = torch.where(pm.mp_slot >= 0,
                             pt_idx[pm.mp_slot.clamp(min=0).long()],
                             -1).to(torch.int32)
    has = mp_of_feat >= 0
    X = ms.mp_pos[mp_of_feat.clamp(min=0).long()]
    res = pose_opt.pose_optimize(
        calib.model, params, calib.bf, R0, t0, X, f.xy, frame.u_right,
        frame.sigma2, has, n_rounds=opt_rounds, n_iters=opt_iters)
    matched = torch.where(res.inlier, mp_of_feat, -1)
    return TrackOut(R=res.R, t=res.t, matched_mp=matched,
                    n_matched=pm.n_matches, n_inliers=res.n_inliers)


def track_by_appearance(ms: M.MapState, calib: Calib, frame: FrameData,
                        kf: int, R0, t0) -> TrackOut:
    """Appearance-only association against one keyframe's landmarks + pose
    optimization (ref Tracking::TrackReferenceKeyFrame)."""
    params = calib.params_array(R0.device)
    f = frame.feats
    kf_obs = ms.obs_mp[kf]
    kf_has = ms.kp_valid[kf] & (kf_obs >= 0)
    mm = matching.mutual_match(f.desc, f.valid, ms.kp_desc[kf], kf_has,
                               max_dist=matching.TH_LOW, nn_ratio=0.7,
                               angle_a=f.angle, angle_b=ms.kp_angle[kf])
    has = mm.idx_b >= 0
    mp = torch.where(has, kf_obs[mm.idx_b.clamp(min=0).long()], -1)
    has &= mp >= 0
    X = ms.mp_pos[mp.clamp(min=0).long()]
    res = pose_opt.pose_optimize(
        calib.model, params, calib.bf, R0, t0, X, f.xy, frame.u_right,
        frame.sigma2, has)
    matched = torch.where(res.inlier, mp, -1).to(torch.int32)
    return TrackOut(R=res.R, t=res.t, matched_mp=matched,
                    n_matched=mm.n_matches, n_inliers=res.n_inliers)


class TrackFullOut(NamedTuple):
    ms: M.MapState
    R: torch.Tensor
    t: torch.Tensor
    matched_mp: torch.Tensor
    stats: torch.Tensor
    """(33,) float32: [R row-major (9), t (3), motion_inliers, used_wide,
    used_fallback, local_inliers, n_close_tracked, n_close_untracked,
    best_local_kf, n_local_candidates, n_ref_matches, ref-KF R (9),
    ref-KF t (3)] — the reference's packed layout, one fetch per frame."""


def _predict_const_velocity(R_last, t_last, R_last2, t_last2, has_vel):
    """Constant-velocity prediction T0 = (T_last T_last2^-1) T_last."""
    R_vel = R_last @ R_last2.T
    t_vel = t_last - R_vel @ t_last2
    has_vel = torch.as_tensor(has_vel, device=R_last.device)
    return (torch.where(has_vel, R_vel @ R_last, R_last),
            torch.where(has_vel, R_vel @ t_last + t_vel, t_last))


def _track_core(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                frame: FrameData, R0, t0, R_last, t_last, last_matched,
                ref_kf: int, local_cap: int, n_obs_all=None, obs_mask=None):
    """Motion-model matching (+ widened retry + appearance fallback), then
    local-map tracking. Returns (ms, out4, stats_i, best_kf)."""
    pt_idx = last_matched.clamp(min=0)
    pt_valid = last_matched >= 0
    # coarse 2x5 LM budget in the motion-model stage (the local-map stage
    # re-polishes with the reference's full 4x10)
    out1 = track_points(ms, calib, orb_cfg, frame, R0, t0, pt_idx, pt_valid,
                        7.0, 0.9, opt_rounds=2, opt_iters=5)
    need_wide = bool(out1.n_inliers < 20)                      # sync: lax.cond
    out2 = track_points(ms, calib, orb_cfg, frame, R0, t0, pt_idx, pt_valid,
                        14.0, 0.9, opt_rounds=2,
                        opt_iters=5) if need_wide else out1
    need_fb = bool(out2.n_inliers < 10)                        # sync: lax.cond
    out3 = track_by_appearance(ms, calib, frame, ref_kf, R_last,
                               t_last) if need_fb else out2

    lk_idx, lk_mask = local_keyframes(ms, out3.matched_mp, k=10,
                                      obs_mask=obs_mask)
    lmask = M.local_map_mask(ms, lk_idx, lk_mask)
    l_idx, l_valid = M.gather_local_points(ms, lmask, local_cap)
    out4 = track_points(ms, calib, orb_cfg, frame, out3.R, out3.t,
                        l_idx, l_valid, 1.0, 0.8, rotation_gate=False,
                        opt_rounds=4, opt_iters=10)
    ms = update_point_stats(ms, l_idx, l_valid, out4.matched_mp,
                            f_angle=frame.feats.angle)
    n_ct, n_cu = count_trackable_close(calib, frame, out4.matched_mp)
    best_kf = lk_idx[0]
    if n_obs_all is None:
        n_obs_all = M.mp_obs_count(ms)
    ref_row = ms.obs_mp[best_kf]
    n_ref = ((ref_row >= 0) & (n_obs_all[ref_row.clamp(min=0).long()] >= 3)
             & ms.kp_valid[best_kf]).sum()
    dev = best_kf.device
    stats_i = torch.stack([torch.as_tensor(v, device=dev).to(torch.int32) for v in (
        out3.n_inliers, int(need_wide), int(need_fb), out4.n_inliers, n_ct,
        n_cu, lk_idx[0], l_valid.sum(), n_ref)])
    return ms, out4, stats_i, best_kf


def _pack_stats(ms, R, t, stats_i, best_kf):
    return torch.cat([R.reshape(9).float(), t.float(), stats_i.float(),
                      ms.kf_R[best_kf].reshape(9).float(),
                      ms.kf_t[best_kf].float()])


def track_full(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
               frame: FrameData, R_last, t_last, R_last2, t_last2, has_vel,
               last_matched, ref_kf: int, local_cap: int, n_obs_all=None,
               obs_mask=None) -> TrackFullOut:
    """The per-frame tracking compute: constant-velocity prediction, the
    association cascade, local-map tracking, point statistics (updated in
    `ms` in place) and the keyframe-decision counters."""
    R0, t0 = _predict_const_velocity(R_last, t_last, R_last2, t_last2,
                                     has_vel)
    ms, out4, stats_i, best_kf = _track_core(
        ms, calib, orb_cfg, frame, R0, t0, R_last, t_last, last_matched,
        ref_kf, local_cap, n_obs_all, obs_mask)
    return TrackFullOut(ms=ms, R=out4.R, t=out4.t,
                        matched_mp=out4.matched_mp,
                        stats=_pack_stats(ms, out4.R, out4.t, stats_i,
                                          best_kf))


def local_keyframes(ms: M.MapState, matched_mp, k: int, obs_mask=None):
    """Local keyframe set by vote: keyframes sharing the most observations
    with the frame's matches (ref Tracking::UpdateLocalKeyFrames).
    obs_mask: cached (M, ceil(K/32)) observer bitmask (the path System
    uses); without it, a member-table sweep of the observation table.
    Returns (idx (k,), mask (k,))."""
    Mc = ms.mp_pos.shape[0]
    K = ms.kf_valid.shape[0]
    if obs_mask is not None:
        rows = torch.where((matched_mp >= 0)[:, None],
                           obs_mask[matched_mp.clamp(min=0).long()], 0)
        shifts = torch.arange(32, dtype=torch.int32, device=rows.device)
        bits = (rows[..., None] >> shifts) & 1
        votes = bits.reshape(rows.shape[0], -1).sum(0)[:K]
        votes = torch.where(ms.kf_valid, votes, 0)
    else:
        tbl = M.member_table(matched_mp, Mc)
        obs = ms.obs_mp
        hit = tbl[obs.clamp(0, Mc).long()] & (obs >= 0) & ms.kf_valid[:, None]
        votes = hit.sum(1)
    w, idx = top_k(votes, k)
    return idx, w > 0


def update_point_stats(ms: M.MapState, pt_idx, visible, matched_mp,
                       f_angle=None) -> M.MapState:
    """IncreaseVisible for frustum-passing candidates, IncreaseFound for
    tracked inliers; matched points take the newest observation's angle.
    In place."""
    ms = M.update_mp_stats(ms, pt_idx, visible, torch.zeros_like(visible))
    found_idx = torch.where(matched_mp >= 0, matched_mp, ms.mp_pos.shape[0])
    add_at_(ms.mp_found, found_idx, 1)
    if f_angle is not None:
        set_at_(ms.mp_angle, found_idx, f_angle)
    return ms


def count_trackable_close(calib: Calib, frame: FrameData, matched_mp):
    """Tracked close points and untracked-but-triangulable close points
    (ref Tracking::NeedNewKeyFrame)."""
    close = (frame.depth > 0) & (frame.depth <= calib.th_depth) \
        & frame.feats.valid
    return ((close & (matched_mp >= 0)).sum().to(torch.int32),
            (close & (matched_mp < 0)).sum().to(torch.int32))
