"""Per-frame tracking compute.

Port of `ms_slam_tpu/pipeline/tracking_ops.py`: motion-model association
with motion-only LM, the widened retry and the appearance fallback, the
local-keyframe vote, local-map tracking, point statistics, the
keyframe-decision counters, the prior-free PnP step that relocalization
runs per candidate keyframe, and the inertial step `track_full_imu` (IMU
preintegration and prediction in front of the same cascade, the joint
pose-velocity-bias refinement behind it).

The reference switches the retry and the fallback with `lax.cond`; here
they are host branches on `n_inliers`, one device sync each (marked
`# sync:` below — the places a CUDA-graph capture would have to remove).
`track_full` updates the point statistics of `ms` in place (the reference
donates `ms`).

Given a `Timing` (`timing=`), the step records its stages as spans
(`utils/trace.py`): `track.motion` (with `sync.track_wide` and
`sync.track_fallback`), `track.local_select`, `track.local`, `track.stats`,
and in the inertial step `imu.predict` and `pvb_opt`; inside them `search`
around each `search_by_projection`, `pose_opt` around each
`pose_optimize` and, on the card, `pose_opt.kernel` and `pvb_opt.kernel`
around the launches of `pose_optimize`'s and `pose_vel_bias_optimize`'s
kernels.

For an unrectified stereo pair (`calib.rig`) every solver also takes each
match's right keypoint (`FrameData.right`) as a right-camera row, and the
stats pack ends with the right rows the frame's solves kept as inliers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import map_state as M
from ..ops import imu as imu_ops
from ..ops import inertial_opt, lie, matching, pnp, pose_opt
from ..ops.indexing import add_at_, set_at_, top_k
from ..ops.orb import OrbConfig
from ..utils.trace import span, sync
from .frontend import Calib, FrameData


class TrackOut(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    matched_mp: torch.Tensor   # (N,) per-feature map point idx (-1 none)
    n_matched: torch.Tensor
    n_inliers: torch.Tensor
    n_right: torch.Tensor = None   # right rows kept (unrectified pair)


def _rig_kwargs(calib: Calib, frame: FrameData, device) -> dict:
    """pose_optimize's right-camera arguments for this frame: none unless
    the calibration is an unrectified pair and the frame has right
    keypoints."""
    if frame.right is None or not calib.is_fisheye_stereo:
        return {}
    return {"rig": calib.rig(device), "right": frame.right}


def track_points(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                 frame: FrameData, R0, t0, pt_idx, pt_valid,
                 th_radius: float, nn_ratio: float,
                 rotation_gate: bool = True, opt_rounds: int = 4,
                 opt_iters: int = 10, *, timing=None) -> TrackOut:
    """Project candidate map points into the frame, associate, optimize the
    pose (ref SearchByProjection + PoseOptimization)."""
    params = calib.params_array(R0.device)
    f = frame.feats
    pi = pt_idx.long()
    with span(timing, "search"):
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
    with span(timing, "pose_opt"):
        res = pose_opt.pose_optimize(
            calib.model, params, calib.bf, R0, t0, X, f.xy, frame.u_right,
            frame.sigma2, has, n_rounds=opt_rounds, n_iters=opt_iters,
            timing=timing, **_rig_kwargs(calib, frame, R0.device))
    matched = torch.where(res.inlier, mp_of_feat, -1)
    return TrackOut(R=res.R, t=res.t, matched_mp=matched,
                    n_matched=pm.n_matches, n_inliers=res.n_inliers,
                    n_right=res.n_right)


def track_by_appearance(ms: M.MapState, calib: Calib, frame: FrameData,
                        kf: int, R0, t0, *, timing=None) -> TrackOut:
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
    with span(timing, "pose_opt"):
        res = pose_opt.pose_optimize(
            calib.model, params, calib.bf, R0, t0, X, f.xy, frame.u_right,
            frame.sigma2, has, timing=timing,
            **_rig_kwargs(calib, frame, R0.device))
    matched = torch.where(res.inlier, mp, -1).to(torch.int32)
    return TrackOut(R=res.R, t=res.t, matched_mp=matched,
                    n_matched=mm.n_matches, n_inliers=res.n_inliers,
                    n_right=res.n_right)


def track_by_pnp(ms: M.MapState, calib: Calib, frame: FrameData, kf: int,
                 generator: torch.Generator) -> TrackOut:
    """Prior-free relocalization against one candidate keyframe:
    appearance matching -> batched PnP RANSAC -> motion-only pose
    optimization (ref Tracking::Relocalization: SearchByBoW +
    MLPnPsolver::iterate + PoseOptimization). When PnP is not ok the
    optimization starts from the candidate keyframe's own pose."""
    params = calib.params_array(frame.u_right.device)
    f = frame.feats
    kf_obs = ms.obs_mp[kf]
    kf_has = ms.kp_valid[kf] & (kf_obs >= 0)
    mm = matching.mutual_match(f.desc, f.valid, ms.kp_desc[kf], kf_has,
                               max_dist=matching.TH_LOW, nn_ratio=0.75,
                               angle_a=f.angle, angle_b=ms.kp_angle[kf])
    has = mm.idx_b >= 0
    mp = torch.where(has, kf_obs[mm.idx_b.clamp(min=0).long()], -1)
    has &= mp >= 0
    X = ms.mp_pos[mp.clamp(min=0).long()]
    res_pnp = pnp.pnp_ransac(calib.model, params, X, f.xy, frame.sigma2,
                             has, generator, n_hyp=256, min_inliers=10)
    R0 = torch.where(res_pnp.ok, res_pnp.R, ms.kf_R[kf])
    t0 = torch.where(res_pnp.ok, res_pnp.t, ms.kf_t[kf])
    res = pose_opt.pose_optimize(
        calib.model, params, calib.bf, R0, t0, X, f.xy, frame.u_right,
        frame.sigma2, has, **_rig_kwargs(calib, frame, R0.device))
    matched = torch.where(res.inlier, mp, -1).to(torch.int32)
    return TrackOut(R=res.R, t=res.t, matched_mp=matched,
                    n_matched=mm.n_matches, n_inliers=res.n_inliers,
                    n_right=res.n_right)


class TrackFullOut(NamedTuple):
    ms: M.MapState
    R: torch.Tensor
    t: torch.Tensor
    matched_mp: torch.Tensor
    stats: torch.Tensor
    """(33,) float32: [R row-major (9), t (3), motion_inliers, used_wide,
    used_fallback, local_inliers, n_close_tracked, n_close_untracked,
    best_local_kf, n_local_candidates, n_ref_matches, ref-KF R (9),
    ref-KF t (3)] — the reference's packed layout, one fetch per frame.
    `track_full_imu` appends the body velocity (33:36) and the bias
    [bg, ba] (36:42); an unrectified pair then the right rows kept (last
    entry)."""
    v: torch.Tensor = None      # body velocity, world frame (inertial step)
    bias: torch.Tensor = None   # [bg, ba] (inertial step)


def _predict_const_velocity(R_last, t_last, R_last2, t_last2, has_vel):
    """Constant-velocity prediction T0 = (T_last T_last2^-1) T_last."""
    R_vel = R_last @ R_last2.T
    t_vel = t_last - R_vel @ t_last2
    has_vel = torch.as_tensor(has_vel, device=R_last.device)
    return (torch.where(has_vel, R_vel @ R_last, R_last),
            torch.where(has_vel, R_vel @ t_last + t_vel, t_last))


def _track_core(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                frame: FrameData, R0, t0, R_last, t_last, last_matched,
                ref_kf: int, local_cap: int, obs_mask=None, *, timing=None):
    """Motion-model matching (+ widened retry + appearance fallback), then
    local-map tracking. Returns (out3, out4, local, n_right): the
    cascade's and the local map's tracks, what `_track_stats` needs of the
    local map, and the right rows the solves kept (None without any)."""
    pt_idx = last_matched.clamp(min=0)
    pt_valid = last_matched >= 0
    with span(timing, "track.motion"):
        # coarse 2x5 LM budget in the motion-model stage (the local-map
        # stage re-polishes with the reference's full 4x10)
        out1 = track_points(ms, calib, orb_cfg, frame, R0, t0, pt_idx,
                            pt_valid, 7.0, 0.9, opt_rounds=2, opt_iters=5,
                            timing=timing)
        with sync(timing, "track_wide"):
            need_wide = bool(out1.n_inliers < 20)              # sync: lax.cond
        out2 = track_points(ms, calib, orb_cfg, frame, R0, t0, pt_idx,
                            pt_valid, 14.0, 0.9, opt_rounds=2, opt_iters=5,
                            timing=timing) if need_wide else out1
        with sync(timing, "track_fallback"):
            need_fb = bool(out2.n_inliers < 10)                # sync: lax.cond
        out3 = track_by_appearance(ms, calib, frame, ref_kf, R_last, t_last,
                                   timing=timing) if need_fb else out2

    with span(timing, "track.local_select"):
        lk_idx, lk_mask = local_keyframes(ms, out3.matched_mp, k=10,
                                          obs_mask=obs_mask)
        lmask = M.local_map_mask(ms, lk_idx, lk_mask)
        l_idx, l_valid = M.gather_local_points(ms, lmask, local_cap)
    with span(timing, "track.local"):
        out4 = track_points(ms, calib, orb_cfg, frame, out3.R, out3.t,
                            l_idx, l_valid, 1.0, 0.8, rotation_gate=False,
                            opt_rounds=4, opt_iters=10, timing=timing)
    n_right = None
    if out4.n_right is not None:
        # every solve that ran: the cascade's calls, then the local map's
        n_right = out1.n_right + out4.n_right
        if need_wide:
            n_right = n_right + out2.n_right
        if need_fb:
            n_right = n_right + out3.n_right
    return out3, out4, (need_wide, need_fb, lk_idx, l_idx, l_valid), n_right


def _track_stats(ms, calib, frame, out3, out4, local, R, t, n_inliers,
                 n_obs_all=None, extra=()):
    """Point statistics (updated in `ms` in place) and the keyframe-decision
    counters, packed with the pose. Returns (ms, stats)."""
    need_wide, need_fb, lk_idx, l_idx, l_valid = local
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
        out3.n_inliers, int(need_wide), int(need_fb), n_inliers, n_ct,
        n_cu, lk_idx[0], l_valid.sum(), n_ref)])
    return ms, _pack_stats(ms, R, t, stats_i, best_kf, extra)


def _right_extra(n_right) -> tuple:
    """The stats pack's last entry for an unrectified pair: the right rows
    the frame's solves kept."""
    return () if n_right is None else (n_right.reshape(1),)


def _pack_stats(ms, R, t, stats_i, best_kf, extra=()):
    return torch.cat([R.reshape(9).float(), t.float(), stats_i.float(),
                      ms.kf_R[best_kf].reshape(9).float(),
                      ms.kf_t[best_kf].float(),
                      *[e.float() for e in extra]])


def track_full(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
               frame: FrameData, R_last, t_last, R_last2, t_last2, has_vel,
               last_matched, ref_kf: int, local_cap: int, n_obs_all=None,
               obs_mask=None, *, timing=None) -> TrackFullOut:
    """The per-frame tracking compute: constant-velocity prediction, the
    association cascade, local-map tracking, point statistics (updated in
    `ms` in place) and the keyframe-decision counters."""
    R0, t0 = _predict_const_velocity(R_last, t_last, R_last2, t_last2,
                                     has_vel)
    out3, out4, local, n_right = _track_core(
        ms, calib, orb_cfg, frame, R0, t0, R_last, t_last, last_matched,
        ref_kf, local_cap, obs_mask, timing=timing)
    with span(timing, "track.stats"):
        ms, stats = _track_stats(ms, calib, frame, out3, out4, local, out4.R,
                                 out4.t, out4.n_inliers, n_obs_all,
                                 _right_extra(n_right))
    return TrackFullOut(ms=ms, R=out4.R, t=out4.t,
                        matched_mp=out4.matched_mp, stats=stats)


def track_full_imu(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                   frame: FrameData, R_last, t_last, v_last, bias, imu_rows,
                   imu_valid, gravity, noise, R_bc, t_bc, last_matched,
                   ref_kf: int, local_cap: int, n_obs_all=None, obs_mask=None,
                   n_rows=None, *, timing=None) -> TrackFullOut:
    """The inertial tracking step: preintegrate the frame's IMU rows,
    predict the pose from the last body state (ref
    Tracking::PredictStateIMU), run the association cascade, then refine
    [pose, velocity, bias] jointly against reprojection and the
    preintegration factor (ref Optimizer::PoseInertialOptimizationLastFrame).
    The body state chains on the device between frames.

    imu_rows: (cap,7) padded [dt, ax..az, gx..gz], imu_valid its mask and
    n_rows the count of leading valid rows when the caller knows it; noise:
    the four continuous densities [gyro, acc, gyro_walk, acc_walk];
    R_bc/t_bc: the extrinsic T_bc."""
    R_cb = R_bc.T
    p_cb = -R_cb @ t_bc

    def body_of_cam(R_cw, t_cw):
        """T_wb = T_wc T_cb from a camera pose T_cw."""
        R_wc = R_cw.T
        return R_wc @ R_cb, R_wc @ p_cb - R_wc @ t_cw

    def cam_of_body(R_wb, p_wb):
        """T_cw = (T_wb T_bc)^-1."""
        R_cw = (R_wb @ R_bc).T
        return R_cw, -R_cw @ (R_wb @ t_bc + p_wb)

    with span(timing, "imu.predict"):
        preint = imu_ops.integrate(bias, imu_rows, imu_valid, *noise,
                                   n_rows=n_rows)
        R_wb1, p_wb1 = body_of_cam(R_last, t_last)

        # IMU state prediction across the interval
        dT = preint.dT
        R_wb2 = lie.orthonormalize(R_wb1 @ preint.dR)
        v2 = v_last + gravity * dT + R_wb1 @ preint.dV
        p_wb2 = p_wb1 + v_last * dT + 0.5 * gravity * dT * dT \
            + R_wb1 @ preint.dP
        R0, t0 = cam_of_body(R_wb2, p_wb2)

    out3, out4, local, n_right = _track_core(
        ms, calib, orb_cfg, frame, R0, t0, R_last, t_last, last_matched,
        ref_kf, local_cap, obs_mask, timing=timing)

    with span(timing, "pvb_opt"):
        # joint [T_wb, v, bg, ba] refinement seeded at the visual solution
        R_wb4, p_wb4 = body_of_cam(out4.R, out4.t)
        has = out4.matched_mp >= 0
        X = ms.mp_pos[out4.matched_mp.clamp(min=0).long()]
        pvb = inertial_opt.pose_vel_bias_optimize(
            calib.model, calib.params_array(R0.device), calib.bf, R_bc, t_bc,
            R_wb1, p_wb1, v_last, bias[:3], bias[3:], preint, R_wb4, p_wb4,
            v2, X, frame.feats.xy, frame.u_right, frame.sigma2, has,
            walk_info=torch.full((6,), 1e4, dtype=R_wb4.dtype,
                                 device=R_wb4.device), g=gravity,
            timing=timing, **_rig_kwargs(calib, frame, R0.device))
        if n_right is not None:
            n_right = n_right + pvb.n_right
        # the joint solution is taken when it keeps at least as many inliers
        use = (pvb.n_inliers >= out4.n_inliers) & (dT > 0)
        R_c, t_c = cam_of_body(pvb.R_wb, pvb.p_wb)
        R_n = torch.where(use, R_c, out4.R)
        t_n = torch.where(use, t_c, out4.t)
        v_n = torch.where(use, pvb.v, v2)
        bias_n = torch.where(use, torch.cat([pvb.bg, pvb.ba]), bias)
        matched = torch.where(use & ~pvb.inlier, -1, out4.matched_mp)
        n_inl = torch.where(use, pvb.n_inliers, out4.n_inliers)
    with span(timing, "track.stats"):
        ms, stats = _track_stats(ms, calib, frame, out3, out4, local, R_n,
                                 t_n, n_inl, n_obs_all,
                                 extra=(v_n, bias_n) + _right_extra(n_right))
    return TrackFullOut(ms=ms, R=R_n, t=t_n, matched_mp=matched,
                        stats=stats, v=v_n, bias=bias_n)


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
