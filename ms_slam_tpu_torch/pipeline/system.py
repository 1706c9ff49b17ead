"""System facade: the public API and the pipeline schedule (stereo visual).

Port of the stereo visual subset of `ms_slam_tpu/pipeline/system.py`:
`track_stereo` runs the frontend and dispatches the tracking step; the
previous in-flight frame completes behind it (pipeline depth 2, as the
reference), so host keyframe decisions lag the same frames as there.

With `sparsify=True` the sliding-window sparsifier runs after each
keyframe's local-mapping window and the keyframe database (KFDB) holds a
BoW row per keyframe; sparsified keyframes are its retrieval candidates.
A tracking failure goes through the reference's loss path: relocalization
(KFDB shortlist, or a brute appearance sweep without a KFDB, then
prior-free PnP), else the RECENTLY_LOST grace window, LOST, and after
enough lost frames a fresh map in the Atlas labels.

With `loop_closing=True` every keyframe also goes to the LoopCloser:
place recognition against the sparsified keyframes, confirmation over three
keyframes, then the loop correction or the Atlas map merge.

The reference's tunnel workarounds (device-scalar cache, upload thread,
batched fetches with `_complete_batch`) are not carried over. IMU and
fisheye configurations raise at construction.
"""
from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models import map_state as M
from ..models.vocab import KeyFrameDatabase, place_scores
from ..ops.lie import rot_to_quat
from ..ops.orb import OrbConfig
from . import mapping_ops as mo
from . import tracking_ops as to
from .frontend import Calib, FrameData, process_stereo_stacked
from .loop_closing import LoopCloser
from .sparsification import Sparsifier

OK, NOT_INITIALIZED, RECENTLY_LOST, LOST = "OK", "NOT_INIT", "RECENTLY_LOST", "LOST"
PIPELINE_DEPTH = 2


@dataclass
class SystemConfig:
    """The reference's SystemConfig fields that the stereo visual path
    reads, with its defaults, plus the switch that selects a path not
    ported yet (`use_imu`: it must stay off)."""

    calib: Calib = None
    orb: OrbConfig = None
    map: M.MapConfig = None
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 10
    ref_ratio: float = 0.75
    min_init_depth_points: int = 200
    n_triangulate_neighbors: int = 4
    n_fixed_cams: int = 4
    ba_iters: int = 8
    # sparsification (ref Sparsification.* yaml keys)
    sparsify: bool = False
    sparsify_n: int = 75
    sparsify_lambda: float = 500.0
    sparsify_grid_lambda: float = 10.0
    sparsify_window: int = 10
    sparsify_queue_min: int = 4
    nonlocal_kf: int = 8
    loop_closing: bool = False
    # essential-graph extra-edge covisibility threshold (ref minFeat=100 at
    # 2000 features a frame; scale down for smaller feature budgets)
    loop_covis_min: int = 100
    # inertial yaw-only loop gate tolerances (ref LoopClosing.cc:243-256)
    loop_pitchroll_tol: float = 0.008
    loop_yaw_tol: float = 0.349
    use_imu: bool = False
    localization_only: bool = False
    # RECENTLY_LOST grace window before LOST, in seconds (ref
    # time_recently_lost, src/Tracking.cc:1947-2018)
    t_recently_lost: float = 5.0


@dataclass
class TrajectoryEntry:
    frame_id: int
    timestamp: float
    ref_kf: int            # -1: T_cr is absolute (world) already
    T_cr: np.ndarray       # frame pose relative to reference keyframe
    lost: bool


@dataclass
class InFlight:
    """A dispatched tracking step whose stats are not yet integrated."""
    frame_id: int
    timestamp: float
    frame: FrameData
    out: "to.TrackFullOut"


class System:
    def __init__(self, cfg: SystemConfig, device=None):
        """device: where the map and every step run; None means the CUDA
        card, and raises when there is none (the CPU only on request)."""
        if cfg.use_imu:
            raise NotImplementedError(
                "SystemConfig.use_imu is not ported yet (ROADMAP queue 1)")
        if cfg.calib.is_fisheye_stereo or cfg.calib.model != 0:
            raise NotImplementedError("fisheye cameras are not ported yet")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "System: no CUDA device; pass device='cpu' to run on "
                    "the CPU")
            device = "cuda"
        self.cfg = cfg
        self.calib = cfg.calib
        self.orb = cfg.orb
        self.device = torch.device(device)
        self.ms = M.empty_map(cfg.map, self.device)
        # per-point observation counts + observer bitmask: the observation
        # graph changes only at keyframe rate, so tracking reads these
        self._n_obs_dev = None
        self._obs_mask_dev = None
        self._obs_dirty = True
        self.n_kf = 0
        self.kf_ord = 0
        self.kf_free: list[int] = []
        self.kf_order: list[int] = []
        self.n_mp = 0
        self.state = NOT_INITIALIZED
        self.frame_id = -1
        self.last_R = np.eye(3, dtype=np.float32)
        self.last_t = np.zeros(3, dtype=np.float32)
        self._ref_pose_np = (np.eye(3, dtype=np.float32),
                             np.zeros(3, dtype=np.float32))
        self.vel: Optional[np.ndarray] = None
        self.last_matched = None
        self.ref_kf = 0
        self.last_kf_frame = 0
        self.n_inliers_ref = 0
        self.trajectory: list[TrajectoryEntry] = []
        self.timing: dict[str, list] = {}
        self._inflight: deque[InFlight] = deque()
        self._Rt_dev = None
        self._Rt_dev2 = None
        self._has_vel = False
        self._lost_ts: Optional[float] = None
        self._lost_frames = 0
        self._pending_kf_info = None
        # Atlas labels (host): the map id of each keyframe slot; a fresh map
        # starts after irrecoverable loss (ref Tracking::CreateMapInAtlas)
        self.active_map = 0
        self.kf_maps: list[int] = []
        # RANSAC draws of relocalization
        self._reloc_gen = torch.Generator(device=self.device)
        self._reloc_gen.manual_seed(0xE10C)
        # the sparsified-keyframe database is System state: relocalization
        # reads it with loop closing off
        self.kf_db = None
        self._sparsifier = None
        self._loop_closer = None
        if cfg.sparsify or cfg.loop_closing:
            self.kf_db = KeyFrameDatabase(max_kf=cfg.map.max_kf,
                                          device=self.device)
        if cfg.sparsify:
            self._sparsifier = Sparsifier(self)
        if cfg.loop_closing:
            self._loop_closer = LoopCloser(self)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def track_stereo(self, img_l, img_r, timestamp: float,
                     next_images=None) -> np.ndarray:
        """Process one rectified stereo pair; returns the estimated Tcw
        (4,4). `next_images` is accepted for the reference's signature; the
        next frame's frontend runs when that frame is tracked."""
        del next_images
        self.frame_id += 1
        t0 = time.perf_counter()
        stacked = np.stack([self._as_uint8(img_l), self._as_uint8(img_r)])
        frame = process_stereo_stacked(
            torch.from_numpy(stacked).to(self.device), self.calib, self.orb)
        self._tic(t0, "frontend")
        return self._advance(frame, timestamp)

    @staticmethod
    def _as_uint8(img):
        a = np.asarray(img)
        if a.dtype == np.uint8:
            return a
        return np.clip(a, 0, 255).astype(np.uint8)

    def _advance(self, frame: FrameData, timestamp: float) -> np.ndarray:
        """Per-frame state machine: in OK the tracking step is dispatched
        and the previous in-flight frame is completed behind it."""
        t0 = time.perf_counter()
        if self.state == NOT_INITIALIZED:
            self._flush_pipeline()
            self._stereo_initialization(frame, timestamp)
            self._tic(t0, "track")
            return self.current_pose()
        if self.state in (RECENTLY_LOST, LOST):
            self._flush_pipeline()
            self._track_lost(frame, timestamp)
            self._tic(t0, "track")
            return self.current_pose()
        self._dispatch_track(frame, timestamp)
        self._tic(t0, "track_dispatch")
        t2 = time.perf_counter()
        while len(self._inflight) > PIPELINE_DEPTH - 1:
            self._complete_one()
        self._tic(t2, "complete")
        self._tic(t0, "track")
        return self._predicted_pose()

    def current_pose(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = np.asarray(self.last_R)
        T[:3, 3] = np.asarray(self.last_t)
        return T

    def map_points_in_map(self) -> int:
        return int(self.ms.mp_valid.sum())

    def compressed_map_points_in_map(self) -> int:
        return int((self.ms.mp_valid & self.ms.mp_sparsified).sum())

    def keyframes_in_map(self) -> int:
        return int(self.ms.kf_valid.sum())

    def memory_stats(self) -> dict:
        """Live map memory, the MS-SLAM headline metric: bytes of live
        keyframe features (56 B each) and live map points (80 B each),
        against the same map plus what the selector removed (its deleted
        points and the feature slots its compaction freed, both counted by
        `sparsify_window`)."""
        self._flush_pipeline()
        kp_live = int((self.ms.kp_valid & self.ms.kf_valid[:, None]).sum())
        mp_live = self.map_points_in_map()
        stats = self._sparsifier.stats if self._sparsifier else {}
        killed = stats.get("killed", 0)
        feat_b, mp_b = 56, 80
        live = kp_live * feat_b + mp_live * mp_b
        without = live + killed * mp_b + stats.get("slots_freed", 0) * feat_b
        return {"live_bytes": live, "without_sparsification_bytes": without,
                "reduction": 1.0 - live / max(without, 1),
                "kp_live": kp_live, "mp_live": mp_live,
                "mp_selector_killed": killed,
                "mp_compressed": self.compressed_map_points_in_map()}

    def print_time_stats(self, file=None):
        """Per-stage host timing summary."""
        file = file or sys.stderr
        print("stage              n      mean      median     p95    total",
              file=file)
        for k, v in sorted(self.timing.items()):
            a = np.asarray(v)
            if not len(a):
                continue
            print(f"{k:<16} {len(a):>4} {a.mean()*1e3:8.2f}ms "
                  f"{np.median(a)*1e3:8.2f}ms {np.percentile(a, 95)*1e3:7.1f}"
                  f"ms {a.sum():7.2f}s", file=file)

    def shutdown(self):
        """Flush the pipeline and sparsify every keyframe left (ref
        ShutdownMapCompressing)."""
        self._flush_pipeline()
        if self._sparsifier is not None:
            self._sparsifier.finish()

    # ------------------------------------------------------------------
    # trajectory export
    # ------------------------------------------------------------------

    def _kf_pose(self, slot: int) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.ms.kf_R[slot].cpu().numpy()
        T[:3, 3] = self.ms.kf_t[slot].cpu().numpy()
        return T

    def _frame_pose(self, e: TrajectoryEntry) -> np.ndarray:
        if e.ref_kf < 0:
            return e.T_cr
        return e.T_cr @ self._kf_pose(e.ref_kf)

    def poses_wc(self):
        """List of (timestamp, Twc 4x4) for all tracked frames."""
        self._flush_pipeline()
        return [(e.timestamp, np.linalg.inv(self._frame_pose(e)))
                for e in self.trajectory if not e.lost]

    def save_trajectory_kitti(self, path: str):
        with open(path, "w") as f:
            for _, Twc in self.poses_wc():
                f.write(" ".join(f"{v:.9e}" for v in Twc[:3].reshape(-1))
                        + "\n")

    def save_trajectory_tum(self, path: str):
        with open(path, "w") as f:
            for ts, Twc in self.poses_wc():
                q = rot_to_quat(torch.from_numpy(Twc[:3, :3])).numpy()
                t = Twc[:3, 3]
                f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _tic(self, t0, key):
        self.timing.setdefault(key, []).append(time.perf_counter() - t0)

    def _stereo_initialization(self, frame: FrameData, timestamp: float):
        """Ref Tracking::StereoInitialization: enough stereo-depth features
        create the origin keyframe with every depth unprojected."""
        n_depth = int(((frame.depth > 0) & frame.feats.valid).sum())
        if n_depth < self.cfg.min_init_depth_points:
            return
        kf_slot = self._alloc_kf_slot()
        if kf_slot is None:
            return
        dev = self.device
        no_match = torch.full((self.cfg.map.n_feat,), -1, dtype=torch.int32,
                              device=dev)
        self.ms, n_new = mo.create_keyframe(
            self.ms, self.calib, kf_slot, frame,
            torch.eye(3, device=dev), torch.zeros(3, device=dev), no_match,
            self.kf_ord, self.frame_id, 1e9)
        self.kf_ord += 1
        self.kf_order.append(kf_slot)
        self.n_mp += int(n_new)
        self.ref_kf = kf_slot
        self.last_kf_frame = self.frame_id
        if self.kf_db is not None:
            self.kf_db.set_row(kf_slot, frame.feats.desc, frame.feats.valid)
        self.last_R = np.eye(3, dtype=np.float32)
        self.last_t = np.zeros(3, dtype=np.float32)
        self._ref_pose_np = (self.last_R, self.last_t)
        self.last_matched = self.ms.obs_mp[kf_slot].clone()
        self.n_inliers_ref = n_depth
        self.state = OK
        self._obs_dirty = True
        self._Rt_dev = None
        self._Rt_dev2 = None
        self._has_vel = False
        self.vel = None
        self._lost_ts = None
        if self._loop_closer is not None:
            self._loop_closer.insert_keyframe(kf_slot)
        self._record(timestamp, lost=False)

    def _dispatch_track(self, frame: FrameData, timestamp: float):
        """Enqueue this frame's tracking step; every input is a host
        constant or a tensor from the previous step."""
        cfg = self.cfg
        dev = self.device
        last_matched = self.last_matched
        if last_matched is None:
            last_matched = torch.full((cfg.map.n_feat,), -1,
                                      dtype=torch.int32, device=dev)
        if self._obs_dirty or self._n_obs_dev is None:
            self._n_obs_dev = M.mp_obs_count(self.ms)
            self._obs_mask_dev = M.observer_mask(self.ms)
            self._obs_dirty = False
        if self._Rt_dev is None:
            self._Rt_dev = (torch.as_tensor(self.last_R, device=dev),
                            torch.as_tensor(self.last_t, device=dev))
        R_last, t_last = self._Rt_dev
        R_l2, t_l2 = (self._Rt_dev2 if self._Rt_dev2 is not None
                      else (R_last, t_last))
        out = to.track_full(
            self.ms, self.calib, self.orb, frame, R_last, t_last, R_l2, t_l2,
            self._has_vel, last_matched, self.ref_kf, cfg.map.local_mp_cap,
            self._n_obs_dev, self._obs_mask_dev)
        self.ms = out.ms
        self._inflight.append(InFlight(frame_id=self.frame_id,
                                       timestamp=timestamp, frame=frame,
                                       out=out))
        self._Rt_dev2 = (R_last, t_last)
        self._Rt_dev = (out.R, out.t)
        self._has_vel = True
        self.last_matched = out.matched_mp

    def _complete_one(self):
        """Fetch and integrate the oldest in-flight frame: state machine,
        pose bookkeeping, keyframe decision (host half of Tracking::Track)."""
        fl = self._inflight.popleft()
        cfg = self.cfg
        tf = time.perf_counter()
        # sync: the one per-frame stats fetch (a deferred keyframe's info
        # rides along with it)
        if self._pending_kf_info is not None:
            slot, info = self._pending_kf_info
            self._pending_kf_info = None
            self._integrate_kf_info(slot, info.cpu().numpy())
        packed = fl.out.stats.cpu().numpy()
        self._tic(tf, "stats_fetch")
        R_np = packed[:9].reshape(3, 3).astype(np.float32)
        t_np = packed[9:12].astype(np.float32)
        (n_pre, _used_wide, _used_fb, n_inliers, n_close, n_close_untracked,
         best_kf, _n_cand, n_ref) = (int(v) for v in packed[12:21])

        if n_pre < 10 or n_inliers < 15:
            self._on_track_failure(fl)
            return
        self.state = OK
        self._lost_frames = 0
        self._lost_ts = None
        if n_ref > 0:
            self.n_inliers_ref = n_ref
        T_last = self.current_pose()
        T_now = np.eye(4)
        T_now[:3, :3] = R_np
        T_now[:3, 3] = t_np
        self.vel = T_now @ np.linalg.inv(T_last)
        self.last_R = R_np
        self.last_t = t_np
        if best_kf != self.ref_kf:
            self.ref_kf = best_kf
            self._ref_pose_np = (packed[21:30].reshape(3, 3).astype(np.float32),
                                 packed[30:33].astype(np.float32))

        # keyframe decision (ref NeedNewKeyFrame)
        need_close = (n_close < 100) and (n_close_untracked > 70)
        c1a = fl.frame_id >= self.last_kf_frame + cfg.max_frames_between_kf
        c1b = fl.frame_id >= self.last_kf_frame + cfg.min_frames_between_kf
        c2 = (n_inliers < self.n_inliers_ref * cfg.ref_ratio) or need_close
        if ((c1a or (c1b and c2)) and n_inliers > 15
                and not cfg.localization_only):
            self._create_keyframe(fl, R_np, t_np)
        self._record(fl.timestamp, lost=False, frame_id=fl.frame_id)

    def _adopt_reloc(self, rl: "to.TrackOut", timestamp: float,
                     frame_id: int):
        """Continue tracking from a relocalized pose."""
        self.state = OK
        self._lost_frames = 0
        self._lost_ts = None
        self.last_R = rl.R.cpu().numpy().astype(np.float32)
        self.last_t = rl.t.cpu().numpy().astype(np.float32)
        self._Rt_dev = (rl.R, rl.t)
        self._Rt_dev2 = None
        self.last_matched = rl.matched_mp
        self._refresh_ref_pose()
        self._record(timestamp, lost=False, frame_id=frame_id)

    def _on_track_failure(self, fl: InFlight):
        """Tracking failed for frame fl: relocalize now, or enter the
        RECENTLY_LOST grace window (ref src/Tracking.cc:1947-2018)."""
        self.vel = None
        self._has_vel = False
        rl = self._relocalize(fl.frame)
        if rl is not None:
            self._adopt_reloc(rl, fl.timestamp, fl.frame_id)
            self._redispatch_inflight()
            return
        if self.n_kf > 10:
            # grace window: keep extrapolating and retrying relocalization
            self.state = RECENTLY_LOST
            if self._lost_ts is None:
                self._lost_ts = fl.timestamp
        else:
            self.state = LOST
            self._lost_frames += 1
        self._record(fl.timestamp, lost=True, frame_id=fl.frame_id)
        self._extrapolate_pose()
        # newer in-flight frames were tracked from a bad pose: reprocess
        # them through the loss path
        stale = list(self._inflight)
        self._inflight.clear()
        for s in stale:
            self._track_lost(s.frame, s.timestamp, frame_id=s.frame_id)

    def _track_lost(self, frame: FrameData, timestamp: float,
                    frame_id: Optional[int] = None):
        """Per-frame handling in RECENTLY_LOST / LOST (ref
        Tracking.cc:1991-2018): retry relocalization, carry the pose
        forward, and start a fresh Atlas map when the loss is
        irrecoverable."""
        fid = self.frame_id if frame_id is None else frame_id
        rl = self._relocalize(frame)
        if rl is not None:
            self.vel = None
            self._has_vel = False
            self._adopt_reloc(rl, timestamp, fid)
            return
        if self.state == RECENTLY_LOST:
            self._extrapolate_pose()
            if (self._lost_ts is not None
                    and timestamp - self._lost_ts > self.cfg.t_recently_lost):
                self.state = LOST
        if self.state == LOST:
            self._lost_frames += 1
            if (self._lost_frames > int(2 * self.calib.fps)
                    and self.n_kf >= 5
                    and (self.cfg.map.max_kf - self.n_kf
                         + len(self.kf_free)) >= 8):
                self.active_map += 1
                self.state = NOT_INITIALIZED
                self.last_matched = None
                self._Rt_dev = None
                self._lost_frames = 0
                self._lost_ts = None
        self._record(timestamp, lost=True, frame_id=fid)

    def _extrapolate_pose(self):
        """Carry the pose forward through a blackout: constant velocity,
        else hold (the reference's IMU branch needs use_imu)."""
        if self.vel is not None:
            T = self.vel @ self.current_pose()
            self.last_R = T[:3, :3].astype(np.float32)
            self.last_t = T[:3, 3].astype(np.float32)
        self._Rt_dev = None

    def _redispatch_inflight(self):
        """Re-run newer in-flight frames after an event that invalidated
        their inputs (relocalization, a loop correction): their tracks rerun
        from the corrected pose."""
        stale = list(self._inflight)
        self._inflight.clear()
        saved_fid = self.frame_id
        for s in stale:
            self.frame_id = s.frame_id
            self._dispatch_track(s.frame, s.timestamp)
        self.frame_id = saved_fid

    def _relocalize(self, frame: FrameData) -> Optional["to.TrackOut"]:
        """Relocalization (ref Tracking::Relocalization): candidates from
        the sparsified-keyframe database (a brute appearance sweep over all
        valid keyframes when there is none) -> appearance matching ->
        prior-free PnP RANSAC -> pose optimization -> the widening
        projection refinement. Returns the refined track or None."""
        f = frame.feats
        if self.kf_db is not None and self.kf_db.present.any():
            # tf-idf shortlist, exact rescoring of the shortlist only
            cands, _ = self.kf_db.query_rescored(
                self.ms.kp_desc, self.ms.kp_valid, f.desc, f.valid, k=5)
        else:
            # brute appearance sweep; keyframes not valid score -1
            scores = place_scores(self.ms.kp_desc, self.ms.kp_valid,
                                  self.ms.kf_valid, f.desc,
                                  f.valid).cpu().numpy()
            order = np.argsort(-scores)[:5]
            cands = [int(i) for i in order if scores[i] > 0.05]
        best = None
        for c in cands:
            out = to.track_by_pnp(self.ms, self.calib, frame, c,
                                  self._reloc_gen)
            n = int(out.n_inliers)                  # sync: host choice
            if n >= 15 and (best is None or n > best[0]):
                best = (n, c, out)
        if best is None:
            return None
        n_best, c, out = best
        # refine: a coarse radius-10 harvest around the PnP pose, then a
        # narrow radius-3 pass with a tighter ratio (ref Tracking.cc:3741)
        obs_c = self.ms.obs_mp[c]
        n_out = n_best
        for radius, ratio in ((10.0, 0.9), (3.0, 0.75)):
            ref = to.track_points(self.ms, self.calib, self.orb, frame,
                                  out.R, out.t, obs_c.clamp(min=0),
                                  obs_c >= 0, radius, ratio)
            n_ref = int(ref.n_inliers)              # sync: host choice
            if n_ref < n_out:
                break
            out, n_out = ref, n_ref
        self.ref_kf = c
        # a hit in another map moves the active-map label with it
        if c < len(self.kf_maps) and self.kf_maps[c] != self.active_map:
            self.active_map = self.kf_maps[c]
        self.vel = None
        return out

    def _flush_pipeline(self):
        """Complete every in-flight frame."""
        while self._inflight:
            self._complete_one()
        self._flush_pending_info()
        if self._loop_closer is not None:
            self._loop_closer.flush()

    def _predicted_pose(self) -> np.ndarray:
        """Host estimate for the newest dispatched frame (its tracked pose
        lands at the next call; the recorded trajectory uses the true
        pose)."""
        T_last = self.current_pose()
        if self.vel is not None and self._has_vel:
            return self.vel @ T_last
        return T_last

    def _alloc_kf_slot(self) -> Optional[int]:
        """Recycled slots first, else the high-water mark; at capacity
        evict the oldest evictable keyframe."""
        if not self.kf_free and self.n_kf >= self.cfg.map.max_kf:
            self._evict_oldest_kf()
        if self.kf_free:
            slot = self.kf_free.pop()
            self._on_kf_slot_reuse(slot)
            self.kf_maps[slot] = self.active_map
            return slot
        if self.n_kf >= self.cfg.map.max_kf:
            return None
        slot = self.n_kf
        self.n_kf += 1
        self.kf_maps.append(self.active_map)
        return slot

    def _evict_oldest_kf(self):
        """Drop the temporally oldest keyframe outside the recent window
        that is not the tracking reference."""
        keep = set(self.kf_order[-(self.cfg.map.window_kf + 2):])
        keep.add(self.ref_kf)
        for s in list(self.kf_order):
            if s in keep:
                continue
            mask = torch.zeros(self.cfg.map.max_kf, dtype=torch.bool,
                               device=self.device)
            mask[s] = True
            self.ms = M.delete_keyframes(self.ms, mask)
            self._obs_dirty = True
            self._free_keyframes([s])
            if self.kf_db is not None:
                self.kf_db.erase(s)
            return

    def _on_kf_slot_reuse(self, slot: int):
        """Before overwriting a recycled slot: trajectory entries anchored
        to it become absolute poses, and the stages forget the slot."""
        if any(e.ref_kf == slot for e in self.trajectory):
            T_rw = self._kf_pose(slot)
            for e in self.trajectory:
                if e.ref_kf == slot:
                    e.T_cr = e.T_cr @ T_rw
                    e.ref_kf = -1
        if self._sparsifier is not None:
            self._sparsifier.forget(slot)
        if self.kf_db is not None:
            self.kf_db.erase(slot)

    def _create_keyframe(self, fl: InFlight, R_np, t_np):
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        if slot is None:
            return
        t0 = time.perf_counter()
        out = fl.out
        cullable, red_th = self._cull_policy()
        ko = mo.keyframe_step(
            self.ms, self.calib, self.orb, slot, fl.frame, out.R, out.t,
            out.matched_mp, self.kf_ord, fl.frame_id, self.calib.th_depth,
            n_tri=cfg.n_triangulate_neighbors, window_kf=cfg.map.window_kf,
            n_fixed=cfg.n_fixed_cams, pt_cap=cfg.map.local_mp_cap,
            ba_iters=cfg.ba_iters, cullable=cullable, red_th=red_th)
        self.ms = ko.ms
        self._n_obs_dev = ko.n_obs
        self._obs_mask_dev = ko.obs_mask
        self._obs_dirty = False
        self.kf_ord += 1
        self.kf_order.append(slot)
        self.ref_kf = slot
        self.last_kf_frame = fl.frame_id
        # the keyframe's observation row is the motion-model candidate set
        # of the next dispatched frame (cloned: later steps write obs_mp)
        self.last_matched = self.ms.obs_mp[slot].clone()
        if self.kf_db is not None:
            # BoW row at creation (ref LocalMapping::ProcessNewKeyFrame)
            self.kf_db.set_row(slot, fl.frame.feats.desc,
                               fl.frame.feats.valid)
        # the dispatch-time pose is the tracked pose; the BA-refined one
        # arrives with the deferred info at the next completion
        self._ref_pose_np = (R_np, t_np)
        self._flush_pending_info()
        self._pending_kf_info = (slot, ko.info)
        self._tic(t0, "keyframe_step")

    def _cull_policy(self):
        """Keyframe-culling inputs: in the visual configuration any
        keyframe may go at the 0.9 redundancy bar (the reference's inertial
        protections need use_imu, which is not ported)."""
        return None, 0.9

    def _integrate_kf_info(self, slot: int, info: np.ndarray):
        """Apply a keyframe step's packed scalars to the host schedule
        (counters, BA-refined ref pose, keyframe free-list, the sparsifier's
        window feed)."""
        Wk = self.cfg.map.window_kf
        self.n_mp += int(info[0]) + int(info[1])
        self.n_inliers_ref = int(info[5])
        if self.ref_kf == slot:
            self._ref_pose_np = (info[6:15].reshape(3, 3).astype(np.float32),
                                 info[15:18].astype(np.float32))
        self._free_keyframes([int(v) for v in info[18 + Wk:18 + 2 * Wk]
                              if v >= 0])
        if self._sparsifier is not None:
            self._sparsifier.observe_window(
                [int(v) for v in info[18:18 + Wk] if v >= 0])
        if self._loop_closer is not None:
            self._loop_closer.insert_keyframe(slot)

    def _free_keyframes(self, culled: list[int]):
        """Feed culled keyframe slots to the free-list; trajectory entries
        anchored to a culled keyframe re-anchor to its temporal parent."""
        for c in culled:
            if c in self.kf_free:
                continue
            self.kf_free.append(c)
            if self._sparsifier is not None:
                self._sparsifier.forget(c)
            if c not in self.kf_order:
                continue
            i = self.kf_order.index(c)
            parent = (self.kf_order[i - 1] if i > 0 else
                      (self.kf_order[i + 1]
                       if i + 1 < len(self.kf_order) else None))
            if (parent is not None
                    and any(e.ref_kf == c for e in self.trajectory)):
                T_cp = self._kf_pose(c) @ np.linalg.inv(self._kf_pose(parent))
                for e in self.trajectory:
                    if e.ref_kf == c:
                        e.T_cr = e.T_cr @ T_cp
                        e.ref_kf = parent
            if self.ref_kf == c and parent is not None:
                self.ref_kf = parent
                self._refresh_ref_pose()
            self.kf_order.pop(i)

    def _flush_pending_info(self):
        if self._pending_kf_info is not None:
            slot, info = self._pending_kf_info
            self._pending_kf_info = None
            self._integrate_kf_info(slot, info.cpu().numpy())

    def _refresh_ref_pose(self):
        T = self._kf_pose(self.ref_kf)
        self._ref_pose_np = (T[:3, :3].astype(np.float32),
                             T[:3, 3].astype(np.float32))

    def _record(self, timestamp, lost: bool, frame_id: Optional[int] = None):
        R_ref, t_ref = self._ref_pose_np
        T_rw = np.eye(4)
        T_rw[:3, :3] = R_ref
        T_rw[:3, 3] = t_ref
        self.trajectory.append(TrajectoryEntry(
            frame_id=self.frame_id if frame_id is None else frame_id,
            timestamp=timestamp, ref_kf=self.ref_kf,
            T_cr=self.current_pose() @ np.linalg.inv(T_rw), lost=lost))
