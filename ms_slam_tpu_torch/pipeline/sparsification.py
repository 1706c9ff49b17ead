"""Sliding-window map sparsification stage: the MS-SLAM novelty.

Port of `ms_slam_tpu/pipeline/sparsification.py`. Keyframes that leave the
local-mapping window for `nonlocal_kf` consecutive iterations are queued;
once enough are queued, a window of them goes to the selector
(`ops/select.py`), the unselected points are deleted, the surviving
keyframes are marked sparsified with their feature slots compacted, and
they enter the keyframe database as retrieval candidates.

`sparsify_window` updates `ms` in place (the reference donates it). The
per-window counters stay on the device until `Sparsifier.stats` is read:
solving a window reads nothing back to the host.

With `MSSLAM_DUMP_WINDOWS=<dir>` every window's selection instance is
written to `<dir>/window_NNN.npz` before it is solved (the reference's
diagnostic, for offline comparison against the exact ILP): the arrays
obs_pt, obs_cell, obs_ok, cost, pt_idx, pt_valid, req and the scalars lam,
lam_grid, n_cells.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..models import map_state as M
from ..ops import select
from ..ops.indexing import set_at_, top_k
from ..utils.trace import span


class SparsifyOut(NamedTuple):
    ms: M.MapState
    n_kept: torch.Tensor
    n_killed: torch.Tensor
    n_slots_freed: torch.Tensor   # feature slots compacted away (exact)


def build_window_tables(ms: M.MapState, win_idx, win_mask, n_req: int,
                        grid_w: int, grid_h: int, img_w: int, img_h: int,
                        pt_cap: int, n_outkf: int):
    """One window's selection instance: observation rows of the window
    keyframes plus pro-rated out-of-window observers. Returns (obs_pt,
    obs_cell, obs_ok, cost, pt_idx, pt_valid, req)."""
    Mc = ms.mp_pos.shape[0]
    Kc = ms.obs_mp.shape[0]
    n_cells = grid_w * grid_h
    dev = ms.obs_mp.device
    wi = win_idx.long()
    # culled keyframes may still sit in the host queue; drop them here
    win_mask = win_mask & ms.kf_valid[wi]

    # dense point set of the window
    pmask = M.local_map_mask(ms, win_idx, win_mask)
    pt_idx, pt_valid = M.gather_local_points(ms, pmask, pt_cap)
    # slot Mc takes the padding writes (in range, so they land there)
    inv = set_at_(torch.full((Mc + 1,), -1, dtype=torch.int32, device=dev),
                  torch.where(pt_valid, pt_idx, Mc),
                  torch.arange(pt_cap, dtype=torch.int32, device=dev))

    def dense(obs):
        return inv[obs.clamp(0, Mc).long()]

    # window observation rows
    obs_w = ms.obs_mp[wi]                                        # (Ws,N)
    pt_w = dense(obs_w)
    ok_w = (obs_w >= 0) & (pt_w >= 0) & win_mask[:, None]
    xy = ms.kp_xy[wi]
    cx = torch.clamp((xy[..., 0] * grid_w / img_w).to(torch.int32),
                     0, grid_w - 1)
    cy = torch.clamp((xy[..., 1] * grid_h / img_h).to(torch.int32),
                     0, grid_h - 1)
    cell_w = cy * grid_w + cx

    # out-of-window observers of window points (pro-rated coverage)
    in_win = set_at_(torch.zeros(Kc, dtype=torch.bool, device=dev),
                     torch.where(win_mask, win_idx, Kc), True)
    sees_win = (ms.obs_mp >= 0) & (dense(ms.obs_mp) >= 0)
    votes = (sees_win.sum(1) * ms.kf_valid * ~in_win).to(torch.int32)
    votes_out, out_idx = top_k(votes, n_outkf)
    out_mask = votes_out > 0
    obs_o = ms.obs_mp[out_idx]
    pt_o = dense(obs_o)
    ok_o = (obs_o >= 0) & (pt_o >= 0) & out_mask[:, None]
    n_total_o = (obs_o >= 0).sum(1).to(torch.int32)
    ratio = votes_out / torch.clamp(n_total_o, min=1)
    req_o = torch.ceil(ratio * n_req).to(torch.int32) * out_mask
    cell_o = torch.full_like(obs_o, n_cells)     # no grid constraint

    obs_pt = torch.cat([pt_w, pt_o], 0)
    obs_cell = torch.cat([cell_w, cell_o], 0)
    obs_ok = torch.cat([ok_w, ok_o], 0)
    req = torch.cat([torch.where(win_mask, n_req, 0).to(torch.int32), req_o])

    # cost = maxObs - obs(p) over the window's point set
    n_obs_all = M.mp_obs_count(ms)
    obs_count = torch.where(pt_valid, n_obs_all[pt_idx.long()], 0)
    cost = (obs_count.max() - obs_count).to(torch.float32)
    return obs_pt, obs_cell, obs_ok, cost, pt_idx, pt_valid, req


def sparsify_window(ms: M.MapState, win_idx, win_mask, n_req: int,
                    lam: float, lam_grid: float, grid_w: int, grid_h: int,
                    img_w: int, img_h: int, pt_cap: int,
                    n_outkf: int) -> SparsifyOut:
    """Run the selector over one keyframe window and apply the result in
    place: delete unselected points, mark the kept ones and the window
    keyframes sparsified, compact the window keyframes' feature slots."""
    Mc = ms.mp_pos.shape[0]
    Kc = ms.obs_mp.shape[0]
    wi = win_idx.long()
    win_mask = win_mask & ms.kf_valid[wi]
    (obs_pt, obs_cell, obs_ok, cost, pt_idx, pt_valid,
     req) = build_window_tables(ms, win_idx, win_mask, n_req, grid_w, grid_h,
                                img_w, img_h, pt_cap, n_outkf)
    res = select.select_points(obs_pt, obs_cell, obs_ok, cost, pt_valid,
                               req, lam=lam, lam_grid=lam_grid,
                               n_cells=grid_w * grid_h)

    kept = pt_valid & res.keep
    kill = set_at_(torch.zeros(Mc, dtype=torch.bool, device=pt_idx.device),
                   torch.where(pt_valid & ~res.keep, pt_idx, Mc), True)
    ms = M.delete_map_points(ms, kill)
    set_at_(ms.mp_sparsified, torch.where(kept, pt_idx, Mc), True)

    # mark + compact the window keyframes (EraseBadDescriptor analog: only
    # surviving observations keep live feature slots)
    wslots = torch.where(win_mask, win_idx, Kc)
    set_at_(ms.kf_sparsified, wslots, True)
    old_kp_valid = ms.kp_valid[wi] & win_mask[:, None]
    new_kp_valid = ms.kp_valid[wi] & (ms.obs_mp[wi] >= 0)
    n_slots_freed = (old_kp_valid
                     & ~(new_kp_valid & win_mask[:, None])).sum()
    set_at_(ms.kp_valid, wslots, new_kp_valid)
    return SparsifyOut(ms=ms, n_kept=kept.sum().to(torch.int32),
                       n_killed=kill.sum().to(torch.int32),
                       n_slots_freed=n_slots_freed.to(torch.int32))


class Sparsifier:
    """Host-side stage state (the MapSparsification 'thread')."""

    def __init__(self, system):
        self.sys = system
        cfg = system.cfg
        self.nonlocal_kf = cfg.nonlocal_kf
        self.window = cfg.sparsify_window
        self.queue_min = cfg.sparsify_queue_min
        self.n_req = cfg.sparsify_n
        self.lam = cfg.sparsify_lambda
        self.lam_grid = cfg.sparsify_grid_lambda
        self.miss: dict[int, int] = {}
        self.queue: list[int] = []
        self.done: set[int] = set()
        self._pending_counts: list[torch.Tensor] = []
        self._stats = {"windows": 0, "killed": 0, "kept": 0,
                       "slots_freed": 0}

    @property
    def stats(self) -> dict:
        """Counters; adds in the window counts still on the device."""
        while self._pending_counts:
            nk, nkept, nsl = self._pending_counts.pop(0).tolist()
            self._stats["killed"] += nk
            self._stats["kept"] += nkept
            self._stats["slots_freed"] += nsl
        return self._stats

    def forget(self, slot: int):
        """Drop bookkeeping for a culled/recycled keyframe slot."""
        self.done.discard(slot)
        self.miss.pop(slot, None)
        if slot in self.queue:
            self.queue.remove(slot)

    def observe_window(self, window_slots: list[int]):
        """Called after each local-mapping iteration with the BA window:
        consecutive misses make a keyframe non-local and queue it (ref
        KeyFrame::UpdateCountInLocalMapping)."""
        win = set(window_slots)
        free = set(self.sys.kf_free)
        for k in range(self.sys.n_kf):
            if k in self.done or k in self.queue or k in free:
                continue
            if k in win:
                self.miss[k] = 0
            else:
                self.miss[k] = self.miss.get(k, 0) + 1
                if self.miss[k] >= self.nonlocal_kf:
                    self.queue.append(k)
        self.maybe_sparsify()

    def inertial_ready(self) -> bool:
        """Inertial gate (ref MapSparsification::CheckNewKeyFrames): in IMU
        mode no window is solved before the inertial BA2 stage."""
        sys = self.sys
        if not getattr(sys.cfg, "use_imu", False):
            return True
        return (getattr(sys, "imu_initialized", False)
                and getattr(sys, "_imu_stage", 0) >= 2)

    def maybe_sparsify(self, force: bool = False):
        if not force and not self.inertial_ready():
            return
        while len(self.queue) >= (1 if force else self.queue_min):
            batch = self.queue[:self.window]
            if not batch:
                break
            self.queue = self.queue[len(batch):]
            self._sparsify(batch)
            if not force:
                break

    def _sparsify(self, batch: list[int]):
        sys = self.sys
        dev = sys.device
        win_idx = np.zeros(self.window, np.int32)
        win_mask = np.zeros(self.window, bool)
        win_idx[:len(batch)] = batch
        win_mask[:len(batch)] = True
        dump_dir = os.environ.get("MSSLAM_DUMP_WINDOWS")
        if dump_dir:
            self._dump_window(dump_dir, win_idx, win_mask)
        # (a host stand-in made in a test may carry no timing)
        with span(getattr(sys, "timing", None), "sparsify_window"):
            out = sparsify_window(
                sys.ms, torch.from_numpy(win_idx).to(dev),
                torch.from_numpy(win_mask).to(dev), self.n_req, self.lam,
                self.lam_grid, grid_w=sys.cfg.map.grid_w,
                grid_h=sys.cfg.map.grid_h, img_w=sys.calib.width,
                img_h=sys.calib.height, pt_cap=sys.cfg.map.local_mp_cap * 2,
                n_outkf=8)
        sys.ms = out.ms
        sys._obs_dirty = True
        self.done.update(batch)
        self._stats["windows"] += 1
        self._pending_counts.append(torch.stack(
            [out.n_killed, out.n_kept, out.n_slots_freed]))
        # sparsified keyframes enter the place-recognition database (ref
        # LoopClosing::DeleteOutdatedInfo -> KeyFrameDatabase::add)
        if sys.kf_db is not None:
            for k in batch:
                sys.kf_db.add(k, sys.ms.kp_desc[k], sys.ms.kp_valid[k])

    def _dump_window(self, dump_dir: str, win_idx, win_mask):
        """Write the selection instance this window is about to solve."""
        sys = self.sys
        dev = sys.device
        tabs = build_window_tables(
            sys.ms, torch.from_numpy(win_idx).to(dev),
            torch.from_numpy(win_mask).to(dev), self.n_req,
            grid_w=sys.cfg.map.grid_w, grid_h=sys.cfg.map.grid_h,
            img_w=sys.calib.width, img_h=sys.calib.height,
            pt_cap=sys.cfg.map.local_mp_cap * 2, n_outkf=8)
        names = ("obs_pt", "obs_cell", "obs_ok", "cost", "pt_idx",
                 "pt_valid", "req")
        os.makedirs(dump_dir, exist_ok=True)
        np.savez(os.path.join(
            dump_dir, f"window_{self._stats['windows']:03d}.npz"),
            **{k: torch.as_tensor(v).cpu().numpy()
               for k, v in zip(names, tabs)},
            lam=self.lam, lam_grid=self.lam_grid,
            n_cells=sys.cfg.map.grid_w * sys.cfg.map.grid_h)

    def finish(self):
        """Sparsify everything left (ref MapSparsification.cc:38-52 on
        RequestFinish)."""
        free = set(self.sys.kf_free)
        for k in range(self.sys.n_kf):
            if k not in self.done and k not in self.queue and k not in free:
                self.queue.append(k)
        self.maybe_sparsify(force=True)
