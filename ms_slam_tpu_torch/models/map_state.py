"""Fixed-capacity structure-of-arrays map state.

Port of `ms_slam_tpu/models/map_state.py`: keyframe and map-point pools
with validity masks; the observation table obs_mp (keyframe slot, feature
slot) -> map point IS the observation graph, and covisibility is
recomputed from it on demand.

The reference's jits donate `ms` and return a new pytree. Here the
structural updates (`insert_keyframe`, `add_map_points`,
`delete_map_points`, `delete_keyframes`, `update_mp_stats`) write into the
MapState tensors IN PLACE and return the same MapState; callers that keep a
row of the state past an update clone it. Dtypes follow the reference
(int32 indices, uint32 descriptor bits carried as int32).

`map_state_from_numpy` / `map_state_to_numpy` carry a reference MapState
across as numpy arrays, field by field. The port's one field of its own,
`kp_right` (the right keypoints of an unrectified pair), is carried only by
a map that holds one, so a map without right observations keeps the
reference's fields, key for key.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.indexing import add_at_, min_at_, set_at_, to_int32_bits, top_k

I32 = torch.int32
F32 = torch.float32


class MapConfig(NamedTuple):
    """Static capacities."""

    max_kf: int = 256
    max_mp: int = 16384
    n_feat: int = 512
    local_mp_cap: int = 4096
    window_kf: int = 8
    factor_cap: int = 8192
    grid_h: int = 48
    grid_w: int = 64


class MapState(NamedTuple):
    """The whole map as one tuple of device tensors (reference layout)."""

    kf_R: torch.Tensor            # (K,3,3) world->camera rotation (Tcw)
    kf_t: torch.Tensor            # (K,3)
    kf_valid: torch.Tensor        # (K,) bool
    kf_sparsified: torch.Tensor   # (K,) bool
    kf_frame_id: torch.Tensor     # (K,) int32
    kf_ord: torch.Tensor          # (K,) int32 creation ordinal of occupant
    kf_miss: torch.Tensor         # (K,) int32
    kp_xy: torch.Tensor           # (K,N,2) float32
    kp_octave: torch.Tensor       # (K,N) int32
    kp_desc: torch.Tensor         # (K,N,8) int32 (uint32 bits)
    kp_uright: torch.Tensor       # (K,N) float32 (-1 mono)
    kp_depth: torch.Tensor        # (K,N) float32 (-1 unknown)
    kp_angle: torch.Tensor        # (K,N) float32
    kp_valid: torch.Tensor        # (K,N) bool
    obs_mp: torch.Tensor          # (K,N) int32 map-point idx or -1
    mp_pos: torch.Tensor          # (M,3) float32
    mp_desc: torch.Tensor         # (M,8) int32 (uint32 bits)
    mp_normal: torch.Tensor       # (M,3) float32
    mp_min_dist: torch.Tensor     # (M,)
    mp_max_dist: torch.Tensor     # (M,)
    mp_angle: torch.Tensor        # (M,)
    mp_valid: torch.Tensor        # (M,) bool
    mp_sparsified: torch.Tensor   # (M,) bool
    mp_first_kf: torch.Tensor     # (M,) int32 reference keyframe SLOT
    mp_first_ord: torch.Tensor    # (M,) int32 keyframe ORDINAL at creation
    mp_visible: torch.Tensor      # (M,) int32
    mp_found: torch.Tensor        # (M,) int32
    mp_quarantine: torch.Tensor   # (M,) int32
    kp_right: torch.Tensor = None
    """(K,N,3) float32 [u, v, sigma2] of the keypoint's match in the right
    image of an unrectified pair, -1 where there is none (every keypoint of
    a rectified, RGB-D or monocular keyframe)."""


def empty_map(cfg: MapConfig, device=None) -> MapState:
    K, M, N = cfg.max_kf, cfg.max_mp, cfg.n_feat

    def z(*shape, dtype=F32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return MapState(
        kf_R=torch.eye(3, dtype=F32, device=device).repeat(K, 1, 1),
        kf_t=z(K, 3), kf_valid=z(K, dtype=torch.bool),
        kf_sparsified=z(K, dtype=torch.bool), kf_frame_id=z(K, dtype=I32),
        kf_ord=z(K, dtype=I32), kf_miss=z(K, dtype=I32),
        kp_xy=z(K, N, 2), kp_octave=z(K, N, dtype=I32),
        kp_desc=z(K, N, 8, dtype=I32), kp_uright=z(K, N, fill=-1.0),
        kp_depth=z(K, N, fill=-1.0), kp_angle=z(K, N),
        kp_valid=z(K, N, dtype=torch.bool), obs_mp=z(K, N, dtype=I32, fill=-1),
        mp_pos=z(M, 3), mp_desc=z(M, 8, dtype=I32), mp_normal=z(M, 3),
        mp_min_dist=z(M), mp_max_dist=z(M, fill=1e9), mp_angle=z(M),
        mp_valid=z(M, dtype=torch.bool), mp_sparsified=z(M, dtype=torch.bool),
        mp_first_kf=z(M, dtype=I32), mp_first_ord=z(M, dtype=I32),
        mp_visible=z(M, dtype=I32), mp_found=z(M, dtype=I32),
        mp_quarantine=z(M, dtype=I32), kp_right=z(K, N, 3, fill=-1.0))


_DESC_FIELDS = ("kp_desc", "mp_desc")


def map_state_from_numpy(d: dict, device=None) -> MapState:
    """MapState from the reference's fields as numpy arrays (e.g.
    `{k: np.asarray(v) for k, v in ms._asdict().items()}`); uint32
    descriptor words keep their bits as int32."""
    out = {}
    for name in MapState._fields:
        if name == "kp_right" and name not in d:
            K, N = np.shape(d["kp_xy"])[:2]
            d = {**d, name: np.full((K, N, 3), -1.0, np.float32)}
        a = np.array(d[name])            # a private, writable copy
        if name in _DESC_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        elif a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        out[name] = torch.from_numpy(a).to(device)
    return MapState(**out)


def map_state_to_numpy(ms: MapState) -> dict:
    """Inverse of map_state_from_numpy (descriptors back to uint32);
    `kp_right` only where some keyframe holds a right observation."""
    out = {}
    for name, t in ms._asdict().items():
        a = t.detach().cpu().numpy()
        if name == "kp_right" and not (a[..., 0] >= 0).any():
            continue
        out[name] = a.view(np.uint32) if name in _DESC_FIELDS else a
    return out


# ---------------------------------------------------------------------------
# Observation-derived quantities
# ---------------------------------------------------------------------------

def _arange(n, like):
    return torch.arange(n, dtype=I32, device=like.device)


def mp_obs_count(ms: MapState) -> torch.Tensor:
    """(M,) number of keyframe observations per map point."""
    M = ms.mp_pos.shape[0]
    obs = torch.where(ms.kf_valid[:, None], ms.obs_mp, -1).reshape(-1)
    sl = torch.where(obs >= 0, obs, M)        # sentinel M dropped
    return add_at_(torch.zeros(M, dtype=I32, device=obs.device), sl, 1)


def observer_mask(ms: MapState) -> torch.Tensor:
    """(M, ceil(K/32)) int32 (uint32 bits) per-point observer bitmask: bit k
    of word w set iff keyframe slot 32w+k observes the point."""
    Mc = ms.mp_pos.shape[0]
    K, N = ms.obs_mp.shape
    Wd = (K + 31) // 32
    obs = torch.where(ms.kf_valid[:, None], ms.obs_mp, -1)
    kf_of = _arange(K, obs)[:, None].expand(K, N)
    tbl = torch.zeros((Mc + 1, Wd * 32), dtype=torch.bool, device=obs.device)
    # an idempotent OR: every write is True, so duplicates cannot disagree
    tbl[torch.where(obs >= 0, obs, Mc).reshape(-1).long(),
        kf_of.reshape(-1).long()] = True
    shifts = torch.arange(32, dtype=torch.int64, device=obs.device)
    words = (tbl[:Mc].view(Mc, Wd, 32).long() << shifts).sum(-1)
    return to_int32_bits(words)


def member_table(ids: torch.Tensor, M: int) -> torch.Tensor:
    """(M+1,) bool lookup table marking the given ids (ids < 0 dropped)."""
    tbl = torch.zeros(M + 1, dtype=torch.bool, device=ids.device)
    set_at_(tbl, torch.where(ids >= 0, ids, M), True)
    tbl[M] = False
    return tbl


def covisibility_counts(ms: MapState, q) -> torch.Tensor:
    """(K,) map points shared between keyframe q and every keyframe."""
    M = ms.mp_pos.shape[0]
    tbl = member_table(ms.obs_mp[q], M)
    obs = ms.obs_mp
    hit = tbl[obs.clamp(0, M).long()] & (obs >= 0) & ms.kf_valid[:, None]
    counts = hit.sum(1).to(I32)
    counts[q] = 0
    return counts


def covisibility_matrix(ms: MapState) -> torch.Tensor:
    """(K,K) int32 shared-observation counts between all keyframe pairs:
    entry [i, k] is the number of keyframe k's observations whose point
    keyframe i observes too (so a point that k observes twice counts twice,
    as in `covisibility_counts`); the diagonal is 0. One (K,M)@(M,K) product
    of small integers in float32, exact with TF32 off."""
    K, N = ms.obs_mp.shape
    M = ms.mp_pos.shape[0]
    obs = torch.where(ms.kf_valid[:, None], ms.obs_mp, -1)
    kf_of = _arange(K, obs)[:, None].expand(K, N)
    cnt = add_at_(torch.zeros((K, M + 1), dtype=F32, device=obs.device),
                  (kf_of, torch.where(obs >= 0, obs, M)), 1.0)[:, :M]
    c = ((cnt > 0).to(F32) @ cnt.T).to(I32)
    c.fill_diagonal_(0)
    return c


def best_covisible(ms: MapState, q, k: int, min_weight: int = 15):
    """Top-k covisible keyframes of q: (k,) idx, (k,) weight, (k,) valid."""
    w, idx = top_k(covisibility_counts(ms, q), k)
    return idx, w, w >= min_weight


def local_map_mask(ms: MapState, kf_idx: torch.Tensor,
                   kf_mask: torch.Tensor) -> torch.Tensor:
    """(M,) bool: map points observed by any keyframe in the given set."""
    M = ms.mp_pos.shape[0]
    obs = torch.where(kf_mask[:, None], ms.obs_mp[kf_idx], -1).reshape(-1)
    mask = torch.zeros(M, dtype=torch.bool, device=obs.device)
    set_at_(mask, torch.where(obs >= 0, obs, M), True)
    return mask & ms.mp_valid


def gather_local_points(ms: MapState, mask: torch.Tensor, cap: int):
    """Pack up to `cap` masked map points into a dense buffer by cumsum
    compaction. Returns (idx (cap,) int32, valid (cap,))."""
    M = mask.shape[0]
    pos = torch.cumsum(mask.to(I32), 0, dtype=I32) - 1
    tgt = torch.where(mask & (pos < cap), pos, cap)
    idx = set_at_(torch.zeros(cap, dtype=I32, device=mask.device), tgt,
                  _arange(M, mask))
    n = torch.clamp(mask.sum(), max=cap)
    valid = torch.arange(cap, device=mask.device) < n
    return idx, valid


# ---------------------------------------------------------------------------
# Structural updates (in place)
# ---------------------------------------------------------------------------

def insert_keyframe(ms: MapState, slot, R, t, xy, octave, desc, uright,
                    depth, kp_valid, obs_mp, frame_id, kf_ord=None,
                    angle=None, right=None) -> MapState:
    """Write a keyframe into pool slot `slot` (a Python int), in place.
    `right`: the right keypoints of an unrectified pair; without them the
    slot's stay -1, as every slot of a map that never has any."""
    if kf_ord is None:
        kf_ord = slot
    if angle is None:
        angle = torch.zeros_like(uright)
    ms.kp_angle[slot] = angle
    ms.kf_R[slot] = R
    ms.kf_t[slot] = t
    ms.kf_valid[slot] = True
    ms.kf_sparsified[slot] = False
    ms.kf_frame_id[slot] = frame_id
    ms.kf_ord[slot] = kf_ord
    ms.kf_miss[slot] = 0
    ms.kp_xy[slot] = xy
    ms.kp_octave[slot] = octave
    ms.kp_desc[slot] = desc
    ms.kp_uright[slot] = uright
    ms.kp_depth[slot] = depth
    ms.kp_valid[slot] = kp_valid
    ms.obs_mp[slot] = obs_mp
    if right is not None:
        ms.kp_right[slot] = right
    return ms


def alloc_map_slots(ms: MapState, new_mask: torch.Tensor):
    """Free-slot allocator: the k-th set bit of new_mask gets the k-th FREE
    pool slot (never-valid or released past quarantine). Returns (slots,
    ok); slots == M where the pool is full."""
    Mc = ms.mp_valid.shape[0]
    free = ~ms.mp_valid & (ms.mp_quarantine <= 0)
    free_rank = torch.cumsum(free.to(I32), 0, dtype=I32) - 1
    n_free = free.sum()
    tgt = torch.where(free, free_rank, Mc)
    kth_free = set_at_(torch.full((Mc,), Mc, dtype=I32, device=free.device),
                       tgt, _arange(Mc, free))
    rank = torch.cumsum(new_mask.to(I32), 0, dtype=I32) - 1
    ok = new_mask & (rank < n_free)
    slots = torch.where(ok, kth_free[rank.clamp(0, Mc - 1).long()], Mc)
    return slots.to(I32), ok


def add_map_points(ms: MapState, slots, valid, pos, desc, normal, min_dist,
                   max_dist, first_kf, first_ord=None, angle=None) -> MapState:
    """Batch-allocate map points into the given slots where valid, in
    place."""
    sl = torch.where(valid, slots, ms.mp_pos.shape[0])   # drop invalid
    if first_ord is None:
        first_ord = first_kf
    if angle is None:
        angle = torch.zeros_like(min_dist)
    set_at_(ms.mp_angle, sl, angle)
    set_at_(ms.mp_pos, sl, pos)
    set_at_(ms.mp_desc, sl, desc)
    set_at_(ms.mp_normal, sl, normal)
    set_at_(ms.mp_min_dist, sl, min_dist)
    set_at_(ms.mp_max_dist, sl, max_dist)
    set_at_(ms.mp_valid, sl, True)
    set_at_(ms.mp_sparsified, sl, False)
    set_at_(ms.mp_first_kf, sl, first_kf)
    set_at_(ms.mp_first_ord, sl, first_ord)
    set_at_(ms.mp_visible, sl, 1)
    set_at_(ms.mp_found, sl, 1)
    return ms


def refresh_mp_refs(ms: MapState) -> MapState:
    """Re-point stale point->reference-keyframe links at the point's oldest
    current valid observer (slot culled or recycled: ordinal mismatch)."""
    K, N = ms.obs_mp.shape
    Mc = ms.mp_pos.shape[0]
    ref0 = ms.mp_first_kf.clamp(0, K - 1).long()
    fresh = ms.kf_valid[ref0] & (ms.kf_ord[ref0] == ms.mp_first_ord)
    obs = torch.where(ms.kf_valid[:, None], ms.obs_mp, -1).reshape(-1)
    kf_of = _arange(K, obs)[:, None].expand(K, N).reshape(-1)
    key = ms.kf_ord[kf_of.long()] * K + kf_of
    tgt = torch.where(obs >= 0, obs, Mc)
    sentinel = torch.iinfo(torch.int32).max
    best = min_at_(torch.full((Mc,), sentinel, dtype=I32, device=obs.device),
                   tgt, key)
    fallback = torch.where(best < sentinel, best % K, ms.mp_first_kf)
    ref = torch.where(fresh, ms.mp_first_kf, fallback)
    return ms._replace(mp_first_kf=ref.to(I32))


def delete_map_points(ms: MapState, kill_mask: torch.Tensor) -> MapState:
    """SetBadFlag for a batch of points, in place: clear validity and every
    observation of them; freed slots enter a 2-step reuse quarantine."""
    obs_bad = kill_mask[ms.obs_mp.clamp(min=0).long()] & (ms.obs_mp >= 0)
    ms.mp_valid.logical_and_(~kill_mask)
    ms.mp_quarantine.masked_fill_(kill_mask, 2)
    ms.obs_mp.masked_fill_(obs_bad, -1)
    return ms


def delete_keyframes(ms: MapState, kill_mask: torch.Tensor) -> MapState:
    """KeyFrame::SetBadFlag, in place: drop the keyframes and their
    observations (their map points live on)."""
    ms.kf_valid.logical_and_(~kill_mask)
    ms.obs_mp.masked_fill_(kill_mask[:, None], -1)
    ms.kp_valid.masked_fill_(kill_mask[:, None], False)
    return ms


def update_mp_stats(ms: MapState, mp_idx, visible, found) -> MapState:
    """Increase visible/found counters, in place."""
    sl = torch.where(visible | found, mp_idx, ms.mp_pos.shape[0])
    add_at_(ms.mp_visible, sl, visible.to(I32))
    add_at_(ms.mp_found, sl, found.to(I32))
    return ms


def recompute_mp_descriptors(ms: MapState, mp_idx=None) -> MapState:
    """Distinctive descriptor (bitwise majority over all observations) and
    mean viewing direction, recomputed for every observed point (the
    reference scans the full table as well; `mp_idx` is unused there)."""
    M = ms.mp_pos.shape[0]
    obs = ms.obs_mp
    valid_obs = (obs >= 0) & ms.kf_valid[:, None]
    flat_mp = torch.where(valid_obs, obs, M).reshape(-1)
    K, N, _ = ms.kp_desc.shape
    shifts32 = torch.arange(32, dtype=I32, device=obs.device)
    bits = (ms.kp_desc.reshape(K * N, 8)[:, :, None] >> shifts32) & 1
    bits = bits.reshape(K * N, 256)
    bit_sum = add_at_(torch.zeros((M, 256), dtype=I32, device=obs.device),
                      flat_mp, bits)
    n_obs = add_at_(torch.zeros(M, dtype=I32, device=obs.device), flat_mp,
                    valid_obs.reshape(-1).to(I32))
    maj = (2 * bit_sum > n_obs[:, None]).reshape(M, 8, 32).long()
    packed = to_int32_bits((maj << shifts32.long()).sum(-1))
    new_desc = torch.where((n_obs > 0)[:, None], packed, ms.mp_desc)

    cam_centers = -torch.einsum("kij,ki->kj", ms.kf_R.transpose(1, 2),
                                ms.kf_t)
    vec = cam_centers[:, None, :] - ms.mp_pos[obs.clamp(min=0).long()]
    vec = vec / (torch.linalg.norm(vec, dim=-1, keepdim=True) + 1e-9)
    vec = torch.where(valid_obs[..., None], vec, torch.zeros_like(vec))
    nrm_sum = add_at_(torch.zeros((M, 3), dtype=ms.mp_pos.dtype,
                                  device=obs.device), flat_mp,
                      vec.reshape(K * N, 3))
    normal = nrm_sum / torch.clamp(n_obs, min=1)[:, None]
    normal = normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + 1e-9)
    new_normal = torch.where((n_obs > 0)[:, None], normal, ms.mp_normal)
    return ms._replace(mp_desc=new_desc, mp_normal=new_normal)
