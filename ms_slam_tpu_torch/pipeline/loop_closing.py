"""Loop closing stage: place recognition against the sparsified keyframes
only, geometric verification, loop correction, essential-graph optimization
and Atlas map merge.

Port of `ms_slam_tpu/pipeline/loop_closing.py` (host orchestration after
LoopClosing::Run): sparsified keyframes are the only retrieval candidates of
the BoW database; per new keyframe, candidates come from the database, are
verified by descriptor matching + RANSAC alignment + Sim3-guided harvest +
Gauss-Newton refinement (`ops/sim3.py`), and a loop is confirmed after 3
consecutive verified keyframes. The correction rigidly moves the current
covisible window and its points, fuses duplicates, optimizes the essential
graph (`ops/pose_graph.py`) with the matched keyframe fixed, re-anchors
every map point by its reference keyframe's pose change and runs the
global BA: the alternating one, or the one sharded over a mesh of devices
(`parallel/dist_ba.py`) when `SystemConfig.dist_ba_devices` asks for it and
the System's device offers that many.

What differs from the reference, by need:

- RANSAC draws come from the LoopCloser's own `torch.Generator` (seed 7, on
  the System's device); `_verify_pair` and `detect_and_verify` also take the
  index tables themselves, so a test can give both packages the same draws.
- `detect_and_verify` fetches the k candidates' "worth verifying" flags once
  and verifies only those in a host loop (the reference's `lax.cond`).
- A dispatched result is copied to pinned host memory without blocking and
  read at the next keyframe or `flush()`, behind a CUDA event.
- The LoopCloser's constructor optimizes a two-pose graph once, so that
  the seconds `torch.func` takes on its first use in a process are not
  spent inside the frame that closes the first loop.
- Edge tables are built at their exact length (the reference pads them to a
  power of two to keep compiled shapes; padding edges have weight 0).
- With the IMU's gravity observed (inertial stage 2) a correction must pass
  the yaw-only gate, the essential graph is the 4-DoF one (yaw about the
  gravity axis and translation) and `System._full_inertial_ba` follows the
  global BA.

`LoopCloser._hyp`, `System.kf_order`, `System.kf_maps` and
`System.active_map` are plain Python/numpy values in both packages, so a
state can be set on both `System`s alike.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import map_state as M
from ..models.vocab import KeyFrameDatabase, tfidf_scores
from ..ops import lie, matching, pose_graph, sim3
from ..ops.indexing import set_at_, top_k
from ..parallel import dist_ba
from ..utils.trace import span, sync
from . import mapping_ops as mo
from .frontend import Calib

MIN_RANSAC_INLIERS = 20
CONSECUTIVE_NEEDED = 3
# essential-graph extra-edge covisibility threshold (ref minFeat=100,
# calibrated for 2000-feature frames; SystemConfig.loop_covis_min scales it
# for smaller feature budgets)
COVIS_EDGE_MIN = 100
# inertial yaw-only loop gating: once gravity is observed a valid loop
# correction can only be yaw drift about gravity + translation
# (ref LoopClosing.cc:243-256: |pitch|,|roll| < 0.008 rad, |yaw| < 0.349)
INERTIAL_PITCHROLL_TOL = 0.008
INERTIAL_YAW_TOL = 0.349
N_HYP = 128

F32 = torch.float32
I32 = torch.int32


def _verify_pair(ms: M.MapState, calib: Calib, kf_a: int, kf_b,
                 generator: torch.Generator = None, with_scale: bool = False,
                 idx: torch.Tensor = None):
    """Descriptor-match two keyframes, RANSAC-align their shared landmark
    geometry, then run the full verification cascade: Sim3-guided projection
    search in BOTH directions to harvest matches beyond the mutual-descriptor
    set and an iterative Sim3 Gauss-Newton refinement (th2 = 10). Returns
    (n_inliers, s, R, t) with (s, R, t) mapping keyframe-b camera coords
    into keyframe-a camera coords (scale free for monocular maps).

    The (N_HYP, 3) RANSAC index table is drawn from `generator`, or given as
    `idx`."""
    dev = ms.kf_R.device
    params = calib.params_array(dev)
    va = ms.kp_valid[kf_a] & (ms.obs_mp[kf_a] >= 0)
    vb = ms.kp_valid[kf_b] & (ms.obs_mp[kf_b] >= 0)
    mm = matching.mutual_match(ms.kp_desc[kf_a], va, ms.kp_desc[kf_b], vb,
                               max_dist=matching.TH_LOW, nn_ratio=0.75,
                               angle_a=ms.kp_angle[kf_a],
                               angle_b=ms.kp_angle[kf_b])
    has = mm.idx_b >= 0
    ib = mm.idx_b.clamp(min=0).long()
    mp_a = ms.obs_mp[kf_a]
    mp_b = ms.obs_mp[kf_b][ib]
    ok = has & (mp_a >= 0) & (mp_b >= 0)
    # per-feature landmark coords in each keyframe's camera frame
    Xa = ms.mp_pos[mp_a.clamp(min=0).long()]
    Xb_all = ms.mp_pos[ms.obs_mp[kf_b].clamp(min=0).long()]
    Xc_a_all = lie.se3_apply(ms.kf_R[kf_a], ms.kf_t[kf_a], Xa)
    Xc_b_all = lie.se3_apply(ms.kf_R[kf_b], ms.kf_t[kf_b], Xb_all)
    s2a = (1.2 ** ms.kp_octave[kf_a].to(F32)) ** 2
    s2b_all = (1.2 ** ms.kp_octave[kf_b].to(F32)) ** 2
    if idx is None:
        idx = sim3.draw_hypotheses(ok, N_HYP, generator)
    res = sim3.sim3_from_hypotheses(calib.model, params, Xc_a_all,
                                    Xc_b_all[ib], s2a, s2b_all[ib], ok, idx,
                                    with_scale=with_scale)

    # Sim3-guided projection harvest, both directions + agreement
    w_img, h_img = float(calib.width), float(calib.height)
    g_b2a = sim3.sim3_guided_match(
        calib.model, params, res.s, res.R, res.t, Xc_b_all, vb,
        ms.kp_desc[kf_b], ms.kp_xy[kf_a], ms.kp_octave[kf_a],
        ms.kp_desc[kf_a], va, w_img, h_img)
    si, Ri, ti = lie.sim3_inv(res.s, res.R, res.t)
    g_a2b = sim3.sim3_guided_match(
        calib.model, params, si, Ri, ti, Xc_a_all, va, ms.kp_desc[kf_a],
        ms.kp_xy[kf_b], ms.kp_octave[kf_b], ms.kp_desc[kf_b], vb,
        w_img, h_img)
    Na = va.shape[0]
    Nb = vb.shape[0]
    arange_b = torch.arange(Nb, dtype=I32, device=dev)
    agree = (g_b2a >= 0) & (g_a2b[g_b2a.clamp(min=0).long()] == arange_b)
    # several b features may agree on one a feature: the last one wins
    guided_j = set_at_(torch.full((Na + 1,), -1, dtype=I32, device=dev),
                       torch.where(agree, g_b2a, Na), arange_b)[:Na]
    # union: mutual matches take precedence, guided fills the rest
    j_comb = torch.where(ok, mm.idx_b, guided_j)
    corr = j_comb >= 0
    jc = j_comb.clamp(min=0).long()

    # iterative Sim3 refinement on the combined set (OptimizeSim3)
    ref = sim3.sim3_refine(
        calib.model, params, Xc_a_all, Xc_b_all[jc], ms.kp_xy[kf_a],
        ms.kp_xy[kf_b][jc], s2a, s2b_all[jc], corr, res.s, res.R, res.t,
        with_scale=with_scale, n_iters=10)
    # fall back to the RANSAC estimate if refinement diverged
    better = ref.n_inliers >= res.n_inliers
    return (torch.maximum(ref.n_inliers, res.n_inliers),
            torch.where(better, ref.s, res.s),
            torch.where(better, ref.R, res.R),
            torch.where(better, ref.t, res.t))


def detect_and_verify(ms: M.MapState, calib: Calib, slot: int, present,
                      has_row, rows, generator: torch.Generator,
                      min_score: float, with_scale: bool, k_cands: int = 3,
                      idx_tables=None, *, timing=None):
    """The per-keyframe place-recognition step (ref
    LoopClosing::NewDetectCommonRegions + DetectNBestCandidates): tf-idf BoW
    scoring over the sparsified database with the query keyframe's own
    stored row, covisibility exclusion, top-k candidates, and geometric
    verification of each candidate above the adaptive score floor (the
    lowest similarity to a covisible keyframe, times 0.75).

    present/has_row: (K,) bool tensors; idx_tables: optional (k, N_HYP, 3)
    RANSAC index tables, one per candidate rank (drawn from `generator`
    when None). Returns (packed (k,16), group (K,)): per candidate
    [cand_slot, score, n_inl, s, t(3), R(9)], a candidate under the floor
    giving (0, 1, 0, I); group = covisibility mask of the best verified
    candidate. timing: a `Timing` (utils/trace.py) for the candidates'
    fetch, or None."""
    dev = ms.kf_R.device
    K = ms.kf_valid.shape[0]
    covis = M.covisibility_counts(ms, slot)
    not_self = torch.arange(K, device=dev) != slot
    mask = present & ms.kf_valid & (covis == 0) & not_self & has_row
    # score everything once; covisible neighbours give the adaptive floor
    all_mask = ms.kf_valid & not_self & has_row
    scores_all = tfidf_scores(rows, present, rows[slot])
    scores_all = torch.where(all_mask, scores_all, -1.0)
    nb_mask = all_mask & (covis > 0)
    inf = torch.full_like(scores_all, float("inf"))
    nb_min = torch.min(torch.where(nb_mask, scores_all, inf))
    floor = torch.full_like(nb_min, min_score)
    thr = torch.maximum(floor, torch.where(torch.isfinite(nb_min),
                                           0.75 * nb_min, floor))
    top_s, top_i = top_k(torch.where(mask, scores_all, -inf), k_cands)
    with sync(timing, "loop_candidates"):
        # sync: one fetch of k flags and slots decides which candidates get
        # the verification cascade
        worth = (top_s > thr).cpu().numpy()
        cands = top_i.cpu().numpy()

    rows_out = []
    for i in range(k_cands):
        if worth[i]:
            n_inl, s, R, t = _verify_pair(
                ms, calib, slot, int(cands[i]), generator,
                with_scale=with_scale,
                idx=None if idx_tables is None else idx_tables[i])
        else:
            n_inl = torch.zeros((), dtype=I32, device=dev)
            s = torch.ones((), dtype=F32, device=dev)
            R = torch.eye(3, dtype=F32, device=dev)
            t = torch.zeros(3, dtype=F32, device=dev)
        rows_out.append(torch.cat([
            torch.stack([top_i[i].to(F32), top_s[i], n_inl.to(F32), s]),
            t, R.reshape(9)]))
    packed = torch.stack(rows_out)
    best = top_i[torch.argmax(packed[:, 2])]
    group = M.covisibility_counts(ms, best) > 0
    group[best] = True
    return packed, group


def refine_hypothesis(ms: M.MapState, calib: Calib, cur: int, match: int,
                      last_cur: int, s_lw, R_lw, t_lw, with_scale: bool,
                      pt_cap: int):
    """Temporal loop-hypothesis refinement (ref
    LoopClosing::DetectAndReffineSim3FromLastKF): once a candidate verified,
    the NEXT keyframe transports the held Sim3 S_lw (world -> last-current
    camera) through the odometry increment, S_cw = T_c_lc * S_lw, and
    re-verifies against the SAME matched keyframe instead of querying the
    database again:

      1. project the matched keyframe's covisible-window landmark pool into
         the current keyframe under S_cw and harvest descriptor matches;
      2. refine S_cw on the harvested set (10 iterations);
      3. harvest again under the refined transform.

    Returns packed (16,): [n_proj, n_opt_inliers, n_reharvest, s, t(3),
    R(9)]; the host applies the 30/50/100 acceptance ladder scaled to the
    feature budget."""
    dev = ms.kf_R.device
    params = calib.params_array(dev)
    K = ms.kf_valid.shape[0]
    # transported hypothesis: S_cw = T_cw_est * T_lw_est^-1 * S_lw
    R_c, t_c = ms.kf_R[cur], ms.kf_t[cur]
    R_l, t_l = ms.kf_R[last_cur], ms.kf_t[last_cur]
    R_cl = R_c @ R_l.T
    t_cl = t_c - R_cl @ t_l
    R_cw = R_cl @ R_lw
    t_cw = R_cl @ t_lw + t_cl
    s_cw = s_lw

    # matched-side landmark pool: the matched keyframe's covisible window
    msel = M.covisibility_counts(ms, match) > 0
    msel[match] = True
    pmask = M.local_map_mask(ms, torch.arange(K, device=dev), msel)
    pt_idx, pt_valid = M.gather_local_points(ms, pmask, pt_cap)
    Xw = ms.mp_pos[pt_idx.long()]
    desc_m = ms.mp_desc[pt_idx.long()]

    xy_c = ms.kp_xy[cur]
    oct_c = ms.kp_octave[cur]
    desc_c = ms.kp_desc[cur]
    va = ms.kp_valid[cur]
    Nc = va.shape[0]

    def harvest(s, R, t):
        g = sim3.sim3_guided_match(calib.model, params, s, R, t, Xw,
                                   pt_valid, desc_m, xy_c, oct_c, desc_c,
                                   va, float(calib.width),
                                   float(calib.height))
        # count distinct matched current-keyframe features
        hit = set_at_(torch.zeros(Nc + 1, dtype=torch.bool, device=dev),
                      torch.where(g >= 0, g, Nc), True)[:Nc]
        return g, hit.sum()

    g1, n1 = harvest(s_cw, R_cw, t_cw)
    gc = g1.clamp(min=0).long()
    sigma2 = (1.2 ** oct_c[gc].to(F32)) ** 2
    ref = sim3.sim3_refine_world(
        calib.model, params, Xw, xy_c[gc], sigma2, g1 >= 0, s_cw, R_cw, t_cw,
        with_scale=with_scale, n_iters=10)
    _, n2 = harvest(ref.s, ref.R, ref.t)
    return torch.cat([
        torch.stack([n1.to(F32), ref.n_inliers.to(F32), n2.to(F32), ref.s]),
        ref.t, ref.R.reshape(9)])


def _apply_window_correction(ms: M.MapState, win_mask_k, sc, Rc, tc,
                             cur: int) -> M.MapState:
    """Similarity-move the keyframes in win_mask_k and their points:
    S_new_i = T_old_i * T_old_cur^-1 * S_corr_cur (relative poses to the
    current keyframe preserved), stored as SE(3) with t/s; points
    X' = S_corr^-1 * T_old_cur * X. sc = 1 for stereo."""
    R_cur, t_cur = ms.kf_R[cur], ms.kf_t[cur]
    Ri, ti = lie.se3_inv(R_cur, t_cur)
    # delta = T_old_cur^-1 * S_corr (a sim3 with scale sc)
    Rd = Ri @ Rc
    td = Ri @ tc + ti
    R_new = ms.kf_R @ Rd
    t_new = (ms.kf_R @ td + ms.kf_t) / sc
    kf_R = torch.where(win_mask_k[:, None, None], R_new, ms.kf_R)
    kf_t = torch.where(win_mask_k[:, None], t_new, ms.kf_t)

    # world-side correction of the points the window observes
    K = ms.kf_valid.shape[0]
    pmask = M.local_map_mask(ms, torch.arange(K, device=Rc.device),
                             win_mask_k)
    sci, Rci, tci = lie.sim3_inv(sc, Rc, tc)
    sw, Rw, tw = lie.sim3_compose(sci, Rci, tci, torch.ones_like(sc), R_cur,
                                  t_cur)
    moved = lie.sim3_apply(sw, Rw, tw, ms.mp_pos)
    mp_pos = torch.where(pmask[:, None], moved, ms.mp_pos)
    return ms._replace(kf_R=kf_R, kf_t=kf_t, mp_pos=mp_pos)


def _ref_kf(ms: M.MapState):
    return ms.mp_first_kf.clamp(0, ms.kf_valid.shape[0] - 1).long()


def _apply_sim3_graph(ms: M.MapState, old_R, old_t, s_new, R_new,
                      t_new) -> M.MapState:
    """Write back a 7-DoF essential-graph result: keyframe poses stored as
    SE(3) with t/s, points moved by their reference keyframe's Sim(3)
    change X' = S_new^-1 (T_old X)."""
    ref = _ref_kf(ms)
    X_cam = lie.se3_apply(old_R[ref], old_t[ref], ms.mp_pos)
    si, Ri, ti = lie.sim3_inv(s_new[ref], R_new[ref], t_new[ref])
    X_n = lie.sim3_apply(si, Ri, ti, X_cam)
    ok = ms.mp_valid & ms.kf_valid[ref]
    return ms._replace(kf_R=R_new, kf_t=t_new / s_new[:, None],
                       mp_pos=torch.where(ok[:, None], X_n, ms.mp_pos))


def _reanchor_points(ms: M.MapState, old_R, old_t) -> M.MapState:
    """After pose-graph optimization, move every point by its reference
    keyframe's pose change: X' = T_new_ref^-1 * T_old_ref * X."""
    ref = _ref_kf(ms)
    Rni, tni = lie.se3_inv(ms.kf_R[ref], ms.kf_t[ref])
    X_cam = lie.se3_apply(old_R[ref], old_t[ref], ms.mp_pos)
    X_new = lie.se3_apply(Rni, tni, X_cam)
    ok = ms.mp_valid & ms.kf_valid[ref]
    return ms._replace(mp_pos=torch.where(ok[:, None], X_new, ms.mp_pos))


class _Deferred:
    """A device result on its way to the host: copied into pinned memory
    without blocking, read behind a CUDA event (on the CPU it is the tensor
    itself)."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()     # sync: the deferred fetch lands
        return self.host.numpy()


class LoopCloser:
    """Host-side stage state (the LoopClosing 'thread')."""

    def __init__(self, system, n_words: int = 2048):
        self.sys = system
        # monocular maps drift in scale: Sim(3) verification and the 7-DoF
        # essential graph
        self.mono = (system.calib.bf or 0.0) <= 0.0
        # the sparsified-keyframe database is shared System state
        # (relocalization reads it too); a standalone one exists only for
        # direct construction in tests
        self.db = system.kf_db if system.kf_db is not None else \
            KeyFrameDatabase(n_words=n_words, max_kf=system.cfg.map.max_kf,
                             device=system.device)
        self.gen = torch.Generator(device=system.device)
        self.gen.manual_seed(7)
        self.stats = {"queries": 0, "verified": 0, "loops": 0, "refines": 0}
        self.loop_edges: list[tuple[int, int]] = []
        # active place hypothesis: matched keyframe, the keyframe the held
        # Sim3 is anchored to, S_lw = (s, R, t) world -> last-current
        # camera, and the coincidence / not-found counters
        self._hyp: dict | None = None
        # acceptance ladder of the hypothesis refinement (ref 30/50/100 at
        # 2000 features) scaled to the feature budget
        f = system.cfg.orb.n_features / 2000.0
        self.th_proj = max(int(round(30 * f)), 10)
        self.th_opt = max(int(round(50 * f)), 14)
        self.th_rep = max(int(round(100 * f)), 22)
        self._pending = None
        self._ba_mesh = None            # the sharded global BA's, once built
        # the pose graph differentiates through torch.func, whose first use
        # in a process takes seconds on the host (8.4 s measured beside an
        # H100): pay that here, on a two-pose graph, not inside the frame
        # that closes the first loop
        dev = system.device
        two = torch.zeros(2, dtype=torch.long, device=dev)
        pose_graph.optimize_pose_graph(
            torch.eye(3, device=dev).repeat(2, 1, 1),
            torch.zeros((2, 3), device=dev),
            torch.tensor([True, False], device=dev), two + 1, two,
            torch.eye(3, device=dev).repeat(2, 1, 1),
            torch.zeros((2, 3), device=dev), torch.ones(2, device=dev),
            torch.ones(2, dtype=torch.bool, device=dev), n_iters=1)

    # -- detection per new keyframe -------------------------------------
    # (the database is fed by Sparsifier through System.kf_db.add)

    def insert_keyframe(self, slot: int):
        """Dispatch this keyframe's place-recognition work; the result is
        read at the next keyframe (or flush), so the camera-rate path never
        waits for it.

        With an active hypothesis the dispatch is a REFINEMENT against the
        held matched keyframe; otherwise it is the tf-idf database query +
        Sim3 verification."""
        self.flush()                    # integrate the previous dispatch
        if self._pending is not None:   # refine-failure fallback query
            self.flush()
        sys = self.sys
        h = self._hyp
        if h is not None:
            if h["match"] in sys.kf_order and h["last_cur"] in sys.kf_order:
                self.stats["refines"] += 1
                s0, R0, t0 = h["S_lw"]
                dev = sys.device
                with span(sys.timing, "loop_refine"):
                    packed = refine_hypothesis(
                        sys.ms, sys.calib, slot, h["match"], h["last_cur"],
                        torch.as_tensor(s0, dtype=F32, device=dev),
                        torch.as_tensor(np.asarray(R0), dtype=F32,
                                        device=dev),
                        torch.as_tensor(np.asarray(t0), dtype=F32,
                                        device=dev),
                        with_scale=self.mono,
                        pt_cap=sys.cfg.map.local_mp_cap)
                self._pending = ("refine", slot, _Deferred(packed))
                return
            self._hyp = None            # an endpoint was culled: drop it
        self._dispatch_query(slot)

    def _dispatch_query(self, slot: int):
        sys = self.sys
        if not self.db.present.any():
            return
        if not self.db._trained:
            self.db._train_now()
        self.stats["queries"] += 1
        dev = sys.device
        with span(sys.timing, "loop_query"):
            packed, _ = detect_and_verify(
                sys.ms, sys.calib, slot,
                torch.from_numpy(self.db.present).to(dev),
                torch.from_numpy(self.db.has_row).to(dev), self.db.rows,
                self.gen, 0.05, with_scale=self.mono, timing=sys.timing)
        self._pending = ("query", slot, _Deferred(packed))

    def flush(self):
        """Complete a dispatched detection (one deferred fetch)."""
        if self._pending is None:
            return
        if self._pending[0] == "refine":
            self._flush_refine()
        else:
            self._flush_query()

    def _kf_pose_np(self, k: int):
        ms = self.sys.ms
        with sync(self.sys.timing, "loop_pose"):
            # sync: one small fetch
            pk = torch.cat([ms.kf_R[k].reshape(9), ms.kf_t[k]]).cpu().numpy()
        return pk[:9].reshape(3, 3), pk[9:]

    def _flush_query(self):
        _, slot, packed = self._pending
        self._pending = None
        with sync(self.sys.timing, "loop_fetch"):
            packed = packed.get()
        row = packed[int(np.argmax(packed[:, 2]))]
        c, n_inl = int(row[0]), int(row[2])
        if n_inl < MIN_RANSAC_INLIERS or c not in self.sys.kf_order \
                or slot not in self.sys.kf_order:
            return
        self.stats["verified"] += 1
        s_cm = float(row[3])
        R_cm = row[7:16].reshape(3, 3)
        t_cm = row[4:7]
        # anchor the hypothesis in world coords: S_cw = S_cm * T_mw
        Rm, tm = self._kf_pose_np(c)
        R_cw = R_cm @ Rm
        t_cw = s_cm * (R_cm @ tm) + t_cm
        self._hyp = {"match": c, "last_cur": slot,
                     "S_lw": (s_cm, R_cw, t_cw),
                     "n_coin": 1, "n_notfound": 0}
        if CONSECUTIVE_NEEDED <= 1:
            self._confirm(slot)

    def _flush_refine(self):
        _, slot, packed = self._pending
        self._pending = None
        with sync(self.sys.timing, "loop_fetch"):
            p = packed.get()
        n_proj, n_opt, n_rep = int(p[0]), int(p[1]), int(p[2])
        h = self._hyp
        if h is None or slot not in self.sys.kf_order:
            return
        ok = (n_proj >= self.th_proj and n_opt > self.th_opt
              and n_rep >= self.th_rep)
        if ok:
            h["n_coin"] += 1
            h["n_notfound"] = 0
            h["last_cur"] = slot
            h["S_lw"] = (float(p[3]), p[7:16].reshape(3, 3).copy(),
                         p[4:7].copy())
            self.stats["verified"] += 1
            if h["n_coin"] >= CONSECUTIVE_NEEDED:
                self._confirm(slot)
        else:
            # two consecutive refinement misses drop the hypothesis; either
            # way a database query is dispatched in the same call, and the
            # caller's flush integrates it
            h["n_notfound"] += 1
            if h["n_notfound"] >= 2:
                self._hyp = None
            self._dispatch_query(slot)

    def _confirm(self, slot: int):
        h = self._hyp
        self._hyp = None
        match = h["match"]
        if slot not in self.sys.kf_order or match not in self.sys.kf_order:
            return
        # back to relative form for the correction: S_cm = S_cw * T_wm
        s_cw, R_cw, t_cw = h["S_lw"]
        Rm, tm = self._kf_pose_np(match)
        R_cm = R_cw @ Rm.T
        t_cm = t_cw - s_cw * (R_cm @ tm)
        if self.sys.kf_maps[match] != self.sys.kf_maps[slot]:
            # cross-map merges get the gravity-consistency gate too, widened
            # 2x: merge hypotheses span maps whose relative tilt is less
            # refined
            if self._inertial_gate_ok(slot, match, R_cm, tol_scale=2.0):
                self._merge_maps(slot, match, s_cw, R_cm, t_cm)
        elif self._inertial_gate_ok(slot, match, R_cm):
            self._correct_loop(slot, match, s_cw, R_cm, t_cm)

    def _inertial_ready(self) -> bool:
        sys = self.sys
        return bool(getattr(sys.cfg, "use_imu", False)
                    and getattr(sys, "imu_initialized", False)
                    and getattr(sys, "_imu_stage", 0) >= 2)

    def _inertial_gate_ok(self, cur: int, match: int, R_cm,
                          tol_scale: float = 1.0) -> bool:
        """Yaw-only loop gating in inertial mode (ref LoopClosing.cc:243-256):
        gravity is observable once VIBA2 has run, so the world-frame rotation
        of the correction, R_old_wc(cur) @ R_new_cw(cur) with
        R_new_cw = R_cm @ R_mw, must be almost purely about the gravity axis
        (|pitch|,|roll| < 0.008 rad, |yaw| < 0.349 rad). True without an
        initialized IMU."""
        if not self._inertial_ready():
            return True
        sys = self.sys
        ms = sys.ms
        pk = torch.cat([ms.kf_R[cur].reshape(9),
                        ms.kf_R[match].reshape(9)]).cpu().numpy()
        R_old = pk[:9].reshape(3, 3)
        R_m = pk[9:].reshape(3, 3)
        R_new = np.asarray(R_cm) @ R_m
        dRw = R_old.T @ R_new
        # log map (numpy, tiny)
        cos_t = np.clip((np.trace(dRw) - 1.0) * 0.5, -1.0, 1.0)
        theta = float(np.arccos(cos_t))
        if theta < 1e-9:
            return True
        ax = np.array([dRw[2, 1] - dRw[1, 2], dRw[0, 2] - dRw[2, 0],
                       dRw[1, 0] - dRw[0, 1]])
        ax = ax / max(np.linalg.norm(ax), 1e-12)
        phi = theta * ax
        g = np.asarray(sys.gravity, np.float64)
        up = -g / max(np.linalg.norm(g), 1e-9)
        yaw = float(np.dot(phi, up))
        perp = float(np.linalg.norm(phi - yaw * up))
        pr_tol = tol_scale * getattr(sys.cfg, "loop_pitchroll_tol",
                                     INERTIAL_PITCHROLL_TOL)
        yaw_tol = tol_scale * getattr(sys.cfg, "loop_yaw_tol",
                                      INERTIAL_YAW_TOL)
        self.stats["gate_pitchroll"] = perp
        self.stats["gate_yaw"] = yaw
        ok = perp < pr_tol and abs(yaw) < yaw_tol
        if not ok:
            self.stats["yaw_rejected"] = self.stats.get("yaw_rejected", 0) + 1
        return ok

    # -- correction ------------------------------------------------------
    def _correct_loop(self, cur: int, match: int, s_cm, R_cm, t_cm):
        """s_cm/R_cm/t_cm map match-keyframe camera coords -> current-
        keyframe camera coords. Corrected S_cw(cur) = S_cm * T_mw."""
        self.stats["loops"] += 1
        # current covisible window (plus current)
        win = M.covisibility_counts(self.sys.ms, cur) > 0
        win[cur] = True
        self._rigid_correct(cur, match, s_cm, R_cm, t_cm, win)
        self._fuse_and_optimize(cur, match)

    def _merge_maps(self, cur: int, match: int, s_cm, R_cm, t_cm):
        """Weld the active map onto the matched keyframe's map (ref
        LoopClosing::MergeLocal): rigidly move EVERY keyframe and point of
        the active map into the old map's frame, relabel, fuse, and optimize
        the joint essential graph."""
        sys = self.sys
        self.stats["merges"] = self.stats.get("merges", 0) + 1
        active = sys.kf_maps[cur]
        target = sys.kf_maps[match]
        win = np.asarray(
            [i < len(sys.kf_maps) and sys.kf_maps[i] == active
             for i in range(sys.ms.kf_valid.shape[0])])
        self._rigid_correct(cur, match, s_cm, R_cm, t_cm,
                            torch.from_numpy(win).to(sys.device))
        for i, m in enumerate(sys.kf_maps):
            if m == active:
                sys.kf_maps[i] = target
        sys.active_map = target
        self._fuse_and_optimize(cur, match, weld=True)

    def _rigid_correct(self, cur, match, s_cm, R_cm, t_cm, win):
        """Corrected S_cw(cur) = S_cm * T_mw (scale s_cm, = 1 unless mono);
        win: (K,) bool tensor of the keyframes to move."""
        sys = self.sys
        dev = sys.device
        Rm, tm = self._kf_pose_np(match)
        Rc = np.asarray(R_cm) @ Rm
        tc = s_cm * (np.asarray(R_cm) @ tm) + np.asarray(t_cm)
        sys.ms = _apply_window_correction(
            sys.ms, win, torch.as_tensor(s_cm, dtype=F32, device=dev),
            torch.as_tensor(Rc, dtype=F32, device=dev),
            torch.as_tensor(tc, dtype=F32, device=dev), cur)

    def _weld_ba(self, cur: int, match: int):
        """Seam-local welding BA (ref MergeLocal's local BA around the weld
        with fixed scaffolding keyframes from the target map): refine the
        moved side's seam window and its points against the target side, so
        a coarse merge Sim3 is absorbed locally instead of by the essential
        graph and the global BA."""
        sys = self.sys
        ms = sys.ms
        dev = sys.device
        Wk = Fk = 8
        with sync(sys.timing, "weld_windows"):
            # sync: the seam's windows are chosen on the host
            pk = torch.stack([M.covisibility_counts(ms, cur),
                              M.covisibility_counts(ms, match)]).cpu().numpy()
        kf_valid = ms.kf_valid.cpu().numpy()
        covis_c = np.where(kf_valid, pk[0], 0)
        covis_m = np.where(kf_valid, pk[1], 0)
        win = [cur] + [int(i) for i in np.argsort(-covis_c)
                       if covis_c[i] > 0 and i != cur][:Wk - 1]
        wset = set(win)
        fix = [match] + [int(i) for i in np.argsort(-covis_m)
                         if covis_m[i] > 0 and i != match
                         and i not in wset][:Fk - 1]

        def padded(slots, n):
            idx = np.zeros(n, np.int32)
            mask = np.zeros(n, bool)
            idx[:len(slots)] = slots
            mask[:len(slots)] = True
            return (torch.from_numpy(idx).to(dev),
                    torch.from_numpy(mask).to(dev))

        win_idx, win_mask = padded(win, Wk)
        fix_idx, fix_mask = padded(fix, Fk)
        out = mo.local_ba(ms, sys.calib, sys.orb, win_idx, win_mask, fix_idx,
                          fix_mask, n_fixed=Fk,
                          pt_cap=sys.cfg.map.local_mp_cap, n_iters=10)
        sys.ms = out.ms
        sys._obs_dirty = True

    def _essential_graph_edges(self, ms: M.MapState, cur: int, match: int):
        """(e_i, e_j, e_w) lists: the temporal chain (the spanning tree's
        stand-in, through kf_order since pool slots are recycled), strong
        covisibility edges (weight >= loop_covis_min, ref minFeat = 100) and
        the loop edge."""
        sys = self.sys
        with sync(sys.timing, "graph_edges"):
            # sync: the graph's edge list is built on the host
            kf_valid = ms.kf_valid.cpu().numpy()
            covm = M.covisibility_matrix(ms).cpu().numpy()
        valid_list = [k for k in sys.kf_order if kf_valid[k]]
        e_i = list(valid_list[1:])
        e_j = list(valid_list[:-1])
        e_w = [10.0] * len(e_i)
        covis_min = getattr(sys.cfg, "loop_covis_min", COVIS_EDGE_MIN)
        ii, jj = np.where(np.triu(covm, 1) >= covis_min)
        e_i += [int(a) for a in ii]
        e_j += [int(b) for b in jj]
        e_w += [1.0] * len(ii)
        e_i.append(cur)
        e_j.append(match)
        e_w.append(20.0)
        return e_i, e_j, e_w, kf_valid

    def _global_ba_mesh(self):
        """The mesh of the sharded global BA, built once, or None for the
        local solve: SystemConfig.dist_ba_devices > 1 asks for one, and the
        System's device must offer that many devices (a CPU System up to 8
        shards, a card System one per card, as the reference counts
        jax.devices()). An unrectified stereo pair takes the local solve,
        the one with its right-camera rows."""
        n_dist = self.sys.cfg.dist_ba_devices
        if n_dist <= 1 or self.sys.calib.is_fisheye_stereo:
            return None
        offered = dist_ba.devices_offered(self.sys.device)
        if len(offered) < n_dist:
            return None
        if self._ba_mesh is None:
            self._ba_mesh = dist_ba.make_mesh(n_dist, offered)
        return self._ba_mesh

    def _fuse_and_optimize(self, cur: int, match: int, weld: bool = False):
        sys = self.sys
        dev = sys.device
        # re-point stale point->reference-keyframe links before the graph
        # moves points by their reference's pose delta (slots recycle)
        sys.ms = ms = M.refresh_mp_refs(sys.ms)
        K = ms.kf_valid.shape[0]

        # fuse matched-side landmarks into the current keyframe only (ref
        # SearchAndFuse projects into every corrected keyframe; the
        # reference package measured that worse)
        msel = M.covisibility_counts(ms, match) > 0
        msel[match] = True
        cand_mask = M.local_map_mask(ms, torch.arange(K, device=dev), msel)
        c_idx, c_valid = M.gather_local_points(ms, cand_mask,
                                               sys.cfg.map.local_mp_cap)
        sys._obs_dirty = True
        sys.ms = ms = mo.fuse_into(ms, sys.calib, sys.orb, cur, c_idx,
                                   c_valid)
        if weld:
            # map merge: seam-local BA before the graph (ref MergeLocal)
            self._weld_ba(cur, match)
            ms = sys.ms

        old_R = ms.kf_R
        old_t = ms.kf_t
        e_i, e_j, e_w, kf_valid = self._essential_graph_edges(ms, cur, match)
        E = len(e_i)
        ei_d = torch.as_tensor(e_i, dtype=torch.long, device=dev)
        ej_d = torch.as_tensor(e_j, dtype=torch.long, device=dev)
        ew_d = torch.as_tensor(e_w, dtype=F32, device=dev)
        e_mask = torch.ones(E, dtype=torch.bool, device=dev)
        eR, et = pose_graph.relative_pose(old_R[ei_d], old_t[ei_d],
                                          old_R[ej_d], old_t[ej_d])
        fixed = ~kf_valid
        fixed[match] = True
        fixed = torch.from_numpy(fixed).to(dev)
        if self.mono:
            # the 7-DoF graph absorbs monocular scale drift
            res7 = pose_graph.optimize_pose_graph_sim3(
                torch.ones(K, dtype=ms.kf_t.dtype, device=dev), ms.kf_R,
                ms.kf_t, fixed, ei_d, ej_d,
                torch.ones(E, dtype=ms.kf_t.dtype, device=dev), eR, et, ew_d,
                e_mask, n_iters=10)
            sys.ms = _apply_sim3_graph(ms, old_R, old_t, res7.s, res7.R,
                                       res7.t)
        elif self._inertial_ready():
            # gravity observed: the graph may only redistribute yaw and
            # translation (ref OptimizeEssentialGraph4DoF)
            g = torch.as_tensor(np.asarray(sys.gravity, np.float32),
                                device=dev)
            res = pose_graph.optimize_pose_graph_4dof(
                ms.kf_R, ms.kf_t, -g, fixed, ei_d, ej_d, eR, et, ew_d,
                e_mask, n_iters=10)
            sys.ms = _reanchor_points(ms._replace(kf_R=res.R, kf_t=res.t),
                                      old_R, old_t)
        else:
            res = pose_graph.optimize_pose_graph(
                ms.kf_R, ms.kf_t, fixed, ei_d, ej_d, eR, et, ew_d, e_mask,
                n_iters=10)
            sys.ms = _reanchor_points(ms._replace(kf_R=res.R, kf_t=res.t),
                                      old_R, old_t)
        # global refinement (ref RunGlobalBundleAdjustment), anchored at the
        # matched keyframe: sharded over the mesh where the System asks for
        # one and its device offers it, else the alternating whole-map BA
        mesh = self._global_ba_mesh()
        if mesh is not None:
            sys.ms = dist_ba.dist_global_ba(sys.ms, sys.calib, sys.orb, match,
                                            mesh, n_iters=8)
        else:
            sys.ms = mo.global_ba(sys.ms, sys.calib, sys.orb, match,
                                  n_sweeps=2)
        if self._inertial_ready():
            # then poses, velocities and biases against the preintegration
            # chain (ref Optimizer::FullInertialBA via LoopClosing.cc:2228)
            sys._full_inertial_ba()
        self.loop_edges.append((cur, match))
        # tracking must re-localize against the corrected map: drop the
        # velocity model, reseed the device pose chain, and re-run the
        # in-flight frames that tracked against the pre-correction map
        sys.vel = None
        sys._has_vel = False
        sys._Rt_dev = None
        sys._Rt_dev2 = None
        T = sys._kf_pose(cur)
        sys.last_R = T[:3, :3].astype(np.float32)
        sys.last_t = T[:3, 3].astype(np.float32)
        sys._refresh_ref_pose()
        sys._redispatch_inflight()
