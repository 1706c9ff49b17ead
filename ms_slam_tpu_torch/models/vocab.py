"""Vectorized binary bag-of-words place recognition.

Port of `ms_slam_tpu/models/vocab.py`: a flat codebook of V binary
centroids, word assignment as one ±1 matmul (`hamming.hamming_matrix`,
TF32 off, so distances are exact integers), dense tf-idf keyframe rows,
and the keyframe database whose retrieval candidates are the sparsified
keyframes only.

Descriptors and codewords are (.., 8) int32 tensors carrying the
reference's uint32 bits. `argmin` ties go to the first index in both
frameworks (`jnp.argmin` and `torch.argmin` document it); the word votes
and their histograms are small multiples of 0.5, so histograms, their
sums and the normalised rows match the reference exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import hamming
from ..ops.indexing import add_at_
from ..ops.orb import pack_bits

_FAR = 1 << 30
_CHUNK = 8        # keyframes per batched Hamming product in place_scores
_ROW_CHUNK = 4096  # descriptors per (rows, V) distance block in the fits


def make_codebook(n_words: int = 2048, seed: int = 0xB0C4B,
                  device=None) -> torch.Tensor:
    """(V,8) int32 random binary centroids (the reference's uint32 draw)."""
    rs = np.random.RandomState(seed)
    words = rs.randint(0, 2 ** 32, size=(n_words, 8), dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def refine_codebook(codebook: torch.Tensor, descs: torch.Tensor,
                    valid: torch.Tensor, n_iter: int = 4) -> torch.Tensor:
    """k-medians refinement: assign descriptors to words, recompute the
    bitwise majority per word (`sums > 0`, so a tie gives bit 0).

    Descriptors go through in blocks of `_ROW_CHUNK` rows, so the distance
    matrix never spans the whole reservoir; the argmins are per row and the
    ±1 sums are small integers, so the result is the unblocked one bit for
    bit."""
    V = codebook.shape[0]
    dev = descs.device
    for _ in range(n_iter):
        sums = torch.zeros((V + 1, 256), device=dev)
        counts = torch.zeros(V + 1, device=dev)
        for s in range(0, descs.shape[0], _ROW_CHUNK):
            dc, vc = descs[s:s + _ROW_CHUNK], valid[s:s + _ROW_CHUNK]
            w = torch.argmin(hamming.hamming_matrix(dc, codebook), dim=1)
            w = torch.where(vc, w, V)
            add_at_(sums, w, hamming.unpack_pm1(dc, torch.float32))
            add_at_(counts, w, 1.0)
        codebook = torch.where((counts[:V] > 0)[:, None],
                               pack_bits(sums[:V] > 0), codebook)
    return codebook


def bow_vectors(codebook: torch.Tensor, descs: torch.Tensor,
                valid: torch.Tensor, soft: bool = True) -> torch.Tensor:
    """(B,V) normalised word histograms for (B,N,8) descriptor sets.

    soft: each descriptor also votes 0.5 for its second-nearest word.
    Blocked over rows as `refine_codebook`; the votes are multiples of 0.5,
    so the histograms are the unblocked ones exactly."""
    V = codebook.shape[0]
    B, N = valid.shape
    dev = descs.device
    flat, vflat = descs.reshape(B * N, 8), valid.reshape(-1)
    base = torch.arange(B, device=dev).repeat_interleave(N) * (V + 1)
    hist = torch.zeros(B * (V + 1), device=dev)
    for s in range(0, B * N, _ROW_CHUNK):
        d = hamming.hamming_matrix(flat[s:s + _ROW_CHUNK], codebook)
        vc, bc = vflat[s:s + _ROW_CHUNK], base[s:s + _ROW_CHUNK]
        w1 = torch.argmin(d, dim=1)
        add_at_(hist, torch.where(vc, w1, V) + bc, 1.0)
        if soft:
            d[torch.arange(d.shape[0], device=dev), w1] = _FAR
            add_at_(hist, torch.where(vc, torch.argmin(d, dim=1), V) + bc,
                    0.5)
    hist = hist.reshape(B, V + 1)[:, :V]
    n = torch.clamp(hist.sum(1, keepdim=True), min=1.0)
    return hist / n


def bow_vector(codebook: torch.Tensor, descs: torch.Tensor,
               valid: torch.Tensor, soft: bool = True) -> torch.Tensor:
    """Normalised word histogram (V,) for one image/keyframe."""
    return bow_vectors(codebook, descs[None], valid[None], soft)[0]


def tfidf_scores(rows: torch.Tensor, present: torch.Tensor,
                 q_vec: torch.Tensor) -> torch.Tensor:
    """Idf-weighted cosine similarity of a query BoW vector against every
    keyframe row: one (K,V)@(V,) product."""
    P = present.to(torch.float32).sum()
    df = ((rows > 0) & present[:, None]).sum(0).to(torch.float32)
    idf = torch.log((1.0 + P) / (1.0 + df))
    qw = q_vec * idf
    qn = qw / torch.clamp(torch.linalg.norm(qw), min=1e-9)
    rw = rows * idf[None, :]
    rn = rw / torch.clamp(torch.linalg.norm(rw, dim=1, keepdim=True),
                          min=1e-9)
    return rn @ qn


def place_scores(kf_desc: torch.Tensor, kf_kp_valid: torch.Tensor,
                 kf_mask: torch.Tensor, q_desc: torch.Tensor,
                 q_valid: torch.Tensor) -> torch.Tensor:
    """Brute-force place-recognition scores: for every keyframe, the
    fraction of its valid descriptors whose nearest query descriptor is
    within Hamming distance 40; -1 where kf_mask is False.

    Keyframes go through in chunks of `_CHUNK`, so memory stays
    O(chunk * Nq * Nk)."""
    K, Nk = kf_kp_valid.shape
    q = hamming.unpack_pm1(q_desc)                           # (Nq,256)
    out = []
    for s in range(0, K, _CHUNK):
        desc = kf_desc[s:s + _CHUNK]
        kv = kf_kp_valid[s:s + _CHUNK]
        C = kv.shape[0]
        dot = q @ hamming.unpack_pm1(desc.reshape(C * Nk, 8)).T
        d = ((hamming.N_BITS - dot) * 0.5).to(torch.int32).reshape(-1, C, Nk)
        ok = q_valid[:, None, None] & kv[None]
        best_kf = torch.where(ok, d, _FAR).min(0).values     # (C,Nk)
        n_k = torch.clamp(kv.sum(1), min=1)
        out.append(((best_kf < 40) & kv).sum(1) / n_k)
    sc = torch.cat(out).to(torch.float32)
    return torch.where(kf_mask, sc, -1.0)


class KeyFrameDatabase:
    """Database of BoW rows on the System's device.

    Every keyframe gets a row at creation (`set_row`); only sparsified
    keyframes become retrieval candidates (`add`). The codebook is fit in
    two deterministic stages: on the first TRAIN_KFS keyframes, then once
    more on everything seen by RETRAIN_KFS keyframes. Rows written before
    either fit are kept in a reservoir and re-encoded in one batched
    `bow_vectors` call, so all stored rows share one vocabulary. Both fits
    run synchronously, as in the reference. `present`, `has_row` and the
    reservoir bookkeeping live on the host."""

    TRAIN_KFS = 4
    RETRAIN_KFS = 24

    def __init__(self, n_words: int = 2048, max_kf: int = 1024,
                 device=None):
        self.device = torch.device(device) if device is not None else None
        self.codebook = make_codebook(n_words, device=device)
        self.rows = torch.zeros((max_kf, n_words), device=device)
        self.present = np.zeros(max_kf, bool)     # retrieval candidates
        self.has_row = np.zeros(max_kf, bool)     # any BoW row stored
        self._trained = False
        self._retrained = False
        self._buffer: list = []                   # (slot, descs, valid, pres)

    def _store(self, slots: list, descs, valid, pres: list):
        """Encode and write rows for distinct slots in one batch."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self.rows[idx] = bow_vectors(self.codebook, descs, valid)
        self.has_row[slots] = True
        self.present[[s for s, p in zip(slots, pres) if p]] = True

    def _reencode_buffer(self):
        """Recompute every buffered row under the current codebook (later
        entries for the same slot win: `add` supersedes `set_row`)."""
        latest = {}
        for slot, d, v, pres in self._buffer:
            keep_pres = pres or (slot in latest and latest[slot][2])
            latest[slot] = (d, v, keep_pres)
        slots = list(latest)
        self._store(slots, torch.stack([latest[s][0] for s in slots]),
                    torch.stack([latest[s][1] for s in slots]),
                    [latest[s][2] for s in slots])

    def _refit(self):
        descs = torch.cat([d for _, d, _, _ in self._buffer])
        valid = torch.cat([v for _, _, v, _ in self._buffer])
        self.codebook = refine_codebook(self.codebook, descs, valid)
        self._reencode_buffer()

    def _train_now(self):
        self._trained = True
        if self._buffer:
            self._refit()
        # keep the reservoir: the one-time retrain re-encodes it

    def _retrain_now(self):
        self._retrained = True
        self._refit()
        self._buffer = []                         # reservoir no longer needed

    def _put(self, kf_slot: int, descs, valid, pres: bool):
        if self._retrained:
            self._store([kf_slot], descs[None], valid[None], [pres])
            return
        # pre-retrain: rows go live at once when the early fit exists, and
        # every descriptor set also joins the reservoir (cloned: the map's
        # feature rows change in place when a slot is compacted or reused)
        self._buffer.append((kf_slot, descs.clone(), valid.clone(), pres))
        if self._trained:
            self._store([kf_slot], descs[None], valid[None], [pres])
        n_slots = len({b[0] for b in self._buffer})
        if not self._trained and n_slots >= self.TRAIN_KFS:
            self._train_now()
        elif self._trained and n_slots >= self.RETRAIN_KFS:
            self._retrain_now()

    def set_row(self, kf_slot: int, descs, valid):
        """BoW row for a NEW keyframe (not yet a retrieval candidate)."""
        self._put(kf_slot, descs, valid, False)

    def add(self, kf_slot: int, descs, valid):
        """(Re)compute the row post-compaction and mark it a candidate."""
        self._put(kf_slot, descs, valid, True)

    def erase(self, kf_slot: int):
        self.present[kf_slot] = False
        self.has_row[kf_slot] = False
        self._buffer = [b for b in self._buffer if b[0] != kf_slot]

    def query(self, descs, valid, exclude: set[int] | None = None,
              k: int = 5):
        """Top-k candidate keyframes by idf-weighted cosine similarity.
        Returns (slots, scores) best-first."""
        if not self._trained:
            self._train_now()
        mask = self.present.copy()
        for e in exclude or ():
            if 0 <= e < len(mask):
                mask[e] = False
        if not mask.any():
            return [], []
        q = bow_vector(self.codebook, descs, valid)
        scores = tfidf_scores(
            self.rows, torch.from_numpy(self.present).to(self.device),
            q).cpu().numpy()
        scores = np.where(mask, scores, -1.0)
        order = np.argsort(-scores)[:k]
        order = [int(i) for i in order if scores[i] > 0]
        return order, [float(scores[i]) for i in order]

    def query_rescored(self, kf_desc, kf_kp_valid, q_desc, q_valid,
                       exclude: set[int] | None = None, k: int = 5,
                       min_score: float = 0.05):
        """Retrieval: the tf-idf product shortlists 2k candidates, exact
        descriptor-set scoring (`place_scores`) rescores only those."""
        cands, _ = self.query(q_desc, q_valid, exclude=exclude, k=2 * k)
        if not cands:
            return [], []
        sub = torch.as_tensor(cands, dtype=torch.long, device=self.device)
        scores = place_scores(
            kf_desc[sub], kf_kp_valid[sub],
            torch.ones(len(cands), dtype=torch.bool, device=self.device),
            q_desc, q_valid).cpu().numpy()
        order = np.argsort(-scores)[:k]
        keep = [i for i in order if scores[i] > min_score]
        return ([cands[i] for i in keep],
                [float(scores[i]) for i in keep])
