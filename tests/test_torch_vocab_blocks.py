"""The codebook fits of `models/vocab.py` blocked over descriptor rows.

`refine_codebook` and `bow_vectors` go through the reservoir in blocks of
`_ROW_CHUNK` descriptors, so the (rows, 2048) distance matrix never spans
the 24-keyframe reservoir that the second fit refines on. Held on a
reservoir of 24 x 2048 descriptors (the size of that fit at 2048 features):

- blocked against the unblocked versions kept below (the port's code
  before the blocking), bit for bit, at the default block and at one that
  leaves a ragged tail;
- against the reference's `refine_codebook` and `bow_vector`, bit for bit.

Exact because the argmins are per row and the sums are small integers
(±1 bit votes, 1 and 0.5 word votes) in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.models import vocab as jv
from ms_slam_tpu_torch.models import vocab as tv
from ms_slam_tpu_torch.ops import hamming
from ms_slam_tpu_torch.ops.indexing import add_at_
from ms_slam_tpu_torch.ops.orb import pack_bits

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

N_KF, N_FEAT, V = 24, 2048, 2048


def _unblocked_refine(codebook, descs, valid, n_iter=4):
    V = codebook.shape[0]
    bits = hamming.unpack_pm1(descs, torch.float32)
    for _ in range(n_iter):
        d = hamming.hamming_matrix(descs, codebook)
        w = torch.argmin(torch.where(valid[:, None], d, tv._FAR), dim=1)
        w = torch.where(valid, w, V)
        sums = add_at_(torch.zeros((V + 1, 256)), w, bits)[:V]
        counts = add_at_(torch.zeros(V + 1), w, 1.0)[:V]
        codebook = torch.where((counts > 0)[:, None], pack_bits(sums > 0),
                               codebook)
    return codebook


def _unblocked_bow_vectors(codebook, descs, valid):
    V = codebook.shape[0]
    B, N = valid.shape
    d = hamming.hamming_matrix(descs.reshape(B * N, 8), codebook)
    d = torch.where(valid.reshape(-1)[:, None], d, tv._FAR)
    base = (torch.arange(B) * (V + 1))[:, None]

    def vote(w, weight):
        wm = torch.where(valid, w.reshape(B, N), V) + base
        return add_at_(torch.zeros(B * (V + 1)), wm,
                       weight).reshape(B, V + 1)[:, :V]

    w1 = torch.argmin(d, dim=1)
    hist = vote(w1, 1.0)
    d[torch.arange(B * N), w1] = tv._FAR
    hist = hist + vote(torch.argmin(d, dim=1), 0.5)
    n = torch.clamp(hist.sum(1, keepdim=True), min=1.0)
    return hist / n


@pytest.fixture(scope="module")
def reservoir():
    """24 keyframes of 2048 descriptors, each a noisy copy of one of 3000
    scene descriptors (as a map's keyframes re-observe one scene), 10%
    invalid; the initial codebook; both fits by the reference."""
    rng = np.random.default_rng(5)
    scene = rng.integers(0, 2 ** 32, (3000, 8), dtype=np.uint32)
    descs = scene[rng.integers(0, 3000, N_KF * N_FEAT)]
    flips = rng.integers(0, 256, (N_KF * N_FEAT, 6))
    for j in range(flips.shape[1]):
        b = flips[:, j]
        descs[np.arange(len(b)), b // 32] ^= (1 << (b % 32)).astype(np.uint32)
    valid = rng.random(N_KF * N_FEAT) > 0.1
    cb0 = np.asarray(jv.make_codebook(V))
    cb_ref = np.asarray(jv.refine_codebook(
        jnp.asarray(cb0), jnp.asarray(descs), jnp.asarray(valid)))
    rows_ref = np.stack([np.asarray(jv.bow_vector(
        jnp.asarray(cb_ref), jnp.asarray(d), jnp.asarray(v)))
        for d, v in zip(descs.reshape(N_KF, N_FEAT, 8),
                        valid.reshape(N_KF, N_FEAT))])
    t = lambda a: torch.from_numpy(np.array(  # noqa: E731
        a.view(np.int32) if a.dtype == np.uint32 else a))
    return {"cb0": t(cb0), "descs": t(descs), "valid": t(valid),
            "cb_ref": cb_ref, "rows_ref": rows_ref,
            "cb_unblocked": _unblocked_refine(t(cb0), t(descs), t(valid))}


@pytest.mark.parametrize("rows", [tv._ROW_CHUNK, 3000])
def test_refine_codebook_blocked_is_exact(reservoir, rows, monkeypatch):
    monkeypatch.setattr(tv, "_ROW_CHUNK", rows)
    r = reservoir
    got = tv.refine_codebook(r["cb0"], r["descs"], r["valid"])
    assert (got != r["cb0"]).any()
    assert torch.equal(got, r["cb_unblocked"])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), r["cb_ref"])


@pytest.mark.parametrize("rows", [tv._ROW_CHUNK, 3000])
def test_bow_vectors_blocked_is_exact(reservoir, rows, monkeypatch):
    monkeypatch.setattr(tv, "_ROW_CHUNK", rows)
    r = reservoir
    cb = torch.from_numpy(np.array(r["cb_ref"].view(np.int32)))
    descs = r["descs"].reshape(N_KF, N_FEAT, 8)
    valid = r["valid"].reshape(N_KF, N_FEAT)
    got = tv.bow_vectors(cb, descs, valid)
    assert torch.equal(got, _unblocked_bow_vectors(cb, descs, valid))
    np.testing.assert_array_equal(got.numpy(), r["rows_ref"])
