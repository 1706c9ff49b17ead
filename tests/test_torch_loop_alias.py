"""Place recognition under repeating texture, in both packages.

A scene whose texture repeats (the synthetic worlds' 768-texel textures at
0.02 m a texel repeat every 15.36 m) shows a camera the same features at
places one period apart. Here that is made exact and small: the early
(revisited) keyframes of test_torch_loop_slice.py's drifted map are copied,
with every point they observe, to a place one period away (every copied
point X + p, every copied pose T_cw * translate(-p), p = 15.36 m along x),
so that each copy sees, in its own camera frame, exactly what its original
sees. The database then holds the copies (as when the true place is not a
retrieval candidate) or both.

Both packages run `detect_and_verify` from the same injected RANSAC
tables, then the reference's three-keyframe confirmation (the query, two
hypothesis refinements, `_confirm`) in their LoopClosers. They agree: the
copy verifies and is confirmed, and the confirmed S_cm would move the
current keyframe by the period; with both in the database, the tie goes to
the lower slot, the true place. Verification by shared geometry cannot tell
a translated copy of a place from the place, in either package.

Tolerances: those of test_torch_loop_slice.py's detect_and_verify and
refine_hypothesis (candidate slots equal, scores rtol 1e-4, inlier counts
within 2, R 1e-4, t 2e-3); the confirmed S_cm R 1e-4, t 5e-3.
"""
import jax
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import sim3 as jsim3
from ms_slam_tpu.pipeline import loop_closing as jlc
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.pipeline import loop_closing as tlc

from test_torch_loop_slice import (_both_systems, _calibs, _j, _jms, _t,
                                   _table, loop_state)

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

__all__ = ["loop_state"]       # the fixture, imported for this module

PERIOD = np.array([768 * 0.02, 0.0, 0.0])   # 15.36 m


def _alias_state(st):
    """The drifted map with the early keyframes and their points copied one
    period away, into free slots. Returns (d, alias slot of each early
    keyframe, kf_order with the copies first)."""
    d = {k: np.array(v) for k, v in st["d"].items()}
    early = st["early"]
    free_kf = np.flatnonzero(~d["kf_valid"])[:len(early)]
    kf_of = dict(zip(early, free_kf.tolist()))
    obs = d["obs_mp"]
    pts = np.unique(obs[early][obs[early] >= 0])
    # free point slots that no observation names (a culled point's stale
    # observations would make a copy covisible with their keyframe)
    named = np.zeros(d["mp_valid"].shape[0], bool)
    named[obs[obs >= 0]] = True
    free_mp = np.flatnonzero(~d["mp_valid"] & (d["mp_quarantine"] <= 0)
                             & ~named)[:len(pts)]
    assert len(free_mp) == len(pts)
    remap = np.full(d["mp_valid"].shape[0], -1)
    remap[pts] = free_mp
    for name in d:
        if name.startswith("mp_"):
            d[name][free_mp] = d[name][pts]
        elif name.startswith(("kf_", "kp_")) or name == "obs_mp":
            d[name][free_kf] = d[name][early]
    d["mp_pos"][free_mp] = (d["mp_pos"][pts] + PERIOD).astype(np.float32)
    d["mp_first_kf"][free_mp] = [kf_of.get(k, k)
                                 for k in d["mp_first_kf"][pts]]
    for k, a in kf_of.items():
        d["obs_mp"][a] = np.where(obs[k] >= 0, remap[obs[k].clip(0)], -1)
        d["kf_t"][a] = (d["kf_t"][k] - d["kf_R"][k] @ PERIOD).astype(
            np.float32)
    # the copies were made before everything else
    base = int(d["kf_ord"][st["kf_order"]].max()) + 1
    d["kf_ord"][free_kf] = base + np.arange(len(free_kf))
    d["mp_first_ord"][free_mp] = d["kf_ord"][d["mp_first_kf"][free_mp]]
    return d, [kf_of[k] for k in early], list(free_kf) + st["kf_order"]


def _aliased(st, present_early):
    """A copy of `loop_state` holding the aliased map; the database holds
    the copies, and the true place too if `present_early`."""
    d, alias, kf_order = _alias_state(st)
    a = dict(st, d=d, kf_order=kf_order, n_kf=max(kf_order) + 1)
    present = np.zeros(len(st["rows"]), bool)
    present[alias] = True
    present[st["early"]] = present_early
    rows = st["rows"].copy()
    rows[alias] = rows[st["early"]]          # same descriptors, same words
    has_row = st["has_row"].copy()
    has_row[alias] = True
    a.update(rows=rows, present=present, has_row=has_row, alias=alias)
    return a


def _centre(R, t):
    return -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)


def _drive(st, idx):
    """Both packages: detect_and_verify at the first late keyframe from the
    injected table, then the LoopCloser's query flush, two refinements at
    the next two late keyframes and the confirmation (recorded, not run)."""
    d = st["d"]
    cur = st["late"][0]
    cj, ct = _calibs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "choice", lambda *a_, **k: _j(idx))
        mp.setattr(jsim3, "sim3_ransac", jsim3.sim3_ransac.__wrapped__)
        pj, _ = jlc.detect_and_verify.__wrapped__(
            _jms(d), cj, _j(np.int32(cur)), _j(st["present"]),
            _j(st["has_row"]), _j(st["rows"]), jax.random.PRNGKey(0),
            _j(np.float32(0.05)), with_scale=False)
    pt, _ = tlc.detect_and_verify(
        TM.map_state_from_numpy(d), ct, cur, _t(st["present"]),
        _t(st["has_row"]), _t(st["rows"]), None, 0.05, with_scale=False,
        idx_tables=[_t(idx)] * 3)
    ref, port = _both_systems(st)
    out = {"packed": (np.asarray(pj), pt.numpy())}
    for name, slam, packed in (("ref", ref, pj),
                               ("port", port, tlc._Deferred(pt))):
        lc = slam._loop_closer
        confirmed = []
        lc._correct_loop = lambda *a: confirmed.append(a)
        lc._merge_maps = lambda *a: confirmed.append(("merge",) + a)
        lc._pending = ("query", cur, packed)
        lc.flush()
        hyp = dict(lc._hyp) if lc._hyp is not None else None
        lc.insert_keyframe(st["late"][1])
        lc.insert_keyframe(st["late"][2])
        lc.flush()
        out[name] = {"hyp": hyp, "confirmed": confirmed, "stats": lc.stats}
    return out


@pytest.fixture(scope="module")
def copies_only(loop_state):
    """The database holds the copies and not the true place."""
    st = _aliased(loop_state, present_early=False)
    rng = np.random.default_rng(0)
    idx = _table(rng, st["d"], st["late"][0], None)
    return st, _drive(st, idx)


@pytest.fixture(scope="module")
def both_present(loop_state):
    """The database holds the true place and its copies."""
    st = _aliased(loop_state, present_early=True)
    rng = np.random.default_rng(0)
    idx = _table(rng, st["d"], st["late"][0], None)
    return st, _drive(st, idx)


def test_copies_see_what_their_originals_see(loop_state):
    """Every copied keyframe observes its points at the same camera-frame
    coordinates as its original (to float32 rounding)."""
    st = _aliased(loop_state, present_early=False)
    d = st["d"]
    for k, a in zip(st["early"], st["alias"]):
        o, oa = d["obs_mp"][k], d["obs_mp"][a]
        assert ((o >= 0) == (oa >= 0)).all()
        Xk = d["mp_pos"][o[o >= 0]] @ d["kf_R"][k].T + d["kf_t"][k]
        Xa = d["mp_pos"][oa[oa >= 0]] @ d["kf_R"][a].T + d["kf_t"][a]
        np.testing.assert_allclose(Xa, Xk, atol=5e-5)
        gap = _centre(d["kf_R"][a], d["kf_t"][a]) \
            - _centre(d["kf_R"][k], d["kf_t"][k])
        np.testing.assert_allclose(gap, PERIOD, atol=1e-4)
    cov = TM.covisibility_matrix(TM.map_state_from_numpy(d)).numpy()
    assert cov[np.ix_(st["alias"], st["late"])].max() == 0
    assert cov[np.ix_(st["alias"], st["early"])].max() == 0


@pytest.mark.parametrize("case", ["copies_only", "both_present"])
def test_detect_and_verify_agree(request, case):
    _, out = request.getfixturevalue(case)
    pj, pt = out["packed"]
    np.testing.assert_array_equal(pt[:, 0], pj[:, 0])        # candidates
    np.testing.assert_allclose(pt[:, 1], pj[:, 1], rtol=1e-4)  # scores
    assert np.abs(pt[:, 2] - pj[:, 2]).max() <= 2              # inliers
    ok = pj[:, 2] >= tlc.MIN_RANSAC_INLIERS
    assert ok.any()
    np.testing.assert_allclose(pt[ok, 4:7], pj[ok, 4:7], atol=2e-3)
    np.testing.assert_allclose(pt[ok, 7:], pj[ok, 7:], atol=1e-4)


def test_copy_verifies_in_both(copies_only):
    """With only the copies in the database, both packages verify a copy:
    the query's best candidate and the held hypothesis are a copied slot."""
    st, out = copies_only
    for name in ("ref", "port"):
        h = out[name]["hyp"]
        assert h is not None and h["match"] in st["alias"], name
    assert out["ref"]["hyp"]["match"] == out["port"]["hyp"]["match"]


@pytest.mark.parametrize("case", ["copies_only", "both_present"])
def test_confirmed_in_both(request, case):
    """Two refinements pass the ladder in both packages and `_confirm`
    routes the hypothesis to the loop correction, with the same pair and
    relative pose."""
    st, out = request.getfixturevalue(case)
    cj, ct = out["ref"]["confirmed"], out["port"]["confirmed"]
    assert len(cj) == len(ct) == 1
    (c1, m1, s1, R1, t1), (c2, m2, s2, R2, t2) = cj[0], ct[0]
    assert (c1, m1) == (c2, m2) and c1 == st["late"][2]
    assert float(s1) == float(s2) == 1.0
    np.testing.assert_allclose(R2, R1, atol=1e-4)
    np.testing.assert_allclose(t2, t1, atol=5e-3)
    assert out["ref"]["stats"]["verified"] == out["port"]["stats"]["verified"]
    assert out["ref"]["stats"]["refines"] == out["port"]["stats"]["refines"]


@pytest.mark.parametrize("case", ["copies_only", "both_present"])
def test_where_the_correction_would_move_the_keyframe(request, case):
    """The confirmed S_cm puts the current keyframe at S_cm * T_mw: one
    period (15.36 m) from where the drifted map has it when the match is a
    copy, within the injected drift (~0.3 m) when it is the true place (the
    lower slot wins the tie of identical scores and inlier counts)."""
    st, out = request.getfixturevalue(case)
    d = st["d"]
    moves = []
    for name in ("ref", "port"):
        cur, match, s, R_cm, t_cm = out[name]["confirmed"][0]
        R_new = np.asarray(R_cm) @ d["kf_R"][match]
        t_new = np.asarray(R_cm) @ d["kf_t"][match] + np.asarray(t_cm)
        moves.append(np.linalg.norm(_centre(R_new, t_new)
                                    - _centre(d["kf_R"][cur],
                                              d["kf_t"][cur])))
        want_alias = case == "copies_only"
        assert (match in st["alias"]) == want_alias, (name, match)
    if case == "copies_only":
        assert all(abs(m - PERIOD[0]) < 1.0 for m in moves), moves
    else:
        assert all(m < 0.5 for m in moves), moves
    assert abs(moves[0] - moves[1]) < 5e-3, moves
