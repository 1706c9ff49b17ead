"""S6, the inertial loop closure (tests/test_inertial_system.py::test_
inertial_loop_closure_preserves_gravity), through the port against the
reference.

Tier-1: the yaw gate (`LoopCloser._inertial_gate_ok`) inside `_confirm`,
from one injected hypothesis in both packages, with the IMU initialized at
stage 2 and gravity along +y. A correction across gravity (pitch) passes
under `loop_pitchroll_tol` (0.05 here, the reference test's), one about
the up axis under INERTIAL_YAW_TOL (0.349 rad); a merge across maps gets
both bands widened 2x. Both packages take the same branch, count the same
rejection, and record the same gate angles (1e-6 rad).

slow: both packages over the reference test's 100 frames (an 80-frame
BoxWorld orbit into its second lap, 200 Hz IMU rows). Each is held to the
reference test's bars (state OK, `_imu_stage >= 2`, queries > 0,
loops >= 1, |g| within 0.6 of 9.81, g_y/|g| > 0.9); the port to the
reference's outcome: loops within 1 of it, |g| within 0.3 of the
reference's and the frame ATE under twice the reference's plus 1% of the
path.
"""
import numpy as np
import pytest
import test_torch_scenarios as S
import torch

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

PR_TOL, YAW_TOL = 0.05, 0.349


@pytest.mark.parametrize("pitch,yaw,cross,want", [
    (0.6 * PR_TOL, 0.0, False, "loop"),
    (1.5 * PR_TOL, 0.0, False, None),       # across gravity: rejected
    (1.5 * PR_TOL, 0.0, True, "merge"),     # ... but a merge's band is 2x
    (2.5 * PR_TOL, 0.0, True, None),
    (0.0, 0.2, False, "loop"),
    (0.0, 1.4 * YAW_TOL, False, None),      # too much yaw for a loop
    (0.0, 1.4 * YAW_TOL, True, "merge"),
])
def test_yaw_gate_in_confirm_matches_reference(pitch, yaw, cross, want):
    (ref, port), R_cm, _ = S.confirm_calls(pitch, cross, inertial=True,
                                           yaw=yaw)
    (rc, rs), (pc, ps) = ref, port
    assert [c[0] for c in pc] == [c[0] for c in rc] == (
        [want] if want else [])
    assert ps.get("yaw_rejected", 0) == rs.get("yaw_rejected", 0) == (
        0 if want else 1)
    for k, v in (("gate_pitchroll", pitch), ("gate_yaw", yaw)):
        assert abs(ps[k] - rs[k]) < 1e-6, (k, ps[k], rs[k])
        assert abs(ps[k] - v) < 1e-6, (k, ps[k], v)
    if want:
        np.testing.assert_allclose(np.asarray(pc[0][4], np.float64), R_cm,
                                   atol=1e-6)


@pytest.mark.slow
def test_inertial_loop_closure_both_packages():
    ref = S.run_inertial_loop(S.package("ref"))
    port = S.run_inertial_loop(S.package("port"))
    print("reference", ref)
    print("port", port)
    for r in (ref, port):
        S.inertial_loop_bars(r)
    assert abs(port["loops"] - ref["loops"]) <= 1, (port, ref)
    assert abs(port["g_norm"] - ref["g_norm"]) < 0.3, (port, ref)
    assert port["ate"] < 2 * ref["ate"] + 0.01 * port["path"], (port, ref)
