"""The motion-only pose optimization's CUDA kernel (`csrc/pose_opt.cu`)
against its plain version, `pose_opt.pose_optimize_plain`, on the card, and
the wrapper's dispatch and checks on the CPU.

The kernel has no CPU mode, so the tests marked `cuda` skip on a machine
without a card. The file needs neither jax nor this directory's
conftest.py; on a GPU machine that has only PyTorch it runs as

    python -m pytest --noconftest -q -m cuda \
        tests/test_torch_pose_opt_kernel.py

The scenes are built here with numpy alone: the drive's (KITTI's pinhole
and bf, 2,048 matches at 3-40 m, every 7th monocular, 7.5% outliers, a
tenth unmatched) and the walk's (TUM-VI's two KB8 lenses and T_c1_c2,
1,024 matches at 1-12 m, each with its right keypoint unless it has none,
5% outliers in each image), from a start 0.02 rad and ~0.2 m off.
Tolerances, float32 on both sides: rotation 2e-5 rad, translation 2e-4,
inlier masks and the right rows' flags that differ in at most 2 slots,
`n_inliers` and `n_right` within 2, chi2 relative 1e-3. The kernel sums
the rows in another order than the plain version's batched contractions,
so the two agree to rounding, not bit for bit.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import _native, cameras, pose_opt

ENTRY = pose_opt.KERNEL.name     # its launches in _native.calls

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

# configs/KITTI00-02.yaml
PIN = np.array([718.856, 718.856, 607.1928, 185.2157, 0, 0, 0, 0])
BF = 386.1448
PIN_WH = (1241, 376)
# configs/TUM-VI-Fisheye.yaml: Camera1, Camera2 (fx, fy, cx, cy, k1-k4) and
# T_c1_c2, whose inverse maps left-camera points into the right camera
KB8_L = np.array([190.97847715128717, 190.9733070521226, 254.93170605935475,
                  256.8974428996504, 0.0034823894022493434,
                  0.0007150348452162257, -0.0020532361418706202,
                  0.00020293673591811182])
KB8_R = np.array([190.44236969414825, 190.4344384721956, 252.59949716835982,
                  254.91723064636983, 0.0034003170790442797,
                  0.001766278153469831, -0.00266312569781606,
                  0.0003299517423931039])
T_C1_C2 = np.array([[0.999999, -0.000528, 0.001413, 0.101063],
                    [0.000527, 0.999999, 0.000506, -0.001946],
                    [-0.001414, -0.000505, 0.999999, 0.000931],
                    [0.0, 0.0, 0.0, 1.0]])
T_RL = np.linalg.inv(T_C1_C2)[:3]
S2 = 1.2 ** (2 * np.arange(8))          # per-octave variance


def _so3_exp(w):
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(th) / th * W
            + (1 - np.cos(th)) / th ** 2 * W @ W)


def _project(model, P, Xc):
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    if model == 0:
        return np.stack([P[0] * x / z + P[2], P[1] * y / z + P[3]], -1)
    r = np.sqrt(x * x + y * y)
    th = np.arctan2(r, z)
    t2 = th * th
    f = th * (1 + t2 * (P[4] + t2 * (P[5] + t2 * (P[6] + t2 * P[7]))))
    s = f / np.maximum(r, 1e-8)
    return np.stack([P[0] * x * s + P[2], P[1] * y * s + P[3]], -1)


def scenario(device, N=2048, model=0, rig=False, masked=False, seed=22,
             dt=torch.float32):
    """(positional arguments, keyword arguments) of pose_optimize on
    `device`, and the true (R, t) of the camera."""
    rng = np.random.default_rng(seed)
    R_true = _so3_exp(np.array([0.03, -0.2, 0.05]))
    t_true = np.array([0.4, -0.1, 2.0])
    if model == 0:      # pixels across KITTI's image, depths 3-40 m
        px = rng.uniform([0, 0], PIN_WH, (N, 2))
        z = rng.uniform(3.0, 40.0, N)
        Xc = np.stack([(px[:, 0] - PIN[2]) / PIN[0] * z,
                       (px[:, 1] - PIN[3]) / PIN[1] * z, z], -1)
    else:               # bearings within 70 degrees of the axis, 1-12 m
        th = np.arccos(rng.uniform(np.cos(np.radians(70)), 1.0, N))
        ph = rng.uniform(0, 2 * np.pi, N)
        d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                      np.cos(th)], -1)
        Xc = d * rng.uniform(1.0, 12.0, N)[:, None]
    X = (Xc - t_true) @ R_true              # R^T (Xc - t), row by row
    P = PIN if model == 0 else KB8_L
    level = rng.integers(0, 8, N)
    sigma2 = S2[level]
    uv = _project(model, P, Xc) + rng.normal(0, 0.5, (N, 2)) \
        * np.sqrt(sigma2)[:, None]
    n_out = int(0.075 * N) if model == 0 else int(0.05 * N)
    uv[:n_out] += rng.normal(0, 25.0, (n_out, 2))
    ur = uv[:, 0] - BF / Xc[:, 2] + rng.normal(0, 0.5, N)
    ur[::7] = -1.0                                 # monocular matches
    mask = rng.random(N) > 0.1
    if model == 1:
        ur[:] = -1.0                               # a KB8 pair's frontend
    if masked:
        mask[:] = False
    guess = (_so3_exp(np.array([0.012, -0.015, 0.008])) @ R_true,
             t_true + np.array([0.12, -0.08, 0.15]))

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)
    args = (model, t(P), BF if model == 0 else 0.0, *[t(a) for a in guess],
            t(X), t(uv), t(ur), t(sigma2), torch.tensor(mask, device=device))
    kw = {}
    if rig:
        Xr = Xc @ T_RL[:, :3].T + T_RL[:, 3]
        lr = rng.integers(0, 8, N)
        right = np.concatenate([_project(1, KB8_R, Xr)
                                + rng.normal(0, 0.5, (N, 2))
                                * np.sqrt(S2[lr])[:, None],
                                S2[lr][:, None]], -1)
        right[n_out:2 * n_out, :2] += rng.normal(0, 25.0, (n_out, 2))
        right[::5] = -1.0                          # no right keypoint
        right[Xr[:, 2] < 0.2] = -1.0
        kw = dict(rig=cameras.Rig(params2=t(KB8_R),
                                  T=t(T_RL).contiguous()),
                  right=t(right))
    return args, kw, (R_true, t_true)


def _rot_err(Ra, Rb):
    """The angle of Ra Rb^T from its skew part, in float64 (the arccos of
    its trace cannot resolve 2e-5 rad from float32 matrices)."""
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = 0.5 * np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0],
                        d[1, 0] - d[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(s), 1.0)))


def right_flags(R, t, args, kw):
    """The plain version's right-row gate at the pose (R, t), in float64:
    matched, a right keypoint, chi2 within the monocular gate and in front
    of the right camera."""
    R, t = (np.asarray(a.cpu(), np.float64) for a in (R, t))
    X = args[5].double().cpu().numpy()
    right = kw["right"].double().cpu().numpy()
    Xr = (X @ R.T + t) @ T_RL[:, :3].T + T_RL[:, 3]
    r = right[:, :2] - _project(1, KB8_R, Xr)
    chi2 = (r * r).sum(-1) / np.maximum(right[:, 2], 1e-12)
    return (args[9].cpu().numpy() & (right[:, 0] >= 0) & (chi2 <= 5.991)
            & (Xr[:, 2] > 0))


def _assert_close(out, ref):
    assert _rot_err(out.R.cpu(), ref.R.cpu()) < 2e-5
    np.testing.assert_allclose(out.t.cpu().numpy(), ref.t.cpu().numpy(),
                               atol=2e-4)
    assert int((out.inlier != ref.inlier).sum()) <= 2
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= 2
    assert abs(float(out.chi2) - float(ref.chi2)) \
        <= 1e-3 * abs(float(ref.chi2))
    assert out.n_inliers.dtype == torch.int32 and out.n_inliers.dim() == 0
    assert (out.n_right is None) == (ref.n_right is None)
    if ref.n_right is not None:
        assert abs(int(out.n_right) - int(ref.n_right)) <= 2


CASES = {
    "drive": (dict(), dict()),                 # the local map's 4 x 10
    "motion_budget": (dict(), dict(n_rounds=2, n_iters=5)),
    "walk": (dict(N=1024, model=1, rig=True), dict()),
    "all_masked": (dict(masked=True), dict()),
    "one_step": (dict(), dict(n_rounds=1, n_iters=1)),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_pose_opt_kernel_against_plain_on_card(name):
    dev = _card()
    scene, budget = CASES[name]
    args, kw, (R_true, t_true) = scenario(dev, **scene)
    out = pose_opt.pose_optimize(*args, **budget, **kw)
    ref = pose_opt.pose_optimize_plain(*args, **budget, **kw)
    torch.cuda.synchronize()
    for t in (out.R, out.t, out.chi2):
        assert torch.isfinite(t).all()
    _assert_close(out, ref)
    if name in ("drive", "walk"):       # and it solved the problem
        assert _rot_err(out.R.cpu(), R_true) < 1e-3
        assert np.linalg.norm(out.t.cpu().numpy() - t_true) < 0.05
        assert int(out.n_inliers) > 0.8 * int(args[9].sum())
    if name == "all_masked":
        assert int(out.n_inliers) == 0 and float(out.chi2) == 0.0
    if name == "walk":
        # the right rows' flags, which the result does not carry: a second
        # launch through the C entry point, the same as the first, and
        # within 2 slots of the plain version's gate at its own pose
        call, again = pose_opt._kernel_call(*args, 4, 10, **kw)
        c_args = pose_opt.KERNEL.args(args[3].device, **call)
        assert pose_opt.KERNEL.fn()(*c_args) == 0
        inlier_r = call["inlier_r"]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(again, out))
        want = right_flags(ref.R, ref.t, args, kw)
        assert int((inlier_r.cpu().numpy() != want).sum()) <= 2
        assert int(inlier_r.sum()) == int(out.n_right)
        assert int(out.n_right) > 0.6 * int(args[9].sum())


@pytest.mark.cuda
def test_pose_opt_kernel_one_launch_a_call_on_card():
    dev = _card()
    args, kw, _ = scenario(dev, N=512)
    before = _native.calls[ENTRY]
    for _ in range(3):
        pose_opt.pose_optimize(*args, n_rounds=2, n_iters=5)
    torch.cuda.synchronize()
    assert _native.calls[ENTRY] == before + 3
    # the start pose in another layout (the inertial step's is a
    # transposed view) gives the same launch
    args = list(args)
    out = pose_opt.pose_optimize(*args)
    args[3] = args[3].t().contiguous().t()          # R0, column-major
    assert not args[3].is_contiguous()
    assert all(torch.equal(a, b) for a, b in
               zip(pose_opt.pose_optimize(*args), out) if a is not None)
    assert _native.calls[ENTRY] == before + 5
    args[5] = args[5].double()                       # X
    with pytest.raises(ValueError, match="X must be"):
        pose_opt.pose_optimize(*args)
    assert _native.calls[ENTRY] == before + 5


def test_pose_opt_wrapper_takes_plain_version_on_cpu():
    args, kw, _ = scenario(torch.device("cpu"), N=200, model=1, rig=True)
    before = (_native.calls[ENTRY], _native.calls["pose_optimize"])
    out = pose_opt.pose_optimize(*args, n_rounds=2, n_iters=3, **kw)
    assert (_native.calls[ENTRY],
            _native.calls["pose_optimize"]) == (before[0], before[1] + 1)
    ref = pose_opt.pose_optimize_plain(*args, n_rounds=2, n_iters=3, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def _refused(args, kw, name):
    """Edits one input so that the kernel cannot take it."""
    args, kw = list(args), dict(kw)
    if name == "float64":
        args[5] = args[5].double()                   # X
    elif name == "strided":
        args[6] = args[6].t().contiguous().t()       # uv, column-major
    elif name == "mask_dtype":
        args[9] = args[9].to(torch.uint8)
    elif name == "short_params":
        args[1] = args[1][:4]
    elif name == "device":
        args[8] = args[8].to("meta")                 # sigma2
    elif name == "model":
        args[0] = 2
    elif name == "right_shape":
        kw["right"] = kw["right"][:-1]
    return args, kw


def _checked(args, kw):
    """The wrapper's call (`_kernel_call`) through the entry point's checks,
    on the tensors' device, without a launch: (C arguments, result, right
    rows' flags)."""
    call, out = pose_opt._kernel_call(*args, 4, 10, **kw)
    return (pose_opt.KERNEL.args(args[3].device, **call), out,
            call["inlier_r"])


@pytest.mark.parametrize("name", ["float64", "strided", "mask_dtype",
                                  "short_params", "device", "model",
                                  "right_shape"])
def test_pose_opt_launch_args_refuse_what_the_kernel_cannot_take(name):
    """The checks in front of the launch, run on CPU tensors (they look at
    device, dtype, shape and layout only)."""
    args, kw, _ = scenario(torch.device("cpu"), N=50, model=1, rig=True)
    bad_args, bad_kw = _refused(args, kw, name)
    with pytest.raises(ValueError):
        _checked(bad_args, bad_kw)
    call, out, inlier_r = _checked(args, kw)
    assert out.inlier.shape == inlier_r.shape == (50,)


def test_pose_opt_wrapper_refuses_other_devices():
    args, _, _ = scenario(torch.device("cpu"), N=20)
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no pose_optimize for device"):
        pose_opt.pose_optimize(*args)


# each entry point's C declaration, written out by hand (`const` left out)
C_INTERFACES = {
    "msslam_pose_opt":
        "int model, float bf, int n, int n_rounds, int n_iters, "
        "float* params, float* R0, float* t0, float* X, float* uv, "
        "float* u_right, float* sigma2, uint8_t* mask, float* state, "
        "uint8_t* inlier, int* n_inliers, float* params2, float* T_rl, "
        "float* right, uint8_t* inlier_r, int* n_right, void* stream",
    "msslam_pose_vel_bias":
        "int model, float bf, int n, int n_rounds, int n_iters, "
        "float* params, float* R_bc, float* t_bc, float* R1, float* p1, "
        "float* v1, float* bg1, float* ba1, float* dT, float* dR, "
        "float* dV, float* dP, float* JRg, float* JVg, float* JVa, "
        "float* JPg, float* JPa, float* bias, float* LT, float* R2, "
        "float* p2, float* v2, float* X, float* uv, float* u_right, "
        "float* sigma2, uint8_t* mask, float* walk, float* g, "
        "float* state, uint8_t* inlier, int* n_inliers, float* params2, "
        "float* T_rl, float* right, uint8_t* inlier_r, int* n_right, "
        "void* stream",
    "msslam_patch_gather_f32":
        "float* canvas, int* bi, int* ys, int* xs, float* out, int n, "
        "int B, int H, int Wc, void* stream",
    "msslam_patch_gather_bf16":
        "__nv_bfloat16* canvas, int* bi, int* ys, int* xs, float* out, "
        "int n, int B, int H, int Wc, void* stream",
}


def _wrapper_call(entry: str, rig: bool = True):
    """(Entry, the wrapper's arguments by name) of an entry point on small
    CPU tensors: with a rig where the entry point takes one, unless not
    `rig`."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)
    N = 30
    rig_kw = dict(rig=cameras.Rig(params2=z(8), T=z(3, 4)),
                  right=z(N, 3)) if rig else {}
    if entry == "msslam_pose_opt":
        args, _, _ = scenario(torch.device("cpu"), N=N, model=1)
        return pose_opt.KERNEL, pose_opt._kernel_call(*args, 4, 10,
                                                      **rig_kw)[0]
    if entry == "msslam_pose_vel_bias":
        from ms_slam_tpu_torch.ops import imu, inertial_opt
        preint = imu.init_state(z(6))
        return inertial_opt.KERNEL, inertial_opt._kernel_call(
            1, z(8), 0.0, z(3, 3), z(3), z(3, 3), z(3), z(3), z(3), z(3),
            preint, z(9, 9), z(3, 3), z(3), z(3), z(N, 3), z(N, 2), z(N),
            z(N), z(N, dtype=torch.bool), z(6), 4, 6, z(3), **rig_kw)[0]
    from ms_slam_tpu_torch.ops import orb
    dtype = torch.bfloat16 if entry.endswith("bf16") else torch.float32
    gather, kw, _ = orb._gather_call(z(2, 64, 256, dtype=dtype),
                                     *[z(N, dtype=torch.int32)] * 3)
    return gather, kw


@pytest.mark.parametrize("entry", list(C_INTERFACES))
def test_pose_opt_launch_args_match_the_c_interface(entry):
    """The parameters read from each entry point's C declaration equal the
    hand-written list, each bound to the ctypes type of its C type; the
    wrapper's call names every one of them but the stream, and passes the
    entry point's checks. A tracking kernel's rig pointers are null
    without a rig and set with one."""
    want = [p.split() for p in C_INTERFACES[entry].split(", ")]
    kernel, call = _wrapper_call(entry)
    assert kernel.name == entry
    assert [list(p) for p in kernel.params] == want
    fn = kernel.bind(type("CFunction", (), {})())
    assert fn.argtypes == [ctypes.c_void_p if t.endswith("*") else
                           ctypes.c_float if t == "float" else ctypes.c_int
                           for t, _ in want]
    assert fn.restype is ctypes.c_int
    assert sorted(call) == sorted(n for _, n in want if n != "stream")
    c_args = kernel.args(torch.device("cpu"), **call)
    assert len(c_args) == len(want) and c_args[-1] is None   # no stream
    rig_at = [i for i, (_, n) in enumerate(want) if n in kernel.optional]
    assert all(c_args[i] is not None for i in rig_at)
    if rig_at:
        kernel, call = _wrapper_call(entry, rig=False)
        c_args = kernel.args(torch.device("cpu"), **call)
        assert [c_args[i] for i in rig_at] == [None] * 5
        assert [want[i][1] for i in rig_at] == list(pose_opt.RIG_PARAMS)


def test_native_entry_refuses_an_unknown_c_type_at_load(tmp_path,
                                                        monkeypatch):
    """A C type the binding has no rule for (here double) is refused when
    the declaration is first read, before anything is built or bound."""
    (tmp_path / "fake.cu").write_text(
        'extern "C" int msslam_fake(const double* x, int n,\n'
        '                           void* stream) { return 0; }\n')
    monkeypatch.setattr(_native, "_CSRC", str(tmp_path))
    entry = _native.Entry("fake", "msslam_fake")
    with pytest.raises(ValueError, match="const double\\* x"):
        entry.params
    with pytest.raises(ValueError, match="no binding"):
        entry.args(torch.device("cpu"), x=torch.zeros(3), n=3)


def test_native_entry_refuses_null_for_a_required_pointer():
    """None is a null pointer only for the parameters the wrapper declares
    optional (the rig's); a missing or unknown name is refused too."""
    kernel, call = _wrapper_call("msslam_pose_opt", rig=False)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="X must be a tensor"):
        kernel.args(cpu, **{**call, "X": None})
    with pytest.raises(TypeError):
        kernel.args(cpu, **{k: v for k, v in call.items() if k != "mask"})
    with pytest.raises(TypeError):
        kernel.args(cpu, **call, mask2=call["mask"])
    with pytest.raises(ValueError, match="n must fit a C int"):
        kernel.args(cpu, **{**call, "n": 2 ** 31})
    assert len(kernel.args(cpu, **call)) == 22


def test_native_sources_lists_included_headers():
    head = os.path.join(_native._CSRC, "lie_camera.cuh")
    for name in ("pose_opt", "pose_vel_bias"):
        assert _native.sources(name) == [
            os.path.join(_native._CSRC, f"{name}.cu"), head]
    assert _native.sources("patch_gather") == [
        os.path.join(_native._CSRC, "patch_gather.cu")]


def test_native_library_is_stale_when_a_header_is_newer(tmp_path):
    src, head, lib = (tmp_path / n for n in ("k.cu", "k.cuh", "libk.so"))
    for p in (src, head, lib):
        p.write_text("")
    os.utime(src, (100, 100))
    os.utime(head, (100, 100))
    os.utime(lib, (200, 200))
    assert not _native.stale(str(lib), [str(src), str(head)])
    os.utime(head, (300, 300))
    assert _native.stale(str(lib), [str(src), str(head)])
    assert _native.stale(str(tmp_path / "missing.so"), [str(src)])
