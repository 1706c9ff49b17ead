"""The patch-gather CUDA kernel against its plain version, and what else
differs on the card (tied argmins, float scatter sums, pinned fetches).

The kernel has no CPU mode, so the tests marked `cuda` skip on a machine
without a card. It needs neither jax nor this directory's conftest.py, so
on a GPU machine that has only PyTorch it runs as

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: bit-exact for the kernel (it is a copy; its bf16 entry point a
widening copy); stated in the test for the pose graph.
"""
import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import _native, orb

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

# the gather's entry points (launches) and wrapper (plain calls) in
# _native.calls
F32, BF16 = "msslam_patch_gather_f32", "msslam_patch_gather_bf16"
PLAIN = "extract_patches_canvas"


def _inputs(rng, B=2, H=384, Wc=5888, n=512):
    canvas = rng.uniform(0, 255, (B, H, Wc)).astype(np.float32)
    ys = rng.integers(-8, H + 8, B * n).astype(np.int32)
    xs = rng.integers(-8, Wc + 8, B * n).astype(np.int32)
    # centres beyond each clip edge: top, bottom, left, right, corners
    ys[:6] = [0, H - 1, 100, 120, -4, H + 3]
    xs[:6] = [50, 60, 0, Wc - 1, -2, Wc + 5]
    bi = np.repeat(np.arange(B, dtype=np.int32), n)
    return canvas, bi, ys, xs


def _case(name):
    """Inputs that the kernel's groups of four, its scalar tail and its
    clips each have to get right; nothing is tied to the 5888-wide canvas."""
    rng = np.random.default_rng(1)
    if name == "tail_of_three":             # 1023 = 255 groups + 3
        canvas, bi, ys, xs = _inputs(rng, n=512)
        return canvas, bi[:1023], ys[:1023], xs[:1023]
    if name == "one_keypoint":              # no whole group at all
        canvas, bi, ys, xs = _inputs(rng, n=4)
        return canvas, bi[5:6], ys[5:6], xs[5:6]
    if name == "one_image":
        return _inputs(rng, B=1, n=301)
    if name == "all_centres_outside":
        canvas, bi, ys, xs = _inputs(rng, n=256)
        H, Wc = canvas.shape[1:]
        ys = np.where(rng.random(ys.shape) < 0.5, -30, H + 30).astype(np.int32)
        xs = np.where(rng.random(xs.shape) < 0.5, -30, Wc + 30).astype(np.int32)
        bi = (bi.astype(np.int64) * 5 - 2).astype(np.int32)   # -2 and 3: clamped
        return canvas, bi, ys, xs
    if name == "vga_canvas":                # 640x480 images, default pyramid
        _, Wc, _ = orb.canvas_layout(480, 640, orb.OrbConfig())
        assert Wc != 5888
        return _inputs(rng, H=480, Wc=Wc, n=130)
    raise KeyError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tail_of_three", "one_keypoint",
                                  "one_image", "all_centres_outside",
                                  "vga_canvas"])
def test_patch_gather_kernel_cases_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in _case(name)]
    before = _native.calls[F32]
    out = orb.extract_patches_canvas(*args)
    torch.cuda.synchronize()
    assert _native.calls[F32] == before + 1
    assert out.shape == (args[1].shape[0], 45, 45)
    assert torch.equal(out, orb.extract_patches_canvas_plain(*args))


@pytest.mark.cuda
def test_patch_gather_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = [torch.from_numpy(a).cuda()
            for a in _inputs(np.random.default_rng(0))]
    before = _native.calls[F32]
    out = orb.extract_patches_canvas(*args)
    torch.cuda.synchronize()
    assert _native.calls[F32] == before + 1
    assert torch.equal(out, orb.extract_patches_canvas_plain(*args))
    with pytest.raises(ValueError):          # f64 canvas: refused, not cast
        orb.extract_patches_canvas(args[0].double(), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tail_of_three", "one_keypoint",
                                  "one_image", "all_centres_outside",
                                  "vga_canvas"])
def test_patch_gather_bf16_kernel_cases_on_card(name):
    """The bf16 entry point (the canvas of MSSLAM_FORCE_TPU_NUMERICS) on the
    same cases, the canvas cast to bf16: its plain version widened, bit for
    bit; its own counter moves and the f32 one does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _bf16_gather_on_card(*_case(name))


def _bf16_gather_on_card(canvas, bi, ys, xs):
    """The bf16 entry point on numpy inputs (the canvas cast to bf16 on the
    card): its own counter moves by one and the f32 one does not, and the
    output equals the plain version widened, bit for bit."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (canvas, bi, ys, xs)]
    args[0] = args[0].to(torch.bfloat16)
    f32, bf16 = _native.calls[F32], _native.calls[BF16]
    out = orb.extract_patches_canvas(*args)
    torch.cuda.synchronize()
    assert _native.calls[BF16] == bf16 + 1
    assert _native.calls[F32] == f32
    assert out.dtype == torch.float32
    assert out.shape == (bi.shape[0], 45, 45)
    assert torch.equal(out, orb.extract_patches_canvas_plain(*args).float())


@pytest.mark.cuda
def test_patch_gather_bf16_right_clip_edge_on_card():
    """Every keypoint at the right clip edge (x = Wc - 23, or beyond it and
    clipped there): each tile's TMA box reaches up to 10 columns past Wc,
    which the tensor map fills with zeros and the widening never copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    canvas, bi, ys, xs = _inputs(rng, n=130)
    Wc = canvas.shape[2]
    xs = np.where(np.arange(xs.size) % 3 == 0, Wc + 7, Wc - 23) \
        .astype(np.int32)
    _bf16_gather_on_card(canvas, bi, ys, xs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(1, 10))
def test_patch_gather_bf16_small_n_on_card(n):
    """n = 1-3 (a tail and no whole group), 4 and 8 (whole groups only),
    5-7 and 9 (whole groups and a tail), on two images."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    canvas, bi, ys, xs = _inputs(np.random.default_rng(10 + n), n=8)
    pick = np.random.default_rng(n).permutation(16)[:n]
    _bf16_gather_on_card(canvas, bi[pick], ys[pick], xs[pick])


@pytest.mark.cuda
def test_patch_gather_bf16_many_waves_on_card():
    """8,192 keypoints (2,048 groups): more groups than resident blocks, so
    every block walks several groups through both of its stages."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _bf16_gather_on_card(*_inputs(np.random.default_rng(4), n=4096))


@pytest.mark.cuda
def test_patch_gather_bf16_refuses_misaligned_view_on_card():
    """A contiguous bf16 view one element into its storage starts 2 bytes
    off the 16-byte alignment the tensor map needs: refused with
    ValueError, nothing launched, and no fallback to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    canvas, bi, ys, xs = (torch.from_numpy(a).cuda() for a in
                          _inputs(np.random.default_rng(5), n=16))
    flat = torch.empty(canvas.numel() + 8, dtype=torch.bfloat16,
                       device="cuda")
    view = flat[1:1 + canvas.numel()].view(canvas.shape)
    view.copy_(canvas)
    assert view.is_contiguous() and view.storage_offset() == 1
    before = (_native.calls[F32], _native.calls[BF16],
              _native.calls[PLAIN])
    with pytest.raises(ValueError, match="16-byte aligned"):
        orb.extract_patches_canvas(view, bi, ys, xs)
    assert (_native.calls[F32], _native.calls[BF16],
            _native.calls[PLAIN]) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_patch_gather_refuses_other_dtypes_on_card(dtype):
    """Only float32 and bfloat16 canvases have an entry point; any other is
    refused, not cast, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = [torch.from_numpy(a).cuda()
            for a in _inputs(np.random.default_rng(0), n=8)]
    f32, bf16 = _native.calls[F32], _native.calls[BF16]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        orb.extract_patches_canvas(args[0].to(dtype), *args[1:])
    assert (_native.calls[F32],
            _native.calls[BF16]) == (f32, bf16)


def test_patch_gather_refuses_other_devices():
    """Only a CPU tensor takes the plain version; any other device either
    launches the kernel (CUDA) or raises."""
    canvas, bi, ys, xs = (torch.from_numpy(a).to("meta") for a in
                          _inputs(np.random.default_rng(0), H=64, Wc=256,
                                  n=4))
    with pytest.raises(ValueError, match="no patch gather"):
        orb.extract_patches_canvas(canvas, bi, ys, xs)


@pytest.mark.cuda
def test_argmin_ties_first_index_on_card():
    """bow_vector's word votes take the first of tied Hamming minima on the
    card too, as jnp.argmin does (tests/test_torch_relocalization.py pins
    the CPU side)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.models import vocab
    d = torch.randint(0, 4, (512, 300), device="cuda")
    d[:, [7, 11]] = -1
    assert bool((torch.argmin(d, dim=1) == 7).all())
    cb = vocab.make_codebook(16, device="cuda")
    cb[9] = cb[2]
    h = vocab.bow_vector(cb, cb[[2, 2]],
                         torch.ones(2, dtype=torch.bool, device="cuda"))
    assert h[2].item() == pytest.approx(2 / 3)
    assert h[9].item() == pytest.approx(1 / 3)


def _ring_graph(K=64, n_pad=40):
    """A drifted ring of K poses with one loop edge and weight-0 padding
    edges into block (0, 0), as float32 numpy."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(3)
    a = 2 * np.pi * np.arange(K) / K
    R = np.stack([Rotation.from_euler("y", x).as_matrix().T for x in a])
    c = np.stack([10 * np.sin(a), 0 * a, 10 * (1 - np.cos(a))], -1)
    t = -np.einsum("kij,kj->ki", R, c)
    e_i = np.r_[np.arange(1, K), K - 1, np.zeros(n_pad, int)]
    e_j = np.r_[np.arange(0, K - 1), 0, np.zeros(n_pad, int)]
    e_R = np.einsum("eij,ekj->eik", R[e_i], R[e_j])
    e_t = t[e_i] - np.einsum("eij,ej->ei", e_R, t[e_j])
    e_w = np.r_[np.full(K - 1, 10.0), 20.0, np.zeros(n_pad)]
    drift = Rotation.from_rotvec(
        np.cumsum(rng.normal(0, 0.004, (K, 3)), 0)).as_matrix()
    R0 = np.einsum("kij,kjl->kil", drift, R)
    t0 = t + np.cumsum(rng.normal(0, 0.02, (K, 3)), 0)
    f32 = np.float32
    return (R0.astype(f32), t0.astype(f32), np.arange(K) == 0, e_i, e_j,
            e_R.astype(f32), e_t.astype(f32), e_w.astype(f32), e_w > 0)


@pytest.mark.cuda
def test_pose_graph_card_against_cpu():
    """The pose graph's block sums are float index_add_s with many edges per
    block: on the card they add in no fixed order, so the card's result is
    held to the CPU's at 1e-4 in rotation and 1e-3 in translation (ring of
    radius 10), not bit for bit; true float32 products (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.ops import pose_graph
    args = [torch.from_numpy(a) for a in _ring_graph()]
    cpu = pose_graph.optimize_pose_graph(*args, n_iters=10)
    card = pose_graph.optimize_pose_graph(*[a.cuda() for a in args],
                                          n_iters=10)
    assert card.R.is_cuda and not torch.backends.cuda.matmul.allow_tf32
    np.testing.assert_allclose(card.R.cpu().numpy(), cpu.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(card.t.cpu().numpy(), cpu.t.numpy(), atol=1e-3)
    assert float(cpu.final_cost) < 1e-2


@pytest.mark.cuda
def test_deferred_fetch_on_card():
    """A dispatched result lands in pinned host memory behind an event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.pipeline.loop_closing import _Deferred
    x = torch.arange(48, dtype=torch.float32, device="cuda").reshape(3, 16)
    d = _Deferred(x * 2)
    assert d.host.is_pinned() and d.event is not None
    np.testing.assert_array_equal(d.get(), 2 * np.arange(48).reshape(3, 16))


def _imu_rows(rng, n_int, rows):
    m = rng.normal(0, 0.3, (n_int, rows, 7)).astype(np.float32)
    m[..., 0] = 0.005
    m[..., 2] += 9.81
    valid = np.ones((n_int, rows), bool)
    valid[-1, rows // 2:] = False
    return m, valid


@pytest.mark.cuda
def test_imu_integrate_card_against_cpu():
    """The preintegration's recurrences on the card against the CPU, five
    intervals of 60 rows: float32, 60 dependent 9x9 products, so 1e-4 of
    each field's largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.ops import imu
    m, valid = _imu_rows(np.random.default_rng(2), 5, 60)
    bias = torch.tensor([0.01, -0.02, 0.005, 0.05, 0.02, -0.03])
    noise = (1e-3, 1e-2, 1e-6, 1e-4)
    cpu = imu.integrate(bias, torch.from_numpy(m), torch.from_numpy(valid),
                        *noise)
    card = imu.integrate(bias.cuda(), torch.from_numpy(m).cuda(),
                         torch.from_numpy(valid).cuda(), *noise)
    for k in imu.PreintState._fields:
        a, b = getattr(cpu, k), getattr(card, k)
        assert b.is_cuda, k
        gap = float((a - b.cpu()).abs().max() / a.abs().max().clamp(min=1e-30))
        assert gap < 1e-4, (k, gap)
    Lc = imu.sqrt_information(cpu)
    Lg = imu.sqrt_information(card).cpu()
    r = torch.full((9,), 1e-3)
    wc, wg = Lc.transpose(-1, -2) @ r, Lg.transpose(-1, -2) @ r
    assert float((wc - wg).norm() / wc.norm()) < 2e-2   # cuSOLVER vs LAPACK


@pytest.mark.cuda
def test_vi_window_ba_card_against_cpu():
    """The visual-inertial window BA on the card against the CPU on a
    simulated window (5 keyframes, 150 points seen by all, two anchor
    cameras). Five float32 Schur steps, sums added atomically on the card:
    rotations and positions 2e-3, points 5e-3, gravity 2e-2 of 9.81."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.ops import imu, inertial_opt, lie
    rng = np.random.default_rng(3)
    W, n_a, n_pts, rows = 5, 2, 150, 40
    n_kf = W + n_a
    f32 = torch.float32
    # a gentle motion sampled at 200 Hz, gravity along -z
    dt = 0.005
    t = np.arange((n_kf - 1) * rows + 1) * dt
    p = np.stack([0.4 * t, 0.1 * np.sin(2 * t), 0.2 * t * t], -1)
    v = np.gradient(p, dt, axis=0)
    a = np.gradient(v, dt, axis=0)
    meas = np.zeros(((n_kf - 1) * rows, 7), np.float32)
    meas[:, 0] = dt
    meas[:, 1:4] = a[:-1] + [0.0, 0.0, 9.81]           # R = I throughout
    kf = np.arange(n_kf) * rows
    X = rng.uniform(-4, 4, (n_pts, 3)) + [0, 0, 10.0]
    fx, cx, cy, bf = 400.0, 320.0, 240.0, 40.0
    Xc = X[None] - p[kf][:, None]
    uv = np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx,
                   fx * Xc[..., 1] / Xc[..., 2] + cy], -1)
    uv += rng.normal(0, 0.05, uv.shape)
    ur = uv[..., 0] - bf / Xc[..., 2]
    pt = np.tile(np.arange(n_pts), (n_kf, 1))
    cam = np.repeat(np.arange(n_kf)[:, None], n_pts, 1)
    p_w = p[kf][n_a:] + np.r_[np.zeros((1, 3)),
                              rng.normal(0, 0.05, (W - 1, 3))]
    v_w = v[kf][n_a:] + rng.normal(0, 0.1, (W, 3))
    Xp = X + rng.normal(0, 0.05, X.shape)

    def run(dev):
        def T(x, dtype=f32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        sts = imu.integrate(
            torch.zeros(6, device=dev),
            T(meas.reshape(n_kf - 1, rows, 7)[n_a:]),
            torch.ones(W - 1, rows, dtype=torch.bool, device=dev),
            1e-3, 1e-2, 1e-6, 1e-5)
        ones = torch.ones
        return inertial_opt.vi_window_ba(
            0, T([fx, fx, cx, cy, 0, 0, 0, 0]), bf,
            torch.eye(3, device=dev).repeat(W, 1, 1), T(p_w), T(v_w),
            ones(W, dtype=torch.bool, device=dev), sts,
            ones(W - 1, dtype=torch.bool, device=dev),
            torch.zeros(3, device=dev), torch.zeros(3, device=dev),
            T([0.0, 0.0, -9.81]), T(Xp),
            T(pt[n_a:].reshape(-1), torch.long),
            T((cam[n_a:] - n_a).reshape(-1), torch.long),
            T(uv[n_a:].reshape(-1, 2)), T(ur[n_a:].reshape(-1)),
            ones(W * n_pts, device=dev),
            ones(W * n_pts, dtype=torch.bool, device=dev),
            torch.eye(3, device=dev).repeat(n_a, 1, 1), T(-p[kf][:n_a]),
            T(cam[:n_a].reshape(-1), torch.long),
            T(pt[:n_a].reshape(-1), torch.long), T(uv[:n_a].reshape(-1, 2)),
            T(ur[:n_a].reshape(-1)), ones(n_a * n_pts, device=dev),
            ones(n_a * n_pts, dtype=torch.bool, device=dev),
            walk_info=torch.full((6,), 1e6, device=dev))
    cpu, card = run("cpu"), run("cuda")
    assert card.R_wb.is_cuda
    eye = torch.eye(3)
    assert float((card.R_wb.cpu() @ cpu.R_wb.transpose(-1, -2) - eye)
                 .abs().max()) < 2e-3
    for name, tol in (("p_wb", 2e-3), ("vels", 1e-2), ("mp_pos", 5e-3),
                      ("g", 0.2), ("bg", 2e-3), ("ba", 2e-2)):
        gap = float((getattr(card, name).cpu() - getattr(cpu, name))
                    .abs().max())
        assert gap < tol, (name, gap)
    # and both pulled the window back to the truth
    truth = torch.as_tensor(p[kf][n_a:], dtype=f32)
    assert float((card.p_wb.cpu() - truth).abs().max()) < 0.05
    assert float(lie.so3_log(card.R_wb.cpu()).abs().max()) < 5e-3


KB8_TUMVI = [190.97847715128717, 190.9733070521226, 254.93170605935475,
             256.8974428996504, 0.0034823894022493434, 0.0007150348452162257,
             -0.0020532361418706202, 0.00020293673591811182]


@pytest.mark.cuda
def test_kb8_card_against_cpu():
    """KB8 projection, its Jacobian and the 10-step Newton unprojection on
    the card against the CPU: float32 elementwise arithmetic, so 1e-4 px
    and 1e-5 in the bearing (the card's transcendental functions round
    differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.ops import cameras
    rng = np.random.default_rng(4)
    th = rng.uniform(0.0, np.radians(80), 4096)
    ph = rng.uniform(-np.pi, np.pi, 4096)
    X = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], -1) * rng.uniform(0.5, 8, (4096, 1))
    p = torch.tensor(KB8_TUMVI)
    X = torch.from_numpy(X.astype(np.float32))
    for fn, arg, tol in (("kb8_project", X, 1e-3),
                         ("kb8_project_jac", X, 1e-3)):
        cpu = getattr(cameras, fn)(p, arg)
        card = getattr(cameras, fn)(p.cuda(), arg.cuda())
        assert card.is_cuda
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(),
                                   rtol=1e-5, atol=tol)
    uv = cameras.kb8_project(p, X)
    cpu = cameras.project(cameras.KB8, p, cameras.unproject(cameras.KB8, p,
                                                            uv))
    card = cameras.project(cameras.KB8, p.cuda(),
                           cameras.unproject(cameras.KB8, p.cuda(),
                                             uv.cuda()))
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=1e-3)
    np.testing.assert_allclose(card.cpu().numpy(), uv.numpy(), atol=2e-3)


def _mono_view(seed=0, H=384, W=1248, fx=718.856):
    from ms_slam_tpu_torch.utils import synth
    rng = np.random.default_rng(seed)
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
    T = synth.make_trajectory(30, "arc")[3]
    img, depth = world.render_rgbd(K, T, H, W)
    img = np.clip(img + rng.normal(0, 2.0, img.shape), 0, 255)
    return img.astype(np.uint8), depth.astype(np.float32), fx


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["mono", "rgbd"])
def test_mono_rgbd_frontend_card_against_cpu(sensor):
    """process_mono / process_rgbd at full width (one 1248x384 image, 2048
    features, 8 levels: the kernel at B = 1, n = 2048) on the card against
    the CPU's plain path: one kernel launch, >= 99% of keypoints identical,
    and on those the descriptors bit for bit and (RGB-D) the depth bit for
    bit and u_right within 1e-6 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.pipeline import frontend
    img, depth, fx = _mono_view()
    calib = frontend.Calib(model=0, params=(fx, fx, 624.0, 192.0),
                           bf=fx * 0.537, width=1248, height=384,
                           th_depth=0.537 * 40)
    cfg = orb.OrbConfig(n_features=2048, n_levels=8)

    def run(dev):
        im = torch.from_numpy(img).to(dev)
        if sensor == "mono":
            return frontend.process_mono(im, calib, cfg)
        return frontend.process_rgbd(im, torch.from_numpy(depth).to(dev),
                                     calib, cfg)
    cpu = run("cpu")
    before = _native.calls[F32]
    card = run("cuda")
    torch.cuda.synchronize()
    assert _native.calls[F32] == before + 1
    fc, fg = cpu.feats, card.feats
    same = ((fc.xy == fg.xy.cpu()).all(1) & (fc.octave == fg.octave.cpu())
            & (fc.valid == fg.valid.cpu()))
    assert float(same.float().mean()) >= 0.99
    assert int(fc.valid.sum()) > 1000
    assert torch.equal(fc.desc[same], fg.desc.cpu()[same])
    if sensor == "rgbd":
        assert torch.equal(cpu.depth[same], card.depth.cpu()[same])
        np.testing.assert_allclose(card.u_right.cpu()[same].numpy(),
                                   cpu.u_right[same].numpy(), rtol=1e-6)


@pytest.mark.cuda
def test_twoview_reconstruct_card_against_cpu():
    """reconstruct_from_hypotheses on the card and on the CPU from one
    injected (256, 8) table (cuSOLVER's batched SVDs against LAPACK's): the
    same ok, rotation within 1e-3 rad, translation direction within 1e-3
    and at most 1% of the inlier flags differing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from scipy.spatial.transform import Rotation

    from ms_slam_tpu_torch.ops import twoview
    rng = np.random.default_rng(5)
    fx, W, H, N = 260.0, 320, 240, 600
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                  rng.uniform(6, 16, N)], -1)
    R2 = Rotation.from_euler("y", 0.05).as_matrix()
    t2 = np.array([-0.6, 0.05, 0.1])

    def proj(Xc):
        return np.stack([fx * Xc[:, 0] / Xc[:, 2] + W / 2,
                         fx * Xc[:, 1] / Xc[:, 2] + H / 2], -1)
    xy1 = proj(X) + rng.normal(0, 0.3, (N, 2))
    xy2 = proj(X @ R2.T + t2) + rng.normal(0, 0.3, (N, 2))
    valid = np.ones(N, bool)
    valid[::10] = False
    idx = rng.choice(np.flatnonzero(valid), (256, 8))
    args = [torch.tensor([fx, fx, W / 2, H / 2, 0, 0, 0, 0]),
            torch.from_numpy(xy1.astype(np.float32)),
            torch.from_numpy(xy2.astype(np.float32)),
            torch.from_numpy(valid), torch.from_numpy(idx)]
    cpu = twoview.reconstruct_from_hypotheses(0, *args)
    card = twoview.reconstruct_from_hypotheses(0, *[a.cuda() for a in args])
    assert card.R.is_cuda and bool(cpu.ok) and bool(card.ok)
    Rc, Rg = cpu.R.numpy(), card.R.cpu().numpy()
    ang = np.arccos(np.clip((np.trace(Rg @ Rc.T) - 1) / 2, -1, 1))
    assert ang < 1e-3
    assert np.linalg.norm(card.t.cpu().numpy() - cpu.t.numpy()) < 1e-3
    assert (card.inlier.cpu() != cpu.inlier).float().mean() <= 0.01
    ang_gt = np.arccos(np.clip((np.trace(Rg @ R2.T) - 1) / 2, -1, 1))
    assert np.degrees(ang_gt) < 1.0


def _saved_map(path):
    """A checkpoint written from a CPU System whose map holds random live
    keyframes, points and observations (no frame is tracked)."""
    from ms_slam_tpu_torch.models.map_state import (MapConfig,
                                                    map_state_from_numpy,
                                                    map_state_to_numpy)
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
    from ms_slam_tpu_torch.utils import checkpoint
    rng = np.random.default_rng(8)
    K, M, N = 16, 512, 64
    cfg = SystemConfig(
        calib=Calib(model=0, params=(260.0, 260.0, 160.0, 120.0), bf=39.0,
                    width=320, height=240),
        orb=OrbConfig(n_features=N, n_levels=4),
        map=MapConfig(max_kf=K, max_mp=M, n_feat=N, local_mp_cap=256),
        sparsify=True)

    def make(device):
        return System(cfg, device=device)
    slam = make("cpu")
    d = map_state_to_numpy(slam.ms)
    d["kf_valid"][:10] = True
    d["kf_t"][:10] = rng.normal(size=(10, 3))
    d["kp_valid"][:10] = rng.random((10, N)) < 0.8
    d["kp_xy"][:10] = rng.uniform(0, 240, (10, N, 2))
    d["kp_desc"][:10] = rng.integers(0, 2 ** 32, (10, N, 8), dtype=np.uint32)
    d["mp_valid"][:300] = True
    d["mp_pos"][:300] = rng.normal(size=(300, 3))
    d["mp_sparsified"][:300] = rng.random(300) < 0.5
    d["obs_mp"][:10] = np.where(d["kp_valid"][:10],
                                rng.integers(0, 300, (10, N)), -1)
    slam.ms = map_state_from_numpy(d)
    slam.n_kf, slam.n_mp, slam.kf_ord = 10, 300, 10
    slam.kf_order = list(range(10))
    slam.kf_db.rows[:10] = torch.from_numpy(
        rng.random((10, slam.kf_db.rows.shape[1])).astype(np.float32))
    slam.kf_db.present[[2, 5]] = True
    checkpoint.save_map(path, slam)
    return make


@pytest.mark.cuda
def test_load_map_on_card_equals_cpu(tmp_path):
    """utils.checkpoint.load_map onto the card: the map lands on the card
    and equals the CPU load field for field, dtype for dtype; the database
    rows follow the database onto the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.models.map_state import map_state_to_numpy
    from ms_slam_tpu_torch.utils import checkpoint
    path = str(tmp_path / "map.npz")
    make = _saved_map(path)
    cpu, card = make("cpu"), make("cuda")
    checkpoint.load_map(path, cpu)
    checkpoint.load_map(path, card)
    assert all(t.is_cuda for t in card.ms) and card.kf_db.rows.is_cuda
    a, b = map_state_to_numpy(card.ms), map_state_to_numpy(cpu.ms)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(card.kf_db.rows.cpu().numpy(),
                                  cpu.kf_db.rows.numpy())
    assert card.state == cpu.state == "LOST"
    assert card.map_points_in_map() == cpu.map_points_in_map() == 300
    assert card.compressed_map_points_in_map() == \
        cpu.compressed_map_points_in_map()


@pytest.mark.cuda
def test_map_snapshot_from_card_map(tmp_path):
    """utils.viewer.MapSnapshot reads a map on the card (explicit host
    copies) and writes the PLY the CPU map gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.utils import checkpoint, viewer
    path = str(tmp_path / "map.npz")
    make = _saved_map(path)
    for device in ("cpu", "cuda"):
        slam = make(device)
        checkpoint.load_map(path, slam)
        snap = viewer.MapSnapshot.from_system(slam)
        snap.save_ply(str(tmp_path / f"{device}.ply"))
    assert int(snap.mp_valid.sum() + snap.kf_valid.sum()) == 310
    assert (tmp_path / "cuda.ply").read_bytes() == \
        (tmp_path / "cpu.ply").read_bytes()


def _dist_bundle(rng, n_cams=6, n_pts=400, noise=0.2):
    """tests/test_ba.py's make_bundle without jax: cameras on an arc looking
    at a point cloud, stereo observations with `noise` px; then the cameras
    but the first two moved by 5 cm and the points by 2 cm."""
    from ms_slam_tpu_torch.ops import cameras, lie
    pin = torch.tensor([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0],
                       dtype=torch.float64)
    bf = 40.0
    P = rng.uniform(-5, 5, (n_pts, 3))
    P[:, 2] += 12.0
    xi = torch.from_numpy(np.stack([np.array(
        [0.8, 0.05, 0.02, 0.01, 0.03, -0.01]) * 0.3 * c
        for c in range(n_cams)]))
    Rs, ts = lie.se3_exp(xi)
    f_cam, f_pt, f_uv, f_ur = [], [], [], []
    for c in range(n_cams):
        Xc = P @ Rs[c].numpy().T + ts[c].numpy()
        uv = cameras.project(0, pin, torch.from_numpy(Xc)).numpy()
        vis = (Xc[:, 2] > 1) & (uv[:, 0] > 0) & (uv[:, 0] < 640) \
            & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        for p in np.flatnonzero(vis):
            f_cam.append(c)
            f_pt.append(p)
            f_uv.append(uv[p] + rng.normal(0, noise, 2))
            f_ur.append(uv[p, 0] - bf / Xc[p, 2] + rng.normal(0, noise))
    F = len(f_cam)
    cam_opt = np.ones(n_cams, bool)
    cam_opt[:2] = False
    tp = ts.numpy() + np.concatenate(
        [np.zeros((2, 3)), rng.normal(0, 0.05, (n_cams - 2, 3))])
    return {"truth": ts.numpy(), "pin": pin, "bf": bf,
            "args": [Rs, torch.from_numpy(tp), torch.from_numpy(cam_opt),
                     torch.from_numpy(P + rng.normal(0, 0.02, P.shape)),
                     torch.ones(n_pts, dtype=torch.bool)],
            "fargs": [torch.tensor(f_cam), torch.tensor(f_pt),
                      torch.from_numpy(np.asarray(f_uv)),
                      torch.from_numpy(np.asarray(f_ur)),
                      torch.ones(F, dtype=torch.float64),
                      torch.ones(F, dtype=torch.bool)]}


def _dist_cost(b, R, t, P):
    """Sum of squared reprojection residuals (float64, on the CPU)."""
    from ms_slam_tpu_torch.ops.ba import _factor_res_jac
    f_cam, f_pt, f_uv, f_ur = b["fargs"][:4]
    res, _, _, _ = _factor_res_jac(
        0, b["pin"], b["bf"], R.cpu().double(), t.cpu().double(),
        P.cpu().double(), f_cam, f_pt, f_uv, f_ur, f_ur >= 0)
    return float((res * res).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4])
def test_dist_ba_solve_card_against_cpu(D):
    """parallel.dist_ba_solve in float32 on D shards of cuda:0 against the
    float64 CPU run on one shard, by cost: the card's index_add_ sums in no
    fixed order and the CG in float32 is sensitive to that order in the
    gauge subspace (tests/test_dist_ba.py says so of the reference), so the
    card is held to the CPU's final cost within 1% of the starting cost and
    to the true cameras within 0.02 m, not pose for pose."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.parallel import dist_ba
    b = _dist_bundle(np.random.default_rng(0))
    cpu = dist_ba.dist_ba_solve(dist_ba.make_mesh(1, ["cpu"]), 0, b["pin"],
                                b["bf"], *b["args"], *b["fargs"], n_iters=6)
    card_args = [a.cuda().float() if a.is_floating_point() else a.cuda()
                 for a in b["args"]]
    card = dist_ba.dist_ba_solve(
        dist_ba.make_mesh(D, [torch.device("cuda", 0)] * D), 0, b["pin"],
        b["bf"], *card_args, *[a.cuda() for a in b["fargs"]], n_iters=6)
    assert all(x.is_cuda and x.dtype == torch.float32 for x in card)
    c0 = _dist_cost(b, *b["args"][:2], b["args"][3])
    c_cpu, c_card = _dist_cost(b, *cpu[:3]), _dist_cost(b, *card[:3])
    assert c_card < 0.05 * c0 and abs(c_card - c_cpu) < 0.01 * c0, \
        (c_card, c_cpu, c0)
    for c in range(2, 6):
        assert np.linalg.norm(card[1][c].cpu().numpy() - b["truth"][c]) < 0.02
    assert float(card[3][-1]) < 1e-2


@pytest.mark.cuda
def test_make_mesh_counts_the_cards():
    """With no device list a mesh takes one card a shard and raises when
    the machine has fewer cards than asked for (one H100: make_mesh(2)
    raises); it never takes the CPU instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ms_slam_tpu_torch.parallel import dist_ba
    n = torch.cuda.device_count()
    if n < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            dist_ba.make_mesh(2)
    else:
        assert dist_ba.make_mesh(2).devices == (torch.device("cuda", 0),
                                                torch.device("cuda", 1))
    assert dist_ba.make_mesh().devices == tuple(
        torch.device("cuda", i) for i in range(n))


@pytest.mark.cuda
def test_patch_gather_stack_shape_on_card():
    """The stack extractor's call: a (2*8, 384, 1248) stack of level planes,
    2 x 2048 keypoints whose image index is their plane, through
    `extract_patches` (centres from the low clip edge up and beyond the
    high ones)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(2)
    P, H, W, n = 16, 384, 1248, 4096
    stack = torch.from_numpy(rng.uniform(0, 255, (P, H, W))
                             .astype(np.float32)).cuda()
    lv = torch.from_numpy(rng.integers(0, P, n).astype(np.int32)).cuda()
    ys = torch.from_numpy(rng.integers(22, H + 8, n).astype(np.int32)).cuda()
    xs = torch.from_numpy(rng.integers(22, W + 8, n).astype(np.int32)).cuda()
    before = _native.calls[F32]
    out = orb.extract_patches(stack, lv, ys, xs)
    torch.cuda.synchronize()
    assert _native.calls[F32] == before + 1
    assert torch.equal(out, orb.extract_patches_canvas_plain(stack, lv, ys,
                                                             xs))


@pytest.mark.cuda
def test_prefetch_on_side_stream_matches_sync_frontend_on_card():
    """System._prefetch_frontend on the worker thread (side stream, pinned
    upload, an event the tracking stream waits on) gives the FrameData of
    the synchronous frontend on the same frame, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ms_slam_tpu_torch.models.map_state import MapConfig
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
    from ms_slam_tpu_torch.utils import synth
    H, W, FX, BL = 240, 320, 260.0, 0.15
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                  width=W, height=H, th_depth=BL * 40, fps=10.0)
    slam = System(SystemConfig(
        calib=calib, orb=orb.OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=16, max_mp=2048, n_feat=512,
                      local_mp_cap=1024)), device="cuda")
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    l, r = (np.clip(im, 0, 255).astype(np.uint8) for im in
            world.render_stereo(K, synth.make_trajectory(30, "arc")[3], BL,
                                H, W))
    sync = slam._dispatch_frontend(l, r)
    before = _native.calls[F32]
    slam._next_images = (l, r)
    slam._prefetch_next()                      # on the worker thread
    slam._next_images = None
    frame = slam._take_prefetched()
    assert slam.prefetch_hits == 1 and slam._side_stream is not None
    assert _native.calls[F32] == before + 1
    for name, a, b in zip(("feats", "u_right", "depth", "sigma2"), frame,
                          sync):
        pairs = zip(a, b) if name == "feats" else [(a, b)]
        for x, y in pairs:
            assert torch.equal(x, y), name
    slam.shutdown()
