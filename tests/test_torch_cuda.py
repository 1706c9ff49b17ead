"""The patch-gather CUDA kernel against its plain version, and what else
differs on the card (tied argmins, float scatter sums, pinned fetches).

The kernel has no CPU mode, so the tests marked `cuda` skip on a machine
without a card. It needs neither jax nor this directory's conftest.py, so
on a GPU machine that has only PyTorch it runs as

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: bit-exact for the kernel (it is a copy); stated in the test for
the pose graph.
"""
import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import orb

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass


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
    before = orb.patch_gather_launches
    out = orb.extract_patches_canvas(*args)
    torch.cuda.synchronize()
    assert orb.patch_gather_launches == before + 1
    assert out.shape == (args[1].shape[0], 45, 45)
    assert torch.equal(out, orb.extract_patches_canvas_plain(*args))


@pytest.mark.cuda
def test_patch_gather_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = [torch.from_numpy(a).cuda()
            for a in _inputs(np.random.default_rng(0))]
    before = orb.patch_gather_launches
    out = orb.extract_patches_canvas(*args)
    torch.cuda.synchronize()
    assert orb.patch_gather_launches == before + 1
    assert torch.equal(out, orb.extract_patches_canvas_plain(*args))
    with pytest.raises(ValueError):          # f64 canvas: refused, not cast
        orb.extract_patches_canvas(args[0].double(), *args[1:])


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
