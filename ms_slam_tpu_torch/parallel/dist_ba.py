"""Distributed bundle adjustment over a mesh of devices.

Port of `ms_slam_tpu/parallel/dist_ba.py`, the reference's scale-out path
for the post-loop global BA. Sharding design (the reference's v2):

- The factor table is routed on the host so that every observation of a map
  point lands on the shard that OWNS that point (point-range ownership:
  shard d owns points [d*Pp, (d+1)*Pp)). Jacobian work is ~1/D, and the
  per-point Hessian blocks Hpp/bp need no collective: all their
  contributions are local.
- The reduced camera system S = Hcc - Wᵀ Hpp⁻¹ W is never formed (the
  reference records that the dense (P, C, 6, 3) coupling it replaced took
  ~2.4 GB at 512 keyframes and 65,536 points). A preconditioned CG runs on
  the (C, 6) camera system instead; each product with S is two per-factor
  passes and ONE sum over the shards of a (C, 6) vector.
- Cameras (tiny) stay replicated; point updates are computed on their owner
  and reassembled by the same sum.

The reference runs all of it as one jit over `shard_map`. Here a mesh is a
tuple of torch devices, one per shard (a device may hold several shards);
each shard's work is launched on its device in turn, replicated values are
held once per distinct device, and `_psum` is the one place where shards
exchange data. Nothing inside the solve waits for the device: the CG's
freeze flag, its residuals and the ratios stay tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie, robust
from ..ops.ba import _diag_damp, _factor_res_jac

# the shards a CPU System may take: the reference's CPU tests see 8 virtual
# devices (tests/conftest.py)
CPU_SHARDS = 8


class Mesh(NamedTuple):
    """The device of each shard, and the axis name of the reference's mesh."""
    devices: tuple
    axis: str = "factors"

    @property
    def places(self) -> tuple:
        """The distinct devices, in the order the shards first name them;
        replicated values hold one tensor per place."""
        return tuple(dict.fromkeys(self.devices))


def devices_offered(device) -> list:
    """The devices a mesh may take for a System on `device`: every CUDA card
    of the machine for a card System (one H100 offers one), CPU_SHARDS
    shards of the CPU for a CPU System."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device] * CPU_SHARDS


def make_mesh(n_devices: int | None = None, devices=None, *,
              axis: str = "factors") -> Mesh:
    """A mesh of `n_devices` shards. With no `devices`, shard d runs on
    cuda:d and fewer cards than asked for raise: the mesh never drops to
    the CPU. An explicit `devices` list may name one device several times
    (["cpu"] * 8 is the counterpart of the reference's 8 virtual CPU
    devices, [cuda:0] * 4 puts four shards on one card)."""
    if devices is None:
        n_cards = torch.cuda.device_count()
        n = n_cards if n_devices is None else n_devices
        if n < 1 or n_cards < n:
            raise RuntimeError(f"make_mesh: {n} CUDA devices asked for, "
                               f"{n_cards} present")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(f"make_mesh: {n_devices} shards asked for, "
                                 f"{len(devices)} devices given")
            devices = devices[:n_devices]
    return Mesh(tuple(devices), axis)


def shard_factors(mesh: Mesh, *arrays, axis: str = "factors"):
    """Split each array's leading dimension into one equal block per shard,
    block d on shard d's device. Returns a tuple of D blocks per array."""
    D = len(mesh.devices)
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        if a.shape[0] % D:
            raise ValueError(f"shard_factors: {a.shape[0]} rows do not "
                             f"split into {D} shards")
        blocks = a.view(D, a.shape[0] // D, *a.shape[1:])
        out.append(tuple(blocks[d].to(dev)
                         for d, dev in enumerate(mesh.devices)))
    return tuple(out)


def replicate(mesh: Mesh, *arrays):
    """A copy of each array on every distinct device of the mesh (shards on
    one device share it). Returns a tuple per array, in `mesh.places`
    order."""
    return tuple(tuple(torch.as_tensor(a).to(dev) for dev in mesh.places)
                 for a in arrays)


def _psum(mesh: Mesh, parts):
    """The sum over the shards (the reference's `jax.lax.psum`): every
    shard's partial goes to the first device, the partials are added in
    shard order, so that the result does not depend on where the shards
    sit, and every distinct device gets a copy (a no-op on the first one).
    The only exchange between shards."""
    home = mesh.devices[0]
    total = parts[0].to(home)
    for p in parts[1:]:
        total = total + p.to(home)
    return [total.to(dev) for dev in mesh.places]


def route_factors_by_point(n_devices: int, Pn: int, f_pt, f_valid,
                           *arrays):
    """Host-side routing: reorder factor rows so device d receives exactly
    the factors of its owned point range [d*Pp, (d+1)*Pp), padded to a
    common per-device capacity. Invalid rows are spread round-robin (they
    carry zero weight). Returns (Pp, routed_f_pt, routed_f_valid,
    routed_arrays), each with leading dim D * F_cap."""
    D = n_devices
    Pp = -(-Pn // D)
    f_pt = np.asarray(f_pt)
    f_valid = np.asarray(f_valid)
    F = f_pt.shape[0]
    shard = np.where(f_valid, f_pt // Pp, np.arange(F) % D).astype(np.int64)
    counts = np.bincount(shard, minlength=D)
    F_cap = max(int(counts.max()), 1)
    order = np.argsort(shard, kind="stable")
    starts = np.zeros(D, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    # position of each (sorted) row inside its device block
    pos_in_shard = np.arange(F) - starts[shard[order]]
    dst = shard[order] * F_cap + pos_in_shard
    idx = np.full(D * F_cap, -1, np.int64)
    idx[dst] = order
    pad = idx < 0
    gi = np.where(pad, 0, idx)
    routed_pt = np.where(pad, 0, f_pt[gi]).astype(np.int32)
    routed_valid = np.where(pad, False, f_valid[gi])
    routed = [np.asarray(a)[gi] for a in arrays]
    return Pp, routed_pt, routed_valid, routed


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _mtv(A, x):
    """Aᵀ x over a batch: (F, i, j), (F, i) -> (F, j)."""
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


class _Shard(NamedTuple):
    """One shard's routed factors and the constants made from them."""
    place: int              # index of its device in mesh.places
    p_lo: int               # first owned point
    f_cam: torch.Tensor
    f_pt: torch.Tensor      # global point index
    f_ptl: torch.Tensor     # local point index, clipped
    f_uv: torch.Tensor
    f_ur: torch.Tensor
    is_stereo: torch.Tensor
    w_info: torch.Tensor
    hub_d2: torch.Tensor
    pt_opt_l: torch.Tensor  # (Pp,) owned points that move


def dist_ba_solve(mesh: Mesh, model: int, params, bf,
                  kf_R, kf_t, cam_opt, mp_pos, pt_opt,
                  f_cam, f_pt, f_uv, f_ur, f_sigma2, f_valid,
                  n_iters: int = 10, lam: float = 1e-4,
                  axis: str = "factors", n_cg: int | None = None):
    """Sharded ba_solve: same semantics as the window BA's iteration (no
    two-stage outlier schedule), factors routed by point ownership and the
    reduced camera system solved by preconditioned CG.
    Returns (kf_R, kf_t, mp_pos, cg_ratios) on the mesh's first device;
    cg_ratios (n_iters,) is each iteration's final preconditioned residual
    over its first."""
    C = kf_R.shape[0]
    Pn = mp_pos.shape[0]
    dt = kf_R.dtype
    D = len(mesh.devices)
    places = mesh.places
    if n_cg is None:
        # the CG budget grows with the camera system: large post-loop
        # global BAs (C*6 in the thousands) under-converge on a fixed cap
        n_cg = min(C * 6, max(96, (C * 6) // 8))

    # sync: the routing is host work, as in the reference; the tables are
    # then gathered on their own device in the routed order
    Pp, f_pt_r, f_valid_r, (gi,) = route_factors_by_point(
        D, Pn, _host(f_pt), _host(f_valid), np.arange(f_pt.shape[0]))

    def routed(a):
        a = torch.as_tensor(a)
        return a[torch.from_numpy(gi).to(a.device)]
    cams, pts, uvs, urs, s2s, valids = shard_factors(
        mesh, routed(f_cam).long(), torch.from_numpy(f_pt_r).long(),
        routed(f_uv).to(dt), routed(f_ur).to(dt), routed(f_sigma2).to(dt),
        torch.from_numpy(f_valid_r), axis=axis)
    params_q, bf_q, R_q, t_q, cam_opt_q, P_q, pt_opt_q = replicate(
        mesh, torch.as_tensor(params, dtype=dt),
        torch.as_tensor(bf, dtype=dt), kf_R, kf_t, cam_opt, mp_pos, pt_opt)
    R_q, t_q, P_q = list(R_q), list(t_q), list(P_q)

    shards = []
    for d, dev in enumerate(mesh.devices):
        q = places.index(dev)
        p_lo = d * Pp
        # local point index of each factor (all factors of an owned point
        # are local by construction; zero-weight rows may fall anywhere)
        f_ptl = torch.clamp(pts[d] - p_lo, 0, Pp - 1)
        pt_opt_l = torch.cat([pt_opt_q[q], torch.zeros(
            D * Pp - Pn, dtype=torch.bool, device=dev)])[p_lo:p_lo + Pp]
        is_stereo = urs[d] >= 0.0
        w_info = torch.where(valids[d],
                             1.0 / torch.clamp(s2s[d], min=1e-12), 0.0)
        hub_d2 = torch.where(
            is_stereo, torch.full_like(w_info, robust.CHI2_3DOF),
            torch.full_like(w_info, robust.CHI2_2DOF))
        shards.append(_Shard(q, p_lo, cams[d], pts[d], f_ptl, uvs[d],
                             urs[d], is_stereo, w_info, hub_d2, pt_opt_l))

    def zeros(n, *shape, dev):
        return torch.zeros((n, *shape), dtype=dt, device=dev)

    rel_stop = torch.finfo(dt).eps ** 2
    ratios = []
    for _ in range(n_iters):
        lin, Hcc_parts, bc_parts = [], [], []
        for s, dev in zip(shards, mesh.devices):
            q = s.place
            res, Jc, Jp, z = _factor_res_jac(
                model, params_q[q], bf_q[q], R_q[q], t_q[q], P_q[q],
                s.f_cam, s.f_pt, s.f_uv, s.f_ur, s.is_stereo)
            chi2 = torch.sum(res * res, dim=-1) * s.w_info
            active = z > 1e-2
            w = robust.huber_weight(chi2, s.hub_d2) * s.w_info * active
            Jc = torch.where(cam_opt_q[q][s.f_cam][:, None, None], Jc, 0.0)
            Jp = torch.where(s.pt_opt_l[s.f_ptl][:, None, None], Jp, 0.0)
            sw = torch.sqrt(w)
            Jc = Jc * sw[:, None, None]   # whitened Jacobians: H = JᵀJ
            Jp = Jp * sw[:, None, None]
            rw = res * sw[:, None]
            # camera blocks: summed over the shards (C is small)
            Hcc_parts.append(zeros(C, 6, 6, dev=dev).index_add_(
                0, s.f_cam, Jc.transpose(1, 2) @ Jc))
            bc_parts.append(zeros(C, 6, dev=dev).index_add_(
                0, s.f_cam, -_mtv(Jc, rw)))
            # point blocks: local (point-owned routing)
            Hpp = zeros(Pp, 3, 3, dev=dev).index_add_(
                0, s.f_ptl, Jp.transpose(1, 2) @ Jp)
            bp = zeros(Pp, 3, dev=dev).index_add_(0, s.f_ptl, -_mtv(Jp, rw))
            lin.append((Jc, Jp, lie.inv3x3(_diag_damp(Hpp, lam, 1e-8)), bp))
        Hcc = [_diag_damp(h, lam, 1e-8) for h in _psum(mesh, Hcc_parts)]
        bc = _psum(mesh, bc_parts)

        def W_apply(d, xc):
            """(W x)_p = sum_f Jpᵀ (Jc x_cam): (C,6) -> (Pp,3), local."""
            s, (Jc, Jp, _, _) = shards[d], lin[d]
            u = _mv(Jc, xc[s.f_cam])                         # (F,3)
            return zeros(Pp, 3, dev=u.device).index_add_(
                0, s.f_ptl, _mtv(Jp, u))

        def Wt_apply(zps):
            """(Wᵀ z)_c = sum_f Jcᵀ (Jp z_pt): (Pp,3) per shard -> (C,6)
            per place, summed over the shards."""
            parts = []
            for s, (Jc, Jp, _, _), zp in zip(shards, lin, zps):
                u = _mv(Jp, zp[s.f_ptl])                     # (F,3)
                parts.append(zeros(C, 6, dev=u.device).index_add_(
                    0, s.f_cam, _mtv(Jc, u)))
            return _psum(mesh, parts)

        def S_apply(xs):
            wt = Wt_apply([_mv(lin[d][2], W_apply(d, xs[s.place]))
                           for d, s in enumerate(shards)])
            return [_mv(Hcc[q], xs[q]) - wt[q] + 1e-8 * xs[q]
                    for q in range(len(places))]

        # RHS: v = bc - Wᵀ Hpp⁻¹ bp
        wt = Wt_apply([_mv(Hpp_inv, bp) for _, _, Hpp_inv, bp in lin])
        v = [b - w_ for b, w_ in zip(bc, wt)]
        # preconditioned CG on the (C,6) camera system; M = Hcc blocks
        # (inv_ex: torch.linalg.inv would check for failure on the host)
        Hcc_pinv = [torch.linalg.inv_ex(h).inverse for h in Hcc]

        def cg_update(carry, Sp, M):
            """One CG step on one place's replica, frozen once the
            preconditioned residual has dropped to float precision or the
            curvature goes non-positive (further steps would only amplify
            rounding noise)."""
            x, r, p, rz, rz0, ok = carry
            denom = torch.sum(p * Sp)
            ok = ok & (denom > 0) & (rz > rel_stop * rz0)
            alpha = torch.where(
                ok, rz / torch.where(denom > 0, denom, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * Sp
            zn = _mv(M, r)
            rz_new = torch.where(ok, torch.sum(r * zn), rz)
            ok = ok & (rz_new > 0)
            beta = torch.where(ok, rz_new / torch.where(rz > 0, rz, 1.0),
                               0.0)
            p = torch.where(ok, zn + beta * p, p)
            return x, r, p, rz_new, rz0, ok

        carry = []
        for vq, M in zip(v, Hcc_pinv):
            z0 = _mv(M, vq)
            rz0 = torch.sum(vq * z0)
            carry.append((torch.zeros_like(vq), vq, z0, rz0, rz0, rz0 > 0))
        for _ in range(n_cg):
            Sp = S_apply([c[2] for c in carry])
            carry = [cg_update(c, sp, M)
                     for c, sp, M in zip(carry, Sp, Hcc_pinv)]
        rz_f, rz0 = carry[0][3], carry[0][4]
        ratios.append(torch.sqrt(torch.clamp(rz_f, min=0.0)
                                 / torch.clamp(rz0, min=1e-30)))
        dxc = [c[0] for c in carry]

        # point back-substitution on the owner, reassembled by the sum
        # (each shard contributes only its owned point range)
        parts = []
        for d, (s, (_, _, Hpp_inv, bp)) in enumerate(zip(shards, lin)):
            dxp_l = _mv(Hpp_inv, bp - W_apply(d, dxc[s.place])) \
                * s.pt_opt_l[:, None]
            buf = zeros(D * Pp, 3, dev=dxp_l.device)
            buf[s.p_lo:s.p_lo + Pp] = dxp_l
            parts.append(buf)
        dxp = [a[:Pn] for a in _psum(mesh, parts)]

        for q in range(len(places)):
            dR, dtc = lie.se3_exp(dxc[q] * cam_opt_q[q][:, None])
            R_new, t_new = lie.se3_compose(dR, dtc, R_q[q], t_q[q])
            R_q[q] = lie.normalize_rotation(R_new)
            t_q[q] = t_new
            P_q[q] = P_q[q] + dxp[q]
    return R_q[0], t_q[0], P_q[0], torch.stack(ratios)


def dist_global_ba(ms, calib, orb_cfg, fixed_kf: int, mesh: Mesh,
                   n_iters: int = 10, axis: str = "factors"):
    """Whole-map global BA through the mesh: the pipeline entry point
    (ref Optimizer::GlobalBundleAdjustemnt via RunGlobalBundleAdjustment).
    Builds the same full factor table as pipeline.mapping_ops.global_ba,
    runs the sharded Schur-CG solver and returns the updated MapState (the
    argument's tensors are left as they were)."""
    from ..pipeline.mapping_ops import _scale2

    dev = ms.kf_R.device
    K, N = ms.obs_mp.shape
    obs = ms.obs_mp
    f_valid = (obs >= 0) & ms.kf_valid[:, None] & ms.kp_valid
    f_cam = torch.arange(K, device=dev)[:, None].expand(K, N).reshape(-1)
    f_s2 = _scale2(orb_cfg, dev)[ms.kp_octave.long()].reshape(-1)
    cam_opt = ms.kf_valid & (torch.arange(K, device=dev) != fixed_kf)

    R_n, t_n, P_n, cg_ratios = dist_ba_solve(
        mesh, calib.model, calib.params_array(dev), calib.bf,
        ms.kf_R, ms.kf_t, cam_opt, ms.mp_pos, ms.mp_valid,
        f_cam, obs.clamp(min=0).reshape(-1), ms.kp_xy.reshape(K * N, 2),
        ms.kp_uright.reshape(-1), f_s2, f_valid.reshape(-1),
        n_iters=n_iters, axis=axis)
    # sync: the final preconditioned CG residual ratio, so that an
    # under-converged reduced-camera solve is seen
    last = float(cg_ratios[-1])
    if last > 1e-2:
        print(f"# dist_global_ba: CG residual ratio {last:.3e} "
              f"(under-converged reduced camera solve)")
    return ms._replace(kf_R=R_n.to(dev), kf_t=t_n.to(dev),
                       mp_pos=P_n.to(dev))
