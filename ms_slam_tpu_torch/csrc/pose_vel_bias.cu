// The inertial tracking refinement for Hopper (sm_90a): all of
// ops/inertial_opt.py::pose_vel_bias_optimize_plain in one launch.
//
// Replaces no TPU kernel. The JAX package's pose_vel_bias_optimize
// (ms_slam_tpu/ops/inertial_opt.py) is XLA-compiled jnp, which fuses it.
// This kernel exists because the port's H100 profile puts the function on
// the critical path of every inertial frame: written in PyTorch, its 4
// rounds x 6 Gauss-Newton steps launch ~10,000 small kernels a call. The
// host spends ~158 ms a frame dispatching them while the card idles.
//
// The work: the current body state x = [dp, dtheta, dv, dbg, dba] (15
// floats) against N visual matches and the 9-row preintegration factor.
// Each step evaluates every match's reprojection rows and their Jacobians.
// It reduces them to a 6x6 system, adds the whitened inertial factor and
// the bias walk, and solves a 15x15 system. After each round a chi2 re-gate
// decides the inliers.
//
// What bounds it on this card: latency, not bytes or FLOPs. The inputs
// are ~41 KB at the corridor's N = 1,280: 28 floats a match, the state and
// the preintegration. A step is ~0.4 MFLOP. But the 24 steps are
// dependent, and each holds two block-wide reductions: the visual sums,
// then the solve that every thread waits for before the next step.
//
// What the design does about that:
//  - One thread block does the whole call, so a step's reduction and the
//    hand-back of x cost a __syncthreads each and no launch. The matches
//    stay in L1 after the first step. More blocks would need a grid-wide
//    sync per step.
//  - Warp 0 builds the inertial factor (residual, Forster Jacobians,
//    whitening by L^T, J^T J) while warps 1-7 evaluate the visual rows.
//    The factor depends only on x, not on the matches, so its serial 3x3
//    algebra is off the critical path.
//  - Visual rows per thread, in registers. Each thread accumulates the 21
//    unique entries of its matches' 6x6 H and the 6 of g. The left
//    Jacobian J_l of the accumulated rotation is applied once, after the
//    reduction, as T^T H T with T = diag(I, J_l). The reduction is warp
//    shuffles, then one pass over the warps' partial sums in shared memory.
//  - Warp 0 then solves the 15x15 normal equations by LU with partial
//    pivoting, as the plain version's torch.linalg.solve_ex does. One lane
//    owns each row of [H | g]; each column takes a shuffle argmax for the
//    pivot, a row swap and the elimination, three warp syncs. Lane 0 does
//    the back substitution. Cholesky would be cheaper, but it needs a
//    positive pivot at every column, and float32 rounding can take that
//    away when the whitened preintegration information is large
//    (imu.information: tiny-noise covariances are ~1e-8). Its sqrtf then
//    gives NaN where LU gives the plain version's finite step.
//
// The same work in the same precision: float32 throughout, every round and
// step runs, and the formulas and their order are the plain version's.
// Sums run in another order (per thread, then across the block), so the
// results agree to float32 rounding, not bit for bit.
//
// Plain C interface (loaded with ctypes): launches on the given stream, does
// not synchronise, allocates nothing, returns a cudaError_t as an int.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPointThreads = kThreads - 32;   // warps 1..7 take the matches
constexpr int kVis = 27;   // 21 unique entries of the visual 6x6 H, 6 of g
constexpr float kMonoChi2 = 5.991f;     // ops/robust.py CHI2_2DOF
constexpr float kStereoChi2 = 7.815f;   // CHI2_3DOF
constexpr float kSmall2 = 1e-8f;        // ops/lie.py _SMALL2

struct Args {
  int model, n, n_rounds, n_iters;
  float bf;
  const float *params, *R_bc, *t_bc;
  const float *R1, *p1, *v1, *bg1, *ba1;
  const float *dT, *dR, *dV, *dP, *JRg, *JVg, *JVa, *JPg, *JPa, *bias;
  const float *LT;                      // (9,9): L^T of info = L L^T
  const float *R2, *p2, *v2;            // the guess x = 0 stands for
  const float *X, *uv, *u_right, *sigma2;
  const uint8_t* mask;
  const float *walk, *g;
  float* state;                         // R (9), p, v, bg, ba: 21 floats
  uint8_t* inlier;                      // (N,): also the working mask
  int* n_inliers;
};

// ---------------------------------------------------------------------------
// 3x3 algebra (row-major), as ops/lie.py computes it
// ---------------------------------------------------------------------------

struct M3 {
  float a[9];
};
struct V3 {
  float a[3];
};

__device__ __forceinline__ M3 load_m3(const float* p) {
  M3 m;
#pragma unroll
  for (int k = 0; k < 9; ++k) m.a[k] = p[k];
  return m;
}

__device__ __forceinline__ V3 load_v3(const float* p) {
  return V3{{p[0], p[1], p[2]}};
}

__device__ __forceinline__ M3 mm(const M3& A, const M3& B) {
  M3 C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.a[3 * i + j] = A.a[3 * i] * B.a[j] + A.a[3 * i + 1] * B.a[3 + j]
                       + A.a[3 * i + 2] * B.a[6 + j];
  return C;
}

__device__ __forceinline__ M3 tr(const M3& A) {
  return M3{{A.a[0], A.a[3], A.a[6], A.a[1], A.a[4], A.a[7], A.a[2], A.a[5],
             A.a[8]}};
}

__device__ __forceinline__ V3 mv(const M3& A, const V3& x) {
  V3 y;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y.a[i] = A.a[3 * i] * x.a[0] + A.a[3 * i + 1] * x.a[1]
             + A.a[3 * i + 2] * x.a[2];
  return y;
}

__device__ __forceinline__ V3 add(const V3& x, const V3& y) {
  return V3{{x.a[0] + y.a[0], x.a[1] + y.a[1], x.a[2] + y.a[2]}};
}

__device__ __forceinline__ V3 sub(const V3& x, const V3& y) {
  return V3{{x.a[0] - y.a[0], x.a[1] - y.a[1], x.a[2] - y.a[2]}};
}

__device__ __forceinline__ V3 scale(const V3& x, float s) {
  return V3{{x.a[0] * s, x.a[1] * s, x.a[2] * s}};
}

__device__ __forceinline__ M3 hat(const V3& w) {
  return M3{{0.f, -w.a[2], w.a[1], w.a[2], 0.f, -w.a[0], -w.a[1], w.a[0],
             0.f}};
}

// I + a W + b W^2, W = hat(w)
__device__ __forceinline__ M3 poly_hat(const V3& w, float a, float b) {
  const M3 W = hat(w);
  const M3 W2 = mm(W, W);
  M3 R;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    R.a[k] = (k % 4 == 0 ? 1.f : 0.f) + a * W.a[k] + b * W2.a[k];
  return R;
}

__device__ __forceinline__ float sq_norm(const V3& w) {
  return w.a[0] * w.a[0] + w.a[1] * w.a[1] + w.a[2] * w.a[2];
}

// lie._safe_theta
__device__ __forceinline__ float safe_theta(float t2, bool& small) {
  small = t2 < kSmall2;
  return sqrtf(small ? 1.f : t2);
}

__device__ __forceinline__ float cosc(float t2) {
  bool small;
  const float th = safe_theta(t2, small);
  return small ? 0.5f - t2 / 24.f : (1.f - cosf(th)) / t2;
}

__device__ __forceinline__ M3 so3_exp(const V3& w) {
  const float t2 = sq_norm(w);
  bool small;
  const float th = safe_theta(t2, small);
  const float a = small ? 1.f - t2 / 6.f : sinf(th) / th;
  return poly_hat(w, a, cosc(t2));
}

__device__ __forceinline__ M3 left_jacobian(const V3& w) {
  const float t2 = sq_norm(w);
  bool small;
  const float th = safe_theta(t2, small);
  const float c = small ? 1.f / 6.f - t2 / 120.f : (th - sinf(th)) / (t2 * th);
  return poly_hat(w, cosc(t2), c);
}

__device__ __forceinline__ M3 right_jacobian(const V3& w) {
  return left_jacobian(scale(w, -1.f));
}

__device__ __forceinline__ M3 right_jacobian_inv(const V3& w) {
  const float t2 = sq_norm(w);
  bool small;
  const float th = safe_theta(t2, small);
  const float c = small ? 1.f / 12.f + t2 / 720.f
                        : 1.f / t2 - (1.f + cosf(th)) / (2.f * th * sinf(th));
  return poly_hat(w, 0.5f, c);
}

// lie.orthonormalize: R (3 I - R^T R) / 2
__device__ __forceinline__ M3 orthonormalize(const M3& R) {
  M3 S = mm(tr(R), R);
#pragma unroll
  for (int k = 0; k < 9; ++k) S.a[k] = (k % 4 == 0 ? 3.f : 0.f) - S.a[k];
  M3 out = mm(R, S);
#pragma unroll
  for (int k = 0; k < 9; ++k) out.a[k] *= 0.5f;
  return out;
}

// lie.so3_log: Shepperd's quaternion (the largest pivot, the first of
// equals), then quat_log
__device__ __forceinline__ float ssqrt(float v) {
  return v > 1e-8f ? sqrtf(v) : 0.f;
}

__device__ __forceinline__ float safe_div(float d) {
  return fabsf(d) > 1e-6f ? d : 1.f;
}

__device__ __forceinline__ V3 so3_log(const M3& R) {
  const float m00 = R.a[0], m01 = R.a[1], m02 = R.a[2];
  const float m10 = R.a[3], m11 = R.a[4], m12 = R.a[5];
  const float m20 = R.a[6], m21 = R.a[7], m22 = R.a[8];
  const float trace = m00 + m11 + m22;
  const float piv1 = m00 - m11 - m22, piv2 = -m00 + m11 - m22,
              piv3 = -m00 - m11 + m22;
  int k = 0;
  float best = trace;
  if (piv1 > best) { k = 1; best = piv1; }
  if (piv2 > best) { k = 2; best = piv2; }
  if (piv3 > best) k = 3;
  float q[4];
  if (k == 0) {
    const float s = ssqrt(1.f + trace) / 2.f, d = safe_div(4.f * s);
    q[0] = s;
    q[1] = (m21 - m12) / d;
    q[2] = (m02 - m20) / d;
    q[3] = (m10 - m01) / d;
  } else if (k == 1) {
    const float s = ssqrt(1.f + m00 - m11 - m22) / 2.f, d = safe_div(4.f * s);
    q[0] = (m21 - m12) / d;
    q[1] = s;
    q[2] = (m01 + m10) / d;
    q[3] = (m02 + m20) / d;
  } else if (k == 2) {
    const float s = ssqrt(1.f - m00 + m11 - m22) / 2.f, d = safe_div(4.f * s);
    q[0] = (m02 - m20) / d;
    q[1] = (m01 + m10) / d;
    q[2] = s;
    q[3] = (m12 + m21) / d;
  } else {
    const float s = ssqrt(1.f - m00 - m11 + m22) / 2.f, d = safe_div(4.f * s);
    q[0] = (m10 - m01) / d;
    q[1] = (m02 + m20) / d;
    q[2] = (m12 + m21) / d;
    q[3] = s;
  }
  const float nq = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                         + q[3] * q[3]);
  const float sg = q[0] / nq < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = q[j] / nq * sg;
  // quat_log
  const float w = fminf(fmaxf(q[0], -1.f), 1.f);
  const float vn2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const bool small = vn2 < 1e-16f;
  const float vn = sqrtf(small ? 1.f : vn2);
  const float s = small ? 2.f / fmaxf(w, 1e-8f) : 2.f * atan2f(vn, w) / vn;
  return V3{{q[1] * s, q[2] * s, q[3] * s}};
}

// ---------------------------------------------------------------------------
// Camera models (ops/cameras.py): projection and its Jacobian d(uv)/d(Xc)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void kb8_poly(const float* P, float th, float& f,
                                         float& df) {
  const float t2 = th * th;
  f = th * (1.f + t2 * (P[4] + t2 * (P[5] + t2 * (P[6] + t2 * P[7]))));
  df = 1.f + t2 * (3.f * P[4] + t2 * (5.f * P[5] + t2 * (7.f * P[6]
                                                         + 9.f * t2 * P[7])));
}

__device__ __forceinline__ void project(int model, const float* P, float x,
                                        float y, float z, float& u,
                                        float& v) {
  if (model == 0) {
    const float zc = fmaxf(z, 1e-6f);
    u = P[0] * x / zc + P[2];
    v = P[1] * y / zc + P[3];
  } else {
    const float r = sqrtf(fmaxf(x * x + y * y, 0.f));
    float f, df;
    kb8_poly(P, atan2f(r, z), f, df);
    const float s = r > 1e-8f ? f * (1.f / fmaxf(r, 1e-8f)) : 1.f;
    u = P[0] * x * s + P[2];
    v = P[1] * y * s + P[3];
  }
}

// J (2x3, row-major)
__device__ __forceinline__ void project_jac(int model, const float* P,
                                            float x, float y, float z,
                                            float J[6]) {
  if (model == 0) {
    const float zi = 1.f / fmaxf(z, 1e-6f);
    const float zi2 = zi * zi;
    J[0] = P[0] * zi;
    J[1] = 0.f;
    J[2] = -P[0] * x * zi2;
    J[3] = 0.f;
    J[4] = P[1] * zi;
    J[5] = -P[1] * y * zi2;
  } else {
    const float r2 = fmaxf(x * x + y * y, 1e-12f);
    const float r = sqrtf(r2);
    const float R2 = r2 + z * z;
    float f, fp;
    kb8_poly(P, atan2f(r, z), f, fp);
    const float dth_dx = x * z / (R2 * r);
    const float dth_dy = y * z / (R2 * r);
    const float dth_dz = -r / R2;
    const float gr = f / r;
    const float dg_dx = (fp * dth_dx * r - f * (x / r)) / r2;
    const float dg_dy = (fp * dth_dy * r - f * (y / r)) / r2;
    const float dg_dz = fp * dth_dz / r;
    J[0] = P[0] * (gr + x * dg_dx);
    J[1] = P[0] * x * dg_dy;
    J[2] = P[0] * x * dg_dz;
    J[3] = P[1] * y * dg_dx;
    J[4] = P[1] * (gr + y * dg_dy);
    J[5] = P[1] * y * dg_dz;
  }
}

// ---------------------------------------------------------------------------
// One match's visual rows (inertial_opt.proj_res_jac)
// ---------------------------------------------------------------------------

struct Pose {
  M3 R;      // R_wb
  V3 p;      // p_wb
  M3 Rcw;    // camera from world
  V3 tcw;
};

// unpack(x)'s pose: R = orthonormalize(Exp(dtheta) R2), p = p2 + dp; and
// the camera riding on it, T_cw = (T_wb T_bc)^-1
__device__ __forceinline__ Pose pose_of(const float* x, const M3& R2,
                                        const V3& p2, const M3& Rbc,
                                        const V3& tbc) {
  Pose s;
  s.R = orthonormalize(mm(so3_exp(V3{{x[3], x[4], x[5]}}), R2));
  s.p = add(p2, V3{{x[0], x[1], x[2]}});
  s.Rcw = tr(mm(s.R, Rbc));
  s.tcw = scale(mv(s.Rcw, add(mv(s.R, tbc), s.p)), -1.f);
  return s;
}

// The residual [uv - proj, ur - proj_r (0 for mono)] of match i, its chi2
// (whitened by 1 / sigma2) and the camera depth; with jac, the 3x6
// Jacobian wrt [dp, dtheta] of the body pose, dtheta on the left of R.
struct Rows {
  V3 X, Xc;
  float r[3];
  float chi2, hub, w_info;
  bool stereo;
};

__device__ __forceinline__ Rows visual_rows(const Args& a, const float* P,
                                            const Pose& s, int i) {
  Rows o;
  o.X = load_v3(a.X + 3 * i);
  o.Xc = add(mv(s.Rcw, o.X), s.tcw);
  float u, v;
  project(a.model, P, o.Xc.a[0], o.Xc.a[1], o.Xc.a[2], u, v);
  const float z = fmaxf(o.Xc.a[2], 1e-6f);
  const float ur = a.u_right[i];
  o.stereo = ur >= 0.f;
  o.r[0] = a.uv[2 * i] - u;
  o.r[1] = a.uv[2 * i + 1] - v;
  o.r[2] = o.stereo ? ur - (u - a.bf / z) : 0.f;
  o.w_info = 1.f / fmaxf(a.sigma2[i], 1e-12f);
  o.chi2 = (o.r[0] * o.r[0] + o.r[1] * o.r[1] + o.r[2] * o.r[2]) * o.w_info;
  o.hub = o.stereo ? kStereoChi2 : kMonoChi2;
  return o;
}

// Adds match i's weighted rows to acc: the upper triangle of J^T W J (21,
// row by row) and J^T W r (6).
__device__ __forceinline__ void accumulate(const Args& a, const float* P,
                                           const Pose& s, int i,
                                           float acc[kVis]) {
  const Rows o = visual_rows(a, P, s, i);
  // robust.huber_weight, the inlier mask and the depth gate
  const float c2 = fmaxf(o.chi2, 1e-12f);
  const float w = (c2 <= o.hub ? 1.f : sqrtf(o.hub / c2)) * o.w_info
                  * (a.inlier[i] ? 1.f : 0.f)
                  * (o.Xc.a[2] > 1e-2f ? 1.f : 0.f);
  if (w == 0.f) return;
  float Jp[6];
  project_jac(a.model, P, o.Xc.a[0], o.Xc.a[1], o.Xc.a[2], Jp);
  const float z = fmaxf(o.Xc.a[2], 1e-6f);
  // J3: the pixel rows and the right image's u row (mono: not used)
  const M3 J3{{Jp[0], Jp[1], Jp[2], Jp[3], Jp[4], Jp[5], Jp[0], Jp[1],
               Jp[2] + a.bf / (z * z)}};
  const M3 M = mm(J3, s.Rcw);            // d(proj) / d(X): rows m_r
  const V3 d = sub(o.X, s.p);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (r == 2 && !o.stereo) break;
    const float m0 = M.a[3 * r], m1 = M.a[3 * r + 1], m2 = M.a[3 * r + 2];
    // row r of [J3 R_cw, -J3 R_cw hat(X - p)]: [m_r, d x m_r]
    const float J[6] = {m0, m1, m2, d.a[1] * m2 - d.a[2] * m1,
                        d.a[2] * m0 - d.a[0] * m2, d.a[0] * m1 - d.a[1] * m0};
    int k = 0;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const float wj = w * J[p];
#pragma unroll
      for (int q = p; q < 6; ++q) acc[k++] += wj * J[q];
      acc[21 + p] += wj * o.r[r];
    }
  }
}

// ---------------------------------------------------------------------------
// The inertial factor and the solve: warp 0
// ---------------------------------------------------------------------------

struct Shared {
  float x[15];
  float red[kWarps][kVis];   // warp partial sums of the visual rows
  float LT[9][9];
  float A[9][16];   // unwhitened Jacobian of the 9-row factor | residual
  float W[9][16];   // L^T A
  float H[15][16];  // normal equations | right-hand side (column 15)
  float Jl[9];
  int count;
};

// Lane 0: the Forster residual and the Jacobian columns that move with x
// (imu.inertial_residual_jac), into A's rows 0-2 and column 15. The
// constant blocks of A were written once.
__device__ __forceinline__ void inertial_rows(const Args& a, Shared& sh,
                                              const float* x, const M3& R,
                                              const V3& p) {
  const M3 JRg = load_m3(a.JRg), JVg = load_m3(a.JVg), JVa = load_m3(a.JVa);
  const M3 JPg = load_m3(a.JPg), JPa = load_m3(a.JPa);
  const V3 v = add(load_v3(a.v2), V3{{x[6], x[7], x[8]}});
  const V3 bg = add(load_v3(a.bg1), V3{{x[9], x[10], x[11]}});
  const V3 ba = add(load_v3(a.ba1), V3{{x[12], x[13], x[14]}});
  const V3 p1 = load_v3(a.p1), v1 = load_v3(a.v1), gv = load_v3(a.g);
  const float dT = a.dT[0];
  const V3 dbg = sub(bg, load_v3(a.bias));
  const V3 dba = sub(ba, load_v3(a.bias + 3));
  const V3 c = mv(JRg, dbg);
  const M3 dRc = orthonormalize(mm(load_m3(a.dR), so3_exp(c)));
  const V3 dVc = add(add(load_v3(a.dV), mv(JVg, dbg)), mv(JVa, dba));
  const V3 dPc = add(add(load_v3(a.dP), mv(JPg, dbg)), mv(JPa, dba));
  const M3 R1T = tr(load_m3(a.R1));
  const V3 er = so3_log(mm(mm(tr(dRc), R1T), R));
  const V3 va = sub(sub(v, v1), scale(gv, dT));
  const V3 pb = sub(sub(sub(p, p1), scale(v1, dT)),
                    scale(scale(scale(gv, 0.5f), dT), dT));
  const V3 ev = sub(mv(R1T, va), dVc);
  const V3 ep = sub(mv(R1T, pb), dPc);
  const M3 Jl = left_jacobian(V3{{x[3], x[4], x[5]}});
  const M3 th = mm(mm(right_jacobian_inv(er), tr(R)), Jl);
  const M3 Jbg = mm(mm(right_jacobian_inv(scale(er, -1.f)),
                       right_jacobian(c)), JRg);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sh.A[i][3 + j] = th.a[3 * i + j];
      sh.A[i][9 + j] = -Jbg.a[3 * i + j];
    }
    sh.A[i][15] = er.a[i];
    sh.A[3 + i][15] = ev.a[i];
    sh.A[6 + i][15] = ep.a[i];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) sh.Jl[k] = Jl.a[k];
}

// Warp 0: W = L^T [A | r], then [H | g] = [W^T W + walk + 1e-6 I |
// -W^T r_w - walk x] over the 15 state columns.
__device__ __forceinline__ void inertial_normal(const Args& a, Shared& sh,
                                                int lane) {
  for (int e = lane; e < 9 * 16; e += 32) {
    const int r = e >> 4, c = e & 15;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) s += sh.LT[r][k] * sh.A[k][c];
    sh.W[r][c] = s;
  }
  __syncwarp();
  for (int e = lane; e < 15 * 16; e += 32) {
    const int i = e >> 4, j = e & 15;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) s += sh.W[k][i] * sh.W[k][j];
    if (i >= 9) {
      const float sw = sqrtf(a.walk[i - 9]);
      if (j == i) s += sw * sw;
      if (j == 15) s += sw * (sh.x[i] * sw);
    }
    if (j == i) s += 1e-6f;
    sh.H[i][j] = j == 15 ? -s : s;
  }
}

// Warp 0, after the visual partial sums are in: adds T^T H_vis T and
// -T^T g_vis, solves H x = g by LU with partial pivoting on [H | g] in
// place and adds the step to sh.x.
__device__ __forceinline__ void solve_step(Shared& sh, int lane) {
  if (lane < kVis) {
    float s = 0.f;
    for (int w = 1; w < kWarps; ++w) s += sh.red[w][lane];
    sh.red[0][lane] = s;
  }
  __syncwarp();
  if (lane == 0) {
    float Hv[6][6];
    int k = 0;
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int q = p; q < 6; ++q) Hv[p][q] = Hv[q][p] = sh.red[0][k++];
    const float* gv = &sh.red[0][21];
    const M3 Jl = load_m3(sh.Jl);
    M3 Hpt, Htt;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Hpt.a[3 * i + j] = Hv[i][3 + j];
        Htt.a[3 * i + j] = Hv[3 + i][3 + j];
      }
    Hpt = mm(Hpt, Jl);
    Htt = mm(mm(tr(Jl), Htt), Jl);
    const V3 gt = mv(tr(Jl), V3{{gv[3], gv[4], gv[5]}});
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        sh.H[i][j] += Hv[i][j];
        sh.H[i][3 + j] += Hpt.a[3 * i + j];
        sh.H[3 + j][i] += Hpt.a[3 * i + j];
        sh.H[3 + i][3 + j] += Htt.a[3 * i + j];
      }
      sh.H[i][15] -= gv[i];
      sh.H[3 + i][15] -= gt.a[i];
    }
  }
  __syncwarp();
  // LU with partial pivoting (the first row of the largest |pivot|, as
  // LAPACK's getrf), eliminating into the right-hand side: lane i owns row i
  for (int k = 0; k < 15; ++k) {
    float v = lane >= k && lane < 15 ? fabsf(sh.H[lane][k]) : -1.f;
    int r = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int orow = __shfl_down_sync(0xffffffffu, r, off);
      if (ov > v || (ov == v && orow < r)) {
        v = ov;
        r = orow;
      }
    }
    const int piv = __shfl_sync(0xffffffffu, r, 0);
    if (piv != k && lane >= k && lane < 16) {
      const float t = sh.H[k][lane];
      sh.H[k][lane] = sh.H[piv][lane];
      sh.H[piv][lane] = t;
    }
    __syncwarp();
    if (lane > k && lane < 15) {
      const float l = sh.H[lane][k] / sh.H[k][k];
      for (int j = k + 1; j < 16; ++j) sh.H[lane][j] -= l * sh.H[k][j];
    }
    __syncwarp();
  }
  if (lane == 0) {
    float y[15];
    for (int i = 14; i >= 0; --i) {
      float s = sh.H[i][15];
      for (int j = i + 1; j < 15; ++j) s -= sh.H[i][j] * y[j];
      y[i] = s / sh.H[i][i];
      sh.x[i] += y[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pose_vel_bias_kernel(const Args a) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float P[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) P[k] = a.params[k];
  const M3 Rbc = load_m3(a.R_bc), R2 = load_m3(a.R2);
  const V3 tbc = load_v3(a.t_bc), p2 = load_v3(a.p2);

  // the working inlier mask starts as the match mask; the constant blocks
  // of the factor's Jacobian (imu.InertialJac p2, v2, bg and ba rows 3-8)
  if (warp > 0)
    for (int i = tid - 32; i < a.n; i += kPointThreads)
      a.inlier[i] = a.mask[i] ? 1 : 0;
  if (tid < 15) sh.x[tid] = 0.f;
  if (tid == 0) sh.count = 0;
  for (int e = tid; e < 81; e += kThreads) sh.LT[e / 9][e % 9] = a.LT[e];
  for (int e = tid; e < 9 * 16; e += kThreads) sh.A[e >> 4][e & 15] = 0.f;
  __syncthreads();
  if (tid == 0) {
    const M3 R1T = tr(load_m3(a.R1));
    const M3 JVg = load_m3(a.JVg), JVa = load_m3(a.JVa);
    const M3 JPg = load_m3(a.JPg), JPa = load_m3(a.JPa);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        sh.A[6 + i][j] = R1T.a[3 * i + j];          // ep / dp
        sh.A[3 + i][6 + j] = R1T.a[3 * i + j];      // ev / dv
        sh.A[3 + i][9 + j] = -JVg.a[3 * i + j];     // ev / dbg
        sh.A[6 + i][9 + j] = -JPg.a[3 * i + j];     // ep / dbg
        sh.A[3 + i][12 + j] = -JVa.a[3 * i + j];    // ev / dba
        sh.A[6 + i][12 + j] = -JPa.a[3 * i + j];    // ep / dba
      }
  }
  __syncthreads();

  float x[15];
  for (int round = 0; round < a.n_rounds; ++round) {
    for (int it = 0; it < a.n_iters; ++it) {
#pragma unroll
      for (int k = 0; k < 15; ++k) x[k] = sh.x[k];
      const Pose s = pose_of(x, R2, p2, Rbc, tbc);
      if (warp > 0) {
        float acc[kVis];
#pragma unroll
        for (int k = 0; k < kVis; ++k) acc[k] = 0.f;
        for (int i = tid - 32; i < a.n; i += kPointThreads)
          accumulate(a, P, s, i, acc);
#pragma unroll
        for (int k = 0; k < kVis; ++k) {
          float v = acc[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane == 0) sh.red[warp][k] = v;
        }
      } else {
        if (lane == 0) inertial_rows(a, sh, x, s.R, s.p);
        __syncwarp();
        inertial_normal(a, sh, lane);
      }
      __syncthreads();
      if (warp == 0) solve_step(sh, lane);
      __syncthreads();
    }
    // the chi2 re-gate against the match mask (each thread its own matches)
#pragma unroll
    for (int k = 0; k < 15; ++k) x[k] = sh.x[k];
    const Pose s = pose_of(x, R2, p2, Rbc, tbc);
    if (warp > 0)
      for (int i = tid - 32; i < a.n; i += kPointThreads) {
        const Rows o = visual_rows(a, P, s, i);
        a.inlier[i] = a.mask[i] && o.chi2 <= o.hub && o.Xc.a[2] > 0.f;
      }
  }

  int cnt = 0;
  if (warp > 0)
    for (int i = tid - 32; i < a.n; i += kPointThreads) cnt += a.inlier[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if (lane == 0 && cnt) atomicAdd(&sh.count, cnt);
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 15; ++k) x[k] = sh.x[k];
    const Pose s = pose_of(x, R2, p2, Rbc, tbc);
    const V3 v = add(load_v3(a.v2), V3{{x[6], x[7], x[8]}});
    const V3 bg = add(load_v3(a.bg1), V3{{x[9], x[10], x[11]}});
    const V3 ba = add(load_v3(a.ba1), V3{{x[12], x[13], x[14]}});
#pragma unroll
    for (int k = 0; k < 9; ++k) a.state[k] = s.R.a[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.state[9 + k] = s.p.a[k];
      a.state[12 + k] = v.a[k];
      a.state[15 + k] = bg.a[k];
      a.state[18 + k] = ba.a[k];
    }
    *a.n_inliers = sh.count;
  }
}

}  // namespace

extern "C" int msslam_pose_vel_bias(
    int model, float bf, int n, int n_rounds, int n_iters,
    const float* params, const float* R_bc, const float* t_bc,
    const float* R1, const float* p1, const float* v1, const float* bg1,
    const float* ba1, const float* dT, const float* dR, const float* dV,
    const float* dP, const float* JRg, const float* JVg, const float* JVa,
    const float* JPg, const float* JPa, const float* bias, const float* LT,
    const float* R2, const float* p2, const float* v2, const float* X,
    const float* uv, const float* u_right, const float* sigma2,
    const uint8_t* mask, const float* walk, const float* g, float* state,
    uint8_t* inlier, int* n_inliers, void* stream) {
  if ((model != 0 && model != 1) || n < 0 || n_rounds < 0 || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{model, n, n_rounds, n_iters, bf, params, R_bc, t_bc, R1, p1,
               v1, bg1, ba1, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, bias,
               LT, R2, p2, v2, X, uv, u_right, sigma2, mask, walk, g, state,
               inlier, n_inliers};
  pose_vel_bias_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
