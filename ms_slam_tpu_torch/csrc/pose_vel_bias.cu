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
// An unrectified stereo pair (non-null rig pointers) adds each match's right keypoint:
// a 2-row residual through T_rl and the second lens, accumulated by the
// same thread right after its left rows, with its own variance, the
// monocular gate and Huber weight and its own working inlier flag. It is
// the plain version's second copy of the table, in the same launch.
//
// The same work in the same precision: float32 throughout, every round and
// step runs, and the formulas and their order are the plain version's.
// Sums run in another order (per thread, then across the block), so the
// results agree to float32 rounding, not bit for bit.
//
// The 3x3 and SO(3) algebra, the camera models, the right row and the
// accumulation of a row are lie_camera.cuh's, shared with pose_opt.cu.
//
// Plain C interface (loaded with ctypes): msslam_pose_vel_bias, whose last
// five pointers are the rig's (the second lens, T_rl as 12 floats row-major
// [R | t], the (N,3) right keypoints, the right rows' flags and their count)
// or all null. It launches on the given stream, does not synchronise,
// allocates nothing, returns a cudaError_t as an int.

#include <cuda_runtime.h>

#include <cstdint>

#include "lie_camera.cuh"

namespace {

using namespace msslam;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPointThreads = kThreads - 32;   // warps 1..7 take the matches

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
  int rig;                              // 1: the right rows below
  const float *params2, *T_rl;          // the second lens; [R_rl | t_rl]
  const float* right;                   // (N,3) [u, v, sigma2], u < 0: none
  uint8_t* inlier_r;                    // (N,): the right rows' flags
  int* n_right;
};

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
// row by row) and J^T W r (6); with a rig, the right row's after them.
__device__ __forceinline__ void accumulate(const Args& a, const float* P,
                                           const float* P2, const float* T,
                                           const Pose& s, int i,
                                           float acc[kVis]) {
  const Rows o = visual_rows(a, P, s, i);
  // robust.huber_weight, the inlier mask and the depth gate
  const float w = huber(o.chi2, o.hub) * o.w_info
                  * (a.inlier[i] ? 1.f : 0.f)
                  * (o.Xc.a[2] > 1e-2f ? 1.f : 0.f);
  const V3 d = sub(o.X, s.p);
  if (w != 0.f) {
    float Jp[6];
    project_jac(a.model, P, o.Xc.a[0], o.Xc.a[1], o.Xc.a[2], Jp);
    const float z = fmaxf(o.Xc.a[2], 1e-6f);
    // J3: the pixel rows and the right image's u row (mono: not used)
    const M3 J3{{Jp[0], Jp[1], Jp[2], Jp[3], Jp[4], Jp[5], Jp[0], Jp[1],
                 Jp[2] + a.bf / (z * z)}};
    const M3 M = mm(J3, s.Rcw);          // d(proj) / d(X): rows m_r
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (r == 2 && !o.stereo) break;
      add_row(M.a[3 * r], M.a[3 * r + 1], M.a[3 * r + 2], d, w, o.r[r], acc);
    }
  }
  if (!a.rig || !a.inlier_r[i]) return;
  const RightRow q = right_row(a.model, a.right, P2, T, o.Xc, i);
  const float wr = huber(q.chi2, kMonoChi2) * q.w_info
                   * (q.Xr.a[2] > 1e-2f ? 1.f : 0.f);
  if (wr == 0.f) return;
  float Jq[6];
  project_jac(a.model, P2, q.Xr.a[0], q.Xr.a[1], q.Xr.a[2], Jq);
  // d(proj2) / d(X) = J2 R_rl R_cw, row by row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float e[3];
    right_jac_row(Jq, T, r, e);
    const V3 m = mv(tr(s.Rcw), V3{{e[0], e[1], e[2]}});
    add_row(m.a[0], m.a[1], m.a[2], d, wr, q.r[r], acc);
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
  float P2[8];      // the second lens
  float T_rl[12];   // [R_rl | t_rl], row-major
  int count, count_r;
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
    for (int i = tid - 32; i < a.n; i += kPointThreads) {
      a.inlier[i] = a.mask[i] ? 1 : 0;
      if (a.rig) a.inlier_r[i] = a.mask[i] && a.right[3 * i] >= 0.f;
    }
  if (tid < 15) sh.x[tid] = 0.f;
  if (a.rig && tid < 8) sh.P2[tid] = a.params2[tid];
  if (a.rig && tid < 12) sh.T_rl[tid] = a.T_rl[tid];
  if (tid == 0) sh.count = sh.count_r = 0;
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
          accumulate(a, P, sh.P2, sh.T_rl, s, i, acc);
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
        if (a.rig) {
          const RightRow q = right_row(a.model, a.right, sh.P2, sh.T_rl,
                                       o.Xc, i);
          a.inlier_r[i] = a.mask[i] && a.right[3 * i] >= 0.f
                          && q.chi2 <= kMonoChi2 && q.Xr.a[2] > 0.f;
        }
      }
  }

  int cnt = 0, cnt_r = 0;
  if (warp > 0)
    for (int i = tid - 32; i < a.n; i += kPointThreads) {
      cnt += a.inlier[i];
      if (a.rig) cnt_r += a.inlier_r[i];
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    cnt_r += __shfl_down_sync(0xffffffffu, cnt_r, off);
  }
  if (lane == 0 && cnt) atomicAdd(&sh.count, cnt);
  if (lane == 0 && cnt_r) atomicAdd(&sh.count_r, cnt_r);
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
    if (a.rig) *a.n_right = sh.count_r;
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
    uint8_t* inlier, int* n_inliers, const float* params2,
    const float* T_rl, const float* right, uint8_t* inlier_r, int* n_right,
    void* stream) {
  const bool rig = params2 != nullptr;
  if ((model != 0 && model != 1) || n < 0 || n_rounds < 0 || n_iters < 0
      || (rig && (!T_rl || !right || !inlier_r || !n_right)))
    return (int)cudaErrorInvalidValue;
  const Args a{model, n, n_rounds, n_iters, bf, params, R_bc, t_bc, R1, p1,
               v1, bg1, ba1, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, bias,
               LT, R2, p2, v2, X, uv, u_right, sigma2, mask, walk, g, state,
               inlier, n_inliers, rig, params2, T_rl, right, inlier_r,
               n_right};
  pose_vel_bias_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
