// Motion-only pose optimization for Hopper (sm_90a): all of
// ops/pose_opt.py::pose_optimize_plain in one launch.
//
// Replaces no TPU kernel. The JAX package's pose_optimize
// (ms_slam_tpu/ops/pose_opt.py) is XLA-compiled jnp, which fuses it.
// This kernel exists because the port's H100 profile puts the function on
// the critical path of every tracked frame: written in PyTorch, one LM
// iteration launches ~530 small kernels, and a frame's 2-4 calls (the
// motion stage's 2 rounds x 5 iterations, the local map's 4 x 10) launch
// ~27,000. The host spends ~370-500 ms a frame dispatching them while the
// card idles.
//
// The work: the camera pose T_cw (R, t) against N matches. Each iteration
// evaluates every match's residual, its Huber weight and its Jacobian at
// the accepted pose and reduces them to a 6x6 system; solves the damped
// system H + lam diag(H) + 1e-9 I for a left step xi; evaluates the robust
// cost at the candidate normalize(exp(xi) T) and keeps it if the cost fell
// (lam halves) or drops it (lam quadruples). After each round a chi2 and
// depth re-gate decides the inliers of the next.
//
// What bounds it on this card: latency, not bytes or FLOPs. The inputs
// are ~59 KB at the drive's N = 2,048 (29 bytes a match). An iteration is
// ~0.5 MFLOP. But a 4 x 10 call is 40 dependent iterations, each two
// block-wide reductions with a serial 6x6 solve between them.
//
// What the design does about that:
//  - One thread block does the whole call, so a reduction and the hand-back
//    of the pose cost a __syncthreads each and no launch. The pose, lam,
//    the cost and the inlier flags live in shared memory (the flags in
//    dynamic shared memory, one byte a row); the matches stay in L1 after
//    the first pass. More blocks would need a grid-wide sync per pass.
//  - Each iteration makes two passes over the rows: (1) at the accepted
//    pose, residual, Huber weight and Jacobian, summed per thread into the
//    21 unique entries of H, the 6 of g and the robust cost; (2) at the
//    candidate, the robust cost alone. Each pass ends in warp shuffles and
//    one pass over the warps' partial sums in shared memory. Pass (1)
//    recomputes the residual at the accepted pose where the plain version
//    carries it from the candidate that was accepted: the same quantity.
//  - Between the passes one lane solves the damped system by the plain
//    version's Schur on closed-form 3x3 inverses (lie.solve_psd6), then
//    builds the candidate. No Cholesky: in float32 it gives NaN on a
//    non-positive pivot (pose_vel_bias.cu says where that was seen).
//
// Rows, all read from the input: the camera model (0 pinhole, 1 KB8); a
// rectified stereo row (3 residuals, with bf) where u_right >= 0, else a
// monocular one (2). With a rig (an unrectified pair: non-null rig
// pointers) every left row is monocular and each match's right keypoint
// (u >= 0) adds a 2-row residual through T_rl and the second lens, with its
// own variance, the monocular gate and Huber weight and its own inlier
// flag, accumulated by the same thread right after the left rows.
//
// The same work in the same precision: float32 throughout, every round and
// iteration runs, and the formulas and their order are the plain
// version's. Sums run in another order (per thread, then across the block),
// so the results agree to float32 rounding, not bit for bit.
//
// Plain C interface (loaded with ctypes): msslam_pose_opt, whose last five
// pointers are the rig's (the second lens, T_rl as 12 floats row-major
// [R | t], the (N,3) right keypoints, the right rows' flags and their count)
// or all null. It launches on the given stream, does not synchronise,
// allocates nothing, returns a cudaError_t as an int.

#include <cuda_runtime.h>

#include <cstdint>

#include "lie_camera.cuh"

namespace {

using namespace msslam;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = kVis + 1;   // H (21), g (6) and the robust cost

struct Args {
  int model, n, n_rounds, n_iters;
  float bf;
  const float *params, *R0, *t0;
  const float *X, *uv, *u_right, *sigma2;
  const uint8_t* mask;
  float* state;                         // R (9), t (3), chi2
  uint8_t* inlier;                      // (N,)
  int* n_inliers;
  int rig;                              // 1: the right rows below
  const float *params2, *T_rl;          // the second lens; [R_rl | t_rl]
  const float* right;                   // (N,3) [u, v, sigma2], u < 0: none
  uint8_t* inlier_r;                    // (N,): the right rows' flags
  int* n_right;
};

struct Shared {
  float R[9], t[3];       // the accepted pose
  float Rc[9], tc[3];     // the candidate
  float cost, lam;
  float red[kWarps][kSums];   // warp partial sums
  float P[8], P2[8];          // the lens; the second lens
  float T_rl[12];             // [R_rl | t_rl], row-major
  int count, count_r;
};

// ---------------------------------------------------------------------------
// One match's rows at a pose (pose_opt._residuals_jac, _rig_rows)
// ---------------------------------------------------------------------------

// The left row [uv - proj, ur - proj_r (0 for mono)] of match i, its chi2
// (whitened by 1 / sigma2), its Huber delta and the camera point.
struct Left {
  V3 Xc;
  float r[3];
  float chi2, hub, w_info;
  bool stereo;
};

__device__ __forceinline__ Left left_row(const Args& a, const float* P,
                                         const M3& R, const V3& t, int i) {
  Left o;
  o.Xc = add(mv(R, load_v3(a.X + 3 * i)), t);
  float u, v;
  project(a.model, P, o.Xc.a[0], o.Xc.a[1], o.Xc.a[2], u, v);
  const float z = fmaxf(o.Xc.a[2], 1e-6f);
  const float ur = a.u_right[i];
  o.stereo = !a.rig && ur >= 0.f;
  o.r[0] = a.uv[2 * i] - u;
  o.r[1] = a.uv[2 * i + 1] - v;
  o.r[2] = o.stereo ? ur - (u - a.bf / z) : 0.f;
  o.w_info = 1.f / fmaxf(a.sigma2[i], 1e-12f);
  o.chi2 = (o.r[0] * o.r[0] + o.r[1] * o.r[1] + o.r[2] * o.r[2]) * o.w_info;
  o.hub = o.stereo ? kStereoChi2 : kMonoChi2;
  return o;
}

// A row's term of the robust cost: min(chi2, 10 delta^2) huber(chi2)
__device__ __forceinline__ float cost_term(float chi2, float hub) {
  return fminf(chi2, hub * 10.f) * huber(chi2, hub);
}

// Adds match i's weighted rows at (R, t) to acc: the upper triangle of
// J^T W J (21, row by row), J^T W r (6) and the robust cost; with a rig,
// the right row's after them. fl / fr: the working inlier flags.
__device__ __forceinline__ void accumulate(const Args& a, const Shared& sh,
                                           const uint8_t* fl,
                                           const uint8_t* fr, const M3& R,
                                           const V3& t, int i,
                                           float acc[kSums]) {
  const Left o = left_row(a, sh.P, R, t, i);
  if (fl[i]) {
    const float wr = huber(o.chi2, o.hub);
    acc[kVis] += fminf(o.chi2, o.hub * 10.f) * wr;
    const float w = wr * o.w_info;
    if (w != 0.f) {
      float Jp[6];
      project_jac(a.model, sh.P, o.Xc.a[0], o.Xc.a[1], o.Xc.a[2], Jp);
      add_row(Jp[0], Jp[1], Jp[2], o.Xc, w, o.r[0], acc);
      add_row(Jp[3], Jp[4], Jp[5], o.Xc, w, o.r[1], acc);
      if (o.stereo) {
        // the right image's u row: d(u - bf / z) / d(Xc)
        const float z = fmaxf(o.Xc.a[2], 1e-6f);
        add_row(Jp[0], Jp[1], Jp[2] + a.bf / (z * z), o.Xc, w, o.r[2], acc);
      }
    }
  }
  if (!a.rig || !fr[i]) return;
  const RightRow q = right_row(a.model, a.right, sh.P2, sh.T_rl, o.Xc, i);
  const float wr = huber(q.chi2, kMonoChi2);
  acc[kVis] += fminf(q.chi2, kMonoChi2 * 10.f) * wr;
  const float w = wr * q.w_info;
  if (w == 0.f) return;
  float Jq[6];
  project_jac(a.model, sh.P2, q.Xr.a[0], q.Xr.a[1], q.Xr.a[2], Jq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float e[3];
    right_jac_row(Jq, sh.T_rl, r, e);
    add_row(e[0], e[1], e[2], o.Xc, w, q.r[r], acc);
  }
}

// Match i's term of the robust cost at (R, t).
__device__ __forceinline__ float cost_at(const Args& a, const Shared& sh,
                                         const uint8_t* fl,
                                         const uint8_t* fr, const M3& R,
                                         const V3& t, int i) {
  const Left o = left_row(a, sh.P, R, t, i);
  float c = fl[i] ? cost_term(o.chi2, o.hub) : 0.f;
  if (a.rig && fr[i]) {
    const RightRow q = right_row(a.model, a.right, sh.P2, sh.T_rl, o.Xc, i);
    c += cost_term(q.chi2, kMonoChi2);
  }
  return c;
}

// ---------------------------------------------------------------------------
// The damped step: one lane
// ---------------------------------------------------------------------------

// lie.inv3x3: adjugate over the determinant, floored at 1e-30
__device__ __forceinline__ M3 inv3x3(const M3& A) {
  const float a = A.a[0], b = A.a[1], c = A.a[2];
  const float d = A.a[3], e = A.a[4], f = A.a[5];
  const float g = A.a[6], h = A.a[7], i = A.a[8];
  const float A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const float A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const float A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  const float det = a * A11 + b * A21 + c * A31;
  const float inv = 1.f / (fabsf(det) > 1e-30f ? det : 1e-30f);
  return M3{{A11 * inv, A12 * inv, A13 * inv, A21 * inv, A22 * inv,
             A23 * inv, A31 * inv, A32 * inv, A33 * inv}};
}

__device__ __forceinline__ M3 sub_m3(const M3& A, const M3& B) {
  M3 C;
#pragma unroll
  for (int k = 0; k < 9; ++k) C.a[k] = A.a[k] - B.a[k];
  return C;
}

// Lane 0 of warp 0, with the block's sums in sh.red[0]: the damped system
// H + lam diag(H) + 1e-9 I, its solution by lie.solve_psd6's 2x2-block
// Schur ([[P, Q], [Q^T, S]] x = [u, v]) and the candidate
// normalize_rotation(exp(xi) T) into sh.Rc / sh.tc. The first iteration of
// a round takes its cost from the sums and starts lam at 1e-3.
__device__ __forceinline__ void solve_candidate(Shared& sh, int it) {
  const float* s = sh.red[0];
  if (it == 0) {
    sh.cost = s[kVis];
    sh.lam = 1e-3f;
  }
  const float lam = sh.lam;
  float H[6][6];
  int k = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) H[p][q] = H[q][p] = s[k++];
#pragma unroll
  for (int p = 0; p < 6; ++p) H[p][p] = H[p][p] + lam * H[p][p] + 1e-9f;
  M3 P, Q, S;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      P.a[3 * i + j] = H[i][j];
      Q.a[3 * i + j] = H[i][3 + j];
      S.a[3 * i + j] = H[3 + i][3 + j];
    }
  const V3 u{{s[21], s[22], s[23]}}, v{{s[24], s[25], s[26]}};
  const M3 Pi = inv3x3(P);
  const M3 PiQ = mm(Pi, Q);
  const M3 Sp = sub_m3(S, mm(tr(Q), PiQ));
  const V3 x2 = mv(inv3x3(Sp), sub(v, mv(tr(PiQ), u)));
  const V3 x1 = sub(mv(Pi, u), mv(PiQ, x2));
  // se3_exp([x1, x2]) composed on the left of the accepted pose
  const M3 Re = so3_exp(x2);
  const V3 te = mv(left_jacobian(x2), x1);
  const M3 Rn = normalize_rotation(mm(Re, load_m3(sh.R)));
  const V3 tn = add(mv(Re, load_v3(sh.t)), te);
#pragma unroll
  for (int j = 0; j < 9; ++j) sh.Rc[j] = Rn.a[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) sh.tc[j] = tn.a[j];
}

// Warp sums of v[0..K) into sh.red[warp]
template <int K>
__device__ __forceinline__ void warp_sums(const float* v, float* out,
                                          int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[k] = s;
  }
}

__global__ void __launch_bounds__(kThreads) pose_opt_kernel(const Args a) {
  __shared__ Shared sh;
  extern __shared__ uint8_t flags[];    // left rows' flags, then right's
  uint8_t* fl = flags;
  uint8_t* fr = flags + (a.rig ? a.n : 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the working inlier flags start as the match mask (the right rows':
  // the matches that have a right keypoint)
  for (int i = tid; i < a.n; i += kThreads) {
    fl[i] = a.mask[i] ? 1 : 0;
    if (a.rig) fr[i] = a.mask[i] && a.right[3 * i] >= 0.f;
  }
  if (tid < 9) sh.R[tid] = a.R0[tid];
  if (tid < 3) sh.t[tid] = a.t0[tid];
  if (tid < 8) sh.P[tid] = a.params[tid];
  if (a.rig && tid < 8) sh.P2[tid] = a.params2[tid];
  if (a.rig && tid < 12) sh.T_rl[tid] = a.T_rl[tid];
  if (tid == 0) sh.count = sh.count_r = 0;
  __syncthreads();

  for (int round = 0; round < a.n_rounds; ++round) {
    for (int it = 0; it < a.n_iters; ++it) {
      {  // (1) the normal equations and the cost at the accepted pose
        const M3 R = load_m3(sh.R);
        const V3 t = load_v3(sh.t);
        float acc[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
        for (int i = tid; i < a.n; i += kThreads)
          accumulate(a, sh, fl, fr, R, t, i, acc);
        warp_sums<kSums>(acc, sh.red[warp], lane);
      }
      __syncthreads();
      if (warp == 0) {
        if (lane < kSums) {
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += sh.red[w][lane];
          sh.red[0][lane] = s;
        }
        __syncwarp();
        if (lane == 0) solve_candidate(sh, it);
      }
      __syncthreads();
      {  // (2) the robust cost at the candidate
        const M3 R = load_m3(sh.Rc);
        const V3 t = load_v3(sh.tc);
        float c = 0.f;
        for (int i = tid; i < a.n; i += kThreads)
          c += cost_at(a, sh, fl, fr, R, t, i);
        warp_sums<1>(&c, sh.red[warp], lane);
      }
      __syncthreads();
      if (tid == 0) {   // accept or reject
        float c = 0.f;
        for (int w = 0; w < kWarps; ++w) c += sh.red[w][0];
        const bool good = c < sh.cost;
        if (good) {
#pragma unroll
          for (int j = 0; j < 9; ++j) sh.R[j] = sh.Rc[j];
#pragma unroll
          for (int j = 0; j < 3; ++j) sh.t[j] = sh.tc[j];
          sh.cost = c;
        }
        sh.lam = good ? sh.lam * 0.5f : sh.lam * 4.f;
      }
      __syncthreads();
    }
    // the chi2 and depth re-gate against the match mask (each thread its
    // own rows, so no barrier before the next pass)
    const M3 R = load_m3(sh.R);
    const V3 t = load_v3(sh.t);
    for (int i = tid; i < a.n; i += kThreads) {
      const Left o = left_row(a, sh.P, R, t, i);
      fl[i] = a.mask[i] && o.chi2 <= o.hub && o.Xc.a[2] > 0.f;
      if (a.rig) {
        const RightRow q = right_row(a.model, a.right, sh.P2, sh.T_rl, o.Xc,
                                     i);
        fr[i] = a.mask[i] && a.right[3 * i] >= 0.f && q.chi2 <= kMonoChi2
                && q.Xr.a[2] > 0.f;
      }
    }
  }

  // the flags out, their counts and the inliers' chi2 at the final pose
  const M3 R = load_m3(sh.R);
  const V3 t = load_v3(sh.t);
  float chi2 = 0.f;
  int cnt = 0, cnt_r = 0;
  for (int i = tid; i < a.n; i += kThreads) {
    const Left o = left_row(a, sh.P, R, t, i);
    if (fl[i]) chi2 += o.chi2;
    cnt += fl[i];
    a.inlier[i] = fl[i];
    if (a.rig) {
      if (fr[i])
        chi2 += right_row(a.model, a.right, sh.P2, sh.T_rl, o.Xc, i).chi2;
      cnt_r += fr[i];
      a.inlier_r[i] = fr[i];
    }
  }
  warp_sums<1>(&chi2, sh.red[warp], lane);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    cnt_r += __shfl_down_sync(0xffffffffu, cnt_r, off);
  }
  if (lane == 0 && cnt) atomicAdd(&sh.count, cnt);
  if (lane == 0 && cnt_r) atomicAdd(&sh.count_r, cnt_r);
  __syncthreads();
  if (tid == 0) {
    float c = 0.f;
    for (int w = 0; w < kWarps; ++w) c += sh.red[w][0];
#pragma unroll
    for (int j = 0; j < 9; ++j) a.state[j] = R.a[j];
#pragma unroll
    for (int j = 0; j < 3; ++j) a.state[9 + j] = t.a[j];
    a.state[12] = c;
    *a.n_inliers = sh.count;
    if (a.rig) *a.n_right = sh.count_r;
  }
}

}  // namespace

extern "C" int msslam_pose_opt(
    int model, float bf, int n, int n_rounds, int n_iters,
    const float* params, const float* R0, const float* t0, const float* X,
    const float* uv, const float* u_right, const float* sigma2,
    const uint8_t* mask, float* state, uint8_t* inlier, int* n_inliers,
    const float* params2, const float* T_rl, const float* right,
    uint8_t* inlier_r, int* n_right, void* stream) {
  const bool rig = params2 != nullptr;
  if ((model != 0 && model != 1) || n < 0 || n_rounds < 0 || n_iters < 0
      || (rig && (!T_rl || !right || !inlier_r || !n_right)))
    return (int)cudaErrorInvalidValue;
  // one byte a row's flag (two with a rig) past the static Shared; above
  // the default 48 KB the kernel has to be allowed more, up to the 227 KB
  // a block can have
  const size_t smem = (size_t)n * (rig ? 2 : 1);
  if (smem + sizeof(Shared) > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem + sizeof(Shared) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pose_opt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Args a{model, n, n_rounds, n_iters, bf, params, R0, t0, X, uv,
               u_right, sigma2, mask, state, inlier, n_inliers, rig,
               params2, T_rl, right, inlier_r, n_right};
  pose_opt_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
