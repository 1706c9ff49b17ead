// Device code shared by the port's pose solvers (pose_opt.cu,
// pose_vel_bias.cu): row-major 3x3 algebra and the SO(3) maps as
// ops/lie.py computes them, the camera models of ops/cameras.py with their
// Jacobians, the right-camera row of an unrectified pair and the
// accumulation of one weighted 6-column row into a 6x6 normal system.
//
// Header only. ops/_native.py rebuilds a library when a header that its
// source includes is newer than the library.

#pragma once

#include <cuda_runtime.h>

namespace msslam {

constexpr int kVis = 27;   // 21 unique entries of a 6x6 H, then 6 of g
constexpr float kMonoChi2 = 5.991f;     // ops/robust.py CHI2_2DOF
constexpr float kStereoChi2 = 7.815f;   // CHI2_3DOF
constexpr float kSmall2 = 1e-8f;        // ops/lie.py _SMALL2

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

// lie.rot_to_quat: Shepperd's quaternion (w, x, y, z), the largest pivot
// (the first of equals), normalized, w >= 0
__device__ __forceinline__ float ssqrt(float v) {
  return v > 1e-8f ? sqrtf(v) : 0.f;
}

__device__ __forceinline__ float safe_div(float d) {
  return fabsf(d) > 1e-6f ? d : 1.f;
}

__device__ __forceinline__ void rot_to_quat(const M3& R, float q[4]) {
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
}

// lie.so3_log: quat_log(rot_to_quat(R))
__device__ __forceinline__ V3 so3_log(const M3& R) {
  float q[4];
  rot_to_quat(R, q);
  const float w = fminf(fmaxf(q[0], -1.f), 1.f);
  const float vn2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const bool small = vn2 < 1e-16f;
  const float vn = sqrtf(small ? 1.f : vn2);
  const float s = small ? 2.f / fmaxf(w, 1e-8f) : 2.f * atan2f(vn, w) / vn;
  return V3{{q[1] * s, q[2] * s, q[3] * s}};
}

// lie.normalize_rotation: quat_to_rot(rot_to_quat(R))
__device__ __forceinline__ M3 normalize_rotation(const M3& R) {
  float q[4];
  rot_to_quat(R, q);
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  return M3{{1.f - 2.f * (y * y + z * z), 2.f * (x * y - w * z),
             2.f * (x * z + w * y), 2.f * (x * y + w * z),
             1.f - 2.f * (x * x + z * z), 2.f * (y * z - w * x),
             2.f * (x * z - w * y), 2.f * (y * z + w * x),
             1.f - 2.f * (x * x + y * y)}};
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
// Rows of the normal equations
// ---------------------------------------------------------------------------

// Adds the weighted row [m, d x m] with residual r to acc: the upper
// triangle of w J^T J (21, row by row) and w J^T r (6). m is a row of
// d(proj)/d(X) in the frame whose origin d is measured from, so [m, d x m]
// is the row's derivative wrt a left perturbation [translation, rotation].
__device__ __forceinline__ void add_row(float m0, float m1, float m2,
                                        const V3& d, float w, float r,
                                        float acc[kVis]) {
  const float J[6] = {m0, m1, m2, d.a[1] * m2 - d.a[2] * m1,
                      d.a[2] * m0 - d.a[0] * m2, d.a[0] * m1 - d.a[1] * m0};
  int k = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const float wj = w * J[p];
#pragma unroll
    for (int q = p; q < 6; ++q) acc[k++] += wj * J[q];
    acc[kVis - 6 + p] += wj * r;
  }
}

// Match i's right row of an unrectified pair: the residual through T_rl
// and the second lens (cameras.rig_project), its chi2 and the right-camera
// point. right: the (N,3) [u, v, sigma2] keypoints; P2 and T (R_rl | t_rl,
// 12 floats row-major) as the caller keeps them.
struct RightRow {
  V3 Xr;
  float r[2];
  float chi2, w_info;
};

__device__ __forceinline__ RightRow right_row(int model, const float* right,
                                              const float* P2, const float* T,
                                              const V3& Xc, int i) {
  RightRow o;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    o.Xr.a[k] = T[4 * k] * Xc.a[0] + T[4 * k + 1] * Xc.a[1]
                + T[4 * k + 2] * Xc.a[2] + T[4 * k + 3];
  float u, v;
  project(model, P2, o.Xr.a[0], o.Xr.a[1], o.Xr.a[2], u, v);
  o.r[0] = right[3 * i] - u;
  o.r[1] = right[3 * i + 1] - v;
  o.w_info = 1.f / fmaxf(right[3 * i + 2], 1e-12f);
  o.chi2 = (o.r[0] * o.r[0] + o.r[1] * o.r[1]) * o.w_info;
  return o;
}

// Row c of d(proj2)/d(Xc) = J2 R_rl for the right camera's Jacobian J2
// (2x3, row-major) and T = [R_rl | t_rl]
__device__ __forceinline__ void right_jac_row(const float J2[6],
                                              const float* T, int c,
                                              float e[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    e[k] = J2[3 * c] * T[k] + J2[3 * c + 1] * T[4 + k]
           + J2[3 * c + 2] * T[8 + k];
}

// robust.huber_weight
__device__ __forceinline__ float huber(float chi2, float d2) {
  const float c2 = fmaxf(chi2, 1e-12f);
  return c2 <= d2 ? 1.f : sqrtf(d2 / c2);
}

}  // namespace msslam
