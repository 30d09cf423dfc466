// The Lie-group and camera functions that VO's two kernels share
// (`localize.cu`, `ba_solve.cu`): `__device__` copies of
// `evo_tpu_torch/core/lie.py` (SE(3) as (qw, qx, qy, qz, tx, ty, tz), tangent
// (v, omega)) and `evo_tpu_torch/core/camera.py` (pinhole with radtan
// distortion, intrinsics [fx, fy, cx, cy, k1, k2, p1, p2, k3]).
//
// Each function takes its operations in the order the plain PyTorch code
// writes them, and the kernels are built with -fmad=false, so that a
// product and a sum round on their own as the plain version's do. Sums of
// three terms go left to right. The constants that the plain version holds
// as Python floats enter as their float32 roundings, as PyTorch casts them.
// The functions that the BA's float64 cost needs too are templates over the
// type (`T(2)` is 2.0f for float).

#pragma once

namespace vo {

constexpr float kLieEps = 1e-8f;

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <class T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// the plain `torch.linalg.norm` of 3 and 4 entries
__device__ __forceinline__ float norm3(const float* a) { return sqrtf(dot3(a, a)); }

__device__ __forceinline__ float safe_div(float num, float den) {
  const float safe = fabsf(den) < kLieEps ? (den < 0.0f ? -kLieEps : kLieEps) : den;
  return num / safe;
}

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// quat_rotate: v + 2 (w (q_v x v) + q_v x (q_v x v))
template <class T>
__device__ __forceinline__ void quat_rotate(const T* q, const T* v, T* out) {
  T uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
  for (int i = 0; i < 3; ++i) out[i] = v[i] + T(2) * (q[0] * uv[i] + uuv[i]);
}

__device__ __forceinline__ void quat_mul(const float* a, const float* b, float* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

__device__ __forceinline__ void quat_normalize(float* q) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// quat_to_matrix, row major
__device__ __forceinline__ void quat_to_matrix(const float* q, float* r) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  r[0] = 1.0f - 2.0f * (y * y + z * z);
  r[1] = 2.0f * (x * y - w * z);
  r[2] = 2.0f * (x * z + w * y);
  r[3] = 2.0f * (x * y + w * z);
  r[4] = 1.0f - 2.0f * (x * x + z * z);
  r[5] = 2.0f * (y * z - w * x);
  r[6] = 2.0f * (x * z - w * y);
  r[7] = 2.0f * (y * z + w * x);
  r[8] = 1.0f - 2.0f * (x * x + y * y);
}

// quat_from_matrix: the trace method's four candidates, the one of the
// largest of (trace, m00, m11, m22) taken (the first on a tie, as argmax),
// normalized, w >= 0
__device__ __forceinline__ void quat_from_matrix(const float* m, float* q) {
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = m00 + m11 + m22;
  int idx = 0;
  float best = tr;
  if (m00 > best) { idx = 1; best = m00; }
  if (m11 > best) { idx = 2; best = m11; }
  if (m22 > best) { idx = 3; }
  if (idx == 0) {
    q[0] = 1.0f + tr; q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  } else if (idx == 1) {
    q[0] = m21 - m12; q[1] = 1.0f + m00 - m11 - m22; q[2] = m01 + m10; q[3] = m02 + m20;
  } else if (idx == 2) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = 1.0f + m11 - m00 - m22; q[3] = m12 + m21;
  } else {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = 1.0f + m22 - m00 - m11;
  }
  quat_normalize(q);
  if (q[0] < 0.0f)
    for (int i = 0; i < 4; ++i) q[i] = q[i] * -1.0f;
}

// se3_inverse: (q*, -(q* t))
template <class T>
__device__ __forceinline__ void se3_inverse(const T* g, T* out) {
  const T qi[4] = {g[0], -g[1], -g[2], -g[3]};
  T t[3];
  quat_rotate(qi, g + 4, t);
  for (int i = 0; i < 4; ++i) out[i] = qi[i];
  for (int i = 0; i < 3; ++i) out[4 + i] = -t[i];
}

template <class T>
__device__ __forceinline__ void se3_apply(const T* g, const T* v, T* out) {
  T r[3];
  quat_rotate(g, v, r);
  for (int i = 0; i < 3; ++i) out[i] = r[i] + g[4 + i];
}

__device__ __forceinline__ void se3_compose(const float* a, const float* b, float* out) {
  float q[4], t[3];
  quat_mul(a, b, q);
  quat_normalize(q);
  quat_rotate(a, b + 4, t);
  for (int i = 0; i < 4; ++i) out[i] = q[i];
  for (int i = 0; i < 3; ++i) out[4 + i] = t[i] + a[4 + i];
}

// hat(w) v as `so3_hat(w) @ v` sums it: the row's zero term adds exactly
__device__ __forceinline__ void hat_mul(const float* w, const float* v, float* out) {
  out[0] = 0.0f * v[0] + -w[2] * v[1] + w[1] * v[2];
  out[1] = w[2] * v[0] + 0.0f * v[1] + -w[0] * v[2];
  out[2] = -w[1] * v[0] + w[0] * v[1] + 0.0f * v[2];
}

// se3_exp of (v, omega), with so3_exp's and se3_exp's small-angle branches
__device__ __forceinline__ void se3_exp(const float* xi, float* out) {
  const float* v = xi;
  const float* w = xi + 3;
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(th2 + 1e-16f);
  const float half = 0.5f * theta;
  const bool small = th2 < 1e-10f;
  const float k = small ? 0.5f - th2 / 48.0f : safe_div(sinf(half), theta);
  out[0] = cosf(half);
  for (int i = 0; i < 3; ++i) out[1 + i] = w[i] * k;
  const float b = small ? 0.5f - th2 / 24.0f : safe_div(1.0f - cosf(theta), th2);
  const float c = small ? 0.16666667f - th2 / 120.0f
                        : safe_div(theta - sinf(theta), th2 * theta);
  float wxv[3], wxwxv[3];
  hat_mul(w, v, wxv);
  hat_mul(w, wxv, wxwxv);
  for (int i = 0; i < 3; ++i) out[4 + i] = v[i] + b * wxv[i] + c * wxwxv[i];
}

// se3_retract: g exp(delta)
__device__ __forceinline__ void se3_retract(const float* g, const float* delta, float* out) {
  float e[7];
  se3_exp(delta, e);
  se3_compose(g, e, out);
}

// -- the camera ---------------------------------------------------------------
template <class T>
__device__ __forceinline__ void distort(const T* k, T x, T y, T* xd, T* yd) {
  const T k1 = k[4], k2 = k[5], p1 = k[6], p2 = k[7], k3 = k[8];
  const T r2 = x * x + y * y;
  const T radial = T(1) + r2 * (k1 + r2 * (k2 + r2 * k3));
  *xd = x * radial + T(2) * p1 * x * y + p2 * (r2 + T(2) * x * x);
  *yd = y * radial + p1 * (r2 + T(2) * y * y) + T(2) * p2 * x * y;
}

template <class T>
__device__ __forceinline__ void project(const T* k, const T* p, T* pix) {
  T xd, yd;
  distort(k, p[0] / p[2], p[1] / p[2], &xd, &yd);
  pix[0] = k[0] * xd + k[2];
  pix[1] = k[1] * yd + k[3];
}

// d project / d p, [2, 3] row major (camera.project_jacobian)
__device__ __forceinline__ void project_jacobian(const float* k, const float* p, float* J) {
  const float k1 = k[4], k2 = k[5], p1 = k[6], p2 = k[7], k3 = k[8];
  const float iz = 1.0f / p[2];
  const float x = p[0] * iz, y = p[1] * iz;
  const float r2 = x * x + y * y;
  const float radial = 1.0f + r2 * (k1 + r2 * (k2 + r2 * k3));
  const float rp = k1 + r2 * (2.0f * k2 + 3.0f * r2 * k3);
  const float dxx = radial + 2.0f * x * x * rp + 2.0f * p1 * y + 6.0f * p2 * x;
  const float dxy = 2.0f * x * y * rp + 2.0f * p1 * x + 2.0f * p2 * y;
  const float dyx = dxy;
  const float dyy = radial + 2.0f * y * y * rp + 6.0f * p1 * y + 2.0f * p2 * x;
  J[0] = k[0] * (dxx * iz);
  J[1] = k[0] * (dxy * iz);
  J[2] = k[0] * (-(dxx * x + dxy * y) * iz);
  J[3] = k[1] * (dyx * iz);
  J[4] = k[1] * (dyy * iz);
  J[5] = k[1] * (-(dyx * x + dyy * y) * iz);
}

// unproject: undistort by 10 fixed-point steps, then the unit bearing
__device__ __forceinline__ void unproject(const float* k, const float* pix, float* b) {
  const float x0 = (pix[0] - k[2]) / k[0], y0 = (pix[1] - k[3]) / k[1];
  float x = x0, y = y0;
  for (int it = 0; it < 10; ++it) {
    float xd, yd;
    distort(k, x, y, &xd, &yd);
    x = x - (xd - x0);
    y = y - (yd - y0);
  }
  const float v[3] = {x, y, 1.0f};
  const float n = norm3(v);
  for (int i = 0; i < 3; ++i) b[i] = v[i] / n;
}

}  // namespace vo
