// Device helpers shared by the port's hand-written kernels (K1,
// csrc/gn_kernel.cu, K2, csrc/stereo_kernel.cu, the SE(3) compose,
// csrc/se3_kernel.cu, and propagate, csrc/propagate_kernel.cu): the
// Lie-group algebra of geom/lie.py formula by formula (exp_se3, log_se3
// and their parts),
// NaN-propagating clamps, and the port's bilinear gather semantics
// (image/interp.py: to_index, corner, blend).  Each source that includes
// this header compiles its own copy of the helpers (internal linkage), so
// nothing here changes a kernel's code: the helpers are inlined as they
// were when they sat in gn_kernel.cu.
//
// ops/__init__.py hashes every header of csrc/ into each library's name,
// so an edit here rebuilds every library.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTheta2Small = 1e-4f;       // lie.py _THETA2_SMALL
constexpr float kEps = 1e-8f;               // lie.py _EPS

__device__ __forceinline__ bool finite_f(float v) {
  return fabsf(v) <= 3.402823466e38f;       // false for inf and NaN
}

// max(v, lo) that propagates NaN, as torch.clamp_min does
__device__ __forceinline__ float max_nan(float v, float lo) {
  return (v != v) ? v : (v > lo ? v : lo);
}

// (A, B, C) = (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) with the
// Taylor branches below kTheta2Small (lie.py _sinc_coeffs)
__device__ __forceinline__ void sinc_coeffs(float theta2, float* A, float* B,
                                            float* C) {
  const bool small = theta2 < kTheta2Small;
  const float t2s = small ? 1.f : theta2;
  const float ts = sqrtf(t2s);
  const float s = sinf(ts);
  *A = small ? 1.f - theta2 / 6.f : s / ts;
  *B = small ? 0.5f - theta2 / 24.f : (1.f - cosf(ts)) / t2s;
  *C = small ? (float)(1.0 / 6.0) - theta2 / 120.f : (ts - s) / (t2s * ts);
}

__device__ __forceinline__ void hat(const float* w, float W[3][3]) {
  W[0][0] = 0.f;   W[0][1] = -w[2]; W[0][2] = w[1];
  W[1][0] = w[2];  W[1][1] = 0.f;   W[1][2] = -w[0];
  W[2][0] = -w[1]; W[2][1] = w[0];  W[2][2] = 0.f;
}

__device__ __forceinline__ void mat3(const float A[3][3], const float B[3][3],
                                     float C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

// exp of a twist [w, v] (lie.py exp_se3): R = I + A W + B W^2,
// t = (I + B W + C W^2) v
__device__ void exp_se3(const float* xi, float R[3][3], float t[3]) {
  const float theta2 = xi[0] * xi[0] + xi[1] * xi[1] + xi[2] * xi[2];
  float A, B, C;
  sinc_coeffs(theta2, &A, &B, &C);
  float W[3][3], W2[3][3], V[3][3];
  hat(xi, W);
  mat3(W, W, W2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.f : 0.f;
      R[i][j] = (I + A * W[i][j]) + B * W2[i][j];
      V[i][j] = (I + B * W[i][j]) + C * W2[i][j];
    }
  for (int i = 0; i < 3; ++i)
    t[i] = V[i][0] * xi[3] + V[i][1] * xi[4] + V[i][2] * xi[5];
}

__device__ __forceinline__ float safe_sqrt(float a) {
  return sqrtf(max_nan(a, 1e-12f));
}

// rotation matrix -> unit quaternion, scalar first, by the Shepperd pivot
// (lie.py quat_from_matrix): the branch of the largest of the trace and
// the diagonal, the first on a tie (each branch reads all nine entries,
// so a NaN anywhere gives a NaN quaternion whichever branch is taken)
__device__ void quat_from_matrix(const float m[3][3], float q[4]) {
  const float tr = m[0][0] + m[1][1] + m[2][2];
  int c = 0;
  float best = tr;
  if (m[0][0] > best) { c = 1; best = m[0][0]; }
  if (m[1][1] > best) { c = 2; best = m[1][1]; }
  if (m[2][2] > best) { c = 3; }
  if (c == 0) {
    const float S = safe_sqrt(1.f + tr) * 2.f;
    q[0] = S / 4.f;
    q[1] = (m[2][1] - m[1][2]) / S;
    q[2] = (m[0][2] - m[2][0]) / S;
    q[3] = (m[1][0] - m[0][1]) / S;
  } else if (c == 1) {
    const float S = safe_sqrt(((1.f + m[0][0]) - m[1][1]) - m[2][2]) * 2.f;
    q[0] = (m[2][1] - m[1][2]) / S;
    q[1] = S / 4.f;
    q[2] = (m[0][1] + m[1][0]) / S;
    q[3] = (m[0][2] + m[2][0]) / S;
  } else if (c == 2) {
    const float S = safe_sqrt(((1.f - m[0][0]) + m[1][1]) - m[2][2]) * 2.f;
    q[0] = (m[0][2] - m[2][0]) / S;
    q[1] = (m[0][1] + m[1][0]) / S;
    q[2] = S / 4.f;
    q[3] = (m[1][2] + m[2][1]) / S;
  } else {
    const float S = safe_sqrt(((1.f - m[0][0]) - m[1][1]) + m[2][2]) * 2.f;
    q[0] = (m[1][0] - m[0][1]) / S;
    q[1] = (m[0][2] + m[2][0]) / S;
    q[2] = (m[1][2] + m[2][1]) / S;
    q[3] = S / 4.f;
  }
  const float sign = q[0] < 0.f ? -1.f : 1.f;
  for (int i = 0; i < 4; ++i) q[i] = q[i] * sign;
  const float n = max_nan(
      sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), kEps);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// unit quaternion -> rotation vector, angle in (-pi, pi] (lie.py log_quat)
__device__ void log_quat(const float q[4], float w[3]) {
  const float s = sqrtf(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  float theta = 2.f * atan2f(s, q[0]);
  if (theta >= kPi) theta = theta - 2.f * kPi;
  if (theta < -kPi) theta = theta + 2.f * kPi;
  const float scale = s < kEps ? 2.f : theta / max_nan(s, kEps);
  for (int i = 0; i < 3; ++i) w[i] = q[i + 1] * scale;
}

// log of [R | t] (lie.py log_se3): w = log_so3(R), v = V^-1 t with
// V^-1 = I - W / 2 + D W^2
__device__ void log_se3(const float R[3][3], const float t[3], float xi[6]) {
  float q[4];
  quat_from_matrix(R, q);
  log_quat(q, xi);
  const float theta2 = xi[0] * xi[0] + xi[1] * xi[1] + xi[2] * xi[2];
  float A, B, C;
  sinc_coeffs(theta2, &A, &B, &C);
  const bool small = theta2 < kTheta2Small;
  const float t2s = small ? 1.f : theta2;
  const float D = small ? (float)(1.0 / 12.0) + theta2 / 720.f
                        : (1.f - A / (2.f * B)) / t2s;
  float W[3][3], W2[3][3];
  hat(xi, W);
  mat3(W, W, W2);
  for (int i = 0; i < 3; ++i) {
    float Vi[3];
    for (int j = 0; j < 3; ++j)
      Vi[j] = ((i == j ? 1.f : 0.f) - 0.5f * W[i][j]) + D * W2[i][j];
    xi[3 + i] = Vi[0] * t[0] + Vi[1] * t[1] + Vi[2] * t[2];
  }
}

// float coordinate -> index, as image/interp.py _to_index: clamped to
// [-1, n] (NaN stays NaN) and converted
__device__ __forceinline__ int to_index(float v, int n) {
  const float c = (v != v) ? v : fminf(fmaxf(v, -1.f), (float)n);
  return (int)c;
}

// The corner (xi, yi) of a bilinear sample: its value, 0 outside the image
__device__ __forceinline__ float corner(const float* __restrict__ img, int xi,
                                       int yi, int ch, int cw, bool* ok) {
  *ok = xi >= 0 && xi <= cw - 1 && yi >= 0 && yi <= ch - 1;
  const int yc = yi < 0 ? 0 : (yi > ch - 1 ? ch - 1 : yi);
  const int xc = xi < 0 ? 0 : (xi > cw - 1 ? cw - 1 : xi);
  return *ok ? img[yc * cw + xc] : 0.f;
}

__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float ax, float ay) {
  const float top = (1.f - ax) * v00 + ax * v01;
  const float bottom = (1.f - ax) * v10 + ax * v11;
  return (1.f - ay) * top + ay * bottom;
}

}  // namespace
