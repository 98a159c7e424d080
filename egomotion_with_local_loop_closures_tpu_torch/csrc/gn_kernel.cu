// One Gauss-Newton iteration of the tracker (K1) for NVIDIA Hopper (sm_90a),
// as two kernels.
//
// Replaces the XLA program of one GN iteration in the JAX package:
// egomotion_with_local_loop_closures_tpu/track/alignment.py::_gn_quantities
// (alignment.py:89-170, the gather path) with the 6x6 solve of
// geom/linear.py::solve_spd, the pose update lie.compose and the freeze
// mask of gn_level (alignment.py:314).  On the TPU, XLA fuses all of it
// into one program per iteration; the port's plain version
// (track/alignment.py) runs it as ~900 small ATen kernels.
//
//   gn_linearize (K1a): grid (blocks of the level, V), 256 threads, one
//     template pixel a thread.  Each thread warps its pixel by exp(pose[v])
//     (computed once per block into shared memory), samples the current
//     image and its two gradients bilinearly with the port's gather
//     semantics (image/interp.py), forms the residual, the variance and
//     Huber weight and the six steepest-descent rows, and holds 29 float32
//     terms: the 21 entries of H's lower triangle, the 6 of g, the energy
//     and the used-pixel count.  A shared-memory tree in a fixed order
//     sums them over the block, which writes partials[v, block, 0..28].
//   gn_finish (K1b): grid (V), 256 threads.  The block sums its video's
//     partials in a fixed order, then one thread solves the 6x6 system
//     (unrolled Cholesky in the order of the JAX package's geom/linear.py,
//     NaN where H is not positive definite), zeroes a failed or
//     astronomical step, composes the update onto the pose formula by
//     formula as the port's geom/lie.py does, and applies the freeze mask.
//
// The block count of K1a is fixed by the level's shape, never by V, and no
// sum uses atomics: a video of a batch gets the bits it gets alone.
//
// What bounds it.  Counting each input byte read once: K1a reads the
// keyframe's image, depth and variance and the current image and its two
// gradients, 24 B a pixel, 3.11 MB at 270x480 (0.93 us at 3.35 TB/s); its
// float32 work, ~250 operations a pixel, is 32 MFLOP (0.5 us at 67
// TFLOP/s).  K1b moves a few kB and does a few thousand serial operations:
// its time is the latency of one thread's chain of dependent divisions,
// square roots and sines, a few microseconds, whatever the card's rates.
// So one iteration is bound by K1b's latency and the two launches, not by
// bytes or arithmetic.  A video that has converged skips both kernels'
// work (its blocks return at once), as the plain version's freeze mask
// discards it.
//
// Built with -fmad=false (no contracted multiply-add), as the port's other
// kernel.  Plain C interface, bound with ctypes: each entry point launches
// on the given stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// H's lower triangle (row-major, i >= j), g, the energy, the used count
constexpr int kSums = 29;
constexpr int kEnergy = 27, kValid = 28;
// K1b: partials summed by kGroups groups of 32 threads, lane c summing
// entry c of every kGroups-th block
constexpr int kGroups = kThreads / 32;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTheta2Small = 1e-4f;       // lie.py _THETA2_SMALL
constexpr float kEps = 1e-8f;               // lie.py _EPS

struct LinArgs {
  const float* __restrict__ kf_image;       // (V, h, w)
  const float* __restrict__ kf_depth;
  const float* __restrict__ kf_var;
  const float* __restrict__ cur_image;      // (V, ch, w)
  const float* __restrict__ cur_gradx;
  const float* __restrict__ cur_grady;
  const float* __restrict__ pose;           // (V, 6)
  const int32_t* __restrict__ done;         // (V,) or null
  float* __restrict__ partials;             // (V, nblocks, kSums)
  int h, w, ch, y_offset, nblocks;
  float fx, fy, cx, cy, noise2, half_huber;
};

struct FinArgs {
  const float* __restrict__ partials;       // (V, nblocks, kSums)
  const float* pose_in;                     // (V, 6); pose on later iters
  float* pose;                              // (V, 6)
  float* wp_last;                           // (V,)
  int32_t* iters;
  float* energy;
  float* valid;
  int32_t* done;
  int nblocks, first;
  float term_w[6];
};

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

__global__ void __launch_bounds__(kThreads) gn_linearize(const LinArgs a) {
  const int v = blockIdx.y;
  // a converged video: gn_finish ignores this iteration's sums
  if (a.done != nullptr && a.done[v] != 0) return;
  __shared__ float s_T[12];
  __shared__ float s_sum[kSums][kThreads];
  const int t = threadIdx.x;
  if (t == 0) {
    float R[3][3], tr[3];
    exp_se3(a.pose + 6 * v, R, tr);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) s_T[3 * i + j] = R[i][j];
      s_T[9 + i] = tr[i];
    }
  }
  __syncthreads();

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  const int n = a.h * a.w;
  const int p = blockIdx.x * kThreads + t;
  if (p < n) {
    const int row = p / a.w, col = p - (p / a.w) * a.w;
    const size_t base = (size_t)v * n + p;
    const float x = (float)col, y = (float)(row + a.y_offset);
    const float d = a.kf_depth[base];
    const bool mask = d > 0.f;
    // backproject (geom/camera.py), R P + t, project with UNZERO 1e-10
    const float X = (x - a.cx) * d / a.fx;
    const float Y = (y - a.cy) * d / a.fy;
    const float px = ((X * s_T[0] + Y * s_T[1]) + d * s_T[2]) + s_T[9];
    const float py = ((X * s_T[3] + Y * s_T[4]) + d * s_T[5]) + s_T[10];
    const float pz = ((X * s_T[6] + Y * s_T[7]) + d * s_T[8]) + s_T[11];
    float z = pz;
    if (fabsf(z) < 1e-10f) z = z < 0.f ? -1e-10f : 1e-10f;
    const float wx = px / z * a.fx + a.cx;
    const float wy = py / z * a.fy + a.cy;

    // three bilinear samples at one set of corners (image/interp.py)
    const float x0 = floorf(wx), y0 = floorf(wy);
    const float ax = wx - x0, ay = wy - y0;
    const int x0i = to_index(x0, a.w), y0i = to_index(y0, a.ch);
    const int x1i = to_index(ceilf(wx), a.w), y1i = to_index(ceilf(wy), a.ch);
    const size_t cbase = (size_t)v * a.ch * a.w;
    const float* planes[3] = {a.cur_image + cbase, a.cur_gradx + cbase,
                              a.cur_grady + cbase};
    float s[3];
    bool m00 = false, m01 = false, m10 = false, m11 = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v00 = corner(planes[k], x0i, y0i, a.ch, a.w, &m00);
      const float v01 = corner(planes[k], x1i, y0i, a.ch, a.w, &m01);
      const float v10 = corner(planes[k], x0i, y1i, a.ch, a.w, &m10);
      const float v11 = corner(planes[k], x1i, y1i, a.ch, a.w, &m11);
      s[k] = blend(v00, v01, v10, v11, ax, ay);
    }
    const bool in_bounds = m00 || m01 || m10 || m11;
    const float gradx = s[1], grady = s[2];

    const float u = x - a.cx, vv = y - a.cy;
    const float inv_d = 1.f / (mask ? d : 1.f);
    const float residual = in_bounds ? s[0] - a.kf_image[base] : 0.f;

    // variance-propagated weight and Huber weight (_pixel_terms)
    const float tx = s_T[9], ty = s_T[10], tz = s_T[11];
    const float gxs = a.fx * gradx, gys = a.fy * grady;
    const float pz2d = mask ? pz * pz * inv_d : 1.f;
    const float g0 = (tx * pz - tz * px) / pz2d;
    const float g1 = (ty * pz - tz * py) / pz2d;
    const float drpdd = gxs * g0 + gys * g1;
    const float sv = max_nan(a.kf_var[base], 0.f);
    const float w_p = 1.f / (a.noise2 + sv * drpdd * drpdd);
    const float wrp = fabsf(residual * sqrtf(w_p));
    const float wh = wrp < a.half_huber
                         ? 1.f : a.half_huber / max_nan(wrp, 1e-12f);
    const bool used = mask && in_bounds;
    const float weight = used ? wh * w_p : 0.f;

    // steepest-descent rows (_steepest_descent)
    float J[6];
    J[0] = gradx * (-(vv * u) / a.fy) + grady * (-(a.fy + (vv * vv) / a.fy));
    J[1] = gradx * (a.fx + (u * u) / a.fx) + grady * ((vv * u) / a.fx);
    J[2] = gradx * (-(a.fx * vv) / a.fy) + grady * ((a.fy * u) / a.fx);
    J[3] = gradx * (a.fx * inv_d);
    J[4] = grady * (a.fy * inv_d);
    J[5] = gradx * (-u * inv_d) + grady * (-vv * inv_d);

#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float Ai = J[i] * weight;
#pragma unroll
      for (int j = 0; j <= i; ++j) acc[i * (i + 1) / 2 + j] = Ai * J[j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] = (J[i] * weight) * residual;
    acc[kEnergy] = weight * residual * residual;
    acc[kValid] = used ? 1.f : 0.f;
  }

#pragma unroll
  for (int k = 0; k < kSums; ++k) s_sum[k][t] = acc[k];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (t < half)
      for (int k = 0; k < kSums; ++k)
        s_sum[k][t] = s_sum[k][t] + s_sum[k][t + half];
    __syncthreads();
  }
  if (t < kSums)
    a.partials[((size_t)v * a.nblocks + blockIdx.x) * kSums + t] =
        s_sum[t][0];
}

__global__ void __launch_bounds__(kThreads) gn_finish(const FinArgs a) {
  const int v = blockIdx.x;
  // a converged video keeps every value (the freeze mask)
  if (!a.first && a.done[v] != 0) return;
  __shared__ float s_part[kGroups][32];
  __shared__ float s_tot[kSums];
  const int t = threadIdx.x, c = t & 31, grp = t >> 5;
  float acc = 0.f;
  if (c < kSums)
    for (int b = grp; b < a.nblocks; b += kGroups)
      acc = acc + a.partials[((size_t)v * a.nblocks + b) * kSums + c];
  s_part[grp][c] = acc;
  __syncthreads();
  if (t < kSums) {
    float s = s_part[0][t];
    for (int q = 1; q < kGroups; ++q) s = s + s_part[q][t];
    s_tot[t] = s;
  }
  __syncthreads();
  if (t != 0) return;

  // H + 1e-12 I from its lower triangle, then the unrolled Cholesky and
  // substitutions of geom/linear.py; NaN where H is not positive definite
  float L[6][6], Hl[6][6], y[6], x[6];
  for (int i = 0, k = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j, ++k)
      Hl[i][j] = s_tot[k] + (i == j ? 1e-12f : 0.f);
  bool pd = true;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) {
      float s = Hl[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        pd = pd && s > 0.f;
        L[i][i] = sqrtf(s);
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  for (int i = 0; i < 6; ++i) {
    float s = s_tot[21 + i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  // the step; zero where it is not finite or exceeds 1e3 in a component
  // (OpenCV's inv() of a singular system, PixelWisePyramid.cpp:451)
  float delta[6];
  bool ok = true;
  float amax = 0.f;
  for (int i = 0; i < 6; ++i) {
    delta[i] = pd ? -x[i] : __int_as_float(0x7fc00000);
    ok = ok && finite_f(delta[i]);
    amax = fmaxf(amax, fabsf(delta[i]));
  }
  ok = ok && amax < 1e3f;
  for (int i = 0; i < 6; ++i) delta[i] = ok ? delta[i] : 0.f;

  // compose(delta, pose) = log(exp(delta) exp(pose))
  float p[6];
  for (int i = 0; i < 6; ++i) p[i] = a.pose_in[6 * v + i];
  float R1[3][3], t1[3], R2[3][3], t2[3], R[3][3], tt[3], out[6];
  exp_se3(delta, R1, t1);
  exp_se3(p, R2, t2);
  mat3(R1, R2, R);
  for (int i = 0; i < 3; ++i)
    tt[i] = ((R1[i][0] * t2[0] + R1[i][1] * t2[1]) + R1[i][2] * t2[2]) + t1[i];
  log_se3(R, tt, out);

  float wp = 0.f;
  for (int i = 0; i < 6; ++i) wp = wp + fabsf(delta[i] * a.term_w[i]);
  for (int i = 0; i < 6; ++i) a.pose[6 * v + i] = out[i];
  a.wp_last[v] = wp;
  a.iters[v] = a.first ? 1 : a.iters[v] + 1;
  a.energy[v] = s_tot[kEnergy];
  a.valid[v] = s_tot[kValid];
  a.done[v] = (wp < 1.f || !ok) ? 1 : 0;
}

}  // namespace

// K1a over V videos: template planes (V, h, w), current planes (V, ch, w),
// poses (V, 6); done (V,) or null (the level's first iteration); writes
// partials (V, nblocks, 29), nblocks = ceil(h w / 256).
extern "C" int ellc_gn_linearize(
    const float* kf_image, const float* kf_depth, const float* kf_var,
    const float* cur_image, const float* cur_gradx, const float* cur_grady,
    const float* pose, const int32_t* done, float* partials, int V, int h,
    int w, int ch, int y_offset, float fx, float fy, float cx, float cy,
    float noise2, float half_huber, void* stream) {
  const int nblocks = (h * w + kThreads - 1) / kThreads;
  const LinArgs a{kf_image, kf_depth, kf_var, cur_image, cur_gradx,
                  cur_grady, pose, done, partials, h, w, ch, y_offset,
                  nblocks, fx, fy, cx, cy, noise2, half_huber};
  const dim3 grid(nblocks, V);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  gn_linearize<<<grid, dim3(kThreads), 0, stream_>>>(a);
  return (int)cudaGetLastError();
}

// K1b over V videos: sums partials (V, nblocks, 29), solves, updates and
// freezes.  first = 1 on a level's first iteration: the pose is read from
// pose_in and the freeze state is started (nothing frozen, iters 0); else
// pose_in is pose and every array holds the previous iteration's values.
extern "C" int ellc_gn_finish(
    const float* partials, const float* pose_in, float* pose, float* wp_last,
    int32_t* iters, float* energy, float* valid, int32_t* done, int V,
    int nblocks, int first, float tw0, float tw1, float tw2, float tw3,
    float tw4, float tw5, void* stream) {
  const FinArgs a{partials, pose_in, pose, wp_last, iters, energy, valid,
                  done, nblocks, first, {tw0, tw1, tw2, tw3, tw4, tw5}};
  const cudaStream_t stream_ = (cudaStream_t)stream;
  gn_finish<<<dim3(V), dim3(kThreads), 0, stream_>>>(a);
  return (int)cudaGetLastError();
}
