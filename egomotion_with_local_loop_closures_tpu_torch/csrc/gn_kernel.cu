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
// The device helpers (exp_se3, log_se3 and their parts, the NaN-propagating
// clamps, and the gather semantics to_index, corner and blend) live in
// csrc/ellc_device.cuh, which K2 (csrc/stereo_kernel.cu) includes too.
//
// Built with -fmad=false (no contracted multiply-add), as the port's other
// kernels.  Plain C interface, bound with ctypes: each entry point launches
// on the given stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ellc_device.cuh"

namespace {

constexpr int kThreads = 256;
// H's lower triangle (row-major, i >= j), g, the energy, the used count
constexpr int kSums = 29;
constexpr int kEnergy = 27, kValid = 28;
// K1b: partials summed by kGroups groups of 32 threads, lane c summing
// entry c of every kGroups-th block
constexpr int kGroups = kThreads / 32;

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
