// The Gauss-Newton iterations of the tracker (K1) for NVIDIA Hopper
// (sm_90a): a small level's iterations in one thread-block-cluster launch
// per video, and a larger level's iterations one launch each.
//
// Replaces the XLA program of one GN iteration in the JAX package:
// egomotion_with_local_loop_closures_tpu/track/alignment.py::_gn_quantities
// (alignment.py:89-170, the gather path) with the 6x6 solve of
// geom/linear.py::solve_spd, the pose update lie.compose and the freeze
// mask of gn_level (alignment.py:314).  On the TPU, XLA fuses all of it
// into one program per iteration; the port's plain version
// (track/alignment.py) runs it as ~900 small ATen kernels.
//
// Each iteration linearizes every template pixel (warp by exp(pose),
// three bilinear samples of the current image and its gradients with the
// port's gather semantics, image/interp.py; the residual, the variance and
// Huber weight and the six steepest-descent rows), sums 29 float32 terms
// (the 21 entries of H's lower triangle, the 6 of g, the energy and the
// used-pixel count), then one thread solves the 6x6 system (unrolled
// Cholesky in the order of the JAX package's geom/linear.py, NaN where H is
// not positive definite), zeroes a failed or astronomical step, composes
// it onto the pose formula by formula as geom/lie.py does, and applies the
// freeze mask.
//
// What bounds it.  Counting each input byte once, an iteration at 270x480
// reads six planes, 24 B a pixel: 3.11 MB, 0.93 us at 3.35 TB/s; its
// ~220 float32 operations a pixel are 0.43 us at 67 TFLOP/s.  The coarser
// levels (135x240, 67x120, 33x60) need 0.23, 0.06 and 0.014 us.  Against
// that, one iteration's finish is a serial chain of ~640 dependent
// operations (divisions, square roots, sines) in one thread, a few
// microseconds whatever the card's rates, and every launch costs a few
// microseconds more.  So K1 is bound by latency: the finish's chain, the
// launches, and the gathers' chain in each pixel, not by bytes.
//
// What the design does about it:
//   gn_level_cluster: a whole level in one launch.  Grid (kClusterBlocks,
//     V), one cluster of kClusterBlocks blocks a video (__cluster_dims__,
//     so the launch stays a plain <<<>>>).  The hardware schedules a
//     cluster's blocks together, so the level's iterations loop inside
//     the launch and meet at cluster.sync(), with no grid barrier.  Each
//     iteration, every thread linearizes a fixed, strided set of pixels,
//     the block reduces with warp shuffles, and after one cluster.sync()
//     every block reads all ranks' sums through distributed shared memory
//     in rank order and its thread 0 finishes, alike in every block (the
//     same bits), writing the new pose's transform for the next iteration
//     into its shared memory: one cluster barrier an iteration, and no
//     broadcast.  The blocks leave the loop together when the video
//     freezes.  Its shared memory is dynamic, one buffer a block.
//   gn_step: one launch an iteration, for the levels where a cluster's
//     threads would each walk several pixels in turn (more than
//     CLUSTER_MAX_PIXELS, ops/gn_kernel.py: levels 0 and 1 at 270x480).
//     Grid (ceil(h w / 256), V), a thread a pixel, the shuffle reduction;
//     each block writes its partials and takes a ticket (one integer
//     atomicAdd on a counter of its video, after a __threadfence), and the
//     block that takes the last ticket sums the video's partials in a
//     fixed order of the block index (coherent loads), finishes, writes
//     the next iteration's transform and resets the counter to 0.  A mode
//     that only linearizes (partials out: the pixel-sharded path, at a row
//     offset) and one that only finishes a given system (tests) share it.
// Neither reads exp(pose) serially at a block's start but on a level's
// first iteration: the finish that ends one iteration forms the next one's
// transform (the same exp_se3 of the same bits; gn_step hands it on in a
// (V, 12) buffer), and composes the step onto the transform it linearized
// at.
//
// Every sum runs in an order fixed by the level's shape, never by V or by
// the order blocks arrive in, and no float is summed with atomics: a video
// of a batch gets the bits it gets alone.  A converged or failed video
// freezes: its values stay those of its last live iteration.
//
// Both kernels count the live iterations into an int64 row of the level
// (utils/profiling.py's k1_live table; null counts nothing): entry i gains
// one for each video not frozen at the start of iteration i, with one
// integer atomicAdd, from the cluster's rank-0 block at each of its
// iterations, or from gn_step's block that takes the video's last ticket.
//
// The device helpers (exp_se3, log_se3 and their parts, the NaN-propagating
// clamps, and the gather semantics to_index, corner and blend) live in
// csrc/ellc_device.cuh, which K2 (csrc/stereo_kernel.cu) includes too.
//
// Built with -fmad=false (no contracted multiply-add), as the port's other
// kernels.  Plain C interface, bound with ctypes: each entry point launches
// on the given stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError() (0 on success).  The CPU emulation of the tests
// (tests/cuda_emulation.py) builds it with a smaller cluster
// (ELLC_CLUSTER_BLOCKS, ELLC_CLUSTER_THREADS).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ellc_device.cuh"

#ifndef ELLC_CLUSTER_BLOCKS
#define ELLC_CLUSTER_BLOCKS 8
#endif
#ifndef ELLC_CLUSTER_THREADS
#define ELLC_CLUSTER_THREADS 512
#endif


namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;               // gn_step: a thread a pixel
// gn_step's blocks an SM must hold: 64 registers a thread, no spill
// (76 unbounded; 4 beat 1, 3 and 6 at levels 0-1, tools/tune_gn_kernel.py)
constexpr int kStepMinBlocks = 4;
constexpr int kClusterBlocks = ELLC_CLUSTER_BLOCKS;
constexpr int kClusterThreads = ELLC_CLUSTER_THREADS;
// H's lower triangle (row-major, i >= j), g, the energy, the used count,
// in 32 slots (a warp's lanes)
constexpr int kSums = 29, kSlots = 32;
constexpr int kEnergy = 27, kValid = 28;
constexpr unsigned kAllLanes = 0xffffffffu;
// gn_step's modes
constexpr int kIterate = 0, kLinearize = 1, kFinish = 2;
// gn_step's finish: the partials summed by kGroups groups of 32 threads,
// lane c summing entry c of every kGroups-th block
constexpr int kGroups = kThreads / 32;
// gn_level_cluster's dynamic shared memory, in floats: the warps' sums,
// two buffers of the block's sums, the cluster's sums, the transform and
// the freeze flag
constexpr int kClusterSmemFloats = kClusterThreads + 3 * kSlots + 16;

struct Planes {
  const float* kf_image;                    // (V, h, w)
  const float* kf_depth;
  const float* kf_var;
  const float* cur_image;                   // (V, ch, w)
  const float* cur_gradx;
  const float* cur_grady;
  int h, w, ch, y_offset;
  float fx, fy, cx, cy, noise2, half_huber;
};

struct State {                              // (V,) each, pose (V, 6)
  float* pose;
  float* wp_last;
  int32_t* iters;
  float* energy;
  float* valid;
  int32_t* done;
};

// One video's GN state while a thread finishes it: the pose, its
// transform [R | t] (R row-major, then t) and the freeze state
struct Video {
  float pose[6], T[12];
  float wp_last, energy, valid;
  int32_t iters, done;
};

struct StepArgs {
  Planes pl;
  const float* pose_in;   // (V, 6): the pose of this iteration
  State st;               // written by the finish (done read on entry)
  float* T;               // (V, 12): the transform of st.pose
  float* partials;        // (V, nblocks, kSums)
  int32_t* tickets;       // (V,), 0 between launches
  unsigned long long* live;  // the level's live counts, or null
  int nblocks, mode, first, iter;
  float term_w[6];
};

struct LevelArgs {
  Planes pl;
  const float* pose0;     // (V, 6)
  State st;
  unsigned long long* live;  // the level's live counts, or null
  int num_iters;
  float term_w[6];
};

__device__ __forceinline__ void to_T(const float R[3][3], const float t[3],
                                     float* T) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) T[3 * i + j] = R[i][j];
    T[9 + i] = t[i];
  }
}

// exp_se3(pose) into T
__device__ void transform_of(const float* pose, float* T) {
  float R[3][3], t[3];
  exp_se3(pose, R, t);
  to_T(R, t, T);
}

// Pixel p of video v's template at the transform T: adds its 29 terms to
// acc (acc[k] + term, in the order the caller visits pixels)
__device__ __forceinline__ void add_pixel(const Planes& a, const float* T,
                                          int v, int p,
                                          float (&acc)[kSlots]) {
  const int n = a.h * a.w;
  const int row = p / a.w, col = p - (p / a.w) * a.w;
  const size_t base = (size_t)v * n + p;
  const float x = (float)col, y = (float)(row + a.y_offset);
  const float d = a.kf_depth[base];
  const bool mask = d > 0.f;
  // backproject (geom/camera.py), R P + t, project with UNZERO 1e-10
  const float X = (x - a.cx) * d / a.fx;
  const float Y = (y - a.cy) * d / a.fy;
  const float px = ((X * T[0] + Y * T[1]) + d * T[2]) + T[9];
  const float py = ((X * T[3] + Y * T[4]) + d * T[5]) + T[10];
  const float pz = ((X * T[6] + Y * T[7]) + d * T[8]) + T[11];
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
  const float tx = T[9], ty = T[10], tz = T[11];
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
    for (int j = 0; j <= i; ++j)
      acc[i * (i + 1) / 2 + j] = acc[i * (i + 1) / 2 + j] + Ai * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    acc[21 + i] = acc[21 + i] + (J[i] * weight) * residual;
  acc[kEnergy] = acc[kEnergy] + weight * residual * residual;
  acc[kValid] = acc[kValid] + (used ? 1.f : 0.f);
}

// One step of a warp's butterfly: a lane whose bit kWidth is clear keeps
// slots [0, kWidth) and sends [kWidth, 2 kWidth) to the lane across, which
// keeps the upper half; each adds what it receives to what it keeps.  The
// slot indices are constants, so acc stays in registers.
template <int kWidth>
__device__ __forceinline__ void fold(float (&acc)[kSlots], int lane) {
  const bool upper = (lane & kWidth) != 0;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const float send = upper ? acc[j] : acc[j + kWidth];
    const float keep = upper ? acc[j + kWidth] : acc[j];
    acc[j] = keep + __shfl_xor_sync(kAllLanes, send, kWidth);
  }
}

// The block's 29 sums into out[0..28] (thread k writes out[k]), in an order
// fixed by the block size: in each warp five butterfly steps that leave
// lane k the warp's sum of slot k, then thread k adds the warps' sums in
// warp order.  Every thread of the block must call it; s_warp holds kBlock
// floats.
template <int kBlock>
__device__ __forceinline__ void block_sums(float (&acc)[kSlots],
                                           float* s_warp, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  fold<16>(acc, lane);
  fold<8>(acc, lane);
  fold<4>(acc, lane);
  fold<2>(acc, lane);
  fold<1>(acc, lane);
  s_warp[warp * 32 + lane] = acc[0];
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = s_warp[threadIdx.x];
#pragma unroll
    for (int q = 1; q < kBlock / 32; ++q) s = s + s_warp[q * 32 + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// One GN update of a live video from its sums tot at s.pose (whose
// transform is s.T), in one thread: H + 1e-12 I from its lower triangle,
// the unrolled Cholesky and substitutions of geom/linear.py (NaN where H
// is not positive definite), the step zeroed where it is not finite or
// exceeds 1e3 in a component (OpenCV's inv() of a singular system,
// PixelWisePyramid.cpp:451), compose(delta, pose) = log(exp(delta)
// exp(pose)) with exp(pose) = s.T, the termination metric and the freeze
// flag; then the new pose's transform for the next iteration.  (Spreading
// the Cholesky and forward substitution over a warp's lanes, the same
// arithmetic a value, made the finish slower on an H100: its chain of
// square roots and divisions stays, and the shuffles add to it.)
__device__ void update(const float* tot, const float* term_w, Video& s) {
  float L[6][6], Hl[6][6], y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      Hl[i][j] = tot[i * (i + 1) / 2 + j] + (i == j ? 1e-12f : 0.f);
  bool pd = true;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float sum = Hl[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) sum = sum - L[i][k] * L[j][k];
      if (i == j) {
        pd = pd && sum > 0.f;
        L[i][i] = sqrtf(sum);
      } else {
        L[i][j] = sum / L[j][j];
      }
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float sum = tot[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) sum = sum - L[i][k] * y[k];
    y[i] = sum / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float sum = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) sum = sum - L[k][i] * x[k];
    x[i] = sum / L[i][i];
  }
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

  float R1[3][3], t1[3], R2[3][3], t2[3], R[3][3], tt[3];
  exp_se3(delta, R1, t1);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R2[i][j] = s.T[3 * i + j];
    t2[i] = s.T[9 + i];
  }
  mat3(R1, R2, R);
  for (int i = 0; i < 3; ++i)
    tt[i] = ((R1[i][0] * t2[0] + R1[i][1] * t2[1]) + R1[i][2] * t2[2]) + t1[i];
  log_se3(R, tt, s.pose);

  float wp = 0.f;
  for (int i = 0; i < 6; ++i) wp = wp + fabsf(delta[i] * term_w[i]);
  s.wp_last = wp;
  s.iters = s.iters + 1;
  s.energy = tot[kEnergy];
  s.valid = tot[kValid];
  s.done = (wp < 1.f || !ok) ? 1 : 0;
  exp_se3(s.pose, R, tt);
  to_T(R, tt, s.T);
}

__device__ void store(const State& st, float* T, int v, const Video& s) {
  for (int i = 0; i < 6; ++i) st.pose[6 * v + i] = s.pose[i];
  st.wp_last[v] = s.wp_last;
  st.iters[v] = s.iters;
  st.energy[v] = s.energy;
  st.valid[v] = s.valid;
  st.done[v] = s.done;
  if (T != nullptr)
    for (int k = 0; k < 12; ++k) T[12 * v + k] = s.T[k];
}

__global__ void __launch_bounds__(kThreads, kStepMinBlocks)
    gn_step(const StepArgs a) {
  const int v = blockIdx.y, t = threadIdx.x;
  // a frozen video keeps every value (the freeze mask): all of its blocks
  // skip alike, so none takes a ticket
  if (!a.first && a.st.done != nullptr && a.st.done[v] != 0) return;
  __shared__ float s_T[12];
  __shared__ float s_warp[kThreads];
  __shared__ float s_sum[kSlots];
  __shared__ int s_last;
  if (a.mode == kIterate && !a.first) {
    if (t < 12) s_T[t] = a.T[12 * v + t];
  } else if (t == 0) {
    // a level's first iteration, a linearization or a finish alone
    transform_of(a.pose_in + 6 * v, s_T);
  }
  __syncthreads();

  if (a.mode != kFinish) {
    float T[12], acc[kSlots];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = s_T[k];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) acc[k] = 0.f;
    const int p = blockIdx.x * kThreads + t;
    if (p < a.pl.h * a.pl.w) add_pixel(a.pl, T, v, p, acc);
    block_sums<kThreads>(acc, s_warp, s_sum);
    if (t < kSums)
      a.partials[((size_t)v * a.nblocks + blockIdx.x) * kSums + t] = s_sum[t];
    if (a.mode == kLinearize) return;
    // the ticket: the block that takes the last one finishes the video
    __threadfence();
    __syncthreads();
    if (t == 0) s_last = atomicAdd(&a.tickets[v], 1) == a.nblocks - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }

  // the video's partials in a fixed order of the block index; coherent
  // loads (__ldcg), since other blocks of this launch wrote them
  const int c = t & 31, grp = t >> 5;
  float part = 0.f;
  if (c < kSums)
#pragma unroll 8
    for (int b = grp; b < a.nblocks; b += kGroups)
      part = part + __ldcg(a.partials + ((size_t)v * a.nblocks + b) * kSums
                           + c);
  s_warp[grp * 32 + c] = part;
  __syncthreads();
  if (t < kSums) {
    float sum = s_warp[t];
    for (int q = 1; q < kGroups; ++q) sum = sum + s_warp[q * 32 + t];
    s_sum[t] = sum;
  }
  __syncthreads();
  if (t != 0) return;
  // this video was live at the start of the iteration
  if (a.live != nullptr) atomicAdd(a.live + a.iter, 1ull);
  Video s;
  for (int i = 0; i < 6; ++i) s.pose[i] = a.pose_in[6 * v + i];
  for (int k = 0; k < 12; ++k) s.T[k] = s_T[k];
  s.iters = a.first ? 0 : a.st.iters[v];
  update(s_sum, a.term_w, s);
  store(a.st, a.mode == kIterate ? a.T : nullptr, v, s);
  if (a.mode == kIterate) a.tickets[v] = 0;
}

__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kClusterThreads) gn_level_cluster(const LevelArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  float* s_warp = smem;                     // the warps' sums
  float* s_sum = s_warp + kClusterThreads;  // the block's sums, 2 buffers
  float* s_tot = s_sum + 2 * kSlots;        // the cluster's sums
  float* s_T = s_tot + kSlots;              // the transform, the freeze flag
  const int rank = (int)cluster.block_rank(), t = threadIdx.x;
  const int v = blockIdx.y, n = a.pl.h * a.pl.w;
  // the video's state in each block's thread 0: every block sums the same
  // ranks' sums in the same order and finishes alike, so all hold the same
  // bits, leave the loop together, and rank 0 writes them out.  The level
  // starts the freeze state, as the plain gn_level does.
  Video s;
  if (t == 0) {
    for (int i = 0; i < 6; ++i) s.pose[i] = a.pose0[6 * v + i];
    transform_of(s.pose, s.T);
    for (int k = 0; k < 12; ++k) s_T[k] = s.T[k];
    s.wp_last = __int_as_float(0x7f800000);
    s.iters = 0;
    s.energy = 0.f;
    s.valid = 0.f;
    s.done = 0;
    s_T[12] = 0.f;
  }
  __syncthreads();
  for (int it = 0; it < a.num_iters && s_T[12] == 0.f; ++it) {
    if (rank == 0 && t == 0 && a.live != nullptr) atomicAdd(a.live + it, 1ull);
    float T[12], acc[kSlots];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = s_T[k];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) acc[k] = 0.f;
#pragma unroll 2
    for (int p = rank * kClusterThreads + t; p < n;
         p += kClusterBlocks * kClusterThreads)
      add_pixel(a.pl, T, v, p, acc);
    // the iterations take the two buffers in turn: a block writes one
    // again only after the next cluster.sync, when every block has read it
    float* buf = s_sum + (it & 1) * kSlots;
    block_sums<kClusterThreads>(acc, s_warp, buf);
    cluster.sync();
    if (t < kSums) {
      float sum = cluster.map_shared_rank(buf, 0)[t];
#pragma unroll
      for (int r = 1; r < kClusterBlocks; ++r)
        sum = sum + cluster.map_shared_rank(buf, r)[t];
      s_tot[t] = sum;
    }
    __syncthreads();
    if (t == 0) {
      update(s_tot, a.term_w, s);
      for (int k = 0; k < 12; ++k) s_T[k] = s.T[k];
      s_T[12] = (float)s.done;
    }
    __syncthreads();
  }
  if (rank == 0 && t == 0) store(a.st, nullptr, v, s);
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

Planes planes_of(const float* kf_image, const float* kf_depth,
                 const float* kf_var, const float* cur_image,
                 const float* cur_gradx, const float* cur_grady, int h, int w,
                 int ch, int y_offset, float fx, float fy, float cx, float cy,
                 float noise2, float half_huber) {
  return Planes{kf_image, kf_depth, kf_var, cur_image, cur_gradx, cur_grady,
                h, w, ch, y_offset, fx, fy, cx, cy, noise2, half_huber};
}

}  // namespace

// gn_step over V videos.  mode 0 (iterate): one GN iteration of template
// planes (V, h, w) against current planes (V, ch, w), its finish in the
// block that takes the last ticket; first = 1 on a level's first
// iteration (pose_in the level's pose, the freeze state started, the
// transform formed from it), else pose_in is st.pose and every array,
// T (V, 12) too, holds the previous iteration's values.
// partials (V, ceil(h w / 256), 29) is scratch, tickets (V,) must be 0;
// live (or null) is the level's row of live counts, iter this iteration's
// index in the level.
// mode 1 (linearize): the partials alone, at row offset y_offset; st.done
// (or null) names the videos to skip.  mode 2 (finish): one block a video
// sums nparts given partials (V, nparts, 29), solves, updates and freezes.
extern "C" int ellc_gn_step(
    const float* kf_image, const float* kf_depth, const float* kf_var,
    const float* cur_image, const float* cur_gradx, const float* cur_grady,
    const float* pose_in, float* pose, float* wp_last, int32_t* iters,
    float* energy, float* valid, int32_t* done, float* T, float* partials,
    int32_t* tickets, unsigned long long* live, int V, int h, int w, int ch,
    int y_offset, int nparts, int mode, int first, int iter, float fx,
    float fy, float cx, float cy, float noise2, float half_huber, float tw0,
    float tw1, float tw2, float tw3, float tw4, float tw5, void* stream) {
  const int nblocks = mode == kFinish ? nparts : (h * w + kThreads - 1) / kThreads;
  const StepArgs a{planes_of(kf_image, kf_depth, kf_var, cur_image,
                             cur_gradx, cur_grady, h, w, ch, y_offset, fx,
                             fy, cx, cy, noise2, half_huber),
                   pose_in, State{pose, wp_last, iters, energy, valid, done},
                   T, partials, tickets, live, nblocks, mode, first, iter,
                   {tw0, tw1, tw2, tw3, tw4, tw5}};
  const dim3 grid(mode == kFinish ? 1 : nblocks, V);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  gn_step<<<grid, dim3(kThreads), 0, stream_>>>(a);
  return (int)cudaGetLastError();
}

// gn_level_cluster over V videos: num_iters (>= 1) GN iterations of a
// level from pose0 (V, 6), the freeze state started; writes the state and
// counts the live iterations into live[0..num_iters) (or not, if null).
extern "C" int ellc_gn_level_cluster(
    const float* kf_image, const float* kf_depth, const float* kf_var,
    const float* cur_image, const float* cur_gradx, const float* cur_grady,
    const float* pose0, float* pose, float* wp_last, int32_t* iters,
    float* energy, float* valid, int32_t* done, unsigned long long* live,
    int V, int h, int w, int ch,
    int num_iters, float fx, float fy, float cx,
    float cy, float noise2, float half_huber, float tw0, float tw1,
    float tw2, float tw3, float tw4, float tw5, void* stream) {
  const LevelArgs a{planes_of(kf_image, kf_depth, kf_var, cur_image,
                              cur_gradx, cur_grady, h, w, ch, 0, fx, fy, cx,
                              cy, noise2, half_huber),
                    pose0, State{pose, wp_last, iters, energy, valid, done},
                    live, num_iters, {tw0, tw1, tw2, tw3, tw4, tw5}};
  const dim3 grid(kClusterBlocks, V);
  const size_t smem = kClusterSmemFloats * sizeof(float);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  gn_level_cluster<<<grid, dim3(kClusterThreads), smem, stream_>>>(a);
  return (int)cudaGetLastError();
}
