// Keyframe depth propagation for NVIDIA Hopper (sm_90a): the reprojection,
// the gates and the candidate merge in one memset and two launches, the
// merge summed in a fixed order.
//
// Replaces depth/propagate.py::propagate on CUDA tensors (the JAX
// package's depth/propagate.py:40-135, DepthPropagation.cpp:1003-1157):
// every hypothesis of the old keyframe is reprojected into the new
// keyframe's grid; a source pixel that is valid, lands inside the image
// and passes the photometric and gradient gates is a candidate for one
// target cell (flat target b*H*W + ty*W + tx, so a batch of B states
// merges into B separate grids).  Per target cell:
//
//   - the winner is the largest candidate inverse depth, and its variance
//     the largest variance among the candidates equal to it (at least 0,
//     NaN if any of those is NaN);
//   - a candidate is compatible when diff_fac * diff * diff <= var +
//     w_var, diff = winner - id (a NaN makes it incompatible);
//   - four sums over the compatible candidates, from +0.0, in ascending
//     source index: 1/var (var clamped away from 0 at 1e-12), id/var, the
//     validity and the count;
//   - the merged inverse depth sum_id / sum_ivar, variance 1 / sum_ivar,
//     validity clamped at validity_cap, and valid = count > 0; the other
//     planes reset (smoothed -1, blacklisted 0).
//
// The plain twin is depth/propagate.py::candidates followed by
// ops/propagate_kernel.py::plain_merge.  Every value here is the twin's
// expression, in the twin's order: the pose's rigid transform is
// lie.exp_se3 formula by formula (csrc/ellc_device.cuh), a division by a
// focal length is a multiplication by float32(1 / f), the reciprocal taken
// in double and rounded once (what ATen's CUDA division by a scalar
// multiplies by; the twin multiplies by it on every device), the bilinear
// sample is image/interp.py's, and each product and sum
// is rounded apart (-fmad=false) with IEEE divisions.  The sums' order is
// the point of the merge: the CPU's sequential index_add_, which the JAX
// package's CPU scatter also matches, adds a cell's candidates in ascending
// source index; a float atomicAdd would add them in whatever order the
// threads come, and two runs would differ in the last bits and, through
// tracking, in their trajectories.  Non-candidates and incompatible
// candidates add +0.0 in the twin; a sum that starts at +0.0 never becomes
// -0.0, so skipping them gives the same bits.  The max and the winner's
// variance do not depend on the order.
//
//   propagate_candidates (a thread a source pixel, a block a 32x8 tile of
//     one state): the block's first thread computes its state's
//     exp_se3(pose) into shared memory while every thread's plane loads
//     are in flight; after one barrier each thread reprojects and gates
//     its pixel and, for a candidate, writes one 16-byte record (new
//     inverse depth, new variance, validity, the next source of its
//     target's list) and pushes its index onto that list,
//     next = atomicExch(&head[t], s) (head set to -1 by a memset first).
//     The lists come out in any order.
//   propagate_merge (a thread a target cell): walks of its list, one
//     float4 load a step.  The first walk finds the winner; each further
//     walk selects the kChunk smallest compatible source indices above
//     the last one summed (insertion into a sorted array) and adds them in
//     that order: two walks for a list of at most kChunk entries, every
//     cell but those of a strong zoom-out (the cost grows as L^2 / kChunk
//     for a list of L, still in ascending order).  Keeping a
//     short list's entries in registers for one walk instead was timed
//     slower at 8 videos and 20 trials (PERF.md) and is not done.
//
// Both passes run on fixed grids with no host read, so a CUDA graph
// captures the memset and the two launches.
//
// What bounds it.  Each byte read once and each output byte written once:
// a source's valid flag (1 B) and a cell's seven output planes (25 B),
// and of a source's 4-B planes (smoothed inverse depth, inverse depth,
// validity, old keyframe image, new keyframe max gradient and image) only
// the 32-B sectors that the sources passing the gates before each read
// touch (chip_smoke.py, propagate_work): at most 50 B a pixel, 6.48 MB
// for one state at 270x480 (1.93 us at 3.35 TB/s).  The float work (~60
// operations a source) is far below the card's rate.

#include <cuda_runtime.h>
#include <cstdint>

#include "ellc_device.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kChunk = 8;

}  // namespace

// outside the anonymous namespace: a struct in the signature of the
// extern "C" entry point would keep nvcc from exporting it
struct PropagateArgs {
  // the old keyframe's state, B planes of H x W
  const float* idepth_smoothed;
  const float* idepth;
  const float* validity;
  const uint8_t* valid;
  const float* old_image;     // B x H x W
  const float* new_image;     // one H x W plane a state, or one for all
  const float* new_maxgrad;   // as new_image
  const float* pose;          // a twist a state (pose_stride 6), or one
  int32_t* head;              // B*H*W list heads
  float4* rec;                // B*H*W candidate records
  float* out_idepth;
  float* out_var;
  float* out_idepth_smoothed;
  float* out_var_smoothed;
  float* out_validity;
  int32_t* out_blacklisted;
  uint8_t* out_valid;
  int B, H, W;
  int new_stride;             // H*W, or 0: one new keyframe for all
  int pose_stride;            // 6, or 0: one pose for all
  float fx, fy, cx, cy;
  float inv_fx, inv_fy;       // 1/fx, 1/fy in double, rounded to float32
  float u_hi, v_hi;           // W - 3.1, H - 3.1 rounded to float32
  float max_diff_constant, max_diff_grad_mult, min_abs_grad_decrease;
  float diff_fac;
  float validity_cap;
};

namespace {

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch's amax: NaN if either is NaN, else the larger
__device__ __forceinline__ float nan_max(float a, float b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return a < b ? b : a;
}

// the twin's clamp away from zero: v unless |v| <= 1e-12 (or NaN)
__device__ __forceinline__ float away_from_zero(float v) {
  return fabsf(v) > 1e-12f ? v : 1e-12f;
}

__global__ void __launch_bounds__(kThreads)
propagate_candidates(const PropagateArgs a) {
  __shared__ float s_T[12];                   // R row-major, then t
  const int tiles_y = (a.H + kTileH - 1) / kTileH;
  const int b = blockIdx.y / tiles_y;
  const int x = blockIdx.x * kTileW + (int)threadIdx.x % kTileW;
  const int y = (blockIdx.y % tiles_y) * kTileH + (int)threadIdx.x / kTileW;
  const bool inside = x < a.W && y < a.H;
  const int hw = a.H * a.W;
  const int p = y * a.W + x;
  const int s = b * hw + p;
  // the pixel's loads, in flight while the first thread takes the exp
  bool valid = false;
  float ids_raw = 0.f, id = 0.f, validity = 0.f, old = 0.f, grad = 0.f;
  if (inside) {
    valid = a.valid[s] != 0;
    ids_raw = a.idepth_smoothed[s];
    id = a.idepth[s];
    validity = a.validity[s];
    old = a.old_image[s];
    grad = a.new_maxgrad[b * a.new_stride + p];
  }
  if (threadIdx.x == 0) {
    float xi[6], R[3][3], t[3];
    for (int k = 0; k < 6; ++k) xi[k] = a.pose[b * a.pose_stride + k];
    exp_se3(xi, R, t);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) s_T[3 * i + j] = R[i][j];
      s_T[9 + i] = t[i];
    }
  }
  __syncthreads();
  // the gradient gate first: a candidate passes every gate
  if (!inside || !valid || !(grad >= a.min_abs_grad_decrease)) return;
  // pn = R * Kinv p / idepth_smoothed + t   (DepthPropagation.cpp:1047)
  const float ids = away_from_zero(ids_raw);
  const float rx = ((float)x - a.cx) * a.inv_fx;
  const float ry = ((float)y - a.cy) * a.inv_fy;
  const float* T = s_T;
  const float px = ((T[0] * rx + T[1] * ry) + T[2]) / ids + T[9];
  const float py = ((T[3] * rx + T[4] * ry) + T[5]) / ids + T[10];
  const float pz = ((T[6] * rx + T[7] * ry) + T[8]) / ids + T[11];
  const float new_id = 1.f / away_from_zero(pz);
  const float u = (px * new_id) * a.fx + a.cx;
  const float v = (py * new_id) * a.fy + a.cy;
  if (!(u > 2.1f && v > 2.1f && u < a.u_hi && v < a.v_hi)) return;
  // photometric consistency: the new keyframe sampled bilinearly at (u, v)
  // with zero fill; its max gradient read at the source pixel, as the
  // reference does (:1066)
  const float* img = a.new_image + b * a.new_stride;
  const float x0 = floorf(u), y0 = floorf(v);
  const float wx = u - x0, wy = v - y0;
  const int x0i = to_index(x0, a.W), y0i = to_index(y0, a.H);
  const int x1i = to_index(ceilf(u), a.W), y1i = to_index(ceilf(v), a.H);
  bool ok;
  const float v00 = corner(img, x0i, y0i, a.H, a.W, &ok);
  const float v01 = corner(img, x1i, y0i, a.H, a.W, &ok);
  const float v10 = corner(img, x0i, y1i, a.H, a.W, &ok);
  const float v11 = corner(img, x1i, y1i, a.H, a.W, &ok);
  const float residual = blend(v00, v01, v10, v11, wx, wy) - old;
  const float denom = a.max_diff_constant
                      + (a.max_diff_grad_mult * grad) * grad;
  if (!((residual * residual) / denom <= 1.f)) return;
  // variance inflation idepth_ratio^4 times the source inverse depth
  // (:1082-1086)
  const float ratio = new_id / ids;
  const float new_var = ((ratio * ratio) * (ratio * ratio)) * id;
  // the truncating casts of u + 0.5 and v + 0.5 (inside the image gate, so
  // their clamps change nothing)
  const int t = b * hw + (int)(v + 0.5f) * a.W + (int)(u + 0.5f);
  const int next = atomicExch(&a.head[t], s);
  a.rec[s] = make_float4(new_id, new_var, validity, __int_as_float(next));
}

// The finish of a cell: the merged planes from its four sums.
__device__ __forceinline__ void finish(const PropagateArgs& a, int t,
                                       float sum_ivar, float sum_id,
                                       float sum_val, float count) {
  const bool has = count > 0.0f;
  const float denom = has ? sum_ivar : 1.0f;
  a.out_idepth[t] = has ? sum_id / denom : 0.0f;
  a.out_var[t] = has ? 1.0f / denom : 0.0f;
  a.out_idepth_smoothed[t] = -1.0f;
  a.out_var_smoothed[t] = -1.0f;
  a.out_validity[t] = is_nan(sum_val) ? sum_val
                                      : fminf(sum_val, a.validity_cap);
  a.out_blacklisted[t] = 0;
  a.out_valid[t] = has ? 1 : 0;
}

// One compatible candidate added to the sums.
__device__ __forceinline__ void add(float v, float id, float val,
                                    float* sum_ivar, float* sum_id,
                                    float* sum_val, float* count) {
  const float ivar = 1.0f / away_from_zero(v);
  *sum_ivar = *sum_ivar + ivar;
  *sum_id = *sum_id + ivar * id;
  *sum_val = *sum_val + val;
  *count = *count + 1.0f;
}

__global__ void __launch_bounds__(kThreads)
propagate_merge(const PropagateArgs a) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.B * a.H * a.W) return;
  const int first = a.head[t];
  // the winner and its variance: order-free (a candidate's inverse depth
  // is finite: its projection passed the image gates)
  float w = -__int_as_float(0x7f800000), wv = w;
  for (int s = first; s >= 0;) {
    const float4 r = a.rec[s];
    if (r.x > w) {
      w = r.x;
      wv = r.y;
    } else if (r.x == w) {
      wv = nan_max(wv, r.y);
    }
    s = __float_as_int(r.w);
  }
  const float w_var = nan_max(0.0f, wv);
  float sum_ivar = 0.0f, sum_id = 0.0f, sum_val = 0.0f, count = 0.0f;
  int prev = -1;
  for (;;) {
    int buf[kChunk];
    int n = 0;
    bool more = false;
    for (int s = first; s >= 0;) {
      const float4 r = a.rec[s];
      const int cur = s;
      s = __float_as_int(r.w);
      if (cur <= prev) continue;
      const float d = w - r.x;
      if (!(a.diff_fac * d * d <= r.y + w_var)) continue;
      if (n == kChunk) {
        more = true;
        if (cur > buf[kChunk - 1]) continue;
        --n;                                   // drop the largest
      }
      int i = n++;
      for (; i > 0 && buf[i - 1] > cur; --i) buf[i] = buf[i - 1];
      buf[i] = cur;
    }
    for (int i = 0; i < n; ++i) {
      const float4 r = a.rec[buf[i]];
      add(r.y, r.x, r.z, &sum_ivar, &sum_id, &sum_val, &count);
    }
    if (!more) break;
    prev = buf[n - 1];
  }
  finish(a, t, sum_ivar, sum_id, sum_val, count);
}

}  // namespace

// The propagation of B states of H x W into their new keyframes on
// ``stream``: head (B*H*W int32) and rec (B*H*W float4) are scratch.  The
// float constants come in as the twin rounds them (float32).  Returns the
// launch's cudaError (0 when the memset and both kernels were queued).
extern "C" int ellc_propagate(
    const float* idepth_smoothed, const float* idepth, const float* validity,
    const uint8_t* valid, const float* old_image, const float* new_image,
    const float* new_maxgrad, const float* pose, int32_t* head, void* rec,
    float* out_idepth, float* out_var, float* out_idepth_smoothed,
    float* out_var_smoothed, float* out_validity, int32_t* out_blacklisted,
    uint8_t* out_valid, int B, int H, int W, int new_stride, int pose_stride,
    float fx, float fy, float cx, float cy, float inv_fx, float inv_fy,
    float u_hi, float v_hi, float max_diff_constant,
    float max_diff_grad_mult, float min_abs_grad_decrease, float diff_fac,
    float validity_cap, void* stream) {
  const long long n = (long long)B * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || n >= (1LL << 31)
      || (long long)B * ((H + kTileH - 1) / kTileH) > 65535)
    return (int)cudaErrorInvalidValue;
  const PropagateArgs a{
      idepth_smoothed, idepth, validity, valid, old_image, new_image,
      new_maxgrad, pose, head, (float4*)rec, out_idepth, out_var,
      out_idepth_smoothed, out_var_smoothed, out_validity, out_blacklisted,
      out_valid, B, H, W, new_stride, pose_stride, fx, fy, cx, cy, inv_fx,
      inv_fy, u_hi, v_hi, max_diff_constant, max_diff_grad_mult,
      min_abs_grad_decrease, diff_fac, validity_cap};
  const dim3 tiles((W + kTileW - 1) / kTileW,
                   B * ((H + kTileH - 1) / kTileH));
  const dim3 cells((unsigned)((n + kThreads - 1) / kThreads));
  const cudaStream_t stream_ = (cudaStream_t)stream;
  cudaMemsetAsync(head, 0xff, sizeof(int32_t) * (size_t)n, stream_);
  propagate_candidates<<<tiles, dim3(kThreads), 0, stream_>>>(a);
  propagate_merge<<<cells, dim3(kThreads), 0, stream_>>>(a);
  return (int)cudaGetLastError();
}
