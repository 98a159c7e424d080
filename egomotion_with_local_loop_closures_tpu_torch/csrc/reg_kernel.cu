// Depth-map regularization (doRegularization) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// egomotion_with_local_loop_closures_tpu/ops/reg_kernel.py::do_regularization_pallas
// (pl.pallas_call at reg_kernel.py:161; body _kernel, sweep _sweep25):
// fillDepthHoles followed by regularizeDepthMap on the post-fill planes
// (reference src/DepthPropagation.cpp:1317-1543).  The same kernel without
// the fill serves the standalone regularizeDepthMap calls.
//
// What bounds it.  Counting each input byte read once and each output byte
// written once: with the fill it reads 29 B/px (five float32 planes, int32
// blacklisted, u8 valid, float32 maxgrad) and writes 25 B/px (all seven
// planes), 7.00 MB at 270x480, 2.09 us at 3.35 TB/s; the smoothing alone
// reads 25 B/px and writes 13 B/px, 4.92 MB, 1.47 us.  The float32
// operations the work needs (two 25-tap passes, a few divisions a pixel)
// take under 0.5 us at 67 TFLOP/s, so the bytes set the bound.  This design
// is held by instruction throughput instead: the bit-exact smoothing tap is
// about 14 SASS instructions (two shared loads, no fused multiply-add),
// 25 of them a pixel, and the six reciprocals and the loads come on top;
// all blocks are resident at once, so the loads of one block hide little
// of another's arithmetic.  Each instantiation's static SASS count and
// the instruction time it implies are printed by chip_smoke.py (phase 2),
// with its registers and shared memory per block (cuobjdump -res-usage,
// the numbers ptxas -v prints).  Built by nvcc 12.9 for sm_90a: with the
// fill 40 registers, 29,184 B of shared memory and 1,681 SASS instructions
// (1,798 with remove_occlusions); without it 36 / 38 registers, 18,304 B
// and 960 / 1,077 instructions; no stack, no spills.  Were every thread
// to run every instruction once, at four warp instructions a clock per SM,
// one 270x480 state would take 6.6 / 7.0 us with the fill and 3.7 / 4.2 us
// without, at 1,980 MHz on 132 SMs.
// The measured times on an H100 are in PERF.md.
//
// Design: one launch per call, for one (H, W) state or a batch of B states
// laid out (B, H, W) (the connection-recovery trials, one per loop-window
// candidate): blockIdx.z picks the state, whose planes start b*H*W into
// each array, and nothing is shared between states.  Each block of 32x8
// threads owns a 32x8 output tile (tuned from 32x16 with tools/tune_reg_kernel.py: 510 blocks
// of 256 threads beat 255 of 512 by 6-9 %; two pixels a thread, sharing
// their neighbour rows, lost, so shared-memory bandwidth is not the limit).
//   1. It loads the raw planes its taps read -- the tile with a halo of 5
//      rows above, 4 below and 4 columns each side (with the fill), or 2
//      on each side (without) -- with coalesced loads (neighbouring threads
//      on neighbouring x), and writes the reference's edge values (valid 0,
//      idepth 0, var 1, validity 0) outside the image, so no tap tests a
//      bound.  Each raw pixel's fill terms (1/var, its product with idepth,
//      valid, valid ? validity : 0) are computed once there, not per tap.
//   2. With the fill, it fills the tile and a 2-pixel ring around it in
//      shared memory (ring pixels are filled by every block that reads
//      them, 1.7x the fill work at 32x8).  The gate reads a ring pixel's
//      maxgrad and blacklisted from global memory, and only where the pixel
//      is an unfilled hole inside the fill region.
//   3. For each valid ring pixel after the fill it stores the six
//      reciprocals 1/(max(var, 0) + d2 * reg_dist_var), d2 in
//      {0,1,2,4,5,8}, that the smoothing taps divide by: six divisions a
//      pixel instead of 25.
//   4. After one more barrier, each thread smooths its pixel from shared
//      memory and stores every output plane once.
// cp.async is not used: it has no 1-byte form for `valid`, and the fill
// terms are computed from the loaded values on their way to shared memory.
//
// Bit-equality with the plain version (depth/propagate.py): the taps
// accumulate in its order (dy outer, dx inner, -2..2) with its float
// expressions; a value computed once and shared between taps is the value
// each tap would compute.  Built with -fmad=false so no multiply-add is
// contracted.  The gates are evaluated lazily; they have no side effects,
// so the result is the same.
//
// A batch of B states reads and writes B times the bytes above: at B = 20
// and 270x480, 140 MB with the fill (41.8 us at 3.35 TB/s) and 98.4 MB
// without (29.4 us).
//
// Plain C interface, bound with ctypes: ellc_reg launches on the given
// stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The output tile, one thread per pixel (tools/tune_reg_kernel.py times
// other heights by building a copy of this file with kTileY changed).
constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;

// The ring: the tile and the 2-pixel border its smoothing taps read.
constexpr int kRingY = kTileY + 4, kRingX = kTileX + 4;
constexpr int kRing = kRingY * kRingX;
// The raw tile of the fill: the ring's taps reach 2 more pixels out, and
// the row-reset validity score reads row y-3 as well.  Ring pixel (ry, rx)
// is raw pixel (ry + 3, rx + 2).
constexpr int kRawY = kRingY + 5, kRawX = kRingX + 4;
constexpr int kRaw = kRawY * kRawX;
constexpr int kRawOffY = 3, kRawOffX = 2;

// dy*dy + dx*dx over the 5x5 window takes six values; class of each tap
constexpr int kNumDist = 6;
__device__ __forceinline__ constexpr int dist_class(int dy, int dx) {
  return (dy * dy + dx * dx) == 0 ? 0
       : (dy * dy + dx * dx) == 1 ? 1
       : (dy * dy + dx * dx) == 2 ? 2
       : (dy * dy + dx * dx) == 4 ? 3
       : (dy * dy + dx * dx) == 5 ? 4 : 5;
}
__device__ __forceinline__ constexpr int dist2_of_class(int k) {
  return k == 0 ? 0 : k == 1 ? 1 : k == 2 ? 2 : k == 3 ? 4 : k == 4 ? 5 : 8;
}

// A filled pixel's valid code in the ring; 1 marks a pixel valid before
// the fill, 0 a hole.
constexpr float kFilled = 2.f;

struct Args {
  const float* __restrict__ idepth;
  const float* __restrict__ var;
  const float* __restrict__ idepth_s;
  const float* __restrict__ var_s;
  const float* __restrict__ validity;
  const int32_t* __restrict__ bl;
  const uint8_t* __restrict__ valid;
  const float* __restrict__ maxgrad;      // with the fill only
  float* __restrict__ o_idepth;           // with the fill only
  float* __restrict__ o_var;              // with the fill only
  float* __restrict__ o_idepth_s;
  float* __restrict__ o_var_s;
  float* __restrict__ o_validity;         // with the fill only
  int32_t* __restrict__ o_bl;
  uint8_t* __restrict__ o_valid;
  int H, W;
  // fillDepthHoles
  float min_abs_grad_decrease;
  int min_blacklist;
  float val_sum_min_for_create, val_sum_min_for_unblacklist;
  float var_random_init;
  int lsd_correct_hole_fill;
  // regularizeDepthMap
  float diff_fac_smoothing, reg_dist_var, val_sum_min_for_keep;
};

__device__ __forceinline__ float clamp_tiny(float v) {
  return fabsf(v) < 1e-10f ? (v < 0.f ? -1e-10f : 1e-10f) : v;
}

// max(v, 0) that propagates NaN, as jnp.maximum and torch.clamp_min do.
__device__ __forceinline__ float max0(float v) {
  return (v != v) ? v : (v > 0.f ? v : 0.f);
}

// Sum over dx = -2..2 of (valid ? validity : 0) on one raw-tile row: one
// row of the reference's per-row prefix difference.
__device__ __forceinline__ float row5(const float4* __restrict__ raw) {
  float s = 0.f;
#pragma unroll
  for (int dx = -2; dx <= 2; ++dx) s = s + raw[dx].w;
  return s;
}

// The six smoothing reciprocals of ring pixel i (0 where it is not valid:
// no tap uses them there).
__device__ __forceinline__ void store_recips(float (*recip)[kRing], int i,
                                             float4 f, const Args& a) {
#pragma unroll
  for (int k = 0; k < kNumDist; ++k) {
    const float dist_fac = (float)dist2_of_class(k) * a.reg_dist_var;
    recip[k][i] = f.w != 0.f ? 1.f / (max0(f.y) + dist_fac) : 0.f;
  }
}

template <bool kFill, bool kOccl>
__global__ void __launch_bounds__(kThreads)
reg_kernel(const Args a) {
  // raw tile (fill only): 1/var, that times idepth, valid,
  // valid ? validity : 0
  __shared__ float4 s_raw[kFill ? kRaw : 1];
  // ring after the fill: idepth, var, validity, valid code (0, 1, kFilled)
  __shared__ float4 s_ring[kRing];
  __shared__ float s_recip[kNumDist][kRing];

  const int H = a.H, W = a.W;
  // the first element of this block's state in every plane
  const int64_t base = (int64_t)blockIdx.z * H * W;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int y0 = blockIdx.y * kTileY, x0 = blockIdx.x * kTileX;

  // -- 1. load: all loads of a thread first, then the derived terms
  constexpr int kLoadW = kFill ? kRawX : kRingX;
  constexpr int kLoadN = kFill ? kRaw : kRing;
  constexpr int kLoadIters = (kLoadN + kThreads - 1) / kThreads;
  constexpr int kHaloY = kFill ? 2 + kRawOffY : 2;
  constexpr int kHaloX = kFill ? 2 + kRawOffX : 2;
  float l_id[kLoadIters], l_var[kLoadIters], l_vy[kLoadIters];
  bool l_v[kLoadIters];
#pragma unroll
  for (int k = 0; k < kLoadIters; ++k) {
    const int i = tid + k * kThreads;
    const int r = i / kLoadW, c = i - r * kLoadW;
    const int y = y0 - kHaloY + r, x = x0 - kHaloX + c;
    const bool in = i < kLoadN && y >= 0 && y < H && x >= 0 && x < W;
    const int64_t j = base + y * W + x;
    // the reference's edge values: valid 0, idepth 0, var 1, validity 0
    l_v[k] = in && a.valid[j] != 0;
    l_id[k] = in ? a.idepth[j] : 0.f;
    l_var[k] = in ? a.var[j] : 1.f;
    l_vy[k] = in ? a.validity[j] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kLoadIters; ++k) {
    const int i = tid + k * kThreads;
    if (i >= kLoadN) continue;
    const float sv = l_v[k] ? 1.f : 0.f;
    const float4 f = make_float4(l_id[k], l_var[k], l_vy[k], sv);
    if (kFill) {
      // fill_tap's terms of this pixel
      const float vr = l_var[k];
      const float iv =
          sv > 0.f ? 1.f / (fabsf(vr) > 1e-12f ? vr : 1e-12f) : 0.f;
      s_raw[i] = make_float4(iv, iv * l_id[k], sv, l_v[k] ? l_vy[k] : 0.f);
      const int r = i / kRawX, c = i - r * kRawX;
      const int ry = r - kRawOffY, rx = c - kRawOffX;
      if (ry >= 0 && ry < kRingY && rx >= 0 && rx < kRingX)
        s_ring[ry * kRingX + rx] = f;
    } else {
      s_ring[i] = f;
      store_recips(s_recip, i, f, a);
    }
  }
  __syncthreads();

  // -- 2. fill the ring (fill_val, fill_tap, fill_finish), then its
  // smoothing reciprocals
  if (kFill) {
    constexpr int kFillIters = (kRing + kThreads - 1) / kThreads;
#pragma unroll
    for (int k = 0; k < kFillIters; ++k) {
      const int i = tid + k * kThreads;
      if (i >= kRing) continue;
      const int ry = i / kRingX, rx = i - ry * kRingX;
      const int y = y0 - 2 + ry, x = x0 - 2 + rx;
      float4 f = s_ring[i];
      // fill_finish's gate over rows 3..H-4, columns 3..W-3
      if (f.w == 0.f && y >= 3 && y < H - 3 && x >= 3 && x < W - 2) {
        const int64_t j = base + y * W + x;
        const float4* raw = s_raw + (ry + kRawOffY) * kRawX + (rx + kRawOffX);
        if (a.maxgrad[j] >= a.min_abs_grad_decrease) {
          float val;
          if (a.lsd_correct_hole_fill) {
            val = 0.f;
#pragma unroll
            for (int dy = -2; dy <= 2; ++dy)
              val = val + row5(raw + dy * kRawX);
          } else {
            val = row5(raw + 2 * kRawX) - row5(raw - 3 * kRawX);
          }
          if ((a.bl[j] >= a.min_blacklist && val > a.val_sum_min_for_create) ||
              val > a.val_sum_min_for_unblacklist) {
            float sum_iv = 0.f, sum_id = 0.f, num = 0.f;
#pragma unroll
            for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
              for (int dx = -2; dx <= 2; ++dx) {
                const float4 t = raw[dy * kRawX + dx];
                sum_iv = sum_iv + t.x;
                sum_id = sum_id + t.y;
                num = num + t.z;
              }
            }
            if (num > 0.f) {
              f = make_float4(
                  clamp_tiny(sum_id / (sum_iv > 0.f ? sum_iv : 1.f)),
                  a.var_random_init, 0.f, kFilled);
              s_ring[i] = f;
            }
          }
        }
      }
      store_recips(s_recip, i, f, a);
    }
    __syncthreads();
  }

  // -- 3. smooth the thread's pixel (reg_tap, reg_finish) and store
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y = y0 + ty, x = x0 + tx;
  if (y >= H || x >= W) return;
  const int64_t i = base + y * W + x;
  const int ci = (ty + 2) * kRingX + (tx + 2);
  const float4 c = s_ring[ci];
  const bool c_valid = c.w != 0.f;
  const bool filled = kFill && c.w == kFilled;
  // reg_finish over rows 3..H-4, columns 2..W-3
  const bool touched = c_valid && y >= 3 && y < H - 3 && x >= 2 && x < W - 2;
  float sum_w = 0.f, sum_id = 0.f, val_sum = 0.f;
  // n_occ - n_not: both are float sums of ones over at most 25 taps, exact
  // small integers, so n_occ > n_not exactly when this int is above 0
  int occ_minus_not = 0;
  if (touched) {
#pragma unroll
    for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
      for (int dx = -2; dx <= 2; ++dx) {
        const int t = ci + dy * kRingX + dx;
        const float4 s = s_ring[t];
        const bool sv = s.w != 0.f;
        const float diff = s.x - c.x;
        const bool compat = a.diff_fac_smoothing * diff * diff <= s.y + c.y;
        const bool use = sv && compat;
        if (kOccl)
          occ_minus_not += (sv && !compat && s.x > c.x) ? 1 : use ? -1 : 0;
        const float iv = use ? s_recip[dist_class(dy, dx)][t] : 0.f;
        sum_w = sum_w + iv;
        sum_id = sum_id + iv * s.x;
        val_sum = val_sum + (use ? s.z : 0.f);
      }
    }
  }
  const bool drop_val = touched && val_sum < a.val_sum_min_for_keep;
  const bool dropped = drop_val || (kOccl && touched && occ_minus_not > 0);
  const bool write = touched && !dropped;
  const float w = sum_w > 0.f ? sum_w : 1.f;
  const int32_t bl = filled ? 0 : a.bl[i];
  a.o_idepth_s[i] =
      write ? clamp_tiny(sum_id / w) : (filled ? -1.f : a.idepth_s[i]);
  a.o_var_s[i] = write ? 1.f / w : (filled ? -1.f : a.var_s[i]);
  a.o_bl[i] = drop_val ? bl - 1 : bl;
  a.o_valid[i] = (c_valid && !dropped) ? 1 : 0;
  if (kFill) {
    a.o_idepth[i] = c.x;
    a.o_var[i] = c.y;
    a.o_validity[i] = c.z;
  }
}

template <bool kFill, bool kOccl>
void launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid((a.W + kTileX - 1) / kTileX, (a.H + kTileY - 1) / kTileY,
                  B);
  reg_kernel<kFill, kOccl><<<grid, dim3(kTileX, kTileY), 0, stream>>>(a);
}

}  // namespace

// fillDepthHoles + regularizeDepthMap (fill = 1: reads maxgrad, writes all
// seven output planes) or regularizeDepthMap alone (fill = 0: maxgrad,
// o_idepth, o_var and o_validity may be null), on B states of H x W, each
// array holding the B planes one after another.
extern "C" int ellc_reg(
    const float* idepth, const float* var, const float* idepth_s,
    const float* var_s, const float* validity, const int32_t* bl,
    const uint8_t* valid, const float* maxgrad, float* o_idepth, float* o_var,
    float* o_idepth_s, float* o_var_s, float* o_validity, int32_t* o_bl,
    uint8_t* o_valid, int B, int H, int W, int fill, int remove_occlusions,
    float min_abs_grad_decrease, int min_blacklist,
    float val_sum_min_for_create, float val_sum_min_for_unblacklist,
    float var_random_init, int lsd_correct_hole_fill,
    float diff_fac_smoothing, float reg_dist_var, float val_sum_min_for_keep,
    void* stream) {
  const Args a{idepth, var, idepth_s, var_s, validity, bl, valid, maxgrad,
               o_idepth, o_var, o_idepth_s, o_var_s, o_validity, o_bl,
               o_valid, H, W, min_abs_grad_decrease, min_blacklist,
               val_sum_min_for_create, val_sum_min_for_unblacklist,
               var_random_init, lsd_correct_hole_fill, diff_fac_smoothing,
               reg_dist_var, val_sum_min_for_keep};
  const cudaStream_t s = (cudaStream_t)stream;
  if (fill)
    remove_occlusions ? launch<true, true>(a, B, s)
                      : launch<true, false>(a, B, s);
  else
    remove_occlusions ? launch<false, true>(a, B, s)
                      : launch<false, false>(a, B, s);
  return (int)cudaGetLastError();
}
