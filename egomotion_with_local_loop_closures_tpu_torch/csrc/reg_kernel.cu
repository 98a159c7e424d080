// Depth-map regularization (doRegularization) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// egomotion_with_local_loop_closures_tpu/ops/reg_kernel.py::do_regularization_pallas
// (pl.pallas_call at reg_kernel.py:161; body _kernel, sweep _sweep25):
// fillDepthHoles followed by regularizeDepthMap on the post-fill planes
// (reference src/DepthPropagation.cpp:1317-1543).
//
// Design: one thread per pixel, two launches.
//   ellc_reg_fill   reads the 7 hypothesis planes + maxgrad and writes the
//                   7 post-fill planes (validity score, 5x5 inverse-variance
//                   fill of gated holes).
//   ellc_reg_smooth reads the post-fill planes and writes the smoothed
//                   inverse depth/variance, blacklist and valid planes
//                   (5x5 inverse-variance smoothing with the compatibility
//                   gate, occlusion votes, keep/drop on the validity sum).
// It also serves the standalone regularizeDepthMap calls alone.
// Neighbours are read straight from global memory: the 25 taps of a block
// overlap, and one pass touches 8 planes of 270x480 float32 (about
// 8 x 518 KB), which stays in the 50 MB L2.  What bounds it on the card is
// those bytes and the launch latency, not arithmetic.  A fused kernel with a
// shared-memory tile and a 5-row/4-column halo is later work.
//
// The taps accumulate in the JAX order (dy outer, dx inner, -2..2) with the
// same float expressions as propagate.fill_tap/fill_finish/reg_tap/
// reg_finish.  Built with -fmad=false so no multiply-add is contracted and
// the rounding equals the plain PyTorch version (one op per kernel).
//
// Plain C interface, bound with ctypes: every function launches on the
// given stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float clamp_tiny(float v) {
  return fabsf(v) < 1e-10f ? (v < 0.f ? -1e-10f : 1e-10f) : v;
}

// max(v, 0) that propagates NaN, as jnp.maximum and torch.clamp_min do.
__device__ __forceinline__ float max0(float v) {
  return (v != v) ? v : (v > 0.f ? v : 0.f);
}

// Sum over dx = -2..2 of (valid ? validity : 0) on row y, 0 outside the
// image: one row of the reference's per-row prefix difference.
__device__ __forceinline__ float row5(const float* __restrict__ validity,
                                      const uint8_t* __restrict__ valid,
                                      int H, int W, int y, int x) {
  float s = 0.f;
  if (y < 0 || y >= H) return s;
  for (int dx = -2; dx <= 2; ++dx) {
    const int xx = x + dx;
    float v = 0.f;
    if (xx >= 0 && xx < W) {
      const int j = y * W + xx;
      v = valid[j] ? validity[j] : 0.f;
    }
    s = s + v;
  }
  return s;
}

__global__ void fill_kernel(
    const float* __restrict__ idepth, const float* __restrict__ var,
    const float* __restrict__ idepth_s, const float* __restrict__ var_s,
    const float* __restrict__ validity, const int32_t* __restrict__ bl,
    const uint8_t* __restrict__ valid, const float* __restrict__ maxgrad,
    float* __restrict__ o_idepth, float* __restrict__ o_var,
    float* __restrict__ o_idepth_s, float* __restrict__ o_var_s,
    float* __restrict__ o_validity, int32_t* __restrict__ o_bl,
    uint8_t* __restrict__ o_valid, int H, int W,
    float min_abs_grad_decrease, int min_blacklist,
    float val_sum_min_for_create, float val_sum_min_for_unblacklist,
    float var_random_init, int lsd_correct_hole_fill) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int i = y * W + x;

  // fill_tap over the 5x5 window; edge fills valid 0, var 1, idepth 0
  float sum_iv = 0.f, sum_id = 0.f, num = 0.f;
  for (int dy = -2; dy <= 2; ++dy) {
    for (int dx = -2; dx <= 2; ++dx) {
      const int yy = y + dy, xx = x + dx;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const int j = yy * W + xx;
      const float sv = (in && valid[j]) ? 1.f : 0.f;
      const float svar = in ? var[j] : 1.f;
      const float sid = in ? idepth[j] : 0.f;
      const float iv =
          sv > 0.f ? 1.f / (fabsf(svar) > 1e-12f ? svar : 1e-12f) : 0.f;
      sum_iv = sum_iv + iv;
      sum_id = sum_id + iv * sid;
      num = num + sv;
    }
  }

  // fill_val: the row-prefix difference, or the 5x5 box sum
  float val;
  if (lsd_correct_hole_fill) {
    val = 0.f;
    for (int dy = -2; dy <= 2; ++dy)
      val = val + row5(validity, valid, H, W, y + dy, x);
  } else {
    val = row5(validity, valid, H, W, y + 2, x) -
          row5(validity, valid, H, W, y - 3, x);
  }

  // fill_finish over rows 3..H-4, columns 3..W-3
  const bool v0 = valid[i] != 0;
  const bool region = y >= 3 && y < H - 3 && x >= 3 && x < W - 2;
  const bool cond = region && !v0 && maxgrad[i] >= min_abs_grad_decrease &&
                    ((bl[i] >= min_blacklist && val > val_sum_min_for_create) ||
                     val > val_sum_min_for_unblacklist) &&
                    num > 0.f;
  const float fill_id = clamp_tiny(sum_id / (sum_iv > 0.f ? sum_iv : 1.f));

  o_idepth[i] = cond ? fill_id : idepth[i];
  o_var[i] = cond ? var_random_init : var[i];
  o_idepth_s[i] = cond ? -1.f : idepth_s[i];
  o_var_s[i] = cond ? -1.f : var_s[i];
  o_validity[i] = cond ? 0.f : validity[i];
  o_bl[i] = cond ? 0 : bl[i];
  o_valid[i] = (v0 || cond) ? 1 : 0;
}

__global__ void smooth_kernel(
    const float* __restrict__ idepth, const float* __restrict__ var,
    const float* __restrict__ idepth_s, const float* __restrict__ var_s,
    const float* __restrict__ validity, const int32_t* __restrict__ bl,
    const uint8_t* __restrict__ valid, float* __restrict__ o_idepth_s,
    float* __restrict__ o_var_s, int32_t* __restrict__ o_bl,
    uint8_t* __restrict__ o_valid, int H, int W, float diff_fac_smoothing,
    float reg_dist_var, float val_sum_min_for_keep, int remove_occlusions) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int i = y * W + x;
  const float c_id = idepth[i];
  const float c_var = var[i];

  // reg_tap over the 5x5 window; edge fills valid 0, idepth 0, var 1,
  // validity 0
  float sum_w = 0.f, sum_id = 0.f, val_sum = 0.f, n_occ = 0.f, n_not = 0.f;
  for (int dy = -2; dy <= 2; ++dy) {
    for (int dx = -2; dx <= 2; ++dx) {
      const int yy = y + dy, xx = x + dx;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const int j = yy * W + xx;
      const bool sv = in && valid[j];
      const float sid = in ? idepth[j] : 0.f;
      const float svar = in ? var[j] : 1.f;
      const float svalc = in ? validity[j] : 0.f;
      const float diff = sid - c_id;
      const bool compat = diff_fac_smoothing * diff * diff <= svar + c_var;
      const bool use = sv && compat;
      n_occ = n_occ + ((sv && !compat && sid > c_id) ? 1.f : 0.f);
      n_not = n_not + (use ? 1.f : 0.f);
      const float dist_fac = (float)(dy * dy + dx * dx) * reg_dist_var;
      const float iv = use ? 1.f / (max0(svar) + dist_fac) : 0.f;
      sum_w = sum_w + iv;
      sum_id = sum_id + iv * sid;
      val_sum = val_sum + (use ? svalc : 0.f);
    }
  }

  // reg_finish over rows 3..H-4, columns 2..W-3
  const bool c_valid = valid[i] != 0;
  const bool region = y >= 3 && y < H - 3 && x >= 2 && x < W - 2;
  const bool touched = region && c_valid;
  const bool drop_val = touched && val_sum < val_sum_min_for_keep;
  const bool drop_occ = remove_occlusions && touched && n_occ > n_not;
  const bool dropped = drop_val || drop_occ;
  const bool write = touched && !dropped;
  const float w = sum_w > 0.f ? sum_w : 1.f;

  o_idepth_s[i] = write ? clamp_tiny(sum_id / w) : idepth_s[i];
  o_var_s[i] = write ? 1.f / w : var_s[i];
  o_bl[i] = drop_val ? bl[i] - 1 : bl[i];
  o_valid[i] = (c_valid && !dropped) ? 1 : 0;
}

dim3 grid_for(int H, int W) {
  return dim3((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
}

}  // namespace

extern "C" int ellc_reg_fill(
    const float* idepth, const float* var, const float* idepth_s,
    const float* var_s, const float* validity, const int32_t* bl,
    const uint8_t* valid, const float* maxgrad, float* o_idepth, float* o_var,
    float* o_idepth_s, float* o_var_s, float* o_validity, int32_t* o_bl,
    uint8_t* o_valid, int H, int W, float min_abs_grad_decrease,
    int min_blacklist, float val_sum_min_for_create,
    float val_sum_min_for_unblacklist, float var_random_init,
    int lsd_correct_hole_fill, void* stream) {
  fill_kernel<<<grid_for(H, W), dim3(kBlockX, kBlockY), 0,
                (cudaStream_t)stream>>>(
      idepth, var, idepth_s, var_s, validity, bl, valid, maxgrad, o_idepth,
      o_var, o_idepth_s, o_var_s, o_validity, o_bl, o_valid, H, W,
      min_abs_grad_decrease, min_blacklist, val_sum_min_for_create,
      val_sum_min_for_unblacklist, var_random_init, lsd_correct_hole_fill);
  return (int)cudaGetLastError();
}

extern "C" int ellc_reg_smooth(
    const float* idepth, const float* var, const float* idepth_s,
    const float* var_s, const float* validity, const int32_t* bl,
    const uint8_t* valid, float* o_idepth_s, float* o_var_s, int32_t* o_bl,
    uint8_t* o_valid, int H, int W, float diff_fac_smoothing,
    float reg_dist_var, float val_sum_min_for_keep, int remove_occlusions,
    void* stream) {
  smooth_kernel<<<grid_for(H, W), dim3(kBlockX, kBlockY), 0,
                  (cudaStream_t)stream>>>(
      idepth, var, idepth_s, var_s, validity, bl, valid, o_idepth_s, o_var_s,
      o_bl, o_valid, H, W, diff_fac_smoothing, reg_dist_var,
      val_sum_min_for_keep, remove_occlusions);
  return (int)cudaGetLastError();
}
