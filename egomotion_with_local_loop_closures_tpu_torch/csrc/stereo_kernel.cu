// One frame's epipolar line stereo and EKF observation (K2) for NVIDIA
// Hopper (sm_90a), as one kernel.
//
// Replaces the XLA program that the JAX package compiles for
// egomotion_with_local_loop_closures_tpu/depth/stereo.py::observe
// (stereo.py:674, the dense path, stereo_compact_frac = 0) with its
// epl_direction, _segment_setup, _kf_descriptor, _walk and line_stereo.
// The port's plain twin is depth/stereo.py (observe's CPU body), whose
// ~1,150 elementwise kernels each read or write (S + 4) x H x W planes.
//
//   stereo_observe: grid (ceil(H W / 256), V), 256 threads, one keyframe
//     pixel a thread.  Thread 0 of each block computes its video's pose
//     blocks once into shared memory (exp_se3 formula by formula, R, t,
//     K R, K t and t_kf_from_cur = -R^T t).  Each thread then evaluates
//     observe's gates, the epipolar direction from the keyframe's raw +-1
//     neighbours, the search band, the segment and its pre-checks (the
//     first failure wins, as _set_code), and, only where the pixel runs and
//     its segment passed, the 5-tap descriptor and the walk: one bilinear
//     sample of the current image a step (image/interp.py's semantics),
//     the SSD and its correlation with the previous step, best and second
//     best with torch.argmin's rule (the first NaN, else the first of
//     equal minima), stopping at the first step whose _step_cond fails
//     (step 0 always runs).  Then the subpixel parabola, the error checks,
//     triangulation (the reference's 1/fx in both branches), the variance
//     model and the EKF create/update rules in the plain twin's order.
//     A pixel that does not run, or whose segment failed, has its
//     line_stereo results never read by observe (every rule needs code 0,
//     -2 or -3, and the segment sets only -1 or -4): it skips the walk.
//
// The kernel writes new state planes and never its inputs (depth/state.py
// treats states as immutable).  The per-video counts of created and
// updated pixels are integers summed in shared memory and then with one
// atomicAdd a block: exact in any order, so each video of a batch gets
// the bits it gets alone.  Every constant is a kernel argument
// (StereoParams, mirrored by ops/stereo_kernel.py), so a CUDA graph
// captures the launch.
//
// What bounds it.  Counting each input byte read once and each output byte
// written once: the state (five float planes, int32, bool: 25 B a pixel),
// the keyframe's image, gradients and max gradient and the current image
// (20 B), and the new state (25 B): 70 B a pixel, 9.07 MB at 270x480
// (2.7 us at 3.35 TB/s).  The float work (~30 operations a pixel, ~160
// more where it runs, ~380 more where its segment passed, ~70 a walked
// step) takes about as long at the card's float32 rate.  This first cut
// is bound by neither: a walking thread runs a serial chain of
// up to S + 4 dependent gathers while the threads of its warp that skip
// the walk wait, and the walk's SSD history sits in local memory.
//
// Built with -fmad=false (no contracted multiply-add), as the port's other
// kernels.  Plain C interface, bound with ctypes: the entry point launches
// on the given stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ellc_device.cuh"

// Every ELLCConfig value the kernel reads, as float32 (or int) the way the
// plain twin's ATen ops see them; ops/stereo_kernel.py::Params mirrors it.
// A division by a configuration value is a multiplication by its float32
// reciprocal, as in the twin (ATen's CUDA division by a scalar).
// At namespace scope: a type of internal linkage in the signature of the
// extern "C" entry point would keep nvcc from exporting it.
struct StereoParams {
  float fx, fy, cx, cy;
  float min_abs_grad_decrease, min_abs_grad_create;
  float min_epl_length_squared, min_epl_grad_squared, min_epl_angle_squared;
  float gradient_sample_dist, stereo_epl_var_fac, inv_min_depth;
  float max_epl_length_crop, min_epl_length_crop, sample_point_to_border;
  float max_error_stereo, four_max_error_stereo, min_distance_error_stereo;
  float division_eps, four_camera_pixel_noise, cx_over_fx, cy_over_fy;
  float max_var, validity_counter_dec, fail_var_inc_fac, succ_var_inc_fac;
  float validity_counter_inc, validity_counter_max,
      validity_counter_max_variable, validity_counter_initial_observe;
  float diff_fac_observe;
  int border, min_blacklist, steps;
};

namespace {

constexpr int kThreads = 256;
// the walk's SSD and correlation history, one entry a step
constexpr int kMaxSteps = 64;

struct StereoArgs {
  // the state in, (V, H, W)
  const float* __restrict__ idepth;
  const float* __restrict__ var;
  const float* __restrict__ idepth_smoothed;
  const float* __restrict__ var_smoothed;
  const float* __restrict__ validity;
  const int32_t* __restrict__ blacklisted;
  const uint8_t* __restrict__ valid;
  // the keyframe and the current frame, (V, H, W); the pose (V, 6)
  const float* __restrict__ kf_image;
  const float* __restrict__ kf_gradx;
  const float* __restrict__ kf_grady;
  const float* __restrict__ kf_maxgrad;
  const float* __restrict__ cur_image;
  const float* __restrict__ pose;
  // the state out, (V, H, W); the counts (V,), zero before the launch
  float* __restrict__ out_idepth;
  float* __restrict__ out_var;
  float* __restrict__ out_idepth_smoothed;
  float* __restrict__ out_var_smoothed;
  float* __restrict__ out_validity;
  int32_t* __restrict__ out_blacklisted;
  uint8_t* __restrict__ out_valid;
  int32_t* __restrict__ num_created;
  int32_t* __restrict__ num_updated;
  int H, W;
  StereoParams p;
};

// the pose blocks of a video in shared memory
enum { kR = 0, kT = 9, kKR = 12, kKt = 21, kTkc = 24, kPoseFloats = 27 };

__device__ __forceinline__ bool is_inf(float v) {
  return fabsf(v) > 3.402823466e38f;        // false for NaN
}

// min(v, hi) that propagates NaN, as torch.clamp_max does
__device__ __forceinline__ float min_nan(float v, float hi) {
  return (v != v) ? v : (v < hi ? v : hi);
}

// torch.where(|v| > 1e-12, v, 1e-12): the plain twin's division guard
__device__ __forceinline__ float guard(float v) {
  return fabsf(v) > 1e-12f ? v : 1e-12f;
}

// bilinear_fill of an (H, W) image at (x, y), image/interp.py
__device__ __forceinline__ float sample(const float* __restrict__ img,
                                        float x, float y, int H, int W) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float ax = x - x0, ay = y - y0;
  const int x0i = to_index(x0, W), y0i = to_index(y0, H);
  const int x1i = to_index(ceilf(x), W), y1i = to_index(ceilf(y), H);
  bool m;
  const float v00 = corner(img, x0i, y0i, H, W, &m);
  const float v01 = corner(img, x1i, y0i, H, W, &m);
  const float v10 = corner(img, x0i, y1i, H, W, &m);
  const float v11 = corner(img, x1i, y1i, H, W, &m);
  return blend(v00, v01, v10, v11, ax, ay);
}

// _set_code: the first failure wins
__device__ __forceinline__ void set_code(int* code, bool cond, int val) {
  if (*code == 0 && cond) *code = val;
}

// The segment of doLineStereo (_segment_setup, DepthPropagation.cpp:397-553)
struct Segment {
  int code;
  float pfar_x, pfar_y, incx, incy, pclose_x, pclose_y, rescale;
};

__device__ Segment segment_setup(float x, float y, float epxn, float epyn,
                                 float min_id, float prior, float max_id,
                                 const float* s, int H, int W,
                                 const StereoParams& p) {
  Segment g;
  int code = 0;
  // _pinf_rescale
  const float kx = (x - p.cx) * (1.f / p.fx);
  const float ky = (y - p.cy) * (1.f / p.fy);
  float pinf[3];
  for (int i = 0; i < 3; ++i)
    pinf[i] = (s[kKR + 3 * i] * kx + s[kKR + 3 * i + 1] * ky)
              + s[kKR + 3 * i + 2];
  const float preal_z = pinf[2] / guard(prior) + s[kKt + 2];
  const float rescale = preal_z * prior;

  const float first_x = x - (2.f * epxn) * rescale;
  const float first_y = y - (2.f * epyn) * rescale;
  const float last_x = x + (2.f * epxn) * rescale;
  const float last_y = y + (2.f * epyn) * rescale;
  const float Wm2 = (float)(W - 2), Hm2 = (float)(H - 2);
  set_code(&code, first_x <= 0.f || first_x >= Wm2 || first_y <= 0.f
                      || first_y >= Hm2 || last_x <= 0.f || last_x >= Wm2
                      || last_y <= 0.f || last_y >= Hm2, -1);
  set_code(&code, !(rescale > 0.7f && rescale < 1.4f), -1);

  // close / far endpoints in the current image
  const float* kt = s + kKt;
  float pclose[3];
  for (int i = 0; i < 3; ++i) pclose[i] = pinf[i] + kt[i] * max_id;
  const bool fix = pclose[2] < 0.001f;
  const float max_id2 = fix ? (0.001f - pinf[2]) / guard(kt[2]) : max_id;
  for (int i = 0; i < 3; ++i) pclose[i] = pinf[i] + kt[i] * max_id2;
  const float pclose_z = guard(pclose[2]);
  float pclose_x = pclose[0] / pclose_z, pclose_y = pclose[1] / pclose_z;

  float pfar[3];
  for (int i = 0; i < 3; ++i) pfar[i] = pinf[i] + kt[i] * min_id;
  set_code(&code, pfar[2] < 0.001f || max_id2 < min_id, -1);
  const float pfar_z = guard(pfar[2]);
  const float pfar0 = pfar[0] / pfar_z, pfar1 = pfar[1] / pfar_z;

  const float nan_sum = pfar0 + pclose_x;
  set_code(&code, nan_sum != nan_sum, -4);

  float incx = pclose_x - pfar0;
  float incy = pclose_y - pfar1;
  const float epl_len = sqrtf(incx * incx + incy * incy);
  set_code(&code, !(epl_len > 0.f) || is_inf(epl_len), -4);

  // crop to MAX_EPL_LENGTH_CROP
  const bool crop = epl_len > p.max_epl_length_crop;
  const float safe_len = epl_len > 0.f ? epl_len : 1.f;
  if (crop) {
    pclose_x = pfar0 + incx * p.max_epl_length_crop / safe_len;
    pclose_y = pfar1 + incy * p.max_epl_length_crop / safe_len;
  }
  incx = incx * p.gradient_sample_dist / safe_len;
  incy = incy * p.gradient_sample_dist / safe_len;

  float pfar_x = pfar0 - incx, pfar_y = pfar1 - incy;
  pclose_x = pclose_x + incx;
  pclose_y = pclose_y + incy;

  // pad to MIN_EPL_LENGTH_CROP
  const float pad = epl_len < p.min_epl_length_crop
                        ? (p.min_epl_length_crop - epl_len) / 2.f : 0.f;
  pfar_x = pfar_x - incx * pad;
  pfar_y = pfar_y - incy * pad;
  pclose_x = pclose_x + incx * pad;
  pclose_y = pclose_y + incy * pad;

  // far point outside the image: skip
  const float b = p.sample_point_to_border;
  const float Wb = (float)W - b, Hb = (float)H - b;
  set_code(&code, pfar_x <= b || pfar_x >= Wb || pfar_y <= b || pfar_y >= Hb,
           -1);

  // near point outside: clamp along the line, x first, then y on the
  // updated values
  const bool lo_x = pclose_x <= b, hi_x = pclose_x >= Wb;
  const float isx = guard(incx);
  const float add_x = lo_x ? (b - pclose_x) / isx
                           : (hi_x ? (Wb - pclose_x) / isx : 0.f);
  pclose_x = pclose_x + add_x * incx;
  pclose_y = pclose_y + add_x * incy;
  const bool lo_y = pclose_y <= b, hi_y = pclose_y >= Hb;
  const float isy = guard(incy);
  const float add_y = lo_y ? (b - pclose_y) / isy
                           : (hi_y ? (Hb - pclose_y) / isy : 0.f);
  pclose_x = pclose_x + add_y * incx;
  pclose_y = pclose_y + add_y * incy;
  const float fincx = pclose_x - pfar_x, fincy = pclose_y - pfar_y;
  const float new_len = sqrtf(fincx * fincx + fincy * fincy);
  const bool still_out = pclose_x <= b || pclose_x >= Wb || pclose_y <= b
                         || pclose_y >= Hb;
  const bool clamped = lo_x || hi_x || lo_y || hi_y;
  set_code(&code, clamped && (still_out || new_len < 8.f), -1);

  g.code = code;
  g.pfar_x = pfar_x;
  g.pfar_y = pfar_y;
  g.incx = incx;
  g.incy = incy;
  g.pclose_x = pclose_x;
  g.pclose_y = pclose_y;
  g.rescale = rescale;
  return g;
}

struct Match {
  int code;
  float idepth, var;
};

// The walk, subpixel step, triangulation and variance model of
// doLineStereo (_walk, DepthPropagation.cpp:611-885) for a pixel whose
// segment passed; real[5] is its keyframe descriptor
__device__ Match walk(float x, float y, const float real[5], float epxn,
                      float epyn, float gix, float giy, const Segment& g,
                      const float* __restrict__ cur, const float* s, int H,
                      int W, const StereoParams& p) {
  const int S = p.steps;
  const float nan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);
  float ee[kMaxSteps], ecorr[kMaxSteps];
  // samples at offsets k-2..k+2 of step k, and its errors e_j
  float win[5], e_prev[5];
  for (int o = -2; o < 2; ++o)
    win[o + 2] = sample(cur, g.pfar_x + (float)o * g.incx,
                        g.pfar_y + (float)o * g.incy, H, W);
  int num = 0;
  for (int k = 0; k < S; ++k) {
    const float fk = (float)k;
    if (k > 0) {                        // _step_cond; step 0 always runs
      const float posx = g.pfar_x + fk * g.incx;
      const float posy = g.pfar_y + fk * g.incy;
      if (!(((g.incx < 0.f) == (posx > g.pclose_x))
            && ((g.incy < 0.f) == (posy > g.pclose_y))))
        break;
    }
    win[4] = sample(cur, g.pfar_x + (fk + 2.f) * g.incx,
                    g.pfar_y + (fk + 2.f) * g.incy, H, W);
    float e[5];
    for (int j = 0; j < 5; ++j) e[j] = win[j] - real[j];
    float sse = e[0] * e[0];
    for (int j = 1; j < 5; ++j) sse = sse + e[j] * e[j];
    float corr = nan;
    if (k > 0) {
      corr = e[0] * e_prev[0];
      for (int j = 1; j < 5; ++j) corr = corr + e[j] * e_prev[j];
    }
    ee[k] = sse;
    ecorr[k] = corr;
    num = k + 1;
    for (int j = 0; j < 4; ++j) win[j] = win[j + 1];
    for (int j = 0; j < 5; ++j) e_prev[j] = e[j];
  }

  // torch.argmin over the steps (past the walk's end: inf): the first NaN,
  // else the first of equal minima; then over them with the best's inf
  int kbest = 0;
  float best = ee[0];
  for (int k = 1; k < num; ++k)
    if (best == best && (ee[k] != ee[k] || ee[k] < best)) {
      best = ee[k];
      kbest = k;
    }
  int ksecond = 0;
  float second = kbest == 0 ? inf : ee[0];
  for (int k = 1; k < num; ++k) {
    const float vk = k == kbest ? inf : ee[k];
    if (second == second && (vk != vk || vk < second)) {
      second = vk;
      ksecond = k;
    }
  }
  const float err_pre = kbest >= 1 ? ee[kbest - 1] : -1.f;
  const bool has_post = kbest + 1 < num;
  const float err_post = has_post ? ee[kbest + 1] : -1.f;
  const float diff_pre = ecorr[kbest];
  // read only where has_post (the parabola needs err_post >= 0)
  const float diff_post = has_post ? ecorr[kbest + 1] : 0.f;

  int code = g.code;
  set_code(&code, best > p.four_max_error_stereo, -3);
  const int dk = kbest - ksecond;
  set_code(&code, (dk > 1 || dk < -1)
                      && p.min_distance_error_stereo * best > second, -2);

  // subpixel refinement
  const float grad_pre_pre = -(err_pre - diff_pre);
  const float grad_pre_this = best - diff_pre;
  const float grad_post_this = -(best - diff_post);
  const float grad_post_post = err_post - diff_post;
  const bool has_both = err_pre >= 0.f && err_post >= 0.f;
  const bool zc_pre = (grad_pre_pre < 0.f) != (grad_pre_this < 0.f);
  const bool zc_post = (grad_post_post < 0.f) != (grad_post_this < 0.f);
  const bool interp_pre = has_both && zc_pre && !zc_post;
  const bool interp_post = has_both && !zc_pre && zc_post;
  const float d_pre = grad_pre_this / guard(grad_pre_this - grad_pre_pre);
  const float d_post = grad_post_this / guard(grad_post_this - grad_post_post);
  const float kf = (float)kbest;
  float best_x = g.pfar_x + kf * g.incx;
  float best_y = g.pfar_y + kf * g.incy;
  if (interp_pre) {
    best_x = best_x - d_pre * g.incx;
    best_y = best_y - d_pre * g.incy;
    best = (best - 2.f * d_pre * grad_pre_this)
           - (grad_pre_pre - grad_pre_this) * d_pre * d_pre;
  } else if (interp_post) {
    best_x = best_x + d_post * g.incx;
    best_y = best_y + d_post * g.incy;
    best = (best + 2.f * d_post * grad_post_this)
           + (grad_post_post - grad_post_this) * d_post * d_post;
  }
  const bool did_subpixel = interp_pre || interp_post;

  // gradient along the line and the final error check
  const float sample_dist = p.gradient_sample_dist * g.rescale;
  const float d43 = real[4] - real[3], d32 = real[3] - real[2];
  const float d21 = real[2] - real[1], d10 = real[1] - real[0];
  float g_along = ((d43 * d43 + d32 * d32) + d21 * d21) + d10 * d10;
  g_along = g_along / (fabsf(sample_dist) > 1e-12f
                           ? sample_dist * sample_dist : 1e-12f);
  set_code(&code,
           best > p.max_error_stereo + sqrtf(max_nan(g_along, 0.f)) * 20.f,
           -3);

  // triangulation; the reference's 1/fx in both branches
  const float* R = s + kR;
  const float* t = s + kT;
  const float rfx = 1.f / p.fx;
  const float kx = (x - p.cx) * rfx;
  const float ky = (y - p.cy) * (1.f / p.fy);
  const float dot0 = (R[0] * kx + R[1] * ky) + R[2];
  const float dot1 = (R[3] * kx + R[4] * ky) + R[5];
  const float dot2 = (R[6] * kx + R[7] * ky) + R[8];
  const bool use_x = g.incx * g.incx > g.incy * g.incy;
  const float old_x = best_x * rfx - p.cx_over_fx;
  const float old_y = best_y * (1.f / p.fy) - p.cy_over_fy;
  const float nom = use_x ? old_x * t[2] - t[0] : old_y * t[2] - t[1];
  const float nom_safe = guard(nom);
  const float idepth = use_x ? (dot0 - old_x * dot2) / nom_safe
                             : (dot1 - old_y * dot2) / nom_safe;
  const float alpha =
      use_x ? g.incx * rfx * (dot0 * t[2] - dot2 * t[0])
                  / (nom_safe * nom_safe)
            : g.incy * rfx * (dot1 * t[2] - dot2 * t[1])
                  / (nom_safe * nom_safe);
  set_code(&code, idepth < 0.f, -2);

  // variance model; a Python scalar over a tensor is the tensor's
  // reciprocal times the scalar
  const float photo = (1.f / (g_along + p.division_eps))
                      * p.four_camera_pixel_noise;
  const float geo_den = (gix * epxn + giy * epyn) + p.division_eps;
  const float geo = 0.0625f * (gix * gix + giy * giy) / (geo_den * geo_den);
  const float disc = (did_subpixel ? 0.05f : 0.5f) * sample_dist
                     * sample_dist;
  Match m;
  m.code = code;
  m.idepth = idepth;
  m.var = alpha * alpha * ((disc + geo) + photo);
  return m;
}

__global__ void __launch_bounds__(kThreads) stereo_observe(const StereoArgs a) {
  const int v = blockIdx.y;
  const StereoParams& p = a.p;
  __shared__ float s[kPoseFloats];
  __shared__ int s_count[2];
  const int tid = threadIdx.x;
  if (tid == 0) {
    float R[3][3], t[3];
    exp_se3(a.pose + 6 * v, R, t);
    const float K[3][3] = {{p.fx, 0.f, p.cx}, {0.f, p.fy, p.cy},
                           {0.f, 0.f, 1.f}};
    float KR[3][3];
    mat3(K, R, KR);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        s[kR + 3 * i + j] = R[i][j];
        s[kKR + 3 * i + j] = KR[i][j];
      }
      s[kT + i] = t[i];
      s[kKt + i] = K[i][0] * t[0] + K[i][1] * t[1] + K[i][2] * t[2];
      s[kTkc + i] = -(R[0][i] * t[0] + R[1][i] * t[1] + R[2][i] * t[2]);
    }
    s_count[0] = 0;
    s_count[1] = 0;
  }
  __syncthreads();

  const int H = a.H, W = a.W, n = H * W;
  const int px = blockIdx.x * kThreads + tid;
  bool created = false, updated = false;
  if (px < n) {
    const int row = px / W, col = px - (px / W) * W;
    const size_t base = (size_t)v * n + px;
    const float x = (float)col, y = (float)row;
    const float* kf = a.kf_image + (size_t)v * n;
    float idepth = a.idepth[base], var = a.var[base];
    float ids = a.idepth_smoothed[base], vs = a.var_smoothed[base];
    float validity = a.validity[base];
    int blk = a.blacklisted[base];
    const bool has_hyp = a.valid[base] != 0;
    const float mg = a.kf_maxgrad[base];

    // gates (DepthPropagation.cpp:224-235)
    const int b = p.border;
    const bool active = col >= b && col < W - b && row >= b && row < H - b;
    const bool kill = active && has_hyp && mg < p.min_abs_grad_decrease;
    bool valid = has_hyp && !kill;
    const bool skip = mg < p.min_abs_grad_create || blk < p.min_blacklist;
    const bool do_pixel = active && !kill && !skip;

    // epl_direction, with the raw +-1 neighbours of the keyframe image
    const float tx = s[kTkc], ty = s[kTkc + 1], tz = s[kTkc + 2];
    const float epx = (-p.fx) * tx + tz * (x - p.cx);
    const float epy = (-p.fy) * ty + tz * (y - p.cy);
    const float ep_sum = epx + epy;
    bool epl_ok = ep_sum == ep_sum;
    const float len2 = epx * epx + epy * epy;
    epl_ok = epl_ok && len2 >= p.min_epl_length_squared;
    const float gx = col >= 1 && col <= W - 2 ? kf[px + 1] - kf[px - 1] : 0.f;
    const float gy = row >= 1 && row <= H - 2 ? kf[px + W] - kf[px - W] : 0.f;
    const float dot = gx * epx + gy * epy;
    const float grad2 = dot * dot / (len2 > 0.f ? len2 : 1.f);
    epl_ok = epl_ok && grad2 >= p.min_epl_grad_squared;
    const float g2 = gx * gx + gy * gy;
    epl_ok = epl_ok
             && grad2 / (g2 > 0.f ? g2 : 1e-12f) >= p.min_epl_angle_squared;
    const bool run = do_pixel && epl_ok;

    if (run) {
      const float fac = (1.f / sqrtf(len2 > 0.f ? len2 : 1.f))
                        * p.gradient_sample_dist;
      const float epxn = epx * fac, epyn = epy * fac;
      // the search band (create: :279-282; update: :898-904)
      const float sv = sqrtf(max_nan(vs, 0.f));
      const float min_id =
          has_hyp ? max_nan(ids - sv * p.stereo_epl_var_fac, 0.f) : 0.f;
      const float prior = has_hyp ? ids : 1.f;
      const float max_id =
          has_hyp ? min_nan(ids + sv * p.stereo_epl_var_fac, p.inv_min_depth)
                  : p.inv_min_depth;
      const Segment g = segment_setup(x, y, epxn, epyn, min_id, prior,
                                      max_id, s, H, W, p);
      if (g.code == 0) {
        // the 5-tap keyframe descriptor (_kf_descriptor)
        float real[5];
        for (int j = -2; j <= 2; ++j)
          real[j + 2] = j == 0 ? kf[px]
                               : sample(kf, x + ((float)j * epxn) * g.rescale,
                                        y + ((float)j * epyn) * g.rescale,
                                        H, W);
        const Match r = walk(x, y, real, epxn, epyn, a.kf_gradx[base],
                             a.kf_grady[base], g,
                             a.cur_image + (size_t)v * n, s, H, W, p);

        // CREATE (:267-308) and UPDATE (:888-999), in the plain twin's
        // order of selects
        const bool create_blacklist = !has_hyp
                                      && (r.code == -3 || r.code == -2);
        const bool create_ok = !has_hyp && r.code == 0 && r.var <= p.max_var;
        const float diff = r.idepth - ids;
        const bool u_notfound = has_hyp && r.code == -2;
        const bool inconsistent =
            has_hyp && r.code == 0
            && p.diff_fac_observe * diff * diff > r.var + vs;
        const bool u_success = has_hyp && r.code == 0 && !inconsistent;

        float new_var = var;
        if (u_notfound) {
          validity = max_nan(validity - p.validity_counter_dec, 0.f);
          new_var = var * p.fail_var_inc_fac;
        }
        const bool nf_kill = u_notfound && new_var > p.max_var;
        valid = valid && !nf_kill;
        if (nf_kill) blk = blk - 1;
        if (inconsistent) new_var = new_var * p.fail_var_inc_fac;
        valid = valid && !(inconsistent && new_var > p.max_var);

        if (u_success) {
          const float id_var = var * p.succ_var_inc_fac;
          const float w = r.var / (r.var + id_var);
          float fused = (1.f - w) * r.idepth + w * idepth;
          if (fabsf(fused) < 1e-10f) fused = fused < 0.f ? -1e-10f : 1e-10f;
          const float id_var_post = id_var * w;
          idepth = fused;
          if (id_var_post < new_var) new_var = id_var_post;
          validity = validity + p.validity_counter_inc;
          const float vmax = p.validity_counter_max
                             + mg * p.validity_counter_max_variable
                                   * (1.f / 255.f);
          if (validity > vmax) validity = vmax;
        }
        if (create_ok) {
          float c = r.idepth;
          if (fabsf(c) < 1e-10f) c = c < 0.f ? -1e-10f : 1e-10f;
          idepth = c;
          new_var = r.var;
          ids = -1.f;
          vs = -1.f;
          validity = p.validity_counter_initial_observe;
          valid = true;
          blk = 0;
        } else if (create_blacklist) {
          blk = blk - 1;
        }
        var = new_var;
        created = create_ok;
        updated = u_success;
      }
    }
    a.out_idepth[base] = idepth;
    a.out_var[base] = var;
    a.out_idepth_smoothed[base] = ids;
    a.out_var_smoothed[base] = vs;
    a.out_validity[base] = validity;
    a.out_blacklisted[base] = blk;
    a.out_valid[base] = valid ? 1 : 0;
  }

  if (created) atomicAdd(&s_count[0], 1);
  if (updated) atomicAdd(&s_count[1], 1);
  __syncthreads();
  if (tid == 0) {
    if (s_count[0] != 0) atomicAdd(&a.num_created[v], s_count[0]);
    if (s_count[1] != 0) atomicAdd(&a.num_updated[v], s_count[1]);
  }
}

}  // namespace

// K2 over V videos: the state, keyframe and current planes (V, H, W), the
// poses (V, 6); writes the new state's planes (V, H, W) and adds each
// video's created and updated pixels to num_created and num_updated (V,),
// which the caller zeroes.  Returns cudaErrorInvalidValue, launching
// nothing, if p.steps is outside 1..64.
extern "C" int ellc_stereo_observe(
    const float* idepth, const float* var, const float* idepth_smoothed,
    const float* var_smoothed, const float* validity,
    const int32_t* blacklisted, const uint8_t* valid, const float* kf_image,
    const float* kf_gradx, const float* kf_grady, const float* kf_maxgrad,
    const float* cur_image, const float* pose, float* out_idepth,
    float* out_var, float* out_idepth_smoothed, float* out_var_smoothed,
    float* out_validity, int32_t* out_blacklisted, uint8_t* out_valid,
    int32_t* num_created, int32_t* num_updated, int V, int H, int W,
    StereoParams p, void* stream) {
  if (p.steps < 1 || p.steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  const StereoArgs a{idepth, var, idepth_smoothed, var_smoothed, validity,
                     blacklisted, valid, kf_image, kf_gradx, kf_grady,
                     kf_maxgrad, cur_image, pose, out_idepth, out_var,
                     out_idepth_smoothed, out_var_smoothed, out_validity,
                     out_blacklisted, out_valid, num_created, num_updated,
                     H, W, p};
  const dim3 grid((H * W + kThreads - 1) / kThreads, V);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  stereo_observe<<<grid, dim3(kThreads), 0, stream_>>>(a);
  return (int)cudaGetLastError();
}
