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
//   stereo_observe: grid (tiles, V), a block a tile of 32 x kTileH
//     keyframe pixels (a warp a row of it), a thread a pixel, in three
//     passes between __syncthreads.  Thread 0 first computes the video's
//     pose blocks into shared memory (exp_se3 formula by formula, R, t,
//     K R, K t, t_kf_from_cur = -R^T t).
//   A (a thread a pixel): observe's gates, the epipolar direction from the
//     keyframe's raw +-1 neighbours, the search band, the segment and its
//     pre-checks (the first failure wins, as _set_code) and, where the
//     segment passed, the 5-tap descriptor and the variance model's
//     geometric term.  Those pixels are the walkers: __ballot_sync and
//     __popc in each warp and a prefix over the block's warps put them in
//     a list in shared memory, in the tile's pixel order.  The box of the
//     current image that the walks sample (each from pfar - 2 inc to
//     pclose + 2 inc, a min and max over the block) is loaded into shared
//     memory, up to kBoxFloats of it, 0 outside the image.
//   B (a thread a walker): thread t walks the list's t-th entry, so the
//     walks fill whole warps.  A step is _step_cond (the walk ends at the
//     first step that fails it; step 0 always runs), one bilinear sample
//     of the current image (image/interp.py's semantics; from the box
//     where its four corners lie in it, else from the image: the same
//     value), the SSD and its correlation with the step before, each
//     summed in _walk's order; the best and second-best steps in
//     torch.argmin's order (the first NaN, else the first of equal minima)
//     and the best's neighbours are kept as the steps come, so nothing is
//     indexed by the step at run time (no local memory).  Then the
//     subpixel parabola, the error checks, triangulation (the reference's
//     1/fx in both branches) and the variance model; the match goes over
//     the entry.
//   C (a thread a pixel): the EKF create and update rules in the plain
//     twin's order, reading the pixel's match from the list, and the
//     writes.  A pixel that does not run, or whose segment failed, has
//     its line_stereo results never read by observe (every rule needs
//     code 0, -2 or -3, and the segment sets only -1 or -4): it walks not.
//
// Why this layout (tools/time_k2.py, PERF.md).  About three pixels in ten
// walk, in clusters: a walk is ~33 steps of ~100 operations and a gather
// each.  With a thread a pixel (the first version) a walking warp ran at the
// pace of its longest walk with most lanes idle, the SSD history (ee[64],
// ecorr[64], indexed at run time) sat on a 512-byte stack, and each step's
// corners came from L2.  The list keeps the walking warps full, the steps
// keep no history, and the box serves the gathers from shared memory.  A
// warp a walker (lane l taking steps l and l + 32, reductions by shuffle)
// was measured slower: the densest tiles, where every pixel walks, then
// ran their walks a warp at a time.  One launch a step, as before: the
// list lives in shared memory, so there is no second launch (which would
// double K2's launches a step) and no global atomic; the price is that a
// tile's walks stay on its SM, so at one video the densest tiles set the
// kernel's time.
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
// step) takes less at the card's float32 rate.  The kernel reaches
// neither: it issues ~100 instructions a walked step (the bilinear
// gather's index arithmetic, the separate multiplies and adds of
// -fmad=false, the argmin's NaN rule) in warps whose walks end at
// different steps, with few warps an SM to hide each step's dependent
// chain (64 registers a thread), and at one video its densest tiles
// finish last.
//
// Built with -fmad=false (no contracted multiply-add), as the port's other
// kernels.  Plain C interface, bound with ctypes: the entry point launches
// on the given stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <limits.h>
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

// a block is a tile of 32 x kTileH keyframe pixels, a thread each (a
// warp a row), and it holds the box of the current image that its walks
// sample, up to kBoxFloats of it, in shared memory; tools/time_k2.py
// times other values
#ifndef ELLC_K2_TILE_H
#define ELLC_K2_TILE_H 8
#endif
#ifndef ELLC_K2_BOX
#define ELLC_K2_BOX 6144
#endif
// blocks an SM must hold at once (__launch_bounds__): a register cap
#ifndef ELLC_K2_MIN_BLOCKS
#define ELLC_K2_MIN_BLOCKS 4
#endif
constexpr int kTileW = 32, kTileH = ELLC_K2_TILE_H;
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads <= 1024, "a block of at most 1024 threads");
constexpr int kBoxFloats = ELLC_K2_BOX;
constexpr int kMinBlocks = ELLC_K2_MIN_BLOCKS;
// the walk's most steps (ops/stereo_kernel.py MAX_STEPS)
constexpr int kMaxSteps = 64;
constexpr unsigned kAll = 0xffffffffu;

// a walker's entry in the block's list, one shared array of kThreads a
// field; after its walk the match takes the place of kIdepth and kVar
// (and its code that of the pixel index)
enum {
  kPfarX, kPfarY, kIncX, kIncY, kPcloseX, kPcloseY, kRescale, kReal,
  kGeo = kReal + 5, kFields, kIdepth = kPfarX, kVar = kPfarY
};
// dynamic shared memory: the current image's box, then the list
constexpr int kSmemBytes = (kBoxFloats + (kFields + 1) * kThreads) * 4;

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

// A box of the current image in shared memory: w columns from ox and h
// rows from oy, 0 outside the image
struct Box {
  const float* v;
  int ox, oy, w, h;
};

// bilinear_fill of the current image at (x, y), from the box where all
// four corners lie in it, else from the image: the same values either way
// (a corner outside the image is 0 in both, and to_index's clamp to
// [-1, n] moves an outside corner only to another outside one)
__device__ __forceinline__ float sample(const Box& b,
                                        const float* __restrict__ img,
                                        float x, float y, int H, int W) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = ceilf(x), y1 = ceilf(y);
  const float ax = x - x0, ay = y - y0;
  const float bx = (float)b.ox, by = (float)b.oy;
  if (x0 >= bx && y0 >= by && x1 <= bx + (float)(b.w - 1)
      && y1 <= by + (float)(b.h - 1)) {
    const int cx0 = (int)(x0 - bx), cy0 = (int)(y0 - by);
    const int cx1 = (int)(x1 - bx), cy1 = (int)(y1 - by);
    return blend(b.v[cy0 * b.w + cx0], b.v[cy0 * b.w + cx1],
                 b.v[cy1 * b.w + cx0], b.v[cy1 * b.w + cx1], ax, ay);
  }
  const int x0i = to_index(x0, W), y0i = to_index(y0, H);
  const int x1i = to_index(x1, W), y1i = to_index(y1, H);
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

// (value, step) a before (value, step) b in torch.argmin's order: a NaN
// before any number, else the smaller value; on a tie the earlier step
__device__ __forceinline__ bool precedes(float a, int ka, float b, int kb) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ka < kb;
}

// A walk's result, what the subpixel step needs of its SSD history: the
// best and second-best steps in torch.argmin's order and the best's
// neighbours (err_pre -1 at step 0, err_post -1 and diff_post 0 where the
// best is the walk's last step)
struct Walk {
  float best, second, err_pre, err_post, diff_pre, diff_post;
  int kbest, ksecond;
};

// entry e's segment and descriptor
__device__ __forceinline__ Segment entry(const float (*f)[kThreads], int e,
                                         float real[5]) {
  Segment g;
  g.code = 0;
  g.pfar_x = f[kPfarX][e];
  g.pfar_y = f[kPfarY][e];
  g.incx = f[kIncX][e];
  g.incy = f[kIncY][e];
  g.pclose_x = f[kPcloseX][e];
  g.pclose_y = f[kPcloseY][e];
  g.rescale = f[kRescale][e];
  for (int j = 0; j < 5; ++j) real[j] = f[kReal + j][e];
  return g;
}

// _step_cond at step k >= 1 (DepthPropagation.cpp:628)
__device__ __forceinline__ bool step_cond(const Segment& g, int k) {
  const float fk = (float)k;
  const float posx = g.pfar_x + fk * g.incx;
  const float posy = g.pfar_y + fk * g.incy;
  return ((g.incx < 0.f) == (posx > g.pclose_x))
         && ((g.incy < 0.f) == (posy > g.pclose_y));
}

// The walk of doLineStereo (_walk, DepthPropagation.cpp:611-710) by one
// thread, up to the first step whose _step_cond fails (step 0 always
// runs): a bilinear sample of the current image a step (image/interp.py's
// semantics, from the block's box), the SSD and its correlation with the
// step before, each summed in _walk's order, and the two first steps kept
// as they come.  Nothing is indexed by the step at run time, so the
// 5-sample window stays in registers.
__device__ Walk walk_thread(const Segment& g, const float real[5],
                            const Box& box, const float* __restrict__ cur,
                            int H, int W, int S) {
  const float nan = __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);
  // samples at offsets k-2..k+2 of step k, and its errors e_j
  float win[5], e_prev[5];
  for (int o = -2; o < 2; ++o)
    win[o + 2] = sample(box, cur, g.pfar_x + (float)o * g.incx,
                        g.pfar_y + (float)o * g.incy, H, W);
  for (int j = 0; j < 5; ++j) e_prev[j] = nan;
  Walk w;
  w.best = w.second = inf;
  w.kbest = w.ksecond = S;              // after every step of the walk
  w.err_pre = w.err_post = -1.f;
  w.diff_pre = nan;
  w.diff_post = 0.f;
  float ee_prev = 0.f;
  bool want_post = false;
  for (int k = 0; k < S; ++k) {
    if (k > 0 && !step_cond(g, k)) break;
    const float fk = (float)k;
    win[4] = sample(box, cur, g.pfar_x + (fk + 2.f) * g.incx,
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
    if (want_post) {
      w.err_post = sse;
      w.diff_post = corr;
      want_post = false;
    }
    if (precedes(sse, k, w.best, w.kbest)) {
      w.second = w.best;
      w.ksecond = w.kbest;
      w.best = sse;
      w.kbest = k;
      w.err_pre = k >= 1 ? ee_prev : -1.f;
      w.diff_pre = corr;
      w.err_post = -1.f;
      w.diff_post = 0.f;
      want_post = true;
    } else if (precedes(sse, k, w.second, w.ksecond)) {
      w.second = sse;
      w.ksecond = k;
    }
    ee_prev = sse;
    for (int j = 0; j < 4; ++j) win[j] = win[j + 1];
    for (int j = 0; j < 5; ++j) e_prev[j] = e[j];
  }
  // torch.argmin over the steps with the best's inf: past the walk's end
  // every step is inf, and the best's comes first of those
  if (!precedes(w.second, w.ksecond, inf, w.kbest)) {
    w.second = inf;
    w.ksecond = w.kbest;
  }
  return w;
}

// The subpixel step, error checks, triangulation and variance model of
// doLineStereo (DepthPropagation.cpp:711-885) after the walk w of keyframe
// pixel px; geo is the variance model's geometric term
__device__ Match tail(const Segment& g, const float real[5], float geo,
                      int px, Walk w, const float* s, int W,
                      const StereoParams& p) {
  float best = w.best;
  int code = g.code;
  set_code(&code, best > p.four_max_error_stereo, -3);
  const int dk = w.kbest - w.ksecond;
  set_code(&code, (dk > 1 || dk < -1)
                      && p.min_distance_error_stereo * best > w.second, -2);

  // subpixel refinement
  const float grad_pre_pre = -(w.err_pre - w.diff_pre);
  const float grad_pre_this = best - w.diff_pre;
  const float grad_post_this = -(best - w.diff_post);
  const float grad_post_post = w.err_post - w.diff_post;
  const bool has_both = w.err_pre >= 0.f && w.err_post >= 0.f;
  const bool zc_pre = (grad_pre_pre < 0.f) != (grad_pre_this < 0.f);
  const bool zc_post = (grad_post_post < 0.f) != (grad_post_this < 0.f);
  const bool interp_pre = has_both && zc_pre && !zc_post;
  const bool interp_post = has_both && !zc_pre && zc_post;
  const float d_pre = grad_pre_this / guard(grad_pre_this - grad_pre_pre);
  const float d_post = grad_post_this / guard(grad_post_this - grad_post_post);
  const float kf = (float)w.kbest;
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
  const int row = px / W, col = px - (px / W) * W;
  const float x = (float)col, y = (float)row;
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
  const float disc = (did_subpixel ? 0.05f : 0.5f) * sample_dist
                     * sample_dist;
  Match m;
  m.code = code;
  m.idepth = idepth;
  m.var = alpha * alpha * ((disc + geo) + photo);
  return m;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stereo_observe(const StereoArgs a) {
  const int v = blockIdx.y;
  const StereoParams& p = a.p;
  __shared__ float s[kPoseFloats];
  __shared__ int s_count[2];
  __shared__ int s_walkers[kWarps];
  __shared__ int s_box[4][kWarps];
  // the current image's box, then the list: kFields arrays of kThreads
  // floats and the pixel (after the walk the match's code) of each entry
  extern __shared__ float smem[];
  float (*l_f)[kThreads] =
      reinterpret_cast<float (*)[kThreads]>(smem + kBoxFloats);
  int* l_px = reinterpret_cast<int*>(smem + kBoxFloats + kFields * kThreads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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

  // pass A: a thread a pixel, up to the segment and the descriptor
  const int H = a.H, W = a.W, n = H * W;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int row = ty0 + tid / kTileW, col = tx0 + tid % kTileW;
  const bool in_image = row < H && col < W;
  const int px = row * W + col;
  const size_t base = (size_t)v * n + px;
  const float* kf = a.kf_image + (size_t)v * n;
  const float* cur = a.cur_image + (size_t)v * n;
  float idepth = 0.f, var = 0.f, ids = 0.f, vs = 0.f, validity = 0.f, mg = 0.f;
  int blk = 0;
  bool has_hyp = false, valid = false, walker = false;
  Segment g;
  float real[5], geo = 0.f;
  if (in_image) {
    const float x = (float)col, y = (float)row;
    idepth = a.idepth[base];
    var = a.var[base];
    ids = a.idepth_smoothed[base];
    vs = a.var_smoothed[base];
    validity = a.validity[base];
    blk = a.blacklisted[base];
    has_hyp = a.valid[base] != 0;
    mg = a.kf_maxgrad[base];

    // gates (DepthPropagation.cpp:224-235)
    const int b = p.border;
    const bool active = col >= b && col < W - b && row >= b && row < H - b;
    const bool kill = active && has_hyp && mg < p.min_abs_grad_decrease;
    valid = has_hyp && !kill;
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

    if (do_pixel && epl_ok) {
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
      g = segment_setup(x, y, epxn, epyn, min_id, prior, max_id, s, H, W, p);
      walker = g.code == 0;
      if (walker) {
        // the 5-tap keyframe descriptor (_kf_descriptor)
        for (int j = -2; j <= 2; ++j)
          real[j + 2] = j == 0 ? kf[px]
                               : sample(kf, x + ((float)j * epxn) * g.rescale,
                                        y + ((float)j * epyn) * g.rescale,
                                        H, W);
        // the variance model's geometric term
        const float gix = a.kf_gradx[base], giy = a.kf_grady[base];
        const float geo_den = (gix * epxn + giy * epyn) + p.division_eps;
        geo = 0.0625f * (gix * gix + giy * giy) / (geo_den * geo_den);
      }
    }
  }

  // the box a walk samples: from pfar - 2 inc to pclose + 2 inc (the
  // walk stops at the first step past pclose), a pixel more each way for
  // the bilinear corners
  int box[4] = {INT_MAX, INT_MAX, INT_MIN, INT_MIN};    // x0, y0, x1, y1
  if (walker) {
    const float ex = g.pfar_x - 2.f * g.incx, ey = g.pfar_y - 2.f * g.incy;
    const float fx = g.pclose_x + 2.f * g.incx;
    const float fy = g.pclose_y + 2.f * g.incy;
    box[0] = (int)floorf(fminf(ex, fx)) - 1;
    box[1] = (int)floorf(fminf(ey, fy)) - 1;
    box[2] = (int)ceilf(fmaxf(ex, fx)) + 1;
    box[3] = (int)ceilf(fmaxf(ey, fy)) + 1;
  }
  for (int m = 16; m >= 1; m >>= 1)
    for (int i = 0; i < 4; ++i) {
      const int o = __shfl_xor_sync(kAll, box[i], m);
      box[i] = i < 2 ? (o < box[i] ? o : box[i]) : (o > box[i] ? o : box[i]);
    }

  // the walkers in the tile's pixel order: a warp's ballot (a warp a row
  // of the tile), a prefix over the warps
  const unsigned ballot = __ballot_sync(kAll, walker);
  if (lane == 0) {
    s_walkers[warp] = __popc(ballot);
    for (int i = 0; i < 4; ++i) s_box[i][warp] = box[i];
  }
  __syncthreads();
  int slot = 0, walkers = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) slot += s_walkers[w];
    walkers += s_walkers[w];
    for (int i = 0; i < 4; ++i)
      box[i] = i < 2 ? min(box[i], s_box[i][w]) : max(box[i], s_box[i][w]);
  }
  slot += __popc(ballot & ((1u << lane) - 1u));
  if (walker) {
    l_px[slot] = px;
    l_f[kPfarX][slot] = g.pfar_x;
    l_f[kPfarY][slot] = g.pfar_y;
    l_f[kIncX][slot] = g.incx;
    l_f[kIncY][slot] = g.incy;
    l_f[kPcloseX][slot] = g.pclose_x;
    l_f[kPcloseY][slot] = g.pclose_y;
    l_f[kRescale][slot] = g.rescale;
    for (int j = 0; j < 5; ++j) l_f[kReal + j][slot] = real[j];
    l_f[kGeo][slot] = geo;
  }
  // the current image over the box, as much of it as kBoxFloats holds
  // (rows from its top), 0 outside the image
  Box cbox{smem, box[0], box[1], 0, 0};
  if (walkers > 0) {
    cbox.w = min(box[2] - box[0] + 1, kBoxFloats);
    cbox.h = min(box[3] - box[1] + 1, kBoxFloats / cbox.w);
  }
  for (int i = tid; i < cbox.w * cbox.h; i += kThreads) {
    const int gy = cbox.oy + i / cbox.w, gx = cbox.ox + i % cbox.w;
    smem[i] = gy >= 0 && gy < H && gx >= 0 && gx < W ? cur[gy * W + gx]
                                                      : 0.f;
  }
  __syncthreads();

  // pass B: thread t walks the list's t-th entry; the match over it
  if (tid < walkers) {
    float real_e[5];
    const Segment ge = entry(l_f, tid, real_e);
    const Match r = tail(ge, real_e, l_f[kGeo][tid], l_px[tid],
                         walk_thread(ge, real_e, cbox, cur, H, W, p.steps),
                         s, W, p);
    l_px[tid] = r.code;
    l_f[kIdepth][tid] = r.idepth;
    l_f[kVar][tid] = r.var;
  }
  __syncthreads();

  // pass C: a thread a pixel, the EKF rules and the writes
  bool created = false, updated = false;
  if (in_image) {
    if (walker) {
      Match r;
      r.code = l_px[slot];
      r.idepth = l_f[kIdepth][slot];
      r.var = l_f[kVar][slot];
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
  const dim3 grid(((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH),
                  V);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  cudaFuncSetAttribute(stereo_observe,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  stereo_observe<<<grid, dim3(kThreads), kSmemBytes, stream_>>>(a);
  return (int)cudaGetLastError();
}
