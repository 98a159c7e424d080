// The keyframe's depth-pyramid refresh for NVIDIA Hopper (sm_90a): one
// launch for every level of a state or a batch of states.
//
// Replaces depth/fusion.py::refresh_depth_pyramid on CUDA tensors, the
// plain depth/state.py::to_depth_image then
// depth/fusion.py::build_depth_var_pyramid (the JAX package's
// depth/state.py:98 and depth/fusion.py:44 with fuse_level :20;
// depthMap::updateDepthImage and buildInvVarDepth,
// src/DepthPropagation.cpp:1254-1308, 1637-1719), which plain PyTorch
// runs as ~80 ATen kernels a frame:
//
//   - level 0: valid = valid & the interior that leaves out a border of
//     ``border`` pixels; where valid and idepth_smoothed >= -0.05, depth
//     1 / idepth_smoothed (|x| clamped up to 1e-12) and var_smoothed,
//     else depth 0 and var -1;
//   - level l + 1 (floor-halved shapes): each cell fuses its 2x2 children
//     whose var > 0 by inverse variance in inverse-depth space, the sums
//     in the twin's order (child (0,0) + (0,1)) + ((1,0) + (1,1)); with
//     no such child depth 0 and var -1.
//
// A block takes a 32x32 tile of level 0 and the tiles of every level
// above it (16x16, 8x8, 4x4), which lie in the same block because a
// tile's origin is even at every level; each level goes through shared
// memory to the next, so the levels' floor shapes (270 -> 135 -> 67 ->
// 33 rows) need no care: a cell exists where its level's shape has it,
// and its children always exist below it.  blockIdx.y is the state of a
// batch.  Every output is written once, in one launch.  The arithmetic is
// the twin's, operation by operation (-fmad=false, IEEE divisions), so
// the kernel is bit-equal to it.
//
// What bounds it.  Per level-0 pixel the state's valid flag, smoothed
// inverse depth and variance read once, and the new valid flag, depth
// and variance written once (18 B), plus the coarser levels' depth and
// variance (8 B a cell): ~2.7 MB for one 270x480 state (0.8 us at 3.35
// TB/s); a few float32 operations a pixel.  At 270x480 the grid is 9 x 15
// blocks, about one an SM; a block's levels run one after another between
// barriers, so its latency, not the bytes, sets the time (64x64 tiles, 40
// blocks, took twice as long).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;           // level-0 pixels a side of a block's tile
constexpr int kMaxLevels = 4;       // kTile >> (kMaxLevels - 1) >= 1

}  // namespace

// outside the anonymous namespace: a struct in the signature of the
// extern "C" entry point would keep nvcc from exporting it
struct RefreshArgs {
  const uint8_t* valid;      // (B, H, W)
  const float* idepth_s;     // idepth_smoothed
  const float* var_s;        // var_smoothed
  uint8_t* valid_out;
  float* depth[kMaxLevels];  // level l: (B, H_l, W_l)
  float* var[kMaxLevels];
  int H, W, levels, border, tiles_x;
};

namespace {

// one child's terms of the fusion (fusion.py fuse_level): 1/var and
// 1/depth where var > 0, else 0
__device__ __forceinline__ void child(float d, float v, float* ivar,
                                      float* inv_d, float* n) {
  const bool ok = v > 0.f;
  *ivar = ok ? 1.f / v : 0.f;
  *inv_d = ok ? 1.f / (fabsf(d) > 1e-12f ? d : 1e-12f) : 0.f;
  *n = ok ? 1.f : 0.f;
}

__global__ void __launch_bounds__(kThreads) depth_refresh(const RefreshArgs a) {
  // a level's depth and variance: level 0 in buffer 0, then odd levels
  // in buffer 1 and even ones in buffer 0 (10 KB in all)
  __shared__ float sd0[kTile * kTile], sv0[kTile * kTile];
  __shared__ float sd1[kTile * kTile / 4], sv1[kTile * kTile / 4];
  const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x % a.tiles_x;
  const size_t b = blockIdx.y;
  int H = a.H, W = a.W;
  // level 0 from the state
  for (int k = threadIdx.x; k < kTile * kTile; k += kThreads) {
    const int y = ty * kTile + k / kTile, x = tx * kTile + k % kTile;
    if (y >= H || x >= W) continue;
    const size_t i = b * H * W + (size_t)y * W + x;
    const bool inside = y >= a.border && y < H - a.border && x >= a.border
                        && x < W - a.border;
    const bool valid = a.valid[i] != 0 && inside;
    const float ids = a.idepth_s[i];
    const bool usable = valid && ids >= -0.05f;
    const float denom = fabsf(ids) > 1e-12f ? ids : 1e-12f;
    const float d = usable ? 1.f / denom : 0.f;
    const float v = usable ? a.var_s[i] : -1.f;
    a.valid_out[i] = valid ? 1 : 0;
    a.depth[0][i] = d;
    a.var[0][i] = v;
    sd0[k] = d;
    sv0[k] = v;
  }
  // level l from level l - 1, unrolled so that a.depth[l] and a.var[l]
  // are read at constant indices (no copy of the arguments to the stack)
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l >= a.levels) break;
    __syncthreads();
    const int T = kTile >> l, Tp = kTile >> (l - 1);
    const int Hp = H, Wp = W;
    H = Hp / 2;
    W = Wp / 2;
    const float* pd = (l & 1) ? sd0 : sd1;
    const float* pv = (l & 1) ? sv0 : sv1;
    float* od = (l & 1) ? sd1 : sd0;
    float* ov = (l & 1) ? sv1 : sv0;
    for (int k = threadIdx.x; k < T * T; k += kThreads) {
      const int ly = k / T, lx = k % T;
      const int y = ty * T + ly, x = tx * T + lx;
      if (y >= H || x >= W) continue;
      float i00, i01, i10, i11, q00, q01, q10, q11, n00, n01, n10, n11;
      const int c = (2 * ly) * Tp + 2 * lx;
      child(pd[c], pv[c], &i00, &q00, &n00);
      child(pd[c + 1], pv[c + 1], &i01, &q01, &n01);
      child(pd[c + Tp], pv[c + Tp], &i10, &q10, &n10);
      child(pd[c + Tp + 1], pv[c + Tp + 1], &i11, &q11, &n11);
      const float ivar_sum = (i00 + i01) + (i10 + i11);
      const float idepth_sum = (i00 * q00 + i01 * q01)
                               + (i10 * q10 + i11 * q11);
      const float num = (n00 + n01) + (n10 + n11);
      const bool any = num > 0.f;
      const float d = any ? ivar_sum / idepth_sum : 0.f;
      const float v = any ? num / ivar_sum : -1.f;
      const size_t i = b * H * W + (size_t)y * W + x;
      a.depth[l][i] = d;
      a.var[l][i] = v;
      od[k] = d;
      ov[k] = v;
    }
  }
}

}  // namespace

// The refresh of B states (H, W) into ``levels`` levels on ``stream``;
// depth and var hold each level's two output planes.  Returns the
// launch's cudaError (0 when it was queued).
extern "C" int ellc_depth_refresh(const uint8_t* valid, const float* idepth_s,
                                  const float* var_s, uint8_t* valid_out,
                                  float* const* depth, float* const* var,
                                  int B, int H, int W, int levels,
                                  int border, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || levels < 1 || levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + kTile - 1) / kTile;
  RefreshArgs a{valid, idepth_s, var_s, valid_out, {}, {}, H, W, levels,
                border, tiles_x};
  for (int l = 0; l < levels; ++l) {
    a.depth[l] = depth[l];
    a.var[l] = var[l];
  }
  const dim3 grid(tiles_x * ((H + kTile - 1) / kTile), B);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  depth_refresh<<<grid, dim3(kThreads), 0, stream_>>>(a);
  return (int)cudaGetLastError();
}
