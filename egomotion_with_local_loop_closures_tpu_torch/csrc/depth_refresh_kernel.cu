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
// A warp owns 4 rows of 32 level-0 pixels and the cells above them (2x16
// and 1x8 at levels 1-2): lane (r, c), r = lane / 8, holds the four
// pixels of row r at columns 4c..4c+3, so each of its loads and stores is
// 128 bytes of a row (32 of flags).  A level-1 cell's children lie in one
// thread (its two columns) and the thread of the next row, lane ^ 8; a
// level-2 cell's in two threads and lane ^ 16.  Each row of a 2x2 is
// summed where it lies and the lower row's sums come by one
// __shfl_xor_sync each, so levels 1 and 2 fuse from registers.  A level-3
// cell's children lie in lanes c and c ^ 1 of two warps, one above the
// other: the lower warp's row sums come through shared memory, the one
// barrier.  Both threads of a pair keep the cell (the same operations on
// the same values), and one writes it.  A block is kTileH x kTileW
// pixels of such warps; blockIdx.y is the state of a batch.  Each thread
// issues its level-0 loads (the flags, the smoothed inverse depth and
// variance of its four pixels) before it uses any: where every row starts
// 16-byte aligned (W a multiple of 4, aligned planes), one 4-byte load of
// flags and one float4 of each plane, else four scalar loads of each.
// The levels' floor shapes (270 -> 135 -> 67 -> 33 rows) need no care: a
// cell is written where its level's shape has it, and its children always
// exist below it.  Every output is written once, in one launch.  The
// arithmetic is the twin's, operation by operation (-fmad=false, IEEE
// divisions), so the kernel is bit-equal to it.
//
// What bounds it.  Per level-0 pixel the state's valid flag, smoothed
// inverse depth and variance read once, and the new valid flag, depth
// and variance written once (18 B), plus the coarser levels' depth and
// variance (8 B a cell): ~2.7 MB for one 270x480 state (0.8 us at 3.35
// TB/s); a few float32 operations a pixel.  One video at 270x480 is 255
// blocks of four warps, each warp one round trip of loads and then its
// stores: latency, not the bytes, sets the time; eight videos or 20
// states come near the bytes.  (Before: 32x32 tiles whose levels went
// through shared memory between barriers, each thread loading, computing
// and storing four pixels in turn; then warps of 8 rows of 16 pixels,
// whose 64-byte row pieces were no faster than it at eight videos.)

#include <cuda_runtime.h>
#include <cstdint>

#ifndef ELLC_REF_TILE_H
#define ELLC_REF_TILE_H 16
#endif
#ifndef ELLC_REF_TILE_W
#define ELLC_REF_TILE_W 32
#endif

namespace {

// a warp's level-0 pixels: 4 rows of 8 threads, each 4 adjacent pixels
constexpr int kWarpH = 4, kWarpW = 32;
constexpr int kTileH = ELLC_REF_TILE_H, kTileW = ELLC_REF_TILE_W;
static_assert(kTileH % (2 * kWarpH) == 0 && kTileW % kWarpW == 0,
              "a block's tile is whole pairs of warps, one above the other");
constexpr int kWarpsX = kTileW / kWarpW;
constexpr int kThreads = 32 * (kTileH / kWarpH) * kWarpsX;
constexpr int kMaxLevels = 4;             // two warps' 8 rows: 1 at level 3
constexpr unsigned kAll = 0xffffffffu;

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
  int vec;                   // 1: 16-byte aligned rows, vector loads
};

namespace {

// a child's terms of the fusion (fusion.py fuse_level): 1/var,
// 1/var * 1/depth and 1 where var > 0, else 0
struct Terms {
  float ivar, idepth, n;
};

__device__ __forceinline__ Terms child(float d, float v) {
  const bool ok = v > 0.f;
  const float ivar = ok ? 1.f / v : 0.f;
  const float inv_d = ok ? 1.f / (fabsf(d) > 1e-12f ? d : 1e-12f) : 0.f;
  return {ivar, ivar * inv_d, ok ? 1.f : 0.f};
}

// a row of a 2x2: its left child's terms plus its right one's
__device__ __forceinline__ Terms pair(const Terms& l, const Terms& r) {
  return {l.ivar + r.ivar, l.idepth + r.idepth, l.n + r.n};
}

__device__ __forceinline__ Terms shfl_xor(const Terms& t, int mask) {
  return {__shfl_xor_sync(kAll, t.ivar, mask),
          __shfl_xor_sync(kAll, t.idepth, mask),
          __shfl_xor_sync(kAll, t.n, mask)};
}

// a cell from its top row's sums and its bottom row's
__device__ __forceinline__ void fuse(const Terms& top, const Terms& bottom,
                                     float* d, float* v) {
  const float ivar_sum = top.ivar + bottom.ivar;
  const float idepth_sum = top.idepth + bottom.idepth;
  const float num = top.n + bottom.n;
  const bool any = num > 0.f;
  *d = any ? ivar_sum / idepth_sum : 0.f;
  *v = any ? num / ivar_sum : -1.f;
}

__global__ void __launch_bounds__(kThreads) depth_refresh(const RefreshArgs a) {
  // lane (r, c) of warp w holds row r, columns 4c..4c+3 of the warp's
  // 4x32 pixels; the warps of a block's tile stand in pairs, one above
  // the other, for level 3
  __shared__ Terms below[kTileH / (2 * kWarpH)][kWarpsX][kWarpW / 4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 3, c = lane & 7;
  const int wy = warp / kWarpsX, wx = warp % kWarpsX;
  const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x % a.tiles_x;
  const int H = a.H, W = a.W;
  const int y = ty * kTileH + wy * kWarpH + r;
  const int x = tx * kTileW + wx * kWarpW + 4 * c;   // the first pixel
  const size_t b = blockIdx.y;
  const size_t i = b * H * W + (size_t)y * W + x;
  const bool row = y < H;
  // level 0: every load first
  uint8_t f[4] = {0, 0, 0, 0};
  float ids[4] = {0.f, 0.f, 0.f, 0.f}, vs[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.vec) {
    if (row && x < W) {
      const uchar4 f4 = *reinterpret_cast<const uchar4*>(a.valid + i);
      const float4 i4 = *reinterpret_cast<const float4*>(a.idepth_s + i);
      const float4 v4 = *reinterpret_cast<const float4*>(a.var_s + i);
      f[0] = f4.x; f[1] = f4.y; f[2] = f4.z; f[3] = f4.w;
      ids[0] = i4.x; ids[1] = i4.y; ids[2] = i4.z; ids[3] = i4.w;
      vs[0] = v4.x; vs[1] = v4.y; vs[2] = v4.z; vs[3] = v4.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (row && x + k < W) {
        f[k] = a.valid[i + k];
        ids[k] = a.idepth_s[i + k];
        vs[k] = a.var_s[i + k];
      }
  }
  float d0[4], v0[4];
  uint8_t ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool inside = y >= a.border && y < H - a.border
                        && x + k >= a.border && x + k < W - a.border;
    const bool valid = f[k] != 0 && inside;
    const bool usable = valid && ids[k] >= -0.05f;
    const float denom = fabsf(ids[k]) > 1e-12f ? ids[k] : 1e-12f;
    d0[k] = usable ? 1.f / denom : 0.f;
    v0[k] = usable ? vs[k] : -1.f;
    ok[k] = valid ? 1 : 0;
  }
  if (a.vec) {
    if (row && x < W) {
      *reinterpret_cast<uchar4*>(a.valid_out + i) =
          make_uchar4(ok[0], ok[1], ok[2], ok[3]);
      *reinterpret_cast<float4*>(a.depth[0] + i) =
          make_float4(d0[0], d0[1], d0[2], d0[3]);
      *reinterpret_cast<float4*>(a.var[0] + i) =
          make_float4(v0[0], v0[1], v0[2], v0[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (row && x + k < W) {
        a.valid_out[i + k] = ok[k];
        a.depth[0][i + k] = d0[k];
        a.var[0][i + k] = v0[k];
      }
  }
  if (a.levels < 2) return;
  // level 1: cells (y / 2, x / 2 + j), j = 0, 1; the lower row's pairs
  // from lane ^ 8
  const int H1 = H / 2, W1 = W / 2;
  float d1[2], v1[2];
  const bool top1 = (r & 1) == 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const Terms mine = pair(child(d0[2 * j], v0[2 * j]),
                            child(d0[2 * j + 1], v0[2 * j + 1]));
    const Terms other = shfl_xor(mine, 8);
    fuse(top1 ? mine : other, top1 ? other : mine, &d1[j], &v1[j]);
    const int Y = y >> 1, X = (x >> 1) + j;
    if (top1 && Y < H1 && X < W1) {
      const size_t o = b * H1 * W1 + (size_t)Y * W1 + X;
      a.depth[1][o] = d1[j];
      a.var[1][o] = v1[j];
    }
  }
  if (a.levels < 3) return;
  // level 2: cell (y / 4, x / 4), its two upper children in this thread,
  // the lower ones in lane ^ 16
  const int H2 = H1 / 2, W2 = W1 / 2;
  float d2, v2;
  {
    const Terms mine = pair(child(d1[0], v1[0]), child(d1[1], v1[1]));
    const Terms other = shfl_xor(mine, 16);
    const bool top2 = (r & 2) == 0;
    fuse(top2 ? mine : other, top2 ? other : mine, &d2, &v2);
    const int Y = y >> 2, X = x >> 2;
    if (r == 0 && Y < H2 && X < W2) {
      const size_t o = b * H2 * W2 + (size_t)Y * W2 + X;
      a.depth[2][o] = d2;
      a.var[2][o] = v2;
    }
  }
  if (a.levels < 4) return;
  // level 3: cell (y / 8, x / 8), its upper children in lanes c and c ^ 1
  // of the upper warp of a pair, its lower ones in the lower warp's, whose
  // row sums come through shared memory: one barrier
  const int H3 = H2 / 2, W3 = W2 / 2;
  const Terms t = child(d2, v2);
  const Terms beside = shfl_xor(t, 1);
  const bool left = (c & 1) == 0;
  const Terms mine = left ? pair(t, beside) : pair(beside, t);
  if ((wy & 1) == 1 && r == 0) below[wy >> 1][wx][c] = mine;
  __syncthreads();
  const int Y = y >> 3, X = x >> 3;
  if ((wy & 1) == 0 && r == 0 && left && Y < H3 && X < W3) {
    float d3, v3;
    fuse(mine, below[wy >> 1][wx][c], &d3, &v3);
    const size_t o = b * H3 * W3 + (size_t)Y * W3 + X;
    a.depth[3][o] = d3;
    a.var[3][o] = v3;
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
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const int vec = W % 4 == 0 && aligned(valid, 4) && aligned(valid_out, 4)
                  && aligned(idepth_s, 16) && aligned(var_s, 16)
                  && aligned(depth[0], 16) && aligned(var[0], 16);
  RefreshArgs a{valid, idepth_s, var_s, valid_out, {}, {}, H, W, levels,
                border, tiles_x, vec};
  for (int l = 0; l < levels; ++l) {
    a.depth[l] = depth[l];
    a.var[l] = var[l];
  }
  const dim3 grid(tiles_x * ((H + kTileH - 1) / kTileH), B);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  depth_refresh<<<grid, dim3(kThreads), 0, stream_>>>(a);
  return (int)cudaGetLastError();
}
