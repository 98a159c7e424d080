// The image pyramid, its gradients and the dilated max-gradient map for
// NVIDIA Hopper (sm_90a): a frame's whole pyramid in one launch.
//
// Replaces image/pyramid.py::build_pyramid, ::gradients and
// ::max_abs_gradient on CUDA tensors (the JAX package's
// image/pyramid.py:52, :60 and :78; frame::constructImagePyramids,
// calculateGradient and buildMaxGradients, src/Frame.cpp:170-285,
// 618-674), which plain PyTorch runs as ~100 ATen kernels a frame (the
// blur's shifted slices and concatenations, the gradients' and the
// dilation's), each a µs-scale launch over one 270x480 plane or less.
//
//   pyramid_level (a block a tile, blockIdx.y the image of a batch): up
//     to kMaxLevels levels of one image.  A block owns a kTileH x kTileW
//     tile of level 0 and, at level l, the (kTileH >> l) x (kTileW >> l)
//     cells above it.  It loads its level-0 region with a halo into shared
//     memory (each cell clamped into the image: the blur's edge
//     replication), then, level by level, writes this level's cells of its
//     tile with their gradients (central differences, one-sided without
//     the 0.5 at the first and last row and column) and computes the next
//     level's region from this one's (the [1 4 6 4 1]/16 blur, rows then
//     columns, taken at (2y, 2x)), all from shared memory; at level 0,
//     when asked, it writes the dilated max-gradient map (the 3x3 max of
//     the magnitude inside, the magnitude itself on the border).  It
//     writes only the cells it owns.  Any output may be left out (a null
//     pointer).  Given gradient planes in place of an image, it writes the
//     max-gradient map alone (pyramid.py max_abs_gradient).
//
// Halos are recomputed, not exchanged.  Level l + 1's cells [a, b) need
// level l's [2a - 2, 2b] and the gradients need a cell on each side, so a
// region d levels below the last reaches 3 * 2^d - 2 cells before its tile
// and 2^(d + 1) - 1 after it (for 32x48 tiles: 69x85, 33x41, 15x19 and
// 6x8 cells, 47 KB of shared memory with the blur's vertical pass and the
// map's magnitudes).  A halo cell outside its level holds the level's
// clamped neighbour, so each level's own floor shape (270 -> 135 -> 67 ->
// 33 rows) sets its edge, never the tile's.  Every cell is the same
// expression of level-0 values in every block that computes it, so
// recomputed halos carry the same bits and blocks never wait on one
// another.  A thread loads a column of the level-0 region (all its loads
// issued before its first store).  Level 1 is blurred in two passes, a
// thread a column (the vertical pass) or a row (the horizontal one) along
// a run of outputs, the five taps slid two cells a step, so a blurred cell
// reads two values from shared memory, not five; levels 2 and 3, a few
// hundred cells, each cell's 25 taps at once.  Five barriers in all.
//
// The arithmetic is image/pyramid.py's, operation by operation: the five
// products of each blur pass summed left to right as _sep_blur5 writes
// them, 0.5 * (a - b), sqrtf(gx * gx + gy * gy) (the twin takes that
// square root in float64 and rounds once, the correctly rounded value of
// sqrtf), every product rounded apart (-fmad=false); the maxima keep a
// NaN, as torch.maximum does.  So the kernel is bit-equal to its twin.
//
// What bounds it.  The level-0 image read once and every level's
// gradients (and levels 1-3, and the max-gradient map) written once:
// about 2.1 MB for a 270x480 frame with gradients and map (0.6 us at 3.35
// TB/s); ~60 float32 operations a pixel.  The four levels were four
// dependent launches; they are one.  At one video the 90 blocks' serial
// chain (the region's loads, then five barrier-separated passes) sets the
// time; with many images the recomputed halos' work does (3.8 times the
// tile's level-0 pixels loaded from L2, 3.5 times its level-1 cells
// blurred).  32x48 tiles of 512 threads were the fastest at one video of
// those timed (tools/time_k4.py: 16x16 to 64x64, 256 to 1024 threads) and
// no slower than four launches at 8 videos or 20 images.

#include <cuda_runtime.h>

#ifndef ELLC_PYR_TILE_H
#define ELLC_PYR_TILE_H 32
#endif
#ifndef ELLC_PYR_TILE_W
#define ELLC_PYR_TILE_W 48
#endif
#ifndef ELLC_PYR_THREADS
#define ELLC_PYR_THREADS 512
#endif

namespace {

constexpr int kThreads = ELLC_PYR_THREADS;
constexpr int kMaxLevels = 4;
// level-0 pixels of a block's tile; the tile at level kMaxLevels - 1
// keeps at least one cell a side
constexpr int kTileH = ELLC_PYR_TILE_H, kTileW = ELLC_PYR_TILE_W;
static_assert(kTileH % (1 << (kMaxLevels - 1)) == 0
              && kTileW % (1 << (kMaxLevels - 1)) == 0,
              "a tile has whole cells at every level");

// Level l's region, fixed for every launch (a launch of fewer levels
// computes a halo wider than it needs): the tile at level l and the cells
// before and after it that the levels above reach, d = kMaxLevels - 1 - l
// levels below the last, 3 * 2^d - 2 and 2^(d + 1) - 1 (at least the 2
// that level 0's map needs).
__host__ __device__ constexpr int halo_before(int l) {
  return 3 * ((1 << (kMaxLevels - 1)) >> l) - 2;
}
__host__ __device__ constexpr int halo_after(int l) {
  return 2 * ((1 << (kMaxLevels - 1)) >> l) - 1;
}
static_assert(halo_before(0) >= 2 && halo_after(0) >= 2,
              "level 0's region holds the map's halo");
__host__ __device__ constexpr int region_h(int l) {
  return (kTileH >> l) + halo_before(l) + halo_after(l);
}
__host__ __device__ constexpr int region_w(int l) {
  return (kTileW >> l) + halo_before(l) + halo_after(l);
}
// where level l's region starts in shared memory; after the regions, the
// blur's vertical pass (level l + 1's rows of level l's columns) and the
// magnitudes of the max-gradient map (the tile and a cell on each side)
__host__ __device__ constexpr int region_at(int l) {
  return l == 0 ? 0 : region_at(l - 1) + region_h(l - 1) * region_w(l - 1);
}
constexpr int kPassAt = region_at(kMaxLevels);
constexpr int kMagAt = kPassAt + region_h(1) * region_w(0);
constexpr int kMagW = kTileW + 2;
constexpr int kSmemBytes = (kMagAt + (kTileH + 2) * kMagW) * 4;
// a thread a column of a region or a row of its blur's vertical pass
static_assert(kThreads >= region_w(0) && kThreads >= region_h(0),
              "a block has a thread for each column and row of level 0");

}  // namespace

// outside the anonymous namespace: a struct in the signature of the
// extern "C" entry point would keep nvcc from exporting it
struct PyramidArgs {
  const float* src;              // level 0, (B, H, W); or gx for the map
  const float* src_y;            // gy for the map alone, else null
  float* img[kMaxLevels];        // level l >= 1, (B, H_l, W_l), or null
  float* gx[kMaxLevels];         // level l's gradients, or null
  float* gy[kMaxLevels];
  float* maxgrad;                // level 0's map, (B, H, W), or null
  int H, W, levels, tiles_x;
};

namespace {

// the blur's taps, [1 4 6 4 1] / 16 (pyramid.py _G5), all exact in float
__device__ __forceinline__ float g5(int k) {
  return (k == 0 || k == 4) ? 0.0625f : ((k == 1 || k == 3) ? 0.25f : 0.375f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the larger of two values, NaN if either is (torch.maximum)
__device__ __forceinline__ float max_nan2(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float magnitude(float gx, float gy) {
  return sqrtf(gx * gx + gy * gy);
}

// the five taps of a blur pass, summed left to right (_sep_blur5)
__device__ __forceinline__ float blur5(float t0, float t1, float t2,
                                       float t3, float t4) {
  return (((g5(0) * t0 + g5(1) * t1) + g5(2) * t2) + g5(3) * t3)
         + g5(4) * t4;
}

// central differences at cell p of a region (row stride s) of a level
// (H, W), one-sided without the 0.5 on the level's borders
// (pyramid.py gradients); H, W >= 2
__device__ __forceinline__ void grad_at(const float* p, int s, int H, int W,
                                        int y, int x, float* gx, float* gy) {
  *gx = x == 0 ? p[1] - p[0]
      : (x == W - 1 ? p[0] - p[-1] : 0.5f * (p[1] - p[-1]));
  *gy = y == 0 ? p[s] - p[0]
      : (y == H - 1 ? p[0] - p[-s] : 0.5f * (p[s] - p[-s]));
}

// the max-gradient map of the block's tile of level 0 (H, W) from the
// magnitudes at the tile and a cell around it (mag, where the level has
// the cell)
__device__ __forceinline__ void write_map(const float* mag, float* out,
                                          int H, int W, int ay, int ax) {
  for (int k = threadIdx.x; k < kTileH * kTileW; k += kThreads) {
    const int y = ay + k / kTileW, x = ax + k % kTileW;
    if (y >= H || x >= W) continue;
    const float* m = mag + (y - ay + 1) * kMagW + (x - ax + 1);
    float v = m[0];
    if (y > 0 && y < H - 1 && x > 0 && x < W - 1) {
      v = m[-kMagW - 1];
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx)
          if (dy != -1 || dx != -1) v = max_nan2(v, m[dy * kMagW + dx]);
    }
    out[(size_t)y * W + x] = v;
  }
}

__global__ void __launch_bounds__(kThreads) pyramid_level(const PyramidArgs p) {
  extern __shared__ float smem[];
  float* const pass = smem + kPassAt;
  float* const mag = smem + kMagAt;
  const int ty = blockIdx.x / p.tiles_x, tx = blockIdx.x % p.tiles_x;
  const int H = p.H, W = p.W, n = p.levels;
  const size_t plane = (size_t)blockIdx.y * H * W;
  const int ay = ty * kTileH, ax = tx * kTileW;
  const bool map = p.maxgrad != nullptr;
  if (p.src_y != nullptr) {       // the map alone, from gradient planes
    for (int k = threadIdx.x; k < (kTileH + 2) * kMagW; k += kThreads) {
      const int y = ay - 1 + k / kMagW, x = ax - 1 + k % kMagW;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const size_t i = plane + (size_t)y * W + x;
        mag[k] = magnitude(p.src[i], p.src_y[i]);
      }
    }
    __syncthreads();
    write_map(mag, p.maxgrad + plane, H, W, ay, ax);
    return;
  }
  // level 0's region from the image, each cell clamped into it: a thread
  // a column and every kG0-th row, all of its loads issued before the
  // first store
  {
    constexpr int S = region_w(0), R = region_h(0);
    constexpr int G = kThreads / S, rows = (R + G - 1) / G;
    const int c = threadIdx.x % S, g = threadIdx.x / S;
    if (g < G) {
      const float* __restrict__ col =
          p.src + plane + clampi(ax - halo_before(0) + c, 0, W - 1);
      const int y0 = ay - halo_before(0);
      float v[rows];
#pragma unroll
      for (int j = 0; j < rows; ++j) {
        const int r = g + j * G;
        if (r < R) v[j] = col[(size_t)clampi(y0 + r, 0, H - 1) * W];
      }
#pragma unroll
      for (int j = 0; j < rows; ++j) {
        const int r = g + j * G;
        if (r < R) smem[r * S + c] = v[j];
      }
    }
  }
  __syncthreads();
  int Hl = H, Wl = W;
  // a level a pass, unrolled so that p.img[l], p.gx[l] and p.gy[l] are
  // read at constant indices (no copy of the arguments to the stack) and
  // every region's shape is a constant
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= n) break;
    const float* cur = smem + region_at(l);
    const int S = region_w(l);                    // the region's row stride
    const int th = kTileH >> l, tw = kTileW >> l;
    const int oy = ty * th, ox = tx * tw;
    const int ry = oy - halo_before(l), rx = ox - halo_before(l);
    // level l + 1: its shape, its tile and whether the block owns a cell
    // there (if not, none above it either)
    const bool next = l + 1 < kMaxLevels && l + 1 < n;
    const int H1 = Hl / 2, W1 = Wl / 2;
    const int S1 = region_w(l + 1), R1 = region_h(l + 1);
    const int oy1 = ty * (th >> 1), ox1 = tx * (tw >> 1);
    const int ry1 = oy1 - halo_before(l + 1), rx1 = ox1 - halo_before(l + 1);
    const bool have1 = next && oy1 < H1 && ox1 < W1;
    // this level's cells of the block: the image (levels 1 and up) and
    // the gradients; level 0's after the vertical pass, beside the
    // horizontal one
    const auto write_cells = [&]() {
      float* const img = l == 0 ? nullptr : p.img[l];
      if ((img == nullptr && p.gx[l] == nullptr) || oy >= Hl || ox >= Wl)
        return;
      const size_t lplane = (size_t)blockIdx.y * Hl * Wl;
      for (int k = threadIdx.x; k < th * tw; k += kThreads) {
        const int y = oy + k / tw, x = ox + k % tw;
        if (y >= Hl || x >= Wl) continue;
        const float* c = cur + (y - ry) * S + (x - rx);
        const size_t i = lplane + (size_t)y * Wl + x;
        if (img != nullptr) img[i] = c[0];
        if (p.gx[l] != nullptr) {
          float gx, gy;
          grad_at(c, S, Hl, Wl, y, x, &gx, &gy);
          p.gx[l][i] = gx;
          p.gy[l][i] = gy;
        }
      }
    };
    if (l > 0) write_cells();
    // level 0's magnitudes at the tile and a cell around it
    if (l == 0 && map) {
      for (int k = threadIdx.x; k < (kTileH + 2) * kMagW; k += kThreads) {
        const int y = ay - 1 + k / kMagW, x = ax - 1 + k % kMagW;
        if (y < 0 || y >= H || x < 0 || x >= W) continue;
        float gx, gy;
        grad_at(cur + (y - ry) * S + (x - rx), S, H, W, y, x, &gx, &gy);
        mag[k] = magnitude(gx, gy);
      }
    }
    // above level 1 the next region is small: each cell's blur at once,
    // the five columns' vertical sums, then across them
    if (have1 && l > 0) {
      float* nxt = smem + region_at(l + 1);
      for (int k = threadIdx.x; k < R1 * S1; k += kThreads) {
        const int yc = clampi(ry1 + k / S1, 0, H1 - 1);
        const int xc = clampi(rx1 + k % S1, 0, W1 - 1);
        const float* t = cur + (2 * yc - 2 - ry) * S + (2 * xc - 2 - rx);
        float v[5];
#pragma unroll
        for (int j = 0; j < 5; ++j)
          v[j] = blur5(t[j], t[S + j], t[2 * S + j], t[3 * S + j],
                       t[4 * S + j]);
        nxt[k] = blur5(v[0], v[1], v[2], v[3], v[4]);
      }
    }
    // level 1 from level 0 in two passes.  The vertical pass at level 1's
    // rows (clamped into it): rows 2y - 2 .. 2y + 2 of each column of this
    // region, a thread a column and a run of rows, its five taps slid down
    // two rows at a time
    if (have1 && l == 0) {
      const int G = kThreads / S, run = (R1 + G - 1) / G;
      const int c = threadIdx.x % S, g = threadIdx.x / S;
      const float* col = cur + c;
      const int end = min(R1, (g + 1) * run);
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f, t4 = 0.f;
      int last = -8;
      for (int r = g * run; g < G && r < end; ++r) {
        const int top = 2 * clampi(ry1 + r, 0, H1 - 1) - 2 - ry;
        if (top == last + 2) {
          t0 = t2; t1 = t3; t2 = t4;
          t3 = col[(top + 3) * S];
          t4 = col[(top + 4) * S];
        } else if (top != last) {
          t0 = col[top * S]; t1 = col[(top + 1) * S];
          t2 = col[(top + 2) * S]; t3 = col[(top + 3) * S];
          t4 = col[(top + 4) * S];
        }
        last = top;
        pass[r * S + c] = blur5(t0, t1, t2, t3, t4);
      }
    }
    if (l == 0) {
      __syncthreads();
      write_cells();
      if (map) write_map(mag, p.maxgrad + plane, H, W, ay, ax);
    }
    // the horizontal pass: level 1's region at its columns (clamped into
    // it), a halo cell the value of its clamped neighbour; a thread a row
    // and a run of columns
    if (have1 && l == 0) {
      float* nxt = smem + region_at(l + 1);
      const int G = kThreads / R1, run = (S1 + G - 1) / G;
      const int r = threadIdx.x % R1, g = threadIdx.x / R1;
      const float* row = pass + r * S;
      const int end = min(S1, (g + 1) * run);
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f, t4 = 0.f;
      int last = -8;
      for (int c = g * run; g < G && c < end; ++c) {
        const int left = 2 * clampi(rx1 + c, 0, W1 - 1) - 2 - rx;
        if (left == last + 2) {
          t0 = t2; t1 = t3; t2 = t4;
          t3 = row[left + 3];
          t4 = row[left + 4];
        } else if (left != last) {
          t0 = row[left]; t1 = row[left + 1]; t2 = row[left + 2];
          t3 = row[left + 3]; t4 = row[left + 4];
        }
        last = left;
        nxt[r * S1 + c] = blur5(t0, t1, t2, t3, t4);
      }
    }
    if (next) __syncthreads();
    Hl = H1;
    Wl = W1;
  }
}

}  // namespace

// The pyramid of B images (H, W) on ``stream``, ``levels`` (1 to
// kMaxLevels) levels in one launch: img[l] (level l >= 1; img[0] is not
// read), gx[l] and gy[l] (level l's gradients), and maxgrad (level 0's
// map), each null to leave it out.  Returns the launch's cudaError (0
// when it was queued).
extern "C" int ellc_pyramid_levels(const float* src, float* const* img,
                                   float* const* gx, float* const* gy,
                                   float* maxgrad, int B, int H, int W,
                                   int levels, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || levels < 1 || levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  PyramidArgs p{src, nullptr, {}, {}, {}, maxgrad, H, W, levels, tiles_x};
  for (int l = 0; l < levels; ++l) {
    p.img[l] = l == 0 ? nullptr : img[l];
    p.gx[l] = gx[l];
    p.gy[l] = gy[l];
  }
  const dim3 grid(tiles_x * ((H + kTileH - 1) / kTileH), B);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  cudaFuncSetAttribute(pyramid_level,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  pyramid_level<<<grid, dim3(kThreads), kSmemBytes, stream_>>>(p);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a block, bytes.
extern "C" int ellc_pyramid_smem_bytes() { return kSmemBytes; }

// The max-gradient map of B gradient planes (H, W) on ``stream``.
extern "C" int ellc_pyramid_maxgrad(const float* gx, const float* gy,
                                    float* maxgrad, int B, int H, int W,
                                    void* stream) {
  if (B <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const PyramidArgs p{gx, gy, {}, {}, {}, maxgrad, H, W, 1, tiles_x};
  const dim3 grid(tiles_x * ((H + kTileH - 1) / kTileH), B);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  cudaFuncSetAttribute(pyramid_level,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  pyramid_level<<<grid, dim3(kThreads), kSmemBytes, stream_>>>(p);
  return (int)cudaGetLastError();
}
