// The image pyramid, its gradients and the dilated max-gradient map for
// NVIDIA Hopper (sm_90a): one launch a pyramid level.
//
// Replaces image/pyramid.py::build_pyramid, ::gradients and
// ::max_abs_gradient on CUDA tensors (the JAX package's
// image/pyramid.py:52, :60 and :78; frame::constructImagePyramids,
// calculateGradient and buildMaxGradients, src/Frame.cpp:170-285,
// 618-674), which plain PyTorch runs as ~100 ATen kernels a frame (the
// blur's shifted slices and concatenations, the gradients' and the
// dilation's), each a µs-scale launch over one 270x480 plane or less.
//
//   pyramid_level (a thread a pixel of level l, blockIdx.y the image of
//     a batch): the pixel's gradients (central differences, one-sided
//     without the 0.5 at the first and last row and column), optionally
//     the dilated max-gradient map (the 3x3 max of the magnitude inside,
//     the magnitude itself on the border), and, at an even row and
//     column inside the floor-halved shape, level l + 1's pixel: the
//     [1 4 6 4 1]/16 blur, rows then columns, replicating level l's own
//     border, taken at (2y, 2x).  Any of the three outputs may be left
//     out (a null pointer).
//     Given gradient planes in place of an image, it writes the
//     max-gradient map alone (pyramid.py max_abs_gradient).
//
// The arithmetic is image/pyramid.py's, operation by operation: the five
// products of each blur pass summed left to right as _sep_blur5 writes
// them, 0.5 * (a - b), sqrtf(gx * gx + gy * gy) (the twin takes that
// square root in float64 and rounds once, the correctly rounded value of
// sqrtf), every product rounded apart (-fmad=false); the maxima keep a
// NaN, as torch.maximum does.  So the kernel is bit-equal to its twin.
//
// What bounds it.  Each level's image read once and its gradients (and
// the next level, and at level 0 the max-gradient map) written once:
// about 2.1 MB for a 270x480 frame's four levels with gradients and map
// (0.6 us at 3.35 TB/s); ~60 float32 operations a pixel.  A thread
// re-reads its neighbours (25 for a blurred pixel, 20 for the map) from
// L1; at this size the four launches' latency is most of the time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

}  // namespace

// outside the anonymous namespace: a struct in the signature of the
// extern "C" entry point would keep nvcc from exporting it
struct PyramidArgs {
  const float* src;    // level l, (B, H, W); or gx for pyramid_maxgrad
  const float* src_y;  // gy for pyramid_maxgrad
  float* dst;          // level l + 1, (B, H / 2, W / 2), or null
  float* gx;           // (B, H, W), or null
  float* gy;
  float* maxgrad;      // (B, H, W), or null
  int H, W;
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

// central differences, one-sided without the 0.5 on the borders
// (pyramid.py gradients); H, W >= 2
__device__ __forceinline__ void grad_at(const float* __restrict__ img,
                                        int H, int W, int y, int x,
                                        float* gx, float* gy) {
  const float* row = img + (size_t)y * W;
  *gx = x == 0 ? row[1] - row[0]
      : (x == W - 1 ? row[W - 1] - row[W - 2]
                    : 0.5f * (row[x + 1] - row[x - 1]));
  *gy = y == 0 ? img[W + x] - img[x]
      : (y == H - 1 ? img[(size_t)(H - 1) * W + x] - img[(size_t)(H - 2) * W + x]
                    : 0.5f * (img[(size_t)(y + 1) * W + x]
                              - img[(size_t)(y - 1) * W + x]));
}

__device__ __forceinline__ float magnitude(float gx, float gy) {
  return sqrtf(gx * gx + gy * gy);
}

// the dilated max-gradient map at (y, x) from given gradient planes
__device__ __forceinline__ float maxgrad_of(const float* __restrict__ gx,
                                           const float* __restrict__ gy,
                                           int H, int W, int y, int x) {
  const int i = y * W + x;
  if (y == 0 || y == H - 1 || x == 0 || x == W - 1)
    return magnitude(gx[i], gy[i]);
  float m = 0.f;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx) {
      const int j = i + dy * W + dx;
      const float v = magnitude(gx[j], gy[j]);
      m = (dy == -1 && dx == -1) ? v : max_nan2(m, v);
    }
  return m;
}

__global__ void __launch_bounds__(kThreads) pyramid_level(const PyramidArgs p) {
  const int H = p.H, W = p.W;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= H * W) return;
  const int y = i / W, x = i % W;
  const size_t plane = (size_t)blockIdx.y * H * W;
  if (p.src_y != nullptr) {       // the map alone, from gradient planes
    p.maxgrad[plane + i] = maxgrad_of(p.src + plane, p.src_y + plane, H, W,
                                      y, x);
    return;
  }
  const float* __restrict__ img = p.src + plane;
  if (p.gx != nullptr) {
    float gx, gy;
    grad_at(img, H, W, y, x, &gx, &gy);
    p.gx[plane + i] = gx;
    p.gy[plane + i] = gy;
  }
  if (p.maxgrad != nullptr) {
    float m;
    if (y == 0 || y == H - 1 || x == 0 || x == W - 1) {
      float gx, gy;
      grad_at(img, H, W, y, x, &gx, &gy);
      m = magnitude(gx, gy);
    } else {
      m = 0.f;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          float gx, gy;
          grad_at(img, H, W, y + dy, x + dx, &gx, &gy);
          const float v = magnitude(gx, gy);
          m = (dy == -1 && dx == -1) ? v : max_nan2(m, v);
        }
    }
    p.maxgrad[plane + i] = m;
  }
  const int H2 = H / 2, W2 = W / 2;
  if (p.dst != nullptr && (y & 1) == 0 && (x & 1) == 0 && y / 2 < H2
      && x / 2 < W2) {
    // rows first (the vertical pass over the five columns this pixel's
    // horizontal pass reads), then the columns
    float v[5];
    for (int j = 0; j < 5; ++j) {
      const int c = clampi(x + j - 2, 0, W - 1);
      float s = g5(0) * img[(size_t)clampi(y - 2, 0, H - 1) * W + c];
      for (int k = 1; k < 5; ++k)
        s = s + g5(k) * img[(size_t)clampi(y + k - 2, 0, H - 1) * W + c];
      v[j] = s;
    }
    float s = g5(0) * v[0];
    for (int j = 1; j < 5; ++j) s = s + g5(j) * v[j];
    p.dst[(size_t)blockIdx.y * H2 * W2 + (size_t)(y / 2) * W2 + x / 2] = s;
  }
}

}  // namespace

// One pyramid level of B images (H, W) on ``stream``: dst (level l + 1),
// gx and gy, and maxgrad, each null to leave it out.  Returns the
// launch's cudaError (0 when it was queued).
extern "C" int ellc_pyramid_level(const float* src, float* dst, float* gx,
                                  float* gy, float* maxgrad, int B, int H,
                                  int W, void* stream) {
  if (B <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const PyramidArgs p{src, nullptr, dst, gx, gy, maxgrad, H, W};
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  pyramid_level<<<grid, dim3(kThreads), 0, stream_>>>(p);
  return (int)cudaGetLastError();
}

// The max-gradient map of B gradient planes (H, W) on ``stream``.
extern "C" int ellc_pyramid_maxgrad(const float* gx, const float* gy,
                                    float* maxgrad, int B, int H, int W,
                                    void* stream) {
  if (B <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const PyramidArgs p{gx, gy, nullptr, nullptr, nullptr, maxgrad, H, W};
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  pyramid_level<<<grid, dim3(kThreads), 0, stream_>>>(p);
  return (int)cudaGetLastError();
}
