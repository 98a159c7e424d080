// The SE(3) compose and relative pose for NVIDIA Hopper (sm_90a): one
// thread a pose.
//
// Replaces geom/lie.py::compose and ::relative on CUDA tensors (the JAX
// package's geom/lie.py:150 and :156, frame::concatenateRelativePose and
// concatenateOriginPose, src/Frame.cpp:503-562):
//
//   compose(a, b)  = log(exp(a) exp(b))
//   relative(a, b) = log(exp(a) exp(b)^-1)
//
// of twists [w, v] (float32, n of them).  Plain PyTorch spends ~270 ATen
// kernels on one such pose (exp, the 4x4 product, the quaternion log, each
// an elementwise kernel of 6 to 16 floats); this kernel is one launch.
//
// The arithmetic is geom/lie.py's, formula by formula, through
// csrc/ellc_device.cuh (exp_se3, log_se3, also used by K1 and K2): every
// product and sum rounded apart (-fmad=false) and in the order lie.py's
// entry-by-entry lie.mm adds them, including the bottom row of the 4x4
// matrices (a translation times the product's 0.0 and 1.0 terms), the
// divisions IEEE, sinf, cosf, atan2f and sqrtf those of ATen's CUDA
// kernels.  lie.py's quaternion norms are torch.linalg.vector_norm, a
// reduction whose order and fused multiply-adds are ATen's; here each norm
// is summed left to right, so the kernel is held to the plain compose on
// the card within a stated bound rather than bit for bit (chip_smoke.py,
// phase 3e).
//
// What bounds it.  48 bytes in and 24 out a pose and ~600 float32
// operations (two exps, a product, a log); at the main path's one to
// twenty poses the launch's latency (a few microseconds) is all of it.

#include <cuda_runtime.h>

#include "ellc_device.cuh"

namespace {

constexpr int kThreads = 128;

}  // namespace

// outside the anonymous namespace: a struct in the signature of the
// extern "C" entry point would keep nvcc from exporting it
struct Se3Args {
  const float* a;      // (n, 6)
  const float* b;      // (n, 6)
  float* out;          // (n, 6)
  int n;
  int invert_b;        // 1: relative (b inverted), 0: compose
};

namespace {

__global__ void __launch_bounds__(kThreads) se3_compose(const Se3Args p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  float xa[6], xb[6];
  for (int k = 0; k < 6; ++k) {
    xa[k] = p.a[i * 6 + k];
    xb[k] = p.b[i * 6 + k];
  }
  float Ra[3][3], ta[3], Rb[3][3], tb[3];
  exp_se3(xa, Ra, ta);
  exp_se3(xb, Rb, tb);
  if (p.invert_b) {
    // lie.py inv_se3_matrix: [R^T | -(R^T t)]
    float Rt[3][3], tt[3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) Rt[r][c] = Rb[c][r];
    for (int r = 0; r < 3; ++r)
      tt[r] = -((Rt[r][0] * tb[0] + Rt[r][1] * tb[1]) + Rt[r][2] * tb[2]);
    for (int r = 0; r < 3; ++r) {
      tb[r] = tt[r];
      for (int c = 0; c < 3; ++c) Rb[r][c] = Rt[r][c];
    }
  }
  // the top three rows of lie.mm(A, B) over the 4x4 matrices: B's bottom
  // row is (0, 0, 0, 1), and A's translation times it is added as lie.mm
  // adds it (t * 0.0 keeps a NaN and the sign of zero)
  float R[3][3], t[3];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c)
      R[r][c] = ((Ra[r][0] * Rb[0][c] + Ra[r][1] * Rb[1][c])
                 + Ra[r][2] * Rb[2][c]) + ta[r] * 0.f;
    t[r] = ((Ra[r][0] * tb[0] + Ra[r][1] * tb[1]) + Ra[r][2] * tb[2])
           + ta[r] * 1.f;
  }
  float xi[6];
  log_se3(R, t, xi);
  for (int k = 0; k < 6; ++k) p.out[i * 6 + k] = xi[k];
}

}  // namespace

// compose (invert_b 0) or relative (invert_b 1) of n pose pairs on
// ``stream``; returns the launch's cudaError (0 when it was queued).
extern "C" int ellc_se3_compose(const float* a, const float* b, float* out,
                                int n, int invert_b, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Se3Args p{a, b, out, n, invert_b};
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  se3_compose<<<grid, dim3(kThreads), 0, stream_>>>(p);
  return (int)cudaGetLastError();
}
