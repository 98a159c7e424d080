// The candidate merge of keyframe depth propagation for NVIDIA Hopper
// (sm_90a), summed in a fixed order.
//
// Replaces the merge half of depth/propagate.py::propagate (the JAX
// package's depth/propagate.py:100-135, DepthPropagation.cpp:1090-1157):
// every source pixel that survives the reprojection gates is a candidate
// for one target cell of the new keyframe (flat target b*H*W + ty*W + tx,
// so a batch of B states merges into B separate grids).  Per target cell:
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
// The order is the point of this kernel.  The plain twin
// (ops/propagate_kernel.py::plain_merge) and the CPU's sequential
// index_add_, which the JAX package's CPU scatter also matches, add the
// candidates of a cell in ascending source index; a float atomicAdd (what
// index_add_ does on CUDA) adds them in whatever order the threads come,
// so two runs differed in the last bits and, through tracking, in their
// trajectories.  Non-candidates and incompatible candidates add +0.0 in
// the twin; a sum that starts at +0.0 never becomes -0.0, so skipping
// them gives the same bits.  The max and the winner's variance do not
// depend on the order.
//
//   propagate_link (a thread a source): each candidate pushes its index
//     onto its target's list, next[s] = atomicExch(&head[t], s) (head set
//     to -1 by a memset first).  The lists come out in any order.
//   propagate_merge (a thread a target): one walk of its list finds the
//     winner and its variance; then walks that each select the kChunk
//     smallest compatible source indices above the last one summed
//     (insertion into a sorted array in local memory) and add them in
//     that order.  A list of at most kChunk compatible candidates, every
//     cell but those of a strong zoom-out, takes two walks; a longer one
//     takes one walk more for each kChunk (the cost grows as L^2 / kChunk,
//     still in ascending order).
//
// Both passes run on fixed grids with no host read, so a CUDA graph
// captures the memset and the two launches.  Built with -fmad=false, so
// diff_fac * diff * diff and the quotients round as the twin's separate
// ATen kernels do; the divisions are IEEE (no fast math).
//
// What bounds it.  Each byte the merge needs read once and each output
// byte written once: every source's candidate flag (1 B) and every
// target's seven planes (25 B), and only a candidate's target (int64),
// inverse depth, variance and validity (20 B), since nothing else of a
// source that is not a candidate is read: 3.46 MB for one state at
// 270x480 with its 4,633 candidates (1.03 us at 3.35 TB/s); the float
// work (~15 operations a candidate) is far below the card's rate.  The kernel reads the lists' links and
// gathers its candidates' values at random, at least two dependent loads
// a candidate and a walk.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

}  // namespace

// outside the anonymous namespace: a struct in the signature of the
// extern "C" entry point would keep nvcc from exporting it
struct MergeArgs {
  const int64_t* tgt;
  const uint8_t* cand;
  const float* idepth;
  const float* var;
  const float* validity;
  int32_t* head;
  int32_t* next;
  float* out_idepth;
  float* out_var;
  float* out_idepth_smoothed;
  float* out_var_smoothed;
  float* out_validity;
  int32_t* out_blacklisted;
  uint8_t* out_valid;
  int n;
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

__global__ void __launch_bounds__(kThreads) propagate_link(MergeArgs a) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= a.n || !a.cand[s]) return;
  a.next[s] = atomicExch(&a.head[a.tgt[s]], s);
}

__global__ void __launch_bounds__(kThreads) propagate_merge(MergeArgs a) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.n) return;
  const int first = a.head[t];
  // the winner and its variance: order-free (a candidate's inverse depth
  // is finite: its projection passed the image gates)
  float w = -__int_as_float(0x7f800000), wv = w;
  for (int s = first; s >= 0; s = a.next[s]) {
    const float id = a.idepth[s], v = a.var[s];
    if (id > w) {
      w = id;
      wv = v;
    } else if (id == w) {
      wv = nan_max(wv, v);
    }
  }
  const float w_var = nan_max(0.0f, wv);
  float sum_ivar = 0.0f, sum_id = 0.0f, sum_val = 0.0f, count = 0.0f;
  int prev = -1;
  for (;;) {
    int buf[kChunk];
    int n = 0;
    bool more = false;
    for (int s = first; s >= 0; s = a.next[s]) {
      if (s <= prev) continue;
      const float d = w - a.idepth[s];
      if (!(a.diff_fac * d * d <= a.var[s] + w_var)) continue;
      if (n == kChunk) {
        more = true;
        if (s > buf[kChunk - 1]) continue;
        --n;                                   // drop the largest
      }
      int i = n++;
      for (; i > 0 && buf[i - 1] > s; --i) buf[i] = buf[i - 1];
      buf[i] = s;
    }
    for (int i = 0; i < n; ++i) {
      const int s = buf[i];
      const float v = a.var[s];
      const float ivar = 1.0f / (fabsf(v) > 1e-12f ? v : 1e-12f);
      sum_ivar = sum_ivar + ivar;
      sum_id = sum_id + ivar * a.idepth[s];
      sum_val = sum_val + a.validity[s];
      count = count + 1.0f;
    }
    if (!more) break;
    prev = buf[n - 1];
  }
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

}  // namespace

// The merge of n sources into n target cells (n = B*H*W) on ``stream``:
// head and next are scratch of n int32 each.  Returns the launch's
// cudaError (0 when both kernels were queued).
extern "C" int ellc_propagate_merge(
    const int64_t* tgt, const uint8_t* cand, const float* idepth,
    const float* var, const float* validity, int32_t* head, int32_t* next,
    float* out_idepth, float* out_var, float* out_idepth_smoothed,
    float* out_var_smoothed, float* out_validity, int32_t* out_blacklisted,
    uint8_t* out_valid, int n, float diff_fac, float validity_cap,
    void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const MergeArgs a{tgt, cand, idepth, var, validity, head, next,
                    out_idepth, out_var, out_idepth_smoothed,
                    out_var_smoothed, out_validity, out_blacklisted,
                    out_valid, n, diff_fac, validity_cap};
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  cudaMemsetAsync(head, 0xff, sizeof(int32_t) * (size_t)n, stream_);
  propagate_link<<<grid, dim3(kThreads), 0, stream_>>>(a);
  propagate_merge<<<grid, dim3(kThreads), 0, stream_>>>(a);
  return (int)cudaGetLastError();
}
