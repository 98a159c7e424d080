"""The port's CUDA sources built for the CPU with g++, for the tests.

A shim header stands in for the CUDA runtime.  A kernel launch becomes
``emu_launch``, which runs the grid's blocks one after another, or, for a
kernel declared with ``__cluster_dims__(X, 1, 1)``, one cluster of X
blocks after another.  Each CUDA thread of the running block (or cluster)
is a fiber on the calling thread (its own stack; on x86-64 a switch of
the callee-saved registers, elsewhere ``ucontext``), and a round-robin
scheduler switches between them only where CUDA threads meet:

- ``__syncthreads`` waits for the block's live threads;
- ``__shfl_xor_sync`` and ``__shfl_down_sync`` exchange one 32-bit value
  (a float or an int) between the 32 threads of a warp, and
  ``__ballot_sync`` gathers their predicates (a returned lane gives 0),
  each lane writing its slot and waiting for the warp's live threads (two
  sets of slots taken in turn, so one wait an exchange suffices);
- ``cooperative_groups::this_cluster()``'s ``sync`` waits for every live
  thread of the cluster, ``block_rank`` is the block's index in it, and
  ``map_shared_rank`` maps an address in the block's dynamic shared
  memory to the same offset in another block's.

A thread that returns leaves every group it belongs to, as an exited CUDA
thread no longer holds a barrier back.  ``__shared__`` variables are
function statics, one copy for all blocks: a cluster kernel keeps its
shared memory in its dynamic buffer (``extern __shared__``), which the
shim gives each block of a cluster.  ``atomicAdd`` on an int is a
``std::atomic_ref``, ``__threadfence`` a sequentially consistent fence,
``__ldcg`` a plain load, ``__popc`` the compiler's builtin, and
``cudaFuncSetAttribute`` does nothing: one OS thread runs all fibers.
``atomicExch`` on an int is a ``std::atomic_ref`` exchange and
``cudaMemsetAsync`` a ``memset``.  The blocks (or clusters) run in the
grid's order, or, built with ``EMU_BLOCK_ORDER=1``, in reverse, or with
``EMU_BLOCK_ORDER=2`` the odd ones first, then the even: a kernel whose
result must not depend on the order in which blocks run is built each way.  The sources'
headers (``csrc/*.cuh``) are copied beside them.  Built with
``-ffp-contract=off``, as nvcc's ``-fmad=false`` keeps every multiply and
add apart.  The grid's z axis is not emulated
(``tests/test_torch_reg_kernel_emulated.py`` builds K3 with its own shim).
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

SHIM = r"""
#pragma once
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <ucontext.h>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct uint3 { unsigned x, y, z; };
// the running fiber's indices, set by the scheduler at every switch
inline uint3 threadIdx, blockIdx;
#if defined(__x86_64__)
// a switch between fibers that saves the callee-saved registers and no
// signal mask: swapcontext's system call would take most of the time of a
// warp exchange, 64 switches
extern "C" void emu_switch(void** save_sp, void* load_sp);
asm(R"(
  .text
  .globl emu_switch
  .hidden emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
)");
#endif
namespace emu {
#if defined(__x86_64__)
struct Ctx { void* sp = nullptr; };
inline void switch_to(Ctx& from, Ctx& to) { emu_switch(&from.sp, to.sp); }
// a new fiber's stack: six zero registers under fn, where the first switch
// to it returns, and a return slot that fn never uses
inline void make(Ctx& c, unsigned char* stack, size_t size, void (*fn)()) {
  void** sp = reinterpret_cast<void**>(
      (reinterpret_cast<uintptr_t>(stack) + size) & ~uintptr_t(15));
  *--sp = nullptr;
  *--sp = reinterpret_cast<void*>(fn);
  for (int i = 0; i < 6; ++i) *--sp = nullptr;
  c.sp = sp;
}
#else
struct Ctx { ucontext_t uc; };
inline void switch_to(Ctx& from, Ctx& to) { swapcontext(&from.uc, &to.uc); }
inline void make(Ctx& c, unsigned char* stack, size_t size, void (*fn)()) {
  getcontext(&c.uc);
  c.uc.uc_stack.ss_sp = stack;
  c.uc.uc_stack.ss_size = size;
  c.uc.uc_link = nullptr;
  makecontext(&c.uc, fn, 0);
}
#endif
struct Group { int expected = 0, arrived = 0; std::vector<int> waiting; };
struct Fiber {
  Ctx ctx;
  uint3 tid, bid;
  int block = 0, warp = 0;
  unsigned shuffles = 0;
  bool waiting = false, done = false;
};
struct Run {
  Ctx sched;
  std::vector<Fiber> fibers;
  std::vector<Group> blocks, warps;
  Group cluster;
  std::vector<std::vector<unsigned char>> smem;  // dynamic, one a block
  std::vector<uint32_t> slots;                   // 2 x 32 a warp
  std::function<void()> body;
  int cur = 0;
};
inline Run* run;
constexpr size_t kStack = 32 << 10;

inline void release(Group& g) {
  for (int i : g.waiting) run->fibers[i].waiting = false;
  g.waiting.clear();
  g.arrived = 0;
}
inline void wait(Group& g) {
  if (++g.arrived == g.expected) { release(g); return; }
  const int me = run->cur;
  g.waiting.push_back(me);
  run->fibers[me].waiting = true;
  switch_to(run->fibers[me].ctx, run->sched);
}
inline void leave(Group& g) {
  if (--g.expected > 0 && g.arrived == g.expected) release(g);
}
inline void start() {
  run->body();
  Fiber& f = run->fibers[run->cur];
  f.done = true;
  leave(run->blocks[f.block]);
  leave(run->warps[f.warp]);
  leave(run->cluster);
  switch_to(f.ctx, run->sched);                 // never resumed
}
// runs blocks [b0, b0 + nb) of row by of the grid together, one fiber a
// thread, until every fiber has returned
inline void blocks_together(unsigned b0, unsigned nb, unsigned by,
                            unsigned threads, size_t smem_bytes) {
  const unsigned warps = (threads + 31) / 32, n = nb * threads;
  run->fibers.assign(n, Fiber());
  run->blocks.assign(nb, Group());
  run->warps.assign(nb * warps, Group());
  run->cluster = Group();
  run->cluster.expected = n;
  run->smem.assign(nb, std::vector<unsigned char>(smem_bytes + 16, 0));
  run->slots.assign(nb * warps * 64, 0);
  std::vector<unsigned char> stacks(n * kStack);
  for (unsigned i = 0; i < n; ++i) {
    Fiber& f = run->fibers[i];
    f.block = i / threads;
    f.warp = f.block * warps + (i % threads) / 32;
    f.tid = {i % threads, 0, 0};
    f.bid = {b0 + f.block, by, 0};
    run->blocks[f.block].expected++;
    run->warps[f.warp].expected++;
    make(f.ctx, stacks.data() + i * kStack, kStack, start);
  }
  for (;;) {
    bool live = false, ran = false;
    for (unsigned i = 0; i < n; ++i) {
      Fiber& f = run->fibers[i];
      if (f.done) continue;
      live = true;
      if (f.waiting) continue;
      run->cur = i;
      threadIdx = f.tid;
      blockIdx = f.bid;
      switch_to(run->sched, f.ctx);
      ran = true;
    }
    if (!live) return;
    if (!ran) { std::fprintf(stderr, "emu: deadlock\n"); std::abort(); }
  }
}
inline uint32_t shuffle(uint32_t v, int src_of_lane(int, int), int arg) {
  Fiber& f = run->fibers[run->cur];
  const int lane = f.tid.x & 31;
  uint32_t* s = &run->slots[(f.warp * 2 + (f.shuffles++ & 1)) * 32];
  s[lane] = v;
  wait(run->warps[f.warp]);
  const int src = src_of_lane(lane, arg);
  return src >= 0 && src < 32 ? s[src] : v;
}
inline int xor_lane(int lane, int m) { return lane ^ m; }
inline int down_lane(int lane, int d) { return lane + d; }
// the warp's predicates as bits, lane i bit i; a lane that has returned
// (or that the block does not have) gives 0
inline uint32_t ballot(bool pred) {
  Fiber& f = run->fibers[run->cur];
  const int lane = f.tid.x & 31, first = run->cur - lane;
  uint32_t* s = &run->slots[(f.warp * 2 + (f.shuffles++ & 1)) * 32];
  s[lane] = pred ? 1u : 0u;
  wait(run->warps[f.warp]);
  uint32_t bits = 0;
  for (int i = 0; i < 32; ++i) {
    const size_t j = first + i;
    if (j < run->fibers.size() && run->fibers[j].warp == f.warp
        && !run->fibers[j].done && s[i])
      bits |= 1u << i;
  }
  return bits;
}
template <class T> inline T shuffle_as(T v, int src_of_lane(int, int), int arg) {
  static_assert(sizeof(T) == 4, "32-bit values");
  uint32_t b; std::memcpy(&b, &v, 4);
  b = shuffle(b, src_of_lane, arg);
  std::memcpy(&v, &b, 4); return v;
}
inline unsigned char* dynamic_smem() { return run->smem[run->fibers[run->cur].block].data(); }
}  // namespace emu

inline void __syncthreads() {
  emu::wait(emu::run->blocks[emu::run->fibers[emu::run->cur].block]);
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m, int = 32) {
  return emu::shuffle_as(v, emu::xor_lane, m);
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d, int = 32) {
  return emu::shuffle_as(v, emu::down_lane, (int)d);
}
inline unsigned __ballot_sync(unsigned, int pred) { return emu::ballot(pred != 0); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
using std::max;
using std::min;
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline int atomicExch(int* p, int v) { return std::atomic_ref<int>(*p).exchange(v); }
namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu::wait(emu::run->cluster); }
  unsigned block_rank() const { return emu::run->fibers[emu::run->cur].block; }
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    unsigned char* mine = emu::dynamic_smem();
    return reinterpret_cast<T*>(emu::run->smem[rank].data()
                                + (reinterpret_cast<unsigned char*>(p) - mine));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __cluster_dims__(...)
#define __align__(n) alignas(n)
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
#ifndef EMU_BLOCK_ORDER
#define EMU_BLOCK_ORDER 0
#endif
// the k-th of n units (rows of blocks, or clusters) to run: in the grid's
// order (0), reversed (1), or the odd units first, then the even (2)
inline unsigned emu_order(unsigned k, unsigned n) {
  if (EMU_BLOCK_ORDER == 1) return n - 1 - k;
  if (EMU_BLOCK_ORDER == 2) return k < n / 2 ? 2 * k + 1 : 2 * (k - n / 2);
  return k;
}
// a launch: grid.x blocks a row, cluster blocks together (1: one at a time)
template <class F, class A>
void emu_launch(F f, dim3 grid, dim3 block, size_t smem, const A& a,
                unsigned cluster = 1) {
  emu::Run r;
  emu::run = &r;
  r.body = [&] { f(a); };
  const unsigned per_row = grid.x / cluster, units = grid.y * per_row;
  for (unsigned k = 0; k < units; ++k) {
    const unsigned u = emu_order(k, units);
    emu::blocks_together(u % per_row * cluster, cluster, u / per_row,
                         block.x, smem);
  }
  emu::run = nullptr;
}
"""
LAUNCH = re.compile(r"(\w+)<<<(.+?), (dim3\(\w+\)), (\w+), stream_>>>\((\w+)\);")
CLUSTER = re.compile(r"__global__ void __cluster_dims__\((\w+), 1, 1\)\s+"
                     r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(")
DYNAMIC = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];")


def _for_cpu(text: str) -> str:
    text = text.replace("#include <cooperative_groups.h>", "")
    return text.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')


def build_for_cpu(source: Path, out_dir: Path, launches: int,
                  defines: tuple = ()) -> Path:
    """Build ``source`` (a ``.cu`` file with ``launches`` kernel launches)
    and the headers beside it into a shared library in ``out_dir``;
    returns its path.  ``defines``: ``NAME=VALUE`` macros for g++.  Skips
    the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    src = source.read_text()
    clusters = dict((name, size) for size, name in CLUSTER.findall(src))

    def launch(m):
        extra = f", {clusters[m.group(1)]}" if m.group(1) in clusters else ""
        return (f"emu_launch({m.group(1)}, {m.group(2)}, {m.group(3)}, "
                f"{m.group(4)}, {m.group(5)}{extra});")
    src, n = LAUNCH.subn(launch, src)
    assert n == launches, f"{launches} kernel launches in {source.name}"
    src = DYNAMIC.sub(r"\1* \2 = reinterpret_cast<\1*>(emu::dynamic_smem());",
                      src)
    (out_dir / "cuda_shim.h").write_text(SHIM)
    for header in source.parent.glob("*.cuh"):
        (out_dir / header.name).write_text(_for_cpu(header.read_text()))
    cpp = out_dir / f"{source.stem}.cpp"
    cpp.write_text(_for_cpu(src))
    lib = out_dir / f"lib{source.stem}_cpu.so"
    # -fno-gnu-unique: the shim's inline variables (threadIdx, blockIdx,
    # emu::run) would otherwise be STB_GNU_UNIQUE, which the dynamic linker
    # binds process-wide by name, across libraries loaded RTLD_LOCAL: a
    # later library of the same names (another kernel's build, K3's
    # thread_local ones in tests/test_torch_reg_kernel_emulated.py) would
    # use this one's variables
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
                    "-fno-gnu-unique", "-shared", "-w",
                    *(f"-D{d}" for d in defines), "-o", str(lib), str(cpp)],
                   check=True)
    return lib
