"""The port's CUDA sources built for the CPU with g++, for the tests.

A shim header stands in for the CUDA runtime: a kernel launch becomes
``emu_launch``, which runs the grid's blocks one after another, each as
one ``std::thread`` per CUDA thread joined by a ``std::barrier`` at every
``__syncthreads``; ``__shared__`` variables are function statics (one
block runs at a time) and ``atomicAdd`` on an int is a
``std::atomic_ref``.  The sources' headers (``csrc/*.cuh``) are copied
beside them.  Built with ``-ffp-contract=off``, as nvcc's ``-fmad=false``
keeps every multiply and add apart.  The grid's z axis is not emulated
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
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx;
inline std::barrier<>* g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__ __restrict
#define __launch_bounds__(x)
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <class F, class A>
void emu_launch(F f, dim3 grid, dim3 block, const A& a) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(block.x);
      g_bar = &bar;
      std::vector<std::thread> ts;
      for (unsigned tx = 0; tx < block.x; ++tx)
        ts.emplace_back([&, tx] {
          blockIdx = {bx, by, 0};
          threadIdx = {tx, 0, 0};
          f(a);
        });
      for (auto& t : ts) t.join();
    }
}
"""
LAUNCH = re.compile(r"(\w+)<<<(.+?), (dim3\(\w+\)), 0, stream_>>>\((\w+)\);")


def _for_cpu(text: str) -> str:
    return text.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')


def build_for_cpu(source: Path, out_dir: Path, launches: int) -> Path:
    """Build ``source`` (a ``.cu`` file with ``launches`` kernel launches)
    and the headers beside it into a shared library in ``out_dir``;
    returns its path.  Skips the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    src, n = LAUNCH.subn(r"emu_launch(\1, \2, \3, \4);", source.read_text())
    assert n == launches, f"{launches} kernel launches in {source.name}"
    (out_dir / "cuda_shim.h").write_text(SHIM)
    for header in source.parent.glob("*.cuh"):
        (out_dir / header.name).write_text(_for_cpu(header.read_text()))
    cpp = out_dir / f"{source.stem}.cpp"
    cpp.write_text(_for_cpu(src))
    lib = out_dir / f"lib{source.stem}_cpu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-w", "-o", str(lib), str(cpp)],
                   check=True)
    return lib
