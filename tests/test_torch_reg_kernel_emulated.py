"""K3's CUDA source built for the CPU with g++, held bit for bit against the
plain version.

``csrc/reg_kernel.cu`` is compiled through a small header that maps the
CUDA names it uses onto C++: one ``std::thread`` per CUDA thread, the
blocks one after another, ``__syncthreads`` as a ``std::barrier`` and
``__shared__`` arrays as function statics (one block at a time uses them).
The launch ``kernel<<<grid, block, 0, stream>>>(args)`` is rewritten into a
call of the emulated launch.  float32 arithmetic is IEEE on both sides
(x86-64 SSE; ``-ffp-contract=off`` as ``nvcc -fmad=false``), so every plane
must equal the plain version's.  This holds the kernel's indexing, halo,
edge values and gates on the CPU, on ragged shapes and valid borders; that
nvcc accepts the source and how the card runs it are checked on the card
(``test_torch_reg_kernel.py -m cuda``, ``chip_smoke.py``).  A batch of
states (the grid's z extent) must give each state what it gives alone.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import propagate
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    FIELDS, DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
from test_torch_reg_kernel import border_planes, random_planes, stacked

torch.set_num_threads(1)

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline std::barrier<>* g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
template <class F, class A>
void emu_launch(F f, dim3 grid, dim3 block, const A& a) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(block.x * block.y);
        g_bar = &bar;
        std::vector<std::thread> ts;
        for (unsigned ty = 0; ty < block.y; ++ty)
          for (unsigned tx = 0; tx < block.x; ++tx)
            ts.emplace_back([&, tx, ty] {
              blockIdx = {bx, by, bz};
              threadIdx = {tx, ty, 0};
              f(a);
            });
        for (auto& t : ts) t.join();
      }
}
"""
LAUNCH = re.compile(r"(\w+<[^>]*>)<<<([^,]+), (dim3\([^)]*\)), 0, stream>>>"
                    r"\((\w+)\);")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's library built for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernel")
    src = reg_kernel.SOURCE.read_text()
    src, n = LAUNCH.subn(r"emu_launch(\1, \2, \3, \4);", src)
    assert n == 1, "one kernel launch in the source"
    d = tmp_path_factory.mktemp("reg_kernel_cpu")
    (d / "cuda_shim.h").write_text(SHIM)
    (d / "reg_kernel.cpp").write_text(
        src.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"'))
    lib = d / "libreg_kernel_cpu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-w", "-o", str(lib),
                    str(d / "reg_kernel.cpp")], check=True)
    return reg_kernel.bind(ctypes.CDLL(str(lib)))


def assert_equal(ref, got):
    for name in FIELDS:
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"field {name}: {m}")


@pytest.mark.parametrize("make", [random_planes, border_planes],
                         ids=["seeded", "valid_border"])
@pytest.mark.parametrize("shape", [(37, 53), (21, 100)])
@pytest.mark.parametrize("lsd", [False, True])
@pytest.mark.parametrize("occl", [False, True])
def test_emulated_kernel_equals_plain(emulated, make, shape, lsd, occl):
    planes, mg = make(7, shape)
    st = DepthMapState(**{k: torch.as_tensor(v) for k, v in planes.items()})
    mgt = torch.as_tensor(mg)
    H, W = shape
    cfg = ELLCConfig(rows=H, cols=W, lsd_correct_hole_fill=lsd)
    got = reg_kernel._launch(emulated, st, mgt, cfg, occl, 0)
    ref = propagate.do_regularization(st, mgt, cfg, occl)
    assert_equal(ref, got)
    assert_equal(propagate.regularize(st, cfg, occl),
                 reg_kernel._launch(emulated, st, None, cfg, occl, 0))
    assert (ref.valid & ~st.valid).any()          # holes filled
    assert (st.valid & ~ref.valid).any()          # pixels dropped


@pytest.mark.parametrize("shape", [(37, 53), (21, 100)])
@pytest.mark.parametrize("occl", [False, True])
def test_emulated_batch_equals_plain_per_state(emulated, shape, occl):
    """B = 3 states (seeded, valid-border, seeded) in one launch: each
    equals the plain version on that state alone, bit for bit."""
    st, mgt, states = stacked(shape, seed=17)
    H, W = shape
    cfg = ELLCConfig(rows=H, cols=W)
    got = reg_kernel._launch(emulated, st, mgt, cfg, occl, 0)
    got_r = reg_kernel._launch(emulated, st, None, cfg, occl, 0)
    for b, (s_b, mg_b) in enumerate(states):
        assert_equal(propagate.do_regularization(s_b, mg_b, cfg, occl),
                     got.replace(**{n: getattr(got, n)[b] for n in FIELDS}))
        assert_equal(propagate.regularize(s_b, cfg, occl),
                     got_r.replace(**{n: getattr(got_r, n)[b]
                                      for n in FIELDS}))
