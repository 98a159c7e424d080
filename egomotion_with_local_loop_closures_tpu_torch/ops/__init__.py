"""Hand-written CUDA kernels and their PyTorch bindings.

- ``reg_kernel``: K3, the depth-map regularization (``csrc/reg_kernel.cu``);
- ``gn_kernel``: K1, one Gauss-Newton iteration of the tracker as two
  kernels (``csrc/gn_kernel.cu``);
- ``stereo_kernel``: K2, the epipolar line stereo and EKF observation of
  one frame (``csrc/stereo_kernel.cu``);
- ``propagate_kernel``: the candidate merge of keyframe depth
  propagation, summed in a fixed order (``csrc/propagate_kernel.cu``);
- K4, the rest of a tracked frame: ``se3_kernel``, the SE(3) compose and
  relative pose (``csrc/se3_kernel.cu``); ``pyramid_kernel``, the
  frame's pyramid, gradients and max-gradient map
  (``csrc/pyramid_kernel.cu``); ``depth_refresh_kernel``, the keyframe's
  depth-pyramid refresh (``csrc/depth_refresh_kernel.cu``).

K1, K2 and the compose share their device helpers,
``csrc/ellc_device.cuh``.  Each
source is compiled with ``nvcc`` on first use, from this checkout, into
``build/`` (one shared library per hash of the source, the headers of
``csrc/`` and the flags, loaded with ``ctypes``): :func:`build`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot "
                           "be built (install the CUDA toolkit or put nvcc "
                           "on PATH)")
    return nvcc


def build(source: Path, stem: str) -> Path:
    """Compile ``source`` into ``build/lib<stem>_<hash>.so`` unless a
    library of this exact source, headers (every ``csrc/*.cuh``) and flag
    set is already built; returns the library's path."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib
