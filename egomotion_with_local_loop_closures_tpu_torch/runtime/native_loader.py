"""ctypes binding and on-demand build of the native C++ frame loader.

Port of ``egomotion_with_local_loop_closures_tpu/runtime/native_loader.py``.
The reference decodes every frame on its tracking thread
(cv::VideoCapture in the main loop, ``src/main.cpp:199-226``), so decode
latency adds to compute.  ``native/ellc_loader.cpp`` (the port's own copy
of the source) decodes, converts to gray and resizes on a C++ thread pool
behind a bounded in-order queue.  This module builds it with ``g++
-ljpeg`` on first use into the port's ``build/`` directory (one library
per source hash, as the CUDA kernels are built) and serves it as a frame
iterator like ``runtime.io.image_dir_frames``.

``frames`` falls back to decoding with PIL on a host without ``g++`` or
libjpeg; ``Frames.backend`` says which path a source took ("native" or
"pil").  Both decode on the host and hand numpy arrays to the pipeline,
which moves them to its device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "ellc_loader.cpp"
BUILD_DIR = _PKG / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LINK = ("-ljpeg", "-lpthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library of this exact source and flag set is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS + _LINK).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"libellc_loader_{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp),
                        *_LINK], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, lib)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if it cannot be
    built or loaded on this host."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.ellc_loader_open.restype = ctypes.c_void_p
        lib.ellc_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
        lib.ellc_loader_count.restype = ctypes.c_int
        lib.ellc_loader_count.argtypes = [ctypes.c_void_p]
        lib.ellc_loader_next.restype = ctypes.c_int
        lib.ellc_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.ellc_loader_skip.restype = None
        lib.ellc_loader_skip.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ellc_loader_close.restype = None
        lib.ellc_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeFrameLoader:
    """In-order prefetching frame source backed by the C++ pool."""

    def __init__(self, directory: str, rows: int, cols: int,
                 n_threads: int = 2, queue_cap: int = 8):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._h = lib.ellc_loader_open(directory.encode(), rows, cols,
                                       n_threads, queue_cap)
        if not self._h:
            raise FileNotFoundError(directory)
        self.rows, self.cols = rows, cols

    def __len__(self) -> int:
        return self._lib.ellc_loader_count(self._h)

    def skip(self, n: int) -> None:
        self._lib.ellc_loader_skip(self._h, n)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty((self.rows, self.cols), np.float32)
        ok = self._lib.ellc_loader_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if not ok:
            raise StopIteration
        return out

    def close(self) -> None:
        if self._h:
            self._lib.ellc_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _pil_frames(directory: str, rows: int, cols: int
                ) -> Iterator[np.ndarray]:
    """The PIL path: decode with ``image_dir_frames``, resize bilinearly
    to rows x cols where the size differs."""
    from PIL import Image

    from egomotion_with_local_loop_closures_tpu_torch.runtime import io
    for img in io.image_dir_frames(directory):
        if img.shape != (rows, cols):
            img = np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
                (cols, rows), Image.BILINEAR), np.float32)
        yield img


class Frames:
    """The frames of an image directory, (rows, cols) float32 arrays in
    order: from the native loader where it builds, else from PIL.
    ``backend`` is "native" or "pil"."""

    def __init__(self, directory: str, rows: int, cols: int,
                 n_threads: int = 2, queue_cap: int = 8):
        try:
            self._loader: Optional[NativeFrameLoader] = NativeFrameLoader(
                directory, rows, cols, n_threads, queue_cap)
            self._it: Iterator[np.ndarray] = self._loader
            self.backend = "native"
        except (RuntimeError, FileNotFoundError):
            self._loader = None
            self._it = _pil_frames(directory, rows, cols)
            self.backend = "pil"

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        try:
            return next(self._it)
        except StopIteration:
            self.close()
            raise

    def close(self) -> None:
        if self._loader is not None:
            self._loader.close()
            self._loader = None


def frames(directory: str, rows: int, cols: int,
           n_threads: int = 2, queue_cap: int = 8) -> Frames:
    """Frame iterator over an image directory: the native C++ prefetch
    loader where it builds, otherwise the PIL path (resized to rows x
    cols); its ``backend`` attribute names the path taken."""
    return Frames(directory, rows, cols, n_threads, queue_cap)
