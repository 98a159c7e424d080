"""The port's native C++ frame loader (runtime/native_loader.py, its own
copy of native/ellc_loader.cpp), following the JAX package's
tests/test_native_loader.py: decode against the written images, order,
resize, skip, and the PIL path; and the library is built under the port's
``build/`` directory, never inside the JAX package.

Tolerances: PGM frames exact; JPEG frames within a mean of 3 grey levels
of the image written (lossy); a resized frame within 1e-3 of OpenCV's
INTER_LINEAR formula; the PIL path equal to the JAX package's
``image_dir_frames`` bit for bit.
"""

import os
from pathlib import Path

import numpy as np
from PIL import Image

from egomotion_with_local_loop_closures_tpu.runtime import io as jio

from egomotion_with_local_loop_closures_tpu_torch.runtime import native_loader

PORT = Path(native_loader.__file__).resolve().parent.parent
JAX_PKG = PORT.parent / "egomotion_with_local_loop_closures_tpu"


def _make_seq(d, n=6, size=(40, 32), fmt="jpeg"):
    rng = np.random.default_rng(0)
    truth = []
    for i in range(n):
        # a smooth image, so that JPEG's loss stays small
        base = np.zeros(size, np.float32)
        base += np.linspace(0, 200, size[1])[None, :]
        base += 10.0 * i
        img = np.clip(base + rng.normal(0, 1, size), 0, 255).astype(np.uint8)
        name = f"{i:06d}.jpg" if fmt == "jpeg" else f"{i:06d}.pgm"
        Image.fromarray(img).save(os.path.join(d, name))
        truth.append(img)
    return truth


def test_library_builds_under_the_port_build_dir():
    lib = native_loader.get_lib()
    assert lib is not None, "g++ and libjpeg are expected on this host"
    path = Path(lib._name).resolve()
    assert path == native_loader.library_path().resolve()
    assert path.parent == PORT / "build"
    assert JAX_PKG not in path.parents


def test_jpeg_sequence_in_order(tmp_path):
    truth = _make_seq(str(tmp_path), fmt="jpeg")
    with native_loader.NativeFrameLoader(str(tmp_path), 40, 32) as ld:
        assert len(ld) == len(truth)
        for i, frame in enumerate(ld):
            assert frame.shape == (40, 32)
            assert np.abs(frame - truth[i].astype(np.float32)).mean() < 3.0


def test_pgm_exact_and_resize(tmp_path):
    truth = _make_seq(str(tmp_path), n=3, fmt="pgm")
    with native_loader.NativeFrameLoader(str(tmp_path), 40, 32) as ld:
        f0 = next(iter(ld))
    np.testing.assert_array_equal(f0, truth[0].astype(np.float32))
    with native_loader.NativeFrameLoader(str(tmp_path), 20, 16) as ld:
        g0 = next(iter(ld))
    a = truth[0].astype(np.float32)
    # OpenCV's INTER_LINEAR: src = (dst + 0.5) * scale - 0.5, edge clamp
    fy = (np.arange(20) + 0.5) * 2.0 - 0.5
    fx = (np.arange(16) + 0.5) * 2.0 - 0.5
    y0, x0 = np.floor(fy).astype(int), np.floor(fx).astype(int)
    wy, wx = (fy - y0)[:, None], (fx - x0)[None, :]
    y0c, y1c = np.clip(y0, 0, 39), np.clip(y0 + 1, 0, 39)
    x0c, x1c = np.clip(x0, 0, 31), np.clip(x0 + 1, 0, 31)
    top = a[y0c][:, x0c] * (1 - wx) + a[y0c][:, x1c] * wx
    bot = a[y1c][:, x0c] * (1 - wx) + a[y1c][:, x1c] * wx
    assert np.abs(g0 - (top * (1 - wy) + bot * wy)).max() < 1e-3


def test_skip(tmp_path):
    truth = _make_seq(str(tmp_path), n=5, fmt="pgm")
    with native_loader.NativeFrameLoader(str(tmp_path), 40, 32) as ld:
        ld.skip(3)
        f = next(iter(ld))
    np.testing.assert_array_equal(f, truth[3].astype(np.float32))


def test_frames_takes_the_native_path(tmp_path):
    truth = _make_seq(str(tmp_path), n=2, fmt="pgm")
    src = native_loader.frames(str(tmp_path), 40, 32)
    assert src.backend == "native"
    got = list(src)
    assert len(got) == 2
    np.testing.assert_array_equal(got[1], truth[1].astype(np.float32))


def test_pil_path_equals_the_jax_package(tmp_path, monkeypatch):
    _make_seq(str(tmp_path), n=3, fmt="jpeg")
    monkeypatch.setattr(native_loader, "get_lib", lambda: None)
    src = native_loader.frames(str(tmp_path), 40, 32)
    assert src.backend == "pil"
    want = list(jio.image_dir_frames(str(tmp_path)))
    got = list(src)
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    # a size that differs is resized bilinearly by PIL
    small = list(native_loader.frames(str(tmp_path), 20, 16))
    assert small[0].shape == (20, 16) and small[0].dtype == np.float32
