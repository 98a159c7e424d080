"""Bit-exact replica of glibc's default ``rand()`` stream.

A copy of ``egomotion_with_local_loop_closures_tpu/utils/glibc_rand.py``
(numpy only): the JAX package's ``utils/__init__.py`` imports jax, so the
port cannot import the original.

The reference's random depth bootstrap draws
``0.5f + (rand() % 100001) / 100000.0f`` per gradient-gated pixel in
raster order (``DepthPropagation.cpp:160``) and never calls ``srand``
(no call anywhere in ``src/``), so every reference run consumes the
deterministic glibc TYPE_3 additive-feedback sequence from seed 1.
Replicating that stream lets the framework start from EXACTLY the
reference's initial depth map, turning "the remaining parity gap is
init randomness" from an inference into a measurement (BASELINE.md).

Algorithm (glibc ``stdlib/random_r.c``, TYPE_3, degree 31, sep 3):
  r[0]    = seed
  r[i]    = (16807 * r[i-1]) mod 2147483647          for i in 1..30
            (computed via Schrage's trick in glibc; with 64-bit ints
            the plain product is exact and equal)
  r[i]    = r[i-31]                                  for i in 31..33
  r[i]    = (r[i-3] + r[i-31]) mod 2^32              for i >= 34
  out[k]  = r[344 + k] >> 1        (first 310 values are discarded)

Verified against the toolchain's actual libc ``rand()`` in the JAX
package's ``tests/test_glibc_rand.py`` (first outputs 1804289383,
846930886, ...).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def glibc_rand(n: int, seed: int = 1) -> np.ndarray:
    """First ``n`` outputs of glibc ``rand()`` after ``srand(seed)``
    (seed 1 == the never-seeded default), as uint32 in [0, 2^31)."""
    total = 344 + n
    r = np.zeros(total, dtype=np.uint64)
    s = np.uint64(seed)
    r[0] = s
    for i in range(1, 31):
        # 16807 * r mod 2^31-1; glibc maps a 0 intermediate to 1 only
        # through Schrage's decomposition, which for seed>=1 never hits 0
        r[i] = (np.uint64(16807) * r[i - 1]) % np.uint64(2147483647)
    r[31:34] = r[0:3]
    m = np.uint64(0xFFFFFFFF)
    # additive feedback r[i] = r[i-31] + r[i-3] (mod 2^32).  The lag-3 /
    # lag-31 recurrence admits a small vectorization: values within a
    # stride of 3 depend only on already-final entries
    for i in range(34, total, 3):
        j = min(i + 3, total)
        k = j - i
        r[i:j] = (r[i - 31:i - 31 + k] + r[i - 3:i - 3 + k]) & m
    return (r[344:] >> np.uint64(1)).astype(np.uint32)


def glibc_unit_floats(n: int, seed: int = 1) -> np.ndarray:
    """``(rand() % 100001) / 100000.0f`` for the first ``n`` draws —
    the exact float32 values of DepthPropagation.cpp:160."""
    v = glibc_rand(n, seed) % np.uint32(100001)
    return (v.astype(np.float32) / np.float32(100000.0)).astype(np.float32)
