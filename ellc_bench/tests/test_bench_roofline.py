"""The frozen work counts reproduce the kernel table's bounds at 480x270
(PERF.md, kernel table: K2 9.07 MB a video; one align 0.003554 ms at V = 1
and 0.028429 ms at V = 8 with phase 3b's live iterations 3 / 3 / 4 / 6)."""

import pytest

from ellc_bench.roofline import peaks, work


def test_bench_k2_bytes():
    nbytes, _ = work.stereo_work(270, 480)
    assert nbytes == 9_072_032
    assert 1e3 * peaks.bound_s(*work.stereo_work(270, 480)) == pytest.approx(
        0.002708, abs=5e-7)
    assert 1e3 * peaks.bound_s(*work.stereo_work(270, 480, 8)) == \
        pytest.approx(0.021665, abs=5e-7)


@pytest.mark.parametrize("videos, ms", [(1, 0.003554), (8, 0.028429)])
def test_bench_align_bound(videos, ms):
    nbytes, ops = work.align_work(270, 480, 4, videos, [3, 3, 4, 6])
    assert 1e3 * peaks.bound_s(nbytes, ops) == pytest.approx(ms, abs=5e-7)


def test_bench_align_bound_once_a_level():
    """Without live iterations each level's planes count once: 6 planes
    of 4 B a pixel at every level."""
    nbytes, _ = work.align_work(270, 480, 4)
    pixels = sum(h * w for h, w in work.level_shapes(270, 480, 4))
    assert nbytes == 24 * pixels + 4 * work.K1_BYTES_VIDEO_LEVEL
