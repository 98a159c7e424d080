"""The port's frame sources against the JAX package's: ``video_frames``
(an OpenCV decode, a resize by 1/4 and BGR -> gray), ``rgb_to_gray`` and
``resize_quarter``, and the CLI's ``--video``/``--skip``.

Tolerances: the decoded video frames equal the JAX package's bit for bit
(the same OpenCV calls on the same file); ``rgb_to_gray`` and
``resize_quarter`` within 1e-4 grey levels (a 3-term dot product and a
16-term mean in float32, rounded by two libraries).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu.image import pyramid as jpyr
from egomotion_with_local_loop_closures_tpu.runtime import io as jio

from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.runtime import cli, io
from egomotion_with_local_loop_closures_tpu_torch.utils import synthetic

torch.set_num_threads(1)

GRAY_TOL = 1e-4
N_FRAMES = 8


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """An 8-frame 384x512 colour video (MJPG): the synthetic room seen by a
    camera moving sideways, one colour channel shifted per channel."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("video") / "clip.avi")
    scene = synthetic.make_room_scene(seed=4, depth=1.25, half_width=1.7,
                                      half_height=1.15)
    poses = torch.zeros(N_FRAMES, 6)
    poses[:, 3] = torch.arange(N_FRAMES) * 0.01
    img, _ = synthetic.render_sequence(scene, poses, 384, 512, 440.0, 440.0,
                                       256.0, 192.0)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             (512, 384))
    assert writer.isOpened()
    for im in img.numpy():
        bgr = np.stack([im, 0.9 * im, np.roll(im, 3, axis=1)], -1)
        writer.write(np.clip(bgr, 0, 255).astype(np.uint8))
    writer.release()
    return path


@pytest.mark.parametrize("skip,max_frames", [(0, None), (3, 2)])
def test_video_frames_equal_jax(video, skip, max_frames):
    want = list(jio.video_frames(video, skip=skip, max_frames=max_frames))
    got = list(io.video_frames(video, skip=skip, max_frames=max_frames))
    assert len(got) == len(want) == (max_frames or N_FRAMES - skip)
    for a, b in zip(want, got):
        assert b.dtype == np.float32 and b.shape == (96, 128)
        np.testing.assert_array_equal(b, a)
    rgb = list(io.video_frames(video, gray=False, resize_factor=1.0,
                               max_frames=1))
    assert rgb[0].shape == (384, 512, 3)


def test_video_frames_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        next(io.video_frames(str(tmp_path / "none.avi")))


def test_rgb_to_gray_and_resize_quarter_match_jax():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 255, (38, 53, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pyramid.rgb_to_gray(torch.as_tensor(rgb)).numpy(),
        np.asarray(jpyr.rgb_to_gray(jnp.asarray(rgb))), rtol=0,
        atol=GRAY_TOL)
    u8 = rgb.astype(np.uint8)               # integer input is cast first
    np.testing.assert_allclose(
        pyramid.rgb_to_gray(torch.as_tensor(u8)).numpy(),
        np.asarray(jpyr.rgb_to_gray(jnp.asarray(u8))), rtol=0,
        atol=GRAY_TOL)
    img = rng.uniform(0, 255, (38, 53)).astype(np.float32)
    got = pyramid.resize_quarter(torch.as_tensor(img))
    assert got.shape == (9, 13)             # ragged rows and columns dropped
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpyr.resize_quarter(jnp.asarray(img))),
        rtol=0, atol=GRAY_TOL)


def test_cli_video_with_skip(video, tmp_path, capsys):
    out = tmp_path / "out"
    assert cli.main(["--video", video, "--skip", "2", "--out", str(out),
                     "--device", "cpu"]) == 0
    assert "camera model set to decoded frame size 96x128" in \
        capsys.readouterr().out
    orig = np.loadtxt(out / "poses_orig.txt")
    # frames 3..8 of the video: the first initializes, five are tracked
    assert orig[:, 0].astype(int).tolist() == [2, 3, 4, 5, 6]
    assert np.isfinite(orig).all()
    assert os.path.exists(out / "matchframes.txt")


def test_cli_needs_one_source(tmp_path, video):
    with pytest.raises(SystemExit):
        cli.main(["--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        cli.main(["--video", video, "--synthetic", "3", "--out",
                  str(tmp_path)])
