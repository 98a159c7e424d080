"""The frozen renderer equals the port's ``utils/synthetic.py`` at a small
size, every video of a batch of them, at the port's texture."""

import pytest
import torch

from ellc_bench.frames import render


@pytest.mark.parametrize("kind", ["base", "fastrot", "revisit"])
def test_bench_renderer_equals_port(kind):
    from egomotion_with_local_loop_closures_tpu_torch.utils import synthetic
    pairs = [(11, 12), (13, 14), (15, 16)]
    scenes, poses = render.build_scenes_and_poses(kind, pairs, 24)
    for (s, t), scene, pose in zip(pairs, scenes, poses):
        port_scene = synthetic.make_room_scene(
            seed=s, depth=1.25, half_width=1.7, half_height=1.15)
        if kind == "revisit":
            port_poses = torch.from_numpy(synthetic.loop_trajectory(
                24, seed=t, rot_amp=0.08, trans_amp=0.12))
        else:
            port_poses = synthetic.trajectory(
                24, seed=t,
                rot_step=0.0015 * (3.0 if kind == "fastrot" else 1.0),
                trans_step=0.02)
        assert torch.equal(pose, port_poses)
        for a, b in zip(scene, port_scene):
            assert (a == b).all()
        got = render.render_frames(scene, pose, 30, 40,
                                   (40.0, 40.0, 20.0, 15.0), "cpu", chunk=5)
        want = synthetic.render_sequence(port_scene, port_poses, 30, 40,
                                         40.0, 40.0, 20.0, 15.0)[0]
        assert torch.equal(got, want)


def test_bench_texture_widens_the_spectrum():
    """The benchmark's texture: the same draws over a wider band."""
    a = render.make_room_scene(seed=3, num_harmonics=48,
                               freq_range=(3.0, 600.0))
    f = torch.as_tensor(a.tex_freq).norm(dim=-1)
    assert f.min() >= 3.0 * (1 - 1e-6) and f.max() <= 600.0 * (1 + 1e-6)
    assert a.tex_freq.shape == (5, 48, 2)
