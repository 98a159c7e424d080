"""The frozen plain reference agrees with the port's plain path (its CPU
branch) on ``TEST_CONFIG``, bit for bit: GN over two videos at once."""

import dataclasses

import torch

from ellc_bench.frames import render
from ellc_bench.reference import config as ref_config
from ellc_bench.reference import pipeline as ref


def _configs(**kw):
    from egomotion_with_local_loop_closures_tpu_torch import config
    cfg = config.TEST_CONFIG.replace(**config.PARITY_OVERRIDES, **kw)
    return cfg, ref_config.ELLCConfig(**dataclasses.asdict(cfg))


def _frames(cfg, kind, videos, frames):
    scenes, poses = render.build_scenes_and_poses(
        kind, [(5 + v, 9 + v) for v in range(videos)], frames)
    return torch.stack([render.render_frames(
        s, p, cfg.rows, cfg.cols, (cfg.fx, cfg.fy, cfg.cx, cfg.cy), "cpu")
        for s, p in zip(scenes, poses)])


def test_bench_reference_gn_equals_port():
    from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
    cfg, rcfg = _configs()
    fr = _frames(cfg, "base", 2, 24)
    st = sharded.batched_init(fr[:, 0], cfg, "cpu")
    rs = ref.batched_init(fr[:, 0], rcfg, "cpu")
    for b, size in ((1, 7), (8, 8), (16, 8)):
        st, out = sharded.batched_process_interval(st, fr[:, b:b + size],
                                                   cfg)
        rs, rout = ref.batched_process_interval(rs, fr[:, b:b + size], rcfg)
        for f in ("pose_wrt_kf", "pose_wrt_world", "seeds", "rescale"):
            assert torch.equal(getattr(out, f), getattr(rout, f)), f
    assert torch.equal(st.depth.idepth_smoothed, rs.depth.idepth_smoothed)
    assert torch.equal(st.kf.depths[2], rs.kf.depths[2])

