"""The comparison that decides ``correct`` fails what it has to fail.

Each test drives the rest of a run (``harness.run_cell`` on the CPU, at a
small size, with the look for a card skipped) and sees ``correct``: true
for the sound program, false with the timed path broken underneath (a
step that returns its state unchanged; half of the videos left out, their
outputs copied from the rest; a tracked pose altered where it is
produced, in every video or in one slot of the batch; a wrong init), and
false for the bfloat16 control in the program's place."""

import dataclasses

import numpy as np
import pytest

from ellc_bench import compare, harness

SMALL = dict(rows=96, cols=128, fx=120.0, fy=120.0, cx=64.0, cy=48.0)


def _spec(videos=2):
    spec = harness.cell_spec("gn_backlog")
    spec["config"]["overrides"].update(SMALL)
    spec["traffic"].update(videos=videos, clip_frames=24,
                           check_videos=videos, check_intervals=3)
    return spec


def _correct(videos=2, seed=3):
    result, checks = harness.run_cell(_spec(videos), seed, 0.0, False,
                                      "cpu")
    return result["correct"], checks


def _unchanged_state(monkeypatch):
    from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline
    step = pipeline._track_refine_step

    def broken(state, image, cfg, replay=False, init_rotation=None):
        return state, step(state, image, cfg, replay, init_rotation)[1]

    monkeypatch.setattr(pipeline, "_track_refine_step", broken)


def _half_batch(monkeypatch):
    from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
    run = sharded.batched_process_interval

    def broken(states, images, cfg):
        V = images.shape[0]
        half = sharded._map(lambda t: t[:V // 2], states)
        new, out = run(half, images[:V // 2], cfg)

        def widen(t):
            reps = [V // t.shape[0]] + [1] * (t.dim() - 1)
            return t.repeat(*reps)
        return (sharded._map(widen, new),
                type(out)(**{f.name: widen(getattr(out, f.name))
                             for f in dataclasses.fields(out)}))

    monkeypatch.setattr(sharded, "batched_process_interval", broken)


def _altered_pose(monkeypatch):
    from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
    run = sharded.batched_process_interval

    def broken(states, images, cfg):
        new, out = run(states, images, cfg)
        pose = out.pose_wrt_world.clone()
        pose[:, -1, 3] += 1e-3
        return new, dataclasses.replace(out, pose_wrt_world=pose)

    monkeypatch.setattr(sharded, "batched_process_interval", broken)


def _one_slot(monkeypatch):
    """Slot 1 of the batch alone gets a wrong pose, in every frame."""
    from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
    run = sharded.batched_process_interval

    def broken(states, images, cfg):
        new, out = run(states, images, cfg)
        pose = out.pose_wrt_world.clone()
        pose[1, :, 3] += 1e-3
        return new, dataclasses.replace(out, pose_wrt_world=pose)

    monkeypatch.setattr(sharded, "batched_process_interval", broken)


def _wrong_init(monkeypatch):
    """Every video's initial inverse depth 1 % off."""
    from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
    init = sharded.batched_init

    def broken(images, cfg, device):
        st = init(images, cfg, device)
        depth = dataclasses.replace(
            st.depth, idepth=st.depth.idepth * 1.01,
            idepth_smoothed=st.depth.idepth_smoothed * 1.01)
        return dataclasses.replace(st, depth=depth)

    monkeypatch.setattr(sharded, "batched_init", broken)


def test_bench_sound_program_is_correct():
    ok, checks = _correct()
    assert ok, checks


@pytest.mark.parametrize("fault, videos", [
    (_unchanged_state, 2), (_half_batch, 2), (_altered_pose, 2),
    (_one_slot, 4), (_wrong_init, 2)])
def test_bench_fault_is_not_correct(fault, videos, monkeypatch):
    fault(monkeypatch)
    ok, checks = _correct(videos)
    assert not ok, checks


def test_bench_control_is_not_correct():
    """The bfloat16 control against the reference, judged by the cell's
    limits."""
    spec = _spec()
    mod = harness.load_driver(spec["config"]["entry"])
    drv = mod.Driver(spec["config"], spec["traffic"], 3, "cpu")
    drv.setup()
    drv.run_pass({}, {})
    drv.release()
    limits = harness._limits(spec)
    read = drv.readings(control=True)
    assert all(read["program"][k] <= lim for k, lim in limits.items()), read
    assert any(read["control"][k] > lim for k, lim in limits.items()), read


def test_bench_interval_statistic_at_the_cell_shape():
    """At the cell's sample (6 intervals of 8 videos), a fault in one
    video's every interval reads whole, one far step of one video does
    not, and the init's number is its widest video."""
    limit = 4e-4
    sound = np.random.default_rng(0).uniform(0, limit / 4, (6, 8))
    one_slot = sound.copy()
    one_slot[:, 5] = 10 * limit
    one_step = sound.copy()
    one_step[2, 5] = 10 * limit
    assert compare.worst_video_median(sound) <= limit
    assert compare.worst_video_median(one_slot) > limit
    assert compare.worst_video_median(one_step) <= limit
    assert compare.worst_video(np.r_[sound[0, :7], limit * 2]) > limit
