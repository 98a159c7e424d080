"""Write the golden file that the PyTorch port is checked against.

Runs the JAX package's ``runner.run_sequence`` on the CPU over the first
17 frames of ``reference_build/run_gn/frames_480x270.npz`` (480x270, GN
mode) under the parity config (exact warps, dense stereo, float samples,
the glibc bootstrap), and writes the tracked frames' world poses, seeds%
and rescale factors as JSON.  ``chip_smoke.py`` and
``tests/test_torch_pipeline.py`` compare the port's run with it.

Usage: python tools/make_port_golden.py [--frames N] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = os.path.join(ROOT, "reference_build", "run_gn", "frames_480x270.npz")
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "port_golden_run_gn.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig
    from egomotion_with_local_loop_closures_tpu.runtime import runner
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        PARITY_OVERRIDES)

    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    frames = np.load(FRAMES)["frames"][:args.frames]
    res = runner.run_sequence(iter(frames), cfg)
    golden = {
        "source": "egomotion_with_local_loop_closures_tpu runner.run_sequence"
                  " on the CPU, tools/make_port_golden.py",
        "frames_file": os.path.relpath(FRAMES, ROOT),
        "num_input_frames": int(args.frames),
        "config_overrides": PARITY_OVERRIDES,
        "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                   if not isinstance(v, tuple)},
        "frame_ids": res.frame_ids.tolist(),
        "kf_ids": res.kf_ids.tolist(),
        "world_poses": np.asarray(res.world_poses, np.float64).tolist(),
        "seeds": res.seeds.tolist(),
        "rescales": res.rescales.tolist(),
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}: {len(res.frame_ids)} tracked frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
