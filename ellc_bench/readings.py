"""The readings that the comparison's limits are set from: for each seed,
the numbers of one pass of the timed path against the plain reference,
and with ``--control 1`` those of the bfloat16 control (the reference put
in the program's place, ``reference/control.py``) against it.  One JSON
line a seed.  The benchmark's own runs never run the control.

    python ellc_bench/readings.py --workload gn_backlog --seeds 1,2,3 \
        --control 1 [--device cuda]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ellc_bench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    harness.set_environment(harness.ROOT)
    import torch

    spec = harness.cell_spec(args.workload)
    mod = harness.load_driver(spec["config"]["entry"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = mod.Driver(spec["config"], spec["traffic"], seed, args.device)
        drv.setup()
        drv.run_pass({}, {})
        drv.release()
        out = drv.readings(bool(args.control))
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        del drv
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
