"""One run of a cell with traffic parameters overridden, for sweeps that
locate the knee of a mix (the videos at once, say) on the card; prints the
run's result line with the overrides beside it.  Not a benchmark run: its
numbers are not held to any bound.

    python ellc_bench/sweep.py --workload gn_backlog --set videos=16 \
        --seed 5 --seconds 5 --trace 0
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ellc_bench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="a traffic parameter, NAME=VALUE (JSON)")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    harness.set_environment(harness.ROOT)
    spec = harness.apply_sets(harness.cell_spec(args.workload), args.set)
    result, checks = harness.run_cell(spec, args.seed, args.seconds,
                                      bool(args.trace), args.device)
    result["set"] = args.set
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
