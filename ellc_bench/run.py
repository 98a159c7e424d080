"""Run one benchmark cell of the PyTorch and CUDA port once.

    python ellc_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Prints the run's checks on standard error and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and with ``--trace 1`` ``breakdown``), then the
compared numbers with their limits under ``checks``.  Exits non-zero and
prints no result without the devices, or when JAX or the JAX package was
loaded.  See ``harness.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ellc_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
