"""Run one cell of the benchmark of ``raytpu_torch`` (BENCHMARK.json).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. See ``portbench/README.md``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.harness.cell import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
