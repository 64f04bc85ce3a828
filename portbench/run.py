"""The benchmark's command:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  It prints one JSON result line last on
standard output, and the numbers its comparison checked, each beside its
limit, as its last lines on standard error."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
