#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port, from the checkout
root:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the output check's numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output.
Exits non-zero without a result when the cell's CUDA devices are missing.
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import harness

    _t_start = harness.process_start()
    sys.exit(harness.main(sys.argv[1:], _t_start))
