"""The benchmark of the PyTorch/CUDA BLAKE2f prover, one run of one cell:

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card. The last line of
standard output is the run's JSON result; the numbers the reference
compared, each beside its limit, are the last lines of standard error.
It exits non-zero, with no result, without a CUDA card, without the
program under test, or when JAX or the JAX package was loaded.
"""

import os
import sys


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from zkbench import harness

    return harness.main(argv, root)


if __name__ == "__main__":
    sys.exit(main())
