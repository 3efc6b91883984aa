"""Run one cell of the benchmark on the machine it is started on.

    python3 port_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints progress and the numbers compared
for ``correct`` on standard error and, last on standard output, one JSON
line (see ``port_bench/harness.py``).  Exits nonzero, printing no result,
without the CUDA devices the cell asks for.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from port_bench import harness
    sys.exit(harness.main(sys.argv[1:], harness.process_start_time()))
