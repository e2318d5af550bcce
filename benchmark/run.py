"""Run one cell of the benchmark of the port (``mg_gcn_tpu_torch``) and print
its result as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. The cells are in
``BENCHMARK.json``; see ``benchmark/harness/runner.py`` for what one run
does. It needs as many CUDA cards as the cell asks for, and exits with
code 1, printing no result, without them.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port builds its kernels into mg_gcn_tpu_torch/_build/, inside the checkout
sys.path.insert(0, ROOT)

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
