"""Run one cell of the benchmark of ``repro_torch`` (the PyTorch and CUDA
port) on the card this process is started on.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (a configuration under a traffic mix) is looked up by name in
``BENCHMARK.json``; its files are ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json``, ``bench/limits/<workload>.json`` and one
reader a per-layer metric, ``bench/metrics/<metric>.py``.  The last line of
standard output is the result as one JSON object; the numbers that decide
``correct`` are the last lines of standard error.  ``--smoke --device cpu``
runs the cell at its configuration's smoke sizes on the CPU (the tests).
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# every build and kernel cache at a fixed path inside the checkout, so that
# only a cell's first run in a checkout builds
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / "bench" / _sub)
os.environ["USE_FLAX"] = "0"

sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

from metlbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:]))
