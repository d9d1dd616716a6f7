"""The benchmark of octree_pathtracing_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds the port.  The cells are the
``workloads`` of ``BENCHMARK.json``; ``PERF.md`` says what each measures.
The run fails, printing no result, where the CUDA cards the cell asks for
are missing.  Every build and cache stays in fixed directories of the
checkout: the port's kernels in ``build/kernels``, its scenes in
``build/scenes``, the reference's scenes in ``benchmark/cache``.
"""

import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
