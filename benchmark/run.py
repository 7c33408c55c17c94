"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  It needs the
CUDA cards the cell asks for, draws its inputs from ``--seed``, warms up,
measures a window of ``--seconds`` (closed at the next iteration
boundary), checks the answers against the plain reference under
``benchmark/reference/`` and prints one JSON line last.  ``--trace 1``
prints the cell's per-layer metrics in place of its end-to-end ones.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")

# build and kernel caches at fixed paths inside the checkout; no JAX backend
# for libraries that would load one
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["USE_TF"] = "0"

# imports resolve from the checkout's root, not from this folder
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from benchmark.harness.cell import main as cell_main

    return cell_main(argv, t0=T0, root=ROOT)


if __name__ == "__main__":
    sys.exit(main())
