"""Run one cell of the rescan benchmark once.

    python3 scanbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

prints the result as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its
limit. Needs a CUDA card; it runs on cuda:0 alone.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place in the checkout
_CACHE = os.path.join(ROOT, ".scanbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from scanbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return harness.main(ap.parse_args(argv), T0)


if __name__ == "__main__":
    sys.exit(main())
