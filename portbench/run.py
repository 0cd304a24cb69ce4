"""Run one benchmark cell once and print its result line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits non-zero, with no result, without the
CUDA devices the cell asks for, when the program cannot be imported, or
when the process has loaded JAX, Flax or the JAX package.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "portbench"
# every compiler cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(BUILD / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
