"""Run one cell of the benchmark of ``pyrayt_tpu_torch`` on the CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as its last line on standard output,
one JSON object (correct, attempted, failed, metrics, device, and with
``--trace 1`` a breakdown), and each compared number beside its limit as
its last lines on standard error.  Exits non-zero without a result when
the cell's CUDA devices are absent, and never runs on the CPU.
"""

import argparse
import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (Linux: from
    /proc; elsewhere the first line of this script)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout (the
    # program's own kernels build into build/torch_kernels beside them)
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    # one process with one intra-op thread: the host work is Python and small
    # ops, and with the default pool the doublet's steps ran about 7% slower
    # on the card's shared host cores
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    sys.path.insert(0, ROOT)
    from benchmark.harness import runner

    return runner.main(args, PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
