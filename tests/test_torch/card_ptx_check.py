"""Check the PTX of the port's CUDA kernels for global loads from a
shared array's address folded to 0.

    python3 tests/test_torch/card_ptx_check.py [--csrc DIR]

Compiles each source of ``pyrayt_tpu_torch/csrc`` (or of another copy of it)
to PTX with the flags of ``ops/_cuda.py:build_kernels`` and, per
function, follows every register set by ``add.s64 %rdA, 0, %rdB`` (an
address whose base is the constant 0) through further address arithmetic
to the loads that use it.  nvcc 12.9 at -O3 for sm_90a emitted such
loads, ``ld.global`` of a block's ``extern __shared__`` array with the
array's generic base folded to 0, for two variants of the wide kernels
(K2 with ``__restrict__`` kernel parameters, K7 with ``find_winner``
inlined): both fault with an illegal address on the card.  Prints one line
per source and exits non-zero if any load of that kind is found.  Needs
``nvcc``.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NULL_BASE = re.compile(r"\s*add\.s64\s+(%rd\d+), 0, %rd\d+;")
ARITH = re.compile(r"\s*(?:add|sub|mov|mad|shl|cvt)[\w.]*\s+(%rd\d+),(.*);")
FUNC = re.compile(r"\.(?:entry|func)\s+(?:\([^)]*\)\s*)?([\w$]+)")


def null_based_loads(ptx: str):
    """[(function, load opcode)] of the loads whose address derives from a
    null-based register, within each function."""
    lines = ptx.splitlines()
    starts = [i for i, line in enumerate(lines) if FUNC.search(line)] + [len(lines)]
    found = []
    for s, e in zip(starts, starts[1:]):
        name = FUNC.search(lines[s]).group(1)
        derived = set()
        for line in lines[s:e]:
            m = NULL_BASE.match(line)
            if m:
                derived.add(m.group(1))
                continue
            m = ARITH.match(line)
            if m and any(re.search(re.escape(r) + r"\b", m.group(2)) for r in derived):
                derived.add(m.group(1))
            elif line.lstrip().startswith("ld.") and "[" in line:
                address = line[line.index("["):]
                if any(re.search(re.escape(r) + r"\b", address) for r in derived):
                    found.append((name, line.split()[0]))
    return found


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--csrc", default=str(ROOT / "pyrayt_tpu_torch" / "csrc"))
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from pyrayt_tpu_torch.ops import _cuda

    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in _cuda.KERNEL_SOURCES:
            ptx = Path(tmp) / (Path(name).stem + ".ptx")
            subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                            "-O3", "-ptx", "-o", str(ptx), str(Path(args.csrc) / name)],
                           check=True)
            found = null_based_loads(ptx.read_text())
            kinds = sorted({op for _, op in found})
            functions = sorted({fn for fn, _ in found})
            print(f"{name}: {len(found)} loads from a null-based address {kinds} in "
                  f"{len(functions)} functions", flush=True)
            bad += len(found)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
