"""Every CUDA kernel of the port timed on the card at its main-path shapes,
by device time and beside its host-inclusive times, for the kernel table of
PERF.md and a comparison of two checkouts in one run.

    python3 tests/test_torch/card_kernel_times.py [--root DIR] [--label NAME]

Kernels and shapes (float32, 2**20 rays), as ``chip_smoke.py`` runs them:
K1 ``fused_trace`` on the condenser (6 generations, phase 5); K3
``fused_bwd_loss`` (RmsSpotRadius) and K4 ``fused_bwd`` (seeded record and
final-state cotangents) on the condenser (phase 8); K2
``fused_trace_wide`` on the 16x16 microlens array (4 generations, the
phase-13 grid); K5 ``staged_tail`` (loss mode, zero carried cotangent), K6
``staged_group`` and K7 ``staged_singles`` per generation of a K2 trace
with ``save_fold``, summed over a staged step (phase 13); K8
``fused_bwd_wide`` in loss mode on the 16x16 array with the bench's grid
(phase 14); the table reduce ``row_reduce`` alone on the table one K8 call
fills (phase 15).  Per kernel: ``chip_smoke.kernel_times`` (the profiler's
device time of the kernel and its reduce, back-to-back calls between one
pair of events, one call between two events with the host's work before
its launch inside, the wrapper's host time until it returns) and the
profiler's device time of every kernel the call launched.  The work is
``chip_smoke.kernel_device_times``, the measurement of its phase 1b, alone
in a fresh process.  Prints one JSON line per kernel and a last line with
all of them and the card's name and power limit.  ``--root`` imports
``pyrayt_tpu_torch`` from another checkout (e.g. the parent commit
unpacked under ``build/parent``) and builds its sources; the scenes and the
timing helpers are this checkout's ``chip_smoke.py``.  Needs one CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(ROOT)]
    import chip_smoke as cs  # this checkout's scenes and helpers

    sys.path[:1] = [str(root)]
    import torch

    import pyrayt_tpu_torch as pyrayt
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch import materials as matl
    from pyrayt_tpu_torch.analysis import metrics
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene

    assert Path(ft.__file__).resolve().is_relative_to(root), ft.__file__
    ft.build_kernels()
    times = cs.kernel_device_times(torch, pyrayt, comp, matl, metrics, TraceConfig, fg, ft,
                                   fresh_ids, compile_scene, torch.device("cuda", 0))
    for name, t in times.items():
        print(json.dumps({name: t}), flush=True)
    print(json.dumps({"label": args.label, "root": str(root), "card": cs.card_line(),
                      "kernels": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
