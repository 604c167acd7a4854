"""Split the gap between K8 (``ops/fused_grad.py:fused_bwd_wide``) and its
plain version on a wide parity scene ray by ray.

    python3 tests/test_torch/card_wide_ray_split.py [--scene meniscus] [--dtype float32]

Traces the scene's grid (``torch_parity_scenes.WIDE_SCENES``) with the
plain forward, in the given dtype and at float64, then runs K8 and its
plain version in generic mode on each ray alone, with the seeded record
and final-state cotangents of ``test_torch_cuda.py``.  Prints one JSON
line: the card's name and power limit, the largest leaf cotangent, and per
ray whose leaf cotangents (d_objtx, d_prim) part by more than 1e-3 of that
largest entry: its index, the gap, whether its trace follows the float64
path, and per generation its hit surface id and win code in the given
dtype and at float64, and its hit point.  Needs one CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "tests" / "test_torch")]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", default="meniscus")
    parser.add_argument("--dtype", default="float32")
    args = parser.parse_args()
    import torch

    from pyrayt_tpu_torch import interop
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_grad as fg
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from torch_parity_scenes import TORCH_NS, WIDE_SCENES, follows_float64_path, wide_rays

    device, dtype = torch.device("cuda", 0), getattr(torch, args.dtype)
    build, _, _, gens = WIDE_SCENES[args.scene]
    config = TraceConfig(generation_limit=gens, fixed_loop=True)
    with TORCH_NS.fresh_ids():
        scene = TORCH_NS.compile(build(TORCH_NS), device=device, dtype=torch.float64)
    runs = {}
    for dt in (torch.float64, dtype):
        rays = interop.rays_from_numpy(*wide_rays(args.scene), device=device, dtype=dt)
        inputs = ft.wide_kernel_inputs(scene.spec, scene.params, rays)
        runs[dt] = (inputs,) + ft.fused_trace_wide_plain(scene.spec, config, *inputs,
                                                         save_fold=True)
    inputs, rec, masks, _, _, win = runs[dtype]
    _, rec64, masks64, _, _, win64 = runs[torch.float64]
    follows = follows_float64_path(rec, masks, rec64, masks64)
    gen = torch.Generator(device="cpu").manual_seed(11)
    n, g = masks.shape[1], masks.shape[0]
    torch.randn((g, 11, n), generator=gen, dtype=torch.float64)  # the test's carry draw
    d_rec = torch.randn(rec.shape, generator=gen, dtype=torch.float64).to(device, dtype)
    d_rec = d_rec * masks[:, None]
    gen = torch.Generator(device="cpu").manual_seed(13)
    d_fstate = torch.randn(inputs[0].shape, generator=gen, dtype=torch.float64).to(device, dtype)
    gaps, largest = [], 0.0
    for i in range(n):
        one = (inputs[0][:, i:i + 1].contiguous(),) + tuple(inputs[1:])
        kw = dict(d_records=d_rec[..., i:i + 1].contiguous(),
                  d_fstate=d_fstate[:, i:i + 1].contiguous())
        k = fg.fused_bwd_wide(scene.spec, config, *one, rec[..., i:i + 1].contiguous(),
                              masks[:, i:i + 1].contiguous(), **kw)
        p = fg.fused_bwd_wide_plain(scene.spec, config, *one, rec[..., i:i + 1].contiguous(),
                                    masks[:, i:i + 1].contiguous(), **kw)
        gap = max(float((a - b).abs().max()) for a, b in zip(k[:2], p[:2]))
        largest = max(largest, max(float(b.abs().max()) for b in p[:2]))
        gaps.append(gap)
    out = {"scene": args.scene, "dtype": args.dtype, "rays": n, "largest": largest,
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip(), "parted": []}
    for i, gap in enumerate(gaps):
        if gap > 1e-3 * largest:
            out["parted"].append({
                "ray": i, "gap": gap, "follows_float64": bool(follows[i]),
                "surface": rec[:, 5, i].tolist(), "surface_float64": rec64[:, 5, i].tolist(),
                "win": win[:, i].tolist(), "win_float64": win64[:, i].tolist(),
                "hit": rec[:, 9:12, i].tolist()})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
