"""Pull out the rays where the wide kernel K2 and its plain version disagree
at float32 on the heterogeneous lens wall (chip_smoke.py phase 9: 61
leaves, 2**20 grid rays, 4 generations), for a replay on the CPU.

    python3 tests/test_torch/card_wide_witness.py

Traces the wall with ``fused_trace_wide`` and ``fused_trace_wide_plain``
(``save_fold``) at float32 and float64 on the card, takes the rays whose
masked records differ by more than chip_smoke's ATOL32 (or whose masks or
win codes differ), and writes per ray its input state at both precisions
and both sides' records, masks, fold and win codes, plus the float32 scene
tables, to ``chiprun_out/witness/hetero_f32.json``.  Needs one CUDA
device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MAX_RAYS = 16
OUT = ROOT / "chiprun_out" / "witness" / "hetero_f32.json"


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from pyrayt_tpu_torch import components as comp
    from pyrayt_tpu_torch import materials as matl
    from pyrayt_tpu_torch.config import TraceConfig
    from pyrayt_tpu_torch.ops import fused_trace as ft
    from pyrayt_tpu_torch.scene import fresh_ids
    from pyrayt_tpu_torch.scene.compile import compile_scene

    device = torch.device("cuda", 0)
    config = TraceConfig(generation_limit=cs.MLA_GENERATIONS)
    source = comp.GridOfRays(20 * 2.6 * 0.95, 1.0).move_x(-1.5)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        with fresh_ids():
            scene = compile_scene(cs.hetero_wall(comp, matl), device=device, dtype=dtype)
        rays = source.generate_rays(cs.N_RAYS, device=device, dtype=dtype)
        inputs = ft.wide_kernel_inputs(scene.spec, scene.params, rays)
        kernel = ft.fused_trace_wide(scene.spec, config, *inputs, save_fold=True)
        plain = ft.fused_trace_wide_plain(scene.spec, config, *inputs, save_fold=True)
        torch.cuda.synchronize()
        runs[dtype] = (inputs, kernel, plain)

    inputs, (k_rec, k_mask, _, k_fold, k_win), (p_rec, p_mask, _, p_fold, p_win) = \
        runs[torch.float32]
    agree = (k_mask == p_mask).all(dim=0) & (k_win == p_win).all(dim=0)
    live = (k_mask & agree[None]).unsqueeze(1)
    diff = torch.where(live, (k_rec - p_rec).abs(), 0.0)
    bad = ((diff > cs.ATOL32).any(dim=0).any(dim=0) | ~agree).nonzero().squeeze(1)
    print(f"float32: {bad.numel()} of {k_mask.shape[1]} rays outside {cs.ATOL32} or with other "
          f"masks or win codes; max difference {float(diff.max())!r}", flush=True)

    def column(t, i):
        return t[..., i].cpu().tolist()

    f32, f64 = runs[torch.float32], runs[torch.float64]
    sides = {"kernel_f32": f32[1], "plain_f32": f32[2], "kernel_f64": f64[1], "plain_f64": f64[2]}
    rays = []
    for i in bad[:MAX_RAYS].tolist():
        ray = {"index": i, "state_f32": column(f32[0][0], i), "state_f64": column(f64[0][0], i)}
        for side, (rec, mask, _, fold, win) in sides.items():
            ray[side] = {"records": column(rec, i), "masks": column(mask, i),
                         "fold5": column(fold, i), "win": column(win, i)}
        rays.append(ray)
        print(json.dumps({"index": i, "surfaces": {side: [row[5] for row in ray[side]["records"]]
                                                   for side in sides}}), flush=True)
    state0, obj_tx, prim, glass, slots, aabb = inputs[:6]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({
        "outside": bad.numel(), "rays": rays,
        "tables_f32": {"obj_tx": obj_tx.cpu().tolist(), "prim": prim.cpu().tolist(),
                       "glass": glass.cpu().tolist(), "slots": slots.cpu().tolist(),
                       "aabb": aabb.cpu().tolist()},
    }))
    print(f"wrote {OUT}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
