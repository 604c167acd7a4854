"""Split the gap between the wide backward kernels K8
(``ops/fused_grad.py:fused_bwd_wide``) and K6 (``staged_group``) and their
plain versions on a wide parity scene ray by ray, and hold each ray that
parts against the plain version at float64.

    python3 tests/test_torch/card_wide_ray_split.py [--scene meniscus] [--dtype float32]

Traces the scene's grid (``torch_parity_scenes.WIDE_SCENES``) with the
plain forward, in the given dtype and at float64, then runs K8 and its
plain version in generic mode on each ray alone, with the seeded record
and final-state cotangents of ``test_torch_cuda.py``, K6 and its plain
version on each ray and generation alone, with the seeded carry of
``test_staged_fold_matches_plain``, and K2 (with save_fold) on each
generation's input state rebuilt from the plain records.  A ray parts
when its leaf cotangents (d_objtx, d_prim) differ by more than 1e-3 of the
largest entry.  For each such ray it records the leaf rows that are
nonzero in the kernel's, the plain version's and the float64 plain
version's cotangents (the float64 trace's records and the same cotangent
draws), whether its trace follows the float64 path, per generation its
hit surface, win code, hit point and the endpoint that gives its hit
distance (leaf, hit code, the discriminant relative to b^2 where a
quadratic root gives it) at either precision, and per generation K6's
gap, the plain fold (distance, normal, material slot) and win code beside
K2's.  Prints one JSON line with the card's name and power limit, the
largest leaf cotangents and a summary per parted ray; writes everything to
``chiprun_out/wide_ray_split_<scene>_<dtype>.json``.  Needs one CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "tests" / "test_torch")]

CODE_NAMES = {0: "C_PLUS", 1: "C_MINUS", 2: "C_LINEAR", 3: "C_SLAB_LO", 4: "C_SLAB_HI",
              5: "C_PLANE"}


def endpoints(kind, pr, o, d):
    """[(code, distance, discriminant / b^2 or None)] of one leaf's
    intersector formulas for the local ray (o, d), in float64 (the
    conventions of csrc/trace_common.cuh; cube faces are left out)."""
    out = []
    if kind in (0, 4):  # sphere, cylinder: the quadratic's roots
        k = 3 if kind == 0 else 2
        a, b = float(d[:k] @ d[:k]), 2.0 * float(d[:k] @ o[:k])
        c = float(o[:k] @ o[:k]) - pr[0] ** 2
        disc = b * b - 4 * a * c
        rel = disc / (b * b) if b else None
        if kind == 4 and abs(a) <= 1e-8:
            if abs(b) > 1e-8:
                out.append((2, -c / b, None))
        elif disc >= 0:
            root = np.sqrt(disc)
            out += [(0, (-b + root) / (2 * a), rel), (1, (-b - root) / (2 * a), rel)]
        if kind == 4 and abs(d[2]) > 1e-8:
            out += [(3, (pr[1] - o[2]) / d[2], None), (4, (pr[2] - o[2]) / d[2], None)]
    elif kind == 2 and abs(d[2]) > 1e-8:  # plane
        out.append((5, -o[2] / d[2], None))
    return out


def hit_endpoint(spec, obj_tx, prim, rec, g, i):
    """The leaf endpoint nearest to generation g's hit distance of ray i:
    {leaf, code, disc_rel, gap}, or None when the ray did not hit."""
    p, ph, v = rec[g, 6:9, i], rec[g, 9:12, i], rec[g, 12:15, i]
    t = float(np.linalg.norm(ph - p))
    best = None
    for s, kind in enumerate(spec.leaf_types):
        m = obj_tx[s].reshape(4, 4)
        o, d = m[:3, :3] @ p + m[:3, 3], m[:3, :3] @ v
        for code, dist, rel in endpoints(kind, prim[s], o, d):
            if best is None or abs(dist - t) < best["gap"]:
                best = {"leaf": s, "code": CODE_NAMES[code], "disc_rel": rel,
                        "gap": abs(dist - t), "t": t}
    return best


def leaf_rows(outs, labels):
    """{leaf: {label: 22 values (d_objtx row, d_prim row)}} for the leaves
    nonzero in any of ``outs`` (each (d_objtx, d_prim, ...))."""
    rows = {}
    stacked = [np.concatenate((o[0].double().cpu().numpy(), o[1].double().cpu().numpy()), axis=1)
               for o in outs]
    for s in range(stacked[0].shape[0]):
        if any(np.any(x[s] != 0) for x in stacked):
            rows[s] = {label: x[s].tolist() for label, x in zip(labels, stacked)}
    return rows


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
    spec = scene.spec
    n_groups = len(ft.engine.wide_plan(spec)[1])
    runs = {}
    for dt in (torch.float64, dtype):
        rays = interop.rays_from_numpy(*wide_rays(args.scene), device=device, dtype=dt)
        inputs = ft.wide_kernel_inputs(spec, scene.params, rays)
        rec, masks, _, fold5, win = ft.fused_trace_wide_plain(spec, config, *inputs, save_fold=True)
        # the cotangent draws of test_torch_cuda.py: staged_inputs (seed 11:
        # carry, then d_rec) and test_wide_fused_bwd_matches_plain (seed 13)
        gen = torch.Generator(device="cpu").manual_seed(11)
        n, g = masks.shape[1], masks.shape[0]
        carry = torch.randn((g, 11, n), generator=gen, dtype=torch.float64).to(device, dt)
        d_rec = torch.randn(rec.shape, generator=gen, dtype=torch.float64).to(device, dt)
        d_rec = d_rec * masks[:, None]
        gen = torch.Generator(device="cpu").manual_seed(13)
        d_fstate = torch.randn(inputs[0].shape, generator=gen, dtype=torch.float64).to(device, dt)
        bufs = [fg.staged_tail_plain(spec, config, inputs[0], rec[k], masks[k],
                                     masks[k - 1] if k else None, fold5[k], inputs[3], carry[k],
                                     d_rec=d_rec[k])[0] for k in range(g)]
        # K2's fold of each generation's input state (rebuilt from the plain
        # records, as the backward kernels rebuild it)
        one = TraceConfig(generation_limit=1, fixed_loop=True)
        refold = [ft.fused_trace_wide(spec, one, fg._wide_input_state(
            inputs[0], rec[k], masks[k - 1] if k else None)[0].contiguous(), *inputs[1:],
            save_fold=True)[3:] for k in range(g)]
        runs[dt] = dict(inputs=inputs, rec=rec, masks=masks, win=win, d_rec=d_rec,
                        d_fstate=d_fstate, bufs=bufs, fold5=fold5, refold=refold)

    def k8_ray(run, i, kernel):
        inputs = run["inputs"]
        one = (inputs[0][:, i:i + 1].contiguous(),) + tuple(inputs[1:])
        kw = dict(d_records=run["d_rec"][..., i:i + 1].contiguous(),
                  d_fstate=run["d_fstate"][:, i:i + 1].contiguous())
        fn = fg.fused_bwd_wide if kernel else fg.fused_bwd_wide_plain
        return fn(spec, config, *one, run["rec"][..., i:i + 1].contiguous(),
                  run["masks"][:, i:i + 1].contiguous(), **kw)

    def k6_gen(run, i, k, kernel):
        """K6's (d_objtx, d_prim) of ray i in generation k."""
        _, obj_tx, prim, _, slots = run["inputs"][:5]
        fn = fg.staged_group if kernel else fg.staged_group_plain
        total = None
        for gi in range(n_groups):
            out = fn(spec, gi, run["bufs"][k][:, i:i + 1].contiguous(),
                     run["win"][k][i:i + 1].contiguous(), obj_tx, prim, slots)[:2]
            total = out if total is None else tuple(a + b for a, b in zip(total, out))
        return total

    def k6_ray(run, i, kernel):
        """K6's (d_objtx, d_prim) of ray i summed over the generations."""
        outs = [k6_gen(run, i, k, kernel) for k in range(len(run["bufs"]))]
        return tuple(sum(parts) for parts in zip(*outs))

    low, hi = runs[dtype], runs[torch.float64]
    follows = follows_float64_path(low["rec"], low["masks"], hi["rec"], hi["masks"])
    n = low["masks"].shape[1]
    gaps = {"k8": [], "k6": []}
    largest = {"k8": 0.0, "k6": 0.0}
    for i in range(n):
        for name, fn in (("k8", k8_ray), ("k6", k6_ray)):
            k, p = fn(low, i, True), fn(low, i, False)
            gaps[name].append(max(float((a - b).abs().max()) for a, b in zip(k[:2], p[:2])))
            largest[name] = max(largest[name], max(float(b.abs().max()) for b in p[:2]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    full = {"scene": args.scene, "dtype": args.dtype, "rays": n, "largest": largest, "card": card,
            "parted": []}
    tables = {dt: (run["inputs"][1].double().cpu().numpy(), run["inputs"][2].double().cpu().numpy(),
                   run["rec"].double().cpu().numpy()) for dt, run in runs.items()}
    for i in range(n):
        parted = [name for name in gaps if gaps[name][i] > 1e-3 * largest[name]]
        if not parted:
            continue
        entry = {"ray": i, "parted": parted, "gap_k8": gaps["k8"][i], "gap_k6": gaps["k6"][i],
                 "follows_float64": bool(follows[i]),
                 "surface": low["rec"][:, 5, i].tolist(),
                 "surface_float64": hi["rec"][:, 5, i].tolist(),
                 "win": low["win"][:, i].tolist(), "win_float64": hi["win"][:, i].tolist(),
                 "hit": low["rec"][:, 9:12, i].tolist()}
        for name, fn in (("k8", k8_ray), ("k6", k6_ray)):
            outs = (fn(low, i, True), fn(low, i, False), fn(hi, i, False))
            entry[f"{name}_leaves"] = leaf_rows(outs, ("kernel", "plain", "plain_float64"))
            kern, plain, p64 = (np.concatenate([t.double().cpu().numpy().ravel() for t in o[:2]])
                                for o in outs)
            entry[f"{name}_kernel_minus_float64"] = float(np.abs(kern - p64).max())
            entry[f"{name}_plain_minus_float64"] = float(np.abs(plain - p64).max())
        entry["per_generation"] = [{
            "k6_gap": max(float((a - b).abs().max()) for a, b in zip(
                k6_gen(low, i, k, True), k6_gen(low, i, k, False))),
            "plain_fold": low["fold5"][k][:, i].tolist(), "plain_win": int(low["win"][k][i]),
            "k2_fold": low["refold"][k][0][0, :, i].tolist(),
            "k2_win": int(low["refold"][k][1][0, i])} for k in range(gens)]
        entry["endpoints"] = {
            str(dt).replace("torch.", ""): [
                hit_endpoint(spec, obj, prim, rec, k, i) if bool(runs[dt]["masks"][k, i]) else None
                for k in range(gens)]
            for dt, (obj, prim, rec) in tables.items()}
        full["parted"].append(entry)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"wide_ray_split_{args.scene}_{args.dtype}.json").write_text(json.dumps(full))
    summary = dict(full, parted=[
        {key: e[key] for key in ("ray", "parted", "gap_k8", "gap_k6", "follows_float64",
                                 "k8_kernel_minus_float64", "k8_plain_minus_float64",
                                 "k6_kernel_minus_float64", "k6_plain_minus_float64",
                                 "per_generation")}
        for e in full["parted"]])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
