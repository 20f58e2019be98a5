#!/usr/bin/env python3
"""Two trees of the PyTorch port timed against each other on one CUDA card,
in turns.

    python3 scripts/torch_compare_trees.py OLD NEW [--runs 2]

OLD and NEW are roots of two checkouts of this repository (a parent
commit unpacked with ``git archive`` into a git-ignored directory, and
``.``). The script runs itself in ``--measure`` mode once from the root
of each tree, in turns OLD, NEW, NEW, OLD, each turn in its own process,
so each turn imports its own tree's package and builds its own tree's
kernels from its own ``csrc/``: no wrapper or C signature is copied here.
The timing helpers and the ring come from this script's repository's
``chip_smoke.py`` (``profile_calls``, ``cuda_ms``, ``sweep_tally``,
``cg_matvecs``, ``render_stacks``, ``scan_params``), whose imports of the
port resolve to the tree being measured.

A turn measures:

* ``nearest_one`` and ``matvec_band`` on seeded operands (random keys at
  2048×8192 and 8192×8192, seeded x and W on the sphere band); a digest of
  their outputs, which must be equal in every turn;
* the headline 24-stop 1080p ring through ``scan_stacks_to_cloud`` and
  its merged cloud through ``mesh_360`` at depth 10, once to warm up (which
  keeps the sweeps by shape and the mesh band) and ``--runs`` times timed:
  wall and stage seconds, fine CG iterations and the device time per CG
  iteration;
* ``nearest_one`` at the ring's two most swept shapes and ``matvec_band``
  on the mesh band and the sphere band, on the device (the profiler: every
  kernel a call launches) and a call with its wrapper (CUDA events).

Then per kernel and stage the mean of each tree's turns and their ratio,
and the card's name and power limit. Exits 1 if a turn fails or the two
trees' kernels give different outputs on the seeded operands.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This repository's ``chip_smoke.py``, whatever tree is measured."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(runs: int, dev) -> dict:
    """One turn on ``dev``, from the root of the tree measured (first on
    ``sys.path``)."""
    import numpy as np
    import torch

    cs = _chip_smoke()
    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.kernels import (
        build,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
        scan360,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        nn,
        poisson_matvec as pm,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    t0 = time.perf_counter()
    build.library()
    out = {"tree": os.getcwd(), "build_s": time.perf_counter() - t0,
           "digest": {}, "kernels": {}, "runs": []}

    def timed(label, fn, reps):
        ms, seen = cs.profile_calls(fn, reps)
        out["kernels"][label] = {
            "device_ms": ms, "call_ms": cs.cuda_ms(fn, 2 * reps),
            "kernels_a_call": {k[:40]: v / (2 * reps)
                               for k, v in seen.items()}}

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    for m in (2048, 8192):
        q, kt, p2v, _, _ = cs.nn_operands(dev, g, m, 8192, 0.2)
        out["digest"][f"nearest_one {m}x8192"] = _digest(
            *nn.nearest_one(q, kt, p2v))
        timed(f"nearest_one random {m}x8192", lambda: nn.nearest_one(
            q, kt, p2v), 200)
    _, _, nbr, bv = cs.sphere_band(dev)
    x = torch.randn((nbr.shape[0], 512), device=dev, generator=g)
    W = torch.rand((nbr.shape[0], 512), device=dev, generator=g)
    sphere = (x, W, nbr, bv)
    out["digest"]["matvec_band sphere"] = _digest(pm.matvec_band(*sphere))

    proj = ProjectorConfig()
    stacks, rig, _, _ = cs.render_stacks(cs.N_STOPS, cs.STEP_DEG, proj)
    h, w = stacks.shape[2:]
    calib = make_calibration(*rig, h, w, proj.width, proj.height, device=dev)
    params = cs.scan_params(cs.STEP_DEG)
    for run in range(runs + 1):
        timing, mtiming, stats = {}, {}, {}
        cs._sync(dev)
        # The warm-up run keeps the sweeps by shape; the timed runs do not
        # tally.
        with cs.sweep_tally() if run == 0 else nullcontext({}) as tally:
            t0 = time.perf_counter()
            merged, _ = scan360.scan_stacks_to_cloud(
                stacks, calib, proj.col_bits, proj.row_bits, params=params,
                timing=timing, device=dev)
            cs._sync(dev)
            scan_s = time.perf_counter() - t0
        cloud = PointCloud(points=merged.points.copy(), colors=merged.colors,
                           normals=merged.normals.copy())
        with cs.cg_matvecs(dev) as cg:
            t0 = time.perf_counter()
            meshing.mesh_360(cloud, os.devnull, depth=10, quantile_trim=0.0,
                             cg_iters=100, timing=mtiming, solve_stats=stats,
                             device=dev)
            cs._sync(dev)
            mesh_s = time.perf_counter() - t0
        if run == 0:
            sweeps, band = tally, cg["band"]
            continue
        row = {"scan_wall_s": scan_s, "mesh_wall_s": mesh_s,
               **{f"scan {k}": v for k, v in timing.items()},
               **{f"mesh {k}": v for k, v in mtiming.items()},
               "cg_iters": stats["cg_iters_used"],
               "cg_iteration_ms": cs.cg_iteration_ms(cg["events"]),
               "points": len(merged),
               "checksum": float(np.abs(merged.points).sum())}
        out["runs"].append(row)
        print(f"run {run}: {json.dumps(row)}", flush=True)
    out["sweeps"] = {f"{m}x{n}": c for (m, n), (c, _) in sweeps.items()}
    for (m, n), (count, (q, kt, p2v)) in sorted(
            sweeps.items(), key=lambda kv: -kv[1][0])[:2]:
        timed(f"nearest_one ring sweep {m}x{n}",
              lambda: nn.nearest_one(q, kt, p2v), 200)
    timed("matvec_band mesh band", lambda: pm.matvec_band(*band), 50)
    timed("matvec_band sphere band", lambda: pm.matvec_band(*sphere), 50)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="TREE",
                    help="OLD and NEW: roots of the two trees")
    ap.add_argument("--runs", type=int, default=2,
                    help="timed runs of the ring and mesh a turn")
    ap.add_argument("--measure", action="store_true",
                    help="one turn, from the root of the tree measured")
    args = ap.parse_args()
    if args.measure:
        sys.path.insert(0, os.getcwd())
        import torch

        if not torch.cuda.is_available():
            print("FAIL: this script needs a CUDA card", flush=True)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("turn " + json.dumps(measure(args.runs,
                                           torch.device("cuda", 0))),
              flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees, OLD and NEW")
    old, new = (os.path.abspath(t) for t in args.trees)
    turns = []
    for which, tree in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure",
             "--runs", str(args.runs)], cwd=tree, capture_output=True,
            text=True, timeout=1800)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        got = [line for line in proc.stdout.splitlines()
               if line.startswith("turn ")]
        if proc.returncode != 0 or not got:
            print(f"FAIL: the turn in {tree} exited {proc.returncode}",
                  flush=True)
            return 1
        turns.append(dict(json.loads(got[-1][len("turn "):]), which=which))

    def mean(which, get):
        vals = [get(t) for t in turns if t["which"] == which]
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else float("nan")

    for label in turns[0]["kernels"]:
        for key in ("device_ms", "call_ms"):
            per = [t["kernels"].get(label, {}).get(key) for t in turns]
            o = mean("old", lambda t: t["kernels"].get(label, {}).get(key))
            n = mean("new", lambda t: t["kernels"].get(label, {}).get(key))
            print(f"{label}, {key}: turns old/new/new/old "
                  + ", ".join("nan" if v is None else f"{v:.4f}"
                              for v in per)
                  + f"; mean old {o:.4f}, new {n:.4f}, old/new {o / n:.3f}",
                  flush=True)
        print(f"{label}, kernels a call: old "
              f"{turns[0]['kernels'].get(label, {}).get('kernels_a_call')}, "
              f"new {turns[1]['kernels'].get(label, {}).get('kernels_a_call')}",
              flush=True)
    for key in turns[0]["runs"][0]:
        per = [[round(r[key], 4) for r in t["runs"]] for t in turns]
        o = mean("old", lambda t: sum(r[key] for r in t["runs"])
                 / len(t["runs"]))
        n = mean("new", lambda t: sum(r[key] for r in t["runs"])
                 / len(t["runs"]))
        print(f"{key}: turns old/new/new/old {per}; mean old {o:.4f}, new "
              f"{n:.4f}", flush=True)
    print(f"sweeps by shape: old {turns[0]['sweeps']}, new "
          f"{turns[1]['sweeps']}", flush=True)
    same = all(t["digest"] == turns[0]["digest"] for t in turns)
    print(f"kernel outputs on the seeded operands equal in every turn: "
          f"{same} ({turns[0]['digest']})", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
