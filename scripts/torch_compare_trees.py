#!/usr/bin/env python3
"""Two trees of the PyTorch port timed against each other on one CUDA card,
in turns.

    python3 scripts/torch_compare_trees.py OLD NEW [--runs 2]
        [--paths ring,splat,cleanup,fused,poisson1m,dense]

OLD and NEW are roots of two checkouts of this repository (a parent
commit unpacked with ``git archive`` into a git-ignored directory, and
``.``). The script runs itself in ``--measure`` mode once from the root
of each tree, in turns OLD, NEW, NEW, OLD, each turn in its own process,
so each turn imports its own tree's package and builds its own tree's
kernels from its own ``csrc/``: no wrapper or C signature is copied here.
The timing helpers, the ring and the scenes come from this script's
repository's ``chip_smoke.py`` (``profile_calls``, ``cuda_ms``,
``sweep_tally``, ``cg_matvecs``, ``corner_phases``, ``phase_timing``,
``render_stacks``, ``render_stop``, ``scan_params``, ``headline_params``,
``splat_params``, ``heldout_view``), whose imports of the port resolve to
the tree being measured.

A turn measures, on the device (the profiler: every kernel a call
launches) and as a call with its wrapper (CUDA events):

* always, on seeded operands: ``nearest_one`` (random keys at 2048×8192
  and 8192×8192), ``matvec_band`` (seeded x and W on the sphere band) and
  ``brick_knn_cells`` (bench 3b's 2²⁰-point cylinder, k = 20,
  ``exclude_self``); a digest of every output, which must be equal in
  every turn;
* ``ring``: the headline 24-stop 1080p ring through
  ``scan_stacks_to_cloud`` and its merged cloud through ``mesh_360`` at
  depth 10, once to warm up (which keeps the sweeps by shape and the mesh
  band) and ``--runs`` times timed: wall and stage seconds, fine CG
  iterations and the device time per CG iteration; then ``nearest_one``
  at the ring's two most swept shapes and ``matvec_band`` on the mesh band
  and the sphere band (with a digest of the mesh band's operands: x₀, W,
  the neighbour table, validity); then the classify phase
  (``marching_device._phase_corners``) on the mesh's own band (kept in the
  warm-up run) and on the sphere band at iso 0: a digest of its frame,
  mask and count, its device time, its classify kernel's, a call's, the
  plain phase's pieces apart and its peak device memory
  (``chip_smoke.phase_timing``);
* ``splat``: bench config 12 on the same ring (stops 0–22 through a
  ``"splat"`` session, ``ensure_scene``), then ``--runs`` sweeps of 20
  views at 384×288, each view's wall (the median is the end-to-end line);
  then ``composite_cells`` on the records of sweep view 0 and of held-out
  stop 23's view, with digests;
* ``cleanup``: one walled 1080p stop through reconstruct → PLY out and
  back → ``remove_background`` → ``remove_outliers`` →
  ``reconstruct_stl`` at depth 10, once to warm up (which keeps the brick
  kernel's two inputs) and ``--runs`` times timed; then
  ``brick_knn_cells`` on those two inputs, with digests;
* ``fused``: bench config 2's ring at ``stop_chunk=3`` — in a tree whose
  ``Scan360Params`` has ``fused``, config 2 as written on device-resident
  stacks (the batched ring); in an older tree, its multi-launch path on
  host stacks (the hint-chained loop ring) — once to warm up and
  ``--runs`` times timed: wall, stage seconds (``register_s`` is the
  ring's), ``nearest_one`` launches and points.
* ``poisson1m``: bench config 3c, the 2²⁰-point noisy cylinder's normals
  (k = 12, oriented outward from (0, 0, 500)) and its depth-10 band solve
  (``"additive"``, ``cg_iters=100``, 196,608 block slots), once to warm
  up and ``--runs`` times timed: wall, stage seconds (``setup_s``,
  ``coarse_s``, ``fine_cg_s``, ``iso_s``), fine iterations and blocks;
  digests of the normals, of the band (block coordinates, validity,
  neighbour table) and of χ.
* ``dense``: the one-card dense solve (``poisson.reconstruct``) on a
  seeded cylinder with estimated normals: the streaming preview's (8,192
  points, depth 6, ``cg_iters=60``) cold and warm-started from the
  preview of every other point, and depth 7 and 8 cold solves of 2¹⁶
  points (``cg_iters=300``), once to warm up and ``--runs`` times timed:
  each solve's wall and iterations; digests of each χ.

Then per kernel and stage the mean of each tree's turns and their ratio,
and the card's name and power limit. Exits 1 if a turn fails or the two
trees' kernels give different outputs (any digest differs; the mesh band's
classify digest only where both trees' rings give the same cloud, since
that band is built from it).
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


PATHS = ("ring", "splat", "cleanup", "fused", "poisson1m", "dense")


def measure(runs: int, dev, paths=PATHS) -> dict:
    """One turn on ``dev``, from the root of the tree measured (first on
    ``sys.path``), over the named ``paths``."""
    import torch

    cs = _chip_smoke()
    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.kernels import (
        build,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        brickknn_kernel as bk,
        nn,
        poisson_matvec as pm,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    t0 = time.perf_counter()
    build.library()
    out = {"tree": os.getcwd(), "build_s": time.perf_counter() - t0,
           "digest": {}, "kernels": {}, "runs": {}, "phases": {}}

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
    timed("matvec_band sphere band", lambda: pm.matvec_band(*sphere), 50)
    del x, W, sphere
    pts = torch.from_numpy(cs.cylinder_cloud(cs.BRICK_N, 0)).to(dev)
    bricks = bk.kernel_inputs(pts, torch.ones(len(pts), dtype=torch.bool,
                                              device=dev), 20, 140,
                              len(pts) // 8 + 1024)[:3]
    out["digest"]["brick_knn_cells 2^20 cylinder"] = _digest(
        *bk.brick_knn_cells(*bricks, 20, True))
    timed("brick_knn_cells 2^20 cylinder k=20",
          lambda: bk.brick_knn_cells(*bricks, 20, True), 20)
    del pts, bricks

    proj = ProjectorConfig()
    if "ring" in paths or "splat" in paths or "fused" in paths:
        stacks, rig, _, _ = cs.render_stacks(cs.N_STOPS, cs.STEP_DEG, proj)
        h, w = stacks.shape[2:]
        calib = make_calibration(*rig, h, w, proj.width, proj.height,
                                 device=dev)
    if "ring" in paths:
        ring_paths(out, runs, dev, cs, stacks, calib, proj, timed)
    if "fused" in paths:
        fused_ring(out, runs, dev, cs, stacks, calib, proj)
    if "splat" in paths:
        splat_path(out, runs, dev, cs, stacks, calib, proj, timed)
        del stacks
    if "cleanup" in paths:
        cleanup_path(out, runs, dev, cs, proj, timed)
    if "poisson1m" in paths:
        poisson1m_path(out, runs, dev, cs)
    if "dense" in paths:
        dense_path(out, runs, dev, cs)
    return out


def ring_paths(out, runs, dev, cs, stacks, calib, proj, timed) -> None:
    """The 360° ring and its mesh, warm-up + ``runs`` timed runs, then the
    nearest-one and matvec kernels on the path's own operands, and the
    classify phase on the mesh's band (kept in the warm-up run) and on the
    sphere band."""
    import numpy as np
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
        scan360,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        marching_device as md,
        nn,
        poisson_matvec as pm,
    )

    params = cs.scan_params(cs.STEP_DEG)
    out["runs"]["ring"] = []
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
        with cs.cg_matvecs(dev) as cg, cs.corner_phases() as corners:
            t0 = time.perf_counter()
            meshing.mesh_360(cloud, os.devnull, depth=10, quantile_trim=0.0,
                             cg_iters=100, timing=mtiming, solve_stats=stats,
                             device=dev)
            cs._sync(dev)
            mesh_s = time.perf_counter() - t0
        if run == 0:
            sweeps, band, mesh_band = tally, cg["band"], corners["band"]
            out["digest"]["operands mesh band"] = _digest(*band)
            continue
        row = {"scan_wall_s": scan_s, "mesh_wall_s": mesh_s,
               **{f"scan {k}": v for k, v in timing.items()},
               **{f"mesh {k}": v for k, v in mtiming.items()},
               "cg_iters": stats["cg_iters_used"],
               "cg_iteration_ms": cs.cg_iteration_ms(cg["events"]),
               "points": len(merged),
               "checksum": float(np.abs(merged.points).sum())}
        out["runs"]["ring"].append(row)
        print(f"ring run {run}: {json.dumps(row)}", flush=True)
    out["sweeps"] = {"x".join(map(str, k)): c
                     for k, (c, _) in sweeps.items()}
    for k, (count, (q, kt, p2v)) in sorted(
            sweeps.items(), key=lambda kv: -kv[1][0])[:2]:
        timed(f"nearest_one ring sweep {'x'.join(map(str, k))}",
              lambda: nn.nearest_one(q, kt, p2v), 200)
    timed("matvec_band mesh band", lambda: pm.matvec_band(*band), 50)
    del band
    rhs, _, nbr, bv = cs.sphere_band(dev)
    for label, (chi, nb, v, iso) in (
            ("mesh band", mesh_band),
            ("sphere band", (rhs, nbr, bv, torch.zeros((), device=dev)))):
        c9, active, count = md._phase_corners(chi, nb, v, iso)
        out["digest"][f"classify phase {label}"] = _digest(c9, active, count)
        del c9, active, count
        out["phases"][label] = cs.phase_timing(chi, nb, v, iso, label)


def fused_ring(out, runs, dev, cs, stacks, calib, proj) -> None:
    """Config 2's ring, warm-up + ``runs`` timed runs: config 2 as written
    (``chip_smoke.headline_params``, stacks staged to the device untimed)
    where the tree has the fused form, else the tree's multi-launch path at
    the same settings on host stacks."""
    import dataclasses

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        scan360,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import nn

    if "fused" in {f.name for f in dataclasses.fields(scan360.Scan360Params)}:
        form, params = "fused", cs.headline_params(cs.STEP_DEG)
        st = torch.from_numpy(stacks).to(dev)
    else:
        form, st = "loop", stacks
        params = dataclasses.replace(cs.scan_params(cs.STEP_DEG),
                                     stop_chunk=3)
    out["fused_form"] = form
    out["runs"]["fused"] = []
    for run in range(runs + 1):
        timing = {}
        cs._sync(dev)
        nn.nearest_one.launches = 0
        t0 = time.perf_counter()
        merged, _ = scan360.scan_stacks_to_cloud(
            st, calib, proj.col_bits, proj.row_bits, params=params,
            timing=timing, device=dev)
        cs._sync(dev)
        wall = time.perf_counter() - t0
        if run == 0:
            continue
        row = {"wall_s": wall,
               **{k: v for k, v in timing.items() if k.endswith("_s")},
               "nearest_one_launches": nn.nearest_one.launches,
               "points": len(merged)}
        out["runs"]["fused"].append(row)
        print(f"fused run {run} ({form}): {json.dumps(row)}", flush=True)


def splat_path(out, runs, dev, cs, stacks, calib, proj, timed) -> None:
    """Bench config 12: stops 0–22 through a splat session, the scene
    built, ``runs`` sweeps of 20 views (each view's wall), then the
    composite on the records of sweep view 0 and the held-out view."""
    import statistics

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_composite as sc,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_render as sr,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        IncrementalSession,
    )

    sp = cs.splat_params(merge.MergeParams(voxel_size=3.0,
                                           final_max_points=131_072,
                                           step_deg=cs.STEP_DEG))
    sess = IncrementalSession(calib, proj.col_bits, proj.row_bits, params=sp,
                              scan_id="compare-splat", device=dev)
    for k in range(cs.HELD_OUT):
        sess.add_stop(stacks[k])
    mesher = sess.previewer
    t0 = time.perf_counter()
    scene = mesher.ensure_scene()
    cs._sync(dev)
    build_s = time.perf_counter() - t0
    img = mesher.render_image(0.0, 20.0)                 # untimed warm-up
    out["runs"]["splat"] = []
    for run in range(runs):
        per_view = []
        for i in range(cs.SPLAT_SWEEP):
            t0 = time.perf_counter()
            mesher.render_image(360.0 * i / cs.SPLAT_SWEEP, 20.0)
            per_view.append(time.perf_counter() - t0)
        row = {"view_median_s": statistics.median(per_view),
               "view_min_s": min(per_view), "view_max_s": max(per_view),
               "ensure_scene_s": build_s, "splats": scene.n_splats}
        out["runs"]["splat"].append(row)
        print(f"splat run {run}: {json.dumps(row)}", flush=True)
    h_cam, h_cfg, _, _ = cs.heldout_view(sess, stacks[cs.HELD_OUT], calib,
                                         proj, cs.HELD_OUT)
    s_cfg = sr.RenderConfig(width=img.shape[1], height=img.shape[0])
    for label, cam, cfg in (
            ("sweep view 0", scene.camera(0.0, 20.0, s_cfg.width,
                                          s_cfg.height), s_cfg),
            (f"held-out stop {cs.HELD_OUT}", h_cam, h_cfg)):
        recs, x0, y0 = sr._tile_records(
            scene.means, scene.normals, scene.log_scales, scene.colors_sh,
            scene.opacity, scene.valid, *sr.camera_tensors(cam, dev), cfg)
        out["digest"][f"composite_cells {label}"] = _digest(
            *sc.composite(*recs, x0, y0, cfg.tile))
        timed(f"composite_cells {label}",
              lambda: sc.composite(*recs, x0, y0, cfg.tile), 200)


def cleanup_path(out, runs, dev, cs, proj, timed) -> None:
    """One walled 1080p stop through the cleanup path to a depth-10 STL,
    warm-up + ``runs`` timed runs; then the brick kernel on the path's own
    two inputs (kept in the warm-up run)."""
    import tempfile

    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        read_ply,
        write_ply,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
        meshing,
        pipeline,
        synthetic,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        brickknn_kernel as bk,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    h, w = proj.height, proj.width
    rig = synthetic.default_calibration(h, w, proj)
    stack = cs.render_stop(synthetic.rotated_scene(cs.headline_scene(700.0),
                                                   0.0), rig, h, w, proj)
    calib = make_calibration(*rig, h, w, proj.width, proj.height, device=dev)
    real = bk.brick_knn_cells
    kept = []

    def keep(bricks, nbr, nnb, k, exclude_self):
        kept.append((bricks, nbr, nnb, k, exclude_self))
        return real(bricks, nbr, nnb, k, exclude_self)

    keep.launches = 0   # the wrapper counts through its module's name

    out["runs"]["cleanup"] = []
    with tempfile.TemporaryDirectory() as tmp:
        for run in range(runs + 1):
            bk.brick_knn_cells = keep if run == 0 else real
            cs._sync(dev)
            t0 = time.perf_counter()
            cloud = pipeline.to_point_cloud(pipeline.reconstruct(
                stack, calib, proj.col_bits, proj.row_bits, device=dev))
            write_ply(os.path.join(tmp, "stop.ply"), cloud)
            cloud = read_ply(os.path.join(tmp, "stop.ply"))
            bg = merge.remove_background(cloud, device=dev)
            clean = merge.remove_outliers(bg, device=dev)
            mesh = meshing.reconstruct_stl(clean, os.path.join(tmp, "m.stl"),
                                           depth=10, device=dev)
            cs._sync(dev)
            wall = time.perf_counter() - t0
            bk.brick_knn_cells = real
            if run == 0:
                continue
            row = {"cleanup_wall_s": wall, "points": len(clean),
                   "faces": len(mesh.faces)}
            out["runs"]["cleanup"].append(row)
            print(f"cleanup run {run}: {json.dumps(row)}", flush=True)
    for bricks, nbr, nnb, k, excl in kept:
        label = f"brick_knn_cells cleanup {bricks.shape[0]} cells k={k}"
        out["digest"][label] = _digest(*real(bricks, nbr, nnb, k, excl))
        timed(label, lambda: real(bricks, nbr, nnb, k, excl), 20)


def poisson1m_path(out, runs, dev, cs) -> None:
    """Bench config 3c (``bench.py:1183-1228``): the cylinder's normals and
    its depth-10 band solve, warm-up + ``runs`` timed runs."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        pointcloud,
        poisson_sparse,
    )

    cyl = torch.from_numpy(cs.cylinder_cloud(1 << 20, 0)).to(dev)
    nrm = pointcloud.estimate_normals(cyl, k=12)[0]
    nrm = pointcloud.orient_normals(
        cyl, nrm, torch.tensor([0.0, 0.0, 500.0], device=dev), outward=True)
    out["digest"]["3c normals"] = _digest(nrm)
    out["runs"]["poisson1m"] = []
    for run in range(runs + 1):
        timing = {}
        cs._sync(dev)
        t0 = time.perf_counter()
        grid, nb, stats = poisson_sparse.reconstruct_sparse(
            cyl, nrm, depth=10, cg_iters=100, max_blocks=196_608,
            with_stats=True, timing=timing)
        cs._sync(dev)
        wall = time.perf_counter() - t0
        if run == 0:
            out["digest"]["3c band"] = _digest(
                grid.block_coords, grid.block_valid, grid.nbr)
            out["digest"]["3c chi"] = _digest(grid.chi)
            continue
        row = {"wall_s": wall, **timing,
               "cg_iters": stats["cg_iters_used"], "blocks": nb}
        out["runs"]["poisson1m"].append(row)
        print(f"poisson1m run {run}: {json.dumps(row)}", flush=True)


def dense_path(out, runs, dev, cs) -> None:
    """The one-card dense solve: the streaming preview's, cold and warm,
    and depth 7 and 8 cold solves, warm-up + ``runs`` timed runs."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        pointcloud,
        poisson,
    )

    def cloud(n):
        pts = torch.from_numpy(cs.cylinder_cloud(n, 2)).to(dev)
        nrm = pointcloud.estimate_normals(pts, k=12)[0]
        return pts, pointcloud.orient_normals(
            pts, nrm, torch.tensor([0.0, 0.0, 500.0], device=dev),
            outward=True)

    small, big = cloud(8192), cloud(1 << 16)
    x0 = poisson.reconstruct(small[0][::2], small[1][::2], depth=6,
                             cg_iters=60).chi
    solves = {"preview_cold": (small, 6, 60, None),
              "preview_warm": (small, 6, 60, x0),
              "d7": (big, 7, 300, None), "d8": (big, 8, 300, None)}
    out["runs"]["dense"] = []
    for run in range(runs + 1):
        row = {}
        for name, ((pts, nrm), depth, iters, warm) in solves.items():
            cs._sync(dev)
            t0 = time.perf_counter()
            grid, used = poisson.reconstruct(pts, nrm, depth=depth,
                                             cg_iters=iters, x0=warm,
                                             return_iters=True)
            cs._sync(dev)
            row[f"{name}_s"] = time.perf_counter() - t0
            row[f"{name}_iters"] = used
            if run == 0:
                out["digest"][f"dense {name} chi"] = _digest(grid.chi)
        if run:
            out["runs"]["dense"].append(row)
            print(f"dense run {run}: {json.dumps(row)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="TREE",
                    help="OLD and NEW: roots of the two trees")
    ap.add_argument("--runs", type=int, default=2,
                    help="timed runs of each path a turn")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated paths a turn runs, of "
                         f"{', '.join(PATHS)} (the seeded kernels always)")
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
        print("turn " + json.dumps(measure(args.runs, torch.device("cuda", 0),
                                           args.paths.split(","))),
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
             "--runs", str(args.runs), "--paths", args.paths], cwd=tree,
            capture_output=True, text=True, timeout=1800)
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
    for path, rows in turns[0]["runs"].items():
        for key in rows[0]:
            per = [[round(r[key], 6) for r in t["runs"][path]]
                   for t in turns]
            o = mean("old", lambda t: sum(r[key] for r in t["runs"][path])
                     / len(t["runs"][path]))
            n = mean("new", lambda t: sum(r[key] for r in t["runs"][path])
                     / len(t["runs"][path]))
            print(f"{path} {key}: turns old/new/new/old {per}; mean old "
                  f"{o:.6f}, new {n:.6f}", flush=True)
    for label in turns[0]["phases"]:
        for key in ("phase_ms", "call_ms", "kernel_ms", "nb8_ms", "frame_ms",
                    "sum_ms", "peak_bytes", "output_bytes", "count"):
            per = [t["phases"][label][key] for t in turns]
            o = mean("old", lambda t: t["phases"][label][key])
            n = mean("new", lambda t: t["phases"][label][key])
            print(f"classify phase {label} {key}: turns old/new/new/old "
                  f"{per}; mean old {o:.4f}, new {n:.4f}, old/new "
                  f"{o / n:.3f}", flush=True)
        print(f"classify phase {label}, kernels a call: old "
              f"{turns[0]['phases'][label]['kernels_a_call']}, new "
              f"{turns[1]['phases'][label]['kernels_a_call']}", flush=True)
    if "fused_form" in turns[0]:
        print("fused path's form by turn: "
              + ", ".join(t["fused_form"] for t in turns), flush=True)
    if "sweeps" in turns[0]:
        print(f"sweeps by shape: old {turns[0]['sweeps']}, new "
              f"{turns[1]['sweeps']}", flush=True)
    # The mesh band's classify digest is taken on the band each tree's own
    # ring gives: it compares kernels only where both rings give one cloud.
    clouds = [[r["checksum"] for r in t["runs"].get("ring", [])]
              for t in turns]
    derived = set()
    if any(c != clouds[0] for c in clouds):
        derived = {k for k in turns[0]["digest"] if "mesh band" in k}
        print(f"the trees' rings give other clouds: {sorted(derived)} "
              "taken on other inputs, not compared", flush=True)
    same = all({k: v for k, v in t["digest"].items() if k not in derived}
               == {k: v for k, v in turns[0]["digest"].items()
                   if k not in derived} for t in turns)
    print(f"kernel outputs equal in every turn: {same} "
          f"({turns[0]['digest']})", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
