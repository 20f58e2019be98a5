#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port on one NVIDIA GPU:
``structured_light_for_3d_model_replication_tpu_torch``, from stacks to the
merged 360° cloud and on to the printable STL, with its CUDA kernels.

    python3 chip_smoke.py                  # the full run (no arguments)
    python3 chip_smoke.py --kernels-only   # build + kernel checks, no result
    python3 chip_smoke.py --profile        # full run + a profiled main path

Phases, in order; any failure exits non-zero before the result line:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the TF32 flags (both set False and printed);
2. build of the CUDA kernels from ``csrc/`` (one ``nvcc -c`` per source, all
   started together, then one link), with its time;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at ragged ones, then timed with CUDA events beside its
   bound, its plain version and, where one exists, a library yardstick;
4. the main path at full size — 24 stops × 15°, 1080×1920 camera, 1920×1080
   projector, 46 frames (the repository's headline 360° configuration) —
   through ``scan_stacks_to_cloud``, then ``mesh_360`` of the merged cloud
   at depth 10 into a temporary STL (bench.py config 6 settings); each half
   with its kernels' launch counters zeroed before and read after; stage
   times, peak memory, the merged cloud and every pose against the
   commanded turntable angle, the band, the CG iterations, the mesh against
   the scene's analytic surface and the STL read back;
5. the whole path on the tests' small 4-stop rig, scan and depth-9 mesh, on
   the card and on the host (the plain versions), compared by outcome;
6. a ``kernels`` JSON line, the card line again, and last the result line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA card; without one it exits non-zero and prints no result. The
port (and nothing of the JAX package) must be importable from the working
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # non-tensor fp32, H100 SXM data sheet
NN_FLOPS_PER_PAIR = 8          # 3 sub, 3 mul, 2 add
N_STOPS, STEP_DEG = 24, 15.0   # the headline ring (bench.py:337-380)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_decode(dev):
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import decode

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    max_err = 0
    main = None
    for shape, bits, ds in (((6, 46, 1080, 1920), (11, 11), 1),
                            ((1, 32, 97, 161), (8, 7), 2),
                            ((3, 32, 97, 161), (8, 7), 1)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=g)
        col, row = decode.decode_maps(x, *bits, downsample=ds)
        rcol, rrow = decode.decode_maps_reference(x, *bits, downsample=ds)
        torch.cuda.synchronize()
        err = max(int((col - rcol).abs().max()), int((row - rrow).abs().max()))
        print(f"decode_maps {tuple(shape)} ds={ds}: max |kernel - plain| = "
              f"{err}", flush=True)
        if err != 0:
            fail(f"decode_maps disagrees with its plain version at {shape}")
        max_err = max(max_err, err)
        if main is None:
            main = (x, bits, ds)
    x, bits, ds = main
    b, f, h, w = x.shape
    ms = cuda_ms(lambda: decode.decode_maps(x, *bits, downsample=ds), 50)
    plain_ms = cuda_ms(
        lambda: decode.decode_maps_reference(x, *bits, downsample=ds), 5)
    # Planes 0 and 1 (white, black) feed only the mask, computed outside
    # the kernel: the function reads the f - 2 bit planes.
    nbytes = b * (f - 2) * h * w + 8 * b * h * w
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"decode_maps {tuple(x.shape)}: {ms:.4f} ms/launch, bound "
          f"{bound_ms:.4f} ms (bytes, {nbytes / 1e6:.1f} MB), plain "
          f"{plain_ms:.3f} ms, library yardstick: none", flush=True)
    return dict(name="decode_maps", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/decode.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "decode_pallas.py:57",
                max_abs_err=float(max_err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def check_nearest_one(dev):
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import nn

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    max_err = 0.0
    cases = (("8192x8192, 20% invalid", 8192, 8192, 0.2),
             ("1500x1100, 20% invalid", 1500, 1100, 0.2),
             ("64x128, all invalid", 64, 128, 1.0))
    main = None
    for label, m, n, invalid in cases:
        q = torch.randn((m, 3), device=dev, generator=g) * 50 + 500
        p = torch.randn((n, 3), device=dev, generator=g) * 50 + 500
        valid = torch.rand((n,), device=dev, generator=g) >= invalid
        kt, p2v = nn.key_table(p, valid)
        d2, idx = nn.nearest_one(q, kt, p2v)
        rd2, ridx = nn.nearest_one_reference(q, kt, p2v)
        torch.cuda.synchronize()
        finite = torch.isfinite(rd2)
        if not torch.equal(finite, torch.isfinite(d2)):
            fail(f"nearest_one {label}: +inf pattern differs")
        if not bool(finite.any()):
            if not bool((idx == 0).all()):
                fail(f"nearest_one {label}: idx not 0 without valid keys")
            print(f"nearest_one {label}: all d2 = +inf, idx = 0", flush=True)
            continue
        rel = ((d2[finite] - rd2[finite]).abs()
               / rd2[finite].abs().clamp_min(1e-30))
        err = float((d2[finite] - rd2[finite]).abs().max())
        # A differing idx is allowed only where the two d2 tie (1e-6 rel).
        flips = (idx != ridx) & finite
        tie_ok = bool((rel[flips[finite]] <= 1e-6).all())
        print(f"nearest_one {label}: max |d2 - plain| = {err:.3e}, max rel "
              f"{float(rel.max()):.3e}, idx differs on {int(flips.sum())} "
              f"rows (ties: {tie_ok}), valid keys {bool(valid[idx[finite]].all())}",
              flush=True)
        if float(rel.max()) > 1e-6 or not tie_ok:
            fail(f"nearest_one disagrees with its plain version ({label})")
        if not bool(valid[idx[finite]].all()):
            fail(f"nearest_one {label}: idx points at an invalid key")
        max_err = max(max_err, err)
        if main is None:
            main = (q, kt, p2v, p, valid)
    q, kt, p2v, p, valid = main
    m, n_valid = q.shape[0], int(valid.sum())
    ms = cuda_ms(lambda: nn.nearest_one(q, kt, p2v), 200)
    plain_ms = cuda_ms(lambda: nn.nearest_one_reference(q, kt, p2v), 20)
    pv = p[valid]
    lib_ms = cuda_ms(lambda: torch.cdist(q, pv).argmin(1), 20)
    flops = NN_FLOPS_PER_PAIR * m * n_valid
    nbytes = 4 * (3 * m + 4 * kt.shape[1]) + 12 * m
    bound_ms = max(flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    print(f"nearest_one {m}x{kt.shape[1]} ({n_valid} valid keys): {ms:.4f} "
          f"ms/launch, bound {bound_ms:.4f} ms (operations, "
          f"{flops / 1e9:.3f} GFLOP), plain {plain_ms:.3f} ms, library "
          f"torch.cdist(q, k).argmin(1) {lib_ms:.3f} ms", flush=True)
    return dict(name="nearest_one", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/nn1.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "nn_pallas.py:99",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="operations", library_ms=lib_ms)


def sphere_band(dev):
    """The band of a sphere of radius 80 mm sampled by 100 000 points with
    their normals, built by the port's ``_setup_sparse`` at depth 10 with
    131 072 block slots: (rhs, W, nbr, block_valid)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        poisson_sparse,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    u = torch.randn((100_000, 3), device=dev, generator=g)
    u = u / u.norm(dim=1, keepdim=True)
    pts = u * 80.0 + torch.tensor([0.0, 10.0, 500.0], device=dev)
    out = poisson_sparse._setup_sparse(
        pts, u, torch.ones(pts.shape[0], dtype=torch.bool, device=dev),
        2 ** 10, 131_072, torch.tensor(4.0, device=dev))
    print(f"sphere band at depth 10: {int(out[11])} blocks, "
          f"{int(out[3].sum())} of them in the 131072 slots", flush=True)
    return out[0], out[1], out[2], out[3]


def check_matvec(dev, band):
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        poisson_matvec as pm,
    )

    rhs, W, nbr, bv = band
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    xr = torch.randn(rhs.shape, device=dev, generator=g)
    # A ragged prefix (neighbours past it count as absent) with a tenth of
    # its bricks marked invalid.
    mr = 100_003
    bvr = bv[:mr] & (torch.rand((mr,), device=dev, generator=g) > 0.1)
    cases = (("band, x = rhs", rhs, W, nbr, bv),
             ("band, random x", xr, W, nbr, bv),
             (f"first {mr} rows, 10% invalid, random x", xr[:mr], W[:mr],
              nbr[:mr], bvr))
    max_err = 0.0
    for label, x, w, nb, v in cases:
        got = pm.matvec_band(x, w, nb, v)
        ref = pm.matvec_band_reference(x, w, nb, v)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        print(f"matvec_band {label}: max |kernel - plain| = {err:.3e} "
              f"(max |plain| {scale:.3e})", flush=True)
        if not err <= 1e-6 * scale:
            fail(f"matvec_band disagrees with its plain version ({label})")
        max_err = max(max_err, err)
    m = rhs.shape[0]
    n_valid = int(bv.sum())
    ms = cuda_ms(lambda: pm.matvec_band(rhs, W, nbr, bv), 100)
    plain_ms = cuda_ms(lambda: pm.matvec_band_reference(rhs, W, nbr, bv), 5)
    # Valid brick: x, W read and out written; invalid brick: out written;
    # every brick: nbr and block_valid read. Face halos hit L2.
    nbytes = 3 * 2048 * n_valid + 2048 * (m - n_valid) + 25 * m
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"matvec_band M={m} ({n_valid} valid): {ms:.4f} ms/launch, bound "
          f"{bound_ms:.4f} ms (bytes, {nbytes / 1e6:.1f} MB), plain "
          f"{plain_ms:.3f} ms, library yardstick: none", flush=True)
    return dict(name="matvec_band", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/matvec.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "poisson_pallas.py:130",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def check_classify(dev, band):
    import torch
    import torch.nn.functional as F

    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        marching_classify as mc,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        marching_device,
    )

    rhs, _, nbr, bv = band
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    c9 = marching_device.corner_frame(rhs, nbr)
    iso0 = torch.zeros((), device=dev)
    cases = [("band corner frame, iso 0", c9, iso0, bv)]
    # Random frames whose values sit at iso and within one ulp of it, with
    # an iso of scan scale and with iso 0 among subnormals.
    for label, iso in (("iso 0.0137 +- 1 ulp", 0.0137), ("iso 0 +- subnormal",
                                                         0.0)):
        iso_t = torch.tensor(iso, device=dev)
        k = torch.randint(-1, 2, (4096, 729), device=dev, generator=g)
        vals = torch.where(k < 0, torch.nextafter(iso_t, iso_t - 1),
                           torch.where(k > 0, torch.nextafter(iso_t, iso_t + 1),
                                       iso_t.expand(4096, 729)))
        valid = torch.rand((4096,), device=dev, generator=g) > 0.1
        cases.append((label, vals.contiguous(), iso_t, valid))
    for label, c, iso, v in cases:
        got = mc.classify_cells(c, iso, v)
        ref = mc.classify_cells_reference(c, iso, v)
        torch.cuda.synchronize()
        diff = int((got != ref).sum())
        print(f"classify_cells {label}: {int(ref.sum())} active cells, "
              f"max |kernel - plain| = {int(diff > 0)} ({diff} cells differ)",
              flush=True)
        if diff:
            fail(f"classify_cells disagrees with its plain version ({label})")
    m = c9.shape[0]
    ms = cuda_ms(lambda: mc.classify_cells(c9, iso0, bv), 100)
    plain_ms = cuda_ms(lambda: mc.classify_cells_reference(c9, iso0, bv), 5)

    def pooled():
        inside = (c9 > iso0).to(torch.float32).view(m, 1, 9, 9, 9)
        any_in = F.max_pool3d(inside, kernel_size=2, stride=1)
        all_in = -F.max_pool3d(-inside, kernel_size=2, stride=1)
        return ((any_in > 0.5) & (all_in < 0.5)).view(m, 512) & bv[:, None]

    if not torch.equal(pooled(), mc.classify_cells(c9, iso0, bv)):
        fail("the max_pool3d yardstick computes another function")
    lib_ms = cuda_ms(pooled, 20)
    nbytes = m * (729 * 4 + 512 + 1)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"classify_cells M={m}: {ms:.4f} ms/launch, bound {bound_ms:.4f} "
          f"ms (bytes, {nbytes / 1e6:.1f} MB), plain {plain_ms:.3f} ms, "
          f"library max_pool3d any/all {lib_ms:.3f} ms", flush=True)
    return dict(name="classify_cells", route="cuda",
                source="structured_light_for_3d_model_replication_tpu_torch/"
                       "csrc/classify.cu",
                replaces="structured_light_for_3d_model_replication_tpu/ops/"
                         "marching_pallas.py:54",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=lib_ms)


# ---------------------------------------------------------------------------
# Phase 4: the main path at full size
# ---------------------------------------------------------------------------


def render_stacks(n_stops: int, step_deg: float, proj):
    """The headline bump scene, camera at the projector's resolution,
    rendered on the host with the port's numpy rig (untimed set-up).
    Returns (stacks, rig, ground-truth points of stop 0, scene)."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    h, w = proj.height, proj.width
    rig = synthetic.default_calibration(h, w, proj)

    def bump(az_deg, y, r):
        az = np.radians(az_deg)
        return synthetic.Sphere(
            (90.0 * np.sin(az), y, 500.0 + 90.0 * np.cos(az)), r, 0.75)

    scene = synthetic.Scene(wall_z=None, spheres=(
        synthetic.Sphere((0.0, 10.0, 500.0), 80.0, 0.9),
        bump(0, -40, 32), bump(60, 30, 26), bump(130, -10, 30),
        bump(200, 55, 24), bump(270, -55, 28), bump(320, 20, 22)))
    frames = synthetic.pattern_frames(proj)
    stacks = np.empty((n_stops, frames.shape[0], h, w), np.uint8)
    gts = [None] * n_stops

    def render(k):
        sc = synthetic.rotated_scene(scene, k * step_deg)
        shader = synthetic.FrameShader(sc, *rig, h, w, proj)
        for f in range(frames.shape[0]):
            stacks[k, f] = shader.shade(frames[f])
        gts[k] = shader.ground_truth["points"]

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(render, range(n_stops)))
    return stacks, rig, gts[0], scene


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_run(run, top: int = 15) -> None:
    """Run ``run()`` once under ``torch.profiler`` and print where the
    device time goes: kernel count, device-busy time (the union of kernel
    intervals) against the wall, and the kernels with the most device time.
    The counted main-path run is never profiled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, cur_s, cur_e = 0.0, None, None
    per_name = {}
    for s0, e0, name in spans:
        n, t = per_name.get(name, (0, 0.0))
        per_name[name] = (n + 1, t + (e0 - s0))
        if cur_e is None or s0 > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    print(f"profile: {len(spans)} kernels, device busy {busy_us / 1e3:.1f} ms "
          f"of {wall_ms:.1f} ms wall under the profiler (idle share "
          f"{1 - busy_us / 1e3 / wall_ms:.3f})", flush=True)
    for name, (n, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[
            :top]:
        print(f"  {t / 1e3:9.2f} ms {n:6d}x  {name[:100]}", flush=True)


def main_path(dev, n_stops: int, proj=None, profile: bool = False):
    """Drive ``scan_stacks_to_cloud`` once at full size (1920×1080
    projector unless ``proj`` says otherwise) and check what comes out;
    with ``profile`` run it once more under the profiler."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
        pipeline,
        scan360,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        decode,
        nn,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    proj = proj or ProjectorConfig()
    step = STEP_DEG
    t0 = time.perf_counter()
    stacks, rig, gt0, scene = render_stacks(n_stops, step, proj)
    h, w = stacks.shape[2:]
    print(f"rendered {n_stops} stops x {stacks.shape[1]} frames at {h}x{w} "
          f"in {time.perf_counter() - t0:.1f} s (untimed set-up)", flush=True)
    calib = make_calibration(*rig, h, w, proj.width, proj.height, device=dev)
    params = scan360.Scan360Params(
        merge=merge.MergeParams(voxel_size=3.0, final_max_points=131_072,
                                step_deg=step),
        method="sequential", view_cap=16_384, stop_chunk=6)

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    decode.decode_maps.launches = 0
    nn.nearest_one.launches = 0
    timing = {}
    t0 = time.perf_counter()
    merged, poses, stats = scan360.scan_stacks_to_cloud(
        stacks, calib, proj.col_bits, proj.row_bits, params=params,
        with_stats=True, timing=timing, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {"decode_maps": decode.decode_maps.launches,
                "nearest_one": nn.nearest_one.launches}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    print(f"main path: {n_stops} stops -> {len(merged)} points in "
          f"{wall:.3f} s wall; stages (s): " + ", ".join(
              f"{k}={v:.3f}" for k, v in timing.items()
              if k.endswith("_s")), flush=True)
    print(f"peak device memory {peak / 2**30:.2f} GiB; kernel launches "
          f"{launches}", flush=True)
    worst = 0.0
    for k in range(n_stops):
        R = poses[k][:3, :3].astype(np.float64)
        ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
        cmd = (k * step) % 360.0
        cmd = min(cmd, 360.0 - cmd)
        worst = max(worst, abs(ang - cmd))
        print(f"  pose {k:2d}: {ang:8.3f} deg vs commanded {cmd:6.1f}",
              flush=True)
    fits = [e["fitness"] for e in stats["edges"]]
    print(f"edge fitness min {min(fits):.4f} mean {np.mean(fits):.4f}; "
          f"worst pose error {worst:.3f} deg", flush=True)

    if worst > 2.0:
        fail(f"a pose is {worst:.3f} deg off its commanded angle")
    if len(merged) <= (10_000 if proj.width >= 1920 else 200):
        fail(f"merged cloud has only {len(merged)} points")
    if merged.colors is None or merged.normals is None:
        fail("merged cloud lacks colours or normals")
    if not np.isfinite(merged.points).all():
        fail("merged cloud has non-finite points")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the main path never launched {name}")

    # Stop 0 triangulated against the rendered ground truth (the decode
    # rounds to the nearest projector column: ~1 pixel of depth).
    r = pipeline.reconstruct(stacks[0], calib, proj.col_bits, proj.row_bits,
                             device=dev)
    valid = r.valid.cpu().numpy()
    err = np.linalg.norm(r.points.cpu().numpy()[valid]
                         - gt0.reshape(-1, 3)[valid], axis=1)
    print(f"stop 0: {int(valid.sum())} valid pixels, median |p - truth| "
          f"{np.median(err):.3f} mm", flush=True)
    if valid.mean() < 0.05 or np.median(err) > 3.0:
        fail("stop 0 does not match the rendered ground truth")
    if profile:
        profile_run(lambda: scan360.scan_stacks_to_cloud(
            stacks, calib, proj.col_bits, proj.row_bits, params=params,
            device=dev))
    launches.update(mesh_path(dev, merged, scene, profile=profile))
    return launches


def surface_distance(points: np.ndarray, spheres) -> np.ndarray:
    """Distance of each point to the surface of the union of ``spheres``
    (exact outside the union)."""
    d = np.full(points.shape[0], np.inf)
    for s in spheres:
        d = np.minimum(d, np.linalg.norm(points - np.asarray(s.center),
                                         axis=1) - s.radius)
    return np.abs(d)


def mesh_path(dev, merged, scene, profile: bool = False):
    """The main path's second half: ``mesh_360`` of the merged cloud at
    depth 10 (trim 0, 100 CG iterations, the bench.py config 6 settings)
    into a temporary STL, with the mesh kernels' launch counters zeroed
    before and read after; stage times, band, mesh, peak memory, the STL
    read back and the vertices against the scene's analytic surface."""
    import tempfile

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io.stl import (
        read_stl,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        marching_classify,
        poisson_matvec,
    )

    def cloud():  # mesh_360 writes the oriented normals into its cloud
        return PointCloud(points=merged.points.copy(), colors=merged.colors,
                          normals=merged.normals.copy())

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    poisson_matvec.matvec_band.launches = 0
    marching_classify.classify_cells.launches = 0
    timing, stats = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.stl")
        t0 = time.perf_counter()
        mesh = meshing.mesh_360(cloud(), path, depth=10, quantile_trim=0.0,
                                cg_iters=100, timing=timing,
                                solve_stats=stats, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = {"matvec_band": poisson_matvec.matvec_band.launches,
                    "classify_cells":
                        marching_classify.classify_cells.launches}
        back = read_stl(path)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    print(f"mesh path: {len(merged)} points -> {len(mesh.vertices)} "
          f"vertices, {len(mesh.faces)} faces in {wall:.3f} s wall; stages "
          f"(s): " + ", ".join(f"{k}={v:.3f}" for k, v in timing.items()),
          flush=True)
    print(f"band {stats['n_blocks']} blocks; fine CG {stats['cg_iters_used']} "
          f"iterations (additive), coarse {stats['coarse_iters_used']}; peak "
          f"device memory {peak / 2**30:.2f} GiB; kernel launches {launches}",
          flush=True)
    dist = surface_distance(mesh.vertices.astype(np.float64),
                            synthetic_spheres(scene))
    med, p90 = float(np.median(dist)), float(np.percentile(dist, 90))
    print(f"mesh vertices vs the scene's surface: median {med:.3f} mm, p90 "
          f"{p90:.3f} mm (the watertight fill also caps unseen regions); "
          f"STL read back: {len(back.faces)} faces", flush=True)
    if launches["matvec_band"] != 1 + stats["cg_iters_used"]:
        fail(f"matvec_band launched {launches['matvec_band']} times, not "
             f"1 + {stats['cg_iters_used']} CG iterations")
    if launches["classify_cells"] != 1:
        fail(f"classify_cells launched {launches['classify_cells']} times, "
             "not once")
    if len(mesh.faces) <= 10_000:
        fail(f"the mesh has only {len(mesh.faces)} faces")
    if len(back.faces) != len(mesh.faces):
        fail("the STL does not read back to the same face count")
    if not np.isfinite(mesh.vertices).all() or med > 1.0:
        fail(f"the mesh is {med:.3f} mm from the scene's surface (median)")
    if profile:
        profile_run(lambda: meshing.mesh_360(
            cloud(), os.devnull, depth=10, quantile_trim=0.0, cg_iters=100,
            device=dev))
    return launches


def synthetic_spheres(scene):
    """The scene's spheres in the merged cloud's frame (stop 0)."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    return synthetic.rotated_scene(scene, 0.0).spheres


def small_rig_agreement(dev) -> None:
    """The whole slice on the card against the same slice on the host (the
    plain versions): the tests' 4-stop, 10° rig (256×128 projector, 96×160
    camera, FAST parameters). The RANSAC streams of the two devices differ,
    so outcomes are compared: every pose within 0.5° of the host's and of
    i·10°, merged point counts within 5%."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge,
        scan360,
        synthetic,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration,
    )

    proj = ProjectorConfig(width=256, height=128)
    h, w = 96, 160
    rig = synthetic.default_calibration(h, w, proj)
    scene = synthetic.Scene(wall_z=None, spheres=tuple(
        synthetic.Sphere(c, r, a) for c, r, a in (
            ((0.0, 10.0, 500.0), 80.0, 0.9), ((60.0, -40.0, 460.0), 35.0, 0.7),
            ((-70.0, 40.0, 530.0), 30.0, 0.8),
            ((20.0, 70.0, 440.0), 25.0, 0.75))))
    stacks = np.stack([s for s, _ in synthetic.render_turntable_scans(
        scene, 4, 10.0, *rig, h, w, proj)])
    params = scan360.Scan360Params(merge=merge.MergeParams(
        voxel_size=6.0, ransac_iterations=2048, icp_iterations=20,
        fpfh_max_nn=32, normals_k=12, max_points=2048), view_cap=8192)
    runs = {}
    for d in (dev, torch.device("cpu")):
        calib = make_calibration(*rig, h, w, proj.width, proj.height,
                                 device=d)
        runs[d.type] = scan360.scan_stacks_to_cloud(
            stacks, calib, proj.col_bits, proj.row_bits, params=params,
            device=d)
    (m_dev, p_dev), (m_cpu, p_cpu) = runs[dev.type], runs["cpu"]
    worst = 0.0
    for i in range(4):
        a = [np.degrees(np.arccos(np.clip((np.trace(p[i][:3, :3]) - 1) / 2,
                                          -1, 1))) for p in (p_dev, p_cpu)]
        worst = max(worst, abs(a[0] - a[1]), abs(a[0] - 10.0 * i))
    print(f"small rig, {dev.type} vs cpu: {len(m_dev)} vs {len(m_cpu)} "
          f"merged points, worst pose gap {worst:.4f} deg", flush=True)
    if worst > 0.5 or abs(len(m_dev) - len(m_cpu)) > 0.05 * len(m_cpu):
        fail(f"the slice on {dev.type} disagrees with the host run")

    # On to the mesh at depth 9 on each device, compared by outcome (the
    # clouds differ by their RANSAC draws and the splats by atomic sums):
    # face counts within 3%, median vertex-to-vertex distance between the
    # two meshes ≤ 0.25 voxel. A block budget near the band's ~14k blocks
    # keeps the host run's fields small (every field spans the budget).
    from scipy.spatial import cKDTree

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        meshing,
    )

    meshes = {}
    for d, m in ((dev, m_dev), (torch.device("cpu"), m_cpu)):
        t0 = time.perf_counter()
        meshes[d.type] = meshing.mesh_from_cloud(
            m, depth=9, quantile_trim=0.0, cg_iters=100, max_blocks=32_768,
            device=d)
        print(f"small rig mesh on {d.type}: {len(meshes[d.type].faces)} "
              f"faces in {time.perf_counter() - t0:.2f} s", flush=True)
    a, b = meshes[dev.type], meshes["cpu"]
    pts = np.asarray(m_cpu.points, np.float64)
    voxel = 1.2 * float((pts.max(0) - pts.min(0)).max()) / (2 ** 9 - 1)
    gap = np.concatenate([cKDTree(b.vertices).query(a.vertices)[0],
                          cKDTree(a.vertices).query(b.vertices)[0]])
    med = float(np.median(gap)) / voxel
    print(f"small rig mesh, {dev.type} vs cpu: {len(a.faces)} vs "
          f"{len(b.faces)} faces, median vertex gap {med:.4f} voxel",
          flush=True)
    if abs(len(a.faces) - len(b.faces)) > 0.03 * len(b.faces) or med > 0.25:
        fail(f"the mesh on {dev.type} disagrees with the host run")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels only (no main path, "
                         "no result line)")
    ap.add_argument("--profile", action="store_true",
                    help="after the checked run, profile one more main-path "
                         "run and print where the device time goes")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    from structured_light_for_3d_model_replication_tpu_torch.kernels import (
        build,
    )

    t0 = time.perf_counter()
    build.library()
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'} s)",
          flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    band = sphere_band(dev)
    kernels = [check_decode(dev), check_nearest_one(dev),
               check_matvec(dev, band), check_classify(dev, band)]
    del band
    if args.kernels_only:
        return 0
    launches = main_path(dev, N_STOPS, profile=args.profile)
    small_rig_agreement(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
