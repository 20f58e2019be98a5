"""The covisibility gate of the streaming session, JAX package against the
PyTorch port, on one rendered 24-stop ring.

A parity harness, like the ``tests/test_torch_*.py`` files: it imports both
packages and runs on the host CPU. It renders the headline bump scene of
``chip_smoke.py`` (24 stops × 15°, 1920×1080 projector, 46 frames) with the
port's numpy rig at a reduced camera resolution (default 270×480: the gate
sees the same ``max_points`` = 8192 registration points per stop at any
resolution, since every stop holds far more valid pixels than that), feeds
the same uint8 stacks to the JAX ``IncrementalSession`` and to the port's, with
``chip_smoke.py``'s session settings and the gate on (the ``StreamParams``
default), and prints for every stop and both sessions:

* the camera-frame duplicate overlap and the predicted-pose model overlap
  the gate measured (``voxel_overlap``), and its decision;
* the fused model's voxel-key count and the Jaccard index of the two
  sessions' model key sets;
* after ``finalize(mesh=False)``: stops fused, the weakest edge fitness, the
  worst final pose error against k·15° and the merged cloud's median
  distance to the scene's spheres.

Previews are off (``preview_every=0``) and the lane is ``"poisson"``: neither
touches the gate's state, and both cost host minutes here.

    python scripts/torch_gate_witness.py [--height 270 --width 480]

Prints one JSON line at the end with the per-stop records.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_STOPS = 24
STEP_DEG = 15.0


def render(h: int, w: int):
    """The bump scene on the turntable, as ``chip_smoke.render_stacks``
    renders it, at an (h, w) camera."""
    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    proj = ProjectorConfig()
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
    stacks = np.empty((N_STOPS, frames.shape[0], h, w), np.uint8)
    for k in range(N_STOPS):
        shader = synthetic.FrameShader(
            synthetic.rotated_scene(scene, k * STEP_DEG), *rig, h, w, proj)
        for f in range(frames.shape[0]):
            stacks[k, f] = shader.shade(frames[f])
    return stacks, rig, proj, synthetic.rotated_scene(scene, 0.0).spheres


def instrument(sess, voxel_overlap):
    """Record what the gate measures at every stop, whatever it decides."""
    orig = sess._covis_overlap
    recs = {}

    def wrapped(label, reg_np):
        voxel = sess._covis_voxel()
        dup = cov = None
        if sess._labels:
            dup = voxel_overlap(reg_np, sess._prev_cam_voxels, voxel)
            if sess._consensus is not None and sess._model_voxels.size:
                pred = sess._predict_pose(label)
                moved = reg_np @ pred[:3, :3].T + pred[:3, 3]
                cov = voxel_overlap(moved, sess._model_voxels, voxel)
        out = orig(label, reg_np)
        recs[label] = {"reg_points": int(reg_np.shape[0]), "dup": dup,
                       "model": cov,
                       "decision": "fused" if out is None else out[0]}
        return out

    sess._covis_overlap = wrapped
    return recs


def rotation_deg(R) -> float:
    R = np.asarray(R, np.float64)
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1,
                                              1))))


def pose_error(poses) -> float:
    worst = 0.0
    for k in range(len(poses)):
        cmd = (k * STEP_DEG) % 360.0
        worst = max(worst, abs(rotation_deg(poses[k][:3, :3])
                               - min(cmd, 360.0 - cmd)))
    return worst


def surface_median(points, spheres) -> float:
    pts = np.asarray(points, np.float64)
    d = np.full(len(pts), np.inf)
    for s in spheres:
        d = np.minimum(d, np.abs(np.linalg.norm(
            pts - np.asarray(s.center), axis=1) - s.radius))
    return float(np.median(d))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args()

    import jax
    import torch

    torch.set_num_threads(args.threads)
    jax.config.update("jax_platforms", "cpu")

    from structured_light_for_3d_model_replication_tpu.models import (
        merge as jmerge,
    )
    from structured_light_for_3d_model_replication_tpu.ops.triangulate import (
        make_calibration as jcalib,
    )
    from structured_light_for_3d_model_replication_tpu.stream import (
        session as jsession,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge as tmerge,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration as tcalib,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        session as tsession,
    )

    t0 = time.perf_counter()
    stacks, rig, proj, spheres = render(args.height, args.width)
    h, w = args.height, args.width
    print(f"rendered {stacks.shape} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    common = dict(method="posegraph", covis=True, view_cap=16_384,
                  model_cap=131_072, preview_every=0, preview_points=16_384,
                  preview_depth=6, final_depth=10, representation="poisson",
                  tsdf_grid_depth=8, tsdf_max_bricks=16_384)
    merge_kw = dict(voxel_size=3.0, final_max_points=131_072,
                    step_deg=STEP_DEG)
    sessions = {
        "jax": jsession.IncrementalSession(
            jcalib(*rig, h, w, proj_width=proj.width,
                   proj_height=proj.height),
            proj.col_bits, proj.row_bits,
            params=jsession.StreamParams(
                merge=jmerge.MergeParams(**merge_kw), expected_stops=N_STOPS,
                **common),
            key=jax.random.PRNGKey(11), scan_id="witness-jax"),
        "torch": tsession.IncrementalSession(
            tcalib(*rig, h, w, proj.width, proj.height,
                   device=torch.device("cpu")),
            proj.col_bits, proj.row_bits,
            params=tsession.StreamParams(
                merge=tmerge.MergeParams(**merge_kw), **common),
            scan_id="witness-torch", device="cpu"),
    }
    recs = {"jax": instrument(sessions["jax"], jsession.voxel_overlap),
            "torch": instrument(sessions["torch"], tsession.voxel_overlap)}
    model_keys = {"jax": [], "torch": []}
    for k in range(N_STOPS):
        line = [f"stop {k:2d}"]
        for name, sess in sessions.items():
            ts = time.perf_counter()
            sess.add_stop(stacks[k])
            r = recs[name][k]
            r["model_voxels"] = int(sess._model_voxels.size)
            r["seconds"] = round(time.perf_counter() - ts, 3)
            model_keys[name] = sess._model_voxels
            fmt = (lambda v: "   -   " if v is None else f"{v:.5f}")
            line.append(f"{name}: dup {fmt(r['dup'])} model "
                        f"{fmt(r['model'])} {r['decision']:<17s} "
                        f"{r['model_voxels']:6d} keys")
        a, b = model_keys["jax"], model_keys["torch"]
        union = np.union1d(a, b).size
        jac = np.intersect1d(a, b).size / union if union else 1.0
        recs["jax"][k]["model_jaccard"] = round(jac, 6)
        print(" | ".join(line) + f" | jaccard {jac:.5f}", flush=True)

    summary = {}
    for name, sess in sessions.items():
        ts = time.perf_counter()
        fin = sess.finalize(mesh=False)
        pts = np.asarray(fin.cloud.points)
        summary[name] = {
            "stops_fused": sess.stops_fused,
            "skipped": {str(k): v[0] for k, v in sess._skipped.items()},
            "min_fitness": fin.stats["min_fitness"],
            "worst_pose_error_deg": round(pose_error(fin.poses), 4),
            "cloud_points": int(len(pts)),
            "median_mm_to_spheres": round(surface_median(pts, spheres), 4),
            "finalize_s": round(time.perf_counter() - ts, 3),
        }
        print(f"{name}: " + json.dumps(summary[name]), flush=True)
    print(json.dumps({"camera": [h, w], "summary": summary,
                      "stops": {n: {str(k): v for k, v in r.items()}
                                for n, r in recs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
