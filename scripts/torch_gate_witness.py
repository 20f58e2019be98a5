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

``--splat`` witnesses the splat appearance tier instead: bench config 12
(``chip_smoke.splat_params``; the JAX session with bench.py's key) on the
same ring in both packages — stops 0–22 streamed, ``ensure_scene`` (seed +
200 Adam steps against 8 frames), then for each package the PSNR of the
render from held-out stop 23's predicted camera against its captured RGB
(bench [12]'s ≥ 20 dB gate), the mean PSNR of the 8 buffered training
views (fitted, and freshly seeded), and, as a diagnostic of the
renderer's K nearest splats per tile, the held-out PSNR of the fitted and
of the freshly seeded scene at
``max_per_tile`` 128 (the config) and 512, and the port's tile membership
counts at the held-out view. A cross fit follows: each package's fresh
seed and frame buffer fitted by the other package's ``fit_appearance`` and
rendered at its held-out view, which tells a gap from the fit apart from
one in the session state; then the state's parts: the two frame buffers
and buffered cameras compared, and each package's seed and frames fitted
with the other's cameras. ``--perturb N`` adds the port's refits of both
packages' fused volumes, as they stand and N times with every TSDF value
moved by an ulp or two, and the two volumes compared brick by brick.
``--seeds`` repeats all of it for each session seed (the JAX PRNG key, the
port's seed) and ends with the spread. ~12 min a seed on 8 cores at the
chip run's 1080×1920 camera:

    python scripts/torch_gate_witness.py --splat --height 1080 --width 1920 \
        --seeds 12,0,1,2 [--perturb 3]

``--poisson1m`` witnesses the deep rows of bench config 3 instead: first
3c's fine-CG iteration count (``bench.py:1183-1228``; its gate asks for
≤ 30) — the 2²⁰-point noisy cylinder (``chip_smoke.cylinder_cloud``), its
normals estimated once by the port on the host (k = 12, oriented outward
from (0, 0, 500)), then ``reconstruct_sparse(depth=10, cg_iters=100,
max_blocks=196_608)`` on that same numpy cloud and normals in the port and
in the JAX package, one after the other, for each preconditioner named by
``--preconditioners`` (default ``additive``; empty for none): blocks, fine
and coarse iterations, the wall, and χ's largest difference on the band
over max|χ|; then the band set-ups of 3d and 3e (``chip_smoke.
deep_sphere`` at depths 14 and 15, 196,608 slots) in both packages:
block counts, and whether block coordinates and neighbour tables are
equal. ~7 min a preconditioner in the two packages on 8 cores, ~11 GB:

    python scripts/torch_gate_witness.py --poisson1m \
        [--preconditioners additive,jacobi]

The card's normals differ from the host's (on the card ``estimate_normals``
takes the brick kernel, on the host the Morton engine), so 3c is also
witnessed on the card's own: ``--card-normals NPY`` (on a CUDA card; no
JAX imported) computes them as ``chip_smoke.py``'s deep path does, saves
them to NPY and prints the port's 3c iterations there on them; then
``--poisson1m --normals NPY`` runs the 3c rows on the host on those normals
(and skips the 3d/3e set-ups):

    python scripts/torch_gate_witness.py --card-normals n3c.npy
    python scripts/torch_gate_witness.py --poisson1m \
        --normals n3c.npy
"""

from __future__ import annotations

import argparse
import dataclasses
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


def rotation_gap_deg(Ra, Rb) -> float:
    """The angle between two rotations, from the chord ‖Ra − Rb‖_F =
    2√2·sin(θ/2), which stays exact at the small angles where the trace
    formula loses them to float32 rounding."""
    chord = np.linalg.norm(np.asarray(Ra, np.float64)
                           - np.asarray(Rb, np.float64))
    return round(float(np.degrees(2 * np.arcsin(min(
        chord / (2 * np.sqrt(2)), 1.0)))), 5)


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


HELD_OUT = 23


def splat_report(sess, stacks, calib, proj, decode_stop, sr, fit, seed,
                 render):
    """Config 12's numbers for one package's session after stops 0–22,
    and what the cross fit needs: the fresh seed, the padded frame buffer
    and the held-out camera and target."""
    h, w = stacks.shape[2:]
    mesher = sess._mesher
    ts = time.perf_counter()
    scene = mesher.ensure_scene()
    build_s = time.perf_counter() - ts
    _, cols, vals = decode_stop(stacks[HELD_OUT], calib, proj.col_bits,
                                proj.row_bits)
    target, mask = fit.frame_target(np.asarray(cols), np.asarray(vals), h,
                                    w, mesher.stride)
    fx, fy, cx, cy = mesher.intrinsics
    s = float(mesher.stride)
    cam = sr.stop_camera(sess._predict_pose(HELD_OUT), fx / s, fy / s,
                         cx / s, cy / s)
    heldout = (cam, target, mask)

    def psnr(sc, camera, tgt, msk, k=128):
        cfg = sr.RenderConfig(width=tgt.shape[1], height=tgt.shape[0],
                              max_per_tile=k)
        return round(fit.psnr(np.asarray(render(sc, camera, cfg)), tgt,
                              msk), 3)

    fresh = seed(mesher.volume, mesher.splat_params)
    train = [psnr(scene, c, f[0], f[1])
             for f, c in zip(mesher._frames, mesher._cams)]
    seed_train = [psnr(fresh, c, f[0], f[1])
                  for f, c in zip(mesher._frames, mesher._cams)]
    idx = [i % len(mesher._frames) for i in range(mesher.max_frames)]
    buffer = (np.stack([mesher._frames[i][0] for i in idx]),
              np.stack([mesher._frames[i][1] for i in idx]),
              [mesher._cams[i] for i in idx], mesher.fit_iters)
    return {
        "stops_fused": sess.stops_fused,
        "skipped": {str(k): v[0] for k, v in sess._skipped.items()},
        "splats": scene.n_splats, "ensure_scene_s": round(build_s, 3),
        "fit_loss": [scene.fit_stats["fit_loss_first"],
                     scene.fit_stats["fit_loss_last"]],
        "frames": len(mesher._frames), "stride": mesher.stride,
        "heldout_psnr_db": psnr(scene, *heldout),
        "heldout_psnr_db_k512": psnr(scene, *heldout, 512),
        "train_psnr_db": train,
        "train_psnr_db_mean": round(float(np.mean(train)), 3),
        "seed_train_psnr_db_mean": round(float(np.mean(seed_train)), 3),
        "seed_heldout_psnr_db": psnr(fresh, *heldout),
        "seed_heldout_psnr_db_k512": psnr(fresh, *heldout, 512),
    }, dict(scene=scene, fresh=fresh, buffer=buffer, heldout=heldout,
            psnr=psnr)


def perturbed_heldout(n, seed, jvol, tvol, splat_params, t, tfit,
                      tmodel) -> dict:
    """The held-out PSNR's sensitivity to rounding in the fused volume:
    each package's TSDF state (the JAX one carried into the port) seeded
    and fitted by the port with the port's frame buffer, as it stands and
    ``n`` times with every TSDF value moved by ±2⁻²² relative (one or two
    float32 ulps, the size of a different summation order)."""
    from structured_light_for_3d_model_replication_tpu_torch.fusion import (
        TSDFVolume,
    )

    rng = np.random.default_rng(seed)
    frames, masks, cams, iters = t["buffer"]
    st_t = tvol.state
    out = {}
    for name, vol, st in (
            ("jax_volume", jvol, jvol._state),
            ("port_volume", tvol, st_t)):
        arrays = [np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                  for a in (st.dir_map, st.tsdf, st.weight, st.rgb,
                            st.brick_coords, st.n_bricks)]
        psnrs = []
        for i in range(n + 1):
            tsdf = arrays[1] if i == 0 else (arrays[1] * (
                1.0 + 2.0 ** -22 * rng.choice([-1.0, 1.0],
                                              arrays[1].shape))
            ).astype(np.float32)
            carried = TSDFVolume.from_arrays(
                tvol.params, vol.origin, vol.voxel_size, arrays[0], tsdf,
                *arrays[2:], device="cpu")
            scene = tfit.fit_appearance(
                tmodel.seed_from_volume(carried, splat_params),
                frames, masks, cams, iters=iters)
            psnrs.append(t["psnr"](scene, *t["heldout"]))
        out[name] = {"as_fused": psnrs[0], "perturbed": psnrs[1:]}
        out[name]["_arrays"] = arrays
    ja = out["jax_volume"].pop("_arrays")
    ta = out["port_volume"].pop("_arrays")
    out["volume_diff"] = volume_diff(ja, ta)
    # Which field of the volume: the JAX volume with one field (tsdf,
    # weight, rgb) taken from the port's, brick by brick, seeded and fitted
    # as above.
    jb, tb = _bricks(ja), _bricks(ta)
    common = sorted(set(jb) & set(tb))
    ji = np.asarray([jb[c] for c in common], np.int64)
    ti = np.asarray([tb[c] for c in common], np.int64)
    for key, k in (("tsdf", 1), ("weight", 2), ("rgb", 3)):
        hybrid = list(ja)
        hybrid[k] = np.array(ja[k])
        hybrid[k][ji] = ta[k][ti]
        carried = TSDFVolume.from_arrays(
            tvol.params, jvol.origin, jvol.voxel_size, *hybrid,
            device="cpu")
        seeded = tmodel.seed_from_volume(carried, splat_params)
        n = seeded.n_splats
        scene = tfit.fit_appearance(seeded, frames, masks, cams,
                                    iters=iters)
        out[f"jax_volume_with_port_{key}"] = {
            "splats": n, "heldout_psnr_db": t["psnr"](scene, *t["heldout"])}
    return out


def _bricks(a) -> dict:
    """Brick coordinates → row of a volume's state arrays."""
    return {tuple(c): i for i, c in enumerate(a[4][:int(a[5])].tolist())}


def volume_diff(ja, ta) -> dict:
    """The two packages' fused TSDF volumes compared brick by brick (matched
    by brick coordinates): bricks in each and in both, and over the voxels
    both observed (weight > 0), the gaps in tsdf, weight and rgb."""
    jb, tb = _bricks(ja), _bricks(ta)
    common = sorted(set(jb) & set(tb))
    ji = np.asarray([jb[c] for c in common], np.int64)
    ti = np.asarray([tb[c] for c in common], np.int64)

    def take(a, k, idx):
        return a[k][idx].reshape(len(idx), 512, -1).astype(np.float64)

    jw, tw = take(ja, 2, ji)[..., 0], take(ta, 2, ti)[..., 0]
    both = (jw > 0) & (tw > 0)
    either = (jw > 0) | (tw > 0)
    gaps = {}
    for key, k in (("tsdf", 1), ("weight", 2), ("rgb", 3)):
        d = np.abs(take(ja, k, ji) - take(ta, k, ti))[both]
        gaps[key] = {"max": float(d.max()), "median": float(np.median(d)),
                     "p99": float(np.quantile(d, 0.99))}
    return {"bricks": [len(jb), len(tb), len(common)],
            "voxels_observed_both": int(both.sum()),
            "voxels_observed_one": int((either & ~both).sum()),
            "weight_sum": [float(jw.sum()), float(tw.sum())], **gaps}


def splat_witness(args) -> int:
    """Bench config 12 in both packages on one ring, once per session seed
    (module docstring)."""
    import jax
    import torch

    import chip_smoke
    from structured_light_for_3d_model_replication_tpu.models import (
        merge as jmerge,
    )
    from structured_light_for_3d_model_replication_tpu.models import (
        scan360 as jscan,
    )
    from structured_light_for_3d_model_replication_tpu.ops import (
        splat_render as jsr,
    )
    from structured_light_for_3d_model_replication_tpu.ops.triangulate import (
        make_calibration as jcalib,
    )
    from structured_light_for_3d_model_replication_tpu.splat import (
        fit as jfit,
    )
    from structured_light_for_3d_model_replication_tpu.splat import (
        model as jmodel,
    )
    from structured_light_for_3d_model_replication_tpu.stream import (
        session as jsession,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        merge as tmerge,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        scan360 as tscan,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        splat_render as tsr,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
        make_calibration as tcalib,
    )
    from structured_light_for_3d_model_replication_tpu_torch.splat import (
        fit as tfit,
    )
    from structured_light_for_3d_model_replication_tpu_torch.splat import (
        model as tmodel,
    )
    from structured_light_for_3d_model_replication_tpu_torch.stream import (
        session as tsession,
    )

    t0 = time.perf_counter()
    stacks, rig, proj, _ = render(args.height, args.width)
    h, w = args.height, args.width
    print(f"rendered {stacks.shape} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    merge_kw = dict(voxel_size=3.0, final_max_points=131_072,
                    step_deg=STEP_DEG)
    tp = chip_smoke.splat_params(tmerge.MergeParams(**merge_kw))
    jp = jsession.StreamParams(
        merge=jmerge.MergeParams(**merge_kw), expected_stops=N_STOPS,
        **{f.name: getattr(tp, f.name)
           for f in dataclasses.fields(tp) if f.name != "merge"})
    jcal = jcalib(*rig, h, w, proj_width=proj.width, proj_height=proj.height)
    tcal = tcalib(*rig, h, w, proj.width, proj.height,
                  device=torch.device("cpu"))

    def jrender(sc, cam, cfg):
        return sc.render_camera(cam, cfg, use_pallas=False)[0]

    def trender(sc, cam, cfg):
        return sc.render_camera(cam, cfg)[0].numpy()

    runs = []
    for seed in args.seeds:
        jsess = jsession.IncrementalSession(
            jcal, proj.col_bits, proj.row_bits, params=jp,
            key=jax.random.PRNGKey(seed), scan_id="witness-jax-splat")
        tsess = tsession.IncrementalSession(
            tcal, proj.col_bits, proj.row_bits, params=tp, seed=seed,
            scan_id="witness-torch-splat", device="cpu")
        for k in range(HELD_OUT):
            for sess in (jsess, tsess):
                sess.add_stop(stacks[k])
        print(f"seed {seed}: stops 0-{HELD_OUT - 1} streamed", flush=True)
        out = {"seed": seed}
        out["jax"], j = splat_report(
            jsess, stacks, jcal, proj, jscan.decode_stop, jsr, jfit,
            jmodel.seed_from_volume, jrender)
        out["torch"], t = splat_report(
            tsess, stacks, tcal, proj, tscan.decode_stop, tsr, tfit,
            tmodel.seed_from_volume, trender)
        # The cross fit: each package's fresh seed, frame buffer and
        # held-out view fitted and rendered by the other package. Where a
        # state gives the same held-out PSNR under both fits, the packages'
        # gap comes from the session state (poses, TSDF, frames), not from
        # the seed pass, the fit or the renderer.
        frames, masks, cams, iters = j["buffer"]
        on_j = tfit.fit_appearance(
            tmodel.SplatScene.from_bytes(j["fresh"].to_bytes(),
                                         device="cpu"),
            frames, masks, cams, iters=iters)
        out["jax"]["heldout_psnr_db_port_fit"] = t["psnr"](on_j,
                                                           *j["heldout"])
        frames, masks, cams, iters = t["buffer"]
        on_t = jmodel.SplatScene.from_bytes(t["fresh"].to_bytes())
        jfit.fit_appearance(on_t, frames, masks, cams, iters=iters)
        out["torch"]["heldout_psnr_db_jax_fit"] = j["psnr"](on_t,
                                                            *t["heldout"])
        # Which part of the state: the frame buffers compared, the
        # buffered cameras' poses compared, and the port's fit of each
        # package's seed and frames with the other package's cameras.
        jf, jm, jc, _ = j["buffer"]
        tf, tm, tc, _ = t["buffer"]
        out["state"] = {
            "frames_max_abs_diff": float(np.abs(jf - tf).max())
            if jf.shape == tf.shape else None,
            "masks_equal": bool(np.array_equal(jm, tm)),
            "cam_rot_diff_deg": [rotation_gap_deg(a[0], b[0])
                                 for a, b in zip(jc, tc)],
            "cam_eye_diff_mm": [round(float(np.linalg.norm(
                np.asarray(a[1], np.float64) - np.asarray(b[1], np.float64))),
                4) for a, b in zip(jc, tc)],
            "heldout_cam_rot_diff_deg": rotation_gap_deg(
                j["heldout"][0][0], t["heldout"][0][0]),
            "heldout_cam_eye_diff_mm": round(float(np.linalg.norm(
                np.asarray(j["heldout"][0][1], np.float64)
                - np.asarray(t["heldout"][0][1], np.float64))), 4),
        }
        swap = tfit.fit_appearance(
            tmodel.SplatScene.from_bytes(j["fresh"].to_bytes(),
                                         device="cpu"),
            jf, jm, tc, iters=iters)
        out["state"]["jax_seed_frames_port_cams"] = t["psnr"](
            swap, *j["heldout"])
        swap = tfit.fit_appearance(
            tmodel.SplatScene.from_bytes(t["fresh"].to_bytes(),
                                         device="cpu"),
            tf, tm, jc, iters=iters)
        out["state"]["port_seed_frames_jax_cams"] = t["psnr"](
            swap, *t["heldout"])
        if args.perturb:
            out["perturbed"] = perturbed_heldout(
                args.perturb, seed, jsess._mesher.volume,
                tsess._mesher.volume, tsess._mesher.splat_params, t, tfit,
                tmodel)
        cfg = tsr.RenderConfig(width=t["heldout"][1].shape[1],
                               height=t["heldout"][1].shape[0],
                               max_per_tile=t["scene"].capacity)
        sc = t["scene"]
        recs = tsr._tile_records(
            sc.means, sc.normals, sc.log_scales, sc.colors_sh, sc.opacity,
            sc.valid, *tsr.camera_tensors(t["heldout"][0], "cpu"), cfg)[0]
        members = recs[9].sum(1)
        members = members[members > 0].to(torch.float64)
        out["torch"]["tile_members_at_heldout"] = {
            "tiles_touched": int(members.numel()),
            "median": float(members.median()), "max": int(members.max()),
            "share_over_128": round(float((members > 128).double().mean()),
                                    4)}
        print(f"seed {seed}: " + json.dumps(out), flush=True)
        runs.append(out)
        del jsess, tsess, j, t, on_j, on_t, swap
    spread = {
        name: {key: [r[name][key] for r in runs] for key in (
            "heldout_psnr_db", "train_psnr_db_mean", "seed_heldout_psnr_db",
            "seed_train_psnr_db_mean", "splats")}
        for name in ("jax", "torch")}
    print(json.dumps({"camera": [h, w], "config": 12, "spread": spread,
                      "runs": runs}), flush=True)
    return 0


def poisson1m_witness(args) -> int:
    """Bench config 3c in both packages on one cloud and its normals."""
    import gc

    import jax.numpy as jnp
    import torch

    import chip_smoke
    from structured_light_for_3d_model_replication_tpu.ops import (
        poisson_sparse as jps,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        pointcloud,
        poisson_sparse as tps,
    )

    pts = chip_smoke.cylinder_cloud(1 << 20, 0)
    pt = torch.from_numpy(pts)
    t0 = time.perf_counter()
    if args.normals:
        nrm_np = np.load(args.normals)
        nrm = torch.from_numpy(nrm_np)
        print(f"normals of {len(pts)} points from {args.normals}",
              flush=True)
    else:
        nrm = pointcloud.estimate_normals(pt, k=chip_smoke.NORMALS_K)[0]
        nrm = pointcloud.orient_normals(
            pt, nrm, torch.tensor([0.0, 0.0, 500.0]), outward=True)
        nrm_np = nrm.numpy()
        print(f"normals of {len(pts)} points in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    records = []
    for pre in args.preconditioners:
        kw = dict(depth=10, cg_iters=100, max_blocks=196_608,
                  preconditioner=pre, with_stats=True)
        t0 = time.perf_counter()
        g_t, nb_t, st_t = tps.reconstruct_sparse(pt, nrm, **kw)
        t_port = time.perf_counter() - t0
        chi_t = g_t.chi.numpy()
        del g_t
        gc.collect()
        t0 = time.perf_counter()
        g_j, nb_j, st_j = jps.reconstruct_sparse(pts, nrm_np, **kw)
        t_jax = time.perf_counter() - t0
        bv = np.asarray(g_j.block_valid)
        chi_j = np.asarray(g_j.chi)
        del g_j
        rec = {"preconditioner": pre, "blocks": [nb_t, int(nb_j)],
               "cg_iters_used": [st_t["cg_iters_used"],
                                 st_j["cg_iters_used"]],
               "coarse_iters_used": [st_t["coarse_iters_used"],
                                     st_j["coarse_iters_used"]],
               "wall_s": [t_port, t_jax],
               "chi_rel_diff": float(np.abs(chi_t[bv] - chi_j[bv]).max()
                                     / np.abs(chi_j).max())}
        del chi_t, chi_j, bv
        gc.collect()
        records.append(rec)
        print(f"3c {pre} (port, JAX): {json.dumps(rec)}", flush=True)
    for label, depth, r_sphere in (() if args.normals else (
            ("3d", 14, 50.0), ("3e", 15, 25.0))):
        pts, nrm_np = chip_smoke.deep_sphere(1 << 20, r_sphere)
        n = pts.shape[0]
        t = tps._setup_sparse(torch.from_numpy(pts), torch.from_numpy(nrm_np),
                              torch.ones(n, dtype=torch.bool), 2 ** depth,
                              196_608, torch.tensor(4.0))
        t = {"n_blocks": int(t[11]), "block_coords": t[4].numpy(),
             "nbr": t[2].numpy()}
        gc.collect()
        j = jps._setup_sparse(jnp.asarray(pts), jnp.asarray(nrm_np),
                              jnp.ones((n,), bool), 2 ** depth, 196_608,
                              jnp.float32(4.0))
        rec = {"row": label, "blocks": [t["n_blocks"], int(j[11])],
               "block_coords_equal": bool(np.array_equal(
                   t["block_coords"], np.asarray(j[4]))),
               "nbr_equal": bool(np.array_equal(t["nbr"], np.asarray(j[2])))}
        del t, j
        gc.collect()
        records.append(rec)
        print(f"{label} set-up (port, JAX): {json.dumps(rec)}", flush=True)
    print(json.dumps({"poisson1m": records}), flush=True)
    return 0


def card_normals(args) -> int:
    """Bench 3c's normals on the card, saved; the port's 3c solve on them
    there."""
    import torch

    import chip_smoke
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        pointcloud,
        poisson_sparse as tps,
    )

    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    pts = torch.from_numpy(chip_smoke.cylinder_cloud(1 << 20, 0)).to(dev)
    nrm = pointcloud.estimate_normals(pts, k=chip_smoke.NORMALS_K)[0]
    nrm = pointcloud.orient_normals(
        pts, nrm, torch.tensor([0.0, 0.0, 500.0], device=dev), outward=True)
    np.save(args.card_normals, nrm.cpu().numpy())
    _, nb, st = tps.reconstruct_sparse(
        pts, nrm, depth=10, cg_iters=100, max_blocks=196_608,
        with_stats=True)
    print(json.dumps({"card_normals": args.card_normals, "blocks": nb,
                      "cg_iters_used": st["cg_iters_used"],
                      "coarse_iters_used": st["coarse_iters_used"]}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--splat", action="store_true",
                    help="witness bench config 12 (the splat tier) instead "
                         "of the gate")
    ap.add_argument("--seeds", type=lambda v: [int(x) for x in v.split(",")],
                    default=[12],
                    help="--splat: comma-separated session seeds (the JAX "
                         "session's PRNG key and the port's seed); bench "
                         "[12] uses 12")
    ap.add_argument("--perturb", type=int, default=0,
                    help="--splat: also refit each package's volume this "
                         "many times with its TSDF moved by a float32 ulp "
                         "or two")
    ap.add_argument("--poisson1m", action="store_true",
                    help="witness bench config 3c's fine-CG iterations in "
                         "both packages instead of the gate")
    ap.add_argument("--preconditioners",
                    type=lambda v: [p for p in v.split(",") if p],
                    default=["additive"],
                    help="--poisson1m: comma-separated preconditioners")
    ap.add_argument("--normals", metavar="NPY",
                    help="--poisson1m: 3c's normals from NPY (as "
                         "--card-normals saves them), the 3c rows only")
    ap.add_argument("--card-normals", metavar="NPY",
                    help="on a CUDA card: save 3c's normals to NPY and "
                         "solve 3c there on them (no JAX)")
    args = ap.parse_args()
    if args.card_normals:
        return card_normals(args)

    import jax
    import torch

    torch.set_num_threads(args.threads)
    jax.config.update("jax_platforms", "cpu")
    if args.splat:
        return splat_witness(args)
    if args.poisson1m:
        return poisson1m_witness(args)

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
