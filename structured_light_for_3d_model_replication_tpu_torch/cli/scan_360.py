"""``scan-360``: per-stop capture folders → merged PLY, on the card
(counterpart of the JAX tool).

The whole post-capture path of the reference (per-stop `generate_cloud`,
then the merge tab) as one run (:func:`..models.scan360.
scan_folders_to_cloud`), or with ``--stream`` as an incremental session that
previews after every stop. Stops are the subfolders of the session folder
that hold frames, numerically sorted — the auto-scan layout
(`server/gui.py:703-740`).
"""

from __future__ import annotations

import argparse
import os
import re
import sys

from ._args import add_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="scan-360",
        description="Decode, triangulate, register and merge a full 360° "
                    "session in one run")
    p.add_argument("--input", "-i", required=True,
                   help="session folder whose subfolders are per-stop scans")
    p.add_argument("--calib", "-c", required=True, help=".mat calibration")
    p.add_argument("--output", "-o", required=True, help="merged .ply")
    p.add_argument("--method", choices=("sequential", "posegraph"),
                   default="posegraph")
    p.add_argument("--voxel-size", type=float, default=0.02)
    p.add_argument("--max-points", type=int, default=16_384)
    p.add_argument("--stop-chunk", type=int, default=6,
                   help="stops decoded per device call (bounds the dense "
                        "per-pixel temporaries)")
    p.add_argument("--fused", action="store_true",
                   help="stage every stack on the device and read the "
                        "result back in one copy (the batched ring)")
    p.add_argument("--step-deg", type=float, default=None,
                   help="commanded turntable advance per stop; feeds the "
                        "axis-consensus prior. Default: parsed from an "
                        "'..._<deg>deg_AUTO' session folder name when "
                        "present")
    p.add_argument("--stl", default=None,
                   help="also mesh the merged cloud to this path (watertight "
                        "screened Poisson by default). A .ply extension "
                        "writes a vertex-colored mesh instead of STL — pair "
                        "it with --representation tsdf to keep the scan's "
                        "colors")
    p.add_argument("--mesh-depth", type=int, default=8)
    s = p.add_argument_group("streaming")
    s.add_argument("--stream", action="store_true",
                   help="fuse stops incrementally: per-stop coarse mesh "
                        "previews, covisibility gate on redundant stops, "
                        "the same final merge math")
    s.add_argument("--preview-out", default=None, metavar="PATH",
                   help="progressive preview STL path (default "
                        "<output>.preview.stl), rewritten after every "
                        "fused stop")
    s.add_argument("--preview-depth", type=int, default=6,
                   help="coarse Poisson depth of the per-stop previews")
    s.add_argument("--preview-every", type=int, default=1,
                   help="emit a preview every N fused stops (0 = off)")
    s.add_argument("--representation",
                   choices=("tsdf", "archival", "poisson", "splat"),
                   default="tsdf",
                   help="scene representation (batch and --stream): 'tsdf' "
                        "(default) fuses into a brick volume, and the final "
                        "mesh carries vertex color when --stl names a .ply; "
                        "'archival' keeps the TSDF previews but makes the "
                        "final artifact the watertight Poisson solve; "
                        "'poisson' the coarse Poisson re-solve previews "
                        "too; 'splat' adds the Gaussian appearance tier — "
                        "rendered previews (--preview-render) and a "
                        "saveable scene (--save-scene). Streaming only; the "
                        "batch path treats it as 'tsdf'")
    s.add_argument("--preview-render", action="store_true",
                   help="with --stream --representation splat: also "
                        "rewrite a rendered novel-view PNG "
                        "(<output>.preview.png) after every fused stop")
    s.add_argument("--save-scene", default=None, metavar="PATH",
                   help="with --stream --representation splat: save the "
                        "fitted splat scene (.npz) at the end — `cli "
                        "render` reproduces the renders offline")
    g = p.add_argument_group("quality gates")
    g.add_argument("--no-gates", action="store_true",
                   help="disable the quality gates (abort-on-anything "
                        "reference behavior)")
    g.add_argument("--min-coverage", type=float, default=0.02,
                   help="drop stops whose decoded-valid pixel fraction is "
                        "below this (bridged out of the ring)")
    g.add_argument("--min-edge-fitness", type=float, default=0.2,
                   help="reject ring edges below this ICP fitness "
                        "(consensus-repaired / down-weighted)")
    g.add_argument("--max-edge-rmse", type=float, default=None,
                   help="optional absolute inlier-RMSE ceiling per edge")
    g.add_argument("--health-json", default=None, metavar="PATH",
                   help="write the scan health report (per-stop coverage, "
                        "dropped stops, edge verdicts) as JSON here")
    add_device(p)
    return p


def stop_folders(session: str) -> list[str]:
    """The session's subfolders that hold frames, numerically sorted. A
    partially captured stop (fewer frames than the fullest) is skipped, and
    said so."""
    from ..io.images import list_frames, numeric_sort
    from .process_cloud import has_frames

    subs = numeric_sort([
        os.path.join(session, s) for s in os.listdir(session)
        if os.path.isdir(os.path.join(session, s))])
    stop_dirs = [s for s in subs if has_frames(s)]
    counts = {d: len(list_frames(d)) for d in stop_dirs}
    if counts:
        full = max(counts.values())
        ragged = [d for d in stop_dirs if counts[d] < full]
        if ragged:
            print(f"skipping {len(ragged)} partial stop folder(s) "
                  f"(fewer than {full} frames): "
                  f"{[os.path.basename(d) for d in ragged]}",
                  file=sys.stderr)
            stop_dirs = [d for d in stop_dirs if counts[d] == full]
    return stop_dirs


def session_step(args) -> float | None:
    """``--step-deg``, else the step the auto-scan layout encodes in the
    session folder's name, ``<base>_<deg>deg_AUTO``
    (`server/gui.py:703-740`)."""
    if args.step_deg is not None:
        return args.step_deg
    m = re.search(r"_(\d+(?:\.\d+)?)deg_AUTO$",
                  os.path.basename(os.path.normpath(args.input)))
    if not m:
        return None
    print(f"turntable step {float(m.group(1))}° (from session folder name)",
          file=sys.stderr)
    return float(m.group(1))


def stop_labels(stop_dirs: list[str], step_deg: float | None):
    """Physical stop indices from the stop folders' ``_<angle>deg_scan``
    names when the step is known (so a session with capture-skipped stops
    reports health by real stop and bridges true gaps); None otherwise."""
    if not step_deg:
        return None
    angles = []
    for d in stop_dirs:
        m = re.search(r"_(\d+(?:\.\d+)?)deg_scan$",
                      os.path.basename(os.path.normpath(d)))
        if not m:
            return None
        angles.append(float(m.group(1)))
    labs = [round(a / step_deg) for a in angles]
    return labs if labs and labs == sorted(set(labs)) else None


def quality_gates(args):
    from ..health import QualityGates

    return None if args.no_gates else QualityGates(
        min_coverage=args.min_coverage,
        min_edge_fitness=args.min_edge_fitness,
        max_edge_rmse=args.max_edge_rmse)


def batch_params(args, step_deg: float | None):
    """The :class:`..models.scan360.Scan360Params` of the batch form."""
    from ..models import merge, scan360

    return scan360.Scan360Params(
        merge=merge.MergeParams(voxel_size=args.voxel_size,
                                max_points=args.max_points,
                                step_deg=step_deg),
        method=args.method,
        fused=args.fused,
        stop_chunk=args.stop_chunk,
        gates=quality_gates(args))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .._device import resolve_device
    from ..health import ScanHealthReport

    dev = resolve_device(args.device)
    stop_dirs = stop_folders(args.input)
    if len(stop_dirs) < 2:
        raise SystemExit(f"{args.input}: need ≥2 per-stop frame folders, "
                         f"found {len(stop_dirs)}")
    step_deg = session_step(args)
    labels = stop_labels(stop_dirs, step_deg)
    health = ScanHealthReport()
    if args.stream:
        return _run_stream(args, stop_dirs, step_deg, labels, health, dev)

    from ..models import scan360

    merged, _ = scan360.scan_folders_to_cloud(
        stop_dirs, args.calib, output_path=args.output,
        params=batch_params(args, step_deg), health=health,
        stop_labels=labels, device=dev)
    print(f"{len(stop_dirs)} stops -> {args.output} ({len(merged)} points)",
          file=sys.stderr)
    if health.dropped_stops:
        print(f"degraded: stops {health.dropped_stops} dropped by the "
              f"coverage gate (see --health-json)", file=sys.stderr)
    if args.stl:
        _mesh_batch(args, merged, health, dev)
    health.emit()
    if args.health_json:
        health.write(args.health_json)
    return 0


def _mesh_batch(args, merged, health, dev) -> None:
    """``--stl`` after the batch form. A meshing failure (or an empty mesh)
    degrades to "the merged PLY is kept" and the run still exits 0."""
    from ..models import meshing

    # The batch path has no per-stop frames to fit appearance from:
    # 'splat' degrades to its geometry half (the coloured TSDF mesh).
    representation = "tsdf" if args.representation == "splat" \
        else args.representation
    to_ply = args.stl.lower().endswith(".ply")
    if representation == "tsdf" and not to_ply:
        print("note: --representation tsdf meshes carry vertex color only "
              "into a .ply output; STL drops it", file=sys.stderr)
    try:
        if to_ply:
            from ..io import ply as ply_io

            # quantile_trim 0.0 = the mesh_360 watertight default: the
            # output extension must not change the geometry.
            mesh = meshing.mesh_from_cloud(
                merged, depth=args.mesh_depth, quantile_trim=0.0,
                representation=representation, device=dev)
            ply_io.write_ply_mesh(args.stl, mesh)
        else:
            mesh = meshing.mesh_360(merged, args.stl, depth=args.mesh_depth,
                                    representation=representation,
                                    device=dev)
    except Exception as e:  # the terminal guard: the cloud is already out
        health.note("meshing failed (%s) — merged cloud kept at %s", e,
                    args.output)
        print(f"meshing failed: {e} (cloud kept at {args.output})",
              file=sys.stderr)
        return
    if len(mesh.faces) == 0:
        health.note("mesh has zero faces — treat %s as unusable, merged "
                    "cloud kept at %s", args.stl, args.output)
    print(f"meshed -> {args.stl} ({len(mesh.faces)} faces)", file=sys.stderr)


def _run_stream(args, stop_dirs, step_deg, labels, health, dev) -> int:
    """``--stream``: replay the stop folders through an incremental session
    — a preview after every fused stop, the batch form's final merge
    math."""
    import math
    import time

    from ..health import ScanFault
    from ..io import images as img_io
    from ..io import matcal
    from ..io import ply as ply_io
    from ..io.stl import write_stl
    from ..models import merge
    from ..stream import IncrementalSession, StreamParams

    first = img_io.load_stack(stop_dirs[0])
    _, h, w = first.shape
    cal = matcal.load_calibration_mat(args.calib, h, w, device=dev)
    col_bits = math.ceil(math.log2(cal.plane_cols.shape[0]))
    row_bits = math.ceil(math.log2(cal.plane_rows.shape[0]))
    expect = 2 + 2 * (col_bits + row_bits)
    if first.shape[0] != expect:
        raise SystemExit(
            f"stack has {first.shape[0]} frames but {col_bits}+{row_bits} "
            f"bits imply {expect}")
    labels = labels or list(range(len(stop_dirs)))
    params = StreamParams(
        merge=merge.MergeParams(voxel_size=args.voxel_size,
                                max_points=args.max_points,
                                step_deg=step_deg),
        method=args.method,
        gates=quality_gates(args),
        preview_depth=args.preview_depth,
        preview_every=args.preview_every,
        representation=args.representation,
        final_depth=args.mesh_depth,
        expected_stops=max(labels) + 1)
    sess = IncrementalSession(cal, col_bits, row_bits, params=params,
                              health=health, device=dev)
    preview_path = args.preview_out or (args.output + ".preview.stl")
    render_path = args.output + ".preview.png"
    want_render = args.preview_render and args.representation == "splat"
    if args.preview_render and not want_render:
        print("--preview-render needs --representation splat; ignored",
              file=sys.stderr)
    t0 = time.monotonic()
    first_preview_s = None
    for k, d in enumerate(stop_dirs):
        stack = first if k == 0 else img_io.load_stack(d)
        res = sess.add_stop(stack, stop=labels[k])
        print(f"stop {labels[k]}: {res.reason} (coverage {res.coverage:.3f}"
              + (f", fitness {res.fitness:.3f}" if res.fitness is not None
                 else "")
              + f", {res.seconds:.1f}s)", file=sys.stderr)
        if want_render and res.fused:
            # The rendered novel view is rebuilt after every fused stop,
            # whatever the mesh preview's cadence.
            img = sess.previewer.render_image(30.0, 20.0)
            if img is not None:
                from ..io.png import write_png

                write_png(render_path, img)
        if res.preview and sess.preview is not None:
            if preview_path.lower().endswith(".ply"):
                ply_io.write_ply_mesh(preview_path, sess.preview)
            else:
                write_stl(preview_path, sess.preview)
            if first_preview_s is None:
                first_preview_s = time.monotonic() - t0
                print(f"first preview {first_preview_s:.1f}s after stop "
                      f"{labels[k]} -> {preview_path} "
                      f"({len(sess.preview.faces)} faces)"
                      + (f" + render -> {render_path}" if want_render
                         else ""),
                      file=sys.stderr)
    try:
        fin = sess.finalize(mesh=bool(args.stl))
    except ScanFault as e:
        # Too few fused stops (gates or covisibility skipped the rest): end
        # with the health story and whatever preview exists.
        health.note("stream finalize failed: %s", e)
        print(f"finalize failed: {e}"
              + (f" — latest preview kept at {preview_path}"
                 if first_preview_s is not None else ""),
              file=sys.stderr)
        health.emit()
        if args.health_json:
            health.write(args.health_json)
        return 1
    ply_io.write_ply(args.output, fin.cloud)
    print(f"{sess.stops_fused} fused / {sess.stops_skipped} skipped "
          f"stops -> {args.output} ({len(fin.cloud)} points)",
          file=sys.stderr)
    if args.save_scene:
        if args.representation == "splat":
            data = sess.previewer.scene_bytes()
            if data is not None:
                with open(args.save_scene, "wb") as f:
                    f.write(data)
                print(f"splat scene -> {args.save_scene} ({len(data)} B; "
                      f"render offline with `cli render`)", file=sys.stderr)
        else:
            print("--save-scene needs --representation splat; ignored",
                  file=sys.stderr)
    if args.stl and fin.mesh is not None:
        colored = getattr(fin.mesh, "vertex_colors", None) is not None
        if args.stl.lower().endswith(".ply"):
            ply_io.write_ply_mesh(args.stl, fin.mesh)
        else:
            if colored:
                print("note: STL drops the mesh's vertex colors — name a "
                      ".ply with --stl to keep them", file=sys.stderr)
                colored = False
            write_stl(args.stl, fin.mesh)
        print(f"meshed -> {args.stl} ({len(fin.mesh.faces)} faces"
              f"{', colored' if colored else ''})", file=sys.stderr)
    health.emit()
    if args.health_json:
        health.write(args.health_json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
