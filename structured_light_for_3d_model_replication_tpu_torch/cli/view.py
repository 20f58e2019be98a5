"""``view``: render a cloud/mesh to PNG — the headless viewer (the port's
copy of the JAX package's ``cli/view.py``).

The reference eyeballs every stage through interactive Open3D windows:
inlier/outlier coloring (`Old/StatisticalOutlierRemoval.py:66-71`),
before/after pair alignment (`Old/New360.py:72-73`), plane-split preview
(`Old/blackground_remove.py:23`) and the final mesh (`Old/360Merge.py:125`).
On a headless host the equivalent is a PNG: this tool renders any
``.ply``/``.stl`` with the same coloring conventions via ``viz``.

Modes::

    view cloud.ply -o out.png                 # plain (stored colors/depth cue)
    view cloud.ply --outliers -o out.png      # SOR: inliers grey, rejects red
    view cloud.ply --plane -o out.png         # RANSAC plane green vs object
    view a.ply --compare b.ply [--icp] ...    # pair before|after panel
    view mesh.stl -o out.png                  # shaded mesh render

The rendering is host numpy (``viz``); ``--outliers`` (the SOR's KNN),
``--plane`` (RANSAC) and ``--icp`` (RANSAC + ICP) compute on ``--device``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ._args import add_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="view",
                                description="Render a .ply/.stl to a PNG")
    p.add_argument("input", help="input .ply or .stl")
    p.add_argument("--output", "-o", required=True, help="output .png")
    p.add_argument("--outliers", action="store_true",
                   help="color statistical-outlier rejects red "
                        "(nb=20, std=2.0 — the reference defaults)")
    p.add_argument("--plane", action="store_true",
                   help="color the dominant RANSAC plane green")
    p.add_argument("--plane-threshold", type=float, default=None,
                   help="RANSAC plane distance threshold; default derives "
                        "from the cloud scale (bbox diagonal / 50 — ≈ the "
                        "reference's 10.0 on its mm-scale scans)")
    p.add_argument("--compare", metavar="OTHER",
                   help="second cloud: render a before|after pair panel")
    p.add_argument("--icp", action="store_true",
                   help="with --compare: register input onto OTHER "
                        "(RANSAC+ICP) and show the aligned pair on the right")
    p.add_argument("--no-color", action="store_true",
                   help="ignore stored colors (depth-cued grey)")
    p.add_argument("--azim", type=float, default=30.0)
    p.add_argument("--elev", type=float, default=20.0)
    p.add_argument("--zoom", type=float, default=2.1)
    p.add_argument("--size", default="960x720", help="WxH (default 960x720)")
    p.add_argument("--point-px", type=int, default=2)
    add_device(p)
    return p


def outlier_mask(points, device) -> np.ndarray:
    """The SOR keep mask of ``--outliers`` (nb = 20, std = 2.0) on
    ``device``: the port's ``statistical_outlier_removal`` with its
    ``"auto"`` KNN engine."""
    import torch

    from ..ops import pointcloud

    keep = pointcloud.statistical_outlier_removal(
        torch.as_tensor(np.asarray(points, np.float32), device=device),
        nb_neighbors=20, std_ratio=2.0)
    return keep.cpu().numpy()[: len(points)]


def plane_threshold(points) -> float:
    """``--plane``'s default threshold: bbox diagonal / 50."""
    # Scale-free default: a fixed 10.0 is the reference's unit choice;
    # clouds in other units got an all-or-nothing preview.
    diag = float(np.linalg.norm(np.ptp(np.asarray(points, np.float64),
                                       axis=0)))
    return max(diag / 50.0, 1e-9)


def plane_mask(points, threshold: float, device) -> np.ndarray:
    """The dominant RANSAC plane's inlier mask of ``--plane`` on
    ``device`` (1,000 hypotheses)."""
    import torch

    from ..ops import segmentation

    _, inl = segmentation.segment_plane(
        torch.as_tensor(np.asarray(points, np.float32), device=device),
        distance_threshold=threshold, num_iterations=1000)
    return inl.cpu().numpy()[: len(points)]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        w, h = (int(x) for x in args.size.lower().split("x"))
    except ValueError:
        print(f"bad --size {args.size!r}, expected WxH", file=sys.stderr)
        return 2
    kw = dict(width=w, height=h, azim=args.azim, elev=args.elev,
              zoom=args.zoom)

    from .. import viz

    if args.input.lower().endswith(".stl"):
        from ..io import stl as stl_io

        mesh = stl_io.read_stl(args.input)
        img = viz.render_mesh(mesh.vertices, mesh.faces, **kw)
        viz.save_png(args.output, img)
        print(f"{args.input}: {len(mesh.faces)} faces -> {args.output}",
              file=sys.stderr)
        return 0

    from ..io import ply as ply_io

    cloud = ply_io.read_ply(args.input)
    pts = cloud.points
    colors = None if args.no_color else cloud.colors

    if args.compare:
        other = ply_io.read_ply(args.compare)
        transform = None
        if args.icp:
            from ..models import merge as merge_mod

            res, _ = merge_mod.register_pair_clouds(cloud, other,
                                                    device=args.device)
            transform = res.transformation.cpu().numpy()
            print(f"icp: fitness={float(res.fitness):.3f} "
                  f"rmse={float(res.inlier_rmse):.4f}", file=sys.stderr)
        img = viz.render_pair(pts, other.points, transform,
                              width=2 * w, height=h, azim=args.azim,
                              elev=args.elev, zoom=args.zoom,
                              point_px=args.point_px)
    elif args.outliers:
        keep = outlier_mask(pts, args.device)
        img = viz.render_inliers(pts, keep, point_px=args.point_px, **kw)
        print(f"outliers: {int((~keep).sum())}/{len(pts)} rejected",
              file=sys.stderr)
    elif args.plane:
        thresh = args.plane_threshold
        if thresh is None:
            thresh = plane_threshold(pts)
        pm = plane_mask(pts, thresh, args.device)
        img = viz.render_plane_split(pts, pm, point_px=args.point_px, **kw)
        print(f"plane: {int(pm.sum())}/{len(pts)} points on the plane "
              f"(threshold {thresh:.3g})", file=sys.stderr)
    else:
        img = viz.render_points(pts, colors, point_px=args.point_px, **kw)

    viz.save_png(args.output, img)
    print(f"{args.input}: {len(pts)} pts -> {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
