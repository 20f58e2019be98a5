"""``mesh``: point cloud → STL surface (counterpart of the JAX tool).

The two GUI meshing actions (`server/gui.py:643-684` →
`ProcessingLogic.mesh_360` / `reconstruct_stl`, `server/processing.py:
184-310`) as one CLI: watertight screened Poisson or the ball-pivoted
surface mode, with density-quantile trimming and a choice of normal
orientation. Optional cleanup passes mirror the Process tab
(`remove_background` / `remove_outliers`, `server/processing.py:24-76`).
"""

from __future__ import annotations

import argparse
import sys

from ._args import add_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mesh",
        description="Mesh a .ply cloud into an .stl (or a vertex-"
                    "colored mesh .ply)")
    p.add_argument("--input", "-i", required=True, help="input .ply")
    p.add_argument("--output", "-o", required=True,
                   help="output mesh: .stl, or .ply for a vertex-"
                        "colored PLY mesh (colors need "
                        "--representation tsdf and a colored cloud)")
    p.add_argument("--mode", choices=("watertight", "surface"),
                   default="watertight")
    p.add_argument("--depth", type=int, default=8,
                   help="Poisson octree-equivalent depth (2^depth virtual "
                        "grid; ≤8 dense, 9-16 band-sparse — the reference "
                        "defaults its octree to depth 10 and caps at 16)")
    p.add_argument("--trim", type=float, default=0.0,
                   help="density quantile to trim (0.0 = watertight "
                        "mesh_360 default, 0.02 = reconstruct_stl default)")
    p.add_argument("--orientation", choices=("radial", "tangent"),
                   default="radial",
                   help="normal orientation (server/processing.py:270-289)")
    p.add_argument("--radii", default="1,2,4",
                   help="surface mode: ball-pivot radii as multipliers of "
                        "the average NN distance (the reference GUI's "
                        "radii list, server/processing.py:222-235)")
    p.add_argument("--remove-background", action="store_true",
                   help="drop the dominant RANSAC plane first")
    p.add_argument("--remove-outliers", action="store_true",
                   help="statistical outlier removal first (20, 2.0)")
    p.add_argument("--preconditioner",
                   choices=("additive", "vcycle", "chebyshev", "jacobi"),
                   default="additive",
                   help="fine-band CG preconditioner of the deep (sparse) "
                        "Poisson path")
    p.add_argument("--extraction", choices=("auto", "host", "device"),
                   default="auto",
                   help="iso-surface extractor: device marching on the "
                        "card, the host oracle on the CPU (auto), or force "
                        "either engine")
    p.add_argument("--representation", choices=("poisson", "tsdf"),
                   default="poisson",
                   help="scene representation: 'poisson' watertight print "
                        "path, 'tsdf' the fused brick-grid path — open "
                        "surfaces, per-vertex colour carried into a .ply "
                        "output")
    add_device(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .._device import resolve_device
    from ..io import ply as ply_io
    from ..models import merge, meshing

    dev = resolve_device(args.device)
    cloud = ply_io.read_ply(args.input)
    if args.remove_background:
        cloud = merge.remove_background(cloud, device=dev)
    if args.remove_outliers:
        cloud = merge.remove_outliers(cloud, device=dev)
    kw = dict(mode=args.mode, depth=args.depth,
              quantile_trim=args.trim, orientation_mode=args.orientation,
              radii_multipliers=args.radii,
              preconditioner=args.preconditioner,
              extraction=args.extraction,
              representation=args.representation, device=dev)
    if args.output.lower().endswith(".ply"):
        mesh = meshing.mesh_from_cloud(cloud, **kw)
        ply_io.write_ply_mesh(args.output, mesh)
    else:
        mesh = meshing.reconstruct_stl(cloud, args.output, **kw)
    colored = getattr(mesh, "vertex_colors", None) is not None \
        and args.output.lower().endswith(".ply")
    print(f"{args.input}: {len(cloud)} pts -> {args.output} "
          f"({len(mesh.vertices)} verts, {len(mesh.faces)} faces"
          f"{', colored' if colored else ''})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
