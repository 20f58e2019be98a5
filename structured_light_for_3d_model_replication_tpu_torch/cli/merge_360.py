"""``merge-360``: register and merge a folder of per-stop PLYs (counterpart
of the JAX tool).

The GUI merge action (`server/gui.py:622-641` → `merge_pro_360`,
`server/processing.py:115-181`) plus the pose-graph variant of the legacy
scripts (`Old/360Merge.py`, `Old/new360Merge.py`) behind ``--method``.
"""

from __future__ import annotations

import argparse
import sys

from ._args import add_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="merge-360",
        description="Register+merge a folder of .ply scans (numeric order)")
    p.add_argument("--input", "-i", required=True,
                   help="folder of per-stop .ply files")
    p.add_argument("--output", "-o", required=True, help="merged .ply")
    p.add_argument("--method", choices=("posegraph", "sequential"),
                   default="posegraph")
    p.add_argument("--voxel-size", type=float, default=0.02,
                   help="registration/cleanup voxel (reference default 0.02, "
                        "server/processing.py:115)")
    p.add_argument("--ransac-iterations", type=int, default=100_000)
    p.add_argument("--icp-iterations", type=int, default=30)
    p.add_argument("--max-points", type=int, default=16_384,
                   help="per-scan registration point cap")
    p.add_argument("--no-loop-closure", action="store_true",
                   help="pose-graph without the first↔last edge")
    g = p.add_argument_group("quality gates")
    g.add_argument("--no-gates", action="store_true",
                   help="disable the per-edge registration gates")
    g.add_argument("--min-edge-fitness", type=float, default=0.2,
                   help="reject ring edges below this ICP fitness "
                        "(consensus-repaired / down-weighted)")
    g.add_argument("--max-edge-rmse", type=float, default=None,
                   help="optional absolute inlier-RMSE ceiling per edge")
    g.add_argument("--step-deg", type=float, default=None,
                   help="commanded turntable advance per stop; anchors the "
                        "consensus repair of rejected edges")
    g.add_argument("--health-json", default=None, metavar="PATH",
                   help="write the merge health report (edge verdicts, "
                        "repairs) as JSON here")
    add_device(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..health import QualityGates, ScanHealthReport
    from ..models import merge

    params = merge.MergeParams(
        voxel_size=args.voxel_size,
        ransac_iterations=args.ransac_iterations,
        icp_iterations=args.icp_iterations,
        max_points=args.max_points,
        loop_closure=not args.no_loop_closure,
        step_deg=args.step_deg,
    )
    gates = None if args.no_gates else QualityGates(
        min_edge_fitness=args.min_edge_fitness,
        max_edge_rmse=args.max_edge_rmse)
    health = ScanHealthReport()
    merged = merge.merge_360_files(args.input, args.output, params=params,
                                   method=args.method, gates=gates,
                                   health=health, device=args.device)
    print(f"merged -> {args.output} ({len(merged)} points)", file=sys.stderr)
    if health.rejected_edges:
        print(f"degraded: {len(health.rejected_edges)} edge(s) rejected and "
              f"repaired (see --health-json)", file=sys.stderr)
    health.emit()
    if args.health_json:
        health.write(args.health_json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
