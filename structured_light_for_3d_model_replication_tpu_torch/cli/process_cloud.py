"""``process-cloud``: decode + triangulate capture folder(s) into PLYs
(counterpart of the JAX tool).

CLI parity with the reference's two batch paths in one tool:

* `Old/process_cloud.py:221-236` — ``--input/--output/--calib`` single run;
* `multi_point_cloud_process.py` — one calibration + many scan folders (its
  batch GUI walks subfolders, `:242-257`), with the fixed decode thresholds
  (white > 40, contrast > 10, `:36-38`); ``--thresholds fixed`` selects
  them, the default is the adaptive variant of
  `server/sl_system.py:526-535`.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

from ._args import add_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="process-cloud",
        description="Decode+triangulate structured-light scan folders to PLY")
    p.add_argument("--input", "-i", required=True, nargs="+",
                   help="scan folder(s) with protocol-ordered frames; a "
                        "folder whose subfolders hold frames is treated as "
                        "a batch root")
    p.add_argument("--calib", "-c", required=True, help=".mat calibration")
    p.add_argument("--output", "-o", required=True,
                   help="output .ply (single input) or output dir (batch)")
    p.add_argument("--thresholds", choices=("adaptive", "fixed"),
                   default="adaptive")
    p.add_argument("--white-thresh", type=float, default=40.0)
    p.add_argument("--contrast-thresh", type=float, default=10.0)
    p.add_argument("--plane-axis", choices=("col", "row", "both"),
                   default="col",
                   help="triangulation planes (reference uses col only, "
                        "server/sl_system.py:624-629)")
    p.add_argument("--ascii", action="store_true",
                   help="ASCII PLY (reference-writer compatible) instead of "
                        "binary")
    add_device(p)
    return p


def has_frames(folder: str) -> bool:
    from ..io.images import list_frames

    try:
        return bool(list_frames(folder))
    except FileNotFoundError:
        return False


def _expand_batch(inputs):
    """A directory whose subdirectories contain frames is a batch root
    (`multi_point_cloud_process.py:242-257`)."""
    dirs = []
    for d in inputs:
        if has_frames(d):
            dirs.append(d)
            continue
        subs = sorted(
            os.path.join(d, s) for s in os.listdir(d)
            if os.path.isdir(os.path.join(d, s)))
        frame_subs = [s for s in subs if has_frames(s)]
        if not frame_subs:
            raise SystemExit(f"{d}: no frames and no frame subfolders")
        dirs.extend(frame_subs)
    return dirs


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .._device import resolve_device
    from ..config import DecodeConfig, TriangulationConfig
    from ..io import images as img_io
    from ..io import matcal
    from ..io import ply as ply_io
    from ..models import pipeline

    dev = resolve_device(args.device)
    scan_dirs = _expand_batch(args.input)
    batch = len(scan_dirs) > 1
    if batch:
        os.makedirs(args.output, exist_ok=True)

    decode_cfg = DecodeConfig(
        mode=args.thresholds,
        white_thresh=args.white_thresh,
        contrast_thresh=args.contrast_thresh)
    tri_cfg = TriangulationConfig(plane_axis=args.plane_axis)

    calib = None
    for d in scan_dirs:
        stack = img_io.load_stack(d)
        f, h, w = stack.shape
        if calib is None:
            calib = matcal.load_calibration_mat(args.calib, h, w, device=dev)
            col_bits = math.ceil(math.log2(calib.plane_cols.shape[0]))
            row_bits = math.ceil(math.log2(calib.plane_rows.shape[0]))
            expect = 2 + 2 * (col_bits + row_bits)
            if f != expect:
                raise SystemExit(
                    f"{d}: {f} frames but calibration implies {expect}")
        res = pipeline.reconstruct(stack, calib, col_bits, row_bits,
                                   decode_cfg=decode_cfg, tri_cfg=tri_cfg,
                                   device=dev)
        cloud = pipeline.to_point_cloud(res)
        out = (os.path.join(args.output,
                            os.path.basename(d.rstrip("/")) + ".ply")
               if batch else args.output)
        ply_io.write_ply(out, cloud, binary=not args.ascii)
        print(f"{d}: {len(cloud)} points -> {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
