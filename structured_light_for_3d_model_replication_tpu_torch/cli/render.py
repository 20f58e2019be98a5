"""``render``: novel-view PNGs from a splat scene (counterpart of the JAX
tool).

What a live session serves as a rendered view, this tool reproduces from a
saved scene: the ``.npz`` a session exports (``SplatScene.save``, the JAX
package's schema) renders here on the card. A coloured ``.ply`` cloud works
too: it is fused into a TSDF and seeded on the spot
(:func:`..splat.splat_scene_from_cloud`; the appearance is the fused DC
colour — view-dependent SH needs a session's captured frames).

Modes::

    render scene.npz -o view.png --az 30 --el 20      # saved scene
    render cloud.ply -o view.png --depth 7            # seed from cloud
    render scene.npz -o sweep_.png --sweep 12         # 12-view orbit
"""

from __future__ import annotations

import argparse
import os
import sys

from ._args import add_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="render",
        description="Render a splat scene (.npz) or colored cloud "
                    "(.ply) to novel-view PNGs")
    p.add_argument("input", help="scene .npz (a session's splat export) or "
                                 "a colored .ply cloud")
    p.add_argument("--output", "-o", required=True,
                   help="output .png (with --sweep N: frame index is "
                        "appended before the extension)")
    p.add_argument("--az", type=float, default=30.0,
                   help="orbit azimuth in degrees")
    p.add_argument("--el", type=float, default=20.0,
                   help="orbit elevation in degrees")
    p.add_argument("--zoom", type=float, default=2.1)
    p.add_argument("--size", default="384x288", help="WxH (default 384x288)")
    p.add_argument("--sweep", type=int, default=0, metavar="N",
                   help="render N views sweeping azimuth over 360°")
    p.add_argument("--depth", type=int, default=7,
                   help=".ply input: TSDF grid depth for the seeding "
                        "fuse (2^depth voxels per axis)")
    p.add_argument("--splats", type=int, default=8192,
                   help=".ply input: splat capacity")
    add_device(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        w, h = (int(x) for x in args.size.lower().split("x"))
    except ValueError:
        print(f"bad --size {args.size!r}, expected WxH", file=sys.stderr)
        return 2

    from .._device import resolve_device
    from ..io.png import write_png
    from ..splat import SplatParams, SplatScene, splat_scene_from_cloud

    dev = resolve_device(args.device)
    if args.input.lower().endswith(".ply"):
        from ..io import ply as ply_io

        cloud = ply_io.read_ply(args.input)
        scene = splat_scene_from_cloud(
            cloud, SplatParams(capacity=args.splats), depth=args.depth,
            device=dev)
        src = f"{len(cloud)} pts"
    else:
        scene = SplatScene.load(args.input, device=dev)
        src = f"{scene.n_splats} splats"

    if scene.n_splats == 0:
        print(f"{args.input}: scene is empty (nothing to render)",
              file=sys.stderr)
        return 1

    if args.sweep > 0:
        base, ext = os.path.splitext(args.output)
        outs = []
        for k in range(args.sweep):
            az = args.az + 360.0 * k / args.sweep
            img = scene.render(azim=az, elev=args.el, width=w, height=h,
                               zoom=args.zoom)
            path = f"{base}{k:03d}{ext or '.png'}"
            write_png(path, img)
            outs.append(path)
        print(f"{args.input}: {src} -> {len(outs)} views "
              f"({outs[0]} .. {outs[-1]})", file=sys.stderr)
        return 0

    img = scene.render(azim=args.az, elev=args.el, width=w, height=h,
                       zoom=args.zoom)
    write_png(args.output, img)
    print(f"{args.input}: {src} -> {args.output} ({w}x{h}, "
          f"az {args.az:g}, el {args.el:g})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
