"""Command-line tools of the port (counterpart of the JAX ``cli/``): the
file-level flow — capture folders and a ``.mat`` calibration in, a merged
PLY and a printable STL out — on the card.

================  ===========================================================
``process-cloud``  decode + triangulate scan folder(s) → PLY
                   (`Old/process_cloud.py`, `multi_point_cloud_process.py`)
``read-calib``     inspect a ``.mat`` calibration (`Old/read_calib.py`)
``merge-360``      register + merge a folder of PLYs (`server/gui.py:622-641`)
``scan-360``       stop folders → merged cloud, batch or ``--stream``
``mesh``           cloud → STL, watertight or surface
                   (`server/gui.py:643-684`)
``render``         novel-view PNGs from a splat scene (.npz) or a coloured
                   cloud
``serve``          the continuous-batching reconstruction service, one
                   replica on one device (HTTP submit → PLY/STL, sessions),
                   or with ``--router`` the fleet's front router
``scan``           drive a capture rig, real or virtual (`server/gui.py:686`)
``view``           render a .ply/.stl to PNG — the headless stand-in for the
                   reference's Open3D viewer moments (`Old/New360.py:72`,
                   `Old/StatisticalOutlierRemoval.py:66-71`)
``diagnose``       support bundle: health + metrics + flight journal +
                   Perfetto spans + env manifest in one tarball
``lint``           torchlint, the port's static analysis (``analysis/``):
                   PyTorch-on-a-card and concurrency hazards, default path
                   the port's package
================  ===========================================================

Every tool that computes takes ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch path on the host); ``scan``, ``read-calib`` and ``lint``
compute nothing on a device and take none.

Invoke via ``python -m structured_light_for_3d_model_replication_tpu_torch.cli
<tool> [args]``.
"""

from __future__ import annotations

import sys

_TOOLS = {
    "diagnose": "diagnose",
    "lint": "lint",
    "process-cloud": "process_cloud",
    "read-calib": "read_calib",
    "render": "render",
    "merge-360": "merge_360",
    "scan-360": "scan_360",
    "mesh": "mesh",
    "scan": "scan",
    "serve": "serve",
    "view": "view",
}

# Tools whose modules the port does not have yet, with the ROADMAP Queue 1
# step that brings them.
_NOT_PORTED: dict[str, str] = {}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("tools:", ", ".join(sorted(_TOOLS)))
        return 0
    tool = argv[0]
    if tool not in _TOOLS:
        print(f"unknown tool {tool!r}; available: {', '.join(sorted(_TOOLS))}",
              file=sys.stderr)
        return 2
    if tool in _NOT_PORTED:
        print(f"{tool} is not ported yet: it comes with ROADMAP Queue 1 "
              f"{_NOT_PORTED[tool]}", file=sys.stderr)
        return 2
    import importlib

    mod = importlib.import_module(f".{_TOOLS[tool]}", __name__)
    return mod.main(argv[1:])
