"""Calibration container I/O — MATLAB ``.mat`` interop (counterpart of the
JAX ``io/matcal.py``).

The reference persists calibration as a ``.mat`` with keys
``{Nc, Oc, wPlaneCol, wPlaneRow, cam_K, proj_K, R, T}`` in these layouts
(`server/sl_system.py:406-415`):

* ``Nc``        (3, H*W)  — camera rays, transposed flat grid
* ``Oc``        (3, 1)
* ``wPlaneCol`` (4, proj_w) — stored transposed (written ``wPlaneCol.T``)
* ``wPlaneRow`` (4, proj_h) — ditto
* ``cam_K``/``proj_K`` (3, 3), ``R`` (3, 3), ``T`` (3, 1)

Files written here load in the reference pipeline, in the JAX package and
back here, so a calibration survives a backend switch.
"""

from __future__ import annotations

import numpy as np
import scipy.io
import torch

from .._device import resolve_device
from ..ops.triangulate import Calibration, make_calibration

_KEYS = ("Nc", "Oc", "wPlaneCol", "wPlaneRow", "cam_K", "proj_K", "R", "T")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def save_calibration_mat(path: str, calib: Calibration) -> None:
    """Write a Calibration (on any device) in the reference layout."""
    scipy.io.savemat(path, {
        "Nc": _host(calib.Nc).reshape(-1, 3).T,             # (3, H*W)
        "Oc": _host(calib.Oc).reshape(3, 1),
        "wPlaneCol": _host(calib.plane_cols).T,             # (4, W)
        "wPlaneRow": _host(calib.plane_rows).T,             # (4, H)
        "cam_K": _host(calib.cam_K),
        "proj_K": _host(calib.proj_K),
        "R": _host(calib.R),
        "T": _host(calib.T).reshape(3, 1),
    })


def load_calibration_mat(path: str, cam_height: int, cam_width: int,
                         device=None) -> Calibration:
    """Load a reference-layout ``.mat`` into a Calibration on ``device``
    (None means the card).

    The stored flat ray grid carries no (H, W); callers pass the capture
    resolution. When the stored grid's size differs from it (a scan at
    another resolution than the calibration), the rays are regenerated from
    ``cam_K`` as the reference does (`server/sl_system.py:605-621`). The
    planes and rays are taken as stored; ``make_calibration`` supplies the
    rest."""
    dev = resolve_device(device)
    data = scipy.io.loadmat(path)
    missing = [k for k in _KEYS if k not in data]
    if missing:
        raise ValueError(f"{path}: calibration file missing keys {missing}")

    cam_K = np.asarray(data["cam_K"], np.float32)
    proj_K = np.asarray(data["proj_K"], np.float32)
    R = np.asarray(data["R"], np.float32)
    T = np.asarray(data["T"], np.float32).reshape(3)
    plane_cols = np.asarray(data["wPlaneCol"], np.float32).T  # (W, 4)
    plane_rows = np.asarray(data["wPlaneRow"], np.float32).T  # (H, 4)
    base = make_calibration(cam_K, proj_K, R, T, cam_height, cam_width,
                            proj_width=plane_cols.shape[0],
                            proj_height=plane_rows.shape[0], device=dev)

    # make_calibration's rays are camera_rays(cam_K): the regenerated grid.
    Nc = base.Nc
    Nc_flat = np.asarray(data["Nc"], np.float32)  # (3, H*W)
    if Nc_flat.shape[1] == cam_height * cam_width:
        Nc = torch.from_numpy(np.ascontiguousarray(
            Nc_flat.T.reshape(cam_height, cam_width, 3))).to(dev)
    return base._replace(
        Nc=Nc,
        plane_cols=torch.from_numpy(np.ascontiguousarray(plane_cols)).to(dev),
        plane_rows=torch.from_numpy(np.ascontiguousarray(plane_rows)).to(dev))
