"""``read-calib``: inspect a ``.mat`` calibration container (counterpart of
the JAX tool; host numpy only, so it takes no ``--device``).

Parity with `Old/read_calib.py:23-110`: prints camera/projector intrinsics
(fx/fy/cx/cy, skew), the stereo rotation as Euler angles, the translation,
the camera-frame projector center Oc = −RᵀT, and sanity stats over the
stored light-plane tables.
"""

from __future__ import annotations

import argparse

import numpy as np
import scipy.io


def _euler_deg(R: np.ndarray) -> tuple[float, float, float]:
    """ZYX (yaw-pitch-roll) Euler angles in degrees."""
    sy = float(np.hypot(R[0, 0], R[1, 0]))
    if sy > 1e-8:
        roll = np.arctan2(R[2, 1], R[2, 2])
        pitch = np.arctan2(-R[2, 0], sy)
        yaw = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
        roll = np.arctan2(-R[1, 2], R[1, 1])
        pitch = np.arctan2(-R[2, 0], sy)
        yaw = 0.0
    return tuple(np.degrees([yaw, pitch, roll]))


def _intrinsics(tag: str, K: np.ndarray) -> None:
    print(f"{tag} intrinsics:")
    print(f"  fx={K[0, 0]:.2f}  fy={K[1, 1]:.2f}  "
          f"cx={K[0, 2]:.2f}  cy={K[1, 2]:.2f}  skew={K[0, 1]:.4f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="read-calib",
                                description=__doc__.splitlines()[0])
    p.add_argument("calib", help=".mat calibration file")
    args = p.parse_args(argv)

    data = scipy.io.loadmat(args.calib)
    cam_K = np.asarray(data["cam_K"], float)
    proj_K = np.asarray(data["proj_K"], float)
    R = np.asarray(data["R"], float)
    T = np.asarray(data["T"], float).reshape(3)

    _intrinsics("camera", cam_K)
    _intrinsics("projector", proj_K)

    yaw, pitch, roll = _euler_deg(R)
    print("stereo extrinsics (X_proj = R X_cam + T):")
    print(f"  R (ZYX Euler): yaw={yaw:+.3f}°  pitch={pitch:+.3f}°  "
          f"roll={roll:+.3f}°")
    print(f"  T (mm): [{T[0]:+.2f}, {T[1]:+.2f}, {T[2]:+.2f}]  "
          f"|T|={np.linalg.norm(T):.2f}")
    Oc = -R.T @ T
    print(f"  projector center Oc = -RᵀT (mm): "
          f"[{Oc[0]:+.2f}, {Oc[1]:+.2f}, {Oc[2]:+.2f}]")

    for key, axis in (("wPlaneCol", "column"), ("wPlaneRow", "row")):
        if key in data:
            planes = np.asarray(data[key], float).T  # stored (4, n)
            n = np.linalg.norm(planes[:, :3], axis=1)
            print(f"{key}: {planes.shape[0]} {axis} planes, "
                  f"|n| in [{n.min():.6f}, {n.max():.6f}]")
    if "Nc" in data:
        Nc = np.asarray(data["Nc"], float)
        print(f"Nc: {Nc.shape[1]} camera rays "
              f"(grid flattens to H*W; |ray| mean "
              f"{np.linalg.norm(Nc, axis=0).mean():.6f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
