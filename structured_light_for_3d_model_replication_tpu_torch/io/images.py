"""Captured-frame I/O: scan folders → uint8 stacks (counterpart of the JAX
``io/images.py``).

The whole stack is decoded on the host once, in a thread pool (JPEG and PNG
decoding release the GIL), and staged to the device in one copy
(:func:`device_stack`), so the decode kernel sees one (F, H, W) tensor.
Frames decode through OpenCV where it imports and through PIL where it does
not, as in the JAX package; a machine without ``cv2`` always decodes through
PIL.

Frame-number protocol (reference `server/sl_system.py:133-150`): file
``{idx:02d}`` with 01 = white, 02 = black, then (pattern, inverse) pairs for
each column bit, then each row bit.
"""

from __future__ import annotations

import concurrent.futures as _fut
import glob
import os
import re

import numpy as np

from .._device import resolve_device

_EXTS = (".bmp", ".png", ".jpg", ".jpeg")


def _cv2():
    """cv2 if it imports, else None."""
    try:
        import cv2
        return cv2
    except ImportError:
        return None


def _imread_gray(path: str) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(f"failed to read image {path}")
        return img
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("L"))


def _imread_rgb(path: str) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"failed to read image {path}")
        return img[..., ::-1].copy()  # BGR -> RGB at the boundary
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def list_frames(folder: str) -> list[str]:
    """Sorted frame files of the first extension present, in the order
    .bmp, .png, .jpg, .jpeg (the reference globs .bmp, then .png)."""
    for ext in _EXTS:
        files = sorted(glob.glob(os.path.join(folder, f"*{ext}")))
        if files:
            return files
    raise FileNotFoundError(f"no frames ({'/'.join(_EXTS)}) in {folder}")


def load_stack(folder: str, expected_frames: int | None = None,
               workers: int = 8) -> np.ndarray:
    """(F, H, W) uint8 grayscale stack from a capture folder."""
    files = list_frames(folder)
    if expected_frames is not None and len(files) != expected_frames:
        raise ValueError(
            f"{folder}: found {len(files)} frames, expected {expected_frames}")
    with _fut.ThreadPoolExecutor(max_workers=workers) as ex:
        frames = list(ex.map(_imread_gray, files))
    shapes = {f.shape for f in frames}
    if len(shapes) != 1:
        raise ValueError(f"{folder}: inconsistent frame shapes {shapes}")
    return np.stack(frames)


def load_white_rgb(folder: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of frame 01, the white reference that colours the
    points (`server/sl_system.py:646-651`)."""
    return _imread_rgb(list_frames(folder)[0])


def device_stack(folder: str, expected_frames: int | None = None,
                 device=None):
    """:func:`load_stack`, then one host → device copy: a (F, H, W) uint8
    tensor on ``device`` (None means the card)."""
    import torch

    dev = resolve_device(device)
    return torch.from_numpy(load_stack(folder, expected_frames)).to(dev)


def write_frame(path: str, img: np.ndarray) -> None:
    """uint8 (H, W) or (H, W, 3) RGB → file; the extension picks the
    codec."""
    cv2 = _cv2()
    if cv2 is not None:
        out = img[..., ::-1] if img.ndim == 3 else img  # RGB -> BGR
        if not cv2.imwrite(path, out):
            raise IOError(f"failed to write image {path}")
        return
    from PIL import Image

    Image.fromarray(np.asarray(img, np.uint8)).save(path)


_NUM_RE = re.compile(r"(\d+)")


def numeric_sort(paths: list[str]) -> list[str]:
    """Sort by the last integer in the basename, then lexically — the legacy
    fix for '10.ply' < '2.ply' (`Old/new360Merge.py:7-20`)."""
    def key(p):
        nums = _NUM_RE.findall(os.path.basename(p))
        return (int(nums[-1]) if nums else -1, p)

    return sorted(paths, key=key)
