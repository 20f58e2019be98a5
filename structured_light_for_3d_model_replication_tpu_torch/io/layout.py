"""Cloud folders of a scan session (the port's copy of ``list_clouds`` and
its numeric sort from the JAX package's ``io/layout.py`` and
``io/images.py``)."""

from __future__ import annotations

import glob
import os
import re

_NUM_RE = re.compile(r"(\d+)")


def numeric_sort(paths: list[str]) -> list[str]:
    """Sort by the last integer in the basename, then lexically — the legacy
    fix for '10.ply' < '2.ply' (`Old/new360Merge.py:7-20`)."""
    def key(p):
        nums = _NUM_RE.findall(os.path.basename(p))
        return (int(nums[-1]) if nums else -1, p)

    return sorted(paths, key=key)


def list_clouds(folder: str) -> list[str]:
    """All .ply files, numerically ordered (`server/processing.py:121-129`
    sorts lexically; the legacy numeric sort is strictly better)."""
    return numeric_sort(glob.glob(os.path.join(folder, "*.ply")))
