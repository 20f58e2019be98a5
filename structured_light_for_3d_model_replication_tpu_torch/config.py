"""Configuration dataclasses: a copy of the JAX package's ``config.py``
parameter sets the 360° path reads (projector geometry, decode masks,
triangulation), the calibration target, the turntable schedule and the
dated session root."""

from __future__ import annotations

import dataclasses
import datetime
import math
import os


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    """Projector geometry; mirrors reference `server/config.py:16-22`."""

    width: int = 1920
    height: int = 1080
    offset_x: int = 1920
    offset_y: int = 0
    brightness: int = 200
    # Pattern downsampling factor: the finest `downsample` bits are dropped.
    downsample: int = 1

    @property
    def col_bits(self) -> int:
        """Bits needed to code width/downsample coarse columns."""
        return int(math.ceil(math.log2(math.ceil(self.width / self.downsample))))

    @property
    def row_bits(self) -> int:
        return int(math.ceil(math.log2(math.ceil(self.height / self.downsample))))

    @property
    def n_frames(self) -> int:
        """2 refs (white, black) + (pattern, inverse) per bit for cols + rows:
        1920x1080 @ D=1 -> 46."""
        return 2 + 2 * self.col_bits + 2 * self.row_bits


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Per-pixel validity-mask thresholds (adaptive or fixed)."""

    mode: str = "adaptive"  # "adaptive" | "fixed"
    # adaptive: white > white_factor * percentile(black, black_percentile)
    #           AND (white-black) > contrast_frac * max(white-black)
    white_factor: float = 1.5
    black_percentile: float = 95.0
    contrast_frac: float = 0.05
    # fixed: white > white_thresh AND (white-black) > contrast_thresh
    white_thresh: float = 40.0
    contrast_thresh: float = 10.0


@dataclasses.dataclass(frozen=True)
class TriangulationConfig:
    """Ray-plane intersection options: "col" planes (the reference), "row",
    or "both" fused by inverse variance."""

    plane_axis: str = "col"  # "col" | "row" | "both"
    denom_eps: float = 1e-6
    # Reject points behind the camera or absurdly far.
    min_t: float = 0.0
    max_t: float = 1e5


@dataclasses.dataclass(frozen=True)
class CheckerboardConfig:
    """Calibration target; reference `server/config.py:24-27` (7x7 @ 35 mm)."""

    cols: int = 7
    rows: int = 7
    square_mm: float = 35.0


@dataclasses.dataclass(frozen=True)
class TurntableConfig:
    """360° schedule; reference `server/gui.py:79-80` defaults 12 x 30°."""

    turns: int = 12
    degrees_per_turn: float = 30.0
    baud: int = 115200
    done_timeout_s: float = 10.0
    settle_s: float = 0.5


def dated_output_root(base: str = ".") -> str:
    """Reference layout root `{dd_mm_YYYY}_3Dscan` (`server/config.py:10`)."""
    stamp = datetime.date.today().strftime("%d_%m_%Y")
    return os.path.join(base, f"{stamp}_3Dscan")
