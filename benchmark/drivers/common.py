"""What every driver shares: the rig and calibration of a configuration,
seeded renders staged to pinned host memory, the limits of a cell, the
profiler's spans and the comparison's bookkeeping."""

from __future__ import annotations

import contextlib
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..reference import plain
from ..scene import render

LIMITS = Path(__file__).resolve().parent.parent / "limits"
BIG = 1e30   # stands for "no answer" in a compared number (JSON has no inf)


def limits_of(cell: str) -> dict:
    """``benchmark/limits/<cell>.json``: each compared number's limit."""
    path = LIMITS / f"{cell}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def finite(x: float) -> float:
    return float(x) if math.isfinite(x) else BIG


class Driver:
    """A closed-loop driver: ``setup`` makes the inputs and the program's
    state and runs the cell's path once; ``request(i, timed)`` runs one
    unit of work and returns what the check needs; ``check`` compares
    every answer with the reference once the program's state is freed."""

    kernels_traced: tuple = ()
    faults: tuple = ()

    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = ctx.device
        self.cfg = ctx.config
        self.mix = ctx.traffic
        self.rig = render.Rig(self.cfg["rig"])
        self.rng = np.random.default_rng(ctx.seed)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(ctx.seed % (1 << 63))
        self.limits = limits_of(ctx.cell["name"])
        self.fault = None
        self.setup_parts: dict[str, float] = {}
        self._mark = time.perf_counter()

    def mark(self, part: str) -> None:
        """Seconds of set-up since the last mark, recorded as ``part``."""
        now = time.perf_counter()
        self.setup_parts[part] = now - self._mark
        self._mark = now

    def plant(self, fault: str) -> None:
        if fault not in self.faults:
            raise ValueError(f"{type(self).__module__} has no fault {fault!r}")
        self.fault = fault

    def kernels(self):
        return self.kernels_traced

    def calibration(self):
        from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
            make_calibration,
        )

        r = self.rig
        return make_calibration(*r.matrices, r.cam_h, r.cam_w, r.proj_w,
                                r.proj_h, device=self.dev)

    def render_pinned(self, renderer, angles) -> torch.Tensor:
        """(len(angles), F, H, W) uint8 in pinned host memory (host memory
        on a CPU run), each stop rendered on the device with read noise."""
        r = self.rig
        out = torch.empty((len(angles), r.n_frames, r.cam_h, r.cam_w),
                          dtype=torch.uint8,
                          pin_memory=self.dev.type == "cuda")
        noise = float(self.cfg["scene"].get("read_noise_dn", 0.0))
        for k, a in enumerate(angles):
            out[k].copy_(renderer.stop(a, self.gen, noise))
        return out

    @contextlib.contextmanager
    def span(self, name: str):
        """A ``bench.<name>`` span in the profiler's trace, which names the
        breakdown's idle gaps."""
        with torch.profiler.record_function(f"bench.{name}"):
            yield

    def sample(self, answers, cap: int = 64):
        """Every answer when there are ``cap`` or fewer (a window of the
        cells as sized), else ``cap`` of them drawn from the seed."""
        if len(answers) <= cap:
            return answers
        pick = np.random.default_rng(self.ctx.seed + 3).choice(
            len(answers), cap, replace=False)
        return [answers[i] for i in sorted(pick)]

    def compared(self, values: dict) -> dict:
        """Each compared number beside its limit (no limit: BIG)."""
        return {k: {"value": finite(v), "limit": float(self.limits.get(k, BIG))}
                for k, v in values.items()}

    def end_to_end(self, win: dict) -> dict:
        """Seconds of the window over the requests completed in it."""
        return {self.rate_metric: win["window_s"]
                / max(1, win["window_requests"])}

    def release(self) -> None:
        pass


def reference_cloud(stacks: torch.Tensor, rig, poses, dev, voxel: float,
                    dtype=plain.EXACT, pose_dtype=torch.float64):
    """The reference's merged cloud of ``stacks`` (host, (N, F, H, W)):
    each stop decoded and triangulated in ``dtype``, moved by its
    commanded pose (4×4, in ``pose_dtype``) and thinned to one point a
    ``voxel``. Returns (cloud, [each stop's points in its own frame])."""
    moved, own = [], []
    for k in range(stacks.shape[0]):
        pts, _ = plain.triangulate(stacks[k].to(dev), rig, dtype)
        own.append(pts)
        P = torch.as_tensor(poses[k], device=dev).to(pose_dtype)
        m = (pts.to(pose_dtype) @ P[:3, :3].T + P[:3, 3]).to(torch.float32)
        moved.append(m)
    return plain.thin(torch.cat(moved), voxel), own
