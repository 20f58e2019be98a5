"""360° scans back to back (one user, closed loop): host stacks of a
whole turntable ring → ``models/scan360.scan_stacks_to_cloud`` → the merged
cloud and the poses on the host.

The mix (``benchmark/traffic/<mix>.json``): ``rings``, how many rings the
seed renders (each from a start stop the seed draws: the same views, in
another order), cycled through in turn; ``trace_requests``, the scans the
traced run profiles.

Compared, for every scan of the window, against the reference (each stop
decoded and triangulated in float64, moved by its commanded turntable
pose): ``pose_gap_mm``, the largest displacement a pose gives a point of
its stop against the commanded pose (a scan that returns another number of
poses than stops reads ``common.BIG``); ``cloud_p90_mm``, the 90th
percentile of the merged points' distance to the reference cloud. The
worst scan counts."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import plain
from ..scene import render
from . import common

SAMPLE = 4096        # merged points compared a scan
POSE_PROBES = 512    # reference points of each stop the pose moves
REF_VOXEL = 0.5      # mm: the reference cloud's thinning


class Driver(common.Driver):
    rate_metric = "scan_cloud_s"
    kernels_traced = ("nearest_one",)
    faults = ("altered", "half", "stale")

    def setup(self) -> None:
        from structured_light_for_3d_model_replication_tpu_torch.models import (
            merge,
            scan360,
        )

        self.scan360 = scan360
        self.mark("port_import_s")
        self.prepare_inputs()
        self.mark("render_pinned_s")
        self.calib = self.calibration()
        sp = dict(self.cfg["scan"])
        sp["merge"] = merge.MergeParams(**sp["merge"])
        self.params = scan360.Scan360Params(**sp)
        self.mark("calibration_s")
        for ring in range(len(self.rings)):   # every input through the path
            self.last = None
            self.request(ring, timed=False)
            self.ctx.sync()
            self.mark(f"warm_scan{ring}_s")

    def prepare_inputs(self) -> None:
        """``rings`` rings of the turntable, each from a start stop the
        seed draws (the same views in another order), rendered on the
        device and staged to pinned host memory."""
        tt = self.cfg["turntable"]
        n, step = int(tt["stops"]), float(tt["step_deg"])
        starts = self.rng.choice(n, size=int(self.mix["rings"]),
                                 replace=False)
        self.angles = [[(int(s) + k) * step for k in range(n)]
                       for s in starts]
        renderer = render.Renderer(self.cfg["scene"], self.rig, self.dev)
        self.rings = [self.render_pinned(renderer, a) for a in self.angles]

    def request(self, i: int, timed: bool) -> dict:
        ring = i % len(self.rings)
        if self.fault == "stale" and self.last is not None:
            return dict(self.last, ring=ring)
        stacks = self.rings[ring]
        if self.fault == "half":
            stacks = stacks[: stacks.shape[0] // 2]
        timing = {} if timed else None
        with self.span("scan"):
            merged, poses = self.scan360.scan_stacks_to_cloud(
                stacks, self.calib, self.rig.col_bits, self.rig.row_bits,
                self.params, timing=timing, device=self.dev)
        if timed:
            self.ctx.timings.append(timing)
        points = merged.points
        if self.fault == "altered":
            points = points + np.float32([5.0, 0.0, 0.0])
        self.last = dict(ring=ring, points=points, poses=np.asarray(poses))
        return self.last

    def release(self) -> None:
        self.calib = self.params = self.last = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------

    def truth(self, ring: int):
        angles = self.angles[ring]
        pivot = self.cfg["scene"]["pivot"]
        return [plain.turntable_pose(a, angles[0], pivot) for a in angles]

    def reference(self, ring: int) -> dict:
        gt = self.truth(ring)
        cloud, own = common.reference_cloud(self.rings[ring], self.rig, gt,
                                            self.dev, REF_VOXEL)
        g = torch.Generator(device=self.dev).manual_seed(self.ctx.seed + 1)
        probes = [p[torch.randperm(p.shape[0], generator=g,
                                   device=self.dev)[:POSE_PROBES]]
                  for p in own]
        return dict(gt=gt, cloud=cloud, probes=probes)

    def numbers(self, answer: dict, ref: dict) -> dict:
        poses = answer["poses"]
        if poses.shape[0] != len(ref["gt"]):
            pose_gap = common.BIG
        else:
            pose_gap = 0.0
            for P, G, x in zip(poses, ref["gt"], ref["probes"]):
                d = (plain.transform(P, x) - plain.transform(G, x)).norm(
                    dim=1)
                pose_gap = max(pose_gap, float(d.max()) if d.numel() else 0.0)
        pts = torch.as_tensor(np.asarray(answer["points"], np.float32),
                              device=self.dev)
        if pts.shape[0] == 0:
            return dict(pose_gap_mm=pose_gap, cloud_p90_mm=common.BIG)
        g = torch.Generator(device=self.dev).manual_seed(self.ctx.seed + 2)
        sub = pts[torch.randperm(pts.shape[0], generator=g,
                                 device=self.dev)[:SAMPLE]]
        return dict(
            pose_gap_mm=pose_gap,
            cloud_p90_mm=plain.percentile(
                plain.nearest_distance(sub, ref["cloud"]), 90))

    def check(self, answers) -> dict:
        answers = self.sample(answers)
        refs = {r: self.reference(r) for r in sorted({a["ring"]
                                                      for a in answers})}
        worst = dict(pose_gap_mm=0.0, cloud_p90_mm=0.0)
        if not answers:
            worst = dict.fromkeys(worst, common.BIG)
        for a in answers:
            for k, v in self.numbers(a, refs[a["ring"]]).items():
                worst[k] = max(worst[k], v)
        return self.compared(worst)

    def distinct_inputs(self) -> int:
        return len(self.rings)

    def control(self) -> dict:
        """The control's compared numbers, the worst over the rings."""
        worst = {}
        for r in range(len(self.rings)):
            got = self.numbers(self.control_answer(r), self.reference(r))
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in got.items()}
        return worst

    def control_answer(self, ring: int) -> dict:
        """The control: the reference put in the program's place, in
        bfloat16 (triangulation and poses), thinned at the program's
        voxel."""
        gt = self.truth(ring)
        cloud, _ = common.reference_cloud(
            self.rings[ring], self.rig, gt, self.dev,
            float(self.cfg["scan"]["merge"]["voxel_size"]),
            dtype=plain.CONTROL, pose_dtype=plain.CONTROL)
        poses = np.stack([torch.as_tensor(P).to(plain.CONTROL).double()
                          .numpy() for P in gt])
        return dict(ring=ring, points=cloud.cpu().numpy(), poses=poses)
