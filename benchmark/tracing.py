"""The traced run's instruments: a profiler slice over the window's first
requests (``torch.profiler``, host and device), the benchmark's recorders
around the kernels' Python wrappers, and the reduction of the slice to the
device's busy time, kernel counts and times, roofline sums and the
breakdown the result line carries."""

from __future__ import annotations

import functools
import importlib
import re
import time

import numpy as np

from . import peaks


class Recorder:
    """Wraps a kernel's Python wrapper: each call records what the launch
    needs (``peaks.KERNELS[name]["need"]``) and then calls the wrapper."""

    def __init__(self, name: str):
        self.name = name
        self.spec = peaks.KERNELS[name]
        self.needs = []
        self.saved = []

    def install(self) -> None:
        for mod, attr in self.spec["patch"]:
            module = importlib.import_module(f"{peaks.PORT}.{mod}")
            original = getattr(module, attr)
            self.saved.append((module, attr, original))

            @functools.wraps(original)
            def wrapped(*args, _original=original, **kw):
                self.needs.append(self.spec["need"](*args, **kw))
                return _original(*args, **kw)
            setattr(module, attr, wrapped)

    def uninstall(self) -> None:
        for module, attr, original in reversed(self.saved):
            setattr(module, attr, original)
        self.saved = []

    def bound_s(self) -> float:
        return sum(peaks.bound_seconds(*need()) for need in self.needs)


class Slice:
    """The profiled part of the traced run's window."""

    def __init__(self, devices, kernels=()):
        self.devices = devices
        self.recorders = [Recorder(k) for k in kernels]

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        for r in self.recorders:
            r.install()
        acts = [ProfilerActivity.CPU]
        if self.devices[0].type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.torch = torch

    def stop(self, requests: int) -> None:
        """Ends the slice; its reduction waits for :meth:`result`, after
        the window."""
        for d in self.devices:
            if d.type == "cuda":
                self.torch.cuda.synchronize(d)
        self.wall = time.perf_counter() - self.t0
        self.requests = requests
        self.prof.__exit__(None, None, None)
        for r in self.recorders:
            r.uninstall()

    def result(self) -> dict:
        return reduce(self.prof, self.wall, self.requests, self.recorders,
                      [d.index or 0 for d in self.devices])


def union_s(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, wall_s: float, requests: int, recorders, indices) -> dict:
    """The slice's numbers: busy seconds (the union of kernel intervals on
    each card, averaged over the cards), kernels by name, each recorded
    kernel's device time and bound, and the breakdown."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("bench."):
                continue    # the benchmark's own spans, mirrored on the GPU
            kernels.append((e.name, tr.start, tr.end, e.device_index))
        else:
            host.append((e.name, tr.start, tr.end))
    busy = [union_s([(s, t) for _, s, t, d in kernels if d == i])
            for i in indices]
    by_name = {}
    for name, s, t, _ in kernels:
        n, tot = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, tot + (t - s) / 1e6)
    rooflines = {}
    for r in recorders:
        frag = re.compile(r"(^|[\s:])" + r.spec["trace_name"] + r"[<(]")
        got = [(n, tot) for name, (n, tot) in by_name.items()
               if frag.search(name)]
        seen = sum(n for n, _ in got)
        dev_s = sum(t for _, t in got)
        calls = len(r.needs)
        if seen and calls:
            # The profiler can miss launches; every recorded one stands
            # for the calls by its mean time.
            rooflines[r.name] = dict(calls=calls, recorded=seen,
                                     device_s=dev_s * calls / seen,
                                     bound_s=r.bound_s())
    return dict(window_s=wall_s, busy_s=float(np.mean(busy)) if busy else 0.0,
                requests=requests, kernels=len(kernels),
                by_name=by_name, rooflines=rooflines,
                breakdown=breakdown(by_name, kernels, host))


def breakdown(by_name, kernels, host, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between kernels, each named by what the host was in at the gap's
    middle: the innermost ``bench.`` span and the innermost other event."""
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    device_ops = [[name[:120], tot] for name, (_, tot) in ops]
    if not kernels or not host:
        return dict(device_ops=device_ops, idle_gaps=[])
    spans = merged([(s, t) for _, s, t, _ in kernels])
    h_start = np.array([s for _, s, _ in host], np.float64)
    h_end = np.array([t for _, _, t in host], np.float64)
    names = [n for n, _, _ in host]
    bench = np.array([n.startswith("bench.") for n in names])
    edges = [(min(h_start.min(), spans[0][0]), spans[0][0])]
    edges += [(a[1], b[0]) for a, b in zip(spans, spans[1:])]
    edges.append((spans[-1][1], max(h_end.max(), spans[-1][1])))
    gaps = sorted(edges, key=lambda g: g[0] - g[1])[:top]
    out = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = (h_start <= mid) & (h_end >= mid)
        label = []
        for sel in (inside & bench, inside & ~bench):
            idx = np.nonzero(sel)[0]
            if idx.size:
                k = idx[np.argmin(h_end[idx] - h_start[idx])]
                label.append(names[k][:60])
        out.append([" / ".join(label) or "host", (g1 - g0) / 1e6])
    return dict(device_ops=device_ops, idle_gaps=out)


class LayerContext:
    """What a per-layer metric reader sees: the driver's context (the
    program's stage timings), the window and the traced slice."""

    def __init__(self, ctx, win: dict):
        self.ctx = ctx
        self.timings = ctx.timings
        self.window = win
        self.slice = win["slice"]

    def mean_timing(self, key: str):
        vals = [t[key] for t in self.timings if key in t]
        return float(np.mean(vals)) if vals else None

    def roofline_pct(self, kernel: str):
        r = self.slice["rooflines"].get(kernel)
        if not r or r["device_s"] <= 0 or r["bound_s"] <= 0:
            return None
        return 100.0 * r["bound_s"] / r["device_s"]

    def idle_pct(self):
        """Percent of a request's wall in which no kernel ran: the device's
        busy seconds a profiled request over the median wall of the
        window's requests, which run outside the profiler (its host
        overhead stretches the profiled ones' walls, not their kernels)."""
        s = self.slice
        rest = self.window["walls"][s["requests"]:]
        if s["kernels"] == 0 or not s["requests"] or not rest:
            return None
        busy = s["busy_s"] / s["requests"]
        return 100.0 * (1.0 - busy / float(np.median(rest)))

    def kernels_per_request(self):
        s = self.slice
        if s["kernels"] == 0 or not s["requests"]:
            return None
        return s["kernels"] / s["requests"]
