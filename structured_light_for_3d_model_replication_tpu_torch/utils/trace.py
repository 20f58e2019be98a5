"""Tracing & per-stage wall-clock metrics (counterpart of the JAX
``utils/trace.py``).

* :class:`Tracer` — nested wall-clock spans with a thread-local stack;
  thread-safe aggregation; JSON export; human summary. While a
  ``torch.profiler`` capture is active, spans also open
  ``torch.profiler.record_function`` ranges, so host spans line up with
  the card's kernels in the capture's timeline.
* :func:`device_trace` — a ``torch.profiler.profile`` capture of the CPU
  and (where there is a card) CUDA activity around any workflow, written
  as a Chrome trace into ``log_dir``.
* module-level :func:`span` / :func:`summary` / :func:`export` on a global
  default tracer, so pipeline stages can annotate themselves without
  threading a tracer object through every call.
* :class:`Counter` / :class:`Gauge` / :class:`Histogram` +
  :class:`MetricsRegistry` — thread-safe monotonic counters and gauges
  with a Prometheus text exporter (:meth:`MetricsRegistry.prometheus_text`).
  The serving layer's ``/metrics`` endpoint renders the module-level
  :data:`REGISTRY`, and the exporter folds in a :class:`Tracer`'s span
  aggregates (``sl_span_seconds_total{span="scan360.register"}`` …) so the
  existing scan360 stage spans surface on the same scrape.

Spans measure HOST wall-clock: CUDA launches return before the card
finishes, so a span costs ~0 unless its body waits on the device. Wrap
the section you time with ``torch.cuda.synchronize`` (or a host read of
its result) or read the numbers as dispatch time, which is also a real
metric.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import threading
import time

#: Default bucket layouts for seconds-valued histograms. The Histogram
#: ctor default (1, 2, 4, 8) fits the serving layer's batch-OCCUPANCY
#: range; latency/compile observations need these instead (enforced by
#: the seconds-histogram audit in tests/test_trace.py).
LATENCY_SECONDS_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 60.0)
COMPILE_SECONDS_BUCKETS = (0.01, 0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 300.0)


@dataclasses.dataclass
class SpanRecord:
    name: str          # dotted path including ancestors ("scan360.register")
    start_s: float     # monotonic, relative to tracer creation
    duration_s: float
    thread: str
    meta: dict | None = None


class Tracer:
    #: Raw-record cap. A long-running serve process spans every batch;
    #: unbounded records are a slow leak. Past the cap the OLDEST records
    #: are folded into `_evicted` aggregates — `totals()` stays exact
    #: forever, only the raw span list (export/Perfetto) is windowed.
    DEFAULT_MAX_RECORDS = 16384

    def __init__(self, max_records: int | None = None):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0 = time.monotonic()
        self.max_records = (self.DEFAULT_MAX_RECORDS if max_records is None
                            else int(max_records))
        if self.max_records < 1:
            raise ValueError(
                f"max_records must be >= 1, got {self.max_records}")
        self.records: collections.deque[SpanRecord] = collections.deque()
        # span path -> {count, total_s, max_s} for evicted records.
        self._evicted: dict[str, dict] = {}
        self.evicted_count = 0

    # ------------------------------------------------------------------

    def _stack(self) -> list[str]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        """Context manager timing a (possibly nested) stage."""
        stack = self._stack()
        path = ".".join(stack + [name])
        stack.append(name)
        annot = _profiler_annotation(path)
        start = time.monotonic()
        try:
            if annot is not None:
                with annot:
                    yield
            else:
                yield
        finally:
            dur = time.monotonic() - start
            stack.pop()
            # Ambient correlation fields (events.context scan_id/job_id/
            # stop) ride every span's meta, so Perfetto args and span
            # exports correlate with the flight journal. Lazy import:
            # events.py imports this module for REGISTRY.
            try:
                from . import events as _events

                ctx = _events.current_context()
            except Exception:
                ctx = {}
            if ctx:
                meta = {**ctx, **meta}
            with self._lock:
                self.records.append(SpanRecord(
                    name=path,
                    start_s=start - self._t0,
                    duration_s=dur,
                    thread=threading.current_thread().name,
                    meta=meta or None))
                while len(self.records) > self.max_records:
                    self._evict_locked()

    def _evict_locked(self) -> None:
        old = self.records.popleft()
        agg = self._evicted.setdefault(
            old.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += old.duration_s
        agg["max_s"] = max(agg["max_s"], old.duration_s)
        self.evicted_count += 1

    def wrap(self, name: str):
        """Decorator form of :meth:`span`."""
        def deco(fn):
            @functools.wraps(fn)
            def inner(*a, **kw):
                with self.span(name):
                    return fn(*a, **kw)
            return inner
        return deco

    # ------------------------------------------------------------------

    def totals(self) -> dict[str, dict]:
        """Aggregate {span path: {count, total_s, mean_s, max_s}}. Exact
        over the tracer's whole lifetime: evicted records contribute via
        their folded aggregates."""
        with self._lock:
            records = list(self.records)
            agg: dict[str, dict] = {
                name: {"count": a["count"], "total_s": a["total_s"],
                       "max_s": a["max_s"]}
                for name, a in self._evicted.items()}
        for r in records:
            a = agg.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                        "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += r.duration_s
            a["max_s"] = max(a["max_s"], r.duration_s)
        for a in agg.values():
            a["mean_s"] = a["total_s"] / a["count"]
            for k in ("total_s", "mean_s", "max_s"):
                a[k] = round(a[k], 6)
        return agg

    def summary(self) -> str:
        rows = sorted(self.totals().items(),
                      key=lambda kv: -kv[1]["total_s"])
        if not rows:
            return "(no spans recorded)"
        w = max(len(k) for k, _ in rows)
        lines = [f"{'span':<{w}}  {'count':>5}  {'total':>9}  "
                 f"{'mean':>9}  {'max':>9}"]
        for k, a in rows:
            lines.append(f"{k:<{w}}  {a['count']:>5}  "
                         f"{a['total_s']:>8.3f}s  {a['mean_s']:>8.3f}s  "
                         f"{a['max_s']:>8.3f}s")
        return "\n".join(lines)

    def export(self, path: str) -> None:
        """JSON dump: raw spans (the retained window) + lifetime
        aggregates."""
        with self._lock:
            records = [dataclasses.asdict(r) for r in self.records]
            evicted = self.evicted_count
        with open(path, "w") as f:
            json.dump({"spans": records, "totals": self.totals(),
                       "evicted_spans": evicted}, f, indent=2)

    # -- Perfetto / Chrome trace_event export ---------------------------

    def to_perfetto(self) -> dict:
        """The retained spans as a Chrome/Perfetto ``trace_event`` JSON
        object (open at ui.perfetto.dev or chrome://tracing). Complete
        duration events ("ph": "X") on one track per thread; span meta —
        including the correlation IDs merged in by :meth:`span` — rides
        in ``args``, so a slow scan's track is searchable by scan_id
        next to a `device_trace` XProf capture of the same run."""
        with self._lock:
            records = list(self.records)
        pid = os.getpid()
        tids: dict[str, int] = {}
        trace_events: list[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "sl-host"}}]
        for r in records:
            tid = tids.get(r.thread)
            if tid is None:
                tid = tids[r.thread] = len(tids) + 1
                trace_events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": r.thread}})
            trace_events.append({
                "ph": "X", "cat": "host", "name": r.name,
                "pid": pid, "tid": tid,
                "ts": round(r.start_s * 1e6, 3),
                "dur": round(r.duration_s * 1e6, 3),
                "args": dict(r.meta or {})})
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export_perfetto(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)

    def reset(self) -> None:
        with self._lock:
            self.records.clear()
            self._evicted.clear()
            self.evicted_count = 0
            self._t0 = time.monotonic()


def _profiler_annotation(name: str):
    """A ``record_function`` range while a ``torch.profiler`` capture is
    active, else None (no cost outside a capture)."""
    import torch

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return None


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (CPU, plus CUDA where a card is
    visible) for the enclosed block and write it as a Chrome trace under
    ``log_dir``: ``with device_trace("/tmp/trace"): run_pipeline()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


# ---------------------------------------------------------------------------
# Global default tracer
# ---------------------------------------------------------------------------

GLOBAL = Tracer()
span = GLOBAL.span
wrap = GLOBAL.wrap
summary = GLOBAL.summary
export = GLOBAL.export
export_perfetto = GLOBAL.export_perfetto
totals = GLOBAL.totals
reset = GLOBAL.reset


# ---------------------------------------------------------------------------
# Metrics: thread-safe counters/gauges/histograms + Prometheus text export
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter. ``inc`` with a negative amount raises — a counter
    that can go down is a gauge, and Prometheus rate() silently mis-reads
    one disguised as the other."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue depth, cache entries, in-flight jobs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with Prometheus semantics (cumulative
    ``_bucket{le=...}`` counts + ``_sum``/``_count``). Default buckets fit
    the serving layer's batch-occupancy range (1..8)."""

    def __init__(self, buckets: tuple = (1, 2, 4, 8)):
        self._lock = threading.Lock()
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * len(self.buckets)   # per-bucket, non-cumulative
        self._overflow = 0
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self._counts[i] += 1
                    break
            else:
                self._overflow += 1

    def snapshot(self) -> dict:
        """{le: cumulative_count} (incl. "+Inf") + sum/count/mean."""
        with self._lock:
            counts = list(self._counts)
            overflow = self._overflow
            total = self._count
            s = self._sum
        cum, acc = {}, 0
        for le, c in zip(self.buckets, counts):
            acc += c
            cum[_fmt_float(le)] = acc
        cum["+Inf"] = acc + overflow
        return {"buckets": cum, "sum": s, "count": total,
                "mean": (s / total) if total else 0.0}


def _fmt_float(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _render_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


class MetricsRegistry:
    """Named metric families with optional labels.

    ``registry.counter("serve_jobs_total", status="done").inc()`` get-or-
    creates the ``status="done"`` child of the ``serve_jobs_total`` family;
    re-registering a name as a different kind raises (one name, one type —
    the Prometheus exposition-format rule)."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, help, {labels_tuple: instrument})
        self._families: dict[str, tuple] = {}

    def _get(self, kind: str, name: str, help_: str, labels: dict,
             **ctor_kwargs):
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, help_, {})
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, "
                    f"requested {kind}")
            children = fam[2]
            inst = children.get(key)
            if inst is None:
                inst = self._KINDS[kind](**ctor_kwargs)
                children[key] = inst
            elif "buckets" in ctor_kwargs:
                # A silently-ignored differing bucket layout would route
                # observations into the WRONG quantile bins; mismatches
                # fail loudly like kind mismatches do.
                want = tuple(sorted(float(b)
                                    for b in ctor_kwargs["buckets"]))
                if want != inst.buckets:
                    raise ValueError(
                        f"histogram {name!r}{dict(key)} already has "
                        f"buckets {inst.buckets}, requested {want}")
            return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = (1, 2, 4, 8), **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict view (JSON-friendly; /status payloads, tests)."""
        out: dict[str, dict] = {}
        with self._lock:
            families = {n: (k, h, dict(c))
                        for n, (k, h, c) in self._families.items()}
        for name, (kind, _, children) in sorted(families.items()):
            fam_out = out.setdefault(name, {})
            for key, inst in sorted(children.items()):
                label_s = _render_labels(key) or "_"
                fam_out[label_s] = (inst.snapshot() if kind == "histogram"
                                    else inst.value)
        return out

    def prometheus_text(self, tracer: "Tracer | None" = None) -> str:
        """Prometheus exposition text of every registered metric, plus —
        when a tracer is given — its span aggregates as
        ``sl_span_seconds_total`` / ``sl_span_count_total`` /
        ``sl_span_max_seconds`` families labelled by span path."""
        lines: list[str] = []
        with self._lock:
            families = {n: (k, h, dict(c))
                        for n, (k, h, c) in self._families.items()}
        for name, (kind, help_, children) in sorted(families.items()):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for key, inst in sorted(children.items()):
                if kind == "histogram":
                    snap = inst.snapshot()
                    for le, c in snap["buckets"].items():
                        lab = dict(key)
                        lab["le"] = le
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels(tuple(sorted(lab.items())))}"
                            f" {c}")
                    lines.append(
                        f"{name}_sum{_render_labels(key)} "
                        f"{_fmt_metric(snap['sum'])}")
                    lines.append(
                        f"{name}_count{_render_labels(key)} {snap['count']}")
                else:
                    lines.append(f"{name}{_render_labels(key)} "
                                 f"{_fmt_metric(inst.value)}")
        if tracer is not None:
            agg = tracer.totals()
            if agg:
                lines.append("# HELP sl_span_seconds_total cumulative "
                             "wall-clock per tracer span")
                lines.append("# TYPE sl_span_seconds_total counter")
                for path, a in sorted(agg.items()):
                    lab = _render_labels((("span", path),))
                    lines.append(f"sl_span_seconds_total{lab} "
                                 f"{_fmt_metric(a['total_s'])}")
                lines.append("# HELP sl_span_count_total completed spans "
                             "per tracer span path")
                lines.append("# TYPE sl_span_count_total counter")
                for path, a in sorted(agg.items()):
                    lab = _render_labels((("span", path),))
                    lines.append(f"sl_span_count_total{lab} {a['count']}")
                lines.append("# HELP sl_span_max_seconds longest single "
                             "span per tracer span path")
                lines.append("# TYPE sl_span_max_seconds gauge")
                for path, a in sorted(agg.items()):
                    lab = _render_labels((("span", path),))
                    lines.append(f"sl_span_max_seconds{lab} "
                                 f"{_fmt_metric(a['max_s'])}")
        return "\n".join(lines) + "\n"


def _fmt_metric(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


# Module-level default registry, mirroring the GLOBAL tracer: callers that
# don't thread a registry through (serve/, bench) meter themselves here.
REGISTRY = MetricsRegistry()
