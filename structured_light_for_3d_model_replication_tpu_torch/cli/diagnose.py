"""``cli diagnose`` — one support bundle for "why is this run slow/dead"
(counterpart of the JAX package's ``cli/diagnose.py``).

Bundles the observability layer's artifacts into a single ``.tar.gz``:

==================  ======================================================
``env.json``         environment manifest: python/platform, torch + CUDA +
                     numpy + scipy versions, the card list (+ the caching
                     allocator's ``torch.cuda.memory_stats``), SL_*/
                     CUDA_*/TORCH_* env vars
``metrics.json``     MetricsRegistry snapshot (JSON)
``metrics.prom``     the same registry as a Prometheus scrape, span
                     aggregates folded in
``spans.json``       tracer span totals + eviction count
``events.jsonl``     flight-recorder journal tail (correlated events)
``perfetto.json``    Chrome/Perfetto trace_event export of host spans —
                     open at ui.perfetto.dev
``telemetry.json``   program-build counters/histogram + recompile storms +
                     device memory + the kernels' launch counts
``health.json``      a scan health report (``--health-json``), a live
                     service's /healthz (``--url``), or a stub naming
                     what was absent
``journal_*.jsonl``  any on-disk flight dumps passed via ``--journal``
``MANIFEST.json``    bundle index + creation time
==================  ======================================================

``--url`` additionally scrapes a running serve instance
(``remote_healthz.json`` / ``remote_metrics.prom`` /
``remote_events.jsonl``). ``--probe`` runs a tiny synthetic
reconstruction first, through the ``decode_maps`` kernel on ``--device``
(default ``cuda``; ``cpu`` takes its plain version), so a fresh process
ships real span and launch numbers instead of empty tables.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import platform
import sys
import tarfile
import time

from ..utils import events, telemetry, trace
from ..utils.log import get_logger
from ._args import add_device

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cli diagnose",
        description="bundle health + metrics + journal + env into a "
                    "support tarball")
    p.add_argument("--output", "-o", default=None,
                   help="output .tar.gz path "
                        "(default diagnose_<timestamp>.tar.gz)")
    p.add_argument("--url", default=None,
                   help="scrape a running serve instance "
                        "(http://host:port) for healthz/metrics/events")
    p.add_argument("--health-json", default=None, metavar="PATH",
                   help="include a scan health report "
                        "(scan-360 --health-json output)")
    p.add_argument("--journal", action="append", default=[],
                   metavar="PATH",
                   help="include an on-disk flight dump (repeatable)")
    p.add_argument("--events", type=int, default=1024,
                   help="journal tail length to include (default 1024)")
    p.add_argument("--probe", action="store_true",
                   help="run a tiny synthetic reconstruction first so "
                        "span and kernel-launch metrics are populated")
    add_device(p)
    return p


# ---------------------------------------------------------------------------
# Collectors
# ---------------------------------------------------------------------------


def _env_manifest() -> dict:
    out = {
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "python": sys.version,
        "platform": platform.platform(),
        "machine": platform.machine(),
        "pid": os.getpid(),
        "cwd": os.getcwd(),
        "argv": list(sys.argv),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(("SL_", "CUDA_", "TORCH_"))},
        "packages": {},
    }
    for name in ("numpy", "scipy", "PIL"):
        try:
            mod = __import__(name)
            out["packages"][name] = getattr(mod, "__version__", "?")
        except Exception:
            out["packages"][name] = None
    try:
        import torch

        out["packages"]["torch"] = torch.__version__
        available = torch.cuda.is_available()
        out["torch"] = {
            "cuda": torch.version.cuda,
            "cuda_available": available,
            "device_count": torch.cuda.device_count() if available else 0,
            "devices": [
                {"index": i, "name": torch.cuda.get_device_name(i),
                 "total_memory": torch.cuda.get_device_properties(i)
                 .total_memory,
                 "memory_stats": _safe_memory_stats(i)}
                for i in range(torch.cuda.device_count() if available
                               else 0)],
        }
    except Exception as e:  # diagnose must work where torch is broken
        out["torch"] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _safe_memory_stats(index: int) -> dict | None:
    import torch

    try:
        stats = torch.cuda.memory_stats(index)
    except Exception:
        return None
    return dict(stats) if stats else None


def _scrape(url: str, path: str, timeout: float = 10.0) -> bytes:
    from urllib.request import urlopen

    with urlopen(url.rstrip("/") + path, timeout=timeout) as resp:
        return resp.read()


def _probe(device: str) -> dict:
    """A tiny end-to-end synthetic reconstruction on ``device``: one
    ``decode_maps`` launch on a card, spans and metrics populated, so a
    fresh diagnose carries real numbers. Kept miniature (32x16 projector,
    16x24 camera) — seconds on the CPU."""
    import torch

    from ..config import ProjectorConfig
    from ..models import pipeline, synthetic
    from ..ops.triangulate import make_calibration

    proj = ProjectorConfig(width=32, height=16)
    cam_h, cam_w = 16, 24
    before = telemetry.kernel_launches()
    with trace.span("diagnose.probe"):
        cam_K, proj_K, R, T = synthetic.default_calibration(cam_h, cam_w,
                                                            proj)
        stack, _ = synthetic.render_scan(synthetic.Scene(), cam_K, proj_K,
                                         R, T, cam_h, cam_w, proj)
        calib = make_calibration(cam_K, proj_K, R, T, cam_h, cam_w,
                                 proj_width=proj.width,
                                 proj_height=proj.height, device=device)
        res = pipeline.reconstruct(
            torch.as_tensor(stack, device=calib.cam_K.device), calib,
            proj.col_bits, proj.row_bits, device=device)
        valid = int(res.valid.sum())
    after = telemetry.kernel_launches()
    return {"probe_points": valid, "cam": [cam_h, cam_w],
            "proj": [proj.width, proj.height],
            "device": str(calib.cam_K.device),
            "kernel_launches": {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}}


def collect(url: str | None = None, health_json: str | None = None,
            journals: list[str] | tuple = (), events_n: int = 1024,
            probe: bool = False, device: str = "cuda") -> dict[str, bytes]:
    """Gather every bundle member as {filename: bytes}. Collection is
    fault-tolerant member by member: a broken source becomes an
    ``*_error`` note in the manifest, never a lost bundle."""
    members: dict[str, bytes] = {}
    errors: dict[str, str] = {}

    def _try(name: str, fn):
        try:
            members[name] = fn()
        except Exception as e:
            errors[name] = f"{type(e).__name__}: {e}"
            log.warning("diagnose: %s collection failed: %s", name, e)

    tel = telemetry.install_global()
    if probe:
        _try("probe.json",
             lambda: json.dumps(_probe(device), indent=2).encode())

    _try("env.json",
         lambda: json.dumps(_env_manifest(), indent=2).encode())
    _try("metrics.json",
         lambda: json.dumps(trace.REGISTRY.snapshot(), indent=2).encode())
    _try("metrics.prom",
         lambda: trace.REGISTRY.prometheus_text(
             tracer=trace.GLOBAL).encode())
    _try("spans.json",
         lambda: json.dumps(
             {"totals": trace.GLOBAL.totals(),
              "evicted_spans": trace.GLOBAL.evicted_count},
             indent=2).encode())
    _try("events.jsonl", lambda: events.to_jsonl(events_n).encode())
    _try("perfetto.json",
         lambda: json.dumps(trace.GLOBAL.to_perfetto()).encode())
    _try("telemetry.json",
         lambda: json.dumps(tel.snapshot(), indent=2).encode())

    # health.json: explicit file > live service > stub naming the gap.
    if health_json is not None:
        _try("health.json", lambda: open(health_json, "rb").read())
    elif url is not None:
        _try("health.json", lambda: _scrape(url, "/healthz"))
    else:
        members["health.json"] = json.dumps(
            {"source": "none",
             "note": "no --health-json or --url given; see env.json for "
                     "process/device liveness"}, indent=2).encode()

    if url is not None:
        _try("remote_healthz.json", lambda: _scrape(url, "/healthz"))
        _try("remote_metrics.prom", lambda: _scrape(url, "/metrics"))
        _try("remote_events.jsonl",
             lambda: _scrape(url, f"/events?n={events_n}"))

    for j, path in enumerate(journals):
        _try(f"journal_{j:02d}_{os.path.basename(path)}",
             lambda p=path: open(p, "rb").read())

    members["MANIFEST.json"] = json.dumps(
        {"members": sorted(members) + ["MANIFEST.json"],
         "errors": errors,
         "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z")},
        indent=2).encode()
    return members


def write_bundle(path: str, members: dict[str, bytes]) -> None:
    with tarfile.open(path, "w:gz") as tar:
        for name in sorted(members):
            data = members[name]
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(data))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = args.output or time.strftime("diagnose_%Y%m%d_%H%M%S.tar.gz")
    members = collect(url=args.url, health_json=args.health_json,
                      journals=args.journal, events_n=args.events,
                      probe=args.probe, device=args.device)
    write_bundle(out, members)
    size = os.path.getsize(out)
    print(f"diagnose bundle: {out} ({size} bytes, {len(members)} members)")
    for name in sorted(members):
        print(f"  {name} ({len(members[name])} bytes)")
    return 0
