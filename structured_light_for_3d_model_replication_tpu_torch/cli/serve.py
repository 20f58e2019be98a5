"""``serve``: the continuous-batching reconstruction service, one replica
on one device, or the fleet's front router (counterpart of the JAX
package's ``cli/serve.py``).

Runs the `serve/` subsystem headless: bounded admission queue, bucketed
continuous batcher, warmed program cache, device worker, and the HTTP
front end (submit/status/result + /healthz + /metrics). SIGTERM/SIGINT
drain gracefully: in-flight jobs finish, new submissions get a retryable
503, workers exit, then the listener closes. ``--device`` (default
``cuda``) picks the card; ``cpu`` serves with the plain PyTorch path.

The fleet tier runs: ``--peers`` and ``--handoff-dir`` on a replica, and
``--router`` (with ``--replicas``, ``--check-interval``, ``--router-id``,
``--router-peers`` and ``--pin-store``) in front of replicas; the router
never touches a device. ``--shard-min-pixels`` and ``--devices`` above 1
are parsed as the JAX tool parses them and exit with code 2: they come
with ROADMAP Queue 1 step 4(c).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ._args import add_device

#: ROADMAP Queue 1 step that brings the multi-card options.
_MULTI_CARD_STEP = "step 4(c) (several cards and the sharded tier)"


def _parse_buckets(spec: str) -> tuple:
    out = []
    for part in spec.split(","):
        h, _, w = part.strip().partition("x")
        out.append((int(h), int(w)))
    if not out:
        raise ValueError(f"no buckets in {spec!r}")
    return tuple(out)


def build_parser() -> argparse.ArgumentParser:
    # Defaults come FROM ServeConfig (the documented tuning surface) so
    # the CLI, in-process users (bench, tests) and docs/SERVING.md can't
    # silently drift apart.
    from ..serve.service import ServeConfig

    d = ServeConfig()
    p = argparse.ArgumentParser(
        prog="serve",
        description="Continuous-batching scan-reconstruction service")
    add_device(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8090,
                   help="0 = pick a free port (printed on stderr)")
    p.add_argument("--queue-depth", type=int, default=d.queue_depth,
                   help="bounded admission queue; above it submits get "
                        "429 + Retry-After")
    p.add_argument("--linger-ms", type=float, default=d.linger_ms,
                   help="max wait for batch company before a partial "
                        "bucket flushes")
    p.add_argument("--workers", type=int, default=d.workers,
                   help="device launch lanes (one per chip: --workers 8 "
                        "on an 8-chip host runs 8 pinned lanes pulling "
                        "from one queue — docs/SERVING.md § multi-chip)")
    p.add_argument("--devices", type=int, default=d.devices,
                   help="spread worker lanes over at most this many "
                        "local devices (default: all visible)")
    p.add_argument("--shard-min-pixels", type=int,
                   default=d.shard_min_pixels,
                   help="buckets with padded H*W at or above this "
                        "dispatch ONE cross-chip sharded program "
                        "(camera rows over the device mesh) instead of "
                        "serializing on a single lane; unset = off")
    p.add_argument("--shard-devices", type=int, default=d.shard_devices,
                   help="chips the sharded big-bucket tier spans "
                        "(0 = all visible)")
    p.add_argument("--buckets",
                   default=",".join(f"{h}x{w}" for h, w in d.buckets),
                   help="comma-separated padded HxW shapes, e.g. "
                        "'1080x1920,2160x3840'")
    p.add_argument("--batch-sizes",
                   default=",".join(str(b) for b in d.batch_sizes),
                   help="allowed batch sizes (compiled per bucket)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip startup precompilation (first requests of "
                        "each shape will pay the compile)")
    p.add_argument("--mesh-depth", type=int, default=d.mesh_depth,
                   help="Poisson depth for STL results")
    p.add_argument("--max-sessions", type=int, default=d.max_sessions,
                   help="bounded live streaming-session registry "
                        "(docs/STREAMING.md); above it POST /session "
                        "gets a retryable 503")
    p.add_argument("--preview-depth", type=int,
                   default=d.stream.preview_depth,
                   help="coarse Poisson depth of per-stop session "
                        "previews (finalize uses the full depth)")
    p.add_argument("--representation",
                   choices=("tsdf", "archival", "poisson", "splat"),
                   default=d.stream.representation,
                   help="default session scene representation "
                        "(docs/STREAMING.md): 'tsdf' (default) previews "
                        "integrate incrementally (fusion/), finalize is "
                        "integrate-don't-re-solve, and meshes carry "
                        "vertex color; 'archival' keeps TSDF previews "
                        "but finalizes via the watertight Poisson solve "
                        "(the print/archive format); 'poisson' is the "
                        "legacy re-solve lane; 'splat' adds rendered "
                        "novel views (GET /session/<id>/render, "
                        "docs/RENDERING.md); per-session override via "
                        "the POST /session body")
    p.add_argument("--mesh-representation", choices=("poisson", "tsdf"),
                   default=d.mesh_representation,
                   help="scene representation for one-shot STL/mesh_ply "
                        "results (docs/MESHING.md)")
    p.add_argument("--no-session-warmup", action="store_true",
                   help="skip the session-lane program warmup (the "
                        "first session — or a failover adoption — will "
                        "pay those compiles)")
    p.add_argument("--proj-width", type=int, default=d.proj.width,
                   help="projector width (fixes the protocol bit count)")
    p.add_argument("--proj-height", type=int, default=d.proj.height)
    p.add_argument("--calib", default=None,
                   help="reference-layout .mat calibration; default is "
                        "the synthetic rig (per-bucket)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="max seconds to wait for in-flight jobs on "
                        "SIGTERM")
    # -- durability (docs/SERVING.md § durability) ----------------------
    p.add_argument("--store-dir", default=None,
                   help="journal volume (crash-safe WAL of admissions + "
                        "session stops, persistent content cache); "
                        "unset = in-memory service")
    p.add_argument("--recover", action="store_true",
                   help="replay the --store-dir journal at startup: "
                        "re-queue non-terminal jobs, rebuild live "
                        "sessions (requires --store-dir)")
    p.add_argument("--no-content-cache", action="store_true",
                   help="disable the content-hash result cache "
                        "(duplicate submits recompute)")
    p.add_argument("--stream-json", default=None,
                   help="JSON overrides for the session StreamParams, "
                        "e.g. '{\"method\":\"sequential\",\"merge\":"
                        "{\"voxel_size\":4.0}}' — a 'merge' sub-object "
                        "overrides MergeParams. Fixed at startup (it "
                        "keys compiled programs)")
    # -- fleet tier (docs/SERVING.md § fleet) ---------------------------
    p.add_argument("--replica-id", default=None,
                   help="stable replica identity (journaled session "
                        "heads, handoff ownership); default: random "
                        "per process")
    p.add_argument("--peers", default=None,
                   help="comma-separated peer base URLs — a local "
                        "content-cache miss consults their "
                        "GET /cache/<key> before computing")
    p.add_argument("--handoff-dir", default=None,
                   help="shared session-handoff store (requires "
                        "--store-dir): session ops stream there so a "
                        "survivor replica can adopt this replica's "
                        "live sessions after a crash. A local "
                        "directory, or an object-store spec "
                        "http://host:port[/prefix] — replicas then "
                        "share no filesystem (docs/SERVING.md § fleet)")
    p.add_argument("--tenant-rate", type=float,
                   default=d.tenant_rate_per_s,
                   help="per-tenant admission quota: sustained "
                        "admissions/s per X-Tenant (0 = off); refusals "
                        "are retryable 429s with per-tenant "
                        "serve_tenant_* metrics")
    p.add_argument("--tenant-burst", type=int, default=d.tenant_burst,
                   help="per-tenant token-bucket burst headroom")
    p.add_argument("--tenant-cost-weighted", action="store_true",
                   help="weight the per-tenant token spend by stack "
                        "MEGAPIXELS instead of 1-per-submit (a 4K scan "
                        "costs ~8x a 1080p one; --tenant-rate becomes "
                        "sustained megapixels/s)")
    p.add_argument("--router", action="store_true",
                   help="run the thin fleet FRONT ROUTER instead of a "
                        "replica: consistent-hash admission, sticky "
                        "sessions with handoff, /readyz-driven "
                        "failover + proactive re-pin (requires "
                        "--replicas)")
    p.add_argument("--replicas", default=None,
                   help="comma-separated replica base URLs the router "
                        "fronts (--router mode only)")
    p.add_argument("--check-interval", type=float, default=1.0,
                   help="router /readyz health-sweep period in seconds")
    p.add_argument("--router-id", default=None,
                   help="stable router identity (pin-board records, "
                        "detector-primary election); default: random "
                        "per process")
    p.add_argument("--router-peers", default=None,
                   help="comma-separated PEER ROUTER base URLs: peers "
                        "are health-probed, share the pin board, and "
                        "elect one detector primary (docs/SERVING.md "
                        "§ fleet, dual-router topology)")
    p.add_argument("--pin-store", default=None,
                   help="shared pin-board store for router HA: a local "
                        "directory or object-store spec "
                        "http://host:port[/prefix]; session pins are "
                        "generation-stamped last-writer-wins records "
                        "every peered router converges on")
    p.add_argument("--no-proactive-repin", action="store_true",
                   help="disable the failure detector's background "
                        "session adoption (failover falls back to the "
                        "lazy next-op re-pin)")
    return p


def _multi_card_option(args) -> str | None:
    """The first multi-card option ``args`` asks for, or None."""
    for flag, on in (("--shard-min-pixels",
                      args.shard_min_pixels is not None),
                     ("--devices", args.devices is not None
                      and args.devices > 1)):
        if on:
            return flag
    return None


def _run_router(args) -> int:
    """``serve --router``: the thin fleet front (serve/router.py). It
    holds no reconstruction state and never touches a device; signals
    stop it, and it prints ``router.stats()`` on exit."""
    import json

    from ..serve.fleet import transport_from_env
    from ..serve.router import FleetRouter, RouterHTTPServer
    from ..utils import log as log_mod

    log_mod.configure()
    replicas = [u.strip() for u in (args.replicas or "").split(",")
                if u.strip()]
    if not replicas:
        print("error: --router requires --replicas url1,url2,...",
              file=sys.stderr)
        return 2
    peers = [u.strip() for u in (args.router_peers or "").split(",")
             if u.strip()]
    router = FleetRouter(replicas,
                         check_interval_s=args.check_interval,
                         transport=transport_from_env(),
                         router_id=args.router_id,
                         router_peers=peers,
                         pin_store=args.pin_store,
                         proactive_repin=not args.no_proactive_repin)
    http = RouterHTTPServer(router, host=args.host,
                            port=args.port).start()
    # Machine-parseable readiness line (fleet scripts grep it).
    print(f"routing on :{http.port}", file=sys.stderr, flush=True)

    stop = threading.Event()

    def _graceful(signum, frame):
        print(f"signal {signum}: router stopping...", file=sys.stderr,
              flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    stop.wait()
    print(json.dumps(router.stats()), file=sys.stderr, flush=True)
    http.stop()
    print("router stopped", file=sys.stderr, flush=True)
    return 0


def _stream_params(base, spec: str | None):
    """Apply ``--stream-json`` overrides onto the default StreamParams
    (nested ``merge`` dict → MergeParams replace)."""
    import dataclasses

    if not spec:
        return base
    import json

    doc = json.loads(spec)
    if not isinstance(doc, dict):
        raise ValueError("--stream-json must be a JSON object")
    merge_over = doc.pop("merge", None)
    merge = base.merge
    if merge_over:
        merge = dataclasses.replace(merge, **merge_over)
    return dataclasses.replace(base, merge=merge, **doc)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.router:
        return _run_router(args)
    flag = _multi_card_option(args)
    if flag is not None:
        print(f"serve {flag} is not ported yet: it comes with ROADMAP "
              f"Queue 1 {_MULTI_CARD_STEP}", file=sys.stderr)
        return 2

    from ..config import ProjectorConfig
    from ..serve.service import (
        ReconstructionService,
        ServeConfig,
        ServeHTTPServer,
        fixed_calib_provider,
    )
    from ..utils import log as log_mod
    from ..utils import sanitize

    log_mod.configure()
    # SL_SANITIZE=1 arms the runtime sanitizers for a REAL service too:
    # the lock-order checker must install before the service constructs
    # its queue/cache/worker locks.
    sanitize.install_if_enabled()

    proj = ProjectorConfig(width=args.proj_width, height=args.proj_height)
    buckets = _parse_buckets(args.buckets)
    if args.calib is not None and len(buckets) != 1:
        # A .mat calibration describes ONE camera geometry; warmup of any
        # other bucket would die mid-start with a provider error. Refuse
        # the contradiction up front.
        print(f"error: --calib serves exactly one bucket, got "
              f"{args.buckets!r} — pass the single HxW matching the "
              "calibration's camera", file=sys.stderr)
        return 2
    if args.recover and args.store_dir is None:
        print("error: --recover requires --store-dir (the journal "
              "volume to replay)", file=sys.stderr)
        return 2
    if args.handoff_dir is not None and args.store_dir is None:
        print("error: --handoff-dir requires --store-dir (the handoff "
              "stream rides the WAL's group commit)", file=sys.stderr)
        return 2
    import dataclasses

    defaults = ServeConfig()
    try:
        stream = _stream_params(
            dataclasses.replace(defaults.stream,
                                preview_depth=args.preview_depth,
                                representation=args.representation),
            args.stream_json)
    except (ValueError, TypeError) as e:
        print(f"error: bad --stream-json: {e}", file=sys.stderr)
        return 2
    config = ServeConfig(
        device=args.device,
        proj=proj,
        queue_depth=args.queue_depth,
        linger_ms=args.linger_ms,
        workers=args.workers,
        devices=args.devices,
        shard_min_pixels=args.shard_min_pixels,
        shard_devices=args.shard_devices,
        buckets=buckets,
        batch_sizes=tuple(int(b) for b in args.batch_sizes.split(",")),
        warmup=not args.no_warmup,
        warmup_sessions=not args.no_session_warmup,
        mesh_depth=args.mesh_depth,
        mesh_representation=args.mesh_representation,
        max_sessions=args.max_sessions,
        store_dir=args.store_dir,
        content_cache=not args.no_content_cache,
        stream=stream,
        tenant_rate_per_s=args.tenant_rate,
        tenant_burst=args.tenant_burst,
        tenant_cost_weighted=args.tenant_cost_weighted,
        replica_id=args.replica_id,
        peers=tuple(u.strip() for u in (args.peers or "").split(",")
                    if u.strip()),
        handoff_dir=args.handoff_dir)

    calib_provider = None
    if args.calib is not None:
        from ..io.matcal import load_calibration_mat

        h, w = buckets[0]
        calib_provider = fixed_calib_provider(
            load_calibration_mat(args.calib, h, w, device=args.device))

    service = ReconstructionService(config, calib_provider=calib_provider)
    print("warming program cache..." if config.warmup else
          "warmup skipped (--no-warmup)", file=sys.stderr, flush=True)
    service.start(recover_from=True if args.recover else None)
    if args.recover:
        st = service.stats()
        print(f"recovered from {args.store_dir}: "
              f"{st['queue_depth']} job(s) re-queued, "
              f"{st['sessions']['live']} live session(s)",
              file=sys.stderr, flush=True)
    http = ServeHTTPServer(service, host=args.host, port=args.port).start()
    # Machine-parseable readiness line (the CI smoke script greps it).
    print(f"serving on :{http.port}", file=sys.stderr, flush=True)

    stop = threading.Event()

    def _graceful(signum, frame):
        print(f"signal {signum}: draining...", file=sys.stderr, flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    stop.wait()

    ok = service.drain(timeout=args.drain_timeout)
    http.stop()
    print("drained clean" if ok else "drain timed out", file=sys.stderr,
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
