"""The generic part of the benchmark: it finds a cell's configuration,
traffic mix, driver and per-layer metric readers by the names in
``BENCHMARK.json``, runs set-up, the measured window and the check, and
builds the result line. Nothing here knows a configuration, a mix or a
metric by name; those live in files of their own:

- ``benchmark/configs/<config>.json``: the rig, scene, settings and
  guarantees of one deployment;
- ``benchmark/traffic/<traffic>.json``: one traffic mix, whose ``driver``
  key names ``benchmark/drivers/<driver>.py``;
- ``benchmark/layer_metrics/<metric>.py``: one per-layer metric, a
  ``read(layer_context)`` that returns a number or None.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# Top-level module names that may not be loaded in a run: the JAX package
# and JAX itself. The port's name begins with the JAX package's, so names
# are compared whole, never by prefix.
BANNED = ("jax", "jaxlib", "flax", "structured_light_for_3d_model_replication_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def traffic_of(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def driver_of(traffic: dict):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def layer_reader(name: str):
    """The ``read`` function of ``benchmark/layer_metrics/<name>.py``."""
    path = BENCH / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_layer_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is banned, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def metrics_for(man: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    rows = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in rows if cell in m.get("workloads", (cell,))]


class Context:
    """What a driver is given: the cell, its configuration and mix, the
    device(s), the seed, and whether this is the traced run. Drivers record
    the program's stage timings in ``timings`` on the requests they run
    ``timed``."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 trace: bool, devices):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.trace, self.devices = int(seed), bool(trace), devices
        self.device = devices[0]
        self.timings: list[dict] = []

    def sync(self) -> None:
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def window(driver, seconds: float, trace_requests: int, profiler) -> dict:
    """The measured window, a closed loop of one user: requests back to
    back until ``seconds`` have passed; the request running then finishes
    and closes the window. In the traced run (a ``profiler``) the first
    ``trace_requests`` requests run under it with the program's stage
    timing off, and the profiler is stopped, before the window's clock
    starts; the window's requests then run with the stage timing on."""
    ctx = driver.ctx
    walls, answers, failed = [], [], 0

    def one(timed: bool) -> None:
        nonlocal failed
        r0 = time.perf_counter()
        try:
            answers.append(driver.request(len(answers), timed=timed))
        except Exception as exc:  # a request that never answers: counted
            failed += 1
            answers.append(None)
            print(f"request {len(answers) - 1} failed: {exc!r}",
                  file=sys.stderr)
        ctx.sync()
        walls.append(time.perf_counter() - r0)

    profiled = 0
    if profiler is not None:
        profiler.start()
        for _ in range(trace_requests):
            one(timed=False)
        profiled = len(answers)
        profiler.stop(profiled)
    t0 = time.perf_counter()
    while True:
        one(timed=profiler is not None)
        if time.perf_counter() - t0 >= seconds:
            break
    win = dict(window_s=time.perf_counter() - t0, walls=walls,
               answers=answers, failed=failed, requests=len(answers),
               window_requests=len(answers) - profiled)
    w = np.asarray(walls[profiled:])
    q1, med, q3 = np.percentile(w, [25, 50, 75])
    print(f"window: {w.size} request(s) in {win['window_s']:.3f} s; wall "
          f"min {w.min():.4f} q1 {q1:.4f} median {med:.4f} q3 {q3:.4f} "
          f"max {w.max():.4f}; first {np.round(w[:3], 4).tolist()}",
          file=sys.stderr)
    return win


def device_info(devices) -> dict:
    import torch

    if devices[0].type != "cuda":
        return dict(platform="cpu", kind="cpu", count=len(devices),
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(devices[0]),
                count=len(devices),
                memory_peak_bytes=max(torch.cuda.max_memory_allocated(d)
                                      for d in devices))


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str | None = None,
        overrides: dict | None = None, fault: str | None = None) -> dict:
    """One run of one cell; returns the result dict (printed by
    ``run.py``). ``device="cpu"``, ``overrides`` (its ``config`` and
    ``traffic`` deep-merged into the cell's; its ``cell``, a workload entry
    that need not be in ``BENCHMARK.json``) and ``fault`` (a fault the
    driver plants in the timed path) are for the CPU tests; a run on the
    chip takes none of them."""
    import torch

    from . import tracing

    man = manifest()
    cell = (overrides or {}).get("cell") or cell_of(man, workload)
    config = merge(config_of(cell["config"]), (overrides or {}).get("config"))
    traffic = merge(traffic_of(cell["traffic"]),
                    (overrides or {}).get("traffic"))
    if device is None:
        devices = [torch.device("cuda", k) for k in range(cell["chips"])]
    else:
        devices = [torch.device(device)] * cell["chips"]
    ctx = Context(cell, config, traffic, seed, trace, devices)
    driver = driver_of(traffic).Driver(ctx)
    if fault is not None:
        driver.plant(fault)
    parts = {"start_s": time.perf_counter() - t_start}
    driver.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    parts.update(driver.setup_parts)
    print(f"set-up: {setup_s:.3f} s; "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
          file=sys.stderr)

    profiler = tracing.Slice(devices, driver.kernels()) if trace else None
    # Set-up's objects leave the collector's generations for the window,
    # so a collection inside it walks only what the requests made.
    gc.collect()
    gc.freeze()
    try:
        win = window(driver, seconds, int(traffic.get("trace_requests", 1)),
                     profiler)
    finally:
        gc.unfreeze()
    win["slice"] = profiler.result() if trace else None
    device = device_info(devices)
    driver.release()
    t_check = time.perf_counter()
    checks = driver.check([a for a in win["answers"] if a is not None])
    print(f"check of {len(win['answers'])} answer(s): "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = win["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    rows = metrics_for(man, workload, trace)
    metrics = {}
    if trace:
        lctx = tracing.LayerContext(ctx, win)
        for m in rows:
            value = layer_reader(m["name"])(lctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        sl = win["slice"]
        device.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
        print(f"traced slice: {sl['requests']} request(s), {sl['kernels']} "
              f"device operations, busy {sl['busy_s']:.4f} s of "
              f"{sl['window_s']:.4f} s; recorder calls "
              f"{[(r.name, len(r.needs)) for r in profiler.recorders]}, "
              f"rooflines {sl['rooflines']}; "
              f"timed requests {len(ctx.timings)}", file=sys.stderr)
    else:
        e2e = driver.end_to_end(win)
        e2e["setup_s"] = setup_s
        for m in rows:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    result = dict(correct=bool(correct), attempted=win["requests"],
                  failed=win["failed"], metrics=metrics, device=device)
    if trace:
        result["breakdown"] = win["slice"]["breakdown"]
    result["checks"] = checks
    return result


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over`` merged in, key by key, nested dicts deeply."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


