"""``cli diagnose``: the port's support bundle against the JAX package's
(tests/test_events.py's bundle test), on the CPU.

What is compared: the bundle's member names with ``--health-json`` and
``--journal`` (equal), with ``--probe`` (equal: the probe's own member
included), and with ``--url`` of a running port replica (the
``remote_*`` scrapes too); the probe's reconstruction (its valid point
count equal to the JAX probe's on the same synthetic rig). The port's
``env.json`` names torch, CUDA and the SL_/CUDA_/TORCH_ variables where
the JAX package's names jax and XLA; ``telemetry.json`` carries the
kernels' launch counts. Every wait has its own bound.
"""

import json
import tarfile

import pytest
import torch

from structured_light_for_3d_model_replication_tpu import (
    health as jhealth,
)
from structured_light_for_3d_model_replication_tpu.cli import (
    diagnose as jdiagnose,
)
from structured_light_for_3d_model_replication_tpu.utils import (
    events as jevents,
)
from structured_light_for_3d_model_replication_tpu_torch import (
    health,
    serve,
)
from structured_light_for_3d_model_replication_tpu_torch.cli import (
    diagnose,
)
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import (
    events,
    telemetry,
    trace,
)

REQUIRED = {"env.json", "metrics.json", "metrics.prom", "spans.json",
            "events.jsonl", "perfetto.json", "telemetry.json",
            "health.json", "MANIFEST.json"}


def _bundle(main, tmp_path, name, argv):
    out = tmp_path / f"{name}.tar.gz"
    assert main(["-o", str(out), *argv]) == 0 and out.exists()
    tar = tarfile.open(out)
    return tar, set(tar.getnames())


def _json(tar, member):
    return json.load(tar.extractfile(member))


def test_bundle_members_match_jax(tmp_path):
    """``--health-json`` and ``--journal``: the same members as the JAX
    bundle, the health report and the flight journal carried through, a
    manifest without errors that lists every member."""
    names = {}
    for pkg, main, hmod, ev in (("port", diagnose.main, health, events),
                                ("jax", jdiagnose.main, jhealth, jevents)):
        ev.record("diagnose_test_marker", n=1)
        health_path = tmp_path / f"{pkg}_health.json"
        report = hmod.ScanHealthReport(scan_id=f"scan-{pkg}")
        report.stop(0).status = "captured"
        report.write(str(health_path))
        journal = tmp_path / f"{pkg}_old_dump.jsonl"
        ev.RECORDER.dump(str(journal))
        tar, got = _bundle(main, tmp_path, pkg, [
            "--health-json", str(health_path), "--journal", str(journal)])
        with tar:
            assert REQUIRED | {f"journal_00_{pkg}_old_dump.jsonl"} <= got
            assert _json(tar, "health.json")["scan_id"] == f"scan-{pkg}"
            assert "diagnose_test_marker" in \
                tar.extractfile("events.jsonl").read().decode()
            manifest = _json(tar, "MANIFEST.json")
            assert manifest["errors"] == {}
            assert set(manifest["members"]) == got
            perfetto = _json(tar, "perfetto.json")
            assert isinstance(perfetto["traceEvents"], list)
            if pkg == "port":
                env = _json(tar, "env.json")
                assert env["packages"]["torch"] == torch.__version__
                assert "cuda_available" in env["torch"]
                assert all(k.startswith(("SL_", "CUDA_", "TORCH_"))
                           for k in env["env"])
                tel = _json(tar, "telemetry.json")
                assert set(tel["kernel_launches"]) == set(telemetry.KERNELS)
        names[pkg] = {n.replace(f"{pkg}_", "") for n in got}
    assert names["port"] == names["jax"]


def test_probe_on_cpu_matches_jax(tmp_path):
    """``--probe --device cpu``: the JAX package's members, the probe's
    member among them, its reconstruction the JAX probe's (the same valid
    point count on the same rig), on the CPU (the plain decode: no kernel
    launch)."""
    tar, got = _bundle(diagnose.main, tmp_path, "port",
                       ["--probe", "--device", "cpu"])
    jtar, jgot = _bundle(jdiagnose.main, tmp_path, "jax", ["--probe"])
    with tar, jtar:
        assert got == jgot and REQUIRED | {"probe.json"} <= got
        probe, jprobe = _json(tar, "probe.json"), _json(jtar, "probe.json")
        assert probe["probe_points"] == jprobe["probe_points"] > 100
        assert (probe["cam"], probe["proj"]) == (jprobe["cam"],
                                                 jprobe["proj"])
        assert probe["device"] == "cpu" and probe["kernel_launches"] == {}
        assert "diagnose.probe" in _json(tar, "spans.json")["totals"]


def test_probe_without_a_card_is_an_error_not_a_fallback(tmp_path,
                                                         monkeypatch):
    """The probe's default ``--device cuda`` without a card is recorded
    as the probe's error in the manifest, never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tar, got = _bundle(diagnose.main, tmp_path, "nocard", ["--probe"])
    with tar:
        assert "probe.json" not in got
        err = _json(tar, "MANIFEST.json")["errors"]["probe.json"]
        assert "CUDA is not available" in err


def test_url_scrapes_a_running_replica(tmp_path):
    """``--url`` of a running port replica adds its ``/healthz``,
    ``/metrics`` (the kernels' launch counters among them) and
    ``/events`` as the JAX bundle's ``remote_*`` members, and its health
    as ``health.json``."""
    svc = serve.ReconstructionService(serve.ServeConfig(
        device="cpu", proj=ProjectorConfig(width=64, height=32),
        buckets=((24, 40),), batch_sizes=(1,), workers=1, warmup=False,
        warmup_sessions=False, replica_id="r-diag")).start()
    http = serve.ServeHTTPServer(svc, port=0).start()
    try:
        tar, got = _bundle(diagnose.main, tmp_path, "url",
                           ["--url", f"http://127.0.0.1:{http.port}"])
        with tar:
            assert REQUIRED | {"remote_healthz.json", "remote_metrics.prom",
                               "remote_events.jsonl"} <= got
            assert _json(tar, "health.json")["replica_id"] == "r-diag"
            prom = tar.extractfile("remote_metrics.prom").read().decode()
            assert 'serve_kernel_launches_total{kernel="decode_maps"} 0' \
                in prom
            assert _json(tar, "MANIFEST.json")["errors"] == {}
    finally:
        http.stop()
        assert svc.drain(timeout=60.0)


def test_kernel_launch_counters_fold_growth(monkeypatch):
    """``serve_kernel_launches_total`` counts the wrappers' launches since
    the telemetry was made, and a wrapper count zeroed by its caller
    restarts the growth instead of going backwards."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        decode,
        nn,
    )

    monkeypatch.setattr(decode.decode_maps, "launches", 5)
    monkeypatch.setattr(nn.nearest_one, "launches", 0)
    reg = trace.MetricsRegistry()
    tel = telemetry.DeviceTelemetry(registry=reg)
    decode.decode_maps.launches += 3
    nn.nearest_one.launches += 2
    assert tel.sample_kernel_launches()["decode_maps"] == 8

    def value(kernel):
        return reg.counter("serve_kernel_launches_total",
                           kernel=kernel).value

    assert (value("decode_maps"), value("nearest_one")) == (3, 2)
    decode.decode_maps.launches = 1
    tel.sample_kernel_launches()
    assert value("decode_maps") == 4
    assert f'serve_kernel_launches_total{{kernel="decode_maps"}} 4' in \
        reg.prometheus_text()
    assert tel.snapshot()["kernel_launches"]["nearest_one"] == 2


def test_dispatcher_runs_diagnose(capsys):
    """``cli diagnose`` is a tool of the port's dispatcher now."""
    from structured_light_for_3d_model_replication_tpu_torch import cli

    with pytest.raises(SystemExit) as exc:
        cli.main(["diagnose", "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--probe" in out and "--device" in out
    assert "diagnose" in cli._TOOLS and "diagnose" not in cli._NOT_PORTED
