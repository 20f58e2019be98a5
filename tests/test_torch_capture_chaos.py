"""The capture half of the chaos suite on the port: seeded fault injection
through the port's ``Scanner`` — transient capture timeouts retried in
place, truncated uploads caught on disk, hard-failed stops skipped and
scrubbed, missed turntable DONEs survived — each run beside the JAX
package's ``Scanner`` on the same plan, with the health reports' JSON
equal, key for key (the random ``scan_id`` set equal first). Then the
acceptance ring of tests/test_chaos.py's end-to-end test on ``cpu``:
24 stops, transients on 4, hard failures on 2, the gated merge of the 22
survivors against the clean ungated run on the same stops, and its mesh.

The ring's merge runs lighter registration settings than the JAX test's
(256 RANSAC hypotheses, 8 ICP steps, 1,024 points a view, against 1,024,
12 and 2,048) to keep the CPU run short; the assertions are the JAX
test's bounds. The JAX test's own merge is a slow test of the JAX suite,
so its bridged edges are held to the JAX package's ring rule on the same
labels (``health.ring_edges`` with ``scan360._ring_span``), the rule its
gated path applies.
"""

import json
import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import health as jhealth
from structured_light_for_3d_model_replication_tpu import scanner as jscan
from structured_light_for_3d_model_replication_tpu.config import (
    ProjectorConfig as JProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu.hw import faults as jfaults
from structured_light_for_3d_model_replication_tpu.hw.rig import (
    VirtualRig as JVirtualRig,
)
from structured_light_for_3d_model_replication_tpu.io import (
    layout as jlayout,
)
from structured_light_for_3d_model_replication_tpu.models import (
    scan360 as jscan360,
)
from structured_light_for_3d_model_replication_tpu_torch import (
    health as health_mod,
)
from structured_light_for_3d_model_replication_tpu_torch import (
    scanner as scan_mod,
)
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.hw import faults
from structured_light_for_3d_model_replication_tpu_torch.hw.rig import (
    VirtualRig,
)
from structured_light_for_3d_model_replication_tpu_torch.io import (
    images as img_io,
)
from structured_light_for_3d_model_replication_tpu_torch.io.layout import (
    SessionLayout,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    merge as merge_mod,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    meshing,
    scan360,
    synthetic,
)
from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
    make_calibration,
)

from .conftest import CAM_H, CAM_W, SMALL_PROJ

TINY = ProjectorConfig(width=64, height=32)
JTINY = JProjectorConfig(width=64, height=32)
FAST_RETRY = dict(frame_attempts=2, stop_attempts=2, backoff_s=0.0)
NO_SLEEP = lambda s: None  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def _threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(old)


def _rules(pkg, spec):
    """``spec`` = [(kind, match, fault)] → the package's FaultRules."""
    plan = pkg.FaultPlan
    return [getattr(plan, kind)(match, fault) for kind, match, fault in spec]


def _scanners(tmp_path, spec=None, turntable_schedule=None, cam=(24, 40),
              proj=(TINY, JTINY)):
    """The port's and the JAX package's scanners over their own virtual
    rigs, with the same fault plan and retry policy: {"port": (rig,
    scanner), "jax": (rig, scanner)}."""
    out = {}
    for name, pkg, rig_cls, smod, lay_cls, p in (
            ("port", faults, VirtualRig, scan_mod, SessionLayout, proj[0]),
            ("jax", jfaults, JVirtualRig, jscan, jlayout.SessionLayout,
             proj[1])):
        rig = rig_cls(proj=p, cam_height=cam[0], cam_width=cam[1])
        rig.turntable.time_scale = 0.001
        camera = rig.camera if spec is None else pkg.FlakyCamera(
            rig.camera, pkg.FaultPlan(_rules(pkg, spec)))
        turntable = rig.turntable
        if turntable_schedule is not None:
            turntable = pkg.FlakyTurntable(
                turntable, pkg.CallSchedule(dict(turntable_schedule)))
        layout = lay_cls(root=str(tmp_path / name / "session")).ensure()
        out[name] = (rig, smod.Scanner(
            camera, rig.projector, turntable=turntable, proj=p,
            layout=layout, settle_s=0.0,
            retry=smod.RetryPolicy(**FAST_RETRY), sleep=NO_SLEEP))
    return out


def _report_doc(report) -> dict:
    doc = json.loads(report.to_json())
    doc.pop("scan_id", None)
    return doc


def _rel_injected(sc) -> list:
    root = sc.layout.root
    return [(os.path.relpath(p, root), a, k) for p, a, k in
            sc.camera.injected]


# ---------------------------------------------------------------------------
# Fault plans and corruption models
# ---------------------------------------------------------------------------


def test_fault_plan_is_deterministic_and_equals_jax():
    matches = [f"stop_{i:02d}" for i in range(24)]
    kw = dict(p_transient=0.3, p_hard=0.1)
    a = faults.FaultPlan.seeded(7, matches, **kw)
    b = faults.FaultPlan.seeded(7, matches, **kw)
    j = jfaults.FaultPlan.seeded(7, matches, **kw)
    rules = [(r.match, r.kinds, r.always) for r in a.rules]
    assert rules and rules == [(r.match, r.kinds, r.always) for r in b.rules]
    assert rules == [(r.match, r.kinds, r.always) for r in j.rules]


def test_fault_plan_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown camera fault"):
        faults.FaultPlan([faults.FaultRule("x", ("explode",))])


def test_corruption_models(tmp_path):
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    img_io.write_frame(a, np.full((8, 10), 7, np.uint8))
    img_io.write_frame(b, np.full((8, 10), 99, np.uint8))
    faults.corrupt_frame_file(a, "black")
    assert (img_io._imread_gray(a) == 0).all()
    faults.corrupt_frame_file(a, "saturated")
    assert (img_io._imread_gray(a) == 255).all()
    faults.corrupt_frame_file(a, "duplicate", duplicate_of=b)
    assert (img_io._imread_gray(a) == 99).all()
    size = os.path.getsize(a)
    faults.corrupt_frame_file(a, "truncate")
    assert 0 < os.path.getsize(a) < size
    assert not scan_mod.frame_file_ok(a)
    assert not jscan.frame_file_ok(a)


def test_frame_file_ok_sniffs_content_like_jax(tmp_path):
    """JPEG bytes under a .png name pass; a lost EOI, an empty file and a
    missing one fail — in both packages. The renderer's PNG (PIL where
    OpenCV is absent) passes, and fails once truncated."""
    p = str(tmp_path / "frame.png")
    cases = [b"\xff\xd8" + b"jpegdata" * 10 + b"\xff\xd9",
             b"\xff\xd8" + b"jpegdata" * 10, b""]
    for body, want in zip(cases, (True, False, False)):
        with open(p, "wb") as f:
            f.write(body)
        assert scan_mod.frame_file_ok(p) is want
        assert jscan.frame_file_ok(p) is want
    missing = str(tmp_path / "missing.png")
    assert not scan_mod.frame_file_ok(missing)
    img_io.write_frame(p, np.arange(96 * 160, dtype=np.uint32).reshape(
        96, 160).astype(np.uint8))
    assert scan_mod.frame_file_ok(p)
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(data[:-20])
    assert not scan_mod.frame_file_ok(p)


def test_deterministic_backoff():
    r = scan_mod.RetryPolicy(backoff_s=0.1, backoff_factor=2.0)
    assert [r.backoff(a) for a in range(3)] == [0.1, 0.2, 0.4]
    j = jscan.RetryPolicy(backoff_s=0.1, backoff_factor=2.0)
    assert [r.backoff(a) for a in range(5)] == [j.backoff(a)
                                                 for a in range(5)]


# ---------------------------------------------------------------------------
# Retry policy: transient faults recover in place
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frame,fault", [("03.png", "timeout"),
                                         ("02.png", "truncate"),
                                         ("01.png", "duplicate")])
def test_transient_fault_recovered_like_jax(tmp_path, frame, fault):
    """A transient timeout or truncated upload is retried once and the
    stack equals a clean render; a 'duplicate' on the first frame has
    nothing to duplicate and is not ledgered. The stop's health record
    and the injected ledger equal the JAX package's."""
    both = _scanners(tmp_path, [("transient", frame, fault)])
    recs, ledgers = {}, {}
    for name, (_, sc) in both.items():
        rec = (health_mod if name == "port" else jhealth).StopHealth(index=0)
        out = os.path.join(sc.layout.root, "scans", "obj")
        sc.capture_stack(out, stop_health=rec)
        recs[name], ledgers[name] = rec.to_dict(), _rel_injected(sc)
    assert recs["port"] == recs["jax"]
    assert ledgers["port"] == ledgers["jax"]
    assert recs["port"]["retries"] == (0 if fault == "duplicate" else 1)
    rig, sc = both["port"]
    want, _ = synthetic.render_scan(rig.scene, rig.cam_K, rig.proj_K, rig.R,
                                    rig.T, 24, 40, TINY)
    np.testing.assert_array_equal(
        img_io.load_stack(os.path.join(sc.layout.root, "scans", "obj")),
        want)


def test_exhausted_frame_raises_scan_aborted(tmp_path):
    both = _scanners(tmp_path, [("hard", "01.png", "timeout")])
    with pytest.raises(scan_mod.ScanAborted):
        both["port"][1].capture_scan("obj")
    assert issubclass(scan_mod.ScanAborted, health_mod.CaptureError)
    assert issubclass(health_mod.CaptureError, health_mod.ScanFault)
    assert _rel_injected(both["port"][1]) == [
        (os.path.join("scans", "obj", "01.png"), a, "timeout")
        for a in range(2)]


# ---------------------------------------------------------------------------
# Auto-360 degradation: hard-failed stops are skipped, not fatal
# ---------------------------------------------------------------------------


def test_hard_failed_stop_is_skipped_like_jax(tmp_path):
    """The 120° stop never captures its fifth frame: skipped, its partial
    frames scrubbed, the table still advances; the health JSON, the stop
    folders and their frames equal the JAX package's."""
    both = _scanners(tmp_path, [("hard", "_120deg_scan/05", "timeout")])
    docs, stops = {}, {}
    for name, (_, sc) in both.items():
        health = (health_mod if name == "port" else jhealth
                  ).ScanHealthReport()
        stops[name] = sc.auto_scan_360("obj", degrees_per_turn=120.0,
                                       turns=3, health=health)
        docs[name] = _report_doc(health)
    assert docs["port"] == docs["jax"]
    assert docs["port"]["failed_stops"] == [1]
    assert docs["port"]["stops"][1]["stop_attempts"] == 2
    sc = both["port"][1]
    failed_dir = sc.layout.stop_dir("obj", 120.0, 120.0)
    assert (os.listdir(failed_dir) if os.path.isdir(failed_dir) else []) \
        == []
    for s, js in zip(stops["port"], stops["jax"]):
        assert os.path.basename(s) == os.path.basename(js)
        np.testing.assert_array_equal(img_io.load_stack(s),
                                      img_io.load_stack(js))
    s0, s2 = (img_io.load_stack(s) for s in stops["port"])
    assert (s0[0] != s2[0]).any()


def test_all_stops_failed_raises(tmp_path):
    both = _scanners(tmp_path, [("hard", ".png", "timeout")])
    with pytest.raises(scan_mod.ScanAborted, match="all 2 stops"):
        both["port"][1].auto_scan_360("obj", degrees_per_turn=180.0,
                                      turns=2)


def test_turntable_done_timeout_warn_and_continue(tmp_path):
    both = _scanners(tmp_path, turntable_schedule={0: "done_timeout"})
    docs = {}
    for name, (_, sc) in both.items():
        health = (health_mod if name == "port" else jhealth
                  ).ScanHealthReport()
        assert len(sc.auto_scan_360("obj", degrees_per_turn=120.0, turns=3,
                                    health=health)) == 3
        docs[name] = _report_doc(health)
        assert sc.turntable.injected == [(0, "done_timeout")]
    assert docs["port"] == docs["jax"]
    assert docs["port"]["rotate_timeouts"] == 1


def test_flaky_channel_drops_trigger():
    class StubChannel:
        connected = True

        def __init__(self):
            self.calls = 0

        def trigger_capture(self, path, timeout=20.0):
            self.calls += 1
            return True

    ch = faults.FlakyChannel(StubChannel(), faults.CallSchedule({0: "drop"}))
    assert ch.trigger_capture("x.jpg") is False
    assert ch.inner.calls == 0
    assert ch.trigger_capture("x.jpg") is True
    assert ch.inner.calls == 1


def test_scan_timings_injectable_no_real_sleep(tmp_path):
    slept = []
    rig = VirtualRig(proj=TINY, cam_height=24, cam_width=40)
    rig.turntable.time_scale = 0.001
    layout = SessionLayout(root=str(tmp_path / "s")).ensure()
    sc = scan_mod.Scanner(rig.camera, rig.projector, rig.turntable,
                          proj=TINY, layout=layout,
                          timings=scan_mod.ScanTimings(settle_s=5.0),
                          sleep=slept.append)
    import time as _time

    t0 = _time.monotonic()
    sc.auto_scan_360("obj", degrees_per_turn=180.0, turns=2)
    assert _time.monotonic() - t0 < 4.0
    assert 5.0 in slept
    t, jt = scan_mod.ScanTimings(), jscan.ScanTimings()
    assert (t.settle_s, t.rotate_timeout_s, t.scan_dwell_ms,
            t.calib_dwell_ms) == (jt.settle_s, jt.rotate_timeout_s,
                                  jt.scan_dwell_ms, jt.calib_dwell_ms) \
        == (0.5, 10.0, 200, 250)


def test_scan_timings_dwell_fields_are_wired(tmp_path):
    rig = VirtualRig(proj=TINY, cam_height=24, cam_width=40)
    dwells = []
    real_show = rig.projector.show

    class RecordingProjector:
        def show(self, frame, dwell_ms=None):
            dwells.append(dwell_ms)
            real_show(frame, dwell_ms=dwell_ms)

    layout = SessionLayout(root=str(tmp_path / "s")).ensure()
    sc = scan_mod.Scanner(rig.camera, RecordingProjector(), proj=TINY,
                          layout=layout,
                          timings=scan_mod.ScanTimings(scan_dwell_ms=123,
                                                       calib_dwell_ms=45),
                          sleep=NO_SLEEP)
    sc.capture_scan("obj")
    assert set(dwells) == {123}
    dwells.clear()
    sc.capture_calibration_pose(1)
    assert set(dwells) == {45}


# ---------------------------------------------------------------------------
# The acceptance ring: chaos capture → gated merge → mesh, on the CPU
# ---------------------------------------------------------------------------

N_TURNS, STEP = 24, 15.0
TRANSIENT_STOPS = (3, 9, 14, 20)
HARD_STOPS = (6, 17)


def _ring_spec():
    return ([("transient", f"_{i * STEP:g}deg_scan/03", "timeout")
             for i in TRANSIENT_STOPS]
            + [("hard", f"_{i * STEP:g}deg_scan", "timeout")
               for i in HARD_STOPS])


def _ring_scene(pkg_synthetic):
    return pkg_synthetic.Scene(wall_z=None, spheres=(
        pkg_synthetic.Sphere((0.0, 10.0, 500.0), 80.0, 0.9),
        pkg_synthetic.Sphere((60.0, -40.0, 460.0), 35.0, 0.7),
        pkg_synthetic.Sphere((-70.0, 40.0, 530.0), 30.0, 0.8),
        pkg_synthetic.Sphere((20.0, 70.0, 440.0), 25.0, 0.75)))


def test_hard_failure_ring_gated_merge_on_cpu(tmp_path):
    """tests/test_chaos.py's acceptance scenario on the port: the capture
    health (equal to the JAX package's capture of the same plan) records
    exactly the injected faults; the 22 survivors' gated merge on ``cpu``
    bridges (7, 5) and (18, 16) — the JAX ring rule's edges on these
    labels — stays within 2 voxels (centroid) and 5% + 8 (count) of the
    clean ungated run on the same stops, and meshes at depth 5."""
    from structured_light_for_3d_model_replication_tpu.models import (
        synthetic as jsynthetic,
    )

    spec = _ring_spec()
    reports, stops = {}, {}
    for name, pkg, rig_cls, smod, lay_cls, hmod, syn, proj in (
            ("port", faults, VirtualRig, scan_mod, SessionLayout,
             health_mod, synthetic, SMALL_PROJ),
            ("jax", jfaults, JVirtualRig, jscan, jlayout.SessionLayout,
             jhealth, jsynthetic, SMALL_PROJ)):
        rig = rig_cls(scene=_ring_scene(syn), proj=proj, cam_height=CAM_H,
                      cam_width=CAM_W)
        rig.turntable.time_scale = 0.0
        layout = lay_cls(root=str(tmp_path / name)).ensure()
        sc = smod.Scanner(pkg.FlakyCamera(rig.camera,
                                          pkg.FaultPlan(_rules(pkg, spec))),
                          rig.projector, rig.turntable, proj=proj,
                          layout=layout, settle_s=0.0,
                          retry=smod.RetryPolicy(**FAST_RETRY),
                          sleep=NO_SLEEP)
        health = hmod.ScanHealthReport()
        stops[name] = sc.auto_scan_360("obj", degrees_per_turn=STEP,
                                       turns=N_TURNS, health=health)
        reports[name] = health
        if name == "port":
            port_rig = rig
    health = reports["port"]
    assert _report_doc(health) == _report_doc(reports["jax"])
    assert len(stops["port"]) == N_TURNS - len(HARD_STOPS)
    assert health.failed_stops == sorted(HARD_STOPS)
    assert health.recovered_stops == sorted(TRANSIENT_STOPS)
    assert sum(s.retries for s in health.stops.values()) \
        == len(TRANSIENT_STOPS)
    clean = set(range(N_TURNS)) - set(TRANSIENT_STOPS) - set(HARD_STOPS)
    assert all(health.stops[i].retries == 0 and not health.stops[i].faults
               for i in clean)

    stacks = np.stack([img_io.load_stack(d) for d in stops["port"]])
    for d, jd in zip(stops["port"], stops["jax"]):
        assert os.path.basename(d) == os.path.basename(jd)
    np.testing.assert_array_equal(
        stacks, np.stack([img_io.load_stack(d) for d in stops["jax"]]))
    rig = port_rig
    calib = make_calibration(rig.cam_K, rig.proj_K, rig.R, rig.T, CAM_H,
                             CAM_W, proj_width=SMALL_PROJ.width,
                             proj_height=SMALL_PROJ.height, device="cpu")
    merge_params = merge_mod.MergeParams(
        voxel_size=6.0, ransac_iterations=256, icp_iterations=8,
        fpfh_max_nn=32, normals_k=12, max_points=1024,
        final_max_points=4096, step_deg=STEP)
    params = scan360.Scan360Params(
        merge=merge_params, method="sequential", view_cap=8192,
        gates=health_mod.QualityGates(min_coverage=0.02,
                                      min_edge_fitness=0.2))
    labels = [i for i in range(N_TURNS) if i not in HARD_STOPS]
    merged, poses = scan360.scan_stacks_to_cloud(
        stacks, calib, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=params, health=health, stop_labels=labels, device="cpu")
    assert len(merged) > 200 and poses.shape == (len(labels), 4, 4)
    assert health.dropped_stops == []
    assert health.failed_stops == sorted(HARD_STOPS)
    assert all(health.stops[i].coverage is None for i in HARD_STOPS)
    assert all(health.stops[i].coverage > 0.02 for i in labels)
    gap2 = [(e.src, e.dst) for e in health.edges if e.gap == 2]
    assert set(gap2) == {(7, 5), (18, 16)}
    assert all(e.gap == 1 for e in health.edges
               if (e.src, e.dst) not in gap2)
    assert [(e.src, e.dst, e.gap) for e in health.edges] == \
        jhealth.ring_edges(labels, False,
                           span=jscan360._ring_span(labels, STEP))

    m_clean, _ = scan360.scan_stacks_to_cloud(
        stacks, calib, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=scan360.Scan360Params(merge=merge_params,
                                     method="sequential", view_cap=8192),
        device="cpu")
    shift = np.linalg.norm(merged.points.mean(axis=0)
                           - m_clean.points.mean(axis=0))
    assert shift < 2 * merge_params.voxel_size
    assert abs(len(merged) - len(m_clean)) <= 0.05 * len(m_clean) + 8
    mesh = meshing.mesh_from_cloud(merged, depth=5, device="cpu")
    assert len(mesh.faces) > 0
