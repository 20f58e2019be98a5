"""The port's command-line tools against the JAX package's, on the CPU, on the
small 3-stop session of tests/test_cli.py written by the JAX package's own
writers (here in the auto-scan layout, ``obj_12deg_AUTO/obj_<angle>deg_scan``,
so the step and the stop labels are parsed from the folder names). The 360°
tools are in tests/test_torch_cli_360.py, which shares this file's session.

The 360° tools run with the registration settings of
tests/test_torch_scan360.py (``FAST``: fewer RANSAC hypotheses, a small
final-merge budget) in both packages, patched into ``MergeParams``: the
tools' defaults (100,000 hypotheses, a 2²⁰-slot final merge) cost minutes
on the CPU and change nothing the comparison reads.

Tolerances, those of tests/test_torch_scan360.py and
tests/test_torch_meshing.py:
* ``process-cloud``: the same points in the same order, to 1e-3 mm, colours
  exact;
* ``read-calib``: the same text;
* ``scan-360`` (batch, ``--fused``, ``--stream``) and ``merge-360``: merged
  point counts within 5%, per-edge fitness (from ``--health-json``) within
  0.02 — the RANSAC streams differ (``torch.Generator`` against
  ``jax.random``) — colours and normals present;
* ``mesh``: watertight face counts within 1%; ``--mode surface`` within 1%;
* ``render``: a saved scene renders to pixels within 1 of the JAX tool's
  (uint8; the renderers agree to 1e-5), a coloured cloud to ≥ 25 dB of it.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import cli as jcli
from structured_light_for_3d_model_replication_tpu.io import images as jimages
from structured_light_for_3d_model_replication_tpu.io import matcal as jmatcal
from structured_light_for_3d_model_replication_tpu.io import png as jpng
from structured_light_for_3d_model_replication_tpu.models import (
    merge as jmerge,
)
from structured_light_for_3d_model_replication_tpu.models import synthetic
from structured_light_for_3d_model_replication_tpu.ops.triangulate import (
    make_calibration,
)
from structured_light_for_3d_model_replication_tpu_torch import cli
from structured_light_for_3d_model_replication_tpu_torch.io import ply, png
from structured_light_for_3d_model_replication_tpu_torch.io import stl
from structured_light_for_3d_model_replication_tpu_torch.models import merge

from .conftest import CAM_H, CAM_W, SMALL_PROJ

FAST = dict(ransac_iterations=2048, icp_iterations=20, fpfh_max_nn=32,
            normals_k=12, final_max_points=4096)
SCAN = ["--method", "sequential", "--voxel-size", "6.0", "--max-points",
        "2048"]


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """This module's PyTorch ops take the worker's share of the cores
    (xdist workers share the host)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def session(tmp_path_factory, synth_rig):
    """Three rendered stops on disk in the auto-scan layout + a .mat."""
    root = tmp_path_factory.mktemp("cli_session")
    sess = root / "obj_12deg_AUTO"
    cam_K, proj_K, R, T = synth_rig
    scene = synthetic.Scene(wall_z=None, spheres=(
        synthetic.Sphere((0.0, 10.0, 500.0), 80.0, 0.9),
        synthetic.Sphere((60.0, -40.0, 460.0), 35.0, 0.7),
        synthetic.Sphere((-70.0, 40.0, 530.0), 30.0, 0.8)))
    scans = synthetic.render_turntable_scans(
        scene, 3, 12.0, cam_K, proj_K, R, T, CAM_H, CAM_W, SMALL_PROJ)
    for i, (stack, _) in enumerate(scans):
        d = sess / f"obj_{12 * i}deg_scan"
        d.mkdir(parents=True)
        for f, frame in enumerate(stack):
            jimages.write_frame(str(d / f"{f + 1:02d}.png"), frame)
    calib = make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                             proj_width=SMALL_PROJ.width,
                             proj_height=SMALL_PROJ.height)
    mat = root / "calib.mat"
    jmatcal.save_calibration_mat(str(mat), calib)
    return sess, mat


@pytest.fixture()
def fast_merge(monkeypatch):
    monkeypatch.setattr(jmerge, "MergeParams",
                        functools.partial(jmerge.MergeParams, **FAST))
    monkeypatch.setattr(merge, "MergeParams",
                        functools.partial(merge.MergeParams, **FAST))


def _both(args, tmp_path, port_extra=("--device", "cpu")):
    """Run ``args`` through the JAX tool and the port's; ``{}`` in an
    argument becomes ``jax`` / ``port``."""
    rc_j = jcli.main([a.format("jax") for a in args])
    rc_t = cli.main([a.format("port") for a in args] + list(port_extra))
    assert rc_j == 0 and rc_t == 0, (rc_j, rc_t)


def _same_merge(tmp_path, name):
    jm = ply.read_ply(str(tmp_path / f"jax{name}.ply"))
    tm = ply.read_ply(str(tmp_path / f"port{name}.ply"))
    assert abs(len(tm) - len(jm)) <= 0.05 * len(jm) and len(tm) > 200
    assert tm.colors is not None and tm.normals is not None
    assert np.isfinite(tm.points).all()
    return jm, tm


def _same_edges(tmp_path, name):
    jh = json.loads((tmp_path / f"jax{name}.json").read_text())
    th = json.loads((tmp_path / f"port{name}.json").read_text())
    assert [(e["src"], e["dst"]) for e in th["edges"]] == \
        [(e["src"], e["dst"]) for e in jh["edges"]]
    np.testing.assert_allclose([e["fitness"] for e in th["edges"]],
                               [e["fitness"] for e in jh["edges"]],
                               atol=0.02)
    assert [s["index"] for s in th["stops"]] == \
        [s["index"] for s in jh["stops"]]
    return th


def test_dispatcher_help_and_unknown(capsys):
    assert cli.main([]) == 0
    out = capsys.readouterr().out
    assert "process-cloud" in out and "--device" in out
    assert cli.main(["bogus"]) == 2
    assert sorted(cli._TOOLS) == sorted(jcli._TOOLS)


@pytest.mark.parametrize("tool,step", [
    ("scan", "step 5"), ("view", "step 5"), ("lint", "step 5"),
    ("serve", "step 4")])
def test_unported_tool_exits_2_naming_its_step(tool, step, capsys):
    """A tool whose modules the port lacks exits 2 and names its ROADMAP
    step, without importing a module to find out; ``serve`` is ported, and
    its multi-card option (``--devices 2``) exits 2 naming step 4(c).
    ``scan`` and ``view`` came with step 5's capture-and-view half: their
    ``--help`` now exits 0 (tests/test_torch_hw_scanner.py and
    tests/test_torch_viz.py run them). ``lint`` came with step 5(b): its
    ``--list-rules`` exits 0 and lists the port's ten rules
    (tests/test_torch_lint.py runs it). ``diagnose`` is ported
    (tests/test_torch_diagnose.py)."""
    if tool == "lint":
        assert cli.main(["lint", "--list-rules"]) == 0
        out, err = capsys.readouterr()
        assert "not ported" not in err
        assert {line.split(" ")[0] for line in out.splitlines()} == {
            "kernel-import", "foreign-import", "host-read", "implicit-dtype",
            "implicit-rng", "atomic-scatter", "silent-except", "lock-order",
            "blocking-under-lock", "unlocked-shared-state"}
        assert not cli._NOT_PORTED
        return
    if tool in ("scan", "view"):
        with pytest.raises(SystemExit) as e:
            cli.main([tool, "--help"])
        assert e.value.code == 0
        out, err = capsys.readouterr()
        assert f"usage: {tool}" in out and "not ported" not in err
        assert (tool == "view") == ("--device" in out)
        return
    flags = ["--devices", "2"] if tool == "serve" else ["--help"]
    assert cli.main([tool, *flags]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and step in err


@pytest.mark.parametrize("tool", ["process-cloud", "scan-360", "merge-360",
                                  "mesh", "render"])
def test_device_cuda_raises_without_a_card(tool, tmp_path, session,
                                           monkeypatch):
    """``--device`` defaults to the card, and without one the tool raises
    instead of running on the CPU."""
    sess, mat = session
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"process-cloud": ["-i", str(sess / "obj_0deg_scan"), "-c",
                              str(mat), "-o", str(tmp_path / "o.ply")],
            "scan-360": ["-i", str(sess), "-c", str(mat), "-o",
                         str(tmp_path / "o.ply")],
            "merge-360": ["-i", str(tmp_path), "-o", str(tmp_path / "o.ply")],
            "mesh": ["-i", str(tmp_path / "c.ply"), "-o",
                     str(tmp_path / "o.stl")],
            "render": [str(tmp_path / "c.ply"), "-o",
                       str(tmp_path / "o.png")]}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([tool, *args])
    assert not (tmp_path / "o.ply").exists()


def test_process_cloud_matches_jax(session, tmp_path):
    sess, mat = session
    stop = str(sess / "obj_12deg_scan")
    _both(["process-cloud", "-i", stop, "-c", str(mat), "-o",
           str(tmp_path / "{}.ply")], tmp_path)
    jc = ply.read_ply(str(tmp_path / "jax.ply"))
    tc = ply.read_ply(str(tmp_path / "port.ply"))
    assert len(tc) == len(jc) > 500
    np.testing.assert_allclose(tc.points, jc.points, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(tc.colors, jc.colors)


def test_process_cloud_batch_fixed_matches_jax(session, tmp_path):
    sess, mat = session
    _both(["process-cloud", "-i", str(sess), "-c", str(mat), "-o",
           str(tmp_path / "{}"), "--thresholds", "fixed", "--ascii"],
          tmp_path)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "obj_0deg_scan.ply", "obj_12deg_scan.ply", "obj_24deg_scan.ply"]
    for n in names:
        jc = ply.read_ply(str(tmp_path / "jax" / n))
        tc = ply.read_ply(str(tmp_path / "port" / n))
        assert len(tc) == len(jc)
        np.testing.assert_allclose(tc.points, jc.points, atol=1e-3)


def test_read_calib_prints_what_jax_prints(session, capsys):
    _, mat = session
    assert jcli.main(["read-calib", str(mat)]) == 0
    ref = capsys.readouterr().out
    assert cli.main(["read-calib", str(mat)]) == 0
    out = capsys.readouterr().out
    assert out == ref and "projector center" in out


@pytest.fixture(scope="module")
def bumpy(tmp_path_factory):
    """A bumpy-sphere cloud with normals, as a PLY."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(3000, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = 50 + 5 * np.sin(4 * u[:, :1])
    col = (np.abs(u) * 255).astype(np.uint8)
    path = tmp_path_factory.mktemp("bumpy") / "cloud.ply"
    ply.write_ply(str(path), ply.PointCloud(points=(u * r).astype(np.float32),
                                            colors=col, normals=u))
    return path


@pytest.mark.parametrize("extra", [
    ["--depth", "6"],
    ["--depth", "6", "--trim", "0.02", "--orientation", "tangent"],
    ["--mode", "surface", "--orientation", "tangent"],
    ["--mode", "surface", "--radii", "1,2"],
], ids=["watertight", "tangent-trim", "surface", "surface-radii"])
def test_mesh_matches_jax(bumpy, tmp_path, extra):
    _both(["mesh", "-i", str(bumpy), "-o", str(tmp_path / "{}.stl"),
           *extra], tmp_path)
    jm = stl.read_stl(str(tmp_path / "jax.stl"))
    tm = stl.read_stl(str(tmp_path / "port.stl"))
    assert abs(len(tm.faces) - len(jm.faces)) <= 0.01 * len(jm.faces)
    assert len(tm.faces) > 1000


def test_mesh_cleanup_and_tsdf_ply_match_jax(bumpy, tmp_path):
    """``--remove-background --remove-outliers`` then a coloured TSDF mesh
    into a .ply, in both packages."""
    _both(["mesh", "-i", str(bumpy), "-o", str(tmp_path / "{}.ply"),
           "--remove-outliers", "--representation", "tsdf", "--depth", "6"],
          tmp_path)
    jm = ply.read_ply_mesh(str(tmp_path / "jax.ply"))
    tm = ply.read_ply_mesh(str(tmp_path / "port.ply"))
    assert abs(len(tm.faces) - len(jm.faces)) <= 0.01 * len(jm.faces)
    assert tm.vertex_colors is not None
    assert cli.main(["mesh", "-i", str(bumpy), "-o", str(tmp_path / "b.stl"),
                     "--remove-background", "--depth", "5", "--device",
                     "cpu"]) == 0


def test_render_matches_jax(bumpy, tmp_path):
    """A coloured cloud seeded and rendered by each package, and one saved
    scene rendered by both."""
    from structured_light_for_3d_model_replication_tpu_torch.splat import (
        SplatParams,
        splat_scene_from_cloud,
    )

    _both(["render", str(bumpy), "-o", str(tmp_path / "{}.png"), "--size",
           "96x72", "--depth", "6", "--splats", "4096"], tmp_path)
    j = jpng.decode_png((tmp_path / "jax.png").read_bytes()).astype(float)
    t = png.decode_png((tmp_path / "port.png").read_bytes()).astype(float)
    assert t.shape == j.shape == (72, 96, 3)
    mse = np.mean((t - j) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 25.0

    scene = splat_scene_from_cloud(ply.read_ply(str(bumpy)),
                                   SplatParams(capacity=4096), depth=6,
                                   device="cpu")
    scene.save(str(tmp_path / "scene.npz"))
    _both(["render", str(tmp_path / "scene.npz"), "-o",
           str(tmp_path / "{}_sweep.png"), "--size", "96x72", "--sweep",
           "2"], tmp_path)
    for k in range(2):
        j = jpng.decode_png((tmp_path / f"jax_sweep{k:03d}.png")
                            .read_bytes()).astype(int)
        t = png.decode_png((tmp_path / f"port_sweep{k:03d}.png")
                           .read_bytes()).astype(int)
        assert np.abs(t - j).max() <= 1 and t.max() > 0
