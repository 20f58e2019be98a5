"""The port's 360° tools, ``scan-360`` (batch, ``--fused``, ``--stream``)
and ``merge-360``, against the JAX package's on the CPU, on the session and
with the settings of tests/test_torch_cli.py (whose docstring gives the
tolerances).
"""

import shutil

import pytest

from structured_light_for_3d_model_replication_tpu_torch import cli
from structured_light_for_3d_model_replication_tpu_torch.io import ply, stl

from .test_torch_cli import (  # noqa: F401 (fixtures)
    SCAN,
    _both,
    _same_edges,
    _same_merge,
    _share_cores_with_workers,
    fast_merge,
    session,
)


def test_scan_360_batch_matches_jax(session, tmp_path, fast_merge, capsys):
    sess, mat = session
    _both(["scan-360", "-i", str(sess), "-c", str(mat), "-o",
           str(tmp_path / "{}.ply"), *SCAN, "--health-json",
           str(tmp_path / "{}.json"), "--stl", str(tmp_path / "{}.stl"),
           "--mesh-depth", "6", "--representation", "poisson"], tmp_path)
    assert "turntable step 12.0°" in capsys.readouterr().err
    _same_merge(tmp_path, "")
    health = _same_edges(tmp_path, "")
    assert health["dropped_stops"] == [] and len(health["edges"]) == 2
    jm = stl.read_stl(str(tmp_path / "jax.stl"))
    tm = stl.read_stl(str(tmp_path / "port.stl"))
    assert abs(len(tm.faces) - len(jm.faces)) <= 0.02 * len(jm.faces)


def test_scan_360_fused_matches_jax(session, tmp_path, fast_merge):
    """``--fused`` (gates off: the gated tail needs the multi-launch path)
    stages the stacks and runs the batched ring in both packages."""
    sess, mat = session
    _both(["scan-360", "-i", str(sess), "-c", str(mat), "-o",
           str(tmp_path / "{}.ply"), *SCAN, "--fused", "--no-gates",
           "--stop-chunk", "2"], tmp_path)
    _same_merge(tmp_path, "")


def test_scan_360_stream_matches_jax(session, tmp_path, fast_merge):
    sess, mat = session
    _both(["scan-360", "-i", str(sess), "-c", str(mat), "-o",
           str(tmp_path / "{}.ply"), *SCAN, "--stream", "--preview-out",
           str(tmp_path / "{}_prev.stl"), "--preview-depth", "4",
           "--health-json", str(tmp_path / "{}.json")], tmp_path)
    _same_merge(tmp_path, "")
    _same_edges(tmp_path, "")
    for who in ("jax", "port"):
        assert len(stl.read_stl(str(tmp_path / f"{who}_prev.stl")).faces) > 0


def test_scan_360_skips_partial_stops(session, tmp_path, fast_merge, capsys):
    """A stop folder with fewer frames than the rest is skipped and said
    so, as the JAX tool does; too few stops exits with a message."""
    sess, mat = session
    part = tmp_path / "obj_12deg_AUTO"
    shutil.copytree(sess, part)
    for f in sorted((part / "obj_24deg_scan").iterdir())[5:]:
        f.unlink()
    with pytest.raises(SystemExit, match="need ≥2"):
        cli.main(["scan-360", "-i", str(part / "obj_0deg_scan"), "-c",
                  str(mat), "-o", str(tmp_path / "x.ply"), "--device",
                  "cpu"])
    assert cli.main(["scan-360", "-i", str(part), "-c", str(mat), "-o",
                     str(tmp_path / "p.ply"), *SCAN, "--device", "cpu"]) == 0
    assert "skipping 1 partial stop folder(s)" in capsys.readouterr().err
    assert len(ply.read_ply(str(tmp_path / "p.ply"))) > 200


def test_merge_360_matches_jax(session, tmp_path, fast_merge):
    sess, mat = session
    clouds = tmp_path / "clouds"
    assert cli.main(["process-cloud", "-i", str(sess), "-c", str(mat), "-o",
                     str(clouds), "--device", "cpu"]) == 0
    _both(["merge-360", "-i", str(clouds), "-o", str(tmp_path / "{}.ply"),
           "--method", "sequential", "--voxel-size", "6.0",
           "--ransac-iterations", "2048", "--max-points", "2048",
           "--health-json", str(tmp_path / "{}.json")], tmp_path)
    jm = ply.read_ply(str(tmp_path / "jax.ply"))
    tm = ply.read_ply(str(tmp_path / "port.ply"))
    assert abs(len(tm) - len(jm)) <= 0.05 * len(jm) and len(tm) > 200
    _same_edges(tmp_path, "")


