"""``chip_smoke.py``'s phase 8h (several cards and the sharded tier) on
host devices ``torch.device("cpu", k)``, its multi-card branch included:
one card cannot run bench configs 7b above one lane, 7c and 7c2, so this
test is their only run until a machine with two cards or more runs the
phase. Its checks are the phase's own (``fail`` exits on any)."""

import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu_torch.models import (
    synthetic,
)

from .test_torch_serve_lanes import H, HOST, W, _sphere_cloud


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def test_chip_smoke_multi_card_phase_on_host_lanes(monkeypatch):
    """``chip_smoke.py``'s phase 8h on host devices, the branch one card
    cannot run included: (a) the members' steps at widths 2, 4, 8 on one
    device bit-equal to the unsharded batch, (b) the ``device_mesh`` dense
    solve with one member bit-equal to the plain one and with 2 and 4
    members (stepped in turn on one device) within the phase's slab bounds
    (at depth 5 here; the card's is depth 8), (c) the one-device services
    byte-equal to the plain one, then bench configs 7b, 7c and 7c2 and,
    over 2 and 4 of four host lanes, the slab rows bit for bit and the
    slab solve of the sphere and of 7c2's STL cloud on the tiny rig (the
    card runs them at the bench's shapes). The nccl world of one (d)
    needs a card."""
    import importlib.util
    from pathlib import Path

    from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
        PointCloud,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate \
        import make_calibration

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    proj, lane_stack = cs.mc_rig()["7b"]
    stacks = np.stack([lane_stack, lane_stack + np.uint8(3)])
    rig = synthetic.default_calibration(H, W, proj)
    calib = make_calibration(*rig, H, W, proj.width, proj.height,
                             device="cpu")
    host = torch.device("cpu")
    # 24 rows over 8 members: 3 rows each.
    assert set(cs.mc_member_steps(host, stacks, calib, proj)) == \
        {"members 2", "members 4", "members 8"}
    monkeypatch.setattr(cs, "MC_DEPTH", 5)
    solve = cs.mc_dense_solve(host, PointCloud(points=_sphere_cloud()))
    assert solve["plain_faces"] > 500 and solve["repeat_bit_equal"]
    assert [solve[f"{k} members"]["halo_bytes"] for k in (2, 4)] == \
        [2 * 32 * 32 * 4, 6 * 32 * 32 * 4]
    assert set(cs.mc_one_card_services(host, stacks, calib, proj)) == \
        {"plain", "devices=1", "shard_min_pixels"}
    runs = cs.multi_card_runs(list(HOST[:4]))
    assert runs["ran"] == ["7b", "7c", "7c2", "slab solve"]
    assert runs["not_run"] == []
    assert sorted(runs["runs"]["7b"]) == [1, 2, 4]
    assert runs["runs"]["7c2"]["convicted"] == "cpu:0"
    slab = runs["runs"]["slab solve"]
    assert sorted(slab) == ["7c2's STL cloud depth 5", "rows",
                            "the 4001-point sphere depth 5"]
    assert all(sorted(v) == [2, 4] for v in slab.values())
    one = cs.multi_card_runs([HOST[0]])
    assert one["not_run"] == ["7b above 1 lane", "7c", "7c2",
                              "slab solve over 2 cards",
                              "slab solve over 4 cards"]
