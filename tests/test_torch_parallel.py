"""The port's device meshes and sharded batch reconstruction against the
JAX package's (tests/test_parallel.py), on host members.

The JAX package runs on 8 forced host devices (tests/conftest.py); the
port's host members are ``torch.device("cpu", k)``, k < 8, told apart by
label. Tolerances: the port's sharded batch equals its unsharded batch bit
for bit (counts and maxima reduce exactly); against the JAX package's
sharded run, ``valid`` equal and points ``atol=1e-3`` (as
tests/test_parallel.py holds JAX's own sharded run to its unsharded one).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from structured_light_for_3d_model_replication_tpu.models import (
    synthetic as jsynthetic,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    triangulate as jtri,
)
from structured_light_for_3d_model_replication_tpu.parallel import (
    mesh as jmesh,
)
from structured_light_for_3d_model_replication_tpu.parallel import (
    pipeline as jpar,
)
from structured_light_for_3d_model_replication_tpu_torch.config import (
    DecodeConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    pipeline,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)
from structured_light_for_3d_model_replication_tpu_torch.parallel import (
    mesh as pmesh,
)
from structured_light_for_3d_model_replication_tpu_torch.parallel import (
    pipeline as par,
)

from .conftest import CAM_H, CAM_W, SMALL_PROJ

HOST = [torch.device("cpu", k) for k in range(8)]


@pytest.fixture(scope="module")
def batch_and_calib(synth_rig):
    cam_K, proj_K, R, T = synth_rig
    jcal = jtri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                                 proj_width=SMALL_PROJ.width,
                                 proj_height=SMALL_PROJ.height)
    scans = jsynthetic.render_turntable_scans(
        jsynthetic.Scene(), 4, 90.0, cam_K, proj_K, R, T, CAM_H, CAM_W,
        SMALL_PROJ)
    stacks = np.stack([s for s, _ in scans])
    gts = [gt for _, gt in scans]
    cal = tri.calibration_from_numpy(
        {k: np.asarray(v) for k, v in jcal._asdict().items()}, device="cpu")
    return stacks, jcal, cal, gts


def _unsharded(stacks, cal, **kw):
    return pipeline.reconstruct_batch(stacks, cal, SMALL_PROJ.col_bits,
                                      SMALL_PROJ.row_bits, device="cpu",
                                      **kw)


def _assert_bit_equal(got, want):
    for f in pipeline.CloudResult._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert torch.equal(a, b), f


def test_make_mesh_shapes():
    m = pmesh.make_mesh(data=4, space=2, devices=HOST)
    assert dict(zip(m.axis_names, (len(m.devices), len(m.devices[0])))) \
        == {"data": 4, "space": 2}
    assert m.shape == {"data": 4, "space": 2} and m.size == 8
    assert m.labels() == [f"cpu:{k}" for k in range(8)]
    with pytest.raises(ValueError, match="divisible"):
        pmesh.make_mesh(space=3, devices=HOST)
    with pytest.raises(ValueError, match="need"):
        pmesh.make_mesh(data=16, space=1, devices=HOST)
    # A device listed twice is refused: the JAX package's mesh refuses it
    # when a batch is placed on it, the port's when it is built.
    with pytest.raises(ValueError, match="repeated"):
        pmesh.make_mesh(data=1, space=2,
                        devices=[HOST[1], torch.device("cpu", 1)])
    twice = jmesh.make_mesh(data=1, space=2,
                            devices=[jax.devices()[1]] * 2)
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((1, 1, 4, 2), np.uint8),
                       jmesh.stack_batch_sharding(twice))


def test_span_labels_resolve_in_enumeration_order():
    """Placement follows device enumeration, not label order, and an
    unknown label raises — as the JAX package's resolve_device_labels."""
    got = pmesh.resolve_device_labels(["cpu:5", "cpu:2"], devices=HOST)
    assert [pmesh.device_label(d) for d in got] == ["cpu:2", "cpu:5"]
    jgot = jmesh.resolve_device_labels(["cpu:5", "cpu:2"])
    assert [f"{d.platform}:{d.id}" for d in jgot] == ["cpu:2", "cpu:5"]
    with pytest.raises(ValueError, match="unknown device label"):
        pmesh.resolve_device_labels(["cpu:9"], devices=HOST)
    span = pmesh.serve_span_mesh(("cpu:3", "cpu:1"), devices=HOST)
    assert span.shape == {"data": 1, "space": 2}
    assert span.labels() == ["cpu:1", "cpu:3"]
    assert pmesh.serve_space_mesh(4, devices=HOST).labels() == \
        [f"cpu:{k}" for k in range(4)]


def test_placements_split_and_gather_in_member_order():
    m = pmesh.make_mesh(data=2, space=3, devices=HOST[:6])
    x = torch.arange(2 * 1 * 7 * 2).reshape(2, 1, 7, 2)
    blocks = pmesh.split_batch(x, m)
    assert [[tuple(b.shape) for b in row] for row in blocks] == \
        [[(1, 1, 3, 2), (1, 1, 3, 2), (1, 1, 1, 2)]] * 2
    back = torch.cat([pmesh.gather_rows(row, 2, "cpu") for row in blocks], 0)
    assert torch.equal(back, x)
    assert pmesh.blocks(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]


def test_reconstruct_sharded_matches_jax_and_unsharded(batch_and_calib):
    stacks, jcal, cal, _ = batch_and_calib
    jm = jmesh.make_mesh(data=4, space=2)
    jout = jpar.reconstruct_sharded(jnp.asarray(stacks), jcal, jm,
                                    SMALL_PROJ.col_bits, SMALL_PROJ.row_bits)
    m = pmesh.make_mesh(data=4, space=2, devices=HOST)
    out = par.reconstruct_sharded(stacks, cal, m, SMALL_PROJ.col_bits,
                                  SMALL_PROJ.row_bits)
    assert np.array_equal(out.valid.numpy(), np.asarray(jout.valid))
    np.testing.assert_allclose(out.points.numpy(), np.asarray(jout.points),
                               atol=1e-3)
    assert np.array_equal(out.col_map.numpy(), np.asarray(jout.col_map))
    _assert_bit_equal(out, _unsharded(stacks, cal))


@pytest.mark.parametrize("data, space, kw", [
    (3, 2, {}),                                  # 4 scans over 3
    (1, 5, {}),                                  # 96 rows over 5
    (1, 7, dict(downsample=2)),                  # 96 rows / 7, downsampled
    (2, 4, dict(decode_cfg=DecodeConfig(mode="fixed"))),
])
def test_uneven_or_downsampled_split_is_bit_equal(batch_and_calib, data,
                                                  space, kw):
    """Rows split in ``ceil(H / space)`` blocks (the last shorter, as
    GSPMD pads) and scans in ``ceil(B / data)``: every member indexes the
    calibration at its global row offset, so any split — downsampled
    codes and the fixed mask too — equals the unsharded batch bit for
    bit."""
    stacks, _, cal, _ = batch_and_calib
    m = pmesh.make_mesh(data=data, space=space, devices=HOST[:data * space])
    out = par.reconstruct_sharded(stacks, cal, m, SMALL_PROJ.col_bits,
                                  SMALL_PROJ.row_bits, **kw)
    _assert_bit_equal(out, _unsharded(stacks, cal, **kw))


def test_member_steps_run_in_turn_on_one_device(batch_and_calib):
    """The members' steps are functions of (block, device, row offset):
    every block placed on ONE device and stepped in turn (how
    ``chip_smoke.py`` runs a span's members on one card) gives the same
    bits as the mesh."""
    stacks, _, cal, _ = batch_and_calib
    layout = pmesh.blocks(CAM_H, 4)
    blocks = [[torch.from_numpy(stacks[:, :, r0:r1]).contiguous()
               for r0, r1 in layout]]
    calibs = [[cal] * len(layout)]
    out = par.reconstruct_blocks(blocks, calibs, SMALL_PROJ.col_bits,
                                 SMALL_PROJ.row_bits)
    _assert_bit_equal(out, _unsharded(stacks, cal))


def test_sharded_accuracy_vs_ground_truth(batch_and_calib):
    stacks, _, cal, gts = batch_and_calib
    m = pmesh.make_mesh(data=2, space=2, devices=HOST[:4])
    out = par.reconstruct_sharded(stacks, cal, m, SMALL_PROJ.col_bits,
                                  SMALL_PROJ.row_bits)
    checked = 0
    for b in range(stacks.shape[0]):
        valid = out.valid[b].numpy()
        if not valid.any():
            continue
        pts = out.points[b].numpy()[valid]
        gt = gts[b]["points"].reshape(-1, 3)[valid]
        err = np.median(np.linalg.norm(pts - gt, axis=1))
        assert err < 5.0, f"scan {b} median error {err} mm"
        checked += 1
    assert checked
