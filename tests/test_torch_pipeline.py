"""One stop to a cloud: the port's ``reconstruct`` against the JAX
package's on the conftest synthetic stop, with the JAX calibration carried
across by ``calibration_from_numpy``; the port's own ``make_calibration``
against JAX's.

Tolerances: decode maps and ``valid`` exact; points rtol 1e-5, atol 1e-3 mm
(float32 sums taken in another order); colours exact. The NumPy oracle's
copy equal to the JAX package's exactly, the port's ``reconstruct`` to it
within tests/test_triangulate.py's rtol 1e-4, atol 1e-2. The port's own
calibration: rtol 1e-5, atol 1e-5 (float32 3×3 inverses by another LU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.config import (
    TriangulationConfig as JTriangulationConfig,
)
from structured_light_for_3d_model_replication_tpu.models import (
    pipeline as jpipeline,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    triangulate as jtri,
)
from structured_light_for_3d_model_replication_tpu_torch.config import (
    TriangulationConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.models import (
    pipeline,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)

from .conftest import CAM_H, CAM_W, SMALL_PROJ


@pytest.fixture(scope="module")
def calibs(synth_rig):
    cam_K, proj_K, R, T = synth_rig
    jcal = jtri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                                 SMALL_PROJ.width, SMALL_PROJ.height)
    carried = tri.calibration_from_numpy(
        {k: np.asarray(v) for k, v in jcal._asdict().items()}, device="cpu")
    return jcal, carried


def _run_both(stack, calibs, plane_axis="col"):
    jcal, cal = calibs
    p = SMALL_PROJ
    jr = jpipeline.reconstruct(jnp.asarray(stack), jcal, p.col_bits,
                               p.row_bits,
                               tri_cfg=JTriangulationConfig(plane_axis))
    r = pipeline.reconstruct(stack, cal, p.col_bits, p.row_bits,
                             tri_cfg=TriangulationConfig(plane_axis),
                             device="cpu")
    return jr, r


def test_calibration_from_numpy_is_exact(calibs):
    jcal, cal = calibs
    for name in tri.Calibration._fields:
        got = getattr(cal, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(getattr(jcal, name)))


def test_make_calibration_matches_jax(synth_rig, calibs):
    jcal, _ = calibs
    cam_K, proj_K, R, T = synth_rig
    cal = tri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                               SMALL_PROJ.width, SMALL_PROJ.height,
                               device="cpu")
    for name in tri.Calibration._fields:
        np.testing.assert_allclose(getattr(cal, name).numpy(),
                                   np.asarray(getattr(jcal, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_projector_center_matches_jax(synth_rig):
    _, _, R, T = synth_rig
    got = tri.projector_center(torch.tensor(R, dtype=torch.float32),
                               torch.tensor(T, dtype=torch.float32))
    ref = jtri.projector_center(jnp.asarray(R, jnp.float32),
                                jnp.asarray(T, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_reconstruct_matches_jax(synth_scan, calibs):
    stack, _ = synth_scan
    jr, r = _run_both(stack, calibs)
    assert np.array_equal(r.col_map.numpy(), np.asarray(jr.col_map))
    assert np.array_equal(r.row_map.numpy(), np.asarray(jr.row_map))
    valid = r.valid.numpy()
    assert np.array_equal(valid, np.asarray(jr.valid))
    assert valid.sum() > 1000
    np.testing.assert_allclose(r.points.numpy(), np.asarray(jr.points),
                               rtol=1e-5, atol=1e-3)
    assert r.colors.dtype == torch.uint8
    assert np.array_equal(r.colors.numpy(), np.asarray(jr.colors))


@pytest.mark.parametrize("plane_axis,rtol", [("row", 5e-4), ("both", 1e-5)])
def test_other_plane_axes_match_jax(synth_scan, calibs, plane_axis, rtol):
    """Row planes are nearly parallel to the camera rays on this rig (the
    baseline is horizontal), so n·ray cancels and a one-ulp difference in
    the summation order moves t by ~1e-4 relative: rtol 5e-4 there."""
    stack, _ = synth_scan
    jr, r = _run_both(stack, calibs, plane_axis)
    assert np.array_equal(r.valid.numpy(), np.asarray(jr.valid))
    np.testing.assert_allclose(r.points.numpy(), np.asarray(jr.points),
                               rtol=rtol, atol=1e-3)


def test_reconstruct_batch_matches_single(synth_scan, calibs):
    stack, _ = synth_scan
    _, cal = calibs
    p = SMALL_PROJ
    batch = np.stack([stack, np.roll(stack, 5, axis=1)])
    rb = pipeline.reconstruct_batch(batch, cal, p.col_bits, p.row_bits,
                                    device="cpu")
    assert rb.points.shape == (2, CAM_H * CAM_W, 3)
    for b in range(2):
        r1 = pipeline.reconstruct(batch[b], cal, p.col_bits, p.row_bits,
                                  device="cpu")
        for a, c in zip(rb, r1):
            assert torch.equal(a[b], c)


def test_to_point_cloud_compacts_valid_points(synth_scan, calibs):
    stack, gt = synth_scan
    _, cal = calibs
    r = pipeline.reconstruct(stack, cal, SMALL_PROJ.col_bits,
                             SMALL_PROJ.row_bits, device="cpu")
    cloud = pipeline.to_point_cloud(r)
    assert len(cloud) == int(r.valid.sum())
    assert cloud.colors.shape == (len(cloud), 3)
    # Triangulated points sit near the rendered ground truth (the decode
    # rounds to the nearest projector column: the JAX package's own bound).
    truth = gt["points"].reshape(-1, 3)[r.valid.numpy()]
    err = np.linalg.norm(cloud.points - truth, axis=1)
    assert np.median(err) < 3.0


@pytest.mark.parametrize("binary", [True, False])
def test_write_ply_reads_back_with_jax_reader(tmp_path, rng, binary):
    """The port's writer is a copy of the JAX package's: its files read back
    through the JAX reader (floats exact in binary, %.4f in ASCII)."""
    n = 257
    cloud = ply.PointCloud(
        points=rng.normal(0, 100, (n, 3)).astype(np.float32),
        colors=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        normals=rng.normal(0, 1, (n, 3)).astype(np.float32))
    path = tmp_path / "cloud.ply"
    ply.write_ply(path, cloud, binary=binary)
    back = jply.read_ply(path)
    atol = 0.0 if binary else 5e-5
    np.testing.assert_allclose(back.points, cloud.points, atol=atol)
    np.testing.assert_allclose(back.normals, cloud.normals, atol=atol)
    assert np.array_equal(back.colors, cloud.colors)


def test_threaded_frame_shaders_equal_sequential(synth_rig):
    """A stop's ``FrameShader`` does its matrix products under the render
    lock, so eight shaders built at once in a thread pool (as
    ``chip_smoke.py`` renders a ring) equal the sequential build bit for
    bit, and stop 0's stack equals the JAX package's render."""
    from concurrent.futures import ThreadPoolExecutor

    from structured_light_for_3d_model_replication_tpu.models import (
        synthetic as jsynthetic,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    cam_K, proj_K, R, T = synth_rig
    scenes = [synthetic.rotated_scene(synthetic.Scene(), 15.0 * k)
              for k in range(8)]

    def build(scene):
        shader = synthetic.FrameShader(scene, cam_K, proj_K, R, T, CAM_H,
                                       CAM_W, SMALL_PROJ)
        return shader.ground_truth, (shader._ui, shader._vi, shader._lit)

    with ThreadPoolExecutor(max_workers=8) as ex:
        threaded = list(ex.map(build, scenes))
    sequential = [build(sc) for sc in scenes]
    for (tg, ta), (sg, sa) in zip(threaded, sequential):
        assert tg.keys() == sg.keys()
        for k in sg:
            assert np.array_equal(tg[k], sg[k]), k
        for x, y in zip(ta, sa):
            assert np.array_equal(x, y)
    stack, _ = synthetic.render_scan(scenes[0], cam_K, proj_K, R, T, CAM_H,
                                     CAM_W, SMALL_PROJ)
    jstack, _ = jsynthetic.render_scan(jsynthetic.Scene(), cam_K, proj_K, R,
                                       T, CAM_H, CAM_W, SMALL_PROJ)
    assert np.array_equal(stack, jstack)


def test_oracle_matches_jax(synth_scan, synth_rig, calibs, rng):
    """The port's copy of the NumPy oracle against the JAX package's on the
    96×160 rig, function by function, exactly (both are the same float64
    NumPy); then the port's ``reconstruct`` against it: decode maps equal,
    points within tests/test_triangulate.py's rtol 1e-4, atol 1e-2."""
    from structured_light_for_3d_model_replication_tpu.config import (
        DecodeConfig as JDecodeConfig,
    )
    from structured_light_for_3d_model_replication_tpu.models import (
        oracle as joracle,
    )
    from structured_light_for_3d_model_replication_tpu_torch.config import (
        DecodeConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        oracle,
    )

    stack, _ = synth_scan
    cam_K, proj_K, R, T = synth_rig
    p = SMALL_PROJ
    g = rng.integers(0, 1 << 9, (64, 64)).astype(np.int32)
    assert np.array_equal(oracle.gray_to_binary_np(g, 9),
                          joracle.gray_to_binary_np(g, 9))
    pairs = stack[2:2 + 2 * p.col_bits].reshape(p.col_bits, 2, CAM_H, CAM_W)
    assert np.array_equal(oracle.decode_bits_np(pairs),
                          joracle.decode_bits_np(pairs))
    for mode in ("adaptive", "fixed"):
        assert np.array_equal(
            oracle.masks_np(stack[0], stack[1], DecodeConfig(mode=mode)),
            joracle.masks_np(stack[0], stack[1], JDecodeConfig(mode=mode)))
    maps = oracle.decode_stack_np(stack, p.col_bits, p.row_bits)
    for a, b in zip(maps, joracle.decode_stack_np(stack, p.col_bits,
                                                  p.row_bits)):
        assert np.array_equal(a, b)
    rays = oracle.camera_rays_np(cam_K, CAM_H, CAM_W).reshape(-1, 3)
    for axis, n in (("col", p.width), ("row", p.height)):
        planes = oracle.projector_planes_np(proj_K, R, T, n, axis)
        assert np.array_equal(
            planes, joracle.projector_planes_np(proj_K, R, T, n, axis))
        idx = rng.integers(0, n, rays.shape[0])
        for a, b in zip(oracle._plane_t_np(planes[idx], rays, 1e-6),
                        joracle._plane_t_np(planes[idx], rays, 1e-6)):
            assert np.array_equal(a, b)
        for a, b in zip(oracle._est_np(planes, idx, rays, 1e-6),
                        joracle._est_np(planes, idx, rays, 1e-6)):
            assert np.array_equal(a, b)
    for axis in ("col", "row", "both"):
        got = oracle.triangulate_np(*maps, cam_K, proj_K, R, T, p.width,
                                    p.height, TriangulationConfig(axis))
        want = joracle.triangulate_np(*maps, cam_K, proj_K, R, T, p.width,
                                      p.height, JTriangulationConfig(axis))
        assert got[0].shape[0] > 1000
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    # The port's device path against its oracle.
    r = pipeline.reconstruct(stack, calibs[1], p.col_bits, p.row_bits,
                             device="cpu")
    assert np.array_equal(r.col_map.numpy(), maps[0])
    assert np.array_equal(r.row_map.numpy(), maps[1])
    pts, flat = oracle.triangulate_np(*maps, cam_K, proj_K, R, T, p.width,
                                      p.height)
    got = r.points.numpy().reshape(-1, 3)[flat]
    assert r.valid.numpy().reshape(-1)[flat].all()
    np.testing.assert_allclose(got, pts, rtol=1e-4, atol=1e-2)


def test_render_scan_takes_pattern_frames(synth_rig):
    """``render_scan(pattern_frames=)``: a stack of the given frames, bit for
    bit the JAX package's render of them."""
    from structured_light_for_3d_model_replication_tpu.models import (
        synthetic as jsynthetic,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    frames = synthetic.pattern_frames(SMALL_PROJ)[[0, 1, 5, 9]]
    stack, gt = synthetic.render_scan(synthetic.Scene(), *synth_rig, CAM_H,
                                      CAM_W, SMALL_PROJ,
                                      pattern_frames=frames)
    jstack, jgt = jsynthetic.render_scan(jsynthetic.Scene(), *synth_rig,
                                         CAM_H, CAM_W, SMALL_PROJ,
                                         pattern_frames=frames)
    assert stack.shape == (4, CAM_H, CAM_W)
    assert np.array_equal(stack, jstack)
    full, _ = synthetic.render_scan(synthetic.Scene(), *synth_rig, CAM_H,
                                    CAM_W, SMALL_PROJ)
    assert np.array_equal(full[[0, 1, 5, 9]], stack)
