"""The port's TSDF brick pool (``ops/tsdf.py``, ``ops/tsdf_combine.py``)
against the JAX package's ``ops/tsdf.py`` on the same numpy inputs, on the
CPU.

Tolerances:
* the combine's plain version against the JAX ``_combine(use_pallas=False)``
  to 1e-6 (the same float32 formula, a true division); against
  ``combine_pallas(interpret=True)`` to 5e-3, the JAX package's own bound
  for its reciprocal-multiply kernel (tests/test_fusion.py);
* ``integrate`` against the JAX ``integrate(use_pallas=False)`` and against
  the NumPy ``integrate_oracle``: 1e-4 on weight and TSDF, 1e-2 on RGB
  (0–255), as tests/test_fusion.py — the scatter sums run in another order;
  with carving off and on; brick directory, coordinates and counts exact;
* ``neighbor_table`` exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import tsdf as jtsdf
from structured_light_for_3d_model_replication_tpu.ops import tsdf_pallas
from structured_light_for_3d_model_replication_tpu_torch.ops import tsdf
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    tsdf_combine as tc,
)


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def _fold_inputs(cap, seed):
    rng = np.random.default_rng(seed)
    shp = (cap, 512)
    tsdf_v = rng.uniform(-1, 1, shp).astype(np.float32)
    weight = rng.uniform(0, 80, shp).astype(np.float32)
    weight[:, ::5] = 64.0                       # at the clamp
    rgb = rng.uniform(0, 255, shp + (3,)).astype(np.float32)
    den = ((rng.uniform(size=shp) > 0.5)
           * rng.uniform(0, 2, shp)).astype(np.float32)
    num = (den * rng.uniform(-1, 1, shp)).astype(np.float32)
    rgbnum = (den[..., None]
              * rng.uniform(0, 255, shp + (3,))).astype(np.float32)
    return tsdf_v, weight, rgb, num, den, rgbnum


@pytest.mark.parametrize("cap", [1, 37])
def test_combine_plain_matches_jax_xla_form(cap):
    args = _fold_inputs(cap, cap)
    ref = jtsdf._combine(*args, np.float32(64.0), use_pallas=False)
    got = tc.tsdf_combine(*(torch.from_numpy(a) for a in args), 64.0)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)


def test_combine_plain_matches_pallas_interpret():
    args = _fold_inputs(32, 3)
    ref = tsdf_pallas.combine_pallas(*args, np.float32(8.0), interpret=True)
    got = tc.tsdf_combine_reference(*(torch.from_numpy(a) for a in args),
                                    8.0)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3)


def test_combine_wrapper_checks_its_operands():
    args = [torch.from_numpy(a) for a in _fold_inputs(4, 5)]
    bad = list(args)
    bad[4] = bad[4][:3]
    with pytest.raises(ValueError, match=r"\(cap, 512\)"):
        tc.tsdf_combine(*bad, 64.0)
    bad = list(args)
    bad[3] = bad[3].double()
    with pytest.raises(ValueError, match="float32"):
        tc.tsdf_combine(*bad, 64.0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        tc.tsdf_combine(*meta, 64.0)


def _sphere(n, seed, radius=1.0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * radius).astype(np.float32)
    cols = ((u * 0.5 + 0.5) * 255.0).astype(np.float32)
    valid = rng.random(n) > 0.1
    return pts, u.astype(np.float32), cols, valid


def _port_state(params, state=None):
    return tsdf.init_state(params, "cpu") if state is None else state


def _jax_dense(jstate, params):
    return jtsdf.state_to_dense(jstate, params)


@pytest.mark.parametrize("carve", [0, 2])
def test_integrate_matches_jax_and_oracle(carve):
    """Two stops into one volume (the second folds into a non-empty
    state): the port against the JAX op and the dense NumPy oracle."""
    jp = jtsdf.TSDFParams(grid_depth=6, max_bricks=1024, carve_steps=carve)
    tp = tsdf.TSDFParams(grid_depth=6, max_bricks=1024, carve_steps=carve)
    origin = np.full(3, -1.3, np.float32)
    voxel = 2.6 / 64
    jstate, tstate, dense = jtsdf.init_state(jp), _port_state(tp), None
    for stop in range(2):
        pts, nrm, cols, valid = _sphere(1500, 10 + stop)
        dirs = -nrm
        jstate, jn = jtsdf.integrate(jstate, jp, pts, cols, valid, dirs,
                                     origin, voxel, use_pallas=False)
        tstate, tn = tsdf.integrate(
            tstate, tp, torch.from_numpy(pts), torch.from_numpy(cols),
            torch.from_numpy(valid), torch.from_numpy(dirs),
            torch.from_numpy(origin), voxel)
        dense = tsdf.integrate_oracle(dense, pts, cols, valid, dirs, origin,
                                      voxel, tp)
        assert int(tn) == int(jn)
    assert int(tstate.n_bricks) == int(jstate.n_bricks) > 0
    np.testing.assert_array_equal(tstate.dir_map.numpy(),
                                  np.asarray(jstate.dir_map))
    np.testing.assert_array_equal(tstate.brick_coords.numpy(),
                                  np.asarray(jstate.brick_coords))
    td, wd, rd = tsdf.state_to_dense(tstate, tp)
    for ref in (_jax_dense(jstate, jp), dense):
        t, w, rgb = ref
        assert np.abs(w - wd).max() < 1e-4
        obs = w > 0
        assert obs.any()
        assert np.abs((t - td)[obs]).max() < 1e-4
        assert np.abs((rgb - rd)[obs]).max() < 1e-2


def test_integrate_pool_overflow_drops_bricks():
    """A pool far smaller than the surface: ``n_wanted > cap``, the pool
    fills exactly, and the port drops the same bricks as the JAX op."""
    jp = jtsdf.TSDFParams(grid_depth=7, max_bricks=16)
    tp = tsdf.TSDFParams(grid_depth=7, max_bricks=16)
    pts, nrm, cols, valid = _sphere(3000, 4)
    origin = np.full(3, -1.2, np.float32)
    voxel = 2.4 / 128
    jstate, jn = jtsdf.integrate(jtsdf.init_state(jp), jp, pts, cols, valid,
                                 -nrm, origin, voxel, use_pallas=False)
    tstate, tn = tsdf.integrate(
        _port_state(tp), tp, torch.from_numpy(pts), torch.from_numpy(cols),
        torch.from_numpy(valid), torch.from_numpy(-nrm),
        torch.from_numpy(origin), voxel)
    assert int(tn) == int(jn) > 16
    assert int(tstate.n_bricks) == 16
    np.testing.assert_array_equal(tstate.dir_map.numpy(),
                                  np.asarray(jstate.dir_map))
    np.testing.assert_allclose(tstate.weight.numpy(),
                               np.asarray(jstate.weight), atol=1e-4)


def test_neighbor_table_matches_jax():
    jp = jtsdf.TSDFParams(grid_depth=6, max_bricks=512)
    tp = tsdf.TSDFParams(grid_depth=6, max_bricks=512)
    pts, nrm, cols, valid = _sphere(2000, 6)
    origin = np.full(3, -1.3, np.float32)
    voxel = 2.6 / 64
    jstate, _ = jtsdf.integrate(jtsdf.init_state(jp), jp, pts, cols, valid,
                                -nrm, origin, voxel, use_pallas=False)
    tstate, _ = tsdf.integrate(
        _port_state(tp), tp, torch.from_numpy(pts), torch.from_numpy(cols),
        torch.from_numpy(valid), torch.from_numpy(-nrm),
        torch.from_numpy(origin), voxel)
    jnbr, jok = jtsdf.neighbor_table(jstate, jp)
    nbr, ok = tsdf.neighbor_table(tstate, tp)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_camera_dirs_match_jax():
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(200, 3)).astype(np.float32) * 50
    pts[0] = 0.0                                 # at the camera
    cam = np.zeros(3, np.float32)
    ref = np.asarray(jtsdf.camera_dirs(jnp.asarray(pts), jnp.asarray(cam)))
    got = tsdf.camera_dirs(torch.from_numpy(pts), torch.from_numpy(cam))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-7)
