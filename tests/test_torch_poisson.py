"""The port's dense screened-Poisson solve (``ops/poisson.py``) against the
JAX package's on the same numpy inputs, on the CPU.

Tolerances:
* ``normalize_points`` exact (grid points, origin, scale);
* the stencils (``laplacian``, ``divergence``) and ``screen_weights`` to
  1e-6 of the field's scale — the same float32 operations, summed in
  another order where a sum runs over the grid;
* ``reconstruct``: the CG iteration count within ±2; χ − iso at the
  samples (where the surface is extracted) to 1e-4·max|χ|; χ everywhere to
  1e-3·max|χ| — the splat's scatter-adds and the CG's dot products sum in
  another order, and far from the samples the screen barely pins the
  Neumann problem's smooth modes, so there the difference stays at the
  rtol = 3e-4 stop's level (measured 4e-4·max|χ|).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import poisson as jp
from structured_light_for_3d_model_replication_tpu_torch.ops import poisson


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores. Under
    xdist the workers share the host; each at its default thread count,
    ATen's OpenMP regions oversubscribe the cores and spin, which made
    these tests many times slower than one thread each does."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def _sphere(n, seed, r=50.0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = u * r + rng.normal(0, 0.3, (n, 3)) + np.array([5.0, -3.0, 400.0])
    return pts.astype(np.float32), u.astype(np.float32)


def test_normalize_points_exact():
    pts, _ = _sphere(3000, 0)
    valid = np.random.default_rng(1).random(3000) > 0.2
    for res in (32, 128, 512):
        g_j, o_j, s_j = (np.asarray(a) for a in jp.normalize_points(
            jnp.asarray(pts), jnp.asarray(valid), res))
        g_t, o_t, s_t = (a.numpy() for a in poisson.normalize_points(
            torch.tensor(pts), torch.tensor(valid), res))
        np.testing.assert_array_equal(o_t, o_j)
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_array_equal(g_t, g_j)


def test_stencils_and_screen_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(24, 20, 16)).astype(np.float32)
    V = rng.normal(size=(24, 20, 16, 3)).astype(np.float32)
    dens = np.maximum(rng.normal(size=(24, 20, 16)), 0).astype(np.float32)
    np.testing.assert_allclose(
        poisson.laplacian(torch.tensor(x)).numpy(),
        np.asarray(jp.laplacian(jnp.asarray(x))), atol=1e-6 * 6, rtol=0)
    np.testing.assert_allclose(
        poisson.divergence(torch.tensor(V)).numpy(),
        np.asarray(jp.divergence(jnp.asarray(V))), atol=1e-6, rtol=0)
    w_j = np.asarray(jp.screen_weights(jnp.asarray(dens), jnp.float32(4.0)))
    w_t = poisson.screen_weights(torch.tensor(dens), 4.0).numpy()
    np.testing.assert_allclose(w_t, w_j, atol=1e-6 * w_j.max(), rtol=0)


def test_splat_and_gather_match():
    pts, nrm = _sphere(2000, 3)
    valid = np.ones(2000, bool)
    g_j, _, _ = jp.normalize_points(jnp.asarray(pts), jnp.asarray(valid), 32)
    g_t = torch.tensor(np.asarray(g_j))
    s_j = np.asarray(jp.splat(g_j, jnp.asarray(nrm), jnp.asarray(valid), 32))
    s_t = poisson.splat(g_t, torch.tensor(nrm), torch.tensor(valid),
                        32).numpy()
    np.testing.assert_allclose(s_t, s_j, atol=1e-5 * np.abs(s_j).max(),
                               rtol=0)
    grid = np.random.default_rng(4).normal(size=(32, 32, 32)).astype(
        np.float32)
    np.testing.assert_allclose(
        poisson.gather(torch.tensor(grid), g_t).numpy(),
        np.asarray(jp.gather(jnp.asarray(grid), g_j)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("depth", [5, 6])
def test_reconstruct_matches_jax(depth):
    pts, nrm = _sphere(6000, 5)
    g_j, it_j = jp.reconstruct(pts, nrm, depth=depth, return_iters=True)
    g_t, it_t = poisson.reconstruct(torch.tensor(pts), torch.tensor(nrm),
                                    depth=depth, return_iters=True)
    chi_j = np.asarray(g_j.chi)
    scale = np.abs(chi_j).max()
    np.testing.assert_allclose(g_t.chi.numpy(), chi_j, atol=1e-3 * scale,
                               rtol=0)
    gp, _, _ = poisson.normalize_points(
        torch.tensor(pts), torch.ones(len(pts), dtype=torch.bool),
        2 ** depth)
    at_t = (poisson.gather(g_t.chi, gp) - g_t.iso).numpy()
    at_j = (poisson.gather(torch.tensor(chi_j), gp) - float(g_j.iso)).numpy()
    np.testing.assert_allclose(at_t, at_j, atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(g_t.density.numpy(), np.asarray(g_j.density),
                               atol=1e-5 * float(g_j.density.max()), rtol=0)
    assert abs(float(g_t.iso) - float(g_j.iso)) <= 1e-5 * scale
    np.testing.assert_array_equal(g_t.origin.numpy(), np.asarray(g_j.origin))
    assert abs(it_t - it_j) <= 2
    assert g_t.chi.shape == (2 ** depth,) * 3


def test_reconstruct_rejects_deep_and_warm_start():
    pts, nrm = (torch.tensor(a) for a in _sphere(100, 6))
    with pytest.raises(ValueError, match="depth=9 > 8"):
        poisson.reconstruct(pts, nrm, depth=9)
    with pytest.raises(ValueError, match="does not match"):
        poisson.reconstruct(pts, nrm, depth=4,
                            x0=torch.zeros((8, 8, 8)))
