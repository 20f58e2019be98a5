"""The port's band-sparse screened Poisson (``ops/poisson_sparse.py``) and
its matvec (``ops/poisson_matvec.py``) against the JAX package's on the same
numpy inputs, on the CPU.

Tolerances:
* band set-up: ``block_coords``, ``block_valid``, ``nbr``, the splat's
  corner slots and found flags and the origin exact; the voxel scale to
  1 ulp (inside the JAX package's jitted set-up XLA rounds that quotient
  otherwise than op by op); ``rhs``, ``W``, ``density`` and the splat
  weights to 1e-4 of each field's max — the splat's scatter-adds sum in
  another order;
* matvec: the plain version against ``matvec_pallas_v2`` and
  ``matvec_pallas`` in interpret mode to ``atol=1e-5·scale, rtol=1e-5``
  (the tolerance of tests/test_poisson_pallas.py), zero outside the band;
  the wrapper on a CPU tensor is the plain version itself;
* solve: ``cg_iters_used`` and ``coarse_iters_used`` within ±2 of JAX; χ
  on the band to 1e-3·max|χ| and the iso level to 1e-4·max|χ| — the
  additive preconditioner's products and every dot product sum in another
  order, which CG carries along; Jacobi stops close to its cap here, so its
  χ is held to 2e-3·max|χ|.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import (
    poisson_pallas as jpp,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    poisson_sparse as jps,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    poisson_matvec,
    poisson_sparse,
)


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
    return (u * r).astype(np.float32), u.astype(np.float32)


def _setups(pts, nrm, depth, max_blocks):
    n = pts.shape[0]
    j = jps._setup_sparse(jnp.asarray(pts), jnp.asarray(nrm),
                          jnp.ones((n,), bool), 2 ** depth, max_blocks,
                          jnp.float32(4.0))
    t = poisson_sparse._setup_sparse(
        torch.tensor(pts), torch.tensor(nrm),
        torch.ones(n, dtype=torch.bool), 2 ** depth, max_blocks,
        torch.tensor(4.0))
    return [np.asarray(a) for a in j], t


def test_setup_matches_jax():
    pts, nrm = _sphere(8000, 0)
    j, t = _setups(pts, nrm, 6, 2048)
    names = ("rhs", "W", "nbr", "block_valid", "block_coords", "density",
             "flat", "w", "cfound", "origin", "scale", "n_blocks")
    got = dict(zip(names, (a.numpy() for a in t)))
    ref = dict(zip(names, j))
    np.testing.assert_allclose(got["scale"], ref["scale"], rtol=1.2e-7)
    for k in ("nbr", "block_valid", "block_coords", "flat", "cfound",
              "n_blocks", "origin"):
        np.testing.assert_array_equal(got[k], ref[k].astype(got[k].dtype),
                                      err_msg=k)
    for k in ("rhs", "W", "density", "w"):
        np.testing.assert_allclose(got[k], ref[k],
                                   atol=1e-4 * np.abs(ref[k]).max(), rtol=0,
                                   err_msg=k)
    assert 0 < int(got["block_valid"].sum()) < 2048


@pytest.fixture(scope="module")
def band():
    """A depth-9 band of 20 000 sphere samples with 8192 block slots — the
    shape of tests/test_poisson_pallas.py."""
    rng = np.random.default_rng(3)
    u = rng.normal(size=(20_000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    j = jps._setup_sparse(
        jnp.asarray((u * 50.0).astype(np.float32)),
        jnp.asarray(u.astype(np.float32)), jnp.ones((20_000,), bool), 2 ** 9,
        8192, jnp.float32(4.0))
    rhs, W, nbr, bv = (np.asarray(a) for a in j[:4])
    return rhs, W, nbr, bv


def _plain(rhs, W, nbr, bv):
    return poisson_matvec.matvec_band_reference(
        torch.tensor(rhs), torch.tensor(W), torch.tensor(nbr),
        torch.tensor(bv)).numpy()


@pytest.mark.parametrize("kernel,cb", [("v2", 32), ("v1", 8), ("v2", 48)])
def test_matvec_matches_pallas(band, kernel, cb):
    """Both TPU kernels compute the same function; cb=48 takes the pad
    branch (8192 % 48 != 0)."""
    rhs, W, nbr, bv = band
    fn = jpp.matvec_pallas_v2 if kernel == "v2" else jpp.matvec_pallas
    ref = np.asarray(fn(jnp.asarray(rhs), jnp.asarray(W), jnp.asarray(nbr),
                        jnp.asarray(bv), interpret=True, cb=cb))
    got = _plain(rhs, W, nbr, bv)
    assert np.isfinite(got).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=1e-5)


def test_matvec_zero_outside_band_and_absent_neighbours():
    """On a band with empty slots (depth 6, 2048 slots): zero there, equal
    to the TPU kernel elsewhere."""
    pts, nrm = _sphere(8000, 0)
    j, _ = _setups(pts, nrm, 6, 2048)
    rhs, W, nbr, bv = j[:4]
    got = _plain(rhs, W, nbr, bv)
    assert (~bv).any() and np.all(got[~bv] == 0.0)
    ref = np.asarray(jpp.matvec_pallas_v2(
        jnp.asarray(rhs), jnp.asarray(W), jnp.asarray(nbr), jnp.asarray(bv),
        interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(),
                               rtol=1e-5)
    # The wrapper on a CPU tensor is the plain version.
    wrapped = poisson_matvec.matvec_band(
        torch.tensor(rhs), torch.tensor(W), torch.tensor(nbr),
        torch.tensor(bv)).numpy()
    np.testing.assert_array_equal(wrapped, got)
    # Any slot outside [0, M) is an absent neighbour, like slot M.
    m = nbr.shape[0]
    odd = np.where(nbr == m, np.where(np.arange(6) % 2 == 0, -1, m + 7),
                   nbr).astype(np.int32)
    np.testing.assert_array_equal(_plain(rhs, W, odd, bv), got)


def test_matvec_wrapper_checks_operands(band):
    rhs, W, nbr, bv = (torch.tensor(a) for a in band)
    with pytest.raises(ValueError, match="nbr must be torch.int32"):
        poisson_matvec.matvec_band(rhs, W, nbr.long(), bv)
    with pytest.raises(ValueError, match=r"\(M, 512\)"):
        poisson_matvec.matvec_band(rhs[:, :64], W[:, :64], nbr, bv)


@pytest.mark.parametrize("precond", ["additive", "jacobi"])
def test_reconstruct_sparse_matches_jax(precond):
    pts, nrm = _sphere(8000, 0)
    kw = dict(depth=6, cg_iters=80, max_blocks=2048, coarse_depth=5,
              coarse_iters=100, preconditioner=precond, with_stats=True)
    g_j, nb_j, st_j = jps.reconstruct_sparse(pts, nrm, **kw)
    g_t, nb_t, st_t = poisson_sparse.reconstruct_sparse(
        torch.tensor(pts), torch.tensor(nrm), **kw)
    assert nb_t == int(nb_j)
    assert abs(st_t["cg_iters_used"] - st_j["cg_iters_used"]) <= 2
    assert abs(st_t["coarse_iters_used"] - st_j["coarse_iters_used"]) <= 2
    assert st_t["preconditioner"] == precond
    bv = np.asarray(g_j.block_valid)
    np.testing.assert_array_equal(g_t.block_valid.numpy(), bv)
    np.testing.assert_array_equal(g_t.nbr.numpy(), np.asarray(g_j.nbr))
    chi_j = np.asarray(g_j.chi)
    scale = np.abs(chi_j).max()
    tol = 1e-3 if precond == "additive" else 2e-3
    np.testing.assert_allclose(g_t.chi.numpy()[bv], chi_j[bv],
                               atol=tol * scale, rtol=0)
    assert np.all(g_t.chi.numpy()[~bv] == 0.0)
    assert abs(float(g_t.iso) - float(g_j.iso)) <= 1e-4 * scale
    assert g_t.resolution == g_j.resolution == 64


def test_budget_overflow_rebuilds_the_band():
    """A budget below the true band size is detected after set-up and the
    band rebuilt larger: the same band as an ample budget."""
    pts, nrm = (torch.tensor(a) for a in _sphere(4000, 1))
    kw = dict(depth=6, cg_iters=20, coarse_depth=5, coarse_iters=50)
    g_big, nb_big = poisson_sparse.reconstruct_sparse(
        pts, nrm, max_blocks=2048, **kw)
    g_small, nb_small = poisson_sparse.reconstruct_sparse(
        pts, nrm, max_blocks=128, **kw)
    assert nb_small == nb_big > 128
    # The retry's budget: 1.25× the reported count + 1024 (with the
    # occupied blocks already past the budget, the count is theirs).
    assert nb_big < g_small.chi.shape[0] <= int(nb_big * 1.25) + 1024

    def blocks(g):
        bc = g.block_coords.numpy()[g.block_valid.numpy()]
        return set(map(tuple, bc))

    assert blocks(g_small) == blocks(g_big)


@pytest.mark.parametrize("kw,what", [
    (dict(preconditioner="vcycle"), "'vcycle' preconditioner"),
    (dict(preconditioner="chebyshev"), "'chebyshev' preconditioner"),
    (dict(depth=14), "wide-key path"),
    (dict(depth=16), "wide-key path"),
])
def test_left_out_options_name_their_step(kw, what):
    pts, nrm = (torch.tensor(a) for a in _sphere(200, 2))
    with pytest.raises(NotImplementedError, match="not ported yet") as exc:
        poisson_sparse.reconstruct_sparse(pts, nrm, **kw)
    assert what in str(exc.value) and "ROADMAP Queue 1" in str(exc.value)
    params = poisson_sparse.PoissonParams(fine_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        poisson_sparse.reconstruct_sparse(pts, nrm, params=params)
    with pytest.raises(ValueError, match="preconditioner"):
        poisson_sparse.reconstruct_sparse(pts, nrm, preconditioner="nope")


def test_grid_from_numpy_carries_every_field():
    pts, nrm = _sphere(3000, 4)
    g_j, _ = jps.reconstruct_sparse(pts, nrm, depth=6, cg_iters=10,
                                    max_blocks=2048, coarse_depth=5,
                                    coarse_iters=20,
                                    preconditioner="jacobi")
    g_t = poisson_sparse.grid_from_numpy(
        {k: np.asarray(v) for k, v in g_j._asdict().items()}, device="cpu")
    assert g_t.resolution == 64
    for name in ("chi", "density", "block_coords", "block_valid", "iso",
                 "origin", "scale", "nbr"):
        np.testing.assert_array_equal(getattr(g_t, name).numpy(),
                                      np.asarray(getattr(g_j, name)))
    assert g_t.nbr.dtype == torch.int32 and g_t.block_valid.dtype == torch.bool


def test_matvec_wrapper_needs_16_byte_aligned_rows(band):
    """The kernel moves x and W as 16-byte vectors: a tensor that starts
    off that boundary is refused on any device; whole-row slices are fine."""
    rhs, W, nbr, bv = (torch.tensor(a) for a in band)
    flat = torch.zeros(rhs.numel() + 1)
    x = flat[1:].view(rhs.shape)
    x.copy_(rhs)
    with pytest.raises(ValueError, match="16-byte"):
        poisson_matvec.matvec_band(x, W, nbr, bv)
    with pytest.raises(ValueError, match="16-byte"):
        poisson_matvec.matvec_band(rhs, flat[1:].view(W.shape), nbr, bv)
    got = poisson_matvec.matvec_band(rhs[3:], W[3:], nbr[3:], bv[3:])
    assert torch.equal(got, poisson_matvec.matvec_band_reference(
        rhs[3:], W[3:], nbr[3:], bv[3:]))
