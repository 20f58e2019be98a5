"""The port's band-sparse Poisson at the depths and options the bench's deep
rows run (depths 14-16, the int64 block key, the ``"vcycle"`` and
``"chebyshev"`` preconditioners, the fields of :class:`PoissonParams`, the
dispatch's warnings) against the JAX package's on the same numpy inputs, on
the CPU.

Tolerances:
* band set-up at depths 9, 14 and 16: ``block_coords``, ``block_valid``,
  ``nbr``, the splat's corner slots and found flags, the origin and the
  band size exact; the voxel scale to 1 ulp and ``rhs``, ``W``,
  ``density`` and the splat weights to 1e-4 of each field's max, as
  tests/test_torch_poisson_sparse.py states for depth 6;
* key order and lookup: the int64 key's sort, first-occurrence mask and
  rank lookup equal to the JAX package's (hi, lo) pair path exactly;
* solves: iterations within ±2 of JAX, χ on the band to 1e-3·max|χ| and the
  iso level to 1e-4·max|χ| (every dot product sums in another order);
* the matvec count of a solve exact: ``(1 + a)·(k + 1)`` for k iterations
  and a fine matvecs in one preconditioner application.

``mesh_from_cloud`` at depth 14 and with each preconditioner is in
tests/test_torch_meshing.py.
"""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import (
    poisson_sparse as jps,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    poisson_sparse,
)


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_poisson_sparse.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def _anchored_sphere(n, seed, r=50.0, a=100.0):
    """``n`` points of a sphere of radius ``r`` with their outward normals
    and the bench's eight anchors at ±``a`` (normals +x): a sparse cloud
    whose deep band is a few thousand blocks."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    anchors = np.asarray([[s * a, t * a, v * a] for s in (-1, 1)
                          for t in (-1, 1) for v in (-1, 1)], np.float32)
    pts = np.vstack([(u * r).astype(np.float32), anchors])
    nrm = np.vstack([u.astype(np.float32),
                     np.tile([1.0, 0.0, 0.0], (8, 1)).astype(np.float32)])
    return pts, nrm


@pytest.mark.parametrize("depth,coord_floor", [(9, 0), (14, 1023),
                                               (16, 2048)])
def test_setup_matches_jax(depth, coord_floor):
    """Depth 9 takes the JAX package's int32 pack, 14 and 16 its (hi, lo)
    pair path: the port's one int64 key gives the same band and slots."""
    pts, nrm = _anchored_sphere(300, 0)
    m = 8704
    n = pts.shape[0]
    j = [np.asarray(a) for a in jps._setup_sparse(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.ones((n,), bool), 2 ** depth,
        m, jnp.float32(4.0))]
    t = poisson_sparse._setup_sparse(
        torch.tensor(pts), torch.tensor(nrm), torch.ones(n, dtype=torch.bool),
        2 ** depth, m, torch.tensor(4.0))
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
    bv = got["block_valid"]
    assert 1000 < int(bv.sum()) <= m
    assert got["block_coords"][bv].max() > coord_floor


def _random_coords(seed, hi):
    r = np.random.default_rng(seed)
    coords = np.unique(r.integers(0, hi, size=(500, 3)), axis=0)
    queries = np.vstack([coords[::3], r.integers(0, hi, size=(300, 3))])
    return coords, queries


@pytest.mark.parametrize("hi", [900, 8192])
def test_key_order_and_lookup_match_the_pair_path(hi):
    """The random table of the JAX package's pair-lookup test (coordinates
    below 900), and one spanning depth 16's 13-bit axis: sort order,
    first-occurrence mask and (slot, found) of the int64 key equal the
    JAX package's ``_sorted_unique(hi, lo)`` and ``_rank_lookup``."""
    coords, queries = _random_coords(7, hi)
    # Duplicates and invalid rows (hi = _BIG) in the sorted input.
    keys_in = np.vstack([coords, coords[::5]])
    invalid = np.arange(keys_in.shape[0]) % 11 == 0
    jh = np.where(invalid, jps._BIG, keys_in[:, 0]).astype(np.int32)
    jl = np.where(invalid, 0, (keys_in[:, 1] << jps._WB)
                  | keys_in[:, 2]).astype(np.int32)
    h, lo, first = (np.asarray(a) for a in jps._sorted_unique(
        jnp.asarray(jh), jnp.asarray(jl)))
    key = poisson_sparse._pack(torch.tensor(keys_in))
    key = torch.where(torch.tensor(invalid), poisson_sparse._BIG, key)
    s, tfirst = poisson_sparse._sorted_unique(key)
    real = h < jps._BIG
    np.testing.assert_array_equal(s.numpy() < poisson_sparse._BIG, real)
    np.testing.assert_array_equal(tfirst.numpy()[real], first[real])
    dec = poisson_sparse._unpack(s[torch.tensor(real)]).numpy()
    np.testing.assert_array_equal(
        dec, np.stack([h[real], lo[real] >> jps._WB,
                       lo[real] & ((1 << jps._WB) - 1)], 1))

    sc = coords[np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))]
    jslot, jfound = (np.asarray(a) for a in jps._rank_lookup(
        jnp.asarray(sc[:, 0]), jnp.asarray((sc[:, 1] << jps._WB) | sc[:, 2]),
        jnp.asarray(queries[:, 0]),
        jnp.asarray((queries[:, 1] << jps._WB) | queries[:, 2])))
    table = poisson_sparse._pack(torch.tensor(sc))
    assert torch.all(table[1:] > table[:-1])
    slot, found = poisson_sparse._rank_lookup1(
        table, poisson_sparse._pack(torch.tensor(queries)))
    np.testing.assert_array_equal(found.numpy(), jfound)
    np.testing.assert_array_equal(slot.numpy()[jfound], jslot[jfound])


def test_depth14_solve_matches_jax():
    """One depth-14 solve end to end (additive, 6 iterations)."""
    pts, nrm = _anchored_sphere(100, 1)
    kw = dict(depth=14, cg_iters=6, max_blocks=3072, coarse_iters=30,
              with_stats=True)
    g_j, nb_j, st_j = jps.reconstruct_sparse(pts, nrm, **kw)
    g_t, nb_t, st_t = poisson_sparse.reconstruct_sparse(
        torch.tensor(pts), torch.tensor(nrm), **kw)
    assert nb_t == int(nb_j) > 2000
    assert abs(st_t["cg_iters_used"] - st_j["cg_iters_used"]) <= 2
    bv = np.asarray(g_j.block_valid)
    np.testing.assert_array_equal(g_t.block_valid.numpy(), bv)
    np.testing.assert_array_equal(g_t.block_coords.numpy(),
                                  np.asarray(g_j.block_coords))
    np.testing.assert_array_equal(g_t.nbr.numpy(), np.asarray(g_j.nbr))
    chi_j = np.asarray(g_j.chi)
    scale = np.abs(chi_j).max()
    np.testing.assert_allclose(g_t.chi.numpy()[bv], chi_j[bv],
                               atol=1e-3 * scale, rtol=0)
    assert abs(float(g_t.iso) - float(g_j.iso)) <= 1e-4 * scale
    assert g_t.resolution == 2 ** 14


def test_params_fields_and_defaults_match_jax():
    assert poisson_sparse.PoissonParams._fields == jps.PoissonParams._fields
    assert (poisson_sparse.PoissonParams._field_defaults
            == jps.PoissonParams._field_defaults)


def _sphere(n, seed, r=50.0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return (u * r).astype(np.float32), u.astype(np.float32)


_SMALL = dict(depth=6, cg_iters=80, max_blocks=2048, coarse_depth=5,
              coarse_iters=100)


@pytest.mark.parametrize("knob,value", [
    ("smooth_omega", 1.0), ("precond_coarse_iters", 3), ("cheby_degree", 6),
    ("cheby_lmin", 0.1), ("cheby_lmax", 1.5)])
def test_jax_only_knob_off_its_default_raises(knob, value):
    """The JAX package's preconditioner fields construct at any value, but
    the port runs each scheme with its default constants: another value is
    refused by name, before any work, not ignored."""
    pts, nrm = _sphere(200, 6)
    params = poisson_sparse.PoissonParams(**_SMALL, **{knob: value})
    with pytest.raises(ValueError, match=f"^{knob}={value!r}: .* default"):
        poisson_sparse.reconstruct_sparse(
            torch.tensor(pts), torch.tensor(nrm), params=params)


@pytest.mark.parametrize("precond,per_apply,fine_dtype", [
    ("additive", 0, "float32"), ("vcycle", 2, "float32"),
    ("chebyshev", 3, "float32"), ("jacobi", 0, "float32"),
    ("additive", 0, "bfloat16"), ("vcycle", 2, "bfloat16"),
    ("chebyshev", 3, "bfloat16")])
def test_matvec_count_per_scheme(monkeypatch, precond, per_apply,
                                 fine_dtype):
    """Every fine matvec of a solve goes through ``matvec_band``: one for
    r₀ and one an iteration, each with its preconditioner application's
    (2 for vcycle, 3 for the degree-4 chebyshev)."""
    calls = []
    real = poisson_sparse.matvec_band

    def counted(*args):
        calls.append(args[0].dtype)
        return real(*args)

    monkeypatch.setattr(poisson_sparse, "matvec_band", counted)
    pts, nrm = _sphere(2000, 5)
    _, _, st = poisson_sparse.reconstruct_sparse(
        torch.tensor(pts), torch.tensor(nrm), params=poisson_sparse.
        PoissonParams(depth=6, cg_iters=8, max_blocks=2048, coarse_depth=5,
                      coarse_iters=40, preconditioner=precond,
                      fine_dtype=fine_dtype), with_stats=True)
    k = st["cg_iters_used"]
    assert k > 0
    assert len(calls) == (1 + per_apply) * (k + 1)
    assert set(calls) == {torch.float32}   # the matvec stays float32


class _Stop(Exception):
    pass


def _warnings(caplog, module, setup, *args, **kw):
    """WARNING messages of one ``reconstruct_sparse`` call of ``module``
    with its set-up replaced by ``setup`` (which ends the call)."""
    caplog.clear()
    real = module._setup_sparse
    module._setup_sparse = setup
    # The JAX package's loggers stop short of the root logger, where caplog
    # listens: caplog's handler goes on the module's own logger instead.
    propagate = module.log.propagate
    module.log.propagate = False
    module.log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING), pytest.raises(_Stop):
            module.reconstruct_sparse(*args, **kw)
    finally:
        module._setup_sparse = real
        module.log.removeHandler(caplog.handler)
        module.log.propagate = propagate
    return [r.getMessage() for r in caplog.records
            if r.levelno == logging.WARNING]


def test_coarse_ratio_warning_matches_jax(caplog):
    """Depth 16 at the default coarse depth (256³) runs at coarse/fine
    ratio 256 and warns, in both packages with one message; depth 15 at
    ratio 128 does not."""
    pts, nrm = _sphere(200, 2)

    def stop(*args, **kw):
        raise _Stop

    for depth, want in ((16, 1), (15, 0)):
        got_j = _warnings(caplog, jps, stop, pts, nrm, depth=depth)
        got_t = _warnings(caplog, poisson_sparse, stop, torch.tensor(pts),
                          torch.tensor(nrm), depth=depth)
        assert got_t == got_j and len(got_t) == want
        assert all("coarse/fine ratio is 256" in g for g in got_t)
    got = _warnings(caplog, poisson_sparse, stop, torch.tensor(pts),
                    torch.tensor(nrm), depth=16, coarse_depth=9)
    assert got == []   # an explicit coarse depth is the caller's choice


def test_retry_memory_warning_matches_jax(caplog):
    """A retried band above ~8 GB of solver state (500,000 blocks → a
    budget of 626,024) warns after the overflow warning, in both packages
    with the same messages."""
    pts, nrm = _sphere(200, 3)

    def overflow(calls, n_blocks):
        def setup(*args, **kw):
            calls.append(args[4])
            if len(calls) > 1:
                raise _Stop
            return (None,) * 11 + (n_blocks,)
        return setup

    seen_j, seen_t = [], []
    got_j = _warnings(caplog, jps, overflow(seen_j, jnp.int32(500_000)),
                      pts, nrm, depth=14, max_blocks=196_608)
    got_t = _warnings(caplog, poisson_sparse,
                      overflow(seen_t, torch.tensor(500_000)),
                      torch.tensor(pts), torch.tensor(nrm), depth=14,
                      max_blocks=196_608)
    assert got_t == got_j and len(got_t) == 2
    assert "~10.3 GB" in got_t[1] and "626024 blocks" in got_t[1]
    assert seen_t == seen_j == [196_608, 626_024]
    # A retry that stays under 8 GB does not warn about memory.
    got = _warnings(caplog, poisson_sparse,
                    overflow([], torch.tensor(150_000)), torch.tensor(pts),
                    torch.tensor(nrm), depth=14, max_blocks=131_072)
    assert len(got) == 1 and "rebuilding the band" in got[0]
