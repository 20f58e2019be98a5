"""The dense Poisson solve spread over a mesh's space members
(``ops/poisson.Slabs``, ``reconstruct(members=…)``) on host members
``torch.device("cpu", k)``.

Tolerances:
* the slab splat, divergence and Laplacian rows equal the whole grid's bit
  for bit: the same terms in the same order, the neighbours' edge planes
  read as halos, the clamp only at the grid's two faces on the first axis;
* the slab solve against the one-member solve: CG iterations within 1,
  max |Δχ| and |Δiso| within 1e-5·max|χ|, faces within 0.5% — the density
  mean and the CG's dot products are per-member partials folded in member
  order (measured 5e-7 to 3e-6·max|χ| at depths 5-7); a second run and a
  warm start from ``x0`` likewise, the second run bit for bit.
The JAX package's sharded solve (GSPMD over two of its host devices) is
held to ``mesh_from_cloud(device_mesh=…)`` over two host members in
tests/test_torch_serve_lanes.py::test_sharded_solve_pads_non_divisible_clouds.
"""

import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import (
    marching,
    poisson,
)
from structured_light_for_3d_model_replication_tpu_torch.parallel import (
    mesh as pmesh,
)

HOST = tuple(torch.device("cpu", k) for k in range(8))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _sphere(n=6000, seed=5, r=50.0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = u * r + rng.normal(0, 0.3, (n, 3)) + np.array([5.0, -3.0, 400.0])
    return (torch.tensor(pts.astype(np.float32)),
            torch.tensor(u.astype(np.float32)))


def _grid_points(R, n, seed, x_hi=None):
    """(n, 3) grid coordinates in [0, R-1] (first axis below ``x_hi``),
    with points on every slab boundary plane, on both faces and past
    them (the splat clamps)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, R - 1, (n, 3))
    if x_hi is not None:
        g[:, 0] = rng.uniform(0.0, x_hi, n)
        edges = np.arange(0.0, x_hi)
    else:
        edges = np.arange(0.0, R)
    e = np.stack([edges, rng.uniform(0, R - 1, edges.size),
                  rng.uniform(0, R - 1, edges.size)], 1)
    faces = np.array([[0.0, 3.0, 4.0], [R - 1.0, 5.0, 6.0],
                      [-2.0, 1.0, 2.0], [R + 3.0, 2.0, 1.0]])
    if x_hi is not None:
        faces = faces[[0, 2]]
    return torch.tensor(np.concatenate([g, e, faces]).astype(np.float32))


@pytest.mark.parametrize("R", [32, 64])
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("half", [False, True], ids=["whole", "one-half"])
def test_slab_rows_equal_the_whole_grid(R, k, half):
    """Splat, divergence and Laplacian over k members' slabs, gathered,
    equal the whole grid's bit for bit — k = 3 splits R unevenly (11/11/10
    at R = 32); with every point in the first half of the first axis the
    upper members get none and their splat rows are zeros. The rows at the
    two faces of the first axis (global planes 0 and R-1) are checked
    apart: only there does the stencil clamp. Stencils of the slabs taken
    each alone (a clamp at every slab edge) differ: the halos matter."""
    rng = np.random.default_rng(R + k)
    slabs = poisson.Slabs.cut(HOST[:k], R)
    assert slabs.planes == pmesh.blocks(R, k)
    gp = _grid_points(R, 3000, k, x_hi=R / 2 - 1 if half else None)
    vals = torch.tensor(rng.normal(size=(len(gp), 4)).astype(np.float32))
    valid = torch.tensor(rng.random(len(gp)) > 0.1)
    whole = poisson.splat(gp, vals, valid, R)
    got = slabs.splat(gp, vals, valid)
    assert torch.equal(_bits(got.gather(CPU)), _bits(whole))
    if half:
        assert not any(bool(p.any()) for p, (s, _) in
                       zip(got.parts, slabs.planes) if s >= R // 2)
    V = torch.tensor(rng.normal(size=(R, R, R, 3)).astype(np.float32))
    x = torch.tensor(rng.normal(size=(R, R, R)).astype(np.float32))
    for op, field in ((poisson.divergence, V), (poisson.laplacian, x)):
        want = op(field)
        rows = getattr(slabs.split(field), op.__name__)().gather(CPU)
        assert torch.equal(_bits(rows), _bits(want)), op.__name__
        for plane in (0, R - 1):
            assert torch.equal(_bits(rows[plane]), _bits(want[plane]))
        alone = torch.cat([op(field[s:e]) for s, e in slabs.planes])
        assert not torch.equal(alone, want), op.__name__


@pytest.mark.parametrize("depth,k", [(2, 3), (3, 5)])
def test_members_without_planes(depth, k):
    """A member may own no plane (``blocks(4, 3)`` = 2, 2, 0 planes;
    ``blocks(8, 5)`` = 2, 2, 2, 2, 0): it holds no part and the solve runs
    over the others, within the slab bounds of the one-member solve."""
    R = 2 ** depth
    assert pmesh.blocks(R, k)[-1][0] == R
    pts, nrm = _sphere(500, 1)
    one, it1 = poisson.reconstruct(pts, nrm, depth=depth, return_iters=True)
    got, itk = poisson.reconstruct(pts, nrm, depth=depth, return_iters=True,
                                   members=HOST[:k])
    assert len(poisson.Slabs.cut(HOST[:k], R).planes) == k - 1
    scale = float(one.chi.abs().max())
    assert abs(itk - it1) <= 1
    assert float((got.chi - one.chi).abs().max()) <= 1e-5 * scale
    assert torch.equal(_bits(got.density), _bits(one.density))


def _faces(grid):
    return len(marching.extract(grid, quantile_trim=0.0).faces)


@pytest.mark.parametrize("depth", [5, 6])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_slab_solve_matches_one_member(depth, k):
    """The slab solve against the one-member solve (the plain call): CG
    iterations within 1, χ and iso within 1e-5·max|χ|, the density bit
    for bit, faces within 0.5%; a second run bit-equal to the first; a
    warm start from ``x0`` (the solve of a subset of the cloud, as the
    streaming previewer threads its last grid through) within the same
    bounds of the one-member warm start."""
    pts, nrm = _sphere()
    members = HOST[:k]

    def close(got, it, ref, it_ref):
        scale = float(ref.chi.abs().max())
        assert abs(it - it_ref) <= 1
        assert float((got.chi - ref.chi).abs().max()) <= 1e-5 * scale
        assert abs(float(got.iso) - float(ref.iso)) <= 1e-5 * scale
        assert torch.equal(_bits(got.density), _bits(ref.density))
        assert torch.equal(got.origin, ref.origin)
        assert torch.equal(got.scale, ref.scale)

    ref, it_ref = poisson.reconstruct(pts, nrm, depth=depth,
                                      return_iters=True)
    got, it = poisson.reconstruct(pts, nrm, depth=depth, return_iters=True,
                                  members=members)
    close(got, it, ref, it_ref)
    n_ref = _faces(ref)
    assert n_ref > 500
    assert abs(_faces(got) - n_ref) <= 0.005 * n_ref
    again, it2 = poisson.reconstruct(pts, nrm, depth=depth,
                                     return_iters=True, members=members)
    assert it2 == it
    for a, b in zip(again, got):
        assert torch.equal(_bits(a) if a.is_floating_point() else a,
                           _bits(b) if b.is_floating_point() else b)
    x0 = poisson.reconstruct(pts[::3], nrm[::3], depth=depth).chi
    warm_ref, wit_ref = poisson.reconstruct(pts, nrm, depth=depth, x0=x0,
                                            return_iters=True)
    warm, wit = poisson.reconstruct(pts, nrm, depth=depth, x0=x0,
                                    return_iters=True, members=members)
    assert wit_ref < it_ref
    close(warm, wit, warm_ref, wit_ref)


@pytest.mark.parametrize("member", [torch.device("cuda", 99),
                                    torch.device("meta")],
                         ids=["missing", "copy-fails"])
def test_slab_solve_raises_for_a_member_it_cannot_reach(member):
    """No fallback: a member whose device is missing (no such card; here,
    no CUDA at all) or whose results cannot be copied back (a meta
    tensor holds no data) fails the solve, which never quietly runs on
    one device."""
    pts, nrm = _sphere(500, 2)
    with pytest.raises((AssertionError, RuntimeError)):
        poisson.reconstruct(pts, nrm, depth=4, members=[HOST[0], member])
