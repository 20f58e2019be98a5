"""Block-sparse screened-Poisson solve at depth 9-16 (counterpart of the JAX
``ops/poisson_sparse.py``).

1. **Coarse solve**: the dense screened Poisson of :mod:`.poisson` at
   ``min(depth, coarse_depth)`` gives the field far from the surface.
2. **Active band**: the 8³ voxel blocks within one block of any sample,
   found by sort-unique of the occupied block keys and of their
   27-dilation, compacted into ``max_blocks`` slots. A block key is one
   int64, 13 bits an axis, at every depth: it orders blocks as the JAX
   package's int32 pack does through depth 13 and as its (hi, lo) pair
   ``lexsort`` does at depths 14-16, so slots and neighbour tables are
   the JAX package's at every depth.
3. **Fine solve**: splat, divergence and the screened-Laplacian CG run only
   on the band, stored as flat (M, 512) bricks. Cross-block stencil halos
   come from the (M, 6) neighbour table; at the band's edge the halo is a
   Dirichlet condition prolonged from the coarse solution and folded into
   the right-hand side once. The coarse solution also seeds the CG.
4. The iso level is gathered from the bricks at the samples.

The fine CG's operator is :func:`.poisson_matvec.matvec_band` — the CUDA
kernel ``csrc/matvec.cu`` on the card — once for r₀, once per iteration
and, inside the preconditioner, twice per application for ``"vcycle"`` and
three times (degree 4) for ``"chebyshev"``. The preconditioners are the
JAX package's four: ``"additive"`` (default: scaled Jacobi plus a
band-masked coarse correction through the separable restriction and
prolongation of :func:`_prolong_band`), ``"vcycle"`` (Jacobi smoothing
around that coarse correction), ``"chebyshev"`` (a Chebyshev polynomial of
the Jacobi-scaled operator) under the flexible (Polak-Ribière) beta, and
``"jacobi"``, the oracle. ``fine_dtype="bfloat16"`` demotes the
preconditioner's relaxation terms to bf16, rounded op by op; matvecs,
residuals and dot products stay float32. Every scheme stops on the JAX
package's rule, read on the host once per iteration, so the iteration
counts match.

``x0`` warm-starts the solve from a previous grid: a dense preview grid
seeds the internal coarse solve (resampled world-aligned), a previous
band-sparse grid seeds the matching band blocks (:func:`_warm_start_seed`).
"""

from __future__ import annotations

import functools
import logging
from typing import NamedTuple

import numpy as np
import torch

from . import poisson as dense_poisson
from .poisson import vdot
from ._scatter import ScatterPlan, scatter_sum
from .poisson_matvec import matvec_band
from .._device import div, resolve_device, stage_clock

log = logging.getLogger(__name__)

BS = 8                       # voxels per block edge
_V = BS ** 3
_KEY_BITS = 13               # per-axis bits of the int64 block key
_KEY_MAX = (1 << _KEY_BITS) - 1
_BIG = 1 << (3 * _KEY_BITS)  # sentinel key: sorts after every real block

# The preconditioners' constants, per scheme: the JAX package's defaults.
# ω weights the Jacobi branch against the coarse one (additive) or damps
# the Jacobi smoother (vcycle, must stay < 1); the coarse PCG runs a fixed
# count; the Chebyshev polynomial has degree 4 (3 fine matvecs an
# application) over the Jacobi-scaled spectrum bounds.
_SMOOTH_OMEGA = {"additive": 2.0, "vcycle": 0.8}
_PRECOND_COARSE_ITERS = {"additive": 4, "vcycle": 8}
_CHEBY_DEGREE, _CHEBY_LMIN, _CHEBY_LMAX = 4, 0.06, 2.0


class SparsePoissonGrid(NamedTuple):
    """Band-sparse solve result; extraction input for ``extract_sparse``.
    Brick fields are flat (M, 512)."""

    chi: torch.Tensor           # (M, 512) float32
    density: torch.Tensor       # (M, 512) float32 splat density
    block_coords: torch.Tensor  # (M, 3) int32 (padding rows nb_axis + 1)
    block_valid: torch.Tensor   # (M,) bool
    iso: torch.Tensor           # () float32
    origin: torch.Tensor        # (3,) world position of voxel (0,0,0)
    scale: torch.Tensor         # () world size of one fine voxel
    resolution: int             # fine voxels per axis
    # Face-neighbour slots (M, 6) int32, columns +x,-x,+y,-y,+z,-z, M for
    # absent; the device extractor assembles corner frames from it.
    nbr: torch.Tensor | None = None


class PoissonParams(NamedTuple):
    """Knob set for :func:`reconstruct_sparse`, with the JAX package's
    fields and defaults.

    ``preconditioner``: ``"additive"`` (default; ω·D⁻¹r plus a band-masked
    coarse correction of the same residual, no fine matvec inside),
    ``"vcycle"`` (damped-Jacobi pre- and post-smoothing around that coarse
    correction, 2 fine matvecs an application), ``"chebyshev"`` (a degree-4
    Chebyshev polynomial of the Jacobi-scaled operator, 3 fine matvecs an
    application, no coarse traffic) or ``"jacobi"`` (the oracle).
    ``fine_dtype="bfloat16"`` runs the preconditioner's relaxation terms in
    bf16 under the three preconditioned schemes; ``"jacobi"`` has none and
    rejects it.

    ``smooth_omega``, ``precond_coarse_iters``, ``cheby_degree``,
    ``cheby_lmin`` and ``cheby_lmax`` keep the JAX package's fields so its
    parameter sets construct here, but accept only their defaults: each
    scheme runs with the constants those defaults select
    (``_SMOOTH_OMEGA``, ``_PRECOND_COARSE_ITERS``, ``_CHEBY_*``), and
    :func:`reconstruct_sparse` refuses another value."""

    depth: int = 10
    cg_iters: int = 200
    screen: float = 4.0
    max_blocks: int = 131_072
    # None = depth-aware default min(8, max(7, depth - 7)): the coarse/fine
    # ratio stays ≤ 128 through depth 15; depth 16 runs at 256 and warns.
    coarse_depth: int | None = None
    coarse_iters: int = 300
    rtol: float = 3e-4
    preconditioner: str = "additive"
    smooth_omega: float | None = None
    precond_coarse_iters: int | None = None
    cheby_degree: int = 4
    cheby_lmin: float = 0.06
    cheby_lmax: float = 2.0
    fine_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Block keys
# ---------------------------------------------------------------------------


def _pack(bc: torch.Tensor) -> torch.Tensor:
    """(..., 3) block coords (in range) → int64 key ``x<<26 | y<<13 | z``:
    ascending keys are (x, y, z) in lexicographic order."""
    bc = bc.to(torch.int64)
    return ((bc[..., 0] << (2 * _KEY_BITS)) | (bc[..., 1] << _KEY_BITS)
            | bc[..., 2])


def _unpack(key: torch.Tensor) -> torch.Tensor:
    """int64 keys → (..., 3) int32 block coords."""
    return torch.stack([key >> (2 * _KEY_BITS), (key >> _KEY_BITS) & _KEY_MAX,
                        key & _KEY_MAX], -1).to(torch.int32)


def _rank_lookup1(table: torch.Tensor, q: torch.Tensor):
    """Sorted key table (ascending, ``_BIG`` padding last) → (slot, found)
    for each query: the count c of table entries ≤ q gives slot c − 1 —
    the JAX package's sort-merge rank, here as one ``searchsorted``."""
    m = table.shape[0]
    c = torch.searchsorted(table, q.contiguous(), right=True)
    slot = (c - 1).clamp(0, m - 1)
    return slot, (c > 0) & (table[slot] == q)


def _sorted_unique(keys: torch.Tensor):
    """Ascending sort + first-occurrence mask."""
    s = torch.sort(keys).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return s, first


def _scatter_table(keys_s: torch.Tensor, first: torch.Tensor,
                   max_entries: int):
    """Compact sorted-unique keys into ``max_entries`` ascending slots
    (``_BIG`` past the real count; the row past the end takes overflow and
    is cut off). Returns (table, n_unique)."""
    new = first & (keys_s < _BIG)
    rank = torch.cumsum(new.to(torch.int64), 0) - 1
    slot = torch.where(new & (rank < max_entries), rank, max_entries)
    big = torch.full((), _BIG, dtype=keys_s.dtype, device=keys_s.device)
    table = torch.full((max_entries + 1,), _BIG, dtype=keys_s.dtype,
                       device=keys_s.device)
    table.scatter_(0, slot, torch.where(new, keys_s, big))
    return table[:max_entries], new.sum()


# ---------------------------------------------------------------------------
# Flat-space stencils on (M, 512) bricks, idx = (ix·8 + iy)·8 + iz: in-brick
# neighbours are rolls by ±64, ±8, ±1 under boundary masks; cross-brick
# faces come from the neighbour brick's opposite face.
# ---------------------------------------------------------------------------

_FLAT_IDX = np.arange(_V)
_FIZ = _FLAT_IDX % BS
_FIY = (_FLAT_IDX // BS) % BS
_FIX = _FLAT_IDX // (BS * BS)

# Direction order matches the neighbour-table columns: +x,-x,+y,-y,+z,-z.
# Each entry: (flat delta, interior mask (512,) f32, face positions (64,),
# neighbour-source index at those positions (64,), Dirichlet face-map index
# at those positions (64,)).
_DIRS = []
for _coord, _stride in ((_FIX, BS * BS), (_FIY, BS), (_FIZ, 1)):
    for _sign in (+1, -1):
        _interior = (_coord < BS - 1) if _sign > 0 else (_coord > 0)
        _src = _FLAT_IDX - _sign * _stride * (BS - 1)
        _others = [c for c in (_FIX, _FIY, _FIZ) if c is not _coord]
        _face_map = _others[0] * BS + _others[1]
        _pos = np.where(~_interior)[0]
        _DIRS.append((_sign * _stride, _interior.astype(np.float32), _pos,
                      _src[_pos], _face_map[_pos]))

# The halo a direction-d neighbour supplies is ITS face on the opposite side,
# in the same (a, b) order.
_OPP = [1, 0, 3, 2, 5, 4]
for _d in range(6):
    assert np.array_equal(_DIRS[_d][3], _DIRS[_OPP[_d]][2]), _d
# Face positions of all six directions, concatenated: the face extraction.
_FACES_ALL = np.concatenate([_DIRS[_d][2] for _d in range(6)])


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """The direction tables as tensors on ``device`` (built once per
    device; never written to)."""
    out = []
    for delta, interior, pos, _src, fmap in _DIRS:
        out.append((delta, torch.from_numpy(interior).to(device),
                    torch.from_numpy(pos).to(device),
                    torch.from_numpy(fmap).to(device)))
    return out, torch.from_numpy(_FACES_ALL).to(device)


def _faces(x: torch.Tensor, faces_all: torch.Tensor) -> torch.Tensor:
    """(M, 512) → (M + 1, 6, 64): every brick's six faces plus a zero row
    that absent neighbours (slot M) read."""
    m = x.shape[0]
    f = x[:, faces_all].reshape(m, 6, BS * BS)
    return torch.cat([f, f.new_zeros((1, 6, BS * BS))])


def _placed(x: torch.Tensor, pos: torch.Tensor,
            halo: torch.Tensor) -> torch.Tensor:
    """Zeros (M, 512) with ``halo`` (M, 64) at the face positions — the
    one-hot placement matmul of the JAX package, by index (exact)."""
    out = torch.zeros_like(x)
    out[:, pos] = halo
    return out


def _neighbor_sum(x: torch.Tensor, nbr: torch.Tensor,
                  dirichlet: torch.Tensor | None = None) -> torch.Tensor:
    """Σ over the six neighbours of each voxel, flat (M, 512) in and out;
    ``nbr`` (M, 6) int64 with M for absent. ``dirichlet`` (M, 6, 64)
    supplies the values past absent faces (None → zero)."""
    m = x.shape[0]
    dirs, faces_all = _consts(x.device)
    fpad = _faces(x, faces_all)
    acc = torch.zeros_like(x)
    for d, (delta, interior, pos, fmap) in enumerate(dirs):
        acc = acc + torch.roll(x, -delta, 1) * interior
        halo = fpad[:, _OPP[d], :][nbr[:, d]]
        if dirichlet is not None:
            have = (nbr[:, d] < m)[:, None]
            halo = torch.where(have, halo, dirichlet[:, d][:, fmap])
        acc = acc + _placed(x, pos, halo)
    return acc


def _lap_band_flat(x: torch.Tensor, nbr: torch.Tensor,
                   dirichlet: torch.Tensor | None = None) -> torch.Tensor:
    return _neighbor_sum(x, nbr, dirichlet) - 6.0 * x


def _div_band_flat(Vflat: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """Central-difference divergence of ``Vflat`` (M, 512, 3), zero
    Dirichlet (the splat support never reaches the band's edge)."""
    m = Vflat.shape[0]
    dirs, faces_all = _consts(Vflat.device)
    out = torch.zeros((m, _V), dtype=torch.float32, device=Vflat.device)
    for ax in range(3):
        x = Vflat[..., ax].contiguous()
        fpad = _faces(x, faces_all)
        for sign, d in ((+0.5, 2 * ax), (-0.5, 2 * ax + 1)):
            delta, interior, pos, _ = dirs[d]
            out = out + sign * (torch.roll(x, -delta, 1) * interior)
            halo = fpad[:, _OPP[d], :][nbr[:, d]]
            out = out + sign * _placed(x, pos, halo)
    return out


# ---------------------------------------------------------------------------
# Band set-up: keys, neighbour table, splat, divergence, screen
# ---------------------------------------------------------------------------


_UNITS = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
          [0, 0, -1]]
_OFFS27 = [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]


def _setup_sparse(points, normals, valid, resolution: int, max_blocks: int,
                  screen):
    """Active band, neighbour table and the splatted right-hand side.

    Returns (rhs, W, nbr (M,6) int32, block_valid, block_coords, density,
    flat, w, cfound, origin, scale, n_blocks) — n_blocks is the true band
    size (0-d tensor), larger than ``max_blocks`` when the budget
    overflows."""
    R = resolution
    nb_axis = R // BS
    n = points.shape[0]
    dev = points.device
    big = torch.full((), _BIG, dtype=torch.int64, device=dev)
    grid_pts, origin, scale = dense_poisson.normalize_points(points, valid, R)

    # Occupied blocks (one sort of N), then their 27-dilation (one sort of
    # 27·M_occ).
    pblock = torch.floor(div(grid_pts, float(BS))).to(torch.int32).clamp(
        0, nb_axis - 1)
    okey = torch.where(valid, _pack(pblock), big)
    occ, n_occ = _scatter_table(*_sorted_unique(okey), max_blocks)
    occ_coords = _unpack(occ)
    occ_ok = occ < _BIG
    offs = torch.tensor(_OFFS27, dtype=torch.int32, device=dev)
    cand = occ_coords[:, None, :] + offs[None]
    in_rng = ((cand >= 0) & (cand < nb_axis)).all(-1)
    dkey = torch.where(in_rng & occ_ok[:, None],
                       _pack(cand.clamp(0, nb_axis - 1)), big).reshape(-1)
    table, n_dil = _scatter_table(*_sorted_unique(dkey), max_blocks)
    n_blocks = torch.where(n_occ > max_blocks, n_occ, n_dil)
    del occ, occ_coords, cand, dkey
    block_valid = table < _BIG
    block_coords = torch.where(block_valid[:, None], _unpack(table),
                               torch.full((), nb_axis + 1, dtype=torch.int32,
                                          device=dev))
    m = max_blocks

    # Neighbour table (M, 6): slots of the ±x/±y/±z blocks (M = absent).
    units = torch.tensor(_UNITS, dtype=torch.int32, device=dev)
    nb_coords = block_coords[:, None, :] + units[None]
    nb_ok = ((nb_coords >= 0) & (nb_coords < nb_axis)).all(-1)
    nb_slot, nb_found = _rank_lookup1(
        table, _pack(nb_coords.clamp(0, nb_axis - 1)))
    nbr = torch.where(nb_ok & nb_found & block_valid[:, None], nb_slot,
                      m).to(torch.int32)

    # Sparse trilinear splat of [normals, 1] into the bricks.
    g = grid_pts.clamp(0.0, R - 1 - 1e-4)
    i0 = torch.floor(g).to(torch.int64)
    f = g - i0.to(torch.float32)
    corners = torch.tensor(dense_poisson._CORNER_OFFS, dtype=torch.int64,
                           device=dev)
    vidx = (i0[:, None, :] + corners[None]).clamp(0, R - 1)   # (N, 8, 3)
    cb = vidx // BS
    intra = vidx - cb * BS
    cslot, cfound = _rank_lookup1(table, _pack(cb))
    cf = corners[None].to(torch.float32)
    t = cf * f[:, None, :] + (1 - cf) * (1 - f[:, None, :])
    w = t[..., 0] * t[..., 1] * t[..., 2]
    w = w * (valid[:, None] & cfound).to(torch.float32)
    flat = (cslot * _V + (intra[..., 0] * BS + intra[..., 1]) * BS
            + intra[..., 2])
    vals = torch.cat([normals, torch.ones((n, 1), device=dev)], -1)
    contrib = w[..., None] * vals[:, None, :]                  # (N, 8, 4)
    dest = torch.where(cfound, flat, m * _V).reshape(-1)
    acc = scatter_sum(m * _V + 1, dest, contrib.reshape(-1, 4))
    del contrib, dest
    density = acc[:m * _V, 3].reshape(m, _V).contiguous()
    rhs = _div_band_flat(acc[:m * _V, :3].reshape(m, _V, 3), nbr.long())
    del acc
    W = dense_poisson.screen_weights(density, screen)
    return (rhs, W, nbr, block_valid, block_coords, density, flat, w, cfound,
            origin, scale, n_blocks)


# ---------------------------------------------------------------------------
# Coarse ↔ band transfer: separable trilinear interpolation
# ---------------------------------------------------------------------------

_E = 10  # extended positions per axis: voxels 0..7 plus the two halos


def _extended_index_maps():
    """Index maps from the (10,10,10) extended-block cube into the flat
    brick (512,) and the (6, 64) Dirichlet face layout."""
    vx, vy, vz = np.meshgrid(np.arange(BS), np.arange(BS), np.arange(BS),
                             indexing="ij")
    interior = (((vx + 1) * _E + (vy + 1)) * _E + (vz + 1)).reshape(-1)
    faces = []
    a, b = np.meshgrid(np.arange(BS), np.arange(BS), indexing="ij")
    af, bf = (a + 1).reshape(-1), (b + 1).reshape(-1)
    for d in range(6):
        ax = d // 2
        wall = _E - 1 if d % 2 == 0 else 0
        e = [None, None, None]
        e[ax] = np.full(BS * BS, wall)
        others = [i for i in range(3) if i != ax]
        e[others[0]], e[others[1]] = af, bf
        faces.append((e[0] * _E + e[1]) * _E + e[2])
    return interior.astype(np.int64), np.concatenate(faces).astype(np.int64)


_INTERIOR_IDX, _FACE_IDX = _extended_index_maps()


def _coarse_ratio_width(resolution: int, coarse_resolution: int):
    """(cr, W): fine→coarse coordinate ratio and the coarse neighbourhood
    width covering one block's footprint."""
    cr = (coarse_resolution - 1.0) / (resolution - 1.0)
    return cr, int(np.floor(9.0 * cr + 1.0)) + 2


def _sep_weights(bcc: torch.Tensor, e: torch.Tensor, cr: float, Rc: int,
                 W: int):
    """Separable per-axis interpolation data for blocks ``bcc`` (C, 3) at
    per-axis fine offsets ``e`` (E,): every position interpolates the
    coarse field at ``t = clip(fine_coord · cr)``. Returns (wgt (C, 3, E, W),
    flat_idx (C, W, W, W) int64 into the flat coarse grid)."""
    dev = bcc.device
    iota = torch.arange(W, dtype=torch.int64, device=dev)
    g = bcc[:, :, None].to(torch.float32) * BS + e[None, None, :]
    t = (g * cr).clamp(0.0, Rc - 1 - 1e-4)                    # (C, 3, E)
    c0 = torch.floor(t[:, :, 0]).to(torch.int64).clamp(0, Rc - W)
    tl = t - c0[:, :, None].to(torch.float32)
    i0 = torch.floor(tl).to(torch.int64).clamp(0, W - 2)
    f = tl - i0.to(torch.float32)
    zero = torch.zeros((), device=dev)
    wgt = (torch.where(iota == i0[..., None], 1.0 - f[..., None], zero)
           + torch.where(iota == i0[..., None] + 1, f[..., None], zero))
    ix = (c0[:, 0, None] + iota).clamp(0, Rc - 1)
    iy = (c0[:, 1, None] + iota).clamp(0, Rc - 1)
    iz = (c0[:, 2, None] + iota).clamp(0, Rc - 1)
    flat_idx = ((ix[:, :, None, None] * Rc + iy[:, None, :, None]) * Rc
                + iz[:, None, None, :])
    return wgt, flat_idx


def _interp3(wgt: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """E[c,x,y,z] = Σ_ijk wx[c,x,i]·wy[c,y,j]·wz[c,z,k]·G[c,i,j,k], one axis
    at a time (float32 batched products; TF32 stays off)."""
    t = torch.einsum("czk,cijk->cijz", wgt[:, 2], G)
    t = torch.einsum("cyj,cijz->ciyz", wgt[:, 1], t)
    return torch.einsum("cxi,ciyz->cxyz", wgt[:, 0], t)


def _interp3_t(wgt: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
    """The transpose of :func:`_interp3`: G[c,i,j,k] =
    Σ_xyz wx[c,x,i]·wy[c,y,j]·wz[c,z,k]·r3[c,x,y,z]."""
    t = torch.einsum("cxi,cxyz->ciyz", wgt[:, 0], r3)
    t = torch.einsum("cyj,ciyz->cijz", wgt[:, 1], t)
    return torch.einsum("czk,cijz->cijk", wgt[:, 2], t)


def _restrict(rf: torch.Tensor, wgt: torch.Tensor, plan: ScatterPlan,
              crf: torch.Tensor) -> torch.Tensor:
    """Band residual (M, 512) → coarse grid (Rc³,): Pᵀ·cr, summed into
    the coarse cells through ``plan`` (the destinations of
    :func:`_sep_weights`' ``flat_idx``, fixed for a whole solve)."""
    G = _interp3_t(wgt, rf.reshape(-1, BS, BS, BS))
    return plan.sum(G.reshape(-1) * crf)


def _prolong_band(coarse_chi, rhs, nbr, block_valid, block_coords,
                  resolution: int, coarse_resolution: int,
                  chunk: int = 8192):
    """Prolong the coarse solution onto the band: the CG seed ``x0`` and
    the Dirichlet-halo-folded right-hand side ``b``. Returns (b, x0)."""
    R, Rc = resolution, coarse_resolution
    cr, Wn = _coarse_ratio_width(R, Rc)
    m = block_coords.shape[0]
    dev = rhs.device
    coarse_flat = coarse_chi.reshape(-1)
    e = torch.arange(_E, dtype=torch.float32, device=dev) - 1.0
    interior_idx = torch.from_numpy(_INTERIOR_IDX).to(dev)
    face_idx = torch.from_numpy(_FACE_IDX).to(dev)
    x0 = torch.empty((m, _V), dtype=torch.float32, device=dev)
    dir_chi = torch.empty((m, 6, BS * BS), dtype=torch.float32, device=dev)
    for s in range(0, m, chunk):
        bcc = block_coords[s:s + chunk]
        c = bcc.shape[0]
        wgt, flat_idx = _sep_weights(bcc, e, cr, Rc, Wn)
        G = coarse_flat[flat_idx.reshape(c, -1)].reshape(c, Wn, Wn, Wn)
        ef = _interp3(wgt, G).reshape(c, _E ** 3)
        x0[s:s + c] = ef[:, interior_idx]
        dir_chi[s:s + c] = ef[:, face_idx].reshape(c, 6, BS * BS)
    band = block_valid[:, None]
    zero = torch.zeros((), device=dev)
    x0 = torch.where(band, x0, zero)
    dir_chi = torch.where(block_valid[:, None, None], dir_chi, zero)
    # Fold the constant Dirichlet halo into the RHS once:
    #   A(x; halo) = A0(x) + L_halo  ⇒  solve A0 x = b − L_halo.
    halo_term = _lap_band_flat(torch.zeros_like(x0), nbr.long(),
                               dirichlet=dir_chi)
    b = torch.where(band, -(rhs - halo_term), zero)
    return b, x0


# ---------------------------------------------------------------------------
# Fine-band CG
# ---------------------------------------------------------------------------


def _cg_sparse(b, W, x0, nbr, block_valid, cg_iters: int,
               rtol: float = 3e-4):
    """Jacobi-preconditioned CG (the oracle). ``cg_iters`` caps the loop;
    the residual stop ‖r‖ ≤ rtol·‖b‖ usually ends it sooner. Returns
    (chi, iterations used)."""
    band = block_valid[:, None]
    zero = torch.zeros((), device=b.device)
    dinv = torch.where(band, 1.0 / (6.0 + W), zero)

    def matvec(xf):
        return matvec_band(xf, W, nbr, block_valid)

    x = x0
    r = b - matvec(x)
    p = dinv * r
    rz = vdot(r, p)
    rt = torch.tensor(rtol, dtype=torch.float32, device=b.device)
    tol2 = rt * rt * vdot(b, b)
    rs = vdot(r, r)
    it = 0
    while it < cg_iters and bool(rs > tol2):
        Ap = matvec(p)
        alpha = rz / vdot(p, Ap).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = vdot(r, z)
        beta = rz_new / rz.clamp_min(1e-30)
        p = z + beta * p
        rz, rs, it = rz_new, vdot(r, r), it + 1
    return torch.where(band, x, zero), it


def _pcg_sparse(b, W, x0, nbr, block_valid, block_coords, coarse_W,
                resolution: int, coarse_resolution: int, cg_iters: int,
                rtol: float = 3e-4, precond: str = "additive",
                fine_dtype: str = "float32"):
    """Flexible PCG with a two-level (additive or V-cycle) or Chebyshev
    preconditioner; the outer loop uses the Polak-Ribière beta, which
    absorbs a preconditioner that is not exactly linear. Returns (chi,
    iterations).

    * ``"additive"``: ``M⁻¹r = ω·D⁻¹r + P·Mc⁻¹·Pᵀ·r`` — the Jacobi term and
      a coarse correction of the same residual, summed; no fine matvec
      inside the preconditioner.
    * ``"vcycle"``: a damped-Jacobi pre-smooth from zero, the coarse
      correction of what it leaves, a post-smooth; 2 fine matvecs.

      Both coarse corrections are a fixed-iteration Jacobi-PCG on the dense
      coarse grid, masked to the band's footprint, with the restriction
      scaled by ``cr = h_f/h_c`` and the coarse screen by ``ratio²``.
    * ``"chebyshev"``: the three-term Chebyshev recurrence of degree
      ``_CHEBY_DEGREE`` on the Jacobi-scaled operator over ``[_CHEBY_LMIN,
      _CHEBY_LMAX]``; ``_CHEBY_DEGREE − 1`` fine matvecs, no coarse
      traffic.

    ω and the coarse PCG's iterations are the scheme's (``_SMOOTH_OMEGA``,
    ``_PRECOND_COARSE_ITERS``).

    ``fine_dtype="bfloat16"`` rounds the relaxation terms (the scaled
    Jacobi branch, the smoothing steps, the Chebyshev state) to bf16 op by
    op; the matvec, residuals, dot products and ``x`` stay float32."""
    R, Rc = resolution, coarse_resolution
    dev = b.device
    band = block_valid[:, None]
    zero = torch.zeros((), device=dev)
    dinv = torch.where(band, 1.0 / (6.0 + W), zero)
    cdt = torch.bfloat16 if fine_dtype == "bfloat16" else torch.float32
    dinv_l = dinv.to(cdt)
    m = block_coords.shape[0]

    def matvec(xf):
        return matvec_band(xf, W, nbr, block_valid)

    def relax(v) -> float:
        """A float32 scalar rounded to the relaxation dtype, as a Python
        float: exact in that dtype, and a scalar operand keeps PyTorch's
        vectorized elementwise kernels (a 0-d device tensor broadcasts)."""
        return float(torch.tensor(np.float32(v), dtype=cdt))

    if precond == "chebyshev":
        # The recurrence's scalars do not depend on the data: float32, as
        # the JAX package computes them from its float32 bounds.
        f32 = np.float32
        lo, hi = f32(_CHEBY_LMIN), f32(_CHEBY_LMAX)
        theta, delta = f32(0.5) * (hi + lo), f32(0.5) * (hi - lo)
        steps, rho_o = [], delta / theta
        for _ in range(_CHEBY_DEGREE - 1):
            rho = f32(1.0) / (f32(2.0) * theta / delta - rho_o)
            steps.append((relax(rho), relax(rho_o)))
            rho_o = rho
        inv_theta, two_delta = relax(f32(1.0) / theta), relax(f32(2.0) / delta)

        def apply_M(r):
            rl = r.to(cdt)
            z = inv_theta * dinv_l * rl
            z_prev = torch.zeros_like(z)
            for rho, rho_o in steps:
                resid = dinv_l * (rl - matvec(z.float()).to(cdt))
                z_prev, z = z, z + rho * (two_delta * resid
                                          + rho_o * (z - z_prev))
            return torch.where(band, z.float(), zero)

    else:
        om_l = relax(_SMOOTH_OMEGA[precond])
        # Separable transfer data for the 8 interior positions of every
        # block, computed once per solve.
        cr, Wn = _coarse_ratio_width(R, Rc)
        crf = torch.tensor(cr, dtype=torch.float32, device=dev)
        e_int = torch.arange(BS, dtype=torch.float32, device=dev)
        wgt, flat_idx = _sep_weights(block_coords, e_int, cr, Rc, Wn)
        flat_idx = flat_idx.reshape(-1)
        ratio2 = torch.tensor(((R - 1.0) / (Rc - 1.0)) ** 2,
                              dtype=torch.float32, device=dev)
        Wc = coarse_W * ratio2
        dinv_c = 1.0 / (6.0 + Wc)

        plan = ScatterPlan(flat_idx, Rc ** 3)   # sorted once, used every step

        def restrict(rf):
            return _restrict(rf, wgt, plan, crf)

        def prolong(ec_flat):
            """Coarse correction (Rc³,) → band interiors (M, 512)."""
            G = ec_flat[flat_idx].reshape(m, Wn, Wn, Wn)
            return _interp3(wgt, G).reshape(m, _V)

        # Band footprint on the coarse grid (cells a band field restricts
        # to): the coarse PCG is fixed to it, zero-Dirichlet outside.
        cmask = (restrict(band.to(torch.float32).expand(m, _V)) > 0.0).to(
            torch.float32).reshape(Rc, Rc, Rc)

        def matvec_c(xc):
            return cmask * -(dense_poisson.laplacian(xc) - Wc * xc)

        def coarse_solve(rc):
            r = cmask * rc.reshape(Rc, Rc, Rc)
            x = torch.zeros_like(r)
            z = dinv_c * r
            p = z
            rz = vdot(r, z)
            for _ in range(_PRECOND_COARSE_ITERS[precond]):
                Ap = matvec_c(p)
                alpha = rz / vdot(p, Ap).clamp_min(1e-30)
                x = x + alpha * p
                r = r - alpha * Ap
                z = dinv_c * r
                rz_new = vdot(r, z)
                beta = rz_new / rz.clamp_min(1e-30)
                p = z + beta * p
                rz = rz_new
            return (cmask * x).reshape(-1)

        def smooth(r):
            """ω·D⁻¹r, rounded in the relaxation dtype, back in float32."""
            return (om_l * dinv_l * r.to(cdt)).float()

        if precond == "additive":
            def apply_M(r):
                ec = coarse_solve(restrict(r))
                z = smooth(r) + torch.where(band, prolong(ec), zero)
                return torch.where(band, z, zero)
        else:
            def apply_M(r):
                z = smooth(r)
                ec = coarse_solve(restrict(r - matvec(z)))
                z = z + torch.where(band, prolong(ec), zero)
                z = z + smooth(r - matvec(z))
                return torch.where(band, z, zero)

    x = x0
    r = b - matvec(x)
    z = apply_M(r)
    p = z
    rz = vdot(r, z)
    rt = torch.tensor(rtol, dtype=torch.float32, device=dev)
    tol2 = rt * rt * vdot(b, b)
    rs = vdot(r, r)
    it = 0
    while it < cg_iters and bool(rs > tol2):
        Ap = matvec(p)
        alpha = rz / vdot(p, Ap).clamp_min(1e-30)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = apply_M(r_new)
        rz_new = vdot(r_new, z_new)
        # Polak-Ribière (flexible) beta.
        beta = (rz_new - vdot(r_new, z)) / rz.clamp_min(1e-30)
        p = z_new + beta * p
        r, z, rz, rs, it = r_new, z_new, rz_new, vdot(r_new, r_new), it + 1
    return torch.where(band, x, zero), it


def _iso_sparse(chi, density, flat, w, cfound, valid):
    """Density-weighted mean of chi at the samples (8 trilinear corners per
    sample, gathered from the bricks)."""
    ok8 = cfound & valid[:, None]
    zero = torch.zeros((), device=chi.device)
    chi_pts = (torch.where(ok8, chi.reshape(-1)[flat], zero) * w).sum(1)
    den_pts = (torch.where(ok8, density.reshape(-1)[flat], zero) * w).sum(1)
    return (chi_pts * den_pts).sum() / den_pts.sum().clamp_min(1e-12)


def _resample_chi_to_coarse(prev: dense_poisson.PoissonGrid, points, valid,
                            rc: int, slabs: int = 16) -> torch.Tensor:
    """Trilinear resample of a DENSE preview χ grid onto this solve's
    internal coarse frame (world-aligned through each grid's own origin and
    scale); zero outside the preview's domain. ``slabs`` x-planes at a
    time, so the 256³ coarse case never holds the whole gather."""
    dev = points.device
    prev_chi = prev.chi.to(device=dev, dtype=torch.float32)
    prev_origin = prev.origin.to(device=dev, dtype=torch.float32)
    prev_scale = prev.scale.to(device=dev, dtype=torch.float32)
    rp = prev_chi.shape[0]
    _, origin_c, scale_c = dense_poisson.normalize_points(points, valid, rc)
    v = torch.arange(rc, dtype=torch.float32, device=dev)
    Y, Z = torch.meshgrid(v, v, indexing="ij")
    zero = torch.zeros((), device=dev)
    out = torch.empty((rc, rc, rc), dtype=torch.float32, device=dev)
    for x0 in range(0, rc, slabs):
        xs = v[x0:x0 + slabs]
        k = xs.shape[0]
        grid = torch.stack([xs[:, None, None].expand(k, rc, rc),
                            Y.expand(k, rc, rc), Z.expand(k, rc, rc)], -1)
        world = origin_c + grid * scale_c
        q = (world - prev_origin) / prev_scale
        inside = ((q >= 0.0) & (q <= rp - 1.0)).all(-1)
        qc = torch.floor(q).to(torch.int64).clamp(0, rp - 2)
        f = (q - qc.to(torch.float32)).clamp(0.0, 1.0)

        def g(dx, dy, dz):
            return prev_chi[qc[..., 0] + dx, qc[..., 1] + dy,
                            qc[..., 2] + dz]

        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        c00 = g(0, 0, 0) * (1 - fz) + g(0, 0, 1) * fz
        c01 = g(0, 1, 0) * (1 - fz) + g(0, 1, 1) * fz
        c10 = g(1, 0, 0) * (1 - fz) + g(1, 0, 1) * fz
        c11 = g(1, 1, 0) * (1 - fz) + g(1, 1, 1) * fz
        c0 = c00 * (1 - fy) + c01 * fy
        c1 = c10 * (1 - fy) + c11 * fy
        out[x0:x0 + k] = torch.where(inside, c0 * (1 - fx) + c1 * fx, zero)
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dense_cover_blocks(block_coords, block_valid, origin, scale,
                        prev: dense_poisson.PoissonGrid) -> int:
    """How many active band blocks the dense preview grid covers (the
    ``warm_start_blocks`` count of the dense-``x0`` path)."""
    bc = _host(block_coords)[_host(block_valid)]
    if bc.shape[0] == 0:
        return 0
    center = bc.astype(np.float64) * BS + 0.5 * BS
    world = _host(origin).astype(np.float64) + center * float(scale)
    q = (world - _host(prev.origin).astype(np.float64)) / float(prev.scale)
    rp = prev.chi.shape[0]
    return int(np.all((q >= 0.0) & (q <= rp - 1.0), axis=-1).sum())


def _warm_start_seed(seed: torch.Tensor, prev: SparsePoissonGrid,
                     block_coords, block_valid, origin, scale,
                     resolution: int):
    """Overlay a previous band solve's χ onto the new band's CG seed: blocks
    present in both bands (matched by block coordinate, valid only when the
    grid normalization did not move) start from the previous χ. Returns
    ``(seed, matched_block_count)``; 0 means skipped."""
    if prev.resolution != resolution:
        log.info("sparse warm start skipped: previous grid resolution %d "
                 "!= %d", prev.resolution, resolution)
        return seed, 0
    prev_origin = _host(prev.origin).astype(np.float64)
    new_origin = _host(origin).astype(np.float64)
    prev_scale, new_scale = float(prev.scale), float(scale)
    tol = 1e-5 * max(abs(prev_scale), abs(new_scale))
    if abs(prev_scale - new_scale) > tol or not np.allclose(
            prev_origin, new_origin, rtol=0.0, atol=tol * BS):
        log.info("sparse warm start skipped: grid normalization moved")
        return seed, 0
    pi = np.nonzero(_host(prev.block_valid))[0]
    ni = np.nonzero(_host(block_valid))[0]
    if pi.size == 0 or ni.size == 0:
        return seed, 0
    bits = 21

    def pack(bc):
        bc = bc.astype(np.int64)
        return (bc[:, 0] << (2 * bits)) | (bc[:, 1] << bits) | bc[:, 2]

    pk = pack(_host(prev.block_coords)[pi])
    nk = pack(_host(block_coords)[ni])
    order = np.argsort(pk)
    pos = np.minimum(np.searchsorted(pk, nk, sorter=order), pk.size - 1)
    hit = pk[order[pos]] == nk
    if not hit.any():
        return seed, 0
    dev = seed.device
    dst = torch.from_numpy(ni[hit]).to(dev)
    src = torch.from_numpy(pi[order[pos[hit]]]).to(dev)
    seed = seed.clone()
    seed[dst] = prev.chi.to(device=dev, dtype=torch.float32)[src]
    return seed, int(hit.sum())


def _check_jax_only_knobs(params: PoissonParams) -> None:
    """Refuse a non-default value of the JAX package's preconditioner
    fields, which select nothing in the port (see :class:`PoissonParams`)."""
    default = PoissonParams()
    for knob in ("smooth_omega", "precond_coarse_iters", "cheby_degree",
                 "cheby_lmin", "cheby_lmax"):
        if getattr(params, knob) != getattr(default, knob):
            raise ValueError(
                f"{knob}={getattr(params, knob)!r}: the port runs each "
                f"preconditioner with the JAX package's default constants, "
                f"so only the default {getattr(default, knob)!r} is "
                f"accepted")


def reconstruct_sparse(points: torch.Tensor, normals: torch.Tensor,
                       valid: torch.Tensor | None = None,
                       depth: int | None = None,
                       cg_iters: int | None = None,
                       screen: float | None = None,
                       max_blocks: int | None = None,
                       coarse_depth: int | None = None,
                       coarse_iters: int | None = None,
                       rtol: float | None = None,
                       preconditioner: str | None = None,
                       params: PoissonParams | None = None,
                       with_stats: bool = False, x0=None,
                       timing: dict | None = None):
    """Band-sparse screened Poisson at depth 9-16 on the device the points
    lie on, as the reference's octree accepts (default depth 10, > 16
    rejected: `server/processing.py:207-208,293`). Returns
    (SparsePoissonGrid, n_blocks) and, with ``with_stats``, a dict with
    ``cg_iters_used``, ``coarse_iters_used``, ``preconditioner``,
    ``fine_dtype`` and ``warm_start_blocks`` (band blocks ``x0`` seeded or
    covered; 0 = cold).

    Knobs come either as keywords or bundled in ``params`` (the single
    source of defaults, :class:`PoissonParams`), not both. A band larger
    than ``max_blocks`` is detected after set-up and rebuilt with a larger
    budget (1.25× the true size + 1024), at most twice; a retried budget
    above ~8 GB of solver state warns. ``timing``, when given, receives the
    wall seconds of ``setup_s``, ``coarse_s`` (coarse solve and
    prolongation onto the band), ``fine_cg_s`` and ``iso_s``, each measured
    with a device synchronize."""
    given = {k: v for k, v in dict(
        depth=depth, cg_iters=cg_iters, screen=screen,
        max_blocks=max_blocks, coarse_depth=coarse_depth,
        coarse_iters=coarse_iters, rtol=rtol,
        preconditioner=preconditioner).items() if v is not None}
    if params is None:
        params = PoissonParams()._replace(**given)
    elif given:
        raise ValueError(
            "pass solver knobs either as keywords or bundled in params, "
            f"not both (got params plus {sorted(given)})")
    depth, cg_iters, screen = params.depth, params.cg_iters, params.screen
    max_blocks, coarse_depth = params.max_blocks, params.coarse_depth
    coarse_iters, rtol = params.coarse_iters, params.rtol
    preconditioner, fine_dtype = params.preconditioner, params.fine_dtype
    if preconditioner not in ("additive", "vcycle", "chebyshev", "jacobi"):
        raise ValueError(
            f"preconditioner must be 'additive', 'vcycle', 'chebyshev' "
            f"or 'jacobi', got {preconditioner!r}")
    if fine_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"fine_dtype must be 'float32' or 'bfloat16', "
                         f"got {fine_dtype!r}")
    if fine_dtype != "float32" and preconditioner == "jacobi":
        raise ValueError(
            "fine_dtype='bfloat16' rides the preconditioned schemes' "
            "relaxation stage; the 'jacobi' oracle path has none and "
            "stays fp32 bit-for-bit — pick additive/vcycle/chebyshev")
    _check_jax_only_knobs(params)
    if depth > 16:
        raise ValueError(f"depth={depth} > 16: rejected exactly like the "
                         "reference's octree guard "
                         "(server/processing.py:207-208)")
    if 2 ** depth < 4 * BS:
        raise ValueError(f"depth={depth} too shallow for the block solver; "
                         "use ops.poisson.reconstruct")
    if x0 is not None and not isinstance(
            x0, (SparsePoissonGrid, dense_poisson.PoissonGrid)):
        raise TypeError(
            f"x0 must be a SparsePoissonGrid from a previous "
            f"reconstruct_sparse call (or a dense poisson.PoissonGrid "
            f"preview), got {type(x0).__name__}")
    if coarse_depth is None:
        # Depth-aware coarse grid: the coarse/fine ratio stays ≤ 128 (at
        # 256 the Dirichlet halo folded from the coarse field carries the
        # coarse surface's error into the band), capped at 256³.
        coarse_depth = min(8, max(7, depth - 7))
        if coarse_depth > 7:
            log.info("sparse Poisson depth=%d: coarse grid auto-raised "
                     "to %d^3 (coarse/fine ratio cap 128)", depth,
                     2 ** coarse_depth)
        if depth - coarse_depth > 7:
            log.warning(
                "sparse Poisson depth=%d: coarse/fine ratio is %d "
                "(memory-capped at coarse 256³) — surface error can "
                "carry the unresolved-coarse-halo tail the ratio-128 "
                "cap removes at depth ≤ 15; pass an explicit "
                "coarse_depth to trade memory for accuracy", depth,
                2 ** (depth - coarse_depth))
    points = points.to(torch.float32)
    normals = normals.to(torch.float32)
    dev = points.device
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
    clock = stage_clock(dev, timing)
    t0 = clock()
    scr = torch.tensor(screen, dtype=torch.float32, device=dev)
    for attempt in range(3):
        (rhs, W, nbr, block_valid, block_coords, density, flat, w, cfound,
         origin, scale, n_blocks) = _setup_sparse(
            points, normals, valid, 2 ** depth, max_blocks, scr)
        nb_host = int(n_blocks)
        if nb_host <= max_blocks:
            break
        del rhs, W, nbr, block_valid, block_coords, density
        if attempt == 2:
            raise RuntimeError(
                f"sparse Poisson depth={depth}: active blocks ({nb_host}) "
                f"still exceed the budget ({max_blocks}) after retries")
        log.warning(
            "sparse Poisson depth=%d: %d active blocks exceed the budget "
            "of %d — rebuilding the band with a larger budget", depth,
            nb_host, max_blocks)
        max_blocks = int(nb_host * 1.25) + 1024
        est_gb = max_blocks * _V * 4 * 8 / 1e9
        if est_gb > 8.0:
            log.warning(
                "sparse Poisson depth=%d: the retried band needs ~%.1f GB "
                "of solver state (%d blocks) — deep depths on dense "
                "clouds are memory-hungry by nature (the reference's "
                "octree warns the same way at depth > 16); consider a "
                "shallower depth or a downsampled cloud", depth, est_gb,
                max_blocks)
    t1 = clock()

    rc = 2 ** min(coarse_depth, depth)
    dense_x0 = x0 if isinstance(x0, dense_poisson.PoissonGrid) else None
    coarse, coarse_used = dense_poisson._solve(
        points, normals, valid, rc, coarse_iters, screen, rtol,
        x0=None if dense_x0 is None else _resample_chi_to_coarse(
            dense_x0, points, valid, rc))
    b, seed = _prolong_band(coarse.chi, rhs, nbr, block_valid, block_coords,
                            2 ** depth, rc)
    del rhs
    warm_blocks = 0
    if dense_x0 is not None:
        warm_blocks = _dense_cover_blocks(block_coords, block_valid, origin,
                                          scale, dense_x0)
        log.info("sparse Poisson depth=%d: dense preview grid warm-started "
                 "the %d^3 coarse solve (%d/%d iterations, %d band blocks "
                 "covered)", depth, rc, coarse_used, coarse_iters,
                 warm_blocks)
    elif x0 is not None:
        seed, warm_blocks = _warm_start_seed(seed, x0, block_coords,
                                             block_valid, origin, scale,
                                             2 ** depth)
    t2 = clock()
    if preconditioner == "jacobi":
        chi, cg_used = _cg_sparse(b, W, seed, nbr, block_valid, cg_iters,
                                  rtol)
    else:
        coarse_W = dense_poisson.screen_weights(coarse.density, scr)
        chi, cg_used = _pcg_sparse(
            b, W, seed, nbr, block_valid, block_coords, coarse_W, 2 ** depth,
            rc, cg_iters, rtol=rtol, precond=preconditioner,
            fine_dtype=fine_dtype)
    del b, seed, W, coarse
    t3 = clock()
    log.info("sparse Poisson depth=%d: fine CG (%s) stopped after %d/%d "
             "iterations", depth, preconditioner, cg_used, cg_iters)
    iso = _iso_sparse(chi, density, flat, w, cfound, valid)
    grid = SparsePoissonGrid(chi, density, block_coords, block_valid, iso,
                             origin, scale, 2 ** depth, nbr=nbr)
    t4 = clock()
    if timing is not None:
        timing.update(setup_s=t1 - t0, coarse_s=t2 - t1, fine_cg_s=t3 - t2,
                      iso_s=t4 - t3)
    if with_stats:
        return grid, nb_host, {"cg_iters_used": cg_used,
                               "coarse_iters_used": coarse_used,
                               "preconditioner": preconditioner,
                               "fine_dtype": fine_dtype,
                               "warm_start_blocks": warm_blocks}
    return grid, nb_host


def grid_from_numpy(arrays, device=None) -> SparsePoissonGrid:
    """A band-sparse grid carried across as numpy arrays — e.g.
    ``{k: np.asarray(v) for k, v in jax_grid._asdict().items()}`` — on
    ``device``: chi/density float32, block_coords/nbr int32, block_valid
    bool, iso/origin/scale float32, resolution int."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                               device=dev)

    nbr = arrays.get("nbr")
    return SparsePoissonGrid(
        chi=t("chi", torch.float32), density=t("density", torch.float32),
        block_coords=t("block_coords", torch.int32),
        block_valid=t("block_valid", torch.bool),
        iso=t("iso", torch.float32), origin=t("origin", torch.float32),
        scale=t("scale", torch.float32),
        resolution=int(arrays["resolution"]),
        nbr=None if nbr is None else t("nbr", torch.int32))
