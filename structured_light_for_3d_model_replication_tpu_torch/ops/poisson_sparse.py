"""Block-sparse screened-Poisson solve at depth 9-13 (counterpart of the JAX
``ops/poisson_sparse.py``).

1. **Coarse solve**: the dense screened Poisson of :mod:`.poisson` at
   ``min(depth, coarse_depth)`` gives the field far from the surface.
2. **Active band**: the 8³ voxel blocks within one block of any sample,
   found by sort-unique of the occupied block keys and of their
   27-dilation, compacted into ``max_blocks`` slots.
3. **Fine solve**: splat, divergence and the screened-Laplacian CG run only
   on the band, stored as flat (M, 512) bricks. Cross-block stencil halos
   come from the (M, 6) neighbour table; at the band's edge the halo is a
   Dirichlet condition prolonged from the coarse solution and folded into
   the right-hand side once. The coarse solution also seeds the CG.
4. The iso level is gathered from the bricks at the samples.

The fine CG's operator is :func:`.poisson_matvec.matvec_band` — the CUDA
kernel ``csrc/matvec.cu`` on the card — once for r₀ and once per iteration.
The default preconditioner is ``"additive"``: scaled Jacobi plus a
band-masked coarse correction through the separable restriction and
prolongation of :func:`_prolong_band`, with the flexible (Polak-Ribière)
beta; ``"jacobi"`` is the oracle. Both stop on the JAX package's rule,
read on the host once per iteration, so the iteration counts match.

Not ported yet, each raising an error that names where it comes: the
wide-key path (depth 14-16), the ``"vcycle"`` and ``"chebyshev"``
preconditioners and ``fine_dtype="bfloat16"`` (ROADMAP Queue 1 step 9),
and the ``x0`` warm starts (step 5, streaming).
"""

from __future__ import annotations

import functools
import logging
from typing import NamedTuple

import numpy as np
import torch

from . import poisson as dense_poisson
from .poisson import vdot
from .poisson_matvec import matvec_band
from .._device import div, resolve_device, stage_clock

log = logging.getLogger(__name__)

BS = 8                       # voxels per block edge
_V = BS ** 3
_KEY_BITS = 10               # per-axis bits of the single-int32 pack
_KEY_MAX = (1 << _KEY_BITS) - 1
_BIG = 1 << 30               # sentinel key: sorts after every real block


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
    """Knob set for :func:`reconstruct_sparse` (the JAX package's defaults;
    ``"additive"`` and ``"jacobi"`` are the ported preconditioners, and the
    additive one's internals are the JAX package's measured defaults,
    ω = 2 and 4 coarse PCG iterations — no caller sets them)."""

    depth: int = 10
    cg_iters: int = 200
    screen: float = 4.0
    max_blocks: int = 131_072
    # None = depth-aware default min(8, max(7, depth - 7)).
    coarse_depth: int | None = None
    coarse_iters: int = 300
    rtol: float = 3e-4
    preconditioner: str = "additive"
    fine_dtype: str = "float32"


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {where} (ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# Block keys
# ---------------------------------------------------------------------------


def _pack(bc: torch.Tensor) -> torch.Tensor:
    """(..., 3) block coords (in range) → packed int32 key."""
    bc = bc.to(torch.int32)
    return ((bc[..., 0] << (2 * _KEY_BITS)) | (bc[..., 1] << _KEY_BITS)
            | bc[..., 2])


def _unpack(key: torch.Tensor) -> torch.Tensor:
    return torch.stack([key >> (2 * _KEY_BITS), (key >> _KEY_BITS) & _KEY_MAX,
                        key & _KEY_MAX], -1)


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
    big = torch.full((), _BIG, dtype=torch.int32, device=dev)
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
    acc = torch.zeros((m * _V + 1, 4), dtype=torch.float32, device=dev)
    acc.index_add_(0, dest, contrib.reshape(-1, 4))
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


_OMEGA = 2.0          # additive: weight of the Jacobi branch
_COARSE_ITERS = 4     # additive: fixed coarse PCG iterations


def _pcg_sparse(b, W, x0, nbr, block_valid, block_coords, coarse_W,
                resolution: int, coarse_resolution: int, cg_iters: int,
                rtol: float = 3e-4):
    """Flexible PCG with the additive two-level preconditioner
    ``M⁻¹r = ω·D⁻¹r + P·Mc⁻¹·Pᵀ·r``: the Jacobi term and a coarse correction
    of the same residual, summed — no fine matvec inside the
    preconditioner. The coarse correction is a fixed-iteration Jacobi-PCG
    on the dense coarse grid, masked to the band's footprint, with the
    restriction scaled by ``cr = h_f/h_c`` and the coarse screen by
    ``ratio²``. The outer loop uses the Polak-Ribière beta, which absorbs
    the truncated coarse solve's nonlinearity. Returns (chi, iterations)."""
    R, Rc = resolution, coarse_resolution
    dev = b.device
    band = block_valid[:, None]
    zero = torch.zeros((), device=dev)
    dinv = torch.where(band, 1.0 / (6.0 + W), zero)
    m = block_coords.shape[0]

    def matvec(xf):
        return matvec_band(xf, W, nbr, block_valid)

    # Separable transfer data for the 8 interior positions of every block,
    # computed once per solve.
    cr, Wn = _coarse_ratio_width(R, Rc)
    crf = torch.tensor(cr, dtype=torch.float32, device=dev)
    e_int = torch.arange(BS, dtype=torch.float32, device=dev)
    wgt, flat_idx = _sep_weights(block_coords, e_int, cr, Rc, Wn)
    flat_idx = flat_idx.reshape(-1)
    ratio2 = torch.tensor(((R - 1.0) / (Rc - 1.0)) ** 2, dtype=torch.float32,
                          device=dev)
    Wc = coarse_W * ratio2
    dinv_c = 1.0 / (6.0 + Wc)

    def restrict(rf):
        """Band residual (M, 512) → coarse grid (Rc³,): Pᵀ·cr."""
        G = _interp3_t(wgt, rf.reshape(m, BS, BS, BS))
        acc = torch.zeros((Rc ** 3,), dtype=torch.float32, device=dev)
        return acc.index_add_(0, flat_idx, G.reshape(-1) * crf)

    def prolong(ec_flat):
        """Coarse correction (Rc³,) → band interiors (M, 512)."""
        G = ec_flat[flat_idx].reshape(m, Wn, Wn, Wn)
        return _interp3(wgt, G).reshape(m, _V)

    # Band footprint on the coarse grid (cells a band field restricts to):
    # the coarse PCG is fixed to it, zero-Dirichlet outside.
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
        for _ in range(_COARSE_ITERS):
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

    def apply_M(r):
        ec = coarse_solve(restrict(r))
        z = _OMEGA * dinv * r + torch.where(band, prolong(ec), zero)
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
    """Band-sparse screened Poisson at depth 9-13 on the device the points
    lie on. Returns (SparsePoissonGrid, n_blocks) and, with ``with_stats``,
    a dict with ``cg_iters_used``, ``coarse_iters_used``,
    ``preconditioner``, ``fine_dtype`` and ``warm_start_blocks`` (always 0
    here).

    Knobs come either as keywords or bundled in ``params`` (the single
    source of defaults, :class:`PoissonParams`), not both. A band larger
    than ``max_blocks`` is detected after set-up and rebuilt with a larger
    budget (1.25× the true size + 1024), at most twice. ``timing``, when
    given, receives the wall seconds of ``setup_s``, ``coarse_s`` (coarse
    solve and prolongation onto the band), ``fine_cg_s`` and ``iso_s``,
    each measured with a device synchronize."""
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
    preconditioner = params.preconditioner
    if preconditioner in ("vcycle", "chebyshev"):
        raise _not_ported(f"the {preconditioner!r} preconditioner",
                          "step 9 (deep-mesh and surface options)")
    if preconditioner not in ("additive", "jacobi"):
        raise ValueError(
            f"preconditioner must be 'additive', 'vcycle', 'chebyshev' "
            f"or 'jacobi', got {preconditioner!r}")
    if params.fine_dtype == "bfloat16":
        raise _not_ported("fine_dtype='bfloat16'",
                          "step 9 (deep-mesh and surface options)")
    if params.fine_dtype != "float32":
        raise ValueError(f"fine_dtype must be 'float32' or 'bfloat16', "
                         f"got {params.fine_dtype!r}")
    if depth > 16:
        raise ValueError(f"depth={depth} > 16: rejected exactly like the "
                         "reference's octree guard "
                         "(server/processing.py:207-208)")
    if (2 ** depth) // BS > (1 << _KEY_BITS):
        raise _not_ported(f"the wide-key path (depth {depth}, 14-16)",
                          "step 9 (deep-mesh and surface options)")
    if 2 ** depth < 4 * BS:
        raise ValueError(f"depth={depth} too shallow for the block solver; "
                         "use ops.poisson.reconstruct")
    if x0 is not None:
        raise _not_ported("the x0 warm start", "step 5 (streaming)")
    if coarse_depth is None:
        coarse_depth = min(8, max(7, depth - 7))
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
    t1 = clock()

    rc = 2 ** min(coarse_depth, depth)
    coarse, coarse_used = dense_poisson._solve(
        points, normals, valid, rc, coarse_iters, screen, rtol)
    b, seed = _prolong_band(coarse.chi, rhs, nbr, block_valid, block_coords,
                            2 ** depth, rc)
    del rhs
    t2 = clock()
    if preconditioner == "jacobi":
        chi, cg_used = _cg_sparse(b, W, seed, nbr, block_valid, cg_iters,
                                  rtol)
    else:
        coarse_W = dense_poisson.screen_weights(coarse.density, scr)
        chi, cg_used = _pcg_sparse(
            b, W, seed, nbr, block_valid, block_coords, coarse_W, 2 ** depth,
            rc, cg_iters, rtol=rtol)
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
                               "fine_dtype": params.fine_dtype,
                               "warm_start_blocks": 0}
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
