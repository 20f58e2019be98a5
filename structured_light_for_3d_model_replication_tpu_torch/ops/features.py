"""FPFH (Fast Point Feature Histograms), batched and branch-free — the
"gather" engine (counterpart of the JAX ``ops/features.py``).

1. neighbourhoods from the exact KNN, radius-masked;
2. the Darboux-frame angles (α, φ, θ) for every (point, neighbour) pair;
3. SPFH histograms by one-hot sums;
4. FPFH = SPFH(p) + mean_k(SPFH(q_k) / ‖p − q_k‖), each 11-bin
   sub-histogram L1-normalized to 100.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .._device import div
from .knn import check_neighbors, knn

N_BINS = 11
FPFH_DIM = 3 * N_BINS


def _bin(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    b = torch.floor(div(x - lo, hi - lo) * N_BINS).to(torch.int64)
    return b.clamp(0, N_BINS - 1)


def fpfh(points: torch.Tensor, normals: torch.Tensor, radius: float,
         valid: torch.Tensor | None = None, max_nn: int = 100,
         neighbors=None):
    """(N, 33) float32 FPFH descriptors (+ (N,) validity). ``neighbors``
    optionally supplies a precomputed ``(d2, idx, nb_valid)`` self-query
    sweep (ascending, ≥ max_nn columns); pairs re-mask against ``valid``."""
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    pts = points.to(torch.float32)
    nrm = normals.to(torch.float32)
    if neighbors is not None:
        check_neighbors(neighbors, n, max_nn)
        d2, idx, nbv = (a[:, :max_nn] for a in neighbors)
    else:
        d2, idx, nbv = knn(pts, max_nn, points_valid=valid)
    own = torch.arange(n, device=dev)[:, None]

    pnv = torch.cat([pts, nrm, valid.to(torch.float32)[:, None]], 1)[idx]
    q = pnv[..., :3]
    nt = pnv[..., 3:6]
    pair_ok = nbv & (d2 <= radius * radius) & (idx != own) \
        & (pnv[..., 6] > 0.5) & valid[:, None]
    dvec = q - pts[:, None, :]
    dist = torch.sqrt(torch.sum(dvec * dvec, dim=-1).clamp_min(1e-20))
    dn = dvec / dist[..., None]

    # Darboux frame at the source point: u = n_s, v = u × d̂, w = u × v.
    u = nrm[:, None, :].expand_as(dvec)
    v = torch.linalg.cross(u, dn, dim=-1)
    v_norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    v = v / torch.where(v_norm > 1e-12, v_norm, torch.ones((), device=dev))
    w = torch.linalg.cross(u, v, dim=-1)

    alpha = torch.sum(v * nt, dim=-1)
    phi = torch.sum(u * dn, dim=-1)
    theta = torch.atan2(torch.sum(w * nt, dim=-1), torch.sum(u * nt, dim=-1))

    bins = torch.stack([_bin(alpha, -1.0, 1.0), _bin(phi, -1.0, 1.0),
                        _bin(theta, -math.pi, math.pi)], dim=-1)  # (N, K, 3)
    onehot = F.one_hot(bins, N_BINS).to(torch.float32)   # (N, K, 3, 11)
    onehot = onehot * pair_ok[..., None, None]
    spfh = onehot.sum(1).reshape(n, FPFH_DIM)
    cnt = pair_ok.sum(1).clamp_min(1)[:, None].to(torch.float32)
    spfh = spfh / cnt

    wgt = torch.where(pair_ok, 1.0 / dist.clamp_min(1e-12),
                      torch.zeros((), device=dev))
    nb_spfh = spfh[idx]                                   # (N, K, 33)
    wsum = wgt.sum(1).clamp_min(1e-12)[:, None]
    f = spfh + torch.einsum("nk,nkf->nf", wgt, nb_spfh) / wsum

    f3 = f.reshape(n, 3, N_BINS)
    s = f3.sum(-1, keepdim=True).clamp_min(1e-12)
    f = (100.0 * f3 / s).reshape(n, FPFH_DIM)
    feat_valid = valid & (pair_ok.sum(1) >= 1)
    return torch.where(feat_valid[:, None], f, torch.zeros((), device=dev)), \
        feat_valid
