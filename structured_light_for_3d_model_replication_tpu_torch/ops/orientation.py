"""Globally consistent normal orientation by tangent-plane MST propagation
(counterpart of the JAX ``ops/orientation.py``).

Replaces Open3D's ``orient_normals_consistent_tangent_plane``
(`server/processing.py:201,282`) with Hoppe's algorithm: a Riemannian graph
over the k nearest neighbours (the port's exact :func:`.knn.knn`, on the
device), edges weighted by how parallel the endpoint normals are, a minimum
spanning tree, and a sign flip propagated along it, on the host. As in the
JAX package, two engines: when the port's native library loads
(:mod:`.._native`), its Prim MST over the symmetrised graph, then a majority
radial vote per component picks the outward sign; otherwise scipy's MST,
each component rooted at its point furthest from the centroid.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import breadth_first_order, connected_components, \
    minimum_spanning_tree

from .. import _native
from .._device import resolve_device
from .knn import knn


def orient_normals_consistent_tangent_plane(
    points: np.ndarray,
    normals: np.ndarray,
    k: int = 100,
    outward: bool = True,
    device=None,
) -> np.ndarray:
    """Flip normal signs for global consistency; returns oriented normals.

    ``k`` mirrors the reference's
    ``orient_normals_consistent_tangent_plane(100)``. Each connected
    component ends pointing away from (``outward=True``) the cloud
    centroid: by the majority of its points' radial votes on the native
    engine, by its root's (its point furthest from the centroid) on the
    scipy one. The KNN graph is built on ``device``."""
    pts = np.asarray(points, np.float32)
    nrm = np.asarray(normals, np.float32).copy()
    n = pts.shape[0]
    if n == 0:
        return nrm
    k_eff = min(k, n)
    dev = resolve_device(device)
    _, idx, nbv = knn(torch.from_numpy(pts).to(dev), k_eff)
    idx, nbv = idx.cpu().numpy(), nbv.cpu().numpy()

    if _native.available():
        # Prim over the symmetrised graph, so its reachability is the
        # union-find components' that the vote runs over.
        out, _ = _native.mst_orient_normals(pts, nrm, idx, nbv,
                                            seed_dir=(0.0, 0.0, 0.0))
        labels, ncomp = _native.connected_components(idx, nbv)
        vote = np.einsum("ij,ij->i", out, pts - pts.mean(axis=0))
        for comp in range(ncomp):
            m = labels == comp
            total = float(vote[m].sum())
            if (total < 0) == outward and total != 0.0:
                out[m] = -out[m]
        return out

    rows = np.repeat(np.arange(n), k_eff)
    cols = idx.reshape(-1)
    mask = nbv.reshape(-1) & (rows != cols)
    rows, cols = rows[mask], cols[mask]
    # Edge weight 1 - |n_i · n_j| (small when tangent planes agree), with an
    # epsilon so the MST keeps even perfectly parallel edges.
    dots = np.abs(np.einsum("ij,ij->i", nrm[rows], nrm[cols]))
    w = np.maximum(1.0 - dots, 1e-6)
    graph = coo_matrix((w, (rows, cols)), shape=(n, n))
    # Union-symmetrize: keep one-sided KNN edges.
    graph = graph.maximum(graph.T)
    ncomp, labels = connected_components(graph, directed=False)
    mst = minimum_spanning_tree(graph)
    sym_csr = (mst + mst.T).tocsr()

    r = pts - pts.mean(axis=0)
    # Flip factor per point: along a tree edge pred→node,
    # f[node] = f[pred] · sign(n_node · n_pred), one BFS depth level at a
    # time.
    f = np.ones(n, np.float32)
    for comp in range(ncomp):
        members = np.where(labels == comp)[0]
        root = members[np.argmax(np.einsum("ij,ij->i", r[members],
                                           r[members]))]
        order, pred = breadth_first_order(sym_csr, root, directed=False)
        s = float(np.dot(nrm[root], r[root]))
        f[root] = -1.0 if ((s < 0) == outward and s != 0.0) else 1.0
        depth = np.zeros(n, np.int64)
        for node in order[1:]:
            depth[node] = depth[pred[node]] + 1
        if len(order) > 1:
            nodes = order[1:]
            dlev = depth[nodes]
            edge_sign = np.sign(np.einsum(
                "ij,ij->i", nrm[nodes], nrm[pred[nodes]]))
            edge_sign[edge_sign == 0] = 1.0
            for d in range(1, int(dlev.max()) + 1):
                lvl = nodes[dlev == d]
                f[lvl] = f[pred[lvl]] * edge_sign[dlev == d]
    return nrm * f[:, None]
