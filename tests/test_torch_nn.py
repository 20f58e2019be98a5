"""k = 1 nearest-neighbour sweep: the port's plain version (the CPU side of
the CUDA kernel ``csrc/nn1.cu``) against the JAX package's Pallas
``nearest_one`` in interpret mode and its XLA ``ops.knn`` k = 1 path.

Tolerances: idx equal on ≥ 99.5% of queries vs Pallas, whose d² carries
the key index in its low 13 mantissa bits (~2⁻¹⁰ relative), so d² rtol 3e-3
there; vs the XLA form d² rtol 1e-6 on the matched rows (both are direct
differences of the same float32 values). All-invalid keys give +inf, and
returned indices always point at valid keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import nn_pallas
from structured_light_for_3d_model_replication_tpu.ops import (
    registration as jreg,
)
from structured_light_for_3d_model_replication_tpu.ops.knn import knn as jknn
from structured_light_for_3d_model_replication_tpu_torch.ops import nn
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    registration,
)


def _port(q, p, valid):
    kt, p2v = nn.key_table(torch.from_numpy(p), torch.from_numpy(valid))
    d2, idx = nn.nearest_one_reference(torch.from_numpy(q), kt, p2v)
    return d2.numpy(), idx.numpy()


@pytest.fixture()
def cloud(rng):
    q = rng.normal(0, 50, (1500, 3)).astype(np.float32)
    p = rng.normal(0, 50, (1100, 3)).astype(np.float32)
    valid = rng.random(1100) > 0.2
    return q, p, valid


def test_key_table_matches_jax(cloud):
    _, p, valid = cloud
    kt, p2v = nn.key_table(torch.from_numpy(p), torch.from_numpy(valid))
    jkt, jp2v = nn_pallas.key_table(jnp.asarray(p), jnp.asarray(valid))
    assert kt.shape == (3, 2048) and p2v.shape == (1, 2048)
    assert np.array_equal(kt.numpy(), np.asarray(jkt))
    np.testing.assert_allclose(p2v.numpy(), np.asarray(jp2v), rtol=1e-6)
    assert np.array_equal(np.isinf(p2v.numpy()), np.isinf(np.asarray(jp2v)))


def test_reference_matches_pallas_interpret(cloud):
    q, p, valid = cloud
    d2, idx = _port(q, p, valid)
    jkt, jp2v = nn_pallas.key_table(jnp.asarray(p), jnp.asarray(valid))
    pd2, pidx = nn_pallas.nearest_one(jnp.asarray(q), jkt, jp2v,
                                      interpret=True)
    matched = idx == np.asarray(pidx)
    assert matched.mean() >= 0.995
    np.testing.assert_allclose(d2[matched], np.asarray(pd2)[matched],
                               rtol=3e-3)
    assert valid[idx].all()


def test_reference_matches_xla_knn(cloud):
    q, p, valid = cloud
    d2, idx = _port(q, p, valid)
    jd2, jidx, _ = jknn(jnp.asarray(p), 1, queries=jnp.asarray(q),
                        points_valid=jnp.asarray(valid))
    jidx = np.asarray(jidx)[:, 0]
    matched = idx == jidx
    assert matched.mean() >= 0.995
    np.testing.assert_allclose(d2[matched], np.asarray(jd2)[matched, 0],
                               rtol=1e-6)


def test_no_valid_keys_gives_inf(rng):
    q = rng.normal(0, 1, (64, 3)).astype(np.float32)
    p = rng.normal(0, 1, (128, 3)).astype(np.float32)
    d2, idx = _port(q, p, np.zeros(128, bool))
    assert np.isinf(d2).all()
    assert (idx == 0).all()


def test_no_key_cap_and_lowest_index_ties(rng):
    """More than the TPU kernel's 8192 keys, with exact duplicates: the
    sweep is exact and a tie goes to the lowest index."""
    p = rng.normal(0, 20, (5000, 3)).astype(np.float32)
    p = np.concatenate([p, p])                  # 10000 keys, all duplicated
    q = rng.normal(0, 20, (700, 3)).astype(np.float32)
    d2, idx = _port(q, p, np.ones(len(p), bool))
    assert (idx < 5000).all()
    dd = ((q[:, None, :] - p[None, :5000, :]) ** 2).sum(-1)
    assert np.array_equal(idx, np.argmin(dd, axis=1))


def test_wrapper_on_cpu_takes_reference_and_checks_inputs(cloud):
    q, p, valid = cloud
    kt, p2v = nn.key_table(torch.from_numpy(p), torch.from_numpy(valid))
    before = nn.nearest_one.launches
    d2, idx = nn.nearest_one(torch.from_numpy(q), kt, p2v)
    rd2, ridx = nn.nearest_one_reference(torch.from_numpy(q), kt, p2v)
    assert torch.equal(d2, rd2) and torch.equal(idx, ridx)
    assert nn.nearest_one.launches == before
    with pytest.raises(ValueError, match="float32"):
        nn.nearest_one(torch.from_numpy(q).double(), kt, p2v)
    with pytest.raises(ValueError, match=r"\(M, 3\)"):
        nn.nearest_one(torch.from_numpy(q)[:, :2], kt, p2v)


def test_nn1_matches_jax(rng):
    q = rng.normal(0, 10, (300, 3)).astype(np.float32)
    p = rng.normal(0, 10, (400, 3)).astype(np.float32)
    qv = rng.random(300) > 0.1
    pv = rng.random(400) > 0.1
    idx, found, d2 = registration._nn1(torch.from_numpy(q),
                                       torch.from_numpy(p),
                                       torch.from_numpy(pv),
                                       torch.from_numpy(qv))
    jidx, jfound, jd2 = jreg._nn1(jnp.asarray(q), jnp.asarray(p),
                                  jnp.asarray(pv), jnp.asarray(qv))
    assert np.array_equal(found.numpy(), np.asarray(jfound))
    f = found.numpy()
    assert np.array_equal(idx.numpy()[f], np.asarray(jidx)[f])
    np.testing.assert_allclose(d2.numpy()[f], np.asarray(jd2)[f], rtol=1e-6)


def test_cluster_splits_fill_the_card(monkeypatch):
    """The CUDA launch's shape (``_launch_shape``, pure host arithmetic):
    four queries a lane unless that leaves fewer than two blocks on each
    of 132 SMs, then two; the fewest blocks per tile, 1 to 8, that put two
    blocks on every SM, each block keeping at least 256 keys."""
    monkeypatch.setattr(nn, "_sm_count", lambda index: 132)
    assert nn._launch_shape(2048, 8192, 0) == (8, 2)    # ICP warm-up
    assert nn._launch_shape(8192, 8192, 0) == (8, 4)
    assert nn._launch_shape(20_000, 8192, 0) == (2, 4)  # 157 tiles
    assert nn._launch_shape(131_072, 8192, 0) == (1, 4)
    assert nn._launch_shape(100, 1024, 0) == (4, 2)     # 256 keys a block
    assert nn._launch_shape(100, 300, 0) == (1, 2)
