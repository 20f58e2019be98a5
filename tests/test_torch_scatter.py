"""The port's float scatter-sums (``ops/_scatter.py``): the card's forms
(sorting accumulate, segmented sum, a once-sorted plan), called here on CPU
tensors with ``_scatter._card`` patched to choose them, against
``index_add_``, which the CPU form keeps.

Tolerance against ``index_add_``: the forms add each destination's terms in
another order, so they agree to fp32 rounding, ``rtol=1e-5`` and ``atol``
1e-6 of the largest destination's sum of |terms|. Two calls of one form on
one input are bit-equal.
"""

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import (
    _scatter,
    pointcloud,
    poisson_sparse,
)


def _case(rng, n=5000, size=700, cols=3):
    idx = rng.integers(0, size, n)
    idx[rng.random(n) < 0.3] = 17            # one heavily shared row
    vals = rng.normal(0, 100, (n, cols)).astype(np.float32)
    return torch.from_numpy(idx), torch.from_numpy(vals), size


@pytest.fixture
def card_forms(monkeypatch):
    """Patches the helper to take the card's forms on CPU tensors; the
    patch is undone by ``.undo()`` or at the test's end."""
    monkeypatch.setattr(_scatter, "_card", lambda t: True)
    return monkeypatch


def _index_add(size, idx, vals):
    return vals.new_zeros((size,) + tuple(vals.shape[1:])).index_add_(
        0, idx, vals)


def _assert_close(got, ref, idx, vals, size):
    mag = _index_add(size, idx, vals.abs()).max().item()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6 * mag)


@pytest.mark.parametrize("cols", [1, 3, 5])
def test_card_forms_match_index_add(rng, cols, card_forms):
    idx, vals, size = _case(rng, cols=cols)
    if cols == 1:
        vals = vals[:, 0]
    ref = _index_add(size, idx, vals)
    _assert_close(_scatter.scatter_sum(size, idx, vals), ref, idx,
                  vals, size)
    order = torch.argsort(idx, stable=True)
    _assert_close(_scatter.segment_sum(vals[order], idx[order], size), ref, idx, vals, size)
    plan = _scatter.ScatterPlan(idx, size)
    _assert_close(plan.sum(vals), ref, idx, vals, size)
    # Destinations that no row reaches stay zero.
    empty = torch.ones(size, dtype=torch.bool)
    empty[idx] = False
    assert empty.any() and (plan.sum(vals)[empty] == 0).all()


def test_cpu_forms_are_index_add(rng):
    idx, vals, size = _case(rng)
    ref = _index_add(size, idx, vals)
    order = torch.argsort(idx, stable=True)
    assert torch.equal(_scatter.scatter_sum(size, idx, vals), ref)
    assert torch.equal(_scatter.ScatterPlan(idx, size).sum(vals), ref)
    assert torch.equal(_scatter.segment_sum(vals[order], idx[order], size),
                       _index_add(size, idx[order], vals[order]))


def test_card_forms_are_repeatable(rng, card_forms):
    idx, vals, size = _case(rng)
    order = torch.argsort(idx, stable=True)
    plan = _scatter.ScatterPlan(idx, size)
    for fn in (lambda: _scatter.scatter_sum(size, idx, vals),
               lambda: _scatter.segment_sum(vals[order], idx[order], size),
               lambda: plan.sum(vals),
               lambda: _scatter.ScatterPlan(idx, size).sum(vals)):
        a, b = fn(), fn()
        assert torch.equal(a, b)
        assert np.array_equal(a.numpy().view(np.uint32),
                              b.numpy().view(np.uint32))


def test_voxel_downsample_segmented_form_matches_cpu_form(rng, monkeypatch):
    pts = rng.normal(0, 30, (6000, 3)).astype(np.float32)
    valid = rng.random(6000) > 0.1
    colors = ((pts * 0.7) % 255).astype(np.float32)
    args = (torch.from_numpy(pts), 4.0)
    kw = dict(valid=torch.from_numpy(valid), attrs=torch.from_numpy(colors))
    cpu = pointcloud.voxel_downsample(*args, **kw)
    monkeypatch.setattr(_scatter, "_card", lambda t: True)
    seg = pointcloud.voxel_downsample(*args, **kw)
    again = pointcloud.voxel_downsample(*args, **kw)
    assert int(seg[3]) == int(cpu[3]) > 100
    assert torch.equal(seg[2], cpu[2])
    for got, ref in ((seg[0], cpu[0]), (seg[1], cpu[1])):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-4)
    for a, b in zip(seg[:2], again[:2]):
        assert torch.equal(a, b)
    # One attribute channel as a 1-D tensor keeps its shape.
    one = pointcloud.voxel_downsample(*args, valid=kw["valid"],
                                      attrs=kw["attrs"][:, 0])
    assert one[1].shape == (6000,)
    np.testing.assert_allclose(one[1].numpy(), seg[1][:, 0].numpy(),
                               rtol=1e-6)


def test_restrict_plan_matches_per_call_form(rng, card_forms):
    """The restriction with its sort taken once per solve equals the
    per-call sorting accumulate and the CPU ``index_add_``."""
    R, Rc = 2 ** 9, 65
    cr, Wn = poisson_sparse._coarse_ratio_width(R, Rc)
    coords = rng.integers(20, 44, (300, 3))
    bcc = torch.from_numpy(np.unique(coords, axis=0)).to(torch.int32)
    m = bcc.shape[0]
    e = torch.arange(8, dtype=torch.float32)
    wgt, flat_idx = poisson_sparse._sep_weights(bcc, e, cr, Rc, Wn)
    flat_idx = flat_idx.reshape(-1)
    crf = torch.tensor(cr, dtype=torch.float32)
    rf = torch.from_numpy(rng.normal(0, 1, (m, 512)).astype(np.float32))
    plan = poisson_sparse.ScatterPlan(flat_idx, Rc ** 3)
    got = poisson_sparse._restrict(rf, wgt, plan, crf)
    G = poisson_sparse._interp3_t(wgt, rf.reshape(m, 8, 8, 8)).reshape(-1)
    per_call = _scatter.scatter_sum(Rc ** 3, flat_idx, G * crf)
    card_forms.undo()
    cpu = poisson_sparse._restrict(
        rf, wgt, poisson_sparse.ScatterPlan(flat_idx, Rc ** 3), crf)
    assert torch.equal(cpu, _index_add(Rc ** 3, flat_idx, G * crf))
    for ref in (per_call, cpu):
        _assert_close(got, ref, flat_idx, G * crf, Rc ** 3)
    assert torch.equal(got, poisson_sparse._restrict(rf, wgt, plan, crf))
