"""The port's splat rasterizer (``ops/splat_render.py``,
``ops/splat_composite.py``) against the JAX package's ``ops/splat_render.py``
and ``ops/splat_render_pallas.py`` on the same numpy inputs, on the CPU.

Tolerances:
* ``_project`` records (u, v, z, radius, conic, colour, alpha₀) to 1e-5
  relative (the same float32 formulas; matrix products and the 3-term sums
  may round in another order), the visibility mask exact;
* ``_bin_tiles`` indices and membership exact, also where many splats share
  one depth (ties go to the lower splat index, as ``lax.top_k``'s);
* the plain composite against ``_composite_xla`` and against
  ``composite_pallas(interpret=True)`` to 1e-5, the JAX package's own bound
  between its two forms (tests/test_splat.py);
* a full ``render`` against ``_render_fn(use_pallas=False)`` and
  ``(use_pallas=True, interpret=True)`` on the 512-splat scene of
  tests/test_splat.py to 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import (
    splat_render as jsr,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    splat_render_pallas as jpallas,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    splat_composite as sc,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    splat_render as sr,
)

CFG = sr.RenderConfig(width=128, height=96, max_per_tile=64)
JCFG = jsr.RenderConfig(width=128, height=96, max_per_tile=64)


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def _random_splats(rng, n=256, scale=0.05):
    """tests/test_splat.py's random shell of splats."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    means = (v * rng.uniform(0.8, 1.0, (n, 1))).astype(np.float32)
    normals = v.astype(np.float32)
    log_scales = np.full((n, 3), np.log(scale), np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = rng.uniform(0.2, 1.0, (n, 3))
    opacity = np.full((n,), 2.0, np.float32)
    valid = np.ones(n, bool)
    return means, normals, log_scales, sh, opacity, valid


def _scene_with_sh(rng, n=512):
    """The random shell with view-dependent colour and some invalid rows."""
    splats = list(_random_splats(rng, n))
    splats[3][:, 1:, :] = rng.normal(0, 0.2, (n, 3, 3)).astype(np.float32)
    splats[2] = (splats[2] + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    splats[5][rng.uniform(size=n) < 0.1] = False
    return splats


def _jax_args(splats, cam):
    return [jnp.asarray(a) for a in splats] + [jnp.asarray(c) for c in cam]


def _torch_args(splats, cam):
    return [torch.from_numpy(np.asarray(a)) for a in splats] \
        + list(sr.camera_tensors(cam, "cpu"))


def _records(splats, cam):
    jout = jsr._project(*_jax_args(splats, cam), JCFG)
    tout = sr._project(*_torch_args(splats, cam), CFG)
    return jout, tout


def test_project_matches_jax(rng):
    splats = _scene_with_sh(rng)
    cam = sr.orbit_camera(splats[0].min(0), splats[0].max(0), 25, 15,
                          CFG.width, CFG.height)
    jout, tout = _records(splats, cam)
    names = ("u", "v", "z", "radius", "a", "b", "c", "color", "alpha0")
    for name, j, t in zip(names, jout[:-1], tout[:-1]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tout[-1].numpy(), np.asarray(jout[-1]))
    assert 0 < int(tout[-1].sum()) < len(splats[0])


@pytest.mark.parametrize("equal_depths", [False, True])
def test_bin_tiles_matches_jax(rng, equal_depths):
    splats = _scene_with_sh(rng)
    if equal_depths:
        # A lattice of splats facing an axis-aligned camera: rows of equal
        # camera depth, the tie case of the nearest-K selection.
        g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(8),
                                 indexing="ij"), -1).reshape(-1, 3)
        splats[0] = (g * 0.12 - 0.42).astype(np.float32)
        cam = (np.eye(3, dtype=np.float32),
               np.asarray([0.0, 0.0, -3.0], np.float32), np.float32(150.0),
               np.float32(150.0), np.float32(63.5), np.float32(47.5))
    else:
        cam = sr.orbit_camera(splats[0].min(0), splats[0].max(0), 40, -10,
                              CFG.width, CFG.height)
    jout, tout = _records(splats, cam)
    jidx, jok, jx0, jy0 = jsr._bin_tiles(jout[0], jout[1], jout[2], jout[3],
                                         jout[-1], JCFG)
    # Both sides bin the same records, so ties are exact ties on both.
    rec = [torch.from_numpy(np.array(jout[i])) for i in (0, 1, 2, 3)]
    idx, ok, x0, y0 = sr._bin_tiles(*rec, torch.from_numpy(
        np.array(jout[-1])), CFG)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    okn = ok.numpy()
    np.testing.assert_array_equal(idx.numpy()[okn], np.asarray(jidx)[okn])
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    np.testing.assert_array_equal(y0.numpy(), np.asarray(jy0))
    if equal_depths:
        z = np.asarray(jout[2])[idx.numpy()]
        ties = okn[:, 1:] & okn[:, :-1] & (z[:, 1:] == z[:, :-1])
        assert ties.sum() > 100


def _composite_inputs(rng, nt=37, k=24, tile=8, nan_masked=False):
    """Random tile records: splat centres around each tile, K sorted."""
    x0 = (rng.integers(0, 20, nt) * tile).astype(np.float32)
    y0 = (rng.integers(0, 12, nt) * tile).astype(np.float32)
    u = (x0[:, None] + rng.uniform(-4, tile + 4, (nt, k))).astype(np.float32)
    v = (y0[:, None] + rng.uniform(-4, tile + 4, (nt, k))).astype(np.float32)
    ca = rng.uniform(0.05, 0.6, (nt, k)).astype(np.float32)
    cc = rng.uniform(0.05, 0.6, (nt, k)).astype(np.float32)
    cb = (rng.uniform(-0.9, 0.9, (nt, k)) * np.sqrt(ca * cc)).astype(
        np.float32)
    cols = [rng.uniform(0, 1, (nt, k)).astype(np.float32) for _ in range(3)]
    opa = rng.uniform(0.1, 0.99, (nt, k)).astype(np.float32)
    ok = rng.uniform(size=(nt, k)) < 0.7
    u[:, 0] = x0 + 3.0            # a pixel exactly on a centre: power = 0
    v[:, 0] = y0 + 2.0
    ok[:, 0] = True
    recs = [u, v, ca, cb, cc, *cols, opa]
    if nan_masked:
        for a in recs:
            a[~ok] = np.nan
    return recs, ok, x0, y0


def test_plain_composite_matches_jax_forms(rng):
    recs, ok, x0, y0 = _composite_inputs(rng)
    jargs = [jnp.asarray(a) for a in recs] + [jnp.asarray(ok),
                                              jnp.asarray(x0),
                                              jnp.asarray(y0)]
    tcfg = jsr.RenderConfig(tile=8)
    jrgb, ja = jsr._composite_xla(*jargs, tcfg)
    prgb, pa = jpallas.composite_pallas(*jargs, tcfg, interpret=True)
    targs = [torch.from_numpy(a) for a in recs] + [
        torch.from_numpy(ok), torch.from_numpy(x0), torch.from_numpy(y0)]
    rgb, a = sc.composite_reference(*targs, 8)
    via_wrapper = sc.composite(*targs, 8)
    for ref_rgb, ref_a in ((jrgb, ja), (prgb, pa)):
        np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb),
                                   atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), atol=1e-5)
    assert torch.equal(via_wrapper[0], rgb) and torch.equal(via_wrapper[1],
                                                            a)
    assert float(a.max()) > 0.9 and float(a.min()) >= 0.0


def test_plain_composite_ignores_masked_records(rng):
    """A masked slot contributes nothing, even when its record is NaN (the
    kernel's contract; the JAX form relies on the gather's zeroing)."""
    recs, ok, x0, y0 = _composite_inputs(rng, nt=9, k=16, tile=16)
    nan_recs, _, _, _ = _composite_inputs(np.random.default_rng(0), nt=9,
                                          k=16, tile=16, nan_masked=True)
    for a, b in zip(recs, nan_recs):
        b[ok] = a[ok]
    out = []
    for rs in (recs, nan_recs):
        args = [torch.from_numpy(a) for a in rs] + [
            torch.from_numpy(ok.astype(np.float32)), torch.from_numpy(x0),
            torch.from_numpy(y0)]
        out.append(sc.composite(*args, 16))
    assert torch.isfinite(out[1][0]).all()
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_composite_bool_and_float_ok_agree(rng):
    """The wrapper takes ``ok`` as bool or as float 0/1 (the kernel reads
    either at its own dtype): the same pixels, bit for bit."""
    recs, ok, x0, y0 = _composite_inputs(rng)
    args = [torch.from_numpy(a) for a in recs]
    org = [torch.from_numpy(x0), torch.from_numpy(y0)]
    as_bool = sc.composite(*args, torch.from_numpy(ok), *org, 8)
    as_float = sc.composite(*args, torch.from_numpy(ok.astype(np.float32)),
                            *org, 8)
    assert torch.equal(as_bool[0], as_float[0])
    assert torch.equal(as_bool[1], as_float[1])


def test_plain_composite_ignores_the_tail_after_the_last_member(rng):
    """The kernel stops folding at a tile's last member; the plain version
    agrees: NaN or garbage in the records after it, and a tile whose only
    member is its last slot or that has none, give the pixels of the
    clean records."""
    nt, k = 9, 16
    recs, ok, x0, y0 = _composite_inputs(rng, nt=nt, k=k)
    ok[:, 10:] = False
    ok[1] = False
    ok[1, k - 1] = True                  # the only member in the last slot
    ok[2] = False                        # no member
    dirty = [a.copy() for a in recs]
    for a in dirty:
        a[:, 10:][~ok[:, 10:]] = np.nan
        a[1, :k - 1] = 1e30
        a[2] = np.nan
    out = []
    for rs in (recs, dirty):
        args = [torch.from_numpy(a) for a in rs] + [
            torch.from_numpy(ok), torch.from_numpy(x0), torch.from_numpy(y0)]
        out.append(sc.composite(*args, 8))
    assert torch.isfinite(out[1][0]).all() and torch.isfinite(out[1][1]).all()
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert float(out[1][1][1].max()) > 0.0          # the last slot is drawn
    assert float(out[1][1][2].abs().max()) == 0.0   # nothing in tile 2


def test_composite_wrapper_checks_its_operands():
    z = torch.zeros((4, 8))
    org = torch.zeros(4)
    planes = [z.clone() for _ in range(10)]
    assert sc.composite(*planes, org, org, 4)[0].shape == (4, 16, 3)
    with pytest.raises(ValueError, match="requires grad"):
        sc.composite(z.clone().requires_grad_(True), *planes[1:], org, org,
                     4)
    with pytest.raises(ValueError, match="float32"):
        sc.composite(*planes[:3], z.double(), *planes[4:], org, org, 4)
    with pytest.raises(ValueError, match="tile"):
        sc.composite(*planes, org, org, 33)
    with pytest.raises(ValueError, match="x0"):
        sc.composite(*planes, torch.zeros(5), org, 4)
    assert sc.composite.launches == 0     # the CPU never launches


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_matches_jax(rng, use_pallas):
    """tests/test_splat.py's 512-splat parity scene through the whole
    render at the default route (on the CPU, the composite's plain
    version), against both JAX forms, to 1e-5. The two routes differ in
    what they accept: the gradient route (``use_kernel=False``, the fit's)
    renders the same pixels from parameters that require grad and carries
    the gradient, and the kernel route (``use_kernel=True``) refuses
    them, on the CPU as on the card."""
    splats = _random_splats(rng, n=512)
    cam = sr.orbit_camera(splats[0].min(0), splats[0].max(0), 25, 15,
                          CFG.width, CFG.height)
    jimg, ja = jsr._render_fn(*_jax_args(splats, cam), JCFG,
                              use_pallas=use_pallas, interpret=use_pallas)
    img, a = sr.render(*splats, cam, CFG, device="cpu")
    assert img.shape == (CFG.height, CFG.width, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-5)

    colors = torch.as_tensor(splats[3]).requires_grad_(True)
    args = (*splats[:3], colors, *splats[4:])
    gimg, _ = sr.render(*args, cam, CFG, use_kernel=False, device="cpu")
    np.testing.assert_array_equal(gimg.detach().numpy(), img.numpy())
    gimg.sum().backward()
    assert colors.grad is not None and bool(colors.grad.abs().sum() > 0)
    with pytest.raises(ValueError, match="requires grad"):
        sr.render(*args, cam, CFG, use_kernel=True, device="cpu")


def test_render_single_splat_blob():
    """One opaque splat in front of the camera renders as a centred blob:
    high alpha at its projection, zero far away, background outside."""
    means = np.asarray([[0.0, 0.0, 0.0]], np.float32)
    normals = np.asarray([[0.0, 0.0, -1.0]], np.float32)
    log_scales = np.full((1, 3), np.log(0.08), np.float32)
    sh = np.zeros((1, 4, 3), np.float32)
    sh[0, 0] = (1.0, 0.2, 0.2)
    opacity = np.asarray([4.0], np.float32)
    valid = np.ones(1, bool)
    cam = sr.orbit_camera([-1, -1, -1], [1, 1, 1], 0.0, 0.0,
                          CFG.width, CFG.height)
    img, alpha = sr.render(means, normals, log_scales, sh, opacity, valid,
                           cam, CFG, device="cpu")
    img, alpha = img.numpy(), alpha.numpy()
    jimg, _ = jsr.render(means, normals, log_scales, sh, opacity, valid,
                         cam, JCFG, use_pallas=False)
    np.testing.assert_allclose(img, np.asarray(jimg), atol=1e-5)
    cy, cx = CFG.height // 2, CFG.width // 2
    assert alpha[cy, cx] > 0.8
    assert alpha[2, 2] == 0.0
    assert img[cy, cx, 0] > 0.8 and img[cy, cx, 0] > img[cy, cx, 1]
    bg = np.asarray(CFG.bg, np.float32) / 255.0
    np.testing.assert_allclose(img[2, 2], bg, atol=1e-5)
    assert sr.to_uint8(img).dtype == np.uint8


def test_render_invalid_splats_invisible(rng):
    """valid=False rows contribute nothing, wherever their coordinates land,
    even non-finite ones."""
    means, normals, log_scales, sh, opacity, valid = _random_splats(rng)
    cam = sr.orbit_camera(means.min(0), means.max(0), 30, 20,
                          CFG.width, CFG.height)

    def render(m, val):
        return sr.render(m, normals, log_scales, sh, opacity, val, cam,
                         CFG, device="cpu")[0].numpy()

    img0 = render(means, valid)
    means2 = means.copy()
    means2[:64] = 0.123
    valid2 = valid.copy()
    valid2[:64] = False
    m3 = means.copy()
    m3[:64] = np.nan
    img1, img2 = render(m3, valid2), render(means2, valid2)
    assert np.array_equal(img1, img2)
    assert not np.array_equal(img0, img1)
