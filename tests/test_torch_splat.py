"""The port's appearance tier (``splat/``) against the JAX package's
``splat/`` on the same numpy inputs, on the CPU.

Tolerances:
* seeding from the JAX volume's state carried into the port's volume: the
  valid mask and the picked voxels exact, means and normals to 1e-5 voxel,
  log-scales, opacity exact, DC colours to 1e-6 (the same float32
  formulas);
* one Adam step (``_fit_step``) against the JAX ``_fit_step_fn`` on the
  same scene, frame and camera: the loss and the gradients (the first
  moments over 1 − β₁) to 1e-4 relative, with an absolute floor of 1e-4 of
  the largest gradient (float32 sums over thousands of pixels, in another
  order); the updated parameters to 1e-6 where the gradient is above 1% of
  the largest (elsewhere a first Adam step is lr·sign(g), sign-sensitive);
* ``fit_appearance`` on tests/test_splat.py's coloured sphere: PSNR ≥ 28 dB
  and within 0.5 dB of the JAX package's fit;
* ``fit_pinhole`` and ``frame_target`` (numpy copies) exact;
* npz bytes written by either package read by the other, rendering the
  same pixels as the writer's scene in the reader's package (exact);
* ``splat_scene_from_cloud``: the splat count within 2% of the JAX
  package's (the TSDF integrate sums in another order, 1e-4), the JAX
  package's too-few-points rejection.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.fusion import (
    TSDFVolume as JVolume,
)
from structured_light_for_3d_model_replication_tpu.io.ply import (
    PointCloud as JPointCloud,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    splat_render as jsr,
)
from structured_light_for_3d_model_replication_tpu.ops.tsdf import (
    TSDFParams as JTSDFParams,
)
from structured_light_for_3d_model_replication_tpu.splat import fit as jfit
from structured_light_for_3d_model_replication_tpu.splat import (
    model as jmodel,
)
from structured_light_for_3d_model_replication_tpu_torch.fusion.volume import (
    TSDFVolume,
)
from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
    PointCloud,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    splat_render as sr,
)
from structured_light_for_3d_model_replication_tpu_torch.ops.tsdf import (
    TSDFParams,
)
from structured_light_for_3d_model_replication_tpu_torch.splat import (
    SplatParams,
    SplatScene,
    fit_appearance,
    fit_pinhole,
    psnr,
    seed_from_volume,
    splat_scene_from_cloud,
)
from structured_light_for_3d_model_replication_tpu_torch.splat import (
    fit as fit_mod,
)


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def carried_volume(jvol, params: TSDFParams, device="cpu") -> TSDFVolume:
    """The JAX volume's state (tsdf, weight, rgb, brick coordinates, brick
    table, count, origin, voxel size) as the port's volume."""
    st = jvol._state
    return TSDFVolume.from_arrays(
        params, jvol.origin, jvol.voxel_size, np.asarray(st.dir_map),
        np.asarray(st.tsdf), np.asarray(st.weight), np.asarray(st.rgb),
        np.asarray(st.brick_coords), np.asarray(st.n_bricks), device=device)


def port_scene(jscene) -> SplatScene:
    """The JAX scene's arrays as the port's scene on the CPU."""
    return SplatScene.from_numpy(
        SplatParams(*jscene.params), *(np.asarray(a) for a in (
            jscene.means, jscene.normals, jscene.log_scales,
            jscene.colors_sh, jscene.opacity, jscene.valid)),
        bbox=jscene.bbox, voxel_size=jscene.voxel_size, device="cpu")


@pytest.fixture(scope="module")
def sphere():
    """tests/test_splat.py's coloured unit-sphere cloud fused into a small
    JAX TSDF volume, its JAX seed, and the carried port volume."""
    rng = np.random.default_rng(0)
    n = 20000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v.astype(np.float32)
    cols = (np.stack([(v[:, 0] + 1) / 2, (v[:, 1] + 1) / 2,
                      np.full(n, 0.5)], 1) * 255).astype(np.float32)
    jvol = JVolume.from_bounds(
        JTSDFParams(grid_depth=6, max_bricks=2048), pts.min(0), pts.max(0))
    jvol.integrate_oriented(pts, cols, np.ones(n, bool), pts)
    jscene = jmodel.seed_from_volume(jvol,
                                     jmodel.SplatParams(capacity=4096))
    vol = carried_volume(jvol, TSDFParams(grid_depth=6, max_bricks=2048))
    return jvol, jscene, vol


def test_seed_matches_jax(sphere):
    jvol, jscene, vol = sphere
    scene = seed_from_volume(vol, SplatParams(capacity=4096))
    assert scene.n_splats == jscene.n_splats > 500
    np.testing.assert_array_equal(scene.valid.numpy(),
                                  np.asarray(jscene.valid))
    tol = 1e-5 * jvol.voxel_size
    np.testing.assert_allclose(scene.means.numpy(), np.asarray(jscene.means),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(scene.normals.numpy(),
                               np.asarray(jscene.normals), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(scene.log_scales.numpy(),
                                  np.asarray(jscene.log_scales))
    np.testing.assert_array_equal(scene.opacity.numpy(),
                                  np.asarray(jscene.opacity))
    np.testing.assert_allclose(scene.colors_sh.numpy(),
                               np.asarray(jscene.colors_sh), atol=1e-6)
    np.testing.assert_allclose(scene.bbox[0], jscene.bbox[0], atol=tol)
    # On the shell with outward normals, as the JAX package's test asks.
    v = scene.valid.numpy()
    r = np.linalg.norm(scene.means.numpy()[v], axis=1)
    assert np.median(np.abs(r - 1.0)) < 0.25 * jvol.voxel_size


def test_seed_empty_volume():
    vol = TSDFVolume.from_bounds(TSDFParams(grid_depth=5, max_bricks=64),
                                 [0, 0, 0], [1, 1, 1], device="cpu")
    scene = seed_from_volume(vol, SplatParams(capacity=256))
    assert scene.n_splats == 0
    assert scene.render(0, 0, 64, 48).shape == (48, 64, 3)


def _views(jscene, cfg, azims):
    """Frames, masks and cameras: renders of the JAX scene."""
    cams = [jscene.camera(az, 15, cfg.width, cfg.height) for az in azims]
    outs = [jscene.render_camera(c, cfg, use_pallas=False) for c in cams]
    frames = np.stack([np.asarray(o[0]) for o in outs])
    masks = np.stack([np.asarray(o[1]) > 0.5 for o in outs])
    return frames, masks, cams


def _gray(scene_sh):
    sh = np.array(scene_sh)
    sh[:, 0, :] = 0.5
    sh[:, 1:, :] = 0.0
    return sh


def test_adam_step_matches_jax(sphere):
    _, jscene, _ = sphere
    cfg = jsr.RenderConfig(width=64, height=48)
    frames, masks, cams = _views(jscene, cfg, (30,))
    sh0 = _gray(jscene.colors_sh)
    sh0[:, 1:, :] = 0.05                   # let the band decay act
    lrs = (0.08, 0.05, 0.01)
    step = jfit._fit_step_fn(cfg, *lrs, 0.997)
    # The JAX step donates its parameters and moments: hand it copies.
    jp = (jnp.asarray(sh0), jnp.array(jscene.opacity),
          jnp.array(jscene.log_scales))
    stacked = tuple(jnp.stack([jnp.asarray(cams[0][k], jnp.float32)])
                    for k in range(6))
    jnew, jm1, jm2, _, jloss = step(
        jp, tuple(jnp.zeros_like(p) for p in jp),
        tuple(jnp.zeros_like(p) for p in jp), jnp.zeros((), jnp.float32),
        (jscene.means, jscene.normals, jscene.valid), jnp.asarray(frames),
        jnp.asarray(masks), stacked, jnp.int32(0))

    scene = port_scene(jscene)
    params = tuple(torch.from_numpy(np.array(a)).requires_grad_(True)
                   for a in (sh0, jscene.opacity, jscene.log_scales))
    m1 = tuple(torch.zeros_like(p) for p in params)
    m2 = tuple(torch.zeros_like(p) for p in params)
    t = torch.zeros(())
    loss = fit_mod._fit_step(
        params, m1, m2, t, (scene.means, scene.normals, scene.valid),
        torch.from_numpy(frames[0]), torch.from_numpy(masks[0]),
        sr.camera_tensors(cams[0], "cpu"), sr.RenderConfig(64, 48), lrs,
        0.997)
    assert float(t) == 1.0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for name, p, a, jn, ja in zip(("colors_sh", "opacity", "log_scales"),
                                  params, m1, jnew, jm1):
        g, jg = a.numpy() / 0.1, np.asarray(ja) / 0.1
        big = float(np.abs(jg).max())
        assert big > 0.0, name
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-4 * big,
                                   err_msg=name)
        sure = np.abs(jg) > 0.01 * big
        np.testing.assert_allclose(p.detach().numpy()[sure],
                                   np.asarray(jn)[sure], atol=1e-6,
                                   err_msg=name)


def test_fit_converges_on_coloured_sphere(sphere):
    """tests/test_splat.py's convergence bar on both packages: reset the
    appearance to flat grey, fit 60 steps against 4 orbit renders of the
    true scene; the training-view PSNR passes 28 dB, and the port's is
    within 0.5 dB of the JAX package's."""
    _, jscene, _ = sphere
    cfg = jsr.RenderConfig(width=96, height=80)
    frames, masks, cams = _views(jscene, cfg, (0, 90, 180, 270))
    jgray = copy.copy(jscene)
    jgray.colors_sh = jnp.asarray(_gray(jscene.colors_sh))
    jgray.opacity = jnp.array(jscene.opacity)        # donated by the fit
    jgray.log_scales = jnp.array(jscene.log_scales)
    jgray = jfit.fit_appearance(jgray, frames, masks, cams, fit_cfg=cfg,
                                iters=60)
    jpsnr = jfit.psnr(np.asarray(jgray.render_camera(cams[0], cfg)[0]),
                      frames[0], masks[0])

    tcfg = sr.RenderConfig(width=96, height=80)
    gray = port_scene(jscene)
    gray.colors_sh = torch.from_numpy(_gray(jscene.colors_sh))
    before_sh = gray.colors_sh
    before = psnr(gray.render_camera(cams[0], tcfg)[0], frames[0], masks[0])
    gray = fit_appearance(gray, frames, masks, cams, fit_cfg=tcfg, iters=60)
    after = psnr(gray.render_camera(cams[0], tcfg)[0], frames[0], masks[0])
    st = gray.fit_stats
    assert st["fit_loss_last"] < st["fit_loss_first"]
    assert st["fit_iters"] == 60 and st["fit_frames"] == 4
    assert after > before + 5.0
    assert after >= 28.0, f"fit PSNR {after:.1f} dB below bound"
    assert abs(after - jpsnr) <= 0.5, (after, jpsnr)
    # The fit leaves the tensors it was given alone.
    assert float(torch.max(torch.abs(before_sh[:, 0, :] - 0.5))) == 0.0
    assert not gray.colors_sh.requires_grad


def test_fit_pinhole_and_frame_target_match_jax():
    h, w = 48, 64
    fx, fy, cx, cy = 80.0, 82.0, (w - 1) / 2, (h - 1) / 2
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    z = 500.0 + 20.0 * np.sin(ii / 7.0)
    pts = np.stack([(jj - cx) * z / fx, (ii - cy) * z / fy, z],
                   axis=-1).reshape(-1, 3)
    rng = np.random.default_rng(3)
    valid = rng.uniform(size=h * w) < 0.9
    got = fit_pinhole(pts, valid, h, w)
    assert got == jfit.fit_pinhole(pts, valid, h, w)
    np.testing.assert_allclose(got, (fx, fy, cx, cy), atol=1e-3)
    assert fit_pinhole(pts, np.zeros(h * w, bool), h, w) is None
    cols = rng.uniform(0, 255, (h * w, 3)).astype(np.float32)
    for stride in (1, 3):
        t, m = fit_mod.frame_target(cols, valid, h, w, stride)
        jt, jm = jfit.frame_target(cols, valid, h, w, stride)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(m, jm)
    assert psnr(t, jt, m) == jfit.psnr(t, jt, m)


def test_scene_bytes_cross_packages(sphere):
    """npz bytes in both directions: each package reads the other's archive
    and renders the same pixels as from the writer's arrays."""
    _, jscene, _ = sphere
    scene = port_scene(jscene)
    from_jax = SplatScene.from_bytes(jscene.to_bytes(), device="cpu")
    assert from_jax.params == scene.params
    assert from_jax.n_splats == scene.n_splats
    assert np.array_equal(from_jax.render(40, 10, 96, 64),
                          scene.render(40, 10, 96, 64))
    in_jax = jmodel.SplatScene.from_bytes(scene.to_bytes())
    assert tuple(in_jax.params) == tuple(scene.params)
    assert np.array_equal(in_jax.render(40, 10, 96, 64, use_pallas=False),
                          jscene.render(40, 10, 96, 64, use_pallas=False))
    clone = SplatScene.from_bytes(scene.to_bytes(), device="cpu")
    assert np.array_equal(clone.render(40, 10, 96, 64),
                          scene.render(40, 10, 96, 64))
    with pytest.raises(ValueError, match="splat scene"):
        SplatScene.from_bytes(b"not an archive at all", device="cpu")


def test_splat_scene_from_cloud_matches_jax(rng):
    n = 6000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v.astype(np.float32)
    cols = np.clip((v * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    jscene = jmodel.splat_scene_from_cloud(
        JPointCloud(points=pts, colors=cols, normals=pts.copy()),
        jmodel.SplatParams(capacity=2048), depth=6)
    scene = splat_scene_from_cloud(
        PointCloud(points=pts, colors=cols, normals=pts.copy()),
        SplatParams(capacity=2048), depth=6, device="cpu")
    assert scene.n_splats > 200
    assert abs(scene.n_splats - jscene.n_splats) <= 0.02 * jscene.n_splats
    assert scene.voxel_size == pytest.approx(jscene.voxel_size, rel=1e-6)
    img = scene.render(40, 10, 96, 64)
    bg = np.asarray(sr.BG_DEFAULT, np.uint8)
    assert (np.abs(img.astype(int) - bg.astype(int)).sum(-1)
            > 30).mean() > 0.01
    with pytest.raises(ValueError, match="too few"):
        splat_scene_from_cloud(PointCloud(points=np.zeros((4, 3),
                                                          np.float32)),
                               device="cpu")
