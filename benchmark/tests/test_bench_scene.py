"""The on-card renderer (here on the CPU) against its frozen NumPy copy
and the port's own frame model, and the plain reference against the
scene's surface, at a small size."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import plain
from benchmark.scene import frozen_numpy, render

RIG = render.Rig(dict(proj_width=256, proj_height=128, cam_width=160,
                      cam_height=96))


@pytest.fixture(scope="module", params=[None, 700.0],
                ids=["no_wall", "wall"])
def scene(request):
    """The ring's scene, and the same with a wall behind it."""
    return dict(harness.config_of("ring24_1080p")["scene"],
                wall_z=request.param)


def test_frames_equal_the_numpy_copy():
    got = render.pattern_frames(RIG, "cpu").numpy()
    want = frozen_numpy.pattern_frames(RIG.proj_w, RIG.proj_h, RIG.col_bits,
                                       RIG.row_bits)
    assert got.shape == (RIG.n_frames, 128, 256)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("angle", [0.0, 37.0, 195.0])
def test_stop_equals_the_numpy_copy(scene, angle):
    got = render.Renderer(scene, RIG, "cpu").stop(angle).numpy()
    spheres = render.rotated_spheres(scene, angle)
    want = frozen_numpy.render_stop(
        spheres, scene["wall_z"], scene["wall_albedo"], scene["ambient"],
        RIG.matrices, RIG.cam_h, RIG.cam_w,
        frozen_numpy.pattern_frames(RIG.proj_w, RIG.proj_h, RIG.col_bits,
                                    RIG.row_bits))
    assert (got != want).mean() < 1e-4


def test_numpy_copy_equals_the_ports_model(scene):
    from structured_light_for_3d_model_replication_tpu_torch.config import (
        ProjectorConfig,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        synthetic,
    )

    proj = ProjectorConfig(width=RIG.proj_w, height=RIG.proj_h)
    sc = synthetic.Scene(
        wall_z=scene["wall_z"], ambient=scene["ambient"],
        spheres=tuple(synthetic.Sphere(tuple(s[:3]), s[3], s[4])
                      for s in scene["spheres"]))
    stack, _ = synthetic.render_scan(
        synthetic.rotated_scene(sc, 30.0),
        *synthetic.default_calibration(RIG.cam_h, RIG.cam_w, proj),
        RIG.cam_h, RIG.cam_w, proj)
    want = frozen_numpy.render_stop(
        render.rotated_spheres(scene, 30.0), scene["wall_z"],
        scene["wall_albedo"], scene["ambient"], RIG.matrices, RIG.cam_h,
        RIG.cam_w, frozen_numpy.pattern_frames(RIG.proj_w, RIG.proj_h,
                                               RIG.col_bits, RIG.row_bits))
    np.testing.assert_array_equal(stack, want)


def test_noise_follows_the_seed(scene):
    r = render.Renderer(scene, RIG, "cpu")

    def noisy(seed):
        g = torch.Generator().manual_seed(seed)
        return r.stop(0.0, g, 2.0)
    a, b, c = noisy(2 ** 31 + 5), noisy(2 ** 31 + 5), noisy(7)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a.int() - r.stop(0.0).int()).abs().float().mean() < 3.0


def test_reference_lies_on_the_scene(scene):
    stack = render.Renderer(scene, RIG, "cpu").stop(15.0)
    pts, idx = plain.triangulate(stack, RIG)
    assert pts.shape[0] > 0.1 * RIG.cam_h * RIG.cam_w
    spheres = render.rotated_spheres(scene, 15.0)
    d = torch.full((pts.shape[0],), float("inf"), dtype=torch.float64)
    for c, r, _ in spheres:
        d = torch.minimum(d, (pts.double() - torch.tensor(c)).norm(dim=1)
                          - r)
    if scene["wall_z"] is not None:
        d = torch.minimum(d.abs(), (pts[:, 2].double()
                                    - scene["wall_z"]).abs())
    # A projector column is ~2.3 mm wide at 700 mm at this size, and a
    # 16-degree triangulation angle stretches it ~3.5 times along depth.
    assert float(d.abs().median()) < 3.0


def test_turntable_pose_maps_a_stop_onto_the_anchor(scene):
    centre = np.array(scene["spheres"][1][:3])
    at = {a: np.array(render.rotated_spheres(scene, a)[1][0])
          for a in (30.0, 75.0)}
    pose = plain.turntable_pose(75.0, 30.0, scene["pivot"])
    moved = pose[:3, :3] @ at[75.0] + pose[:3, 3]
    np.testing.assert_allclose(moved, at[30.0], atol=1e-9)
    assert not np.allclose(centre, at[75.0])
