"""Port parity: geometry, scene, hemisphere fit (PyTorch port vs JAX).

Tolerances: the closed-form geometry runs the same float64 arithmetic in
both packages, so rtol 1e-12; the hemisphere LM iterates to a tolerance,
so rtol 1e-8."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.geometry import camera as jcam
from deeparc_tpu.geometry import projection as jproj
from deeparc_tpu.geometry import rotation as jrot
from deeparc_tpu.io import make_hemisphere_rig, read_deeparc
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver.lm import fit_hemisphere as jfit_hemisphere
from deeparc_tpu_torch.geometry import camera as tcam
from deeparc_tpu_torch.geometry import projection as tproj
from deeparc_tpu_torch.geometry import rotation as trot
from deeparc_tpu_torch.scene import (
    compact,
    freeze_masks,
    from_deeparc,
    to_deeparc,
)
from deeparc_tpu_torch.solver.lm import fit_hemisphere
from torch_parity import as_np, close

RTOL = 1e-12
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "golden_shared.deeparc")


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(0)
    aa = rng.normal(size=(64, 3))
    aa[:4] = [[0, 0, 0], [1e-13, 0, 0], [0, 2e-7, 0], [np.pi, 0, 0]]
    return aa, rng.normal(size=(64, 3))


@pytest.mark.parametrize("name", ["angle_axis_to_matrix", "so3_right_jacobian",
                                  "cross_matrix"])
def test_rotation_unary_matches_jax(vecs, name):
    aa, _ = vecs
    close(getattr(trot, name)(torch.as_tensor(aa)),
          getattr(jrot, name)(jnp.asarray(aa)), RTOL, 1e-15)


def test_angle_axis_rotate_matches_jax(vecs):
    aa, p = vecs
    close(trot.angle_axis_rotate(torch.as_tensor(aa), torch.as_tensor(p)),
          jrot.angle_axis_rotate(jnp.asarray(aa), jnp.asarray(p)), RTOL, 1e-15)


def test_projection_matches_jax(vecs):
    aa, p = vecs
    rng = np.random.default_rng(1)
    n = aa.shape[0]
    arrs = dict(point=p + [0, 0, 5], center=rng.normal(size=(n, 2)) + 800,
                focal=rng.uniform(900, 1100, size=(n, 2)),
                dist=rng.normal(scale=0.05, size=(n, 2)),
                rot_outer=aa * 0.3, t_outer=rng.normal(size=(n, 3)) * 0.1,
                rot_inner=aa[::-1] * 0.2, t_inner=rng.normal(size=(n, 3)) * 0.1)
    masks = dict(focal_shared=(np.arange(n) % 2).astype(float),
                 dist_m1=np.ones(n), dist_m2=(np.arange(n) % 3 == 0) * 1.0)
    xy = rng.normal(size=(n, 2)) * 300 + 800
    got = tproj.project_observation(
        tproj.CameraSlice(**{k: torch.as_tensor(v) for k, v in arrs.items()}),
        tproj.StructureMasks(**{k: torch.as_tensor(v)
                                for k, v in masks.items()}),
        torch.as_tensor(xy))
    want = jproj.project_observation(
        jproj.CameraSlice(**{k: jnp.asarray(v) for k, v in arrs.items()}),
        jproj.StructureMasks(**{k: jnp.asarray(v) for k, v in masks.items()}),
        jnp.asarray(xy))
    close(got, want, RTOL, 1e-9)


def test_camera_centers_match_jax():
    d = make_hemisphere_rig(n_arc=4, n_ring=6, n_points=40, seed=2).data
    got = tcam.hemisphere_camera_centers(torch.as_tensor(d.ext_rot),
                                         torch.as_tensor(d.ext_trans),
                                         d.arc_size, d.ring_size)
    want = jcam.hemisphere_camera_centers(jnp.asarray(d.ext_rot),
                                          jnp.asarray(d.ext_trans),
                                          d.arc_size, d.ring_size)
    close(got, want, RTOL, 1e-14)
    close(tcam.camera_center_single(torch.as_tensor(d.ext_rot),
                                    torch.as_tensor(d.ext_trans)),
          jcam.camera_center_single(jnp.asarray(d.ext_rot),
                                    jnp.asarray(d.ext_trans)), RTOL, 1e-14)


@pytest.mark.parametrize("source", ["golden", "synthetic"])
def test_from_to_deeparc_roundtrip(source):
    data = (read_deeparc(GOLDEN) if source == "golden" else
            make_hemisphere_rig(n_arc=3, n_ring=5, n_points=60, seed=4,
                                pixel_noise=0.5).data)
    scene = from_deeparc(data, device="cpu")
    jscene = jfrom_deeparc(data)
    for f in ("obs_point", "obs_outer", "obs_inner", "obs_intr", "obs_xy",
              "focal_shared", "dist_m1", "dist_m2"):
        np.testing.assert_array_equal(as_np(getattr(scene.index, f)),
                                      np.asarray(getattr(jscene.index, f)))
    back = to_deeparc(scene)
    for f in ("obs_arc", "obs_ring", "obs_point", "obs_xy", "points",
              "ext_rot", "ext_trans", "center", "focal", "dist", "colors"):
        np.testing.assert_array_equal(
            np.sort(np.asarray(getattr(back, f)), axis=0),
            np.sort(np.asarray(getattr(data, f)), axis=0))
    # masking then compacting drops the masked observations and points
    scene.index.point_mask[0] = 0.0
    small = to_deeparc(compact(scene))
    assert small.n_points == data.n_points - 1
    assert small.n_obs == int((data.obs_point != 0).sum())


@pytest.mark.parametrize("kw", [dict(), dict(freeze_camera=True),
                                dict(optimize_intrinsics=True)])
def test_freeze_masks_match_jax(kw):
    from deeparc_tpu.scene import freeze_masks as jfreeze

    data = read_deeparc(GOLDEN)
    got, want = freeze_masks(from_deeparc(data, device="cpu"), **kw), jfreeze(
        jfrom_deeparc(data), **kw)
    for f in ("points", "ext_rot", "ext_trans", "center", "focal", "dist"):
        np.testing.assert_array_equal(as_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))


def test_fit_hemisphere_matches_jax():
    d = make_hemisphere_rig(n_arc=4, n_ring=8, n_points=40, seed=3).data
    centers = jcam.hemisphere_camera_centers(jnp.asarray(d.ext_rot),
                                             jnp.asarray(d.ext_trans),
                                             d.arc_size, d.ring_size)
    want = jfit_hemisphere(centers, 1000)
    got = fit_hemisphere(torch.as_tensor(np.asarray(centers)), 1000)
    close(got, want, 1e-8, 1e-12)
