"""Port parity: geometry, scene, hemisphere fit (PyTorch port vs JAX).

Tolerances: the closed-form geometry runs the same float64 arithmetic in
both packages, so rtol 1e-12; the hemisphere LM iterates to a tolerance,
so rtol 1e-8."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.geometry import camera as jcam
from deeparc_tpu.geometry import projection as jproj
from deeparc_tpu.geometry import rotation as jrot
from deeparc_tpu.io import make_hemisphere_rig, read_deeparc
from deeparc_tpu.io.synthetic import make_bal_synthetic
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


def _source(name):
    """Scene contents: the golden file, a rig, the rig shuffled (points
    renumbered, observations reordered, so the point sort has ties in a
    new order) and a BAL-style non-shared scene."""
    if name == "golden":
        return read_deeparc(GOLDEN)
    if name == "bal":
        return make_bal_synthetic(n_cameras=10, n_points=80, seed=6,
                                  pixel_noise=0.5).data
    data = make_hemisphere_rig(n_arc=3, n_ring=5, n_points=60, seed=4,
                               pixel_noise=0.5).data
    if name == "synthetic":
        return data
    rng = np.random.default_rng(7)
    new_id = rng.permutation(data.n_points)
    order = rng.permutation(data.n_obs)
    points, colors = np.empty_like(data.points), np.empty_like(data.colors)
    points[new_id], colors[new_id] = data.points, data.colors
    return dataclasses.replace(
        data, obs_arc=data.obs_arc[order], obs_ring=data.obs_ring[order],
        obs_point=new_id[data.obs_point[order]].astype(np.int32),
        obs_xy=data.obs_xy[order], points=points, colors=colors)


def _same_scene(got, want):
    """Every SceneIndex and BAParams field and SceneMeta's observation and
    point columns equal bit for bit, dtypes too."""
    for group in ("index", "params"):
        g, w = getattr(got, group), getattr(want, group)
        for f in dataclasses.fields(g):
            a, b = as_np(getattr(g, f.name)), np.asarray(getattr(w, f.name))
            assert a.dtype == b.dtype, (group, f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{group}.{f.name}")
    for f in ("obs_arc", "obs_ring", "colors", "focal_size", "dist_size"):
        a, b = getattr(got.meta, f), getattr(want.meta, f)
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f"meta.{f}")


@pytest.mark.parametrize("source", ["golden", "synthetic", "shuffled", "bal"])
def test_from_to_deeparc_roundtrip(source):
    data = _source(source)
    scene = from_deeparc(data, device="cpu")
    jscene = jfrom_deeparc(data)
    _same_scene(scene, jscene)
    back = to_deeparc(scene)
    for f in ("obs_arc", "obs_ring", "obs_point", "obs_xy", "points",
              "ext_rot", "ext_trans", "center", "focal", "dist", "colors"):
        np.testing.assert_array_equal(
            np.sort(np.asarray(getattr(back, f)), axis=0),
            np.sort(np.asarray(getattr(data, f)), axis=0))
    # the given order kept, as the reference package keeps it
    _same_scene(from_deeparc(data, device="cpu", sort_by_point=False),
                jfrom_deeparc(data, sort_by_point=False))
    # masking then compacting drops the masked observations and points
    scene.index.point_mask[0] = 0.0
    small = to_deeparc(compact(scene))
    assert small.n_points == data.n_points - 1
    assert small.n_obs == int((data.obs_point != 0).sum())


@pytest.mark.parametrize("buckets", [(1, 1), (64, 16)])
@pytest.mark.parametrize("source", ["shuffled", "bal"])
def test_compact_matches_jax(source, buckets):
    """Dead observations of live points, live observations of dead points
    and a dead point with no observation left: the survivors, their new
    point ids, the padding's fills and SceneMeta bit for bit as the
    reference package's ``compact``."""
    from deeparc_tpu.scene import compact as jcompact

    data = _source(source)
    scene, jscene = from_deeparc(data, device="cpu"), jfrom_deeparc(data)
    rng = np.random.default_rng(11)
    obs_mask = (rng.random(data.n_obs) > 0.2).astype(np.float64)
    point_mask = (rng.random(data.n_points) > 0.15).astype(np.float64)
    obs_mask[as_np(scene.index.obs_point) == 0] = 0.0
    point_mask[0] = 0.0
    scene.index.obs_mask = torch.as_tensor(obs_mask)
    scene.index.point_mask = torch.as_tensor(point_mask)
    jscene.index = dataclasses.replace(
        jscene.index, obs_mask=jnp.asarray(obs_mask),
        point_mask=jnp.asarray(point_mask))
    got, want = compact(scene, *buckets), jcompact(jscene, *buckets)
    _same_scene(got, want)
    assert got.n_obs % buckets[0] == 0 and got.n_points % buckets[1] == 0


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
