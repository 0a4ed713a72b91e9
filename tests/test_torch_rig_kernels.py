"""Port parity: the grid kernels' plain PyTorch versions vs the JAX Pallas
kernels run in interpret mode, on the same inputs.

Tolerances are the reference's own for these kernels: 1e-8 .. 1e-10 on
the monolithic pair (tests/test_pallas_kernels.py) and 1e-4 .. 1e-5 on the
banded pair (tests/test_rig_band.py); both sides compute in float64."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.kernels import rig_pallas as jk
from deeparc_tpu.residuals.reprojection import flatten_camera as jflatten
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver.rig_band import band_grid as jband_grid
from deeparc_tpu.solver.rig_grid import grid_from_scene as jgrid_from_scene
from deeparc_tpu.solver.rig_grid import slot_params as jslot_params
from deeparc_tpu_torch.kernels import rig_grid as tk
from deeparc_tpu_torch.residuals.reprojection import flatten_camera
from deeparc_tpu_torch.solver.rig_grid import slot_params
from torch_parity import as_np, close, grid_to_torch, params_to_torch


def _free_tables(cam_free, grid, R, K):
    rows = cam_free[: 6 * R].reshape(R, 6)
    intr = cam_free[6 * R:].reshape(K, 6)
    idx = lambda t: t.long() if isinstance(t, torch.Tensor) else t
    return (rows[idx(grid.slot_outer)], rows[idx(grid.slot_inner)],
            intr[idx(grid.slot_intr)])


@pytest.fixture(scope="module", params=[dict(focal_size=1, dist_size=0),
                                        dict(focal_size=2, dist_size=2)])
def mono(request):
    rig = make_hemisphere_rig(n_arc=3, n_ring=5, n_points=50, pixel_noise=0.5,
                              point_noise=0.04, visibility=0.8, seed=31,
                              **request.param)
    scene = jfrom_deeparc(rig.data)
    grid = jgrid_from_scene(scene)
    free = jfreeze(scene)
    return scene, grid, free


def _mono_inputs(mono):
    scene, grid, free = mono
    R, K = grid.onehot_outer.shape[1], grid.onehot_intr.shape[1]
    j_in = (scene.params.points, free.points, jslot_params(scene.params, grid),
            grid, *_free_tables(jflatten(free), grid, R, K))
    params, tgrid = params_to_torch(scene.params), grid_to_torch(grid)
    tfree = params_to_torch(free)
    t_in = (params.points, tfree.points, slot_params(params, tgrid), tgrid,
            *_free_tables(flatten_camera(tfree), tgrid, R, K))
    return j_in, t_in


@pytest.fixture(scope="module")
def jax_mono(mono):
    """The JAX monolithic kernels (interpret) on the rig, once per kernel
    and loss: the tests below hold two things against them."""
    j_in, _ = _mono_inputs(mono)
    memo = {}

    def run(kernel, loss, scale):
        if (kernel, loss, scale) not in memo:
            args = j_in if kernel == "linearize_grid" else (j_in[0], j_in[2],
                                                            j_in[3])
            memo[kernel, loss, scale] = getattr(jk, kernel)(
                *args, loss=loss, loss_scale=scale, block_np=16,
                interpret=True)
        return memo[kernel, loss, scale]

    return run


@pytest.mark.parametrize("loss,scale", [("trivial", 0.5), ("cauchy", 2.0),
                                        ("huber", 3.0)])
def test_linearize_grid_plain_matches_pallas(mono, jax_mono, loss, scale):
    j_in, t_in = _mono_inputs(mono)
    want = jax_mono("linearize_grid", loss, scale)
    got = tk.linearize_grid(*t_in, loss=loss, loss_scale=scale, block_np=16)
    for g, w, rtol, atol in zip(got, want, (1e-9, 1e-8, 1e-8, 1e-8, 1e-8, 1e-8),
                                (0, 1e-10, 1e-10, 1e-9, 1e-9, 1e-10)):
        close(g, w, rtol, atol)


def test_cost_grid_plain_matches_pallas(mono, jax_mono):
    j_in, t_in = _mono_inputs(mono)
    want = jax_mono("cost_grid", "huber", 3.0)
    got = tk.cost_grid(t_in[0], t_in[2], t_in[3], loss="huber",
                       loss_scale=3.0, block_np=16)
    close(got, want, 1e-10)


@pytest.mark.parametrize("kernel", ["linearize_grid", "cost_grid"])
def test_mono_kernels_take_a_given_stack(mono, jax_mono, kernel):
    """The monolithic pair given the solve's plane stack (``mono_planes``,
    here wider than the wrapper would pad) equals the pair building its
    own, and both match the JAX kernel in interpret mode."""
    _, t_in = _mono_inputs(mono)
    grid = t_in[3]
    pxm = tk.mono_planes(grid, 96)
    assert tuple(pxm.shape) == (3, 16, 96)
    assert torch.equal(pxm[:, :15, :50], torch.stack(
        [grid.xy0.T, grid.xy1.T, grid.mask.T]))
    assert not pxm[:, 15:].any() and not pxm[:, :, 50:].any()
    if kernel == "cost_grid":
        args = (t_in[0], t_in[2], t_in[3])
        tols = ((1e-10, 0),)
    else:
        args = t_in
        tols = tuple(zip((1e-9, 1e-8, 1e-8, 1e-8, 1e-8, 1e-8),
                         (0, 1e-10, 1e-10, 1e-9, 1e-9, 1e-10)))
    fn = getattr(tk, kernel)
    kw = dict(loss="huber", loss_scale=3.0, block_np=16)
    given, built = fn(*args, pxm=pxm, **kw), fn(*args, **kw)
    want = jax_mono(kernel, "huber", 3.0)
    given, built, want = ((x if isinstance(x, tuple) else (x,))
                          for x in (given, built, want))
    for g, b, w, (rtol, atol) in zip(given, built, want, tols):
        close(g, as_np(b), 1e-12, 1e-14)
        close(g, w, rtol, atol)


@pytest.mark.parametrize("shape", [(3, 16, 48), (3, 24, 64), (3, 16, 72),
                                   (2, 16, 64)])
def test_mono_kernels_refuse_a_stack_of_the_wrong_shape(mono, shape):
    """A stack with fewer points than the grid, another cell count, a
    width the point tiles do not divide or a missing plane is refused
    before any kernel runs."""
    _, t_in = _mono_inputs(mono)
    pxm = torch.zeros(shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="mono_planes"):
        tk.cost_grid(t_in[0], t_in[2], t_in[3], block_np=16, pxm=pxm)
    with pytest.raises(ValueError, match="mono_planes"):
        tk.linearize_grid(*t_in, block_np=16, pxm=pxm)


@pytest.fixture(scope="module")
def banded():
    """3x16-cell occlusion rig (numpy generator), band-prepped by JAX; the
    port gets the same band-prepped grid and the same band tables
    (test_torch_rig_band.py holds the port's own band prep against JAX)."""
    rig = make_hemisphere_rig(n_arc=3, n_ring=16, n_points=420,
                              occlusion_rings=4, visibility=0.9,
                              pixel_noise=0.8, point_noise=0.02, seed=5)
    scene = jfrom_deeparc(rig.data)
    prep = jband_grid(jgrid_from_scene(scene), block_np=64, cost_block_np=128)
    assert prep is not None
    tg = grid_to_torch(prep.grid)
    starts, starts_cost, pxm_lin, pxm_cost = prep.grid.band
    t = lambda a: torch.as_tensor(np.asarray(a))
    tg.band = (t(starts), t(starts_cost), tuple(t(p) for p in pxm_lin),
               tuple(t(p) for p in pxm_cost))
    return scene, prep, tg


@pytest.mark.parametrize("loss,scale,intr_frozen", [
    ("trivial", 0.5, False),   # full E: extrinsic + intrinsic columns
    ("huber", 2.0, True),      # ext-only E, intrinsic slot entries zero
])
def test_linearize_banded_plain_matches_pallas(banded, loss, scale,
                                               intr_frozen):
    scene, prep, tg = banded
    g = prep.grid
    perm = np.asarray(prep.perm)
    params = dataclasses.replace(scene.params,
                                 points=scene.params.points[perm])
    R, K = g.onehot_outer.shape[1], g.onehot_intr.shape[1]
    cam_free = np.ones(6 * (R + K))
    if intr_frozen:
        cam_free[6 * R:] = 0.0
    pf = np.ones_like(np.asarray(params.points))
    want = jk.linearize_grid_banded(
        params.points, jnp.asarray(pf), jslot_params(params, g), g,
        *_free_tables(jnp.asarray(cam_free), g, R, K), g.band[0],
        w_band=prep.lin_groups, loss=loss, loss_scale=scale, block_np=64,
        interpret=True, intr_frozen=intr_frozen, pxm=g.band[2])
    tparams = params_to_torch(params)
    got = tk.linearize_grid_banded(
        tparams.points, torch.as_tensor(pf), slot_params(tparams, tg), tg,
        *_free_tables(torch.as_tensor(cam_free), tg, R, K), tg.band[0],
        w_band=prep.lin_groups, loss=loss, loss_scale=scale, block_np=64,
        intr_frozen=intr_frozen, pxm=tg.band[2])
    assert got[5].shape == want[5].shape
    for g_, w_, rtol, atol in zip(got, want, (1e-5, 1e-4, 1e-4, 1e-4, 1e-4,
                                              1e-4),
                                  (0, 1e-5, 1e-5, 1e-4, 1e-4, 1e-5)):
        close(g_, w_, rtol, atol)


@pytest.mark.parametrize("tp", [32, 16])
def test_band_subtiles_pin_starts_and_groups(banded, tp):
    """linearize_band's tiles of tp points: each width group of block_np
    tiles splits into (hi - lo) * block_np / tp of them, and sub-tile s,
    taking the band of block tile lo + s * tp // block_np, sees exactly the
    group's gathered plane columns [s * tp, (s + 1) * tp)."""
    scene, prep, tg = banded
    starts, pxms = tg.band[0], tg.band[2]
    block_np = 64
    subs = tk.band_subtiles(prep.lin_groups, block_np, tp)
    assert [(w, lo) for w, lo, _ in subs] == [
        (w, lo) for w, lo, _ in prep.lin_groups]
    n_pad = prep.lin_groups[-1][2] * block_np
    assert sum(n for _, _, n in subs) * tp == n_pad
    w_max = max(w for w, _, _ in prep.lin_groups)
    pxm_ext = tk.banded_planes(tg, n_pad, w_max)
    for (w, lo, n_sub), pxm in zip(subs, pxms):
        sub_starts = starts[lo + torch.arange(n_sub) * tp // block_np]
        seen = tk.gather_banded_planes(
            pxm_ext, torch.cat([torch.zeros(lo * block_np // tp,
                                            dtype=sub_starts.dtype),
                                sub_starts]), w, tp, lo * block_np // tp,
            lo * block_np // tp + n_sub)
        assert torch.equal(seen, pxm)
    with pytest.raises(ValueError):
        tk.band_subtiles(prep.lin_groups, 48, 32)


@pytest.mark.parametrize("loss,scale,width", [
    ("trivial", 0.5, "groups"),
    ("huber", 2.0, "groups"),
    ("cauchy", 3.0, "groups"),
    ("cauchy", 3.0, "one"),   # one integer width, each side gathers its stack
])
def test_cost_banded_plain_matches_pallas(banded, loss, scale, width):
    """The banded trial cost against JAX's (interpret mode), over the band
    prep's width groups with its gathered stacks, or over one width that
    covers every tile's band with no stack given. 1e-5 relative: the
    reference's own tolerance for the banded pair (tests/test_rig_band.py);
    both sides compute in float64."""
    scene, prep, tg = banded
    g = prep.grid
    params = dataclasses.replace(
        scene.params, points=scene.params.points[np.asarray(prep.perm)])
    tparams = params_to_torch(params)
    if width == "groups":
        kw_j = dict(w_band=prep.cost_groups, pxm=g.band[3])
        kw_t = dict(w_band=prep.cost_groups, pxm=tg.band[3])
    else:
        kw_j = kw_t = dict(w_band=prep.w_band_cost, pxm=None)
    want = jk.cost_grid_banded(params.points, jslot_params(params, g), g,
                               g.band[1], loss=loss, loss_scale=scale,
                               block_np=128, interpret=True, **kw_j)
    got = tk.cost_grid_banded(tparams.points, slot_params(tparams, tg), tg,
                              tg.band[1], loss=loss, loss_scale=scale,
                              block_np=128, **kw_t)
    close(got, want, 1e-5)


@pytest.mark.parametrize("block_np", [128, 320, 512])
def test_cost_launch_maps_blocks_to_band_columns(banded, block_np):
    """cost_band's one launch over all width groups: block j of a group,
    decoded as the kernel decodes it (tile lo + j // per_tile, points
    (j % per_tile) * threads + [0, threads) below block_np), reads exactly
    the gathered stack's columns that hold that tile's points in that
    tile's band, and the blocks cover every column of every group once.
    The decode here is Python's copy of the kernel's; the kernel's own
    (``cost_band`` in ``csrc/rig_grid.cu``) is held only by
    ``chip_smoke.py`` phase 3, against the plain version, on the
    flagship's three width groups."""
    _, _, tg = banded
    gen = torch.Generator().manual_seed(block_np)
    n_tiles = 7
    n_pad = n_tiles * block_np
    t_pad = tg.xy0.shape[1]
    groups = ((16, 0, 2), (24, 2, 2), (32, 2, 6), (8, 6, 7))
    starts = torch.randint(0, t_pad // 8, (n_tiles,), generator=gen,
                           dtype=torch.int32)
    pxm_ext = tk.banded_planes(tg, n_pad, 32)
    launch = tk.cost_launch(groups, block_np)
    assert launch.threads % 32 == 0 and launch.threads <= tk.COST_THREADS
    assert launch.per_tile * launch.threads >= block_np
    firsts = list(launch.first_blocks) + [launch.n_blocks]
    assert firsts[0] == 0
    for (w, lo, hi), first, nxt in zip(groups, firsts, firsts[1:]):
        stack = tk.gather_banded_planes(pxm_ext, starts, w, block_np, lo, hi)
        assert nxt - first == (hi - lo) * launch.per_tile
        seen = torch.zeros(stack.shape[-1], dtype=torch.int64)
        for j in range(nxt - first):
            tile = lo + j // launch.per_tile
            i0 = (j % launch.per_tile) * launch.threads
            n = max(0, min(launch.threads, block_np - i0))
            col0 = (tile - lo) * block_np + i0
            p0 = tile * block_np + i0
            rows = int(starts[tile]) * 8 + torch.arange(w)
            assert torch.equal(stack[:, :, col0:col0 + n],
                               pxm_ext[:, rows, p0:p0 + n])
            seen[col0:col0 + n] += 1
        assert torch.equal(seen, torch.ones_like(seen))


@pytest.mark.parametrize("block_np", [32, 1024])
def test_cost_launch_of_the_monolithic_stack(mono, block_np):
    """cost_grid's launch: its prep's one group of t_pad cells over the
    (3, t_pad, n_pad) stack with a zero start table (every band at cell 0),
    so block j owns stack columns [j * threads, (j + 1) * threads) and the
    blocks cover n_pad once."""
    _, t_in = _mono_inputs(mono)
    points, _, sp, grid = t_in[:4]
    prep = tk._prep_cost_mono(points, sp, grid, block_np, None)
    (pxm,), ((w, lo, hi),) = prep["pxms"], prep["groups"]
    n_pad = prep["n_pad"]
    assert pxm.shape == (3, w, n_pad) and (lo, hi) == (0, n_pad // block_np)
    assert not prep["starts"].any() and prep["starts"].numel() == hi
    launch = tk.cost_launch(prep["groups"], block_np)
    assert launch.first_blocks == (0,)
    assert launch.n_blocks * launch.threads == n_pad
    for j in range(launch.n_blocks):
        t, k = divmod(j, launch.per_tile)
        assert t * block_np + k * launch.threads == j * launch.threads


def test_cost_launch_refuses_more_than_eight_groups():
    groups = tuple((8, i, i + 1) for i in range(tk.COST_MAX_GROUPS + 1))
    assert tk.cost_launch(groups[:-1], 1024).first_blocks == tuple(
        4 * i for i in range(tk.COST_MAX_GROUPS))
    with pytest.raises(ValueError, match="at most 8 width groups"):
        tk.cost_launch(groups, 1024)


@pytest.mark.parametrize("R,K", [(7, 3), (32, 8), (5, 0)])
def test_native_of_flat_identical(R, K):
    np.testing.assert_array_equal(tk.native_of_flat(R, K),
                                  jk.native_of_flat(R, K))
    np.testing.assert_array_equal(tk.flat_of_native(R, K),
                                  jk.flat_of_native(R, K))

