"""The grid step's Schur reduction in one pass over E
(``kernels.rig_grid.schur_reduce``, ``solver.rig_grid.schur_reduce``).

Its plain version, which the CPU runs, keeps the arithmetic of the three
pieces the step ran before it (the reduced gradient ``E2.T @ (B^-1 g_p)``,
``be = B^-1 E`` and the correction ``E2.T @ be``), kept here as the
reference: every comparison is bit for bit. The kernel itself runs on the
card only (``chip_smoke.py`` holds it against the plain version there).
"""

import dataclasses

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.kernels import rig_grid as k
from deeparc_tpu_torch.scripts import profile_grid as pg
from deeparc_tpu_torch.solver import rig_grid as rg


def _e2(sys):
    N, Cn = sys.E.shape[0], sys.E.shape[2]
    return sys.E.reshape(N * 3, Cn)


def reference_rhs(sys, binv, cam_free, to_flat, allsum):
    bg = torch.einsum("pij,pj->pi", binv, sys.g_p).reshape(-1)
    return (-sys.g_c + allsum(to_flat(_e2(sys).T @ bg))) * cam_free


def reference_be(sys, binv):
    N, Cn = sys.E.shape[0], sys.E.shape[2]
    return torch.einsum("pij,pjd->pid", binv, sys.E).reshape(N * 3, Cn)


def reference_corr(sys, be, to_flat, allsum_sym):
    return allsum_sym(to_flat(_e2(sys).T @ be))


def reference_reduce(sys, binv, cam_free, to_flat, allsum=rg._same,
                     allsum_sym=rg._same):
    """The three pieces in the order the step ran them."""
    rhs = reference_rhs(sys, binv, cam_free, to_flat, allsum)
    corr = reference_corr(sys, reference_be(sys, binv), to_flat, allsum_sym)
    return rhs, corr


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float(torch.max(torch.abs(got - want)))


def _problem(banded, seed):
    """The band-prepped 8 x 24 occlusion rig (band_grid declines smaller
    rigs), or a uniform 4 x 8 rig for the monolithic route."""
    if banded:
        return pg.problem(2000, 6, "cpu", seed=seed)
    return pg.problem(500, None, "cpu", seed=seed, n_arc=4, n_ring=8)


def _system(layout, frozen_points, partial_cams, dtype):
    """(sys, binv, cam_free, to_flat) of a small rig at its start iterate:
    ``banded`` the band-prepped occlusion rig on the kernels' path (ext-only
    E, native order), ``mono`` the uniform rig on it (E with the intrinsic
    columns), ``flat`` the uniform rig on the torch path (E in flat
    order)."""
    opts = SolverOptions()
    prob = _problem(layout == "banded", seed=5)
    free = prob.free
    if frozen_points:
        pf = free.points.clone()
        pf[::3] = 0.0
        free = dataclasses.replace(free, points=pf)
    if partial_cams:
        er = free.ext_rot.clone()
        er[1:4] = 0.0
        free = dataclasses.replace(free, ext_rot=er,
                                   ext_trans=free.ext_trans.clone())
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera

    cam_free = flatten_camera(free)
    kw = prob.step_kw
    impl = "planes" if layout == "flat" else "auto"
    bw, bb = kw.get("band_widths", (0, 0)), kw.get("band_blocks", (0, 0))
    sys = rg.assemble_grid_system(
        prob.params.points, rg.slot_params(prob.params, prob.grid),
        prob.grid, cam_free, free.points, impl=impl, band_width=bw[0],
        band_block=bb[0], band_intr_frozen=kw.get("band_intr_frozen", False),
        pxm=kw.get("pxm"))
    radius = torch.tensor(opts.initial_radius, dtype=torch.float64)
    binv, _ = rg.schur_point_blocks(sys, radius, free.points, opts)
    if layout == "flat":
        to_flat = rg.column_maps(prob.params, False, False)[0]
    else:
        to_flat = pg.column_maps(prob.params, kw)[0]
    cast = lambda t: t.to(dtype)
    sys = rg.GridSystem(*(cast(t) for t in sys))
    return sys, cast(binv), cast(cam_free), to_flat


CASES = [
    pytest.param(layout, frozen, partial, dtype,
                 id=f"{layout}{'-frozen' if frozen else ''}"
                    f"{'-partial' if partial else ''}-{str(dtype)[6:]}")
    for layout, frozen, partial in (
        ("banded", False, False), ("mono", False, False),
        ("flat", False, False), ("banded", True, False),
        ("mono", False, True))
    for dtype in (torch.float64, torch.float32)]


@pytest.mark.parametrize("layout,frozen,partial,dtype", CASES)
def test_schur_reduce_plain_is_the_three_pieces(layout, frozen, partial,
                                                dtype):
    sys, binv, cam_free, to_flat = _system(layout, frozen, partial, dtype)
    N, _, Cn = sys.E.shape
    # ext-only E on the banded route, the intrinsic columns elsewhere
    assert (Cn < cam_free.numel()) == (layout == "banded")
    if frozen:
        pf = torch.zeros(N, dtype=torch.bool)
        pf[::3] = True
        # identity rows (up to the LM diagonal's 1e-6 / radius)
        eye = torch.eye(3, dtype=dtype).expand(int(pf.sum()), 3, 3)
        assert float(torch.abs(binv[pf] - eye).max()) < 1e-9
        assert not torch.any(sys.E[pf])
    corr, v = k.schur_reduce_plain(sys.E, binv, sys.g_p)
    bg = torch.einsum("pij,pj->pi", binv, sys.g_p).reshape(-1)
    _same_bits(v, _e2(sys).T @ bg)
    _same_bits(corr, _e2(sys).T @ reference_be(sys, binv))
    # the wrapper on CPU tensors is the plain version
    for got, want in zip(k.schur_reduce(sys.E, binv, sys.g_p), (corr, v)):
        _same_bits(got, want)
    # and the solver's one call is the step's three pieces
    rhs, corr_flat = rg.schur_reduce(sys, binv, cam_free, to_flat)
    want_rhs, want_corr = reference_reduce(sys, binv, cam_free, to_flat)
    _same_bits(rhs, want_rhs)
    _same_bits(corr_flat, want_corr)
    assert float(torch.abs(corr).max()) > 0


def _fresh_state(prob, opts, cam_free, fused):
    kw = prob.step_kw
    common = dict(band_widths=kw.get("band_widths", (0, 0)),
                  band_blocks=kw.get("band_blocks", (0, 0)),
                  pxm=kw.get("pxm"))
    if fused:
        return rg.init_grid_state_fused(
            prob.params, prob.grid, opts, cam_free, prob.free.points,
            band_intr_frozen=kw.get("band_intr_frozen", False), **common)
    return rg.init_grid_state(prob.params, prob.grid, opts, **common)


@pytest.mark.parametrize("fused", [False, True], ids=["classic", "fused"])
@pytest.mark.parametrize("banded", [True, False], ids=["banded", "mono"])
def test_grid_step_keeps_the_parent_bits(monkeypatch, banded, fused):
    """Two LM steps through ``solve_and_decide`` with the one-pass
    reduction and with the three pieces give the same bits."""
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera

    opts = SolverOptions()
    prob = _problem(banded, seed=7)
    cam_free = flatten_camera(prob.free)

    def run():
        step = rg.make_grid_step(opts, prob.params, fuse_trial=fused,
                                 **prob.step_kw)
        state = _fresh_state(prob, opts, cam_free, fused)
        out = []
        for _ in range(2):
            state, info = step(state, prob.grid, cam_free, prob.free.points)
            out.append((state.points.clone(), state.cam_vec.clone(),
                        state.cost.clone(), state.tr.radius.clone(),
                        info.accepted))
        return out

    got = run()
    monkeypatch.setattr(rg, "schur_reduce", reference_reduce)
    want = run()
    assert any(bool(w[-1]) for w in want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _same_bits(torch.as_tensor(a), torch.as_tensor(b))


def _refusal_inputs(what):
    N, Cn = 40, 48
    E = torch.randn(N, 3, Cn, dtype=torch.float64)
    binv = torch.eye(3, dtype=torch.float64).repeat(N, 1, 1)
    g_p = torch.randn(N, 3, dtype=torch.float64)
    if what == "non-contiguous":
        E = torch.randn(N, 3, 2 * Cn, dtype=torch.float64)[:, :, ::2]
    elif what == "dtype":
        binv = binv.float()
    elif what == "columns":
        E = torch.randn(N, 3, Cn + 2, dtype=torch.float64)
    return E, binv, g_p


@pytest.mark.parametrize("what,error", [("non-contiguous", ValueError),
                                        ("dtype", TypeError),
                                        ("columns", ValueError)])
def test_schur_reduce_refuses(what, error):
    E, binv, g_p = _refusal_inputs(what)
    with pytest.raises(error):
        k.schur_reduce(E, binv, g_p)


# (blocks in one wave, N, Cn, slices): an H100's 132 SMs x 4 blocks at the
# main path's two shapes, fewer points than the wave's slices, a device
# smaller than the triangle's tiles, no points
@pytest.mark.parametrize("wave,N,Cn,slices", [
    (528, 400_000, 192, 88), (528, 400_000, 240, 52), (528, 37, 246, 5),
    (4, 1000, 246, 1), (528, 0, 6, 1)])
def test_schur_slices_fill_one_wave(wave, N, Cn, slices):
    assert k._schur_slices(wave, N, Cn) == slices
