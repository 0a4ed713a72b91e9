"""Port parity: the measurement entry points of ``deeparc_tpu_torch.scripts``
(the grid and tile step profilers, the band scan, the primitive scans and
the CPU DENSE_SCHUR anchor) at small sizes on the CPU.

Tolerances: the Schur pieces of ``profile_grid`` are the step's own
arithmetic, so the iterate they give equals the step's to 1e-12 relative
(float64); against the JAX step (its XLA path, the same algebra summed in
another order) the iterates agree as in tests/test_torch_rig_grid.py
(points and camera vector rtol 1e-5, atol 1e-8). The pieces of the plain
linearize rebuild its outputs bit for bit. The primitive scans' float64
rows sum the same values as ``np.add.at`` / ``np.take`` in other orders:
1e-12 of the largest value; their bf16 rows round inputs to 8 bits: 1e-2.
The tile step's two impls (kernel plain versions and the torch chunk path)
take the same step: 1e-12 relative, as chip_smoke.py phase 16a finds on
the card (3.9e-14). The CPU anchor's arithmetic is the reference script's
on the same rig: its dc and cost to 1e-10 relative."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.scripts import ceres_equiv_cpu as tce
from deeparc_tpu_torch.scripts import microbench_ops as mo
from deeparc_tpu_torch.scripts import microbench_tile_ops as mto
from deeparc_tpu_torch.scripts import profile_grid as pg
from deeparc_tpu_torch.scripts import profile_grid_band as pgb
from deeparc_tpu_torch.scripts import profile_planes as pp
from deeparc_tpu_torch.scripts import profile_tiles as pt
from torch_parity import as_np, close, grid_to_jax, params_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, want):
    got, want = as_np(got), np.asarray(want)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / scale) if scale else 0.0


@pytest.mark.parametrize("occlusion_rings,n_points", [(None, 1000), (6, 2000)])
def test_profile_grid_schur_pieces_are_the_step(occlusion_rings, n_points):
    """The Schur pieces, run in order, give the step's iterate: uniform
    (the monolithic kernels' plain versions, E with its intrinsic columns)
    and band-prepped (ext-only E)."""
    opts = SolverOptions()
    prob = pg.problem(n_points, occlusion_rings, "cpu")
    assert (prob.band is not None) == (occlusion_rings is not None)
    step, state, cam_free, lin, _ = pg.start(prob, opts)
    _, dc, dp = pg.schur_pieces(lin(), state.tr.radius, cam_free,
                                prob.free.points, opts,
                                pg.column_maps(prob.params, prob.step_kw))
    nxt, info = step(state, prob.grid, cam_free, prob.free.points)
    assert bool(info.accepted)
    assert _rel(state.points + dp, nxt.points) <= 1e-12
    assert _rel(state.cam_vec + dc, nxt.cam_vec) <= 1e-12
    assert float(torch.abs(dc).max()) > 0 and float(torch.abs(dp).max()) > 0


def test_profile_grid_schur_pieces_match_jax_step():
    from deeparc_tpu.config import SolverOptions as JOptions
    from deeparc_tpu.residuals.reprojection import flatten_camera as jflat
    from deeparc_tpu.solver import rig_grid as jrg

    opts = SolverOptions()
    prob = pg.problem(300, None, "cpu", seed=3, n_arc=4, n_ring=8)
    _, state, cam_free, lin, _ = pg.start(prob, opts)
    _, dc, dp = pg.schur_pieces(lin(), state.tr.radius, cam_free,
                                prob.free.points, opts,
                                pg.column_maps(prob.params, prob.step_kw))
    jparams, jgrid = params_to_jax(prob.params), grid_to_jax(prob.grid)
    jfree = params_to_jax(prob.free)
    step = jrg.make_grid_step(JOptions(), jparams, impl="einsum")
    jstate = jrg.init_grid_state(jparams, jgrid, JOptions(), impl="einsum")
    jnext, jinfo = step(jstate, jgrid, jflat(jfree), jfree.points)
    assert bool(jinfo.accepted)
    close(state.points + dp, jnext.points, 1e-5, 1e-8)
    close(state.cam_vec + dc, jnext.cam_vec, 1e-5, 1e-8)


def test_profile_grid_runs_on_the_cpu(capsys):
    assert pg.main(["--device", "cpu", "--n-points", "600", "--reps",
                    "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["platform"] == "cpu" and not out["banded"]
    assert list(out["schur_ms"]) == list(pg.PIECES)
    assert out["schur_pieces_sum_ms"] == pytest.approx(
        sum(out["schur_ms"].values()))
    assert out["e_shape"] == [600, 3, 240]


def test_profile_planes_pieces_rebuild_the_plain_linearize():
    """The plain linearize's pieces, as the script times them, put
    together by hand give ``linearize_grid_plain``'s outputs bit for bit
    (22 tiles of 256 points: two chunks)."""
    from deeparc_tpu_torch.kernels import rig_grid as k

    args, pxm, prep = pp.setup(5500, "cpu")
    want = k.linearize_grid_plain(*args, block_np=pp.BLOCK_NP, pxm=pxm)
    chunks = list(k._chunk_products(prep, pp.LOSS, pp.LOSS_SCALE))
    assert len(chunks) == 2 and len(pp.chains(prep)) == 2
    n_pad, t_ext = prep["pts"].shape[1], prep["tables"][0].shape[0]
    cost = torch.zeros((), dtype=torch.float64)
    pout = torch.zeros((12, n_pad), dtype=torch.float64)
    E = torch.zeros((n_pad,) + want[5].shape[1:], dtype=torch.float64)
    ghs = 0.0
    for c_val, r0, r1, J0, J1, P0, P1, rows, p0, p1 in chunks:
        cost = cost + c_val
        g_p, hpp = k._point_side(J0, J1, r0, r1)
        pout[0:3, p0:p1] = g_p.reshape(3, -1)
        pout[3:12, p0:p1] = hpp.reshape(9, -1)
        ghs = ghs + k._bin_slots(k._slot_grad(P0, P1, r0, r1),
                                 k._slot_gram(P0, P1), rows, t_ext)
        E[p0:p1] = k._e_rows(J0, J1, P0, P1, prep["tables"], rows,
                             prep["intr_frozen"])
    got = k._finish_linearize(prep["N"], cost, pout, *k._fold_slots(
        ghs, prep["T"], prep["t_pad"], 18), E)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_profile_planes_runs_on_the_cpu(capsys):
    assert pp.main(["--device", "cpu", "--n-points", "300", "--reps",
                    "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("chain_ms", "jacobians_ms", "point_side_ms", "cam_grad_ms",
                "hcc_ms", "cam_gram_ms", "E_ms", "linearize_full_ms",
                "bin_slot_system_ms", "flat_columns_ms", "cost_only_ms"):
        assert out[key] > 0, key
    assert out["n_chunks"] == 1 and out["platform"] == "cpu"


def _numpy_ref(check):
    kind, *a = check
    if kind == "take":
        src, idx = as_np(a[0]), as_np(a[1]).astype(np.int64)
        return np.take(src, idx, axis=0)
    vals, idx, n = as_np(a[0]), as_np(a[1]).astype(np.int64), a[2]
    out = np.zeros((n,) + vals.shape[1:])
    np.add.at(out, idx, vals)
    return out


@pytest.mark.parametrize("script,size", [
    (mo, dict(M=3000, N=400, C=48, W=16)),
    (mto, dict(M=8192, V=40, W=8)),
])
def test_primitive_scans_compute_the_numpy_sums(script, size):
    """Every read or write candidate with a reference gives np.take's or
    np.add.at's values (float64; bf16 rows to their own tolerance); the
    fixed-order ``sum_rows`` rows repeat bit for bit."""
    cands = script.candidates(**size, dtype=torch.float64, device="cpu")
    checked = 0
    for c in cands:
        if c.check is None:
            continue
        got = c.fn().double()
        want = _numpy_ref(c.check)
        assert got.shape == want.shape, c.name
        tol = 1e-2 if c.name.endswith("bf16") else 1e-12
        assert _rel(got, want) <= tol, c.name
        if "sum_rows" in c.name:
            assert torch.equal(c.fn(), c.fn()), c.name
        checked += 1
    assert checked >= 10
    assert any("sum_rows" in c.name for c in cands)


def test_primitive_scans_run_on_the_cpu(capsys):
    assert mo.main(["--device", "cpu", "--m", "2000", "--n", "300", "--c",
                    "32", "--matmul-n", "64", "--reps", "1"]) == 0
    assert mto.main(["--device", "cpu", "--m", "8192", "--v", "32",
                     "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    ops, tile_ops = (json.loads(x) for x in lines[-2:])
    assert "matmul_64_bf16" in ops["rows"] and ops["dtype"] == "float32"
    assert "sum_rows (M,18)->(V,18)" in tile_ops["rows"]
    for row in list(ops["rows"].values()) + list(tile_ops["rows"].values()):
        assert row["ms"] > 0 and row["gbytes"] > 0


def test_profile_grid_band_widths_match_jax_band_grid():
    from deeparc_tpu.solver.rig_band import band_grid as jband_grid

    out = pgb.run("cpu", n_points=1500, reps=1)
    _, grid = pg.rig(1500, pgb.OCCLUSION_RINGS, "cpu")
    jgrid = grid_to_jax(grid)
    for bn in pgb.BLOCK_NPS:
        want = jband_grid(jgrid, block_np=bn, cost_block_np=pgb.COST_BLOCK_NP)
        row = out[f"b{bn}"]
        assert (row["w_band"], row["w_band_cost"]) == (want.w_band,
                                                       want.w_band_cost)
        assert [list(g) for g in row["lin_groups"]] == [
            list(g) for g in want.lin_groups]
        assert row["lin"]["ms"] > 0 and row["cost"]["ms"] > 0
    assert out["lin_full"]["ms"] > 0 and out["cost_full"]["ms"] > 0


def test_profile_tiles_impls_take_the_same_step():
    kw = dict(n_points=3000, n_cameras=48, window=24, reps=1)
    got = {impl: pt.profile("cpu", impl=impl, **kw) for impl in
           ("pallas", "xla")}
    (rec_p, nxt_p, info_p), (rec_x, nxt_x, info_x) = got.values()
    assert bool(info_p.accepted) == bool(info_x.accepted)
    assert int(info_p.cg_iters) == int(info_x.cg_iters) > 0
    for a, b in ((nxt_p.points, nxt_x.points), (nxt_p.cam_vec, nxt_x.cam_vec),
                 (nxt_p.cost, nxt_x.cost)):
        assert _rel(a, b) <= 1e-12
    assert "sweep_setup_ms" in rec_p and "sweep_setup_ms" not in rec_x
    for rec in (rec_p, rec_x):
        assert set(rec["sweep_bounds"]) == set(pt.MODES)
        assert rec["step_ms"] > 0 and rec["local_tables"] == [True]


def test_profile_tiles_dual_raises():
    with pytest.raises(ValueError, match="dual"):
        pt.profile("cpu", impl="dual")


def _jax_ceres_script():
    spec = importlib.util.spec_from_file_location(
        "_ref_ceres_equiv_cpu", os.path.join(REPO, "scripts",
                                             "ceres_equiv_cpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _first_iteration(mod):
    """(dc, trial cost) of one iteration on the whole problem in
    ``mod._G``, one process."""
    g = mod._G
    S, rhs, stash = mod._phase1(0, g["points"].shape[0], 0,
                                g["obs_point"].size)
    dc = mod._reduce_and_solve([S], [rhs])
    return dc, mod._phase2(stash, dc)


def test_ceres_anchor_matches_the_reference_script():
    from deeparc_tpu.io import make_hemisphere_rig
    from deeparc_tpu.scene import from_deeparc

    rig = dict(n_points=2000, n_arc=4, n_ring=8, visibility=0.5, seed=2)
    tce.load_problem(**rig)
    dc_t, cost_t = _first_iteration(tce)
    ref = _jax_ceres_script()
    data = make_hemisphere_rig(
        n_arc=4, n_ring=8, n_points=2000, visibility=0.5, pixel_noise=1.0,
        point_noise=0.02, seed=2).data
    scene = from_deeparc(data)
    idx, p = scene.index, scene.params
    W = lambda a: np.array(a, copy=True)
    ref._G.update(
        obs_point=W(idx.obs_point), outer=W(idx.obs_outer),
        inner=W(idx.obs_inner), intr=W(idx.obs_intr), xy=W(idx.obs_xy),
        ext_rot=W(p.ext_rot), ext_trans=W(p.ext_trans), center=W(p.center),
        focal=W(p.focal), dist=W(p.dist), points=W(p.points),
        fsh=W(idx.focal_shared), dm1=W(idx.dist_m1), dm2=W(idx.dist_m2),
        C=6 * p.ext_rot.shape[0], R_rows=p.ext_rot.shape[0])
    dc_j, cost_j = _first_iteration(ref)
    assert tce._G["obs_point"].size == ref._G["obs_point"].size > 0
    assert _rel(dc_t, dc_j) <= 1e-10
    assert abs(cost_t - cost_j) <= 1e-10 * abs(cost_j)


def test_ceres_anchor_runs_and_names_its_host(capsys):
    assert tce.main(["--n-points", "1000", "--n-arc", "4", "--n-ring", "8",
                     "--visibility", "0.5", "--reps", "1",
                     "--procs", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["iters_per_sec"] > 0 and out["platform"] == "cpu"
    d = out["detail"]
    assert d["host_cpu_model"] and d["host_cpus"] >= d["host_cpus_usable"] > 0
    assert set(d) >= {"iters_per_sec_by_procs", "parallel_efficiency",
                      "iters_per_sec_16t_est"}


def test_phase_17_checks_every_time_and_share():
    """chip_smoke.py phase 17's check of a script's JSON line: times (keys
    ``ms``, ``*_ms`` and the numbers under a ``*_ms`` key) finite and above
    0, shares at most 1.05, a refused row passing."""
    import importlib

    cs = importlib.import_module("chip_smoke")
    good = {"step_ms": 2.0, "schur_ms": {"rhs": 0.5, "be": 1.0},
            "rows": {"a": {"ms": 1.0, "hbm_share": 0.8}},
            "b512": {"lin": {"refused": "32..256-point tiles"}},
            "detail": {"seconds_per_iter": 3.0}, "launches": {"x": 0}}
    assert cs.check_numbers("t", good) == 6
    for bad in ({"schur_ms": {"rhs": 0.0}}, {"step_ms": float("nan")},
                {"rows": [{"peak_share": 1.2}]}, {"ms": -1.0}):
        with pytest.raises(AssertionError):
            cs.check_numbers("t", bad)


def test_phase_17_allows_only_the_512_point_linearize_refusal():
    """chip_smoke.py phase 17 lets a row hold a refusal in place of a time
    only for the banded linearize at 512-point tiles."""
    import importlib

    cs = importlib.import_module("chip_smoke")
    rec = {"lin_full": {"ms": 1.0},
           "b256": {"lin": {"ms": 2.0}, "cost": {"refused": "x"}},
           "b512": {"lin": {"refused": "32..256-point tiles"},
                    "cost": {"ms": 1.0}},
           "b1024": {"declined": "no locality"}}
    assert sorted(cs.refusals(rec)) == ["b1024", "b256.cost", "b512.lin"]
    assert cs.REFUSALS_ALLOWED == {"profile_grid_band": {"b512.lin"}}


def test_profile_grid_band_rows_refuse_only_the_tile_and_check_shares():
    """A band scan row holds a refusal only where it may and only for the
    tile; any other error raises, and so does a bound faster than the
    time (a wrong count)."""
    cpu = torch.device("cpu")
    msg = "the linearize kernel takes 32..256-point tiles, not 512"

    def raising(text):
        def fn():
            raise ValueError(text)
        return fn

    row = lambda fn, moved, refuse: pgb._row(
        fn, 1, cpu, moved, 1, "linearize_grid_banded", "b512.lin",
        may_refuse=refuse)
    assert row(raising(msg), 0, True) == {"refused": msg}
    for fn, refuse in ((raising(msg), False),
                       (raising("band start outside the cell table"), True)):
        with pytest.raises(ValueError):
            row(fn, 0, refuse)
    ones = lambda: torch.ones(8, dtype=torch.float64)
    assert 0 < row(ones, 64, True)["share"] <= 1.05
    with pytest.raises(AssertionError, match="count is wrong"):
        row(ones, 10 ** 15, True)
