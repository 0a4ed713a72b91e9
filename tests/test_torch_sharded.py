"""Port parity: the sharded engines (``deeparc_tpu_torch.parallel``, gloo
groups of spawned CPU ranks, the kernels' plain versions) against
``deeparc_tpu.parallel`` on the virtual CPU mesh of the same size.

Tolerances are tests/test_dist.py's: iterations equal, cost rtol 1e-9,
points and camera vector rtol 1e-7 / atol 1e-9 (both sum the same terms
over the shards in another order). The port's ``driver="while_loop"``
solves run the Python driver's step in blocks: the same bits. The host-side layout helpers are the
same numpy arithmetic: equal element for element. The pipelines: the same
filter rounds and points alive, final cost rtol 1e-9.

The reference's sharded tile solve returns its points in shard-major
order where a layout has more than one bucket (its row map is applied as
a mask, not as a scatter): the comparison puts them back in the caller's
order through the same row map; the port returns the caller's order."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist as td
from deeparc_tpu.config import PipelineOptions as JPipelineOptions
from deeparc_tpu.config import SolverOptions as JSolverOptions
from deeparc_tpu.config import FilterOptions as JFilterOptions
from deeparc_tpu.parallel import make_mesh as jmake_mesh
from deeparc_tpu.parallel import shard_scene as jshard_scene
from deeparc_tpu.parallel import solve_ba_sharded as jsolve_ba_sharded
from deeparc_tpu.parallel.sharded_grid import (
    shard_grid_rows as jshard_grid_rows,
    solve_ba_grid_sharded as jsolve_grid_sharded,
)
from deeparc_tpu.parallel.sharded_tiles import (
    shard_tile_rows as jshard_tile_rows,
    solve_ba_tiles_sharded as jsolve_tiles_sharded,
)
from deeparc_tpu.pipeline.driver import run_pipeline as jrun_pipeline
from deeparc_tpu.residuals.reprojection import flatten_camera as jflatten
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver.rig_grid import grid_from_scene as jgrid_from_scene
from deeparc_tpu.solver.tiles import tiles_from_scene as jtiles_from_scene
from deeparc_tpu_torch.parallel.sharded_ba import shard_scene
from deeparc_tpu_torch.parallel.sharded_grid import shard_grid_rows
from deeparc_tpu_torch.parallel.sharded_tiles import shard_tile_rows
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
from deeparc_tpu_torch.solver.rig_grid import grid_from_scene
from deeparc_tpu_torch.solver.tiles import tiles_from_scene
from torch_parity import as_np

RANKS = (2, 4)
ENGINES = ("grid-sharded", "tiles-sharded")


def _jopts(opts):
    return JSolverOptions(**dataclasses.asdict(opts))


def _jscene(data):
    scene = jfrom_deeparc(data)
    return scene, jfreeze(scene)


def _jtiles(data):
    scene, free = _jscene(data)
    tiles, params_t, free_t = jtiles_from_scene(scene, free,
                                                chunk_obs=td.TILE_CHUNK)
    return free, tiles, params_t, free_t


def _jax_solves(n):
    """The reference's sharded solves on an n-device mesh, as numpy."""
    mesh = jmake_mesh(n)
    scene, free = _jscene(td.rig_data())
    out = {}
    g = jsolve_grid_sharded(scene.params, jgrid_from_scene(scene), free,
                            _jopts(td.GRID_OPTS), mesh, chunk_size=16)
    out["grid"] = dict(points=np.asarray(g.params.points),
                       cam_vec=np.asarray(jflatten(g.params)),
                       cost=float(g.cost), iterations=int(g.iterations))
    i = jsolve_ba_sharded(jshard_scene(scene, free, n),
                          _jopts(td.INDEXED_OPTS), mesh)
    out["indexed"] = dict(points=np.asarray(i.points),
                          cam_vec=np.asarray(i.cam_vec), cost=float(i.cost),
                          iterations=int(i.iterations))
    tfree, tiles, params_t, free_t = _jtiles(td.bal_data())
    t = jsolve_tiles_sharded(params_t, tiles, free_t, jflatten(tfree),
                             _jopts(td.TILE_OPTS), mesh=mesh,
                             chunk_obs=td.TILE_CHUNK, impl="xla")
    orig = jshard_tile_rows(params_t, tiles, free_t, n, td.TILE_CHUNK)[3]
    points = np.empty_like(np.asarray(params_t.points))
    points[orig[orig >= 0]] = np.asarray(t.params.points)
    out["tiles"] = dict(points=points, cam_vec=np.asarray(jflatten(t.params)),
                        cost=float(t.cost), iterations=int(t.iterations))
    return out


def _jax_pipeline(engine, n):
    o = td._pipeline_opts(engine, n)
    opts = JPipelineOptions(
        solver=_jopts(o.solver),
        filter=JFilterOptions(**dataclasses.asdict(o.filter)),
        max_filter_rounds=o.max_filter_rounds, write_snapshots=False,
        engine=engine, devices=n)
    res = jrun_pipeline(td.pipeline_data(engine), opts, verbose=False)
    return dict(rounds=res.filter_rounds, n_points=res.scene.n_points,
                final_cost=float(res.final_cost))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of this file, started together; the reference runs in
    this process meanwhile. {n: rank 0's results}, {n: the reference's}."""
    tmp = tmp_path_factory.mktemp("sharded")
    work = tmp / "work"
    work.mkdir()
    calls = {2: (("sharded_solves", ()),
                 ("pipelines", (ENGINES, str(tmp / "pipeline"))),
                 ("operational", (str(work),))),
             4: (("sharded_solves", ()),)}
    groups = {n: td.spawn(td.several, n, tmp, calls[n]) for n in RANKS}
    want = {n: _jax_solves(n) for n in RANKS}
    want["pipelines"] = {e: _jax_pipeline(e, 2) for e in ENGINES}
    got = {n: g.result() for n, g in groups.items()}
    return got, want, tmp


def _close(got, want, keys=("points", "cam_vec")):
    assert got["iterations"] == want["iterations"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-9)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_grid_matches_jax(runs, n):
    got, want, _ = runs
    _close(got[n]["sharded_solves"]["grid"], want[n]["grid"])


@pytest.mark.parametrize("n", RANKS)
def test_sharded_indexed_matches_jax(runs, n):
    got, want, _ = runs
    _close(got[n]["sharded_solves"]["indexed"], want[n]["indexed"])


@pytest.mark.parametrize("n", RANKS)
def test_sharded_tiles_matches_jax(runs, n):
    got, want, _ = runs
    _close(got[n]["sharded_solves"]["tiles"], want[n]["tiles"])


@pytest.mark.parametrize("n", RANKS)
def test_sharded_grid_matches_port_monolithic(runs, n):
    """The sharded grid solve against the port's own single-device solve on
    the monolithic kernels (``band_reuse={"prep": None}`` skips the band
    prep)."""
    got, _, _ = runs
    solves = got[n]["sharded_solves"]
    _close(solves["grid"], solves["grid_single"])


SOLVES = ("grid", "indexed", "tiles")


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", SOLVES)
def test_sharded_while_loop_gives_the_python_drivers_bits(runs, n, name):
    """``driver="while_loop"`` runs the same step as the Python driver, in
    blocks (the indexed solve in one): the same bits on every rank count."""
    solves = runs[0][n]["sharded_solves"]
    got, want = solves[f"{name}_while_loop"], solves[name]
    assert got["iterations"] == want["iterations"]
    assert got["cost"] == want["cost"]
    for key in ("points", "cam_vec"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", SOLVES)
def test_sharded_while_loop_matches_jax(runs, n, name):
    """Against the reference's sharded solves, which run only as
    ``lax.while_loop`` blocks."""
    got, want, _ = runs
    _close(got[n]["sharded_solves"][f"{name}_while_loop"], want[n][name])


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_pipeline_matches_jax(runs, engine):
    got, want, tmp = runs
    g = got[2]["pipelines"][engine]
    w = want["pipelines"][engine]
    assert g["rounds"] == w["rounds"]
    assert g["n_points"] == w["n_points"]
    np.testing.assert_allclose(g["final_cost"], w["final_cost"], rtol=1e-9)
    assert g["final_rmse_px"] < 2.0
    # rank 0 alone writes the outputs
    assert os.path.exists(tmp / "pipeline" / "0" /
                          f"{engine}_output.deeparc")
    assert not os.path.exists(tmp / "pipeline" / "1")


@pytest.mark.parametrize("engine", ["grid", "tiles"])
def test_sharded_operational_parity(runs, engine):
    """The counterparts of tests/test_utils.py's sharded operational tests:
    a zero wall-clock budget runs no iteration on any rank, rank 0 alone
    writes the checkpoint and the log (one line per iteration), and a
    resumed solve continues to the uninterrupted solve's cost."""
    got, _, tmp = runs
    rec = got[2]["operational"][engine]
    assert rec["zero_budget"] == 0
    assert rec["wrote_checkpoint"]
    assert rec["a_iterations"] == 2
    assert rec["log_events"] == ["lm_iteration"] * 2
    work = tmp / "work"
    assert os.path.exists(work / f"{engine}_ck_0.npz")
    assert not os.path.exists(work / f"{engine}_ck_1.npz")
    assert not os.path.exists(work / f"{engine}_log_1.jsonl") or \
        os.path.getsize(work / f"{engine}_log_1.jsonl") == 0
    assert rec["b_iterations"] >= rec["a_iterations"]
    np.testing.assert_allclose(rec["b_cost"], rec["full_cost"], rtol=1e-12)


@pytest.mark.parametrize("engine", ["grid", "tiles"])
def test_sharded_while_loop_operational(runs, engine):
    """``driver="while_loop"`` in blocks of 2: a zero wall-clock budget runs
    no iteration on any rank; rank 0 alone writes the checkpoint after
    every block and one ``lm_block`` log line a block (iteration, cost,
    radius, status; no ``lm_iteration`` lines); a solve resumed from the
    checkpoint of iteration 3 ends on the uninterrupted 5-iteration
    solve's bits."""
    got, _, tmp = runs
    rec = got[2]["operational"][f"{engine}_while_loop"]
    assert rec["zero_budget"] == 0
    assert rec["wrote_checkpoint"]
    assert (rec["a_iterations"], rec["b_iterations"]) == (3, 5)
    assert [r["event"] for r in rec["log"]] == ["lm_block"] * 2
    assert [r["iter"] for r in rec["log"]] == [2, 3]
    assert all({"cost", "radius", "status"} <= set(r) for r in rec["log"])
    work, tag = tmp / "work", f"{engine}_while_loop"
    assert os.path.exists(work / f"{tag}_ck_0.npz")
    assert not os.path.exists(work / f"{tag}_ck_1.npz")
    assert not os.path.exists(work / f"{tag}_log_1.jsonl") or \
        os.path.getsize(work / f"{tag}_log_1.jsonl") == 0
    full, resumed = rec["full"], rec["b"]
    assert resumed["cost"] == full["cost"]
    for key in ("points", "cam_vec"):
        np.testing.assert_array_equal(resumed[key], full[key], err_msg=key)


def _layouts(n, helper):
    """(port outputs, reference outputs) of one layout helper, as flat
    lists of arrays."""
    if helper == "shard_scene":
        data = td.rig_data()
        scene = from_deeparc(data, device="cpu")
        jscene, jfree = _jscene(data)
        return (list(shard_scene(scene, freeze_masks(scene), n)),
                list(jshard_scene(jscene, jfree, n)))
    if helper == "shard_grid_rows":
        data = td.rig_data()
        scene = from_deeparc(data, device="cpu")
        free = freeze_masks(scene)
        p, g, pf, N = shard_grid_rows(scene.params, grid_from_scene(scene),
                                      free.points, n)
        jscene, jfree = _jscene(data)
        jp, jg, jpf, jN = jshard_grid_rows(jscene.params,
                                           jgrid_from_scene(jscene),
                                           jfree.points, n)
        fields = ("xy0", "xy1", "mask", "point_mask")
        return ([p.points, pf, N] + [getattr(g, f) for f in fields],
                [jp.points, jpf, jN] + [getattr(jg, f) for f in fields])
    data = td.bal_data()
    scene = from_deeparc(data, device="cpu")
    tiles, params_t, free_t = tiles_from_scene(scene, freeze_masks(scene),
                                               chunk_obs=td.TILE_CHUNK)
    p, t, pf, orig = shard_tile_rows(params_t, tiles, free_t, n,
                                     td.TILE_CHUNK)
    _, jtiles, jparams_t, jfree_t = _jtiles(data)
    jp, jt, jpf, jorig = jshard_tile_rows(jparams_t, jtiles, jfree_t, n,
                                          td.TILE_CHUNK)

    def planes(tl):
        return [a for b in tl.buckets
                for a in (b.cell, b.xy0, b.xy1, b.mask, *b.loc)]

    return ([p.points, pf, orig] + planes(t),
            [jp.points, jpf, jorig] + planes(jt))


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("helper", ["shard_scene", "shard_grid_rows",
                                    "shard_tile_rows"])
def test_layout_helpers_match_jax(helper, n):
    got, want = _layouts(n, helper)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(as_np(g), np.asarray(w),
                                      err_msg=f"{helper} output {i}")


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, as a sharded entry point
    starts one; destroyed after the test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _one_step(engine, reducer):
    """One LM step of the grid or tile engine on td's problems, with or
    without a reducer; the next state."""
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.solver import rig_grid as rg
    from deeparc_tpu_torch.solver import tiles as tl

    if engine == "grid":
        scene = from_deeparc(td.rig_data(), device="cpu")
        free = freeze_masks(scene)
        grid = grid_from_scene(scene)
        pxm = rg.mono_stack(grid, (256, 1024))
        st = rg.init_grid_state(scene.params, grid, td.GRID_OPTS, pxm=pxm,
                                reducer=reducer)
        step = rg.make_grid_step(td.GRID_OPTS, scene.params, pxm=pxm,
                                 reducer=reducer)
        return step(st, grid, flatten_camera(free), free.points)[0]
    scene, free, tiles, params_t, free_t = td._tile_layout(td.bal_data())
    cam_free = flatten_camera(free)
    st = tl.init_tile_state(params_t, tiles, td.TILE_OPTS, cam_free,
                            reducer=reducer)
    step = tl.make_tile_step(td.TILE_OPTS, params_t, reducer=reducer)
    return step(st, tiles, cam_free, free_t)[0]


@pytest.mark.parametrize("engine", ["grid", "tiles"])
def test_one_rank_sharded_step_gives_the_unsharded_bits(one_rank_group,
                                                        engine):
    """On one rank the sharded step's collectives sum nothing: the next
    state's points, camera vector and cost are the single-device step's
    bits (the symmetric sums move the triangle the Cholesky reads)."""
    from deeparc_tpu_torch.parallel.multihost import Reducer, start_group

    start_group("cpu")
    red = Reducer()
    a, b = _one_step(engine, None), _one_step(engine, red)
    for field in ("points", "cam_vec", "cost"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    assert red.calls > 0 and red.bytes > 0


def test_one_rank_sharded_indexed_while_loop(one_rank_group):
    """``solve_ba_sharded(driver="while_loop")`` on a one-rank gloo group:
    the whole solve as one block gives the Python driver's bits; an
    unknown driver raises."""
    from deeparc_tpu_torch.parallel.multihost import start_group
    from deeparc_tpu_torch.parallel.sharded_ba import solve_ba_sharded

    start_group("cpu")
    scene, free = td._scene(td.rig_data())
    sharded = shard_scene(scene, free, 1)
    py = solve_ba_sharded(sharded, td.INDEXED_OPTS, device="cpu")
    wl = solve_ba_sharded(sharded, td.INDEXED_OPTS, device="cpu",
                          driver="while_loop")
    assert (wl.iterations, wl.status) == (py.iterations, py.status)
    assert 0 < py.iterations <= td.INDEXED_OPTS.max_iterations
    for field in ("points", "cam_vec", "cost"):
        assert torch.equal(getattr(wl, field), getattr(py, field)), field
    with pytest.raises(ValueError, match="unknown driver"):
        solve_ba_sharded(sharded, td.INDEXED_OPTS, device="cpu",
                         driver="scan")


def test_cli_grid_sharded_runs_on_one_rank(one_rank_group, tmp_path, capsys):
    from deeparc_tpu_torch.pipeline.cli import main

    assert main(["--synthetic", "--n-arc", "3", "--n-ring", "4",
                 "--n-points", "40", "--device", "cpu", "--engine",
                 "grid-sharded", "--devices", "1", "--max-iterations", "5",
                 "--no-snapshots", "-o", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "engine=grid-sharded" in out and "process group: world size 1" in out
    assert os.path.exists(tmp_path / "synthetic_output.deeparc")


def test_cli_devices_past_the_world_raises(one_rank_group):
    """``--devices 2`` in a one-rank world names the torchrun command."""
    from deeparc_tpu_torch.pipeline.cli import main

    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        main(["--synthetic", "--n-points", "20", "--device", "cpu",
              "--engine", "grid-sharded", "--devices", "2"])
