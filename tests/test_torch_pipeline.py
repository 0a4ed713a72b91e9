"""Port parity: the whole pipeline (PyTorch port on the CPU vs JAX
``run_pipeline`` on the grid and the tile engine), the CLI, the port's
generators, and the port's independence from JAX and from ``deeparc_tpu``.

Tolerances: both runs iterate the same LM to the same tolerances from the
same data, so final_cost rtol 1e-6 and final_rmse_px rtol 1e-5; the
filter-round count and the surviving points are equal."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeparc_tpu.config import FilterOptions, PipelineOptions, SolverOptions
from deeparc_tpu.io import make_hemisphere_rig, read_deeparc
from deeparc_tpu.io import synthetic as jsynthetic
from deeparc_tpu.pipeline.driver import run_pipeline as jrun_pipeline
from deeparc_tpu_torch.io import synthetic as tsynthetic
from deeparc_tpu_torch.pipeline import run_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_shared.deeparc")
GOLDEN_NONSHARED = os.path.join(REPO, "tests", "fixtures",
                                "golden_nonshared.deeparc")


def _compare(data, opts, tmp_path, capsys, atol=0.0, engine="grid"):
    want = jrun_pipeline(data, dataclasses.replace(opts, engine=engine),
                         verbose=False)
    progress = dataclasses.replace(
        opts, solver=dataclasses.replace(opts.solver, progress_to_stdout=True))
    got = run_pipeline(data, progress, output_dir=str(tmp_path),
                       basename="t", device="cpu", verbose=True)
    out = capsys.readouterr().out
    assert got.filter_rounds == want.filter_rounds
    assert got.scene.n_points == want.scene.n_points
    np.testing.assert_allclose(got.final_cost, want.final_cost, rtol=1e-6,
                               atol=atol)
    np.testing.assert_allclose(got.final_rmse_px, want.final_rmse_px,
                               rtol=1e-5, atol=atol)
    back = read_deeparc(str(tmp_path / "t_output.deeparc"))
    assert back.n_points == got.scene.n_points
    return got, out


def test_pipeline_occlusion_rig_matches_jax(tmp_path, capsys):
    rig = make_hemisphere_rig(n_arc=3, n_ring=16, n_points=420,
                              occlusion_rings=4, visibility=0.9,
                              pixel_noise=0.8, point_noise=0.02, seed=5)
    opts = PipelineOptions(solver=SolverOptions(max_iterations=20),
                           write_snapshots=True)
    got, out = _compare(rig.data, opts, tmp_path, capsys)
    assert "live-band solve" in out          # the band path was taken
    assert got.final_rmse_px < 2 * 0.8
    assert os.path.exists(tmp_path / "t_clear.ply")


def test_pipeline_golden_shared_matches_jax(tmp_path, capsys):
    opts = PipelineOptions(solver=SolverOptions(max_iterations=10),
                           filter=FilterOptions(hemisphere_cut=False),
                           write_snapshots=False)
    # the hand-authored scene is exact: both runs end at round-off (cost
    # ~1e-16), where only an absolute tolerance means anything
    got, _ = _compare(read_deeparc(GOLDEN), opts, tmp_path, capsys, atol=1e-9)
    assert got.final_rmse_px < 1e-6


def test_cli_runs_without_jax(tmp_path):
    """The port imports neither JAX nor ``deeparc_tpu`` nor the repo's
    top-level ``scripts`` (its own entry points are
    ``deeparc_tpu_torch.scripts``): in a fresh interpreter, import every
    module of the port (the sharded engines of ``parallel`` among them),
    run the CLI's --help and a small synthetic run on the CPU, then
    inspect ``sys.modules``."""
    code = (
        "import pkgutil, sys\n"
        "import deeparc_tpu_torch\n"
        "for m in pkgutil.walk_packages(deeparc_tpu_torch.__path__,\n"
        "                               'deeparc_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "import deeparc_tpu_torch.pipeline.cli as cli\n"
        "try:\n"
        "    cli.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        f"assert cli.main(['--synthetic', '--n-arc', '3', '--n-ring', '4',"
        f" '--n-points', '40', '--device', 'cpu', '--quiet',"
        f" '--max-iterations', '5', '-o', {str(tmp_path)!r}]) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'deeparc_tpu' or m.startswith('deeparc_tpu.')\n"
        "       or m == 'scripts' or m.startswith('scripts.')]\n"
        "assert not bad, f'the port imported {bad[:5]}'\n"
        "assert 'deeparc_tpu_torch.scripts.vpu_roofline' in sys.modules\n"
        "for m in ('profile_grid', 'profile_grid_band', 'profile_planes',\n"
        "          'profile_tiles', 'microbench_ops', 'microbench_tile_ops',\n"
        "          'ceres_equiv_cpu'):\n"
        "    assert 'deeparc_tpu_torch.scripts.' + m in sys.modules, m\n"
        "for m in ('multihost', 'sharded_ba', 'sharded_grid',\n"
        "          'sharded_tiles', 'dryrun'):\n"
        "    assert 'deeparc_tpu_torch.parallel.' + m in sys.modules, m\n"
        "print('NO_JAX_OK', len([m for m in sys.modules\n"
        "                        if m.startswith('deeparc_tpu_torch.')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "usage: deeparc-tpu-torch" in res.stdout
    assert "NO_JAX_OK" in res.stdout
    assert os.path.exists(tmp_path / "synthetic_output.deeparc")


def test_cpu_run_launches_no_kernel():
    """On CPU tensors every wrapper runs its plain version: whole pipeline
    runs on the grid and the tile engine leave every launch counter at 0."""
    from deeparc_tpu_torch import kernels as tk

    tk.reset_launch_counts()
    rig = make_hemisphere_rig(n_arc=3, n_ring=16, n_points=200,
                              occlusion_rings=4, visibility=0.9,
                              pixel_noise=0.5, seed=1)
    run_pipeline(rig.data, PipelineOptions(write_snapshots=False),
                 device="cpu", verbose=False)
    bal = tsynthetic.make_bal_synthetic(n_cameras=8, n_points=60, seed=2)
    run_pipeline(bal.data, PipelineOptions(write_snapshots=False),
                 device="cpu", verbose=False)
    assert len(tk.KERNEL_WRAPPERS) == 8
    assert all(fn.launches == 0 for fn in tk.KERNEL_WRAPPERS)


def test_cuda_device_without_a_card_fails_loudly():
    """Asking for the card where there is none raises; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from deeparc_tpu_torch.pipeline.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--synthetic", "--n-points", "20", "--device", "cuda"])


def _bal_opts():
    return PipelineOptions(
        solver=SolverOptions(linear_solver="iterative_schur",
                             max_iterations=8, cg_max_iterations=40),
        filter=FilterOptions(error_boundary=5.0, hemisphere_cut=True),
        max_filter_rounds=3, write_snapshots=False)


def test_pipeline_bal_scene_uses_tiles_matches_jax(tmp_path, capsys):
    """The problem of tests/test_pipeline.py:257-268: engine='auto' takes
    the tile engine on a non-shared scene."""
    rig = jsynthetic.make_bal_synthetic(
        n_cameras=10, n_points=150, track_length=5.0, pixel_noise=0.5,
        point_noise=0.05, seed=7)
    got, out = _compare(rig.data, _bal_opts(), tmp_path, capsys,
                        engine="tiles")
    assert "engine=tiles" in out and "kernels=plain torch" in out
    assert got.final_rmse_px < 2.0
    assert got.cg_iterations > 0


def test_pipeline_golden_nonshared_matches_jax(tmp_path, capsys):
    opts = PipelineOptions(solver=SolverOptions(max_iterations=10),
                           filter=FilterOptions(hemisphere_cut=False),
                           write_snapshots=False)
    # the hand-authored scene is exact to its 6 written decimals
    got, out = _compare(read_deeparc(GOLDEN_NONSHARED), opts, tmp_path,
                        capsys, atol=1e-9, engine="tiles")
    assert "engine=tiles" in out
    assert got.final_rmse_px < 1e-5


def _write_bal(path, data):
    """A BAL file of a non-shared synthetic scene: BAL has no principal
    point and projects with -f, so observations are shifted to the centre
    and the focal length is stored negated."""
    cam = np.concatenate([data.ext_rot, data.ext_trans, -data.focal[:, :1],
                          data.dist], axis=1)
    xy = data.obs_xy - data.center[data.obs_arc]
    with open(path, "w") as f:
        f.write(f"{cam.shape[0]} {data.n_points} {data.n_obs}\n")
        for c, p, (x, y) in zip(data.obs_arc, data.obs_point, xy):
            f.write(f"{c} {p} {x:.17g} {y:.17g}\n")
        for v in np.concatenate([cam.reshape(-1), data.points.reshape(-1)]):
            f.write(f"{v:.17g}\n")


def test_cli_reads_bal_on_cpu(tmp_path, capsys):
    from deeparc_tpu_torch.pipeline.cli import main

    rig = tsynthetic.make_bal_synthetic(n_cameras=8, n_points=80,
                                        pixel_noise=0.3, point_noise=0.02,
                                        seed=4)
    path = str(tmp_path / "scene.bal")
    _write_bal(path, rig.data)
    assert main([path, "--device", "cpu", "--engine", "tiles",
                 "--sweep-dtype", "f32", "--linear-solver",
                 "iterative_schur", "--max-iterations", "6",
                 "--no-snapshots", "-o", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "engine=tiles" in out and "[deeparc] done" in out
    rmse = float(out.split("rmse=")[-1].split("px")[0])
    assert rmse < 2 * 0.3
    back = read_deeparc(str(tmp_path / "scene_output.deeparc"))
    assert not back.share_extrinsic and back.n_points > 0


GENERATORS = {
    "make_hemisphere_rig": dict(n_arc=3, n_ring=6, n_points=120,
                                occlusion_rings=3, visibility=0.8,
                                pixel_noise=0.5, point_noise=0.02, seed=3),
    "make_bal_synthetic": dict(n_cameras=9, n_points=70, pixel_noise=0.5,
                               point_noise=0.02, ext_noise=0.01, seed=5),
    "make_bal_windowed_host": dict(n_cameras=40, n_points=300,
                                   track_length=6, window=12, n_hubs=3,
                                   seed=6),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_port_generators_match_jax(name):
    kw = GENERATORS[name]
    got = getattr(tsynthetic, name)(**kw)
    want = getattr(jsynthetic, name)(**kw)
    got, want = getattr(got, "data", got), getattr(want, "data", want)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
