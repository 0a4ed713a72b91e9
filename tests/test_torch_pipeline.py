"""Port parity: the whole pipeline (PyTorch port on the CPU vs JAX
``run_pipeline(engine="grid")``), the CLI, and the port's independence
from JAX.

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
from deeparc_tpu.pipeline.driver import run_pipeline as jrun_pipeline
from deeparc_tpu_torch.pipeline import run_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_shared.deeparc")


def _compare(data, opts, tmp_path, capsys, atol=0.0):
    want = jrun_pipeline(data, dataclasses.replace(opts, engine="grid"),
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


@pytest.mark.parametrize("engine", ["tiles", "indexed", "grid-sharded"])
def test_unported_engines_name_their_roadmap_item(engine):
    rig = make_hemisphere_rig(n_arc=2, n_ring=3, n_points=20, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        run_pipeline(rig.data, PipelineOptions(engine=engine), device="cpu")


def test_cli_runs_without_jax(tmp_path):
    """The port and its CLI import no JAX: --help, then a small synthetic
    run on the CPU, in a fresh interpreter."""
    code = (
        "import sys\n"
        "import deeparc_tpu_torch.pipeline.cli as cli\n"
        "import deeparc_tpu_torch.kernels.build, deeparc_tpu_torch.io\n"
        "try:\n"
        "    cli.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        f"assert cli.main(['--synthetic', '--n-arc', '3', '--n-ring', '4',"
        f" '--n-points', '40', '--device', 'cpu', '--quiet',"
        f" '--max-iterations', '5', '-o', {str(tmp_path)!r}]) == 0\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "usage: deeparc-tpu-torch" in res.stdout
    assert "NO_JAX_OK" in res.stdout
    assert os.path.exists(tmp_path / "synthetic_output.deeparc")


def test_cpu_run_launches_no_kernel():
    """On CPU tensors every wrapper runs its plain version: a whole
    pipeline run leaves the kernels' launch counters at 0."""
    from deeparc_tpu_torch.kernels import rig_grid as tk

    tk.reset_launch_counts()
    rig = make_hemisphere_rig(n_arc=3, n_ring=16, n_points=200,
                              occlusion_rings=4, visibility=0.9,
                              pixel_noise=0.5, seed=1)
    run_pipeline(rig.data, PipelineOptions(write_snapshots=False),
                 device="cpu", verbose=False)
    assert all(fn.launches == 0 for fn in tk.KERNEL_WRAPPERS)


def test_cuda_device_without_a_card_fails_loudly():
    """Asking for the card where there is none raises; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from deeparc_tpu_torch.pipeline.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--synthetic", "--n-points", "20", "--device", "cuda"])
