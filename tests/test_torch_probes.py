"""Port parity: the measurement probes' plain versions (the CPU path of
``kernels.probes``) against the Pallas kernels of ``scripts/vpu_roofline.py``
and ``scripts/microbench_sweep_payload.py`` in interpret mode, at the
scripts' own block shapes with 2 grid tiles; and the port's two entry
points run on the CPU at a small size.

The scripts are loaded by path, so nothing under ``scripts/`` changes.
Tolerances: XLA's CPU backend fuses each step ``a v + v`` of the FMA chains
into one FMA, as the card's kernel does, while the plain version rounds the
product and the sum separately. With |v| < 1 an earlier step's error
shrinks, so each of a chain's 64 steps adds at most one such rounding and
the chains share v's sign: rtol 64 x 2^-24 (3.8e-6) in float32, 1e-12 in
float64. The float32 contractions over 1024-8192 terms, summed in another
order: rtol 1e-5."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deeparc_tpu_torch.kernels import probes as kp
from deeparc_tpu_torch.scripts import microbench_sweep_payload as tmsp
from deeparc_tpu_torch.scripts import vpu_roofline as tvr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GRID = 2


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jvr():
    return _script("vpu_roofline")


@pytest.fixture(scope="module")
def jmsp():
    return _script("microbench_sweep_payload")


@pytest.mark.parametrize("dtype,rtol", [("float32", 64 * 2.0 ** -24),
                                        ("float64", 1e-12)])
def test_fma_pass_matches_pallas(jvr, dtype, rtol):
    rows, cols = jvr.ROWS, jvr.COLS
    x = np.random.default_rng(0).uniform(-1.0, 1.0, (rows, N_GRID * cols))
    x = x.astype(dtype)
    want = np.asarray(pl.pallas_call(
        jvr._fma_kernel, grid=(N_GRID,),
        in_specs=[pl.BlockSpec((rows, cols), lambda i: (0, i))],
        out_specs=pl.BlockSpec((rows, cols), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.dtype(dtype)),
        interpret=True)(jnp.asarray(x)))
    assert want.dtype == np.dtype(dtype)
    xt = torch.from_numpy(x)
    kp.reset_launch_counts()
    for got in (kp.fma_pass_plain(xt), kp.fma_pass(xt)):
        assert got.dtype == xt.dtype and got.shape == xt.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    assert kp.fma_pass.launches == 0
    assert kp.fma_ops(x.size) == 2 * jvr.CHAIN * x.size


@pytest.mark.parametrize("mode", ["many", "one"])
def test_sweep_payload_matches_pallas(jmsp, mode):
    """The Pallas probe's output block is the same for every grid step, so
    it returns the last tile's product; the port returns every tile's."""
    Vl, P, depth = jmsp.Vl, jmsp.P, jmsp.W * jmsp.BLOCK
    assert (Vl, P, depth) == (kp.VL, kp.P, kp.DEPTH)
    rng = np.random.default_rng(1)
    a = rng.uniform(0.0, 1.0, (Vl, N_GRID * depth)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, (P, N_GRID * depth)).astype(np.float32)
    kern = jmsp._kern_many if mode == "many" else jmsp._kern_one
    want = np.asarray(pl.pallas_call(
        kern, grid=(N_GRID,),
        in_specs=[pl.BlockSpec((Vl, depth), lambda i: (0, i)),
                  pl.BlockSpec((P, depth), lambda i: (0, i))],
        out_specs=pl.BlockSpec((Vl, P), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((Vl, P), jnp.float32),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    tiles = np.stack([a[:, t * depth:(t + 1) * depth].astype(np.float64)
                      @ b[:, t * depth:(t + 1) * depth].astype(np.float64).T
                      for t in range(N_GRID)])
    kp.reset_launch_counts()
    for got in (kp.sweep_payload_plain(at, bt, mode),
                kp.sweep_payload(at, bt, mode)):
        assert got.shape == (N_GRID, Vl, P) and got.dtype == torch.float32
        np.testing.assert_allclose(got[-1].numpy(), want, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), tiles, rtol=1e-5)
    assert kp.sweep_payload.launches == 0
    assert not np.allclose(tiles[0], tiles[-1], rtol=1e-5)


def test_vpu_roofline_entry_point_on_cpu(capsys):
    # one thread, so that other test processes' load slows the FMA plane
    # and the linearize alike and the CPU share stays a share
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tvr.main(["--device", "cpu", "--n-points", "100"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["platform"] == "cpu" and out["device"] == "cpu"
    assert out["power_limit"] is None
    assert out["dense_live_slots"] == 100 * 8 * 24
    assert out["cut"] == "n_points cut from 400000 to 100"
    for sfx in ("f32", "f64"):
        assert out[f"fma_peak_tflops_{sfx}"] > 0
        assert out[f"dense_lin_tflops_{sfx}"] > 0
        assert 0 < out[f"dense_lin_vs_fma_peak_{sfx}"] <= 1.0
        # a share of the card's published peak is a card measurement
        assert f"fma_vs_published_peak_{sfx}" not in out


def test_sweep_payload_entry_point_on_cpu(capsys):
    assert tmsp.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["platform"] == "cpu" and out["power_limit"] is None
    assert out["shape"] == "(128,1024)x(1024,18) xW=8, 2 tiles"
    assert out["bound_by"] == "bytes"
    for key in ("tflops_many_small_matmuls", "tflops_one_batched_matmul",
                "ms_many", "ms_one", "bound_ms"):
        assert out[key] > 0


def test_probe_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for run in (tvr.run, tmsp.run):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
