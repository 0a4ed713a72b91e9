"""Port parity: the multi-host helpers and grid solve
(``deeparc_tpu_torch.parallel.multihost``) in a gloo group of four
spawned CPU ranks that join it from torchrun's environment (two a host,
so a (2 hosts, 2 chips) mesh), against the
single-device solve of tests/test_multihost.py (cost rtol 1e-9, the same
iterations), its ``driver="while_loop"`` form against its Python driver
(the same bits); and ``dryrun_multichip`` on one rank."""

import numpy as np
import pytest
import torch.distributed as dist

import torch_dist as td
from deeparc_tpu.config import SolverOptions
from deeparc_tpu.io.synthetic import make_hemisphere_rig
from deeparc_tpu.scene import freeze_masks, from_deeparc
from deeparc_tpu.solver.rig_grid import grid_from_scene, solve_ba_grid


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    # four ranks started as torchrun starts them, two a host
    group = td.spawn_torchrun(td.multihost, 4, 2,
                              tmp_path_factory.mktemp("multihost"))
    rig = make_hemisphere_rig(n_arc=3, n_ring=4, n_points=64,
                              pixel_noise=0.3, point_noise=0.02, seed=11)
    scene = from_deeparc(rig.data)
    single = solve_ba_grid(scene.params, grid_from_scene(scene),
                           freeze_masks(scene),
                           SolverOptions(max_iterations=4),
                           driver="while_loop", chunk_size=16)
    return group.result(), single


def test_host_mesh_and_host_local_rows(four_ranks):
    """A (2, 2) mesh named ("host", "chip"); each rank loads its rows of a
    table (``host_point_slice``, ``global_from_host_local``) and
    ``gather_global`` puts the whole table back together."""
    got, _ = four_ranks
    assert got["mesh_shape"] == (2, 2)
    assert got["dim_names"] == ("host", "chip")
    assert got["rows"] % 4 == 0
    np.testing.assert_array_equal(got["gathered"], got["table"])


def test_multihost_solve_matches_single_device(four_ranks):
    got, single = four_ranks
    res = got["result"]
    assert res["iterations"] == single.iterations
    np.testing.assert_allclose(res["cost"], float(single.cost), rtol=1e-9)
    np.testing.assert_allclose(res["points"],
                               np.asarray(single.params.points), rtol=1e-7,
                               atol=1e-9)


def test_multihost_while_loop_gives_the_python_drivers_bits(four_ranks):
    """``driver="while_loop"`` (blocks of 3) passed through to the sharded
    grid solve: the Python driver's bits on the (2, 2) mesh."""
    got, _ = four_ranks
    a, b = got["result_while_loop"], got["result"]
    assert (a["iterations"], a["cost"]) == (b["iterations"], b["cost"])
    for key in ("points", "cam_vec"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_dryrun_multichip_one_rank_on_cpu(capsys):
    from deeparc_tpu_torch.parallel.dryrun import main

    try:
        assert main(["1", "--device", "cpu"]) == 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out = capsys.readouterr().out
    assert "dryrun_multichip(1): ok" in out
