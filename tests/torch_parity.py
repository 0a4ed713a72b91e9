"""Helpers shared by the port's parity tests: hand one problem, as numpy
arrays, to both the JAX reference and the PyTorch port."""

import dataclasses

import numpy as np
import torch

import deeparc_tpu_torch.scene as tscene

# One intra-op thread a test process: the suite runs several processes (and
# JAX's own thread pool) on the machine's cores, and torch's OpenMP workers
# spin-waiting on cores that other processes hold cost the port's small CPU
# steps 10-100x their single-thread time. Every test worker imports this
# module while it collects the port's test files.
torch.set_num_threads(1)


def as_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def params_to_torch(params_jax, dtype=torch.float64):
    """JAX BAParams -> port BAParams through numpy."""
    d = {f.name: np.asarray(getattr(params_jax, f.name))
         for f in dataclasses.fields(params_jax)}
    return tscene.params_from_numpy(d, dtype=dtype, device="cpu")


def grid_to_torch(grid_jax, dtype=torch.float64):
    """JAX GridIndex (band tables dropped) -> port GridIndex through numpy."""
    d = {k: np.asarray(v) for k, v in grid_jax._asdict().items() if k != "band"}
    return tscene.grid_from_numpy(d, dtype=dtype, device="cpu")


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def tiles_to_torch(tiles_jax, C, dtype=torch.float64):
    """JAX TileIndex -> port TileIndex (with its slot bins and the maps of
    its sums into a camera vector of C values) through numpy."""
    d = {
        "cells": {k: np.asarray(v) for k, v in tiles_jax.cells._asdict().items()},
        "buckets": [dict(cell=np.asarray(b.cell), xy0=np.asarray(b.xy0),
                         xy1=np.asarray(b.xy1), mask=np.asarray(b.mask),
                         loc=tuple(np.asarray(a) for a in b.loc))
                    for b in tiles_jax.buckets],
        "row_of_point": np.asarray(tiles_jax.row_of_point),
    }
    return tscene.tiles_from_numpy(d, C, dtype=dtype, device="cpu")


def params_to_jax(params):
    """Port BAParams -> JAX BAParams through numpy."""
    import jax.numpy as jnp

    from deeparc_tpu.scene import BAParams

    return BAParams(**{f.name: jnp.asarray(as_np(getattr(params, f.name)))
                       for f in dataclasses.fields(params)})


def grid_to_jax(grid):
    """Port GridIndex (band tables dropped) -> JAX GridIndex through
    numpy."""
    import jax.numpy as jnp

    from deeparc_tpu.solver.rig_grid import GridIndex

    return GridIndex(**{f.name: jnp.asarray(as_np(getattr(grid, f.name)))
                        for f in dataclasses.fields(grid) if f.name != "band"})


def tiles_to_jax(tiles):
    """Port TileIndex -> JAX TileIndex (without the port's bins and maps)
    through numpy."""
    import jax.numpy as jnp

    from deeparc_tpu.solver import tiles as jt

    j = lambda a: jnp.asarray(as_np(a))
    cells = jt.CellTable(**{name: j(getattr(tiles.cells, name))
                            for name in jt.CellTable._fields})
    buckets = tuple(
        jt.TileBucket(cell=j(b.cell), xy0=j(b.xy0), xy1=j(b.xy1),
                      mask=j(b.mask), loc=tuple(j(a) for a in b.loc))
        for b in tiles.buckets)
    return jt.TileIndex(cells=cells, buckets=buckets,
                        row_of_point=j(tiles.row_of_point))
