"""The plain reference of BFS incremental bundle adjustment of a shared
rig, written from its description (the reference's ``*_bfs.deeparc``
datasets and the freeze-camera pre-solve of ``src/sfm.cc:111``) on
``reference.py``'s problem, masks and solver; it imports nothing of the
program.

  * cells are the rig's (arc, ring) pairs, numbered arc-major
    (``arc * n_ring + ring``);
  * the covisibility of two cells is the number of points both see;
  * the order is a breadth-first search over that graph from ``start``:
    a cell's unseen neighbours (count > 0) join the queue strongest
    first, ties by the lower index; cells never reached follow in index
    order;
  * batch b activates ``order[b * size:(b + 1) * size]``; an observation
    is active when its cell is, a point live when ``min_observations`` of
    its observations are active (two: one observation fixes a ray, not a
    point);
  * each batch runs a structure-only solve (every camera frozen, the live
    points free), then the full solve (the pipeline's full-round masks,
    the points times live), each from the previous one's answer, over the
    active observations.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference as ref


def cells_of(data) -> np.ndarray:
    """Each observation's cell, arc-major."""
    return (data.obs_arc.astype(np.int64) * data.ring_size
            + data.obs_ring.astype(np.int64))


def covisibility(data, device="cpu") -> np.ndarray:
    """(T, T) counts of the points each two cells both see, the diagonal
    zero (a float64 product: exact below 2**53)."""
    T = data.arc_size * data.ring_size
    seen = torch.zeros((data.n_points, T), dtype=torch.float64,
                       device=device)
    seen[torch.as_tensor(data.obs_point.astype(np.int64), device=device),
         torch.as_tensor(cells_of(data), device=device)] = 1.0
    counts = (seen.T @ seen).cpu().numpy().astype(np.int64)
    np.fill_diagonal(counts, 0)
    return counts


def bfs_order(counts: np.ndarray, start: int = 0) -> np.ndarray:
    """Breadth-first order over a (T, T) count matrix from ``start``:
    strongest neighbour first, ties by index; unreached cells appended in
    index order."""
    T = counts.shape[0]
    seen = [False] * T
    seen[start] = True
    order, queue, head = [], [start], 0
    while head < len(queue):
        c = queue[head]
        head += 1
        order.append(c)
        ranked = sorted((-int(counts[c, n]), n) for n in range(T)
                        if counts[c, n] > 0 and not seen[n])
        for _, n in ranked:
            seen[n] = True
            queue.append(n)
    order += [c for c in range(T) if not seen[c]]
    return np.asarray(order, dtype=np.int64)


def run(data, o: ref.Options, batch_size: int, dtype, device,
        start: int = 0, min_observations: int = 2) -> dict:
    """The whole incremental reconstruction: the final points, cameras and
    cost, the order, and per batch the active cells, live points, both
    solves' iterations and the full solve's cost."""
    prob = ref.problem(data, dtype, device)
    order = bfs_order(covisibility(data, device), start)
    cell = torch.as_tensor(cells_of(data), device=device)
    T = data.arc_size * data.ring_size
    active = torch.zeros(T, dtype=dtype, device=device)
    points, ext, intr = prob.points, prob.ext, prob.intr
    history = []
    for b in range(-(-T // batch_size)):
        active[torch.as_tensor(order[b * batch_size:(b + 1) * batch_size],
                               device=device)] = 1.0
        obs = active[cell]
        live = torch.zeros_like(points[:, 0]).index_add_(
            0, prob.obs_point, obs) >= min_observations
        live = live.to(dtype)
        structure = ref.solve(prob, points, ext, intr, obs,
                              *ref.free_masks(prob, live, True), o)
        full = ref.solve(prob, structure.points, structure.ext,
                         structure.intr, obs,
                         *ref.free_masks(prob, live, False), o)
        points, ext, intr = full.points, full.ext, full.intr
        history.append({"active_cells": int(active.sum()),
                        "live_points": int(live.sum()),
                        "structure_iterations": structure.iterations,
                        "iterations": full.iterations,
                        "cost": full.cost})
    return {"points": points, "ext": ext, "intr": intr,
            "cost": history[-1]["cost"], "order": order,
            "history": history}
