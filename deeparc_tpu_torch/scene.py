"""Flat-array scene representation, PyTorch port of ``deeparc_tpu.scene``.

Parameters are a :class:`BAParams` dataclass of tensors, the observation
structure a :class:`SceneIndex` of int32 index tensors plus alive-masks
(removal = masking), host metadata a :class:`SceneMeta` of numpy arrays.
Every observation evaluates the composed model ``outer(inner(X))``; the
extrinsic tables carry one extra frozen identity row (index E) that
single-extrinsic observations point their inner slot at
(reference ``src/ParameterBlock.hh:75-92``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.io import DeepArcData


@dataclasses.dataclass
class BAParams:
    """Optimizable parameter tables."""

    points: torch.Tensor     # (N, 3)
    ext_rot: torch.Tensor    # (E + 1, 3) angle-axis; row E is the identity slot
    ext_trans: torch.Tensor  # (E + 1, 3)
    center: torch.Tensor     # (K, 2) principal points
    focal: torch.Tensor      # (K, 2)
    dist: torch.Tensor       # (K, 2)


@dataclasses.dataclass
class SceneIndex:
    """Static observation structure (indices, masks, measurements)."""

    obs_point: torch.Tensor   # (M,) int32
    obs_outer: torch.Tensor   # (M,) int32 extrinsic row applied second
    obs_inner: torch.Tensor   # (M,) int32 extrinsic row applied first
    obs_intr: torch.Tensor    # (M,) int32
    obs_xy: torch.Tensor      # (M, 2)
    obs_mask: torch.Tensor    # (M,) 1.0 = alive
    point_mask: torch.Tensor  # (N,) 1.0 = alive
    focal_shared: torch.Tensor  # (K,) 1.0 when focal_size == 1
    dist_m1: torch.Tensor     # (K,) 1.0 when dist_size >= 1
    dist_m2: torch.Tensor     # (K,) 1.0 when dist_size == 2


@dataclasses.dataclass
class SceneMeta:
    """Host-side metadata needed to write results back."""

    share_extrinsic: bool
    arc_size: int
    ring_size: int
    obs_arc: np.ndarray
    obs_ring: np.ndarray
    colors: np.ndarray
    focal_size: np.ndarray
    dist_size: np.ndarray
    version: float = 0.01


@dataclasses.dataclass
class Scene:
    params: BAParams
    index: SceneIndex
    meta: SceneMeta

    @property
    def n_obs(self) -> int:
        return int(self.index.obs_point.shape[0])

    @property
    def n_points(self) -> int:
        return int(self.params.points.shape[0])

    @property
    def n_extrinsics(self) -> int:  # excludes the identity slot
        return int(self.params.ext_rot.shape[0]) - 1

    @property
    def n_intrinsics(self) -> int:
        return int(self.params.center.shape[0])

    @property
    def identity_ext(self) -> int:
        return self.n_extrinsics


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def from_deeparc(data: DeepArcData, dtype=torch.float64,
                 device="cuda", sort_by_point: bool = True) -> Scene:
    """Build a Scene on ``device`` from parsed ``.deeparc`` contents, wired
    as ``DeepArcManager::buildParameterBlock`` does
    (``src/DeepArcManager.cc:173-196``). Observations are sorted by point
    (a stable sort: ties keep their given order). The observation columns
    go to ``device`` once, in the given order, and are sorted, gathered and
    wired there; only the sorted ``obs_arc`` / ``obs_ring`` that
    :class:`SceneMeta` keeps come back. ``data`` is read by field name, so
    the reference package's ``DeepArcData`` serves as well as the port's."""
    device = check_device(device)
    identity = data.n_extrinsics
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    point = dev(data.obs_point)
    if sort_by_point:
        point, order = torch.sort(point, stable=True)
    else:
        order = torch.arange(data.n_obs, device=device)
        point = point[order]
    # gathered copies, in the input's dtype, so SceneMeta never aliases data
    arc, ring = dev(data.obs_arc)[order], dev(data.obs_ring)[order]
    a, r = arc.long(), ring.long()
    if data.share_extrinsic:
        ring_rec = torch.where(r == 0, 0, r + (data.arc_size - 1))
        outer = torch.where(r == 0, a, torch.where(a == 0, ring_rec, a))
        inner = torch.where((r == 0) | (a == 0), identity, ring_rec)
    else:
        outer = r
        inner = torch.full_like(r, identity)
    xy = f(data.obs_xy)[order]
    i32 = lambda t: t.to(torch.int32)
    params = BAParams(
        points=f(data.points),
        ext_rot=f(np.concatenate([data.ext_rot, np.zeros((1, 3))])),
        ext_trans=f(np.concatenate([data.ext_trans, np.zeros((1, 3))])),
        center=f(data.center), focal=f(data.focal), dist=f(data.dist),
    )
    index = SceneIndex(
        obs_point=i32(point), obs_outer=i32(outer), obs_inner=i32(inner),
        obs_intr=i32(a), obs_xy=xy,
        obs_mask=torch.ones(data.n_obs, dtype=dtype, device=device),
        point_mask=torch.ones(data.n_points, dtype=dtype, device=device),
        focal_shared=f(data.focal_size == 1),
        dist_m1=f(data.dist_size >= 1),
        dist_m2=f(data.dist_size == 2),
    )
    meta = SceneMeta(
        share_extrinsic=data.share_extrinsic, arc_size=data.arc_size,
        ring_size=data.ring_size, obs_arc=arc.cpu().numpy(),
        obs_ring=ring.cpu().numpy(), colors=data.colors.copy(),
        focal_size=data.focal_size.copy(), dist_size=data.dist_size.copy(),
        version=data.version,
    )
    return Scene(params=params, index=index, meta=meta)


def to_deeparc(scene: Scene) -> DeepArcData:
    """Export to host DeepArcData, dropping masked-out observations/points
    and re-indexing survivors (``DeepArcManager.cc:429-432``)."""
    obs_alive = _np(scene.index.obs_mask) > 0.5
    pt_alive = _np(scene.index.point_mask) > 0.5
    new_pt = np.cumsum(pt_alive) - 1
    obs_point = _np(scene.index.obs_point)
    obs_alive = obs_alive & pt_alive[obs_point]
    return DeepArcData(
        version=scene.meta.version,
        share_extrinsic=scene.meta.share_extrinsic,
        arc_size=scene.meta.arc_size,
        ring_size=scene.meta.ring_size,
        obs_arc=scene.meta.obs_arc[obs_alive].astype(np.int32),
        obs_ring=scene.meta.obs_ring[obs_alive].astype(np.int32),
        obs_point=new_pt[obs_point[obs_alive]].astype(np.int32),
        obs_xy=_np(scene.index.obs_xy)[obs_alive].astype(np.float64),
        center=_np(scene.params.center).astype(np.float64),
        focal=_np(scene.params.focal).astype(np.float64),
        focal_size=scene.meta.focal_size,
        dist=_np(scene.params.dist).astype(np.float64),
        dist_size=scene.meta.dist_size,
        ext_rot=_np(scene.params.ext_rot)[:-1].astype(np.float64),
        ext_trans=_np(scene.params.ext_trans)[:-1].astype(np.float64),
        points=_np(scene.params.points)[pt_alive].astype(np.float64),
        colors=scene.meta.colors[pt_alive],
    )


def compact(scene: Scene, obs_bucket: int = 1, point_bucket: int = 1) -> Scene:
    """Physically drop masked-out observations/points and re-index
    (``DeepArcManager.cc:355-421``); M / N round up to the bucket sizes with
    masked padding. The masks, the re-index, the gathers and the padding
    run on the scene's device; only the masks come to the host, to cut
    :class:`SceneMeta`'s columns."""
    idx, p = scene.index, scene.params
    pt_alive = idx.point_mask > 0.5
    obs_alive = (idx.obs_mask > 0.5) & pt_alive[idx.obs_point]
    obs_keep = obs_alive.nonzero().squeeze(1)
    pt_keep = pt_alive.nonzero().squeeze(1)
    n_obs, n_pts = obs_keep.numel(), pt_keep.numel()
    M = -(-n_obs // obs_bucket) * obs_bucket
    N = max(-(-n_pts // point_bucket) * point_bucket, 1)

    def pad(t, size, fill):
        return torch.cat([t, t.new_full((size - len(t),) + t.shape[1:],
                                        fill)])

    def pad_host(a, size):
        return np.concatenate([a, np.zeros((size - len(a),) + a.shape[1:],
                                           a.dtype)])

    dtype, device = p.points.dtype, p.points.device
    new_pt = torch.cumsum(pt_alive, 0) - 1
    ident = scene.identity_ext
    index = SceneIndex(
        obs_point=pad(new_pt[idx.obs_point[obs_keep]].to(torch.int32), M, 0),
        obs_outer=pad(idx.obs_outer[obs_keep], M, ident),
        obs_inner=pad(idx.obs_inner[obs_keep], M, ident),
        obs_intr=pad(idx.obs_intr[obs_keep], M, 0),
        obs_xy=pad(idx.obs_xy[obs_keep].to(dtype), M, 0.0),
        obs_mask=pad(torch.ones(n_obs, dtype=dtype, device=device), M, 0.0),
        point_mask=pad(torch.ones(n_pts, dtype=dtype, device=device), N,
                       0.0),
        focal_shared=idx.focal_shared,
        dist_m1=idx.dist_m1,
        dist_m2=idx.dist_m2,
    )
    params = dataclasses.replace(p, points=pad(p.points[pt_keep], N, 0.0))
    obs_h, pt_h = obs_alive.cpu().numpy(), pt_alive.cpu().numpy()
    meta = dataclasses.replace(
        scene.meta,
        obs_arc=pad_host(scene.meta.obs_arc[obs_h], M),
        obs_ring=pad_host(scene.meta.obs_ring[obs_h], M),
        colors=pad_host(scene.meta.colors[pt_h], N),
    )
    return Scene(params=params, index=index, meta=meta)


def freeze_masks(scene: Scene, freeze_camera: bool = False,
                 gauge_fix_first_extrinsic: bool = True,
                 optimize_intrinsics: bool = False,
                 freeze_points: bool = False) -> BAParams:
    """0/1 masks (1 = free) mirroring BAParams, as the reference applies
    ``SetParameterBlockConstant`` (``src/sfm.cc:50-63``): extrinsic record 0
    is the gauge, intrinsics stay frozen by default, ``freeze_camera``
    holds all but the points, and the identity slot is always frozen."""
    p = scene.params
    ones, zeros = torch.ones_like, torch.zeros_like
    ext_free = ones(p.ext_rot)
    ext_free[scene.identity_ext] = 0.0
    if gauge_fix_first_extrinsic:
        ext_free[0] = 0.0
    if freeze_camera:
        ext_free = zeros(p.ext_rot)
    intr_free = (not freeze_camera) and optimize_intrinsics
    intr = ones(p.center) if intr_free else zeros(p.center)
    focal = ones(p.focal) if intr_free else zeros(p.focal)
    dist = ones(p.dist) if intr_free else zeros(p.dist)
    if intr_free:
        fs = scene.index.focal_shared
        focal = focal * torch.stack([torch.ones_like(fs), 1.0 - fs], dim=1)
        dist = dist * torch.stack([scene.index.dist_m1, scene.index.dist_m2],
                                  dim=1)
    points = zeros(p.points) if freeze_points else (
        ones(p.points) * scene.index.point_mask[:, None])
    return BAParams(points=points, ext_rot=ext_free, ext_trans=ext_free.clone(),
                    center=intr, focal=focal, dist=dist)


def params_from_numpy(d: dict, dtype=torch.float64, device="cuda") -> BAParams:
    """BAParams from a dict of numpy arrays keyed by the reference's
    ``BAParams`` field names (so tests hand both packages identical inputs)."""
    device = check_device(device)
    return BAParams(**{
        f.name: torch.tensor(np.asarray(d[f.name], np.float64), dtype=dtype,
                             device=device)
        for f in dataclasses.fields(BAParams)})


def grid_from_numpy(d: dict, dtype=torch.float64, device="cuda"):
    """GridIndex from a dict of numpy arrays keyed by the reference's
    ``GridIndex`` field names (``band`` is not carried over)."""
    device = check_device(device)
    from deeparc_tpu_torch.solver.rig_grid import GridIndex

    out = {}
    for f in dataclasses.fields(GridIndex):
        if f.name == "band":
            continue
        a = np.asarray(d[f.name])
        out[f.name] = (torch.tensor(a.astype(np.int32), device=device)
                       if np.issubdtype(a.dtype, np.integer)
                       else torch.tensor(a.astype(np.float64), dtype=dtype,
                                         device=device))
    return GridIndex(**out)


def tiles_from_numpy(d: dict, C: int, dtype=torch.float64, device="cuda"):
    """TileIndex from numpy arrays laid out as the reference's ``TileIndex``,
    for a camera vector of C values: ``d["cells"]`` maps the ``CellTable``
    field names to arrays, ``d["buckets"]`` is a sequence of dicts with
    the ``TileBucket`` fields (``cell``, ``xy0``, ``xy1``, ``mask``,
    ``loc`` = () or (local, chunk_cells)), ``d["row_of_point"]`` an
    array; so a test can hand a
    layout the reference built to both packages. The kernels' slot bins
    and the fixed-order maps of the step's sums are built here."""
    from deeparc_tpu_torch.solver.tiles import (
        CellTable,
        TileBucket,
        TileIndex,
        cell_maps,
        with_bins,
    )

    device = check_device(device)

    def tensor(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a.astype(np.int32), device=device)
        return torch.tensor(a.astype(np.float64), dtype=dtype, device=device)

    cells = CellTable(**{name: tensor(d["cells"][name])
                         for name in CellTable._fields if name != "maps"})
    cells = cells._replace(maps=cell_maps(cells.cols, C))
    V = cells.cols.shape[0]
    buckets = []
    for b in d["buckets"]:
        loc = tuple(tensor(a) for a in b["loc"]) if len(b["loc"]) else ()
        buckets.append(with_bins(TileBucket(
            cell=tensor(b["cell"]), xy0=tensor(b["xy0"]),
            xy1=tensor(b["xy1"]), mask=tensor(b["mask"]), loc=loc), V))
    return TileIndex(cells=cells, buckets=tuple(buckets),
                     row_of_point=tensor(d["row_of_point"]))
