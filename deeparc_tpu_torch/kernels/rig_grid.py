"""Fused grid-engine linearization and cost pass: CUDA kernels for Hopper,
their plain PyTorch versions, and the host helpers that pack their inputs.

PyTorch port of ``deeparc_tpu/kernels/rig_pallas.py``. Four wrappers keep
the reference's public names, signatures and returns:

  linearize_grid_banded  -> (cost, g_p, hpp, g_slots, hcc_slots, E_native)
  cost_grid_banded       -> cost
  linearize_grid         -> (cost, g_p, hpp, g_slots, hcc_slots, E_native)
  cost_grid              -> cost

A fifth wrapper, ``schur_reduce`` -> (corr, v), is the grid step's Schur
reduction (``csrc/rig_schur.cu``), which the reference leaves to XLA.

A wrapper given CUDA tensors launches the hand-written kernel
(``csrc/rig_grid.cu``, ``csrc/rig_band.cu``, ``csrc/rig_schur.cu``) and
raises if it cannot; given CPU tensors it runs the plain PyTorch version
(``*_plain``), which the tests hold against the JAX reference (the Schur
reduction's against the three products the step ran before it). Each
wrapper counts its kernel launches in a plain ``int`` attribute,
``launches``.

The monolithic pair takes the banded pair's tables with every tile's band
starting at cell 0, one group of width t_pad and no cyclic extension.
``linearize_grid`` has a kernel of its own (``linearize_mono``); both cost
wrappers launch ``cost_band`` once a call, over all their width groups.

Inputs are laid out as in the reference: cells of a tile's band in rows,
points in columns. ``pxm`` stacks [xy0; xy1; mask] per width group as
(3, w, g_tiles * block_np), or for the monolithic pair as the whole
(3, t_pad, n_pad) :func:`mono_planes` stack, which a solve builds once and
hands to both; the (t_ext, 78) slot table holds per-cell
camera values (``pack_slot_tables``). E comes back in the kernel's NATIVE
column order (per point coordinate: six R-wide extrinsic groups, then six
K-wide intrinsic groups unless the intrinsics are frozen);
:func:`native_of_flat` / :func:`flat_of_native` permute C-sized vectors to
and from the flat camera order, never E itself.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from deeparc_tpu_torch.utils.debug import kernel_boundary

# slot-table columns (csrc/rig_slot.cuh holds the same constants)
_RI, _RO, _ROI, _JRO, _JRI = 0, 9, 18, 27, 36
_TI, _TO, _CX, _CY, _FX, _FY = 45, 48, 51, 52, 53, 54
_D0, _D1, _FSH, _M1, _M2 = 55, 56, 57, 58, 59
_FRO, _FRI, _FRK = 60, 66, 72
SP_COLS = 78

_LOSS_IDS = {"trivial": 0, "huber": 1, "cauchy": 2}
# tiles are processed in chunks of at most this many (cell, point) slots by
# the plain versions, which bounds their temporaries at full size
_PLAIN_SLOTS = 1 << 20


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_slot_tables(sp, grid, free_outer, free_inner, free_intr, t_pad):
    """(t_pad, SP_COLS) per-cell table; pad cells get z-safe translations."""
    T = sp.fx.shape[0]
    dtype = sp.fx.dtype
    cols = [
        sp.R_i.reshape(T, 9), sp.R_o.reshape(T, 9), sp.R_oi.reshape(T, 9),
        sp.Jr_o.reshape(T, 9), sp.Jr_i.reshape(T, 9),
        sp.t_i, sp.t_o, sp.center,
        sp.fx[:, None], sp.fy[:, None], sp.d0[:, None], sp.d1[:, None],
        grid.focal_shared[:, None], grid.dist_m1[:, None],
        grid.dist_m2[:, None], free_outer, free_inner, free_intr,
    ]
    pack = torch.cat([c.to(dtype) for c in cols], dim=1)
    if t_pad > T:
        pad = torch.zeros((t_pad - T, SP_COLS), dtype=dtype, device=pack.device)
        pad[:, _TI + 2] = 1.0      # keep 1/z finite on padded cells
        pad[:, _TO + 2] = 1.0
        pack = torch.cat([pack, pad], dim=0)
    return pack


def native_of_flat(n_ext_rows: int, n_intr: int) -> np.ndarray:
    """perm with E_flat[..., c] == E_native[..., native_of_flat[c]]."""
    R, K = n_ext_rows, n_intr
    out = np.empty(6 * (R + K), np.int32)
    for r in range(R):
        for j in range(6):
            out[r * 6 + j] = j * R + r
    for k in range(K):
        for j in range(6):
            out[6 * R + k * 6 + j] = 6 * R + j * K + k
    return out


def flat_of_native(n_ext_rows: int, n_intr: int) -> np.ndarray:
    return np.argsort(native_of_flat(n_ext_rows, n_intr)).astype(np.int32)


def _extend_cyclic(x, w_band, dim=0):
    """Append rows 0..w_band after the end so wrapped bands are contiguous."""
    return torch.cat([x, x.narrow(dim, 0, w_band)], dim=dim)


def mono_planes(grid, n_pad):
    """The observation stack (3, t_pad, n_pad): [xy0; xy1; mask] transposed,
    zero-padded to t_pad = T rounded up to 8 cells and n_pad points. The
    monolithic kernels take it as ``pxm``; a solve builds it once (it
    depends on the mask only), at a width both kernels' tiles divide."""
    N, T = grid.xy0.shape
    t_pad = _round_up(T, 8)
    out = torch.empty((3, t_pad, n_pad), dtype=grid.xy0.dtype,
                      device=grid.xy0.device)
    out[:, T:] = 0.0
    out[:, :T, N:] = 0.0
    for i, x in enumerate((grid.xy0, grid.xy1, grid.mask)):
        out[i, :T, :N] = x.T
    return out


def banded_planes(grid, n_pad, ext_len):
    """Stacked + cyclically-extended observation planes
    (3, t_pad + ext_len, n_pad): [xy0; xy1; mask] transposed."""
    return _extend_cyclic(mono_planes(grid, n_pad), ext_len, dim=1)


def gather_banded_planes(pxm_ext, starts, w_band, block_np, t_lo=0, t_hi=None):
    """Each point tile's live band as a DENSE stack
    (3, w_band, (t_hi - t_lo) * block_np): tile i's column block holds rows
    [starts[i]*8, starts[i]*8 + w_band) of the extended planes."""
    _, t_ext, n_pad = pxm_ext.shape
    n_tiles = n_pad // block_np
    t_hi = n_tiles if t_hi is None else t_hi
    rows = (starts[t_lo:t_hi].long()[:, None] * 8
            + torch.arange(w_band, device=starts.device))     # (g, w)
    arr = pxm_ext.reshape(3, t_ext, n_tiles, block_np)[:, :, t_lo:t_hi]
    idx = rows.T[None, :, :, None].expand(3, w_band, t_hi - t_lo, block_np)
    out = torch.gather(arr, 1, idx.to(pxm_ext.device))
    return out.reshape(3, w_band, (t_hi - t_lo) * block_np)


def _banded_tables(sp, grid, free_outer, free_inner, free_intr, t_pad,
                   w_band, dtype):
    """Cyclically-extended slot table + one-hot bin matrices."""
    T = grid.onehot_outer.shape[0]

    def oh_pad(oh):
        out = torch.zeros((t_pad, oh.shape[1]), dtype=dtype, device=oh.device)
        out[:T] = oh
        return _extend_cyclic(out, w_band)

    tbl = _extend_cyclic(pack_slot_tables(sp, grid, free_outer, free_inner,
                                          free_intr, t_pad), w_band)
    return (tbl, oh_pad(grid.onehot_outer), oh_pad(grid.onehot_inner),
            oh_pad(grid.onehot_intr))


def _slot_ids(grid, t_pad, w_ext):
    """(3, t_pad + w_ext) int32 [outer; inner; intr] row ids per table row,
    -1 on pad cells: the kernel's replacement for the one-hot contractions."""
    T = grid.slot_outer.shape[0]
    ids = torch.full((3, t_pad), -1, dtype=torch.int32,
                     device=grid.slot_outer.device)
    ids[0, :T] = grid.slot_outer
    ids[1, :T] = grid.slot_inner
    ids[2, :T] = grid.slot_intr
    return _extend_cyclic(ids, w_ext, dim=1).contiguous()


def _pts_pack(points, point_free, n_pad):
    """(8, n_pad): rows X, Y, Z, then the point-freeze mask; z-safe padding."""
    N = points.shape[0]
    pack = torch.zeros((8, n_pad), dtype=points.dtype, device=points.device)
    pack[0:3, :N] = points.T
    pack[2, N:] = 1.0
    if point_free is not None:
        pack[3:6, :N] = point_free.T.to(points.dtype)
    return pack


def _groups_of(w_band, N, block_np, pxm):
    """Normalise ``w_band`` (one width or ``(w, lo, hi)`` groups) to groups
    and the padded point count."""
    if isinstance(w_band, tuple):
        return w_band, w_band[-1][2] * block_np
    n_pad = _round_up(N, block_np) if pxm is None else pxm.shape[-1]
    return ((w_band, 0, n_pad // block_np),), n_pad


def check_band_starts(starts: torch.Tensor, t_pad: int) -> None:
    """Refuse a band start table with a start outside the cell table (a
    host read: the band prep runs it where it hands the tables over, and a
    wrapper when it gathers the planes itself, never on a solve's step)."""
    if starts.numel() and int(starts.max()) * 8 >= t_pad:
        raise ValueError("band start outside the cell table")


def _band_stacks(grid, starts, groups, block_np, n_pad, t_pad, pxm):
    """The groups' plane stacks, gathered when not given; checks every
    table against the shapes the kernels index with. The starts' values
    are checked where the planes are gathered (:func:`check_band_starts`):
    given stacks come from a band prep that checked them."""
    w_max = max(w for w, _, _ in groups)
    if any(w % 8 or w > t_pad for w, _, _ in groups):
        raise ValueError(f"band widths {groups} must be multiples of 8 "
                         f"and <= t_pad={t_pad}")
    if starts.shape[0] != n_pad // block_np:
        raise ValueError(f"band start table has {starts.shape[0]} tiles, "
                         f"not {n_pad // block_np}: it was built for another "
                         f"point-tile width than {block_np}")
    if pxm is None:
        check_band_starts(starts, t_pad)
        pxm_ext = banded_planes(grid, n_pad, w_max)
        pxms = tuple(gather_banded_planes(pxm_ext, starts, w, block_np, lo, hi)
                     for w, lo, hi in groups)
    else:
        pxms = pxm if isinstance(pxm, tuple) else (pxm,)
    if len(pxms) != len(groups) or any(
            tuple(p.shape) != (3, w, (hi - lo) * block_np)
            for (w, lo, hi), p in zip(groups, pxms)):
        raise ValueError(f"plane stacks {[tuple(p.shape) for p in pxms]} do "
                         f"not match the groups {groups} at {block_np} points "
                         f"per tile")
    return pxms, w_max


# ---------------------------------------------------------------------------
# Input preparation shared by each wrapper and its plain version
# ---------------------------------------------------------------------------


def _prep_linearize_banded(points, point_free, sp, grid, free_outer,
                           free_inner, free_intr, starts, w_band, block_np,
                           intr_frozen, pxm):
    N, T = grid.xy0.shape
    t_pad = _round_up(T, 8)
    groups, n_pad = _groups_of(w_band, N, block_np, pxm)
    pxms, w_max = _band_stacks(grid, starts, groups, block_np, n_pad, t_pad,
                               pxm)
    tables = _banded_tables(sp, grid, free_outer, free_inner, free_intr,
                            t_pad, w_max, points.dtype)
    return dict(N=N, T=T, t_pad=t_pad, groups=groups, pxms=pxms,
                tables=tables, ids=_slot_ids(grid, t_pad, w_max),
                pts=_pts_pack(points, point_free, n_pad), starts=starts,
                block_np=block_np, intr_frozen=intr_frozen)


def _mono_stack(grid, N, t_pad, block_np, pxm, dtype):
    """The monolithic kernels' plane stack and padded point count: ``pxm``
    checked against the shape the kernels index with, or built."""
    if pxm is None:
        n_pad = _round_up(N, block_np)
        return mono_planes(grid, n_pad), n_pad
    n_pad = pxm.shape[-1]
    if (pxm.shape != (3, t_pad, n_pad) or n_pad < N or n_pad % block_np
            or pxm.dtype != dtype):
        raise ValueError(f"plane stack {tuple(pxm.shape)} {pxm.dtype} does "
                         f"not fit (3, {t_pad}, n_pad >= {N}) {dtype} with "
                         f"n_pad a multiple of {block_np} (mono_planes)")
    return pxm, n_pad


def _prep_linearize_mono(points, point_free, sp, grid, free_outer, free_inner,
                         free_intr, block_np, pxm):
    N, T = grid.xy0.shape
    t_pad = _round_up(T, 8)
    pxm, n_pad = _mono_stack(grid, N, t_pad, block_np, pxm, points.dtype)
    n_tiles = n_pad // block_np
    tables = _banded_tables(sp, grid, free_outer, free_inner, free_intr,
                            t_pad, 0, points.dtype)
    starts = torch.zeros(n_tiles, dtype=torch.int32, device=points.device)
    return dict(N=N, T=T, t_pad=t_pad, groups=((t_pad, 0, n_tiles),),
                pxms=(pxm,), tables=tables, ids=_slot_ids(grid, t_pad, 0),
                pts=_pts_pack(points, point_free, n_pad), starts=starts,
                block_np=block_np, intr_frozen=False)


def _prep_cost_banded(points, sp, grid, starts, w_band, block_np, pxm):
    N, T = grid.xy0.shape
    t_pad = _round_up(T, 8)
    groups, n_pad = _groups_of(w_band, N, block_np, pxm)
    pxms, w_max = _band_stacks(grid, starts, groups, block_np, n_pad, t_pad,
                               pxm)
    zeros6 = torch.zeros((T, 6), dtype=points.dtype, device=points.device)
    tbl = _extend_cyclic(pack_slot_tables(sp, grid, zeros6, zeros6, zeros6,
                                          t_pad), w_max)
    return dict(groups=groups, pxms=pxms, tbl=tbl, starts=starts,
                points=points, n_pad=n_pad, block_np=block_np)


def _prep_cost_mono(points, sp, grid, block_np, pxm):
    N, T = grid.xy0.shape
    t_pad = _round_up(T, 8)
    pxm, n_pad = _mono_stack(grid, N, t_pad, block_np, pxm, points.dtype)
    n_tiles = n_pad // block_np
    zeros6 = torch.zeros((T, 6), dtype=points.dtype, device=points.device)
    return dict(groups=((t_pad, 0, n_tiles),), pxms=(pxm,),
                tbl=pack_slot_tables(sp, grid, zeros6, zeros6, zeros6, t_pad),
                starts=torch.zeros(n_tiles, dtype=torch.int32,
                                   device=points.device),
                points=points, n_pad=n_pad, block_np=block_np)


def _finish_linearize(N, cost, pout, g_slots, hcc_slots, E):
    g_p = pout[0:3, :N].T
    hpp = pout[3:12, :N].T.reshape(N, 3, 3)
    return cost, g_p, hpp, g_slots, hcc_slots, E[:N].reshape(N, 3, -1)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _loss_rho(s, loss, a):
    if loss == "trivial":
        return s
    a2 = a * a
    if loss == "huber":
        return torch.where(s <= a2, s,
                           2.0 * a * torch.sqrt(torch.clamp(s, min=a2)) - a2)
    if loss == "cauchy":
        return a2 * torch.log1p(s / a2)
    raise ValueError(loss)


def _loss_weight(s, loss, a):
    if loss == "trivial":
        return None
    a2 = a * a
    if loss == "huber":
        return torch.where(s <= a2, torch.ones_like(s),
                           torch.sqrt(a / torch.sqrt(torch.clamp(s, min=a2))))
    if loss == "cauchy":
        return torch.sqrt(1.0 / (1.0 + s / a2))
    raise ValueError(loss)


def _chain(col, X, xy0, xy1, mask, zguard=False):
    """Projection/residual planes of a chunk of tiles: (g, w, bn).
    ``zguard`` divides masked slots by z = 1 (their cell may be a pad cell
    whose depth is 0), as the tile kernels do."""
    p2 = [X[0] * col(_RI + 3 * a) + X[1] * col(_RI + 3 * a + 1)
          + X[2] * col(_RI + 3 * a + 2) + col(_TI + a) for a in range(3)]
    p3 = [p2[0] * col(_RO + 3 * a) + p2[1] * col(_RO + 3 * a + 1)
          + p2[2] * col(_RO + 3 * a + 2) + col(_TO + a) for a in range(3)]
    z = p3[2] * mask + (1.0 - mask) if zguard else p3[2]
    inv_z = 1.0 / z
    u0, u1 = p3[0] * inv_z, p3[1] * inv_z
    r2 = u0 * u0 + u1 * u1
    dcoef = 1.0 + r2 * (col(_D0) + col(_D1) * r2)
    r0 = (col(_FX) * dcoef * u0 + col(_CX) - xy0) * mask
    r1 = (col(_FY) * dcoef * u1 + col(_CY) - xy1) * mask
    return dict(p2=p2, inv_z=inv_z, u0=u0, u1=u1, r2=r2, dcoef=dcoef,
                r0=r0, r1=r1)


def _slot_products(col, X, pf, xy0, xy1, mask, loss, loss_scale,
                   intr_frozen=False, zguard=False):
    """Residual + per-slot Jacobian planes (the math of csrc/rig_slot.cuh
    ``slot_products``). Returns (cost, r0, r1, jx_f, P) with P[k] the
    camera-Jacobian planes: 18, or the 12 extrinsic ones when frozen."""
    c = _chain(col, X, xy0, xy1, mask, zguard)
    p2, inv_z, u0, u1 = c["p2"], c["inv_z"], c["u0"], c["u1"]
    r2, dcoef, r0, r1 = c["r2"], c["dcoef"], c["r0"], c["r1"]
    raw_s = r0 * r0 + r1 * r1
    cost = 0.5 * torch.sum(_loss_rho(raw_s, loss, loss_scale) * mask)
    w = _loss_weight(raw_s, loss, loss_scale)
    if w is None:
        wm = mask
    else:
        wm = mask * w
        r0, r1 = r0 * w, r1 * w
    g = col(_D0) + 2.0 * col(_D1) * r2
    c00 = dcoef + 2.0 * g * u0 * u0
    c11 = dcoef + 2.0 * g * u1 * u1
    c01 = 2.0 * g * u0 * u1
    ccr = dcoef + 2.0 * g * r2
    fxz = col(_FX) * inv_z * wm
    fyz = col(_FY) * inv_z * wm
    A = [[fxz * c00, fxz * c01, -fxz * u0 * ccr],
         [fyz * c01, fyz * c11, -fyz * u1 * ccr]]

    def chain_mat(Ak, base):
        return [Ak[0] * col(base + b) + Ak[1] * col(base + 3 + b)
                + Ak[2] * col(base + 6 + b) for b in range(3)]

    def cross(v, u):
        return [v[1] * u[2] - v[2] * u[1], v[2] * u[0] - v[0] * u[2],
                v[0] * u[1] - v[1] * u[0]]

    jx_f, P = [], []
    for k in range(2):
        jx_k = chain_mat(A[k], _ROI)
        B_k = chain_mat(A[k], _RO)
        Cw, Dw = cross(B_k, p2), cross(jx_k, X)
        jwo = [-(Cw[0] * col(_JRO + b) + Cw[1] * col(_JRO + 3 + b)
                 + Cw[2] * col(_JRO + 6 + b)) for b in range(3)]
        jwi = [-(Dw[0] * col(_JRI + b) + Dw[1] * col(_JRI + 3 + b)
                 + Dw[2] * col(_JRI + 6 + b)) for b in range(3)]
        jx_f.append([jx_k[b] * pf[b] for b in range(3)])
        P.append([jwo[b] * col(_FRO + b) for b in range(3)]
                 + [A[k][b] * col(_FRO + 3 + b) for b in range(3)]
                 + [jwi[b] * col(_FRI + b) for b in range(3)]
                 + [B_k[b] * col(_FRI + 3 + b) for b in range(3)])
    if intr_frozen:
        return cost, r0, r1, jx_f, P
    zero = torch.zeros_like(wm)
    du0, du1, sh = dcoef * u0, dcoef * u1, col(_FSH)
    jint = [
        [wm, zero, du0 * wm, zero,
         col(_FX) * u0 * r2 * col(_M1) * wm,
         col(_FX) * u0 * r2 * r2 * col(_M2) * wm],
        [zero, wm, sh * du1 * wm, (1.0 - sh) * du1 * wm,
         col(_FY) * u1 * r2 * col(_M1) * wm,
         col(_FY) * u1 * r2 * r2 * col(_M2) * wm],
    ]
    for k in range(2):
        P[k] = P[k] + [jint[k][j] * col(_FRK + j) for j in range(6)]
    return cost, r0, r1, jx_f, P


def _tile_chunks(groups, pxms, starts, block_np):
    """Yield (rows (g, w), planes (3, g, w, bn), first point, last point) per
    chunk of tiles of each group."""
    bn = block_np
    for (w, lo, hi), pxm in zip(groups, pxms):
        g_tiles = hi - lo
        if g_tiles == 0:
            continue
        planes = pxm.reshape(3, w, g_tiles, bn).permute(0, 2, 1, 3)
        step = max(1, _PLAIN_SLOTS // (w * bn))
        for c0 in range(0, g_tiles, step):
            c1 = min(g_tiles, c0 + step)
            rows = (starts[lo + c0:lo + c1].long()[:, None] * 8
                    + torch.arange(w, device=pxm.device))
            yield rows, planes[:, c0:c1], (lo + c0) * bn, (lo + c1) * bn


def _point_side(J0, J1, r0, r1):
    """g_p (3, g, bn) and hpp (3, 3, g, bn): the point side's reductions
    over a chunk's band cells."""
    g_p = (J0 * r0 + J1 * r1).sum(dim=2)
    hpp = (torch.einsum("agwn,bgwn->abgn", J0, J0)
           + torch.einsum("agwn,bgwn->abgn", J1, J1))
    return g_p, hpp


def _slot_grad(P0, P1, r0, r1):
    """The camera gradient per slot row (n_p, g, w): reductions over each
    tile's points."""
    return (P0 * r0 + P1 * r1).sum(dim=3)


def _slot_gram(P0, P1):
    """The slot Gram per slot row (g, w, n_p, n_p)."""
    return (torch.einsum("agwn,bgwn->gwab", P0, P0)
            + torch.einsum("agwn,bgwn->gwab", P1, P1))


def _bin_slots(g_s, h_s, rows, t_ext):
    """A chunk's slot rows summed into the (t_ext, n_p + n_p^2) table.
    A tile's rows are distinct: each tile's go into their own slab, then
    the slabs are summed in order (no atomics, so the sum repeats bit for
    bit on the card too)."""
    gc, n_p = rows.shape[0], g_s.shape[0]
    vals = torch.cat([g_s.permute(1, 2, 0),
                      h_s.reshape(gc, -1, n_p * n_p)], dim=-1)
    slabs = torch.zeros((gc, t_ext, vals.shape[-1]), dtype=vals.dtype,
                        device=vals.device)
    slabs.scatter_(1, rows[:, :, None].expand(-1, -1, vals.shape[-1]), vals)
    return slabs.sum(dim=0)


def _e_rows(J0, J1, P0, P1, tables, rows, frozen):
    """A chunk's E rows (g * bn, 3, Cn) in native column order: one-hot
    contractions over the band's cells."""
    _, oho, ohi, ohk = tables
    gc, bn = J0.shape[1], J0.shape[3]
    R, K = oho.shape[1], ohk.shape[1]
    W = (torch.einsum("agwn,jgwn->ajgwn", J0, P0)
         + torch.einsum("agwn,jgwn->ajgwn", J1, P1))
    e_ext = (torch.einsum("ajgwn,gwr->gnajr", W[:, 0:6], oho[rows])
             + torch.einsum("ajgwn,gwr->gnajr", W[:, 6:12], ohi[rows]))
    parts = [e_ext.reshape(gc * bn, 3, 6 * R)]
    if not frozen:
        e_int = torch.einsum("ajgwn,gwk->gnajk", W[:, 12:18], ohk[rows])
        parts.append(e_int.reshape(gc * bn, 3, 6 * K))
    return torch.cat(parts, dim=-1)


def _chunk_products(prep, loss, loss_scale):
    """Yield per chunk of tiles (cost, r0, r1, J0, J1, P0, P1, rows, first
    point, last point): the residual and Jacobian planes of
    :func:`_slot_products`, J and P stacked (3 / n_p, g, w, bn)."""
    tbl, pts, bn = prep["tables"][0], prep["pts"], prep["block_np"]
    for rows, planes, p0, p1 in _tile_chunks(prep["groups"], prep["pxms"],
                                             prep["starts"], bn):
        gc = rows.shape[0]
        tb = tbl[rows]                                   # (gc, w, 78)
        col = lambda c: tb[..., c:c + 1]
        X = [pts[a, p0:p1].reshape(gc, 1, bn) for a in range(3)]
        pf = [pts[3 + a, p0:p1].reshape(gc, 1, bn) for a in range(3)]
        c_val, r0, r1, jx_f, P = _slot_products(
            col, X, pf, planes[0], planes[1], planes[2], loss, loss_scale,
            intr_frozen=prep["intr_frozen"])
        yield (c_val, r0, r1, torch.stack(jx_f[0]), torch.stack(jx_f[1]),
               torch.stack(P[0]), torch.stack(P[1]), rows, p0, p1)


def _fold_slots(ghs, T, t_pad, n_p):
    """(g_slots (T, 18), hcc_slots (T, 18, 18)) of the slot table, its
    cyclic extension rows folded back onto their base cells."""
    t_ext = ghs.shape[0]
    folded = ghs[:t_pad].clone()
    folded[:t_ext - t_pad] += ghs[t_pad:]
    g_slots = torch.zeros((T, 18), dtype=ghs.dtype, device=ghs.device)
    hcc_slots = torch.zeros((T, 18, 18), dtype=ghs.dtype, device=ghs.device)
    g_slots[:, :n_p] = folded[:T, :n_p]
    hcc_slots[:, :n_p, :n_p] = folded[:T, n_p:].reshape(T, n_p, n_p)
    return g_slots, hcc_slots


def _plain_linearize(prep, loss, loss_scale):
    """The linearize over the prep's chunks of tiles."""
    tables, pts = prep["tables"], prep["pts"]
    T, t_pad, frozen = prep["T"], prep["t_pad"], prep["intr_frozen"]
    dtype, dev = pts.dtype, pts.device
    n_pad = pts.shape[1]
    R, K = tables[1].shape[1], tables[3].shape[1]
    n_p = 12 if frozen else 18
    t_ext = tables[0].shape[0]
    pout = torch.zeros((12, n_pad), dtype=dtype, device=dev)
    E = torch.zeros((n_pad, 3, 6 * R if frozen else 6 * (R + K)),
                    dtype=dtype, device=dev)
    ghs = torch.zeros((t_ext, n_p + n_p * n_p), dtype=dtype, device=dev)
    cost = torch.zeros((), dtype=dtype, device=dev)
    for c_val, r0, r1, J0, J1, P0, P1, rows, p0, p1 in _chunk_products(
            prep, loss, loss_scale):
        cost = cost + c_val
        g_p, hpp = _point_side(J0, J1, r0, r1)
        pout[0:3, p0:p1] = g_p.reshape(3, -1)
        pout[3:12, p0:p1] = hpp.reshape(9, -1)
        ghs += _bin_slots(_slot_grad(P0, P1, r0, r1), _slot_gram(P0, P1),
                          rows, t_ext)
        E[p0:p1] = _e_rows(J0, J1, P0, P1, tables, rows, frozen)
    g_slots, hcc_slots = _fold_slots(ghs, T, t_pad, n_p)
    return _finish_linearize(prep["N"], cost, pout, g_slots, hcc_slots, E)


def _plain_cost(prep, loss, loss_scale):
    tbl, bn = prep["tbl"], prep["block_np"]
    pts = _pts_pack(prep["points"], None, prep["n_pad"])
    total = torch.zeros((), dtype=pts.dtype, device=pts.device)
    for rows, planes, p0, p1 in _tile_chunks(prep["groups"], prep["pxms"],
                                             prep["starts"], bn):
        tb = tbl[rows]
        col = lambda c: tb[..., c:c + 1]
        X = [pts[a, p0:p1].reshape(rows.shape[0], 1, bn) for a in range(3)]
        c = _chain(col, X, planes[0], planes[1], planes[2])
        s = c["r0"] * c["r0"] + c["r1"] * c["r1"]
        total = total + 0.5 * torch.sum(_loss_rho(s, loss, loss_scale)
                                        * planes[2])
    return total


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_DTYPE_IDS = {torch.float32: 0, torch.float64: 1}


def _n_blocks(device, g_tiles_max):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(g_tiles_max, 4 * sms))


def _cuda_args(pts, loss, tensors):
    """(dtype id, loss id) for the launchers, after checking that every
    float input has the points' dtype and device and is contiguous."""
    if pts.dtype not in _DTYPE_IDS:
        raise TypeError(f"grid kernels take float32 or float64, "
                        f"not {pts.dtype}")
    if loss not in _LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}")
    for t in tensors:
        if t.dtype != pts.dtype or t.device != pts.device:
            raise TypeError(f"kernel input {t.dtype} on {t.device}: every "
                            f"input must be {pts.dtype} on {pts.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return _DTYPE_IDS[pts.dtype], _LOSS_IDS[loss]


# points of a linearize_band tile (csrc/rig_band.cu BAND_PTS)
BAND_PTS = 32
# the largest point tile the linearize kernels take
LIN_MAX_BLOCK_NP = 256


def band_subtiles(groups, block_np, tp=BAND_PTS):
    """The width groups ``(w, tile_lo, tile_hi)`` (in ``block_np``-point
    tiles) as linearize_band launches them: ``(w, tile_lo, n_sub)`` with
    ``n_sub`` tiles of ``tp`` points. Sub-tile s of a group holds points
    ``tile_lo * block_np + s * tp + [0, tp)`` and takes the band of block
    tile ``tile_lo + s * tp // block_np`` (its ``starts`` entry)."""
    if block_np % tp:
        raise ValueError(f"{block_np}-point tiles do not split into "
                         f"{tp}-point tiles")
    return tuple((w, lo, (hi - lo) * block_np // tp) for w, lo, hi in groups)


def linearize_band_route(dtype, loss, intr_frozen, R, K, n_pad) -> int:
    """Blocks of linearize_grid_banded's shared-memory E kernel
    (``linearize_band``, ``csrc/rig_band.cu``) for this rig and dtype, or 0
    when its 32-point E tile (3 Cn values a point) does not fit an SM: such
    a rig takes ``linearize_kernel`` (``csrc/rig_grid.cu``). Needs the
    card."""
    from deeparc_tpu_torch.kernels.build import library

    Cn = 6 * R if intr_frozen else 6 * (R + K)
    blocks = library().rig_linearize_band_grid(
        _DTYPE_IDS[dtype], _LOSS_IDS[loss], 12 if intr_frozen else 18, Cn,
        max(1, n_pad // BAND_PTS))
    if blocks < 0:
        raise RuntimeError(f"rig_linearize_band_grid: cudaError {-blocks}")
    return blocks


def _cuda_linearize(prep, loss, loss_scale, counter, band=False):
    """The banded linearize kernels over the prep's width groups:
    ``linearize_band`` (``band=True``, linearize_grid_banded) when a
    32-point tile's E fits an SM, else ``linearize_kernel``."""
    from deeparc_tpu_torch.kernels.build import check, library

    lib = library()
    tbl, oho, _, ohk = prep["tables"]
    pts, bn, frozen = prep["pts"], prep["block_np"], prep["intr_frozen"]
    T, t_pad = prep["T"], prep["t_pad"]
    dev, dtype = pts.device, pts.dtype
    tbl, ids = tbl.contiguous(), prep["ids"]
    pxms = tuple(p.contiguous() for p in prep["pxms"])
    dt, ls = _cuda_args(pts, loss, (tbl,) + pxms)
    if bn % 32 or not 0 < bn <= LIN_MAX_BLOCK_NP:
        raise ValueError(f"the linearize kernel takes 32..{LIN_MAX_BLOCK_NP}"
                         f"-point tiles in multiples of 32, not {bn}")
    R, K = oho.shape[1], ohk.shape[1]
    n_p = 12 if frozen else 18
    nv = n_p + n_p * (n_p + 1) // 2
    n_pad, t_ext = pts.shape[1], tbl.shape[0]
    Cn = 6 * R if frozen else 6 * (R + K)
    starts = prep["starts"].to(torch.int32).contiguous()
    blocks = (linearize_band_route(dtype, loss, frozen, R, K, n_pad) if band
              else 0)
    if blocks:
        subs = band_subtiles(prep["groups"], bn)
        n_blocks = max(1, min(blocks, max(n for _, _, n in subs)))
    else:
        n_blocks = _n_blocks(dev, max(hi - lo for _, lo, hi in prep["groups"]))
    pout = torch.empty((12, n_pad), dtype=dtype, device=dev)
    E = torch.empty((n_pad, 3 * Cn), dtype=dtype, device=dev)
    partial = torch.zeros((n_blocks, t_ext, nv), dtype=dtype, device=dev)
    partial_cost = torch.zeros((n_blocks,), dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, ((w, lo, hi), pxm) in enumerate(zip(prep["groups"], pxms)):
        if hi == lo:
            continue
        counter.launches += 1
        if blocks:
            n_sub = subs[i][2]
            check(lib.rig_linearize_band(
                dt, ls, n_p, tbl.data_ptr(), ids.data_ptr(),
                starts.data_ptr(), pts.data_ptr(), pxm.data_ptr(), t_ext,
                n_pad, R, K, lo, bn, n_sub, w, float(loss_scale),
                min(n_sub, n_blocks), pout.data_ptr(), E.data_ptr(),
                partial.data_ptr(), partial_cost.data_ptr(), stream),
                "rig_linearize_band")
            continue
        check(lib.rig_linearize(
            dt, ls, int(frozen), tbl.data_ptr(), ids.data_ptr(),
            starts.data_ptr(), pts.data_ptr(), pxm.data_ptr(), t_ext, n_pad,
            R, K, lo, hi - lo, bn, w, float(loss_scale),
            min(hi - lo, n_blocks), pout.data_ptr(), E.data_ptr(),
            partial.data_ptr(), partial_cost.data_ptr(), stream),
            "rig_linearize")
    g_slots = torch.zeros((T, 18), dtype=dtype, device=dev)
    hcc_slots = torch.zeros((T, 18, 18), dtype=dtype, device=dev)
    cost = torch.empty((), dtype=dtype, device=dev)
    check(lib.rig_reduce_slots(dt, partial.data_ptr(), n_blocks, t_ext,
                               t_pad, T, n_p, g_slots.data_ptr(),
                               hcc_slots.data_ptr(), stream),
          "rig_reduce_slots")
    check(lib.rig_reduce_cost(dt, partial_cost.data_ptr(), n_blocks,
                              cost.data_ptr(), stream), "rig_reduce_cost")
    return _finish_linearize(prep["N"], cost, pout, g_slots, hcc_slots, E)


def _cuda_linearize_mono(prep, loss, loss_scale):
    """linearize_grid's own kernel (``linearize_mono``): tiles of 32 points
    whose E rows a block keeps in shared memory. A rig whose E row does not
    fit there (6 (R + K) columns beyond ~250 in float64) takes the kernel
    shared with the banded wrapper."""
    from deeparc_tpu_torch.kernels.build import check, library

    lib = library()
    tbl, oho, _, ohk = prep["tables"]
    pts, T, t_pad = prep["pts"], prep["T"], prep["t_pad"]
    dev, dtype = pts.device, pts.dtype
    tbl, ids, (pxm,) = tbl.contiguous(), prep["ids"], prep["pxms"]
    pxm = pxm.contiguous()
    dt, ls = _cuda_args(pts, loss, (tbl, pxm))
    R, K = oho.shape[1], ohk.shape[1]
    n_pad = pts.shape[1]
    if n_pad % 32:
        raise ValueError(f"linearize_grid takes point tiles in multiples of "
                         f"32, not {prep['block_np']}")
    n_tiles = n_pad // 32
    grid = lib.rig_linearize_mono_grid(dt, ls, 6 * (R + K), n_tiles)
    if grid < 0:
        raise RuntimeError(f"rig_linearize_mono_grid: cudaError {-grid}")
    if grid == 0:
        return _cuda_linearize(prep, loss, loss_scale, linearize_grid)
    pout = torch.empty((12, n_pad), dtype=dtype, device=dev)
    E = torch.empty((n_pad, 18 * (R + K)), dtype=dtype, device=dev)
    partial = torch.zeros((grid, t_pad, 189), dtype=dtype, device=dev)
    partial_cost = torch.empty((grid,), dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    linearize_grid.launches += 1
    check(lib.rig_linearize_mono(
        dt, ls, tbl.data_ptr(), ids.data_ptr(), pts.data_ptr(),
        pxm.data_ptr(), t_pad, n_pad, R, K, n_tiles, float(loss_scale), grid,
        pout.data_ptr(), E.data_ptr(), partial.data_ptr(),
        partial_cost.data_ptr(), stream), "rig_linearize_mono")
    g_slots = torch.zeros((T, 18), dtype=dtype, device=dev)
    hcc_slots = torch.zeros((T, 18, 18), dtype=dtype, device=dev)
    cost = torch.empty((), dtype=dtype, device=dev)
    check(lib.rig_reduce_slots(dt, partial.data_ptr(), grid, t_pad, t_pad, T,
                               18, g_slots.data_ptr(), hcc_slots.data_ptr(),
                               stream), "rig_reduce_slots")
    check(lib.rig_reduce_cost(dt, partial_cost.data_ptr(), grid,
                              cost.data_ptr(), stream), "rig_reduce_cost")
    return _finish_linearize(prep["N"], cost, pout, g_slots, hcc_slots, E)


# points of a cost_band block, and width groups of one launch
# (csrc/rig_grid.cu COST_THREADS, COST_MAX_GROUPS)
COST_THREADS = 256
COST_MAX_GROUPS = 8


class CostLaunch(NamedTuple):
    """cost_band's one launch over width groups ``(w, tile_lo, tile_hi)``
    of ``block_np``-point tiles: blocks of ``threads`` points,
    ``per_tile`` blocks a tile, each group's first block, ``n_blocks`` in
    all. Block j of a group takes tile ``tile_lo + (j - first) //
    per_tile`` and its points ``((j - first) % per_tile) * threads +
    [0, threads)`` below ``block_np``, at the same columns of the group's
    stack counted from the group's first tile. A group without tiles
    starts where the next one does and takes no block."""
    threads: int
    per_tile: int
    first_blocks: tuple
    n_blocks: int


def cost_launch(groups, block_np) -> CostLaunch:
    """cost_band's launch map (:class:`CostLaunch`); raises ValueError for
    more than ``COST_MAX_GROUPS`` groups (the struct the launch passes has
    room for that many)."""
    if len(groups) > COST_MAX_GROUPS:
        raise ValueError(f"cost_band takes at most {COST_MAX_GROUPS} width "
                         f"groups in one launch, not {len(groups)}")
    threads = min(COST_THREADS, _round_up(block_np, 32))
    per_tile = -(-block_np // threads)
    firsts, n_blocks = [], 0
    for _, lo, hi in groups:
        firsts.append(n_blocks)
        n_blocks += (hi - lo) * per_tile
    return CostLaunch(threads, per_tile, tuple(firsts), n_blocks)


class _CostGroups(ctypes.Structure):
    """csrc/rig_grid.cu CostGroups: the groups of one cost_band launch."""
    _fields_ = [("pxm", ctypes.c_void_p * COST_MAX_GROUPS),
                ("cols", ctypes.c_longlong * COST_MAX_GROUPS),
                ("w", ctypes.c_int * COST_MAX_GROUPS),
                ("tile_lo", ctypes.c_int * COST_MAX_GROUPS),
                ("first_block", ctypes.c_int * COST_MAX_GROUPS),
                ("n", ctypes.c_int), ("block_np", ctypes.c_int),
                ("per_tile", ctypes.c_int), ("n_pts", ctypes.c_int)]


def _cuda_cost(prep, loss, loss_scale, counter):
    """Both cost wrappers' kernel (``cost_band``): one launch over all the
    prep's width groups, one thread a point, then one warp sums the blocks'
    partials in order."""
    from deeparc_tpu_torch.kernels.build import check, library

    pts, bn = prep["points"].contiguous(), prep["block_np"]
    tbl = prep["tbl"].contiguous()
    pxms = tuple(p.contiguous() for p in prep["pxms"])
    dt, ls = _cuda_args(pts, loss, (tbl,) + pxms)
    groups = prep["groups"]
    starts = prep["starts"].to(torch.int32).contiguous()
    launch = cost_launch(groups, bn)
    if launch.n_blocks == 0:
        return torch.zeros((), dtype=pts.dtype, device=pts.device)
    g = _CostGroups(n=len(groups), block_np=bn, per_tile=launch.per_tile,
                    n_pts=pts.shape[0])
    for i, ((w, lo, hi), p, first) in enumerate(zip(groups, pxms,
                                                    launch.first_blocks)):
        g.pxm[i], g.cols[i] = p.data_ptr(), (hi - lo) * bn
        g.w[i], g.tile_lo[i], g.first_block[i] = w, lo, first
    partial = torch.empty((launch.n_blocks,), dtype=pts.dtype,
                          device=pts.device)
    cost = torch.empty((), dtype=pts.dtype, device=pts.device)
    counter.launches += 1
    check(library().rig_cost_band(
        dt, ls, tbl.data_ptr(), starts.data_ptr(),
        pts.data_ptr(), ctypes.addressof(g), launch.n_blocks, launch.threads,
        float(loss_scale), partial.data_ptr(), cost.data_ptr(),
        torch.cuda.current_stream(pts.device).cuda_stream), "rig_cost_band")
    return cost


def _dispatch(t: torch.Tensor, name: str) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


# ---------------------------------------------------------------------------
# Public wrappers and their plain versions
# ---------------------------------------------------------------------------


def linearize_grid_banded_plain(
    points, point_free, sp, grid, free_outer, free_inner, free_intr, starts,
    w_band, loss="trivial", loss_scale=0.5, block_np=256, intr_frozen=False,
    pxm=None,
):
    """Plain PyTorch version of :func:`linearize_grid_banded`."""
    prep = _prep_linearize_banded(points, point_free, sp, grid, free_outer,
                                  free_inner, free_intr, starts, w_band,
                                  block_np, intr_frozen, pxm)
    return _plain_linearize(prep, loss, loss_scale)


@kernel_boundary
def linearize_grid_banded(
    points, point_free, sp, grid, free_outer, free_inner, free_intr, starts,
    w_band, loss="trivial", loss_scale=0.5, block_np=256, intr_frozen=False,
    pxm=None,
):
    """Fused linearization over per-tile cell bands.

    ``starts`` is the (n_pad / block_np,) int32 8-row slab start per point
    tile from :func:`deeparc_tpu_torch.solver.rig_band.band_grid`;
    ``w_band`` one width (multiple of 8, <= t_pad) or a tuple of
    ``(w, tile_lo, tile_hi)`` width groups; ``pxm`` the pre-gathered
    :func:`gather_banded_planes` stack(s) for these groups.
    ``intr_frozen=True`` returns an ext-only E (N, 3, 6R) and zero intrinsic
    slot entries. Returns (cost, g_p (N,3), hpp (N,3,3), g_slots (T,18),
    hcc_slots (T,18,18), E_native (N, 3, Cn))."""
    if not _dispatch(points, "linearize_grid_banded"):
        return linearize_grid_banded_plain(
            points, point_free, sp, grid, free_outer, free_inner, free_intr,
            starts, w_band, loss, loss_scale, block_np, intr_frozen, pxm)
    prep = _prep_linearize_banded(points, point_free, sp, grid, free_outer,
                                  free_inner, free_intr, starts, w_band,
                                  block_np, intr_frozen, pxm)
    return _cuda_linearize(prep, loss, loss_scale, linearize_grid_banded,
                           band=True)


def cost_grid_banded_plain(points, sp, grid, starts, w_band, loss="trivial",
                           loss_scale=0.5, block_np=1024, pxm=None):
    """Plain PyTorch version of :func:`cost_grid_banded`."""
    prep = _prep_cost_banded(points, sp, grid, starts, w_band, block_np, pxm)
    return _plain_cost(prep, loss, loss_scale)


@kernel_boundary
def cost_grid_banded(points, sp, grid, starts, w_band, loss="trivial",
                     loss_scale=0.5, block_np=1024, pxm=None):
    """Banded robustified half-SSE (the trial-cost pass over live bands).
    ``starts``/``pxm`` are the band table and stacks built for THIS
    ``block_np``; ``w_band`` as in :func:`linearize_grid_banded`."""
    if not _dispatch(points, "cost_grid_banded"):
        return cost_grid_banded_plain(points, sp, grid, starts, w_band, loss,
                                      loss_scale, block_np, pxm)
    prep = _prep_cost_banded(points, sp, grid, starts, w_band, block_np, pxm)
    return _cuda_cost(prep, loss, loss_scale, cost_grid_banded)


def linearize_grid_plain(points, point_free, sp, grid, free_outer, free_inner,
                         free_intr, loss="trivial", loss_scale=0.5,
                         block_np=256, pxm=None):
    """Plain PyTorch version of :func:`linearize_grid`."""
    prep = _prep_linearize_mono(points, point_free, sp, grid, free_outer,
                                free_inner, free_intr, block_np, pxm)
    return _plain_linearize(prep, loss, loss_scale)


@kernel_boundary
def linearize_grid(points, point_free, sp, grid, free_outer, free_inner,
                   free_intr, loss="trivial", loss_scale=0.5, block_np=256,
                   pxm=None):
    """Fused full-problem linearization over all t_pad cells. Returns the
    same tuple as :func:`linearize_grid_banded`; E always holds the
    intrinsic columns. ``pxm`` is the grid's :func:`mono_planes` stack,
    built here when not given (a solve builds it once)."""
    if not _dispatch(points, "linearize_grid"):
        return linearize_grid_plain(points, point_free, sp, grid, free_outer,
                                    free_inner, free_intr, loss, loss_scale,
                                    block_np, pxm)
    prep = _prep_linearize_mono(points, point_free, sp, grid, free_outer,
                                free_inner, free_intr, block_np, pxm)
    return _cuda_linearize_mono(prep, loss, loss_scale)


def cost_grid_plain(points, sp, grid, loss="trivial", loss_scale=0.5,
                    block_np=1024, pxm=None):
    """Plain PyTorch version of :func:`cost_grid`."""
    return _plain_cost(_prep_cost_mono(points, sp, grid, block_np, pxm), loss,
                       loss_scale)


@kernel_boundary
def cost_grid(points, sp, grid, loss="trivial", loss_scale=0.5,
              block_np=1024, pxm=None):
    """Fused robustified half-SSE over the whole grid (trial-cost pass).
    ``pxm`` as for :func:`linearize_grid`: one width group of t_pad cells,
    every band at cell 0, over ``block_np``-point tiles."""
    if not _dispatch(points, "cost_grid"):
        return cost_grid_plain(points, sp, grid, loss, loss_scale, block_np,
                               pxm)
    return _cuda_cost(_prep_cost_mono(points, sp, grid, block_np, pxm),
                      loss, loss_scale, cost_grid)


# ---------------------------------------------------------------------------
# The step's Schur reduction (csrc/rig_schur.cu)
# ---------------------------------------------------------------------------


def _check_schur(E, binv, g_p):
    """Raise on what the Schur reduction does not take, on any device."""
    if E.ndim != 3 or E.shape[1] != 3:
        raise ValueError(f"schur_reduce takes E as (N, 3, Cn), not "
                         f"{tuple(E.shape)}")
    N, _, Cn = E.shape
    if Cn % 6:
        raise ValueError(f"schur_reduce takes E with a multiple of 6 "
                         f"columns, not {Cn}")
    if tuple(binv.shape) != (N, 3, 3) or tuple(g_p.shape) != (N, 3):
        raise ValueError(f"schur_reduce takes binv (N, 3, 3) and g_p (N, 3) "
                         f"for E's N = {N}, not {tuple(binv.shape)} and "
                         f"{tuple(g_p.shape)}")
    if E.dtype not in _DTYPE_IDS:
        raise TypeError(f"schur_reduce takes float32 or float64, not "
                        f"{E.dtype}")
    for t in (binv, g_p):
        if t.dtype != E.dtype or t.device != E.device:
            raise TypeError(f"schur_reduce input {t.dtype} on {t.device}: "
                            f"binv and g_p must be E's {E.dtype} on "
                            f"{E.device}")
    if not E.is_contiguous():
        raise ValueError("schur_reduce takes a contiguous E")


# schur_tiles' output tile width and points of a chunk (csrc/rig_schur.cu)
_SCHUR_TILE, _SCHUR_CHUNK = 64, 8
# schur_tiles' blocks in one wave, by (dtype id, device index): the launcher
# is set up once a device and dtype
_SCHUR_WAVE: dict = {}


def _schur_wave(lib, dt, dev):
    """Blocks of ``schur_tiles`` that fill ``dev`` in one wave, setting the
    kernel up there on the first call for the dtype."""
    key = (dt, dev.index)
    if key not in _SCHUR_WAVE:
        with torch.cuda.device(dev):
            wave = lib.rig_schur_setup(dt)
        if wave < 0:
            raise RuntimeError(f"rig_schur_setup: cudaError {-wave}")
        _SCHUR_WAVE[key] = wave
    return _SCHUR_WAVE[key]


def _schur_slices(wave, N, Cn):
    """Slices of the N points for ``schur_tiles``: as many as fill one wave
    of ``wave`` blocks with one block a tile of the upper triangle and a
    slice, at most one a chunk of points, at least one."""
    tiles = -(-Cn // _SCHUR_TILE)
    return max(1, min(wave // (tiles * (tiles + 1) // 2),
                      -(-N // _SCHUR_CHUNK)))


def _cuda_schur(E, binv, g_p):
    """``schur_tiles`` over the upper triangle's tiles and as many slices
    of the points as fill one wave (at most one a chunk), then
    ``schur_sum_slices`` in slice order."""
    from deeparc_tpu_torch.kernels.build import check, library

    lib = library()
    N, _, Cn = E.shape
    dt, dev, dtype = _DTYPE_IDS[E.dtype], E.device, E.dtype
    if E.data_ptr() % (2 * E.element_size()):
        raise ValueError("schur_reduce takes E aligned to two values")
    n_slices = _schur_slices(_schur_wave(lib, dt, dev), N, Cn)
    parts = torch.empty(n_slices * (Cn * Cn + Cn), dtype=dtype, device=dev)
    out = torch.empty(Cn * Cn + Cn, dtype=dtype, device=dev)
    corr, v = out[:Cn * Cn].view(Cn, Cn), out[Cn * Cn:]
    schur_reduce.launches += 1
    check(lib.rig_schur_reduce(
        dt, E.data_ptr(), binv.data_ptr(), g_p.data_ptr(), N, Cn, n_slices,
        parts.data_ptr(), parts[n_slices * Cn * Cn:].data_ptr(),
        corr.data_ptr(), v.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "rig_schur_reduce")
    return corr, v


def schur_reduce_plain(E, binv, g_p):
    """Plain PyTorch version of :func:`schur_reduce`: be = B^-1 E and
    B^-1 g_p as batched 3x3 products, then E2.T @ each, E2 being E as
    (3N, Cn)."""
    N, _, Cn = E.shape
    E2 = E.reshape(N * 3, Cn)
    bg = torch.einsum("pij,pj->pi", binv, g_p).reshape(-1)
    be = torch.einsum("pij,pjd->pid", binv, E).reshape(N * 3, Cn)
    return E2.T @ be, E2.T @ bg


@kernel_boundary
def schur_reduce(E, binv, g_p):
    """The grid step's Schur reduction in one pass over E: (corr, v) =
    (E^T B^-1 E (Cn, Cn), E^T B^-1 g_p (Cn,)), in E's own column order,
    from E (N, 3, Cn) contiguous, binv (N, 3, 3) and g_p (N, 3). No
    (3N, Cn) product is formed on the card. Cn must be a multiple of 6."""
    _check_schur(E, binv, g_p)
    if not _dispatch(E, "schur_reduce"):
        return schur_reduce_plain(E, binv, g_p)
    return _cuda_schur(E, binv.contiguous(), g_p.contiguous())


KERNEL_WRAPPERS = (linearize_grid_banded, cost_grid_banded, linearize_grid,
                   cost_grid, schur_reduce)
for _fn in KERNEL_WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
