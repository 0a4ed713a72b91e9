// Grid-engine kernels for Hopper (sm_90a): the fused linearization and the
// robust cost pass over per-tile cell bands.
//
// Replaces the four Pallas TPU kernels of deeparc_tpu/kernels/rig_pallas.py:
//   linearize_grid_banded (:615, body _banded_linearize_kernel :473)
//   cost_grid_banded      (:777, body _banded_cost_kernel :751)
//   linearize_grid        (:363, body _linearize_kernel :278)
//   cost_grid             (:859, body _cost_kernel :159)
// The monolithic pair takes the banded pair's tables with every tile's band
// starting at cell 0, one group of width t_pad and no cyclic extension (the
// wrappers in kernels/rig_grid.py build those tables). Both cost wrappers
// run cost_band (below), one launch a call; linearize_grid runs
// linearize_mono (below) and falls back to linearize_kernel only for a rig
// whose E row does not fit its shared-memory tile.
//
// Design of linearize_kernel (linearize_grid_banded). One thread owns one
// point of a tile of blockDim.x points and walks the tile's band of w cells;
// a block loops over several tiles (grid-stride) so the per-block scratch
// stays bounded.
//   * point side: g_p and the 6 unique H_pp entries stay in registers;
//   * E: the point's row belongs to its thread, so the one-hot contractions
//     of the TPU kernel become direct read-modify-writes at column
//     j*R + row (extrinsic) / 6R + j*K + k (intrinsic) with no race; a tile's
//     E rows are zeroed first with coalesced stores;
//   * slot side: the per-cell gradient and upper-triangular Gram are a
//     reduction across points: warp shuffles, then a per-warp stage in
//     shared memory, summed by the block into ITS OWN partial rows
//     (n_blocks, t_ext, NV). A second kernel sums the partials over blocks
//     in a fixed order, folds the cyclic-extension rows back and expands
//     the triangle into the (T, 18) / (T, 18, 18) outputs. No float atomics
//     anywhere, so every run gives the same bits.
//   * cost: per-thread sums, a block reduction into per-block partials and a
//     fixed-order second pass.
//
// What bounds linearize_kernel on the card. The E row: 3 * Cn values per
// point (576 doubles at the flagship's 32 extrinsic rows, ext-only) written
// once by the zeroing pass and read-modified-written per live slot at
// scattered columns -- device-memory traffic with poor coalescing. Then the
// slot reduction: NV = 90 (ext-only) or 189 warp reductions per cell, five
// shuffles each. The float64 linearize needs up to 178 registers a thread
// (no spills), so one 256-thread block fills an SM's register file.
// Measured on the monolithic shapes (400k points x 192 cells), the E
// read-modify-writes were two thirds of the kernel's time and the warp
// sums a fifth; linearize_mono is built around both. Its own note says
// what bounds it.
#include <cuda_runtime.h>

#include "rig_slot.cuh"

namespace rig {

template <typename S, int LOSS, int NP>
__global__ void __launch_bounds__(256)
linearize_kernel(const S* __restrict__ tbl, const int* __restrict__ ids,
                 const int* __restrict__ starts, const S* __restrict__ pts,
                 const S* __restrict__ pxm, int t_ext, int n_pad, int R, int K,
                 int t_lo, int g_tiles, int w, S scale, S* __restrict__ pout,
                 S* __restrict__ E, S* __restrict__ partial,
                 S* __restrict__ partial_cost) {
  constexpr int NV = NP + NP * (NP + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* stage = reinterpret_cast<S*>(smem_raw);  // [2][nwarps][NV]
  __shared__ S cost_stage[32];

  const int bn = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = bn >> 5;
  const int Cn = NP == 18 ? 6 * (R + K) : 6 * R;
  const long gcols = (long)g_tiles * bn;
  S* part = partial + (size_t)blockIdx.x * t_ext * NV;
  S cost_acc = S(0);
  int buf = 0;

  for (int i = blockIdx.x; i < g_tiles; i += gridDim.x) {
    const int tile = t_lo + i;
    const long p = (long)tile * bn + tid;
    S* E_tile = E + (size_t)tile * bn * 3 * Cn;
    for (long q = tid; q < (long)bn * 3 * Cn; q += bn) E_tile[q] = S(0);
    __syncthreads();

    S X[3], pf[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      X[a] = pts[(long)a * n_pad + p];
      pf[a] = pts[(long)(3 + a) * n_pad + p];
    }
    S gp[3] = {S(0), S(0), S(0)};
    S hp[6] = {S(0), S(0), S(0), S(0), S(0), S(0)};
    S* e_row = E + p * 3 * Cn;
    const int row0 = starts[tile] * 8;

    for (int cell = 0; cell < w; ++cell) {
      const int row = row0 + cell;
      const S* c = tbl + (long)row * SP_COLS;
      const long off = (long)cell * gcols + (long)i * bn + tid;
      const S xy0 = pxm[off];
      const S xy1 = pxm[(long)w * gcols + off];
      const S mask = pxm[2L * w * gcols + off];
      S r0, r1, jx[2][3], P[2][NP];
      cost_acc += slot_products<S, LOSS, NP>(c, X, pf, xy0, xy1, mask, scale,
                                             r0, r1, jx, P);
#pragma unroll
      for (int a = 0; a < 3; ++a) gp[a] += jx[0][a] * r0 + jx[1][a] * r1;
      {
        int h = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = a; b < 3; ++b, ++h)
            hp[h] += jx[0][a] * jx[0][b] + jx[1][a] * jx[1][b];
      }
      // every term of a dead slot is zero: skip its scattered E updates
      if (mask != S(0)) {
        const int o = ids[row], in = ids[t_ext + row], kk = ids[2 * t_ext + row];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          S* e = e_row + a * Cn;
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            if (o >= 0) e[b * R + o] += jx[0][a] * P[0][b] + jx[1][a] * P[1][b];
            if (in >= 0)
              e[b * R + in] += jx[0][a] * P[0][6 + b] + jx[1][a] * P[1][6 + b];
            if (NP == 18 && kk >= 0)
              e[6 * R + b * K + kk] +=
                  jx[0][a] * P[0][NP - 6 + b] + jx[1][a] * P[1][NP - 6 + b];
          }
        }
      }
      // slot side: reduce each value over the block's points
      S* st = stage + (size_t)(buf * nwarps + warp) * NV;
      int v = 0;
#pragma unroll
      for (int a = 0; a < NP; ++a, ++v) {
        const S x = warp_sum(P[0][a] * r0 + P[1][a] * r1);
        if (lane == 0) st[v] = x;
      }
#pragma unroll
      for (int a = 0; a < NP; ++a)
#pragma unroll
        for (int b = a; b < NP; ++b, ++v) {
          const S x = warp_sum(P[0][a] * P[0][b] + P[1][a] * P[1][b]);
          if (lane == 0) st[v] = x;
        }
      // one barrier per cell: the stage is double-buffered, so the next
      // cell's writes go to the other half while this half is being read
      __syncthreads();
      const S* sb = stage + (size_t)buf * nwarps * NV;
      for (int q = tid; q < NV; q += bn) {
        S s = S(0);
        for (int ww = 0; ww < nwarps; ++ww) s += sb[ww * NV + q];
        part[(long)row * NV + q] += s;
      }
      buf ^= 1;
    }

    pout[0L * n_pad + p] = gp[0];
    pout[1L * n_pad + p] = gp[1];
    pout[2L * n_pad + p] = gp[2];
    const int hidx[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        pout[(long)(3 + 3 * a + b) * n_pad + p] = hp[hidx[a][b]];
  }

  cost_acc = warp_sum(cost_acc);
  if (lane == 0) cost_stage[warp] = cost_acc;
  __syncthreads();
  if (tid == 0) {
    S s = S(0);
    for (int ww = 0; ww < nwarps; ++ww) s += cost_stage[ww];
    partial_cost[blockIdx.x] += s;
  }
}

// ---------------------------------------------------------------------------
// linearize_grid: the monolithic linearize (every point against all t_pad
// cells, 18 camera columns)
// ---------------------------------------------------------------------------

constexpr int MONO_PTS = 32;   // points of a block's tile, one per lane
constexpr int MONO_WARPS = 8;  // warps of a block; each takes every 8th cell
constexpr int MONO_LD = 33;    // stage row stride: one point per bank pair
constexpr int MONO_NV = 18 + 18 * 19 / 2;

// A block owns one tile of 32 points at a time and keeps the tile's whole E
// (32 x 3 Cn values) in shared memory; the lane's E value q sits at
// q * 32 + (lane ^ (q & 31)), so a warp's 32 lanes hit 32 banks both when
// they add at one column and when the block writes rows out.
template <typename S>
__device__ __forceinline__ S& e_at(S* Es, int q, int pt) {
  return Es[(size_t)q * MONO_PTS + (pt ^ (q & 31))];
}

// A two-warp named barrier: the waiting warp syncs, the warp before it
// arrives; shared-memory writes before the arrive are seen after the sync.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(64) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(64) : "memory");
}

// Warp w walks cells w, w + 8, ... of the tile. Per cell:
//   * the slot chain (rig_slot.cuh) for the lane's point; g_p / H_pp / cost
//     accumulate per lane;
//   * E: the cell's 54 terms are added to the shared tile in CELL ORDER:
//     warp w adds after warp w - 1 has added (warp 0 after warp 7 of the
//     previous 8 cells), handed on through named barriers, so every run
//     adds in the same order and no two warps touch E at once;
//   * slot Gram: the warp stages its 32 points' P (18 columns) and r, one
//     residual row k at a time, in shared memory; lane l < 27 then forms a
//     3x3 block of the upper Gram (21 blocks) or of P^T r (6 blocks) as dot
//     products over the staged rows, and adds it into the block's own
//     partial row of the cell (the cell is always this warp's, so no race).
// The tile's E rows are then written out once, contiguous and coalesced.
//
// What bounds it on the card. E now costs its one coalesced write (2.3 GB
// at 400k points x 720 columns, ~0.7 ms) and shared-memory adds. The f64
// E tile (184 KB) leaves room for one block, 8 warps, per SM, with 252
// registers a thread, and at that occupancy the slot chain alone takes
// about half the kernel; the E hand-offs and the Gram's shared-memory
// loads make up the rest and overlap. The float64 Gram on the tensor
// cores (mma.m8n8k4) measured within 2% of these FMAs, so it was not
// kept. The E tile needs 3 * Cn * 32 values: a rig with more than ~40
// extrinsic plus intrinsic rows in float64 takes linearize_kernel.
template <typename S, int LOSS>
__global__ void __launch_bounds__(MONO_PTS * MONO_WARPS, sizeof(S) == 4 ? 2 : 1)
linearize_mono(const S* __restrict__ tbl, const int* __restrict__ ids,
               const S* __restrict__ pts, const S* __restrict__ pxm,
               int t_pad, int n_pad, int R, int K, int n_tiles, S scale,
               S* __restrict__ pout, S* __restrict__ E,
               S* __restrict__ partial, S* __restrict__ partial_cost) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ S cost_stage[MONO_WARPS];
  const int Cn = 6 * (R + K), ecols = 3 * Cn;
  S* Es = reinterpret_cast<S*>(smem_raw);
  S* stage_all = Es + (size_t)ecols * MONO_PTS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  S* st = stage_all + warp * 19 * MONO_LD;
  // E hand-offs: named barrier 1 + w passes the turn to warp w
  const int bar_wait = 1 + warp, bar_pass = 1 + (warp + 1) % MONO_WARPS;

  // this lane's 3x3 block: staged columns ca (rows of the block) x cb
  // (columns); lanes 21..26 take P^T r (cb = the staged r), 27..31 idle
  int ca = 0, cb = 0, blkI = 0, blkJ = 0;
  if (lane < 21) {
    int l = lane;
    while (l >= 6 - blkI) {
      l -= 6 - blkI;
      ++blkI;
    }
    blkJ = blkI + l;
    ca = 3 * blkI;
    cb = 3 * blkJ;
  } else {
    blkI = lane < 27 ? lane - 21 : 0;
    ca = 3 * blkI;
    cb = 18;
  }
  const int cb_step = lane < 21 ? 1 : 0;
  // where each of the lane's nine sums goes in a cell's partial row (-1:
  // below the diagonal, a padding column, or an idle lane)
  int vidx[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int a = ca + i, b = cb + j;
      vidx[i][j] = lane < 21 ? (a <= b ? 18 + a * 18 - a * (a - 1) / 2 + (b - a)
                                       : -1)
                             : (lane < 27 && j == 0 ? a : -1);
    }
  S* part = partial + (size_t)blockIdx.x * t_pad * MONO_NV;
  S cost_acc = S(0);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long p = (long)tile * MONO_PTS + lane;
    for (int q = threadIdx.x; q < ecols * MONO_PTS; q += blockDim.x)
      Es[q] = S(0);
    __syncthreads();

    S X[3], pf[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      X[a] = pts[(long)a * n_pad + p];
      pf[a] = pts[(long)(3 + a) * n_pad + p];
    }
    S gp[3] = {S(0), S(0), S(0)};
    S hp[6] = {S(0), S(0), S(0), S(0), S(0), S(0)};

    // the lane's observation of its next cell is loaded one cell ahead
    const long plane = (long)t_pad * n_pad;
    S nxt[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) nxt[e] = pxm[e * plane + (long)warp * n_pad + p];
    for (int cell = warp; cell < t_pad; cell += MONO_WARPS) {
      const S* c = tbl + (long)cell * SP_COLS;
      const S xy0 = nxt[0], xy1 = nxt[1], mask = nxt[2];
      if (cell + MONO_WARPS < t_pad) {
        const long off = (long)(cell + MONO_WARPS) * n_pad + p;
#pragma unroll
        for (int e = 0; e < 3; ++e) nxt[e] = pxm[e * plane + off];
      }
      S r0, r1, jx[2][3], P[2][18];
      cost_acc += slot_products<S, LOSS, 18>(c, X, pf, xy0, xy1, mask, scale,
                                             r0, r1, jx, P);
#pragma unroll
      for (int a = 0; a < 3; ++a) gp[a] += jx[0][a] * r0 + jx[1][a] * r1;
      {
        int h = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = a; b < 3; ++b, ++h)
            hp[h] += jx[0][a] * jx[0][b] + jx[1][a] * jx[1][b];
      }

      // E: the cell's terms for its outer, inner and intrinsic rows. An
      // inner row equal to the outer one is added with the outer group, so
      // each group's 18 addresses are distinct and load together.
      const int o = ids[cell], in = ids[t_pad + cell], kk = ids[2 * t_pad + cell];
      const bool merged = in == o;
      const int grow[3] = {o, merged ? -1 : in, kk};
      if (cell > 0) named_sync(bar_wait);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        if (grow[g] < 0) continue;
        const int q0 = g < 2 ? grow[g] : 6 * R + grow[g];
        const int qs = g < 2 ? R : K;
        S cur[3][6];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 6; ++b) cur[a][b] = e_at(Es, a * Cn + q0 + b * qs, lane);
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            S v = jx[0][a] * P[0][6 * g + b] + jx[1][a] * P[1][6 * g + b];
            if (g == 0 && merged)
              v += jx[0][a] * P[0][6 + b] + jx[1][a] * P[1][6 + b];
            e_at(Es, a * Cn + q0 + b * qs, lane) = cur[a][b] + v;
          }
      }
      if (cell + 1 < t_pad) named_arrive(bar_pass);

      // slot Gram over the tile's 32 points, one residual row at a time
      S acc[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[i][j] = S(0);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int v = 0; v < 18; ++v) st[v * MONO_LD + lane] = P[k][v];
        st[18 * MONO_LD + lane] = k == 0 ? r0 : r1;
        __syncwarp();
#pragma unroll 4
        for (int pt = 0; pt < MONO_PTS; ++pt) {
          S x[3], y[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            x[i] = st[(ca + i) * MONO_LD + pt];
            y[i] = st[(cb + i * cb_step) * MONO_LD + pt];
          }
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) acc[i][j] += x[i] * y[j];
        }
        __syncwarp();
      }
      // into the block's partial row of this cell: every load first, so
      // the nine read-modify-writes wait on memory once
      S* prow = part + (long)cell * MONO_NV;
      S prev[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          prev[i][j] = vidx[i][j] >= 0 ? prow[vidx[i][j]] : S(0);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (vidx[i][j] >= 0) prow[vidx[i][j]] = prev[i][j] + acc[i][j];
    }
    __syncthreads();

    // g_p / H_pp: the eight warps' partial sums per point, in warp order
    S* red = stage_all;  // [warp][9][32]
#pragma unroll
    for (int a = 0; a < 3; ++a) red[(warp * 9 + a) * MONO_PTS + lane] = gp[a];
#pragma unroll
    for (int h = 0; h < 6; ++h) red[(warp * 9 + 3 + h) * MONO_PTS + lane] = hp[h];
    __syncthreads();
    if (warp == 0) {
      S s[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) s[e] = S(0);
      for (int w = 0; w < MONO_WARPS; ++w)
#pragma unroll
        for (int e = 0; e < 9; ++e) s[e] += red[(w * 9 + e) * MONO_PTS + lane];
#pragma unroll
      for (int a = 0; a < 3; ++a) pout[(long)a * n_pad + p] = s[a];
      const int hidx[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          pout[(long)(3 + 3 * a + b) * n_pad + p] = s[3 + hidx[a][b]];
    }
    // the tile's E rows, contiguous in E: one coalesced pass
    S* E_tile = E + (size_t)tile * MONO_PTS * ecols;
    for (int pt = 0; pt < MONO_PTS; ++pt)
      for (int q = threadIdx.x; q < ecols; q += blockDim.x)
        E_tile[(size_t)pt * ecols + q] = e_at(Es, q, pt);
    __syncthreads();
  }

  cost_acc = warp_sum(cost_acc);
  if (lane == 0) cost_stage[warp] = cost_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    S s = S(0);
    for (int w = 0; w < MONO_WARPS; ++w) s += cost_stage[w];
    partial_cost[blockIdx.x] = s;
  }
}

// Dynamic shared memory of linearize_mono: the E tile and the warps' stages.
inline size_t mono_smem_bytes(int Cn, size_t esz) {
  return ((size_t)3 * Cn * MONO_PTS + (size_t)MONO_WARPS * 19 * MONO_LD) * esz;
}

template <typename S, int LOSS>
cudaError_t mono_attr(size_t smem) {
  return cudaFuncSetAttribute(linearize_mono<S, LOSS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// ---------------------------------------------------------------------------
// The trial cost: cost_grid_banded and cost_grid
// ---------------------------------------------------------------------------
//
// Replaces cost_grid_banded (rig_pallas.py:777, body _banded_cost_kernel
// :751) and cost_grid (:859, body _cost_kernel :159) with one kernel,
// cost_band, launched once per call over all of the call's width groups
// (CostGroups, by value). cost_grid is one group of width t_pad whose bands
// all start at cell 0 (a start table of zeros).
//
// A block owns up to COST_THREADS points of one tile, one thread a point,
// and walks the tile's band of w cells in order: table rows
// [starts[tile] * 8, starts[tile] * 8 + w) of the cyclically extended table.
// It stages the 30 table columns the residual chain reads (R_i, R_o, t_i,
// t_o, c, f, d: CostCols) for COST_CELLS cells at a time in shared memory,
// where every lane of a warp reads the same value (a broadcast). Per cell
// the thread reads its slot's mask first (one coalesced plane row per warp)
// and loads xy0 / xy1 and runs the chain only for a live slot: a dead slot
// adds exactly zero to the cost, and 79% (uniform rig) to 86% (occlusion
// flagship's bands) of the slots are dead. Per-thread sums go through a
// warp sum and the block's warps in order into one partial per block,
// summed by one warp in a fixed order (reduce_cost_lanes): no float
// atomics, the same bits every run.
//
// What bounds it on the card. Device-memory bytes: the mask planes are read
// whole, the xy planes only in the 32-byte sectors that hold a live slot.
// One launch covers every group, ~1,560 blocks of 256 threads at 400k
// points, so the card is full whatever the groups' sizes; the f64 divide of
// the perspective chain is the longest dependent step, and several warps per
// scheduler hide it. Dead lanes idle through a warp's chain when one lane of
// the warp is live.
constexpr int COST_THREADS = 256;
constexpr int COST_CELLS = 96;     // cells of the table staged at a time
constexpr int COST_COLS = 30;      // table columns of the residual chain
constexpr int COST_GROUP = 4;      // cells whose loads a thread issues at once
constexpr int COST_MAX_GROUPS = 8; // width groups of one launch

// The staged table's columns: grid columns 0..17 (R_i, R_o), then 45..56
// (t_i, t_o, c, f, d).
struct CostCols {
  static constexpr int RI = 0, RO = 9, TI = 18, TO = 21, CX = 24, CY = 25;
  static constexpr int FX = 26, FY = 27, D0 = 28, D1 = 29;
  static constexpr bool ZGUARD = false;
};
static_assert(RO == 9 && TI == 45 && D1 == 56, "CostCols maps the grid table");

// The width groups of one launch (kernels/rig_grid.py _CostGroups holds the
// same layout). Group g's plane stack is (3, w[g], cols[g]): column
// (t - tile_lo[g]) * block_np + i holds point i of tile t. Its tiles take
// per_tile blocks each, from block first_block[g] on; block j of a group
// takes tile tile_lo[g] + j / per_tile, points (j % per_tile) * blockDim.x
// + [0, blockDim.x) of it. A group without tiles starts where the next one
// does and takes no block.
struct CostGroups {
  const void* pxm[COST_MAX_GROUPS];
  long long cols[COST_MAX_GROUPS];
  int w[COST_MAX_GROUPS];
  int tile_lo[COST_MAX_GROUPS];
  int first_block[COST_MAX_GROUPS];
  int n;         // groups
  int block_np;  // points of a tile
  int per_tile;  // blocks of a tile
  int n_pts;     // rows of the (n_pts, 3) points; later columns are padding
};

template <typename S, int LOSS>
__global__ void __launch_bounds__(COST_THREADS)
cost_band(const S* __restrict__ tbl, const int* __restrict__ starts,
          const S* __restrict__ pts, const CostGroups g, S scale,
          S* __restrict__ partial_cost) {
  __shared__ S ct[COST_CELLS * COST_COLS];
  __shared__ S cost_stage[COST_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the block's group: the last one that starts at or before it (constant
  // indices only, so the struct is read where the launch put it)
  const S* pxm = nullptr;
  long cols = 0;
  int w = 0, lo = 0, first = 0;
#pragma unroll
  for (int i = 0; i < COST_MAX_GROUPS; ++i)
    if (i < g.n && (int)blockIdx.x >= g.first_block[i]) {
      pxm = static_cast<const S*>(g.pxm[i]);
      cols = (long)g.cols[i];
      w = g.w[i];
      lo = g.tile_lo[i];
      first = g.first_block[i];
    }
  const int j = blockIdx.x - first;
  const int t = j / g.per_tile;  // tile within the group
  const int i_pt = (j - t * g.per_tile) * blockDim.x + tid;  // point in it
  const bool in = i_pt < g.block_np;
  const long col = (long)t * g.block_np + i_pt;
  const long p = (long)lo * g.block_np + col;
  const long row0 = (long)starts[lo + t] * 8;
  const long plane = (long)w * cols;
  // a padding point's slots are all dead: its X is never read
  S X[3] = {S(0), S(0), S(0)};
  if (in && p < g.n_pts) {
#pragma unroll
    for (int a = 0; a < 3; ++a) X[a] = pts[3 * p + a];
  }
  S acc = S(0);
  for (int c0 = 0; c0 < w; c0 += COST_CELLS) {
    const int nc = min(COST_CELLS, w - c0);
    __syncthreads();
    for (int q = tid; q < nc * COST_COLS; q += blockDim.x) {
      const int jc = q % COST_COLS;
      ct[q] = tbl[(row0 + c0 + q / COST_COLS) * SP_COLS +
                  (jc < 18 ? jc : 27 + jc)];
    }
    __syncthreads();
    if (!in) continue;
    // cells in groups of COST_GROUP: a group's live xy loads go out
    // together with the next group's masks, then its chains run
    const S* mrow = pxm + 2 * plane + col;
    S m[COST_GROUP];
#pragma unroll
    for (int u = 0; u < COST_GROUP; ++u)
      m[u] = u < nc ? mrow[(long)(c0 + u) * cols] : S(0);
    for (int c = 0; c < nc; c += COST_GROUP) {
      S x0[COST_GROUP], x1[COST_GROUP], mn[COST_GROUP];
#pragma unroll
      for (int u = 0; u < COST_GROUP; ++u) {
        const long off = (long)(c0 + c + u) * cols + col;
        x0[u] = m[u] != S(0) ? pxm[off] : S(0);
        x1[u] = m[u] != S(0) ? pxm[plane + off] : S(0);
      }
#pragma unroll
      for (int u = 0; u < COST_GROUP; ++u) {
        const int cn = c + COST_GROUP + u;
        mn[u] = cn < nc ? mrow[(long)(c0 + cn) * cols] : S(0);
      }
#pragma unroll
      for (int u = 0; u < COST_GROUP; ++u)
        if (m[u] != S(0))
          acc += slot_cost<S, LOSS, CostCols>(ct + (c + u) * COST_COLS, X,
                                              x0[u], x1[u], m[u], scale);
#pragma unroll
      for (int u = 0; u < COST_GROUP; ++u) m[u] = mn[u];
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) cost_stage[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    S s = S(0);
    for (int ww = 0; ww < (int)(blockDim.x >> 5); ++ww) s += cost_stage[ww];
    partial_cost[blockIdx.x] = s;
  }
}

// Second pass of the slot reduction: sum the per-block partials in block
// order, fold the cyclic extension rows [t_pad, t_ext) onto cells
// [0, t_ext - t_pad), and expand the triangle into g_slots (T, 18) and the
// symmetric hcc_slots (T, 18, 18).
template <typename S>
__global__ void reduce_slots_kernel(const S* __restrict__ partial,
                                    int n_blocks, int t_ext, int t_pad, int T,
                                    int np, S* __restrict__ g_slots,
                                    S* __restrict__ hcc) {
  const int nv = np + np * (np + 1) / 2;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)T * nv) return;
  const int r = (int)(idx / nv), q = (int)(idx % nv);
  const bool fold = r + t_pad < t_ext;
  S s = S(0);
  for (int b = 0; b < n_blocks; ++b) {
    const S* pb = partial + (size_t)b * t_ext * nv;
    s += pb[(long)r * nv + q];
    if (fold) s += pb[(long)(r + t_pad) * nv + q];
  }
  if (q < np) {
    g_slots[r * 18 + q] = s;
    return;
  }
  int t = q - np, a = 0;
  while (t >= np - a) {
    t -= np - a;
    ++a;
  }
  const int b = a + t;
  hcc[((long)r * 18 + a) * 18 + b] = s;
  hcc[((long)r * 18 + b) * 18 + a] = s;
}

template <typename S>
__global__ void reduce_cost_kernel(const S* __restrict__ partial_cost,
                                   int n_blocks, S* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  S s = S(0);
  for (int b = 0; b < n_blocks; ++b) s += partial_cost[b];
  out[0] = s;
}

template <typename S, int LOSS>
cudaError_t launch_linearize(int intr_frozen, const void* tbl, const int* ids,
                             const int* starts, const void* pts,
                             const void* pxm, int t_ext, int n_pad, int R,
                             int K, int t_lo, int g_tiles, int bn, int w,
                             double scale, int grid, void* pout, void* E,
                             void* partial, void* partial_cost,
                             cudaStream_t stream) {
  const int nwarps = bn / 32;
  if (intr_frozen) {
    constexpr int NV = 12 + 12 * 13 / 2;
    linearize_kernel<S, LOSS, 12>
        <<<grid, bn, 2 * nwarps * NV * sizeof(S), stream>>>(
            (const S*)tbl, ids, starts, (const S*)pts, (const S*)pxm, t_ext,
            n_pad, R, K, t_lo, g_tiles, w, (S)scale, (S*)pout, (S*)E,
            (S*)partial, (S*)partial_cost);
  } else {
    constexpr int NV = 18 + 18 * 19 / 2;
    linearize_kernel<S, LOSS, 18>
        <<<grid, bn, 2 * nwarps * NV * sizeof(S), stream>>>(
            (const S*)tbl, ids, starts, (const S*)pts, (const S*)pxm, t_ext,
            n_pad, R, K, t_lo, g_tiles, w, (S)scale, (S*)pout, (S*)E,
            (S*)partial, (S*)partial_cost);
  }
  return cudaGetLastError();
}

}  // namespace rig

using namespace rig;

// dtype: 0 = float32, 1 = float64. loss: 0 trivial, 1 huber, 2 cauchy.
// Every launcher returns the cudaError_t of its launch (0 = success).
extern "C" int rig_linearize(int dtype, int loss, int intr_frozen,
                             const void* tbl, const void* ids,
                             const void* starts, const void* pts,
                             const void* pxm, int t_ext, int n_pad, int R,
                             int K, int t_lo, int g_tiles, int bn, int w,
                             double scale, int grid, void* pout, void* E,
                             void* partial, void* partial_cost, void* stream) {
  if (bn % 32 != 0 || bn > 256 || bn <= 0) return (int)cudaErrorInvalidValue;
  const int* id = (const int*)ids;
  const int* st = (const int*)starts;
  cudaStream_t s = (cudaStream_t)stream;
#define RIG_LIN(T, L)                                                        \
  return (int)launch_linearize<T, L>(intr_frozen, tbl, id, st, pts, pxm,    \
                                     t_ext, n_pad, R, K, t_lo, g_tiles, bn, \
                                     w, scale, grid, pout, E, partial,      \
                                     partial_cost, s)
  if (dtype == 1) {
    if (loss == TRIVIAL) RIG_LIN(double, TRIVIAL);
    if (loss == HUBER) RIG_LIN(double, HUBER);
    if (loss == CAUCHY) RIG_LIN(double, CAUCHY);
  } else if (dtype == 0) {
    if (loss == TRIVIAL) RIG_LIN(float, TRIVIAL);
    if (loss == HUBER) RIG_LIN(float, HUBER);
    if (loss == CAUCHY) RIG_LIN(float, CAUCHY);
  }
#undef RIG_LIN
  return (int)cudaErrorInvalidValue;
}

// Blocks of linearize_mono to launch for n_tiles tiles of 32 points (all
// resident at once), 0 when its shared-memory E tile (3 * Cn values a
// point) does not fit an SM, or -cudaError_t on a failed query.
extern "C" int rig_linearize_mono_grid(int dtype, int loss, int Cn,
                                       int n_tiles) {
  if ((dtype != 0 && dtype != 1) || loss < TRIVIAL || loss > CAUCHY)
    return -(int)cudaErrorInvalidValue;
  const size_t smem = mono_smem_bytes(Cn, dtype == 1 ? 8 : 4);
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  if (smem > (size_t)optin) return 0;
#define RIG_MONO_OCC(T, L)                                                   \
  e = mono_attr<T, L>(smem);                                                 \
  if (e == cudaSuccess)                                                      \
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                       \
        &per_sm, linearize_mono<T, L>, MONO_PTS * MONO_WARPS, smem)
  if (dtype == 1) {
    if (loss == TRIVIAL) { RIG_MONO_OCC(double, TRIVIAL); }
    if (loss == HUBER) { RIG_MONO_OCC(double, HUBER); }
    if (loss == CAUCHY) { RIG_MONO_OCC(double, CAUCHY); }
  } else {
    if (loss == TRIVIAL) { RIG_MONO_OCC(float, TRIVIAL); }
    if (loss == HUBER) { RIG_MONO_OCC(float, HUBER); }
    if (loss == CAUCHY) { RIG_MONO_OCC(float, CAUCHY); }
  }
#undef RIG_MONO_OCC
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  const long grid = (long)per_sm * sms;
  return (int)(grid < n_tiles ? grid : n_tiles);
}

extern "C" int rig_linearize_mono(int dtype, int loss, const void* tbl,
                                  const void* ids, const void* pts,
                                  const void* pxm, int t_pad, int n_pad,
                                  int R, int K, int n_tiles, double scale,
                                  int grid, void* pout, void* E,
                                  void* partial, void* partial_cost,
                                  void* stream) {
  if (grid <= 0 || t_pad % MONO_WARPS != 0 || n_pad != n_tiles * MONO_PTS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mono_smem_bytes(6 * (R + K), dtype == 1 ? 8 : 4);
  cudaStream_t s = (cudaStream_t)stream;
#define RIG_MONO(T, L)                                                       \
  {                                                                          \
    const cudaError_t e = mono_attr<T, L>(smem);                             \
    if (e != cudaSuccess) return (int)e;                                     \
    linearize_mono<T, L><<<grid, MONO_PTS * MONO_WARPS, smem, s>>>(          \
        (const T*)tbl, (const int*)ids, (const T*)pts, (const T*)pxm, t_pad, \
        n_pad, R, K, n_tiles, (T)scale, (T*)pout, (T*)E, (T*)partial,        \
        (T*)partial_cost);                                                   \
    return (int)cudaGetLastError();                                          \
  }
  if (dtype == 1) {
    if (loss == TRIVIAL) RIG_MONO(double, TRIVIAL)
    if (loss == HUBER) RIG_MONO(double, HUBER)
    if (loss == CAUCHY) RIG_MONO(double, CAUCHY)
  } else if (dtype == 0) {
    if (loss == TRIVIAL) RIG_MONO(float, TRIVIAL)
    if (loss == HUBER) RIG_MONO(float, HUBER)
    if (loss == CAUCHY) RIG_MONO(float, CAUCHY)
  }
#undef RIG_MONO
  return (int)cudaErrorInvalidValue;
}

// cost_grid_banded and cost_grid: cost_band over the groups, n_blocks blocks
// of `threads` points (one partial each), then one warp sums the partials in
// order into out.
extern "C" int rig_cost_band(int dtype, int loss, const void* tbl,
                             const void* starts, const void* pts,
                             const CostGroups* groups, int n_blocks,
                             int threads, double scale, void* partial_cost,
                             void* out, void* stream) {
  const CostGroups& g = *groups;
  if (!starts || g.n < 1 || g.n > COST_MAX_GROUPS || n_blocks <= 0 ||
      threads <= 0 ||
      threads > COST_THREADS || threads % 32 != 0 || g.block_np <= 0 ||
      (long)g.per_tile * threads < g.block_np || g.first_block[0] != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RIG_COST_BAND(T, L)                                                  \
  {                                                                          \
    cost_band<T, L><<<n_blocks, threads, 0, s>>>(                            \
        (const T*)tbl, (const int*)starts, (const T*)pts, g, (T)scale,       \
        (T*)partial_cost);                                                   \
    const cudaError_t e = cudaGetLastError();                                \
    if (e != cudaSuccess) return (int)e;                                     \
    reduce_cost_lanes<T><<<1, 32, 0, s>>>((const T*)partial_cost, n_blocks,  \
                                          (T*)out);                          \
    return (int)cudaGetLastError();                                          \
  }
  if (dtype == 1) {
    if (loss == TRIVIAL) RIG_COST_BAND(double, TRIVIAL)
    if (loss == HUBER) RIG_COST_BAND(double, HUBER)
    if (loss == CAUCHY) RIG_COST_BAND(double, CAUCHY)
  } else if (dtype == 0) {
    if (loss == TRIVIAL) RIG_COST_BAND(float, TRIVIAL)
    if (loss == HUBER) RIG_COST_BAND(float, HUBER)
    if (loss == CAUCHY) RIG_COST_BAND(float, CAUCHY)
  }
#undef RIG_COST_BAND
  return (int)cudaErrorInvalidValue;
}

extern "C" int rig_reduce_slots(int dtype, const void* partial, int n_blocks,
                                int t_ext, int t_pad, int T, int np,
                                void* g_slots, void* hcc, void* stream) {
  const int nv = np + np * (np + 1) / 2;
  const long n = (long)T * nv;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  if (blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    reduce_slots_kernel<double><<<blocks, threads, 0, s>>>(
        (const double*)partial, n_blocks, t_ext, t_pad, T, np,
        (double*)g_slots, (double*)hcc);
  else if (dtype == 0)
    reduce_slots_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)partial, n_blocks, t_ext, t_pad, T, np,
        (float*)g_slots, (float*)hcc);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int rig_reduce_cost(int dtype, const void* partial_cost,
                               int n_blocks, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    reduce_cost_kernel<double><<<1, 32, 0, s>>>((const double*)partial_cost,
                                                n_blocks, (double*)out);
  else if (dtype == 0)
    reduce_cost_kernel<float><<<1, 32, 0, s>>>((const float*)partial_cost,
                                               n_blocks, (float*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
