// linearize_grid_banded for Hopper (sm_90a): linearize_mono's design
// (rig_grid.cu) on the per-tile cell bands of the banded grid engine.
//
// Replaces the Pallas TPU kernel deeparc_tpu/kernels/rig_pallas.py:615
// linearize_grid_banded (body _banded_linearize_kernel :473) on the route
// where a tile's E fits in shared memory; kernels/rig_grid.py picks the
// route (rig_linearize_band_grid) and sends other rigs to linearize_kernel
// (rig_grid.cu). Its own file, so that nvcc builds it beside rig_grid.cu.
//
// What bounds it on the card. The old kernel spent ~12 of its 18 ms on E's
// zeroing pass and scattered read-modify-writes and ~3.5 on 90 warp sums a
// cell. Here E costs one coalesced write (1.84 GB at 400k points x 576
// columns in float64, ~0.6 ms) and shared-memory adds, the slot Gram
// shared-memory dot products, and a cell with no live observation in the
// tile costs a vote. What is left is the slot chain over the band's live
// cells at the occupancy the E tile allows: a 32-point float64 tile at the
// flagship's 32 extrinsic rows (147 KB) leaves room for one block of 8 warps
// per SM. 16-point tiles (two blocks per SM, two cells per warp) measured
// slower in float64 (7.0 against 5.3 ms; 128 registers with spills) and no
// faster in float32, so the tile is 32 points.
#include <cuda_runtime.h>

#include "rig_slot.cuh"

namespace rig {

constexpr int BAND_PTS = 32;   // points of a block's tile, one per lane
constexpr int BAND_WARPS = 8;  // warps of a block; each takes every 8th cell
constexpr int BAND_LD = 33;    // stage row stride: one point per bank pair

// A two-warp named barrier (as in rig_grid.cu): the waiting warp syncs, the
// warp before it arrives; shared-memory writes before the arrive are seen
// after the sync.
__device__ __forceinline__ void band_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(64) : "memory");
}
__device__ __forceinline__ void band_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(64) : "memory");
}

// A block owns a tile of 32 points at a time, with the band (start slab,
// width w) of the block_np-point tile it lies in, and keeps the tile's E
// (32 x 3 Cn values; Cn = 6 R ext-only, 6 (R + K) with the intrinsics) in
// shared memory: zeroed, summed and written once, contiguous and
// coalesced. Warp w takes cells w, w + 8, ... of the band (w is a multiple
// of 8), lane = point.
//   * A cell whose 32 observations are all dead adds nothing to any sum,
//     so its warp skips the slot chain (a whole-warp vote).
//   * E: the cells' terms are added in CELL ORDER, as in linearize_mono:
//     warp w after warp w - 1 through two-warp named barriers. Dead slots
//     add nothing.
//   * Slot gradient and Gram: the warp stages its cell's P (NP columns) and
//     r in shared memory; lane l < NB (NB + 1) / 2 + NB (NB = NP / 3: 14
//     lanes at NP = 12, 27 at NP = 18) forms one 3x3 block of the upper
//     Gram or of P^T r as dot products over the staged rows and adds it
//     into the block's own partial row of the cell's table row, which no
//     other warp touches in this tile.
// The per-block partial rows then go through rig_reduce_slots, as for
// linearize_kernel (the cyclic-extension fold included).
template <typename S>
__device__ __forceinline__ S& e_tile_at(S* Es, int q, int pt) {
  return Es[(size_t)q * BAND_PTS + (pt ^ (q & 31))];
}

template <typename S, int LOSS, int NP>
__global__ void __launch_bounds__(BAND_PTS * BAND_WARPS, sizeof(S) == 4 ? 2 : 1)
linearize_band(const S* __restrict__ tbl, const int* __restrict__ ids,
               const int* __restrict__ starts, const S* __restrict__ pts,
               const S* __restrict__ pxm, int t_ext, int n_pad, int R, int K,
               int t_lo, int block_np, int n_sub, int w, S scale,
               S* __restrict__ pout, S* __restrict__ E, S* __restrict__ partial,
               S* __restrict__ partial_cost) {
  constexpr int NV = NP + NP * (NP + 1) / 2;
  constexpr int NB = NP / 3;
  constexpr int NGRAM = NB * (NB + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ S cost_stage[BAND_WARPS];
  const int Cn = NP == 18 ? 6 * (R + K) : 6 * R, ecols = 3 * Cn;
  S* Es = reinterpret_cast<S*>(smem_raw);
  S* stage_all = Es + (size_t)ecols * BAND_PTS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  S* st = stage_all + warp * (NP + 1) * BAND_LD;
  const int bar_wait = 1 + warp, bar_pass = 1 + (warp + 1) % BAND_WARPS;

  // this lane's 3x3 block: staged columns ca (rows of the block) x cb
  int ca = 0, cb = 0, blkI = 0;
  const bool gram = lane < NGRAM, ptr = lane >= NGRAM && lane < NGRAM + NB;
  if (gram) {
    int l = lane;
    while (l >= NB - blkI) {
      l -= NB - blkI;
      ++blkI;
    }
    ca = 3 * blkI;
    cb = 3 * (blkI + l);
  } else if (ptr) {
    ca = 3 * (lane - NGRAM);
    cb = NP;
  }
  const int cb_step = gram ? 1 : 0;
  S* part = partial + (size_t)blockIdx.x * t_ext * NV;
  const long gcols = (long)n_sub * BAND_PTS;
  S cost_acc = S(0);

  for (int sub = blockIdx.x; sub < n_sub; sub += gridDim.x) {
    const long col = (long)sub * BAND_PTS + lane;        // in the group
    const long p = (long)t_lo * block_np + col;          // the point
    const int row0 = starts[t_lo + (int)(col / block_np)] * 8;
    for (int q = threadIdx.x; q < ecols * BAND_PTS; q += blockDim.x)
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
    S nxt[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) nxt[e] = pxm[e * w * gcols + warp * gcols + col];
    for (int cell = warp; cell < w; cell += BAND_WARPS) {
      const int row = row0 + cell;
      const S xy0 = nxt[0], xy1 = nxt[1], mask = nxt[2];
      if (cell + BAND_WARPS < w) {
        const long off = (long)(cell + BAND_WARPS) * gcols + col;
#pragma unroll
        for (int e = 0; e < 3; ++e) nxt[e] = pxm[e * w * gcols + off];
      }
      if (!__any_sync(0xffffffffu, mask != S(0))) {
        if (cell > 0) band_sync(bar_wait);
        if (cell + 1 < w) band_arrive(bar_pass);
        continue;
      }
      const S* c = tbl + (long)row * SP_COLS;
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

      // E: the cell's terms for its outer, inner (and intrinsic) rows; an
      // inner row equal to the outer one is added with the outer group
      const int o = ids[row], in = ids[t_ext + row], kk = ids[2 * t_ext + row];
      const bool merged = in == o;
      const int grow[3] = {o, merged ? -1 : in, kk};
      if (cell > 0) band_sync(bar_wait);
      if (mask != S(0)) {
#pragma unroll
        for (int g = 0; g < NP / 6; ++g) {
          if (grow[g] < 0) continue;
          const int q0 = g < 2 ? grow[g] : 6 * R + grow[g];
          const int qs = g < 2 ? R : K;
          S cur[3][6];
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 6; ++b)
              cur[a][b] = e_tile_at(Es, a * Cn + q0 + b * qs, lane);
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 6; ++b) {
              S v = jx[0][a] * P[0][6 * g + b] + jx[1][a] * P[1][6 * g + b];
              if (g == 0 && merged)
                v += jx[0][a] * P[0][6 + b] + jx[1][a] * P[1][6 + b];
              e_tile_at(Es, a * Cn + q0 + b * qs, lane) = cur[a][b] + v;
            }
        }
      }
      if (cell + 1 < w) band_arrive(bar_pass);

      // slot gradient and Gram over the tile's 32 points
      S acc[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[i][j] = S(0);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int v = 0; v < NP; ++v) st[v * BAND_LD + lane] = P[k][v];
        st[NP * BAND_LD + lane] = k == 0 ? r0 : r1;
        __syncwarp();
#pragma unroll 4
        for (int q = 0; q < BAND_PTS; ++q) {
          S x[3], y[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            x[i] = st[(ca + i) * BAND_LD + q];
            y[i] = st[(cb + i * cb_step) * BAND_LD + q];
          }
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) acc[i][j] += x[i] * y[j];
        }
        __syncwarp();
      }
      if (gram || ptr) {
        S* prow = part + (long)row * NV;
        int vidx[3][3];
        S prev[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int a = ca + i, b = cb + j;
            vidx[i][j] = gram ? (a <= b ? NP + a * NP - a * (a - 1) / 2 + (b - a)
                                        : -1)
                              : (j == 0 ? a : -1);
            prev[i][j] = vidx[i][j] >= 0 ? prow[vidx[i][j]] : S(0);
          }
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (vidx[i][j] >= 0) prow[vidx[i][j]] = prev[i][j] + acc[i][j];
      }
    }
    __syncthreads();

    // g_p / H_pp: the eight warps' partial sums per point, in warp order
    S* red = stage_all;  // [warp][9][32]
#pragma unroll
    for (int a = 0; a < 3; ++a) red[(warp * 9 + a) * BAND_PTS + lane] = gp[a];
#pragma unroll
    for (int h = 0; h < 6; ++h) red[(warp * 9 + 3 + h) * BAND_PTS + lane] = hp[h];
    __syncthreads();
    if (warp == 0) {
      S s[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) s[e] = S(0);
      for (int ww = 0; ww < BAND_WARPS; ++ww)
#pragma unroll
        for (int e = 0; e < 9; ++e) s[e] += red[(ww * 9 + e) * BAND_PTS + lane];
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
    S* E_tile = E + (size_t)(p - lane) * ecols;
    for (int pt = 0; pt < BAND_PTS; ++pt)
      for (int q = threadIdx.x; q < ecols; q += blockDim.x)
        E_tile[(size_t)pt * ecols + q] = e_tile_at(Es, q, pt);
    __syncthreads();
  }

  cost_acc = warp_sum(cost_acc);
  if (lane == 0) cost_stage[warp] = cost_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    S s = S(0);
    for (int ww = 0; ww < BAND_WARPS; ++ww) s += cost_stage[ww];
    partial_cost[blockIdx.x] += s;
  }
}

// Dynamic shared memory of linearize_band: the E tile and the warps'
// stages (which also hold the point sums' reduction).
inline size_t band_smem_bytes(int np, int Cn, size_t esz) {
  return ((size_t)3 * Cn * BAND_PTS + (size_t)BAND_WARPS * (np + 1) * BAND_LD) * esz;
}

template <typename S, int LOSS, int NP>
cudaError_t band_attr(size_t smem) {
  return cudaFuncSetAttribute(linearize_band<S, LOSS, NP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename S, int LOSS, int NP>
cudaError_t band_blocks(size_t smem, int* per_sm) {
  cudaError_t e = band_attr<S, LOSS, NP>(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, linearize_band<S, LOSS, NP>, BAND_PTS * BAND_WARPS, smem);
  return e;
}

template <typename S, int LOSS, int NP>
cudaError_t band_launch(const void* tbl, const void* ids, const void* starts,
                        const void* pts, const void* pxm, int t_ext,
                        int n_pad, int R, int K, int t_lo, int block_np,
                        int n_sub, int w, double scale, int grid, void* pout,
                        void* E, void* partial, void* partial_cost,
                        size_t smem, cudaStream_t s) {
  const cudaError_t e = band_attr<S, LOSS, NP>(smem);
  if (e != cudaSuccess) return e;
  linearize_band<S, LOSS, NP><<<grid, BAND_PTS * BAND_WARPS, smem, s>>>(
      (const S*)tbl, (const int*)ids, (const int*)starts, (const S*)pts,
      (const S*)pxm, t_ext, n_pad, R, K, t_lo, block_np, n_sub, w, (S)scale,
      (S*)pout, (S*)E, (S*)partial, (S*)partial_cost);
  return cudaGetLastError();
}

// Dispatch on (dtype, loss, np) to F<S, LOSS, NP>.
#define RIG_BAND_DISPATCH(F, ...)                                      \
  {                                                                    \
    const bool d = dtype == 1;                                         \
    if (np == 12) {                                                    \
      if (loss == TRIVIAL) return d ? F<double, TRIVIAL, 12>(__VA_ARGS__) \
                                    : F<float, TRIVIAL, 12>(__VA_ARGS__); \
      if (loss == HUBER) return d ? F<double, HUBER, 12>(__VA_ARGS__)     \
                                  : F<float, HUBER, 12>(__VA_ARGS__);     \
      if (loss == CAUCHY) return d ? F<double, CAUCHY, 12>(__VA_ARGS__)   \
                                   : F<float, CAUCHY, 12>(__VA_ARGS__);   \
    }                                                                  \
    if (np == 18) {                                                    \
      if (loss == TRIVIAL) return d ? F<double, TRIVIAL, 18>(__VA_ARGS__) \
                                    : F<float, TRIVIAL, 18>(__VA_ARGS__); \
      if (loss == HUBER) return d ? F<double, HUBER, 18>(__VA_ARGS__)     \
                                  : F<float, HUBER, 18>(__VA_ARGS__);     \
      if (loss == CAUCHY) return d ? F<double, CAUCHY, 18>(__VA_ARGS__)   \
                                   : F<float, CAUCHY, 18>(__VA_ARGS__);   \
    }                                                                  \
  }

}  // namespace rig

using namespace rig;

static bool band_args_ok(int dtype, int loss, int np) {
  return (dtype == 0 || dtype == 1) && loss >= TRIVIAL && loss <= CAUCHY &&
         (np == 12 || np == 18);
}

static cudaError_t band_occupancy(int dtype, int loss, int np, size_t smem,
                                  int* per_sm) {
  RIG_BAND_DISPATCH(band_blocks, smem, per_sm)
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = float64. loss: 0 trivial, 1 huber, 2 cauchy.
// np: 12 (intrinsics frozen, ext-only E) or 18.
//
// Blocks of linearize_band to launch for n_sub tiles of 32 points (all
// resident at once), 0 when its shared-memory E tile (3 * Cn values a point)
// does not fit an SM, or -cudaError_t on a failed query.
extern "C" int rig_linearize_band_grid(int dtype, int loss, int np, int Cn,
                                       int n_sub) {
  if (!band_args_ok(dtype, loss, np)) return -(int)cudaErrorInvalidValue;
  const size_t smem = band_smem_bytes(np, Cn, dtype == 1 ? 8 : 4);
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  if (smem > (size_t)optin) return 0;
  e = band_occupancy(dtype, loss, np, smem, &per_sm);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  const long grid = (long)per_sm * sms;
  return (int)(grid < n_sub ? grid : n_sub);
}

// One width group (block tiles [t_lo, t_lo + n_sub * 32 / block_np)) of
// linearize_grid_banded on the shared-memory E route; returns the
// cudaError_t of the launch.
extern "C" int rig_linearize_band(int dtype, int loss, int np,
                                  const void* tbl, const void* ids,
                                  const void* starts, const void* pts,
                                  const void* pxm, int t_ext, int n_pad,
                                  int R, int K, int t_lo, int block_np,
                                  int n_sub, int w, double scale, int grid,
                                  void* pout, void* E, void* partial,
                                  void* partial_cost, void* stream) {
  if (!band_args_ok(dtype, loss, np) || grid <= 0 || w <= 0 || w % 8 != 0 ||
      block_np % BAND_PTS != 0)
    return (int)cudaErrorInvalidValue;
  if (n_sub == 0) return 0;
  const int Cn = np == 18 ? 6 * (R + K) : 6 * R;
  const size_t smem = band_smem_bytes(np, Cn, dtype == 1 ? 8 : 4);
  cudaStream_t s = (cudaStream_t)stream;
  RIG_BAND_DISPATCH(band_launch, tbl, ids, starts, pts, pxm, t_ext, n_pad, R,
                    K, t_lo, block_np, n_sub, w, scale, grid, pout, E,
                    partial, partial_cost, smem, s)
  return (int)cudaErrorInvalidValue;
}
