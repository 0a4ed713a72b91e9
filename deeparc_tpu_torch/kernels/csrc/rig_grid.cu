// Grid-engine kernels for Hopper (sm_90a): the fused linearization and the
// robust cost pass over per-tile cell bands.
//
// Replaces the four Pallas TPU kernels of deeparc_tpu/kernels/rig_pallas.py:
//   linearize_grid_banded (:615, body _banded_linearize_kernel :473)
//   cost_grid_banded      (:777, body _banded_cost_kernel :751)
//   linearize_grid        (:363, body _linearize_kernel :278)
//   cost_grid             (:859, body _cost_kernel :159)
// Two kernels serve all four: the monolithic pair is the banded pair with
// every tile's band starting at cell 0, one group of width t_pad and no
// cyclic extension (the wrappers in kernels/rig_grid.py build those tables).
//
// Design. One thread owns one point of a tile of blockDim.x points and walks
// the tile's band of w cells; a block loops over several tiles (grid-stride)
// so the per-block scratch stays bounded.
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
// What bounds it on the card. The E row: 3 * Cn values per point (576
// doubles at the flagship's 32 extrinsic rows, ext-only) written once by the
// zeroing pass and read-modified-written per live slot at scattered columns
// -- device-memory traffic with poor coalescing. Then the slot reduction:
// NV = 90 (ext-only) or 189 warp reductions per cell, five shuffles each.
// The float64 linearize needs up to 178 registers a thread (no spills), so
// one 256-thread block fills an SM's register file. Making it fast
// (staging the band's table slab in shared memory, wgmma for the Gram and
// E contractions) is later work; this version is the simple correct one.
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

template <typename S, int LOSS>
__global__ void __launch_bounds__(256)
cost_kernel(const S* __restrict__ tbl, const int* __restrict__ starts,
            const S* __restrict__ pts, const S* __restrict__ pxm, int n_pad,
            int t_lo, int g_tiles, int bn, int w, S scale,
            S* __restrict__ partial_cost) {
  __shared__ S cost_stage[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long gcols = (long)g_tiles * bn;
  S acc = S(0);
  for (int i = blockIdx.x; i < g_tiles; i += gridDim.x) {
    const int tile = t_lo + i;
    const int row0 = starts[tile] * 8;
    for (int j = tid; j < bn; j += blockDim.x) {
      const long p = (long)tile * bn + j;
      const S X[3] = {pts[p], pts[(long)n_pad + p], pts[2L * n_pad + p]};
      for (int cell = 0; cell < w; ++cell) {
        const long off = (long)cell * gcols + (long)i * bn + j;
        acc += slot_cost<S, LOSS>(tbl + (long)(row0 + cell) * SP_COLS, X,
                                  pxm[off], pxm[(long)w * gcols + off],
                                  pxm[2L * w * gcols + off], scale);
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) cost_stage[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    S s = S(0);
    for (int ww = 0; ww < (int)(blockDim.x >> 5); ++ww) s += cost_stage[ww];
    partial_cost[blockIdx.x] += s;
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

extern "C" int rig_cost(int dtype, int loss, const void* tbl,
                        const void* starts, const void* pts, const void* pxm,
                        int n_pad, int t_lo, int g_tiles, int bn, int w,
                        double scale, int grid, int threads,
                        void* partial_cost, void* stream) {
  if (threads % 32 != 0 || threads > 256 || threads <= 0)
    return (int)cudaErrorInvalidValue;
  const int* st = (const int*)starts;
  cudaStream_t s = (cudaStream_t)stream;
#define RIG_COST(T, L)                                                      \
  cost_kernel<T, L><<<grid, threads, 0, s>>>(                               \
      (const T*)tbl, st, (const T*)pts, (const T*)pxm, n_pad, t_lo, g_tiles, \
      bn, w, (T)scale, (T*)partial_cost);                                   \
  return (int)cudaGetLastError()
  if (dtype == 1) {
    if (loss == TRIVIAL) { RIG_COST(double, TRIVIAL); }
    if (loss == HUBER) { RIG_COST(double, HUBER); }
    if (loss == CAUCHY) { RIG_COST(double, CAUCHY); }
  } else if (dtype == 0) {
    if (loss == TRIVIAL) { RIG_COST(float, TRIVIAL); }
    if (loss == HUBER) { RIG_COST(float, HUBER); }
    if (loss == CAUCHY) { RIG_COST(float, CAUCHY); }
  }
#undef RIG_COST
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
