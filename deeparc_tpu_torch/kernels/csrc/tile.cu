// Tile-engine kernels for Hopper (sm_90a): the fused bucket linearization
// and the PCG sweeps over a bucket's transposed Jacobian planes.
//
// Replaces the three Pallas TPU kernels of deeparc_tpu/kernels/tile_pallas.py:
//   tile_linearize_local (:573, body _linearize_local_kernel :386)
//   tile_sweep_local     (:207, body _sweep_local_kernel :134)
//   tile_sweep           (:282, body _sweep_kernel :67; rhs/matvec here in
//                         gsweep_rows + gsweep_bins over sort_rows's copy)
// The wrappers and plain versions are in kernels/tile.py.
//
// Design. Each function is a ROW pass and a BIN pass.
//   * Row pass: one thread owns one row (point) and walks its W slots. The
//     linearize reads the slot's 78-value table row (chunk-local id ->
//     tables[chunk][local]) from device memory, runs the slot chain of
//     rig_slot.cuh on the tile layout, writes its own column of the r / jx /
//     jcam planes (neighbouring threads write neighbouring addresses) and of
//     pout, and sums its cost into a per-thread total. A sweep's row pass
//     forms E v (matvec/edot) or takes g_p (rhs), applies the row's 3x3
//     B^-1 and writes the 3-vector w = B^-1 (...) (or E v itself for edot).
//   * Bin pass: the per-cell bins (gc / hc of the linearize, E^T w of the
//     sweeps) are sums over rows into data-dependent cells. The host builds
//     once per layout a list of the bucket's slots sorted by bin (chunk *
//     V_local + local id, or the global id), cut into segments of at most
//     256 slots (kernels/tile.slot_bins). One warp sums one segment in list
//     order into its own partial row; a third kernel sums each bin's
//     segments in order. The linearize's bin pass recomputes the slot chain
//     from its inputs in the working type (so bins never see bf16-rounded
//     planes); tile_sweep_local's bin pass reads the planes and w.
//   * tile_sweep (rhs / matvec), for buckets without local tables, where a
//     cell's ~4000 slots lie on rows spread over the whole bucket: once per
//     LM step sort_rows gathers a cell-sorted copy of jcam (36, W * Nb),
//     the slots of a segment adjacent. Its row pass (gsweep_rows) writes
//     each slot's t2 = (jx_0 . w, jx_1 . w) at the slot's sorted position;
//     its bin pass (gsweep_bins) then reads only sorted data, every load
//     coalesced. The sums and their order are sweep_bins's.
//   * No float atomics anywhere, so every run gives the same bits.
//
// What bounds it on the card. Device-memory bytes. The linearize writes
// 44 plane values per slot (2 r, 6 jx, 36 jcam) plus its bins; a matvec
// sweep reads the 42 jx/jcam values of every slot. tile_sweep_local reads
// the planes twice per sweep (row pass for E v, bin pass for E^T w), the
// bin pass's lanes on scattered rows of the chunk, so sectors are partly
// wasted. tile_sweep reads jcam twice too, but both reads coalesced: about
// 720 bytes a slot in f64 against the bound's ~350, plus the sorted copy
// (2.3 GB at 1M rows x 8 slots) built once per step. bf16 planes halve
// (f32) or quarter (f64) the plane bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rig_slot.cuh"

namespace tile {

using rig::TileCols;
using rig::warp_sum;

constexpr int NV_LIN = 18 + 171;  // gradient + upper-triangle Gram per bin
constexpr int WARPS = 8;          // warps per block of the bin passes

enum Mode { RHS = 0, MATVEC = 1, EDOT = 2 };

template <typename S, typename P>
struct Plane {
  static __device__ __forceinline__ S load(const P* p, long i) {
    return S(p[i]);
  }
  static __device__ __forceinline__ void store(P* p, long i, S x) { p[i] = x; }
};

// bf16 planes: rounded from float as torch's .to(torch.bfloat16) does
template <typename S>
struct Plane<S, __nv_bfloat16> {
  static __device__ __forceinline__ S load(const __nv_bfloat16* p, long i) {
    return S(__bfloat162float(p[i]));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, long i, S x) {
    p[i] = __float2bfloat16((float)x);
  }
};

// ---------------------------------------------------------------------------
// Linearize
// ---------------------------------------------------------------------------

template <typename S, typename P, int LOSS>
__global__ void __launch_bounds__(256)
linearize_rows(const S* __restrict__ pts, const int* __restrict__ cell,
               const S* __restrict__ xy0, const S* __restrict__ xy1,
               const S* __restrict__ mask, const S* __restrict__ tables,
               int W, int Nb, int B, int Vl, S scale, S* __restrict__ pout,
               P* __restrict__ r_t, P* __restrict__ jx_t,
               P* __restrict__ jcam_t, S* __restrict__ partial_cost) {
  __shared__ S cost_stage[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  S cost_acc = S(0);
  for (long p = (long)blockIdx.x * blockDim.x + threadIdx.x; p < Nb;
       p += (long)gridDim.x * blockDim.x) {
    const S X[3] = {pts[p], pts[(long)Nb + p], pts[2L * Nb + p]};
    const S pf[3] = {pts[3L * Nb + p], pts[4L * Nb + p], pts[5L * Nb + p]};
    const S* tbl = tables + (p / B) * (long)Vl * rig::SP_COLS;
    S gp[3] = {S(0), S(0), S(0)};
    S hp[6] = {S(0), S(0), S(0), S(0), S(0), S(0)};
    for (int w = 0; w < W; ++w) {
      const long o = (long)w * Nb + p;
      const S* c = tbl + (long)cell[o] * rig::SP_COLS;
      S r0, r1, jx[2][3], Pj[2][18];
      cost_acc += rig::slot_products<S, LOSS, 18, TileCols>(
          c, X, pf, xy0[o], xy1[o], mask[o], scale, r0, r1, jx, Pj);
      Plane<S, P>::store(r_t, (2L * w) * Nb + p, r0);
      Plane<S, P>::store(r_t, (2L * w + 1) * Nb + p, r1);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          Plane<S, P>::store(jx_t, (6L * w + 3 * k + i) * Nb + p, jx[k][i]);
#pragma unroll
        for (int j = 0; j < 18; ++j)
          Plane<S, P>::store(jcam_t, (36L * w + 18 * k + j) * Nb + p,
                             Pj[k][j]);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) gp[a] += jx[0][a] * r0 + jx[1][a] * r1;
      int h = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = a; b < 3; ++b, ++h)
          hp[h] += jx[0][a] * jx[0][b] + jx[1][a] * jx[1][b];
    }
    const int hidx[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
    for (int a = 0; a < 3; ++a) pout[(long)a * Nb + p] = gp[a];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        pout[(long)(3 + 3 * a + b) * Nb + p] = hp[hidx[a][b]];
  }
  cost_acc = warp_sum(cost_acc);
  if (lane == 0) cost_stage[warp] = cost_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    S s = S(0);
    for (int ww = 0; ww < (int)(blockDim.x >> 5); ++ww) s += cost_stage[ww];
    partial_cost[blockIdx.x] = s;
  }
}

// One warp per segment of a bin: lane l takes the segment's slots l, l+32,
// ...; per round of 32 slots each of the 189 values is warp-summed, and the
// total is kept by lane (v % 32) in its accumulator v / 32.
template <typename S, int LOSS>
__global__ void __launch_bounds__(WARPS * 32)
linearize_bins(const S* __restrict__ pts, const int* __restrict__ cell,
               const S* __restrict__ xy0, const S* __restrict__ xy1,
               const S* __restrict__ mask, const S* __restrict__ tables,
               const int* __restrict__ order,
               const int* __restrict__ seg_start, int n_seg, int Nb, int B,
               int Vl, S scale, S* __restrict__ partial) {
  constexpr int NACC = (NV_LIN + 31) / 32;
  const int lane = threadIdx.x & 31;
  const long seg = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (seg >= n_seg) return;
  const int lo = seg_start[seg], hi = seg_start[seg + 1];
  S acc[NACC];
#pragma unroll
  for (int q = 0; q < NACC; ++q) acc[q] = S(0);
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    S r0 = S(0), r1 = S(0), Pj[2][18];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 18; ++j) Pj[k][j] = S(0);
    if (i < hi) {
      const long f = order[i];
      const long p = f % Nb;
      const S m = mask[f];
      if (m != S(0)) {
        const S X[3] = {pts[p], pts[(long)Nb + p], pts[2L * Nb + p]};
        const S pf[3] = {pts[3L * Nb + p], pts[4L * Nb + p],
                         pts[5L * Nb + p]};
        const S* c = tables + ((p / B) * (long)Vl + cell[f]) * rig::SP_COLS;
        S jx[2][3];
        rig::slot_products<S, LOSS, 18, TileCols>(c, X, pf, xy0[f], xy1[f], m,
                                                  scale, r0, r1, jx, Pj);
      }
    }
    int v = 0;
#pragma unroll
    for (int a = 0; a < 18; ++a, ++v) {
      const S x = warp_sum(Pj[0][a] * r0 + Pj[1][a] * r1);
      if (lane == (v & 31)) acc[v >> 5] += x;
    }
#pragma unroll
    for (int a = 0; a < 18; ++a)
#pragma unroll
      for (int b = a; b < 18; ++b, ++v) {
        const S x = warp_sum(Pj[0][a] * Pj[0][b] + Pj[1][a] * Pj[1][b]);
        if (lane == (v & 31)) acc[v >> 5] += x;
      }
  }
#pragma unroll
  for (int q = 0; q < NACC; ++q) {
    const int v = q * 32 + lane;
    if (v < NV_LIN) partial[seg * NV_LIN + v] = acc[q];
  }
}

// ---------------------------------------------------------------------------
// Sweeps
// ---------------------------------------------------------------------------

// Row pass. LOCAL: v is the per-chunk (n_chunks, 18, Vl) table and cell
// holds local ids; otherwise v is the global (V, 18) vector.
template <typename S, typename P, bool LOCAL, int MODE>
__global__ void __launch_bounds__(256)
sweep_rows(const int* __restrict__ cell, const P* __restrict__ jcam_t,
           const P* __restrict__ jx_t, const S* __restrict__ binv,
           const S* __restrict__ gp, const S* __restrict__ v, int W, int Nb,
           int B, int n_cells, S* __restrict__ wbuf, S* __restrict__ ev_out) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Nb) return;
  S rhs[3];
  if (MODE == RHS) {
#pragma unroll
    for (int i = 0; i < 3; ++i) rhs[i] = gp[(long)i * Nb + p];
  } else {
    S ev[3] = {S(0), S(0), S(0)};
    const S* vt = LOCAL ? v + (p / B) * 18L * n_cells : v;
    for (int w = 0; w < W; ++w) {
      const long l = cell[(long)w * Nb + p];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        S t = S(0);
#pragma unroll
        for (int j = 0; j < 18; ++j) {
          const S vj = LOCAL ? vt[(long)j * n_cells + l] : vt[l * 18 + j];
          t += Plane<S, P>::load(jcam_t, (36L * w + 18 * k + j) * Nb + p) * vj;
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ev[i] += Plane<S, P>::load(jx_t, (6L * w + 3 * k + i) * Nb + p) * t;
      }
    }
    if (MODE == EDOT) {
#pragma unroll
      for (int i = 0; i < 3; ++i) ev_out[p * 3 + i] = ev[i];
      return;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) rhs[i] = ev[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S s = S(0);
#pragma unroll
    for (int j = 0; j < 3; ++j) s += binv[(long)(3 * i + j) * Nb + p] * rhs[j];
    wbuf[(long)i * Nb + p] = s;
  }
}

// Bin pass: u = sum_k jcam_k (jx_k . w) per slot, summed per segment.
template <typename S, typename P>
__global__ void __launch_bounds__(WARPS * 32)
sweep_bins(const int* __restrict__ order, const int* __restrict__ seg_start,
           int n_seg, const P* __restrict__ jcam_t, const P* __restrict__ jx_t,
           const S* __restrict__ wbuf, int Nb, S* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const long seg = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (seg >= n_seg) return;
  const int lo = seg_start[seg], hi = seg_start[seg + 1];
  S acc[18];
#pragma unroll
  for (int j = 0; j < 18; ++j) acc[j] = S(0);
  for (int i = lo + lane; i < hi; i += 32) {
    const long f = order[i];
    const long w = f / Nb, p = f - w * Nb;
    const S wv[3] = {wbuf[p], wbuf[(long)Nb + p], wbuf[2L * Nb + p]};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      S t2 = S(0);
#pragma unroll
      for (int a = 0; a < 3; ++a)
        t2 += Plane<S, P>::load(jx_t, (6 * w + 3 * k + a) * Nb + p) * wv[a];
#pragma unroll
      for (int j = 0; j < 18; ++j)
        acc[j] += Plane<S, P>::load(jcam_t, (36 * w + 18 * k + j) * Nb + p) * t2;
    }
  }
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    const S x = warp_sum(acc[j]);
    if (lane == 0) partial[seg * 18 + j] = x;
  }
}

// A slot's two scalars t2_k = jx_k . w, stored together (one 16- or 8-byte
// access per slot).
template <typename S>
struct alignas(2 * sizeof(S)) Pair {
  S k0, k1;
};

// tile_sweep's row pass in rhs/matvec: w = B^-1 (g_p or E v) as in
// sweep_rows, then each slot's t2 = (jx_0 . w, jx_1 . w) is written at the
// slot's position in the cell-sorted order (pos = inverse of SlotBins.order).
template <typename S, typename P, int MODE>
__global__ void __launch_bounds__(256)
gsweep_rows(const int* __restrict__ cell, const P* __restrict__ jcam_t,
            const P* __restrict__ jx_t, const S* __restrict__ binv,
            const S* __restrict__ gp, const S* __restrict__ v,
            const int* __restrict__ pos, int W, int Nb,
            Pair<S>* __restrict__ t2) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Nb) return;
  S rhs[3];
  if (MODE == RHS) {
#pragma unroll
    for (int i = 0; i < 3; ++i) rhs[i] = gp[(long)i * Nb + p];
  } else {
    S ev[3] = {S(0), S(0), S(0)};
    for (int w = 0; w < W; ++w) {
      const long l = cell[(long)w * Nb + p];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        S t = S(0);
#pragma unroll
        for (int j = 0; j < 18; ++j)
          t += Plane<S, P>::load(jcam_t, (36L * w + 18 * k + j) * Nb + p) *
               v[l * 18 + j];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ev[i] += Plane<S, P>::load(jx_t, (6L * w + 3 * k + i) * Nb + p) * t;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) rhs[i] = ev[i];
  }
  S wv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S s = S(0);
#pragma unroll
    for (int j = 0; j < 3; ++j) s += binv[(long)(3 * i + j) * Nb + p] * rhs[j];
    wv[i] = s;
  }
  for (int w = 0; w < W; ++w) {
    S t[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      S s = S(0);
#pragma unroll
      for (int a = 0; a < 3; ++a)
        s += Plane<S, P>::load(jx_t, (6L * w + 3 * k + a) * Nb + p) * wv[a];
      t[k] = s;
    }
    t2[pos[(long)w * Nb + p]] = Pair<S>{t[0], t[1]};
  }
}

// tile_sweep's bin pass: one warp per segment of the sorted slot list; lane
// l takes positions lo + l, lo + l + 32, ..., so each load of the sorted
// jcam planes (36, n_slots) and of t2 is coalesced. Same sums, in the same
// order, as sweep_bins.
template <typename S, typename P>
__global__ void __launch_bounds__(WARPS * 32)
gsweep_bins(const int* __restrict__ seg_start, int n_seg,
            const P* __restrict__ jsrt, const Pair<S>* __restrict__ t2,
            long n_slots, S* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const long seg = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (seg >= n_seg) return;
  const int lo = seg_start[seg], hi = seg_start[seg + 1];
  S acc[18];
#pragma unroll
  for (int j = 0; j < 18; ++j) acc[j] = S(0);
  for (long i = lo + lane; i < hi; i += 32) {
    const Pair<S> t = t2[i];
#pragma unroll
    for (int j = 0; j < 18; ++j)
      acc[j] += Plane<S, P>::load(jsrt, j * n_slots + i) * t.k0;
#pragma unroll
    for (int j = 0; j < 18; ++j)
      acc[j] += Plane<S, P>::load(jsrt, (18 + j) * n_slots + i) * t.k1;
  }
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    const S x = warp_sum(acc[j]);
    if (lane == 0) partial[seg * 18 + j] = x;
  }
}

// tile_sweep's cell-sorted jcam copy: out[c][i] = value c of slot order[i]
// (flat id w * Nb + p), gathered from the (Nb, W, 36) slot rows. A warp
// takes 32 sorted positions: it reads their 32 source rows whole (288
// contiguous bytes each) into shared memory, then writes the 36 output
// planes 32 adjacent values at a time.
constexpr int SORT_WARPS = 4;

template <typename S, typename P>
__global__ void __launch_bounds__(SORT_WARPS * 32)
sort_rows(const S* __restrict__ rows, const int* __restrict__ order,
          long n_slots, int Nb, int W, P* __restrict__ out) {
  __shared__ S tile_all[SORT_WARPS][32][37];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long i0 = ((long)blockIdx.x * SORT_WARPS + warp) * 32;
  if (i0 >= n_slots) return;
  S(*t)[37] = tile_all[warp];
  const long f = i0 + lane < n_slots ? order[i0 + lane] : 0;
  const long src = ((f % Nb) * W + f / Nb) * 36;
  for (int r = 0; r < 32; ++r) {
    const long s = __shfl_sync(0xffffffffu, src, r);
    if (i0 + r < n_slots) {
      t[r][lane] = rows[s + lane];
      if (lane < 4) t[r][32 + lane] = rows[s + 32 + lane];
    }
  }
  __syncwarp();
  if (i0 + lane < n_slots) {
#pragma unroll 4
    for (int c = 0; c < 36; ++c)
      Plane<S, P>::store(out, c * n_slots + i0 + lane, t[lane][c]);
  }
}

// ---------------------------------------------------------------------------
// Fixed-order second passes
// ---------------------------------------------------------------------------

// out[bin] = sum over the bin's segments, in order, of their partial rows;
// values q < na go to out_a (n_bins, na), the rest to out_b (n_bins, nv-na).
template <typename S>
__global__ void reduce_bins(const S* __restrict__ partial,
                            const int* __restrict__ bin_seg, int n_bins,
                            int nv, int na, S* __restrict__ out_a,
                            S* __restrict__ out_b) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)n_bins * nv) return;
  const long b = idx / nv;
  const int q = (int)(idx - b * nv);
  S s = S(0);
  for (int g = bin_seg[b]; g < bin_seg[b + 1]; ++g) s += partial[(long)g * nv + q];
  if (q < na)
    out_a[b * na + q] = s;
  else
    out_b[b * (nv - na) + (q - na)] = s;
}

// One warp: lane l sums partials l, l+32, ... in order, then a warp sum.
template <typename S>
__global__ void reduce_cost(const S* __restrict__ partial, int n,
                            S* __restrict__ out) {
  S s = S(0);
  for (int i = threadIdx.x; i < n; i += 32) s += partial[i];
  s = warp_sum(s);
  if (threadIdx.x == 0) out[0] = s;
}

inline int blocks_for(long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace tile

using namespace tile;

// dtype: 0 = float32, 1 = float64 (the working type). pdtype: 0 = planes in
// the working type, 1 = bfloat16 planes. loss: 0 trivial, 1 huber, 2 cauchy.
// mode: 0 rhs, 1 matvec, 2 edot. Every launcher returns the cudaError_t of
// its launches (0 = success).

extern "C" int tile_linearize_rows(int dtype, int pdtype, int loss,
                                   const void* pts, const void* cell,
                                   const void* xy0, const void* xy1,
                                   const void* mask, const void* tables, int W,
                                   int Nb, int B, int Vl, double scale,
                                   int threads, int grid, void* pout,
                                   void* r_t, void* jx_t, void* jcam_t,
                                   void* partial_cost, void* stream) {
  if (threads % 32 != 0 || threads <= 0 || threads > 256 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TILE_LIN(T, PT, L)                                                   \
  linearize_rows<T, PT, L><<<grid, threads, 0, s>>>(                         \
      (const T*)pts, (const int*)cell, (const T*)xy0, (const T*)xy1,         \
      (const T*)mask, (const T*)tables, W, Nb, B, Vl, (T)scale, (T*)pout,    \
      (PT*)r_t, (PT*)jx_t, (PT*)jcam_t, (T*)partial_cost);                   \
  return (int)cudaGetLastError()
#define TILE_LIN_LOSS(T, PT)                             \
  if (loss == rig::TRIVIAL) { TILE_LIN(T, PT, rig::TRIVIAL); } \
  if (loss == rig::HUBER) { TILE_LIN(T, PT, rig::HUBER); }     \
  if (loss == rig::CAUCHY) { TILE_LIN(T, PT, rig::CAUCHY); }
  if (dtype == 1 && pdtype == 0) { TILE_LIN_LOSS(double, double) }
  if (dtype == 1 && pdtype == 1) { TILE_LIN_LOSS(double, __nv_bfloat16) }
  if (dtype == 0 && pdtype == 0) { TILE_LIN_LOSS(float, float) }
  if (dtype == 0 && pdtype == 1) { TILE_LIN_LOSS(float, __nv_bfloat16) }
#undef TILE_LIN_LOSS
#undef TILE_LIN
  return (int)cudaErrorInvalidValue;
}

extern "C" int tile_linearize_bins(int dtype, int loss, const void* pts,
                                   const void* cell, const void* xy0,
                                   const void* xy1, const void* mask,
                                   const void* tables, const void* order,
                                   const void* seg_start, int n_seg, int W,
                                   int Nb, int B, int Vl, double scale,
                                   void* partial, void* stream) {
  if (n_seg == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = blocks_for(n_seg, WARPS);
#define TILE_BINS(T, L)                                                      \
  linearize_bins<T, L><<<grid, WARPS * 32, 0, s>>>(                          \
      (const T*)pts, (const int*)cell, (const T*)xy0, (const T*)xy1,         \
      (const T*)mask, (const T*)tables, (const int*)order,                   \
      (const int*)seg_start, n_seg, Nb, B, Vl, (T)scale, (T*)partial);       \
  return (int)cudaGetLastError()
  if (dtype == 1) {
    if (loss == rig::TRIVIAL) { TILE_BINS(double, rig::TRIVIAL); }
    if (loss == rig::HUBER) { TILE_BINS(double, rig::HUBER); }
    if (loss == rig::CAUCHY) { TILE_BINS(double, rig::CAUCHY); }
  } else if (dtype == 0) {
    if (loss == rig::TRIVIAL) { TILE_BINS(float, rig::TRIVIAL); }
    if (loss == rig::HUBER) { TILE_BINS(float, rig::HUBER); }
    if (loss == rig::CAUCHY) { TILE_BINS(float, rig::CAUCHY); }
  }
#undef TILE_BINS
  return (int)cudaErrorInvalidValue;
}

extern "C" int tile_sweep_rows(int dtype, int pdtype, int mode, int local,
                               const void* cell, const void* jcam_t,
                               const void* jx_t, const void* binv,
                               const void* gp, const void* v, int W, int Nb,
                               int B, int n_cells, int threads, void* wbuf,
                               void* ev_out, void* stream) {
  if (threads % 32 != 0 || threads <= 0 || threads > 256)
    return (int)cudaErrorInvalidValue;
  if (Nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = blocks_for(Nb, threads);
#define TILE_SWEEP(T, PT, LOC, M)                                            \
  sweep_rows<T, PT, LOC, M><<<grid, threads, 0, s>>>(                        \
      (const int*)cell, (const PT*)jcam_t, (const PT*)jx_t, (const T*)binv,  \
      (const T*)gp, (const T*)v, W, Nb, B, n_cells, (T*)wbuf, (T*)ev_out);   \
  return (int)cudaGetLastError()
#define TILE_SWEEP_MODE(T, PT, LOC)                       \
  if (mode == RHS) { TILE_SWEEP(T, PT, LOC, RHS); }       \
  if (mode == MATVEC) { TILE_SWEEP(T, PT, LOC, MATVEC); } \
  if (mode == EDOT) { TILE_SWEEP(T, PT, LOC, EDOT); }
  // tile_sweep's rhs / matvec run tile_gsweep; only its edot comes here
#define TILE_SWEEP_LOC(T, PT)                              \
  if (local) { TILE_SWEEP_MODE(T, PT, true) }              \
  else if (mode == EDOT) { TILE_SWEEP(T, PT, false, EDOT); }
  if (dtype == 1 && pdtype == 0) { TILE_SWEEP_LOC(double, double) }
  if (dtype == 1 && pdtype == 1) { TILE_SWEEP_LOC(double, __nv_bfloat16) }
  if (dtype == 0 && pdtype == 0) { TILE_SWEEP_LOC(float, float) }
  if (dtype == 0 && pdtype == 1) { TILE_SWEEP_LOC(float, __nv_bfloat16) }
#undef TILE_SWEEP_LOC
#undef TILE_SWEEP_MODE
#undef TILE_SWEEP
  return (int)cudaErrorInvalidValue;
}

extern "C" int tile_sweep_bins(int dtype, int pdtype, const void* order,
                               const void* seg_start, int n_seg,
                               const void* jcam_t, const void* jx_t,
                               const void* wbuf, int W, int Nb, void* partial,
                               void* stream) {
  if (n_seg == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = blocks_for(n_seg, WARPS);
#define TILE_SBINS(T, PT)                                                    \
  sweep_bins<T, PT><<<grid, WARPS * 32, 0, s>>>(                             \
      (const int*)order, (const int*)seg_start, n_seg, (const PT*)jcam_t,    \
      (const PT*)jx_t, (const T*)wbuf, Nb, (T*)partial);                     \
  return (int)cudaGetLastError()
  if (dtype == 1 && pdtype == 0) { TILE_SBINS(double, double); }
  if (dtype == 1 && pdtype == 1) { TILE_SBINS(double, __nv_bfloat16); }
  if (dtype == 0 && pdtype == 0) { TILE_SBINS(float, float); }
  if (dtype == 0 && pdtype == 1) { TILE_SBINS(float, __nv_bfloat16); }
#undef TILE_SBINS
  return (int)cudaErrorInvalidValue;
}

// tile_sweep in rhs (mode 0) or matvec (mode 1): the row pass writes t2 at
// sorted positions, the bin pass sums each segment of the sorted list.
extern "C" int tile_gsweep(int dtype, int pdtype, int mode, const void* cell,
                           const void* jcam_t, const void* jx_t,
                           const void* binv, const void* gp, const void* v,
                           const void* pos, const void* jsrt,
                           const void* seg_start, int n_seg, int W, int Nb,
                           int threads, void* t2, void* partial,
                           void* stream) {
  if (threads % 32 != 0 || threads <= 0 || threads > 256 ||
      (mode != RHS && mode != MATVEC))
    return (int)cudaErrorInvalidValue;
  if (Nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int rgrid = blocks_for(Nb, threads);
  const int bgrid = blocks_for(n_seg, WARPS);
  const long n_slots = (long)W * Nb;
#define TILE_GROWS(T, PT, M)                                                 \
  gsweep_rows<T, PT, M><<<rgrid, threads, 0, s>>>(                           \
      (const int*)cell, (const PT*)jcam_t, (const PT*)jx_t, (const T*)binv,  \
      (const T*)gp, (const T*)v, (const int*)pos, W, Nb, (Pair<T>*)t2)
#define TILE_GSWEEP(T, PT)                                                   \
  {                                                                          \
    if (mode == RHS)                                                         \
      TILE_GROWS(T, PT, RHS);                                                \
    else                                                                     \
      TILE_GROWS(T, PT, MATVEC);                                             \
    const cudaError_t e = cudaGetLastError();                                \
    if (e != cudaSuccess || n_seg == 0) return (int)e;                       \
    gsweep_bins<T, PT><<<bgrid, WARPS * 32, 0, s>>>(                         \
        (const int*)seg_start, n_seg, (const PT*)jsrt, (const Pair<T>*)t2,   \
        n_slots, (T*)partial);                                               \
    return (int)cudaGetLastError();                                          \
  }
  if (dtype == 1 && pdtype == 0) TILE_GSWEEP(double, double)
  if (dtype == 1 && pdtype == 1) TILE_GSWEEP(double, __nv_bfloat16)
  if (dtype == 0 && pdtype == 0) TILE_GSWEEP(float, float)
  if (dtype == 0 && pdtype == 1) TILE_GSWEEP(float, __nv_bfloat16)
#undef TILE_GSWEEP
#undef TILE_GROWS
  return (int)cudaErrorInvalidValue;
}

// The cell-sorted (36, W * Nb) jcam copy of (Nb, W, 36) slot rows in the
// working type, stored in the plane type.
extern "C" int tile_sort_jcam(int dtype, int pdtype, const void* rows,
                              const void* order, int Nb, int W, void* out,
                              void* stream) {
  const long n_slots = (long)W * Nb;
  if (n_slots == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (int)((n_slots + SORT_WARPS * 32 - 1) / (SORT_WARPS * 32));
#define TILE_SORT(T, PT)                                                      \
  sort_rows<T, PT><<<grid, SORT_WARPS * 32, 0, s>>>(                          \
      (const T*)rows, (const int*)order, n_slots, Nb, W, (PT*)out);           \
  return (int)cudaGetLastError()
  if (dtype == 1 && pdtype == 0) { TILE_SORT(double, double); }
  if (dtype == 1 && pdtype == 1) { TILE_SORT(double, __nv_bfloat16); }
  if (dtype == 0 && pdtype == 0) { TILE_SORT(float, float); }
  if (dtype == 0 && pdtype == 1) { TILE_SORT(float, __nv_bfloat16); }
#undef TILE_SORT
  return (int)cudaErrorInvalidValue;
}

extern "C" int tile_reduce_bins(int dtype, const void* partial,
                                const void* bin_seg, int n_bins, int nv,
                                int na, void* out_a, void* out_b,
                                void* stream) {
  const long n = (long)n_bins * nv;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = blocks_for(n, 256);
  if (dtype == 1)
    reduce_bins<double><<<grid, 256, 0, s>>>(
        (const double*)partial, (const int*)bin_seg, n_bins, nv, na,
        (double*)out_a, (double*)out_b);
  else if (dtype == 0)
    reduce_bins<float><<<grid, 256, 0, s>>>(
        (const float*)partial, (const int*)bin_seg, n_bins, nv, na,
        (float*)out_a, (float*)out_b);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int tile_reduce_cost(int dtype, const void* partial, int n,
                                void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    reduce_cost<double><<<1, 32, 0, s>>>((const double*)partial, n,
                                         (double*)out);
  else if (dtype == 0)
    reduce_cost<float><<<1, 32, 0, s>>>((const float*)partial, n,
                                        (float*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
