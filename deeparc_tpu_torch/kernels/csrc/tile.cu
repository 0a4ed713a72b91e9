// Tile-engine kernels for Hopper (sm_90a): the fused bucket linearization
// and the PCG sweeps over a bucket's transposed Jacobian planes.
//
// Replaces the three Pallas TPU kernels of deeparc_tpu/kernels/tile_pallas.py:
//   tile_linearize_local (:573, body _linearize_local_kernel :386)
//   tile_sweep_local     (:207, body _sweep_local_kernel :134)
//   tile_sweep           (:282, body _sweep_kernel :67)
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
//     planes); the sweeps' bin pass reads the planes and w.
//   * No float atomics anywhere, so every run gives the same bits.
//
// What bounds it on the card. Device-memory bytes. The linearize writes
// 44 plane values per slot (2 r, 6 jx, 36 jcam) plus its bins; a matvec
// sweep reads the 42 jx/jcam values of every slot. This version reads the
// planes twice per sweep (row pass for E v, bin pass for E^T w) and the bin
// pass's lanes touch scattered rows, so sectors are partly wasted: its
// traffic is above the bound. bf16 planes halve (f32) or quarter (f64) the
// plane bytes. Staging a chunk's table in shared memory, one pass per chunk
// with both directions, and coalesced bin reads are later work.
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
#define TILE_SWEEP_LOC(T, PT)                              \
  if (local) { TILE_SWEEP_MODE(T, PT, true) }              \
  else { TILE_SWEEP_MODE(T, PT, false) }
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
