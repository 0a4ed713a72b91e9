// Tile-engine kernels for Hopper (sm_90a): the fused bucket linearization
// and the PCG sweeps over a bucket's transposed Jacobian planes.
//
// Replaces the three Pallas TPU kernels of deeparc_tpu/kernels/tile_pallas.py:
//   tile_linearize_local (:573, body _linearize_local_kernel :386)
//   tile_sweep_local     (:207, body _sweep_local_kernel :134; rhs/matvec
//                         here in gsweep_rows + lsweep_bins over
//                         sort_planes's copy)
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
//     B^-1 and writes each slot's t2 = (jx_0 . w, jx_1 . w), w = B^-1 (...)
//     (edot: E v itself, and no bin pass).
//   * Bin pass: the per-cell bins (gc / hc of the linearize, E^T w of the
//     sweeps) are sums over rows into data-dependent cells. The host builds
//     once per layout a list of the bucket's slots sorted by bin (chunk *
//     V_local + local id, or the global id), cut into segments of at most
//     256 slots and into runs of bins (kernels/tile.slot_bins). The
//     linearize: one block per run (a chunk's bins) recomputes 256 slots
//     at a time from the inputs in the working type (so bins never see
//     bf16-rounded planes), stages their 38 values in shared memory, and
//     its lanes sum 3x3 blocks of each bin's Gram and gradient in slot
//     order straight into the bin's row of gc / hc.
//   * The sweeps (rhs / matvec) read a sorted copy of the jcam planes, built
//     once per LM step (the planes are fixed within a step, and a sweep runs
//     2 + one per PCG iteration times): the row pass writes each slot's t2
//     at its sorted position (SlotBins.pos), and the bin pass reads only
//     sorted data, every load coalesced. tile_sweep (no local tables; a
//     cell's ~4000 slots lie on rows spread over the whole bucket): sort_rows
//     copies the (Nb, W, 36) slot rows, gsweep_rows / gsweep_bins sum per
//     segment, reduce_bins per cell. tile_sweep_local (bins ~32 slots, all
//     of a chunk's in one run of positions): sort_planes copies the
//     transposed planes themselves, bit for bit; the same row pass reads the
//     chunk's local v table, and lsweep_bins sums one chunk per block, each
//     bin straight into its final row; gather_cells then sums the chunk bins
//     into the global cells in one fixed order.
//   * No float atomics anywhere, so every run gives the same bits.
//
// What bounds it on the card. Device-memory bytes. The linearize writes
// 44 plane values per slot (2 r, 6 jx, 36 jcam) plus its bins (189 values
// a bin, ~32 slots a bin on a locality bucket), and its bin pass reads the
// row pass's inputs once more through the sorted list (L2-resident within
// a chunk) and does 2 x 189 FMAs a slot from shared memory; a matvec
// sweep reads the 42 jx/jcam values of every slot, and both sweeps read the
// sorted copy's 36 once more, coalesced: about 640 bytes a slot in f64
// against the bound's ~350, plus the copy (2.3 GB at 1M rows x 8 slots)
// once per step. bf16 planes halve (f32) or quarter (f64) the plane bytes.
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

// tile_linearize_local's bin pass: the per-bin gradient gc (18) and upper
// Gram hc (171) of every bin, in the working type. Block r owns run r of
// bins (SlotBins.runs: the bins of one chunk, or of at most LB_RUN sorted
// slots of a chunk), whose slots fill one run of sorted positions, and
// walks them LB_THREADS at a time:
//   * stage: thread k recomputes the slot at position t0 + k (order[] ->
//     flat id) from the inputs, so the bins never see bf16-rounded planes,
//     and stages its 38 values (P_0 18, r_0, P_1 18, r_1) in shared memory;
//   * sum: warp w takes the slice's bins w, w + 8, ...; its lane l < 21
//     owns one 3x3 block of the upper Gram, lanes 21..26 one 3-value block
//     of P^T r, and sums it over the bin's staged slots in slot order with
//     FMAs; the lane then writes its values straight into the bin's row of
//     gc / hc, or adds them there when the bin began in an earlier slice.
// The block alone writes its bins' rows, each bin's pieces in slice order:
// no partial rows, no second pass, no shuffles, the same bits every run.
constexpr int LB_THREADS = 256;         // slots of a slice, one per thread
constexpr int LB_WARPS = LB_THREADS / 32;
constexpr int LB_LD = LB_THREADS + 1;   // row stride of the staged values
constexpr int LB_ROWS = 38;             // staged values a slot: P_0 r_0 P_1 r_1
constexpr int LB_BINS = 1024;           // most bins of a run (slot_bins)

// A slot's inputs, gathered through the sorted list; m = 0 past its end.
template <typename S>
struct Gathered {
  S X[3], pf[3], x0, x1, m;
  int p, cell;
};

template <typename S>
__device__ __forceinline__ Gathered<S> gather_slot(
    const int* __restrict__ order, const S* __restrict__ mask,
    const S* __restrict__ xy0, const S* __restrict__ xy1,
    const int* __restrict__ cell, const S* __restrict__ pts, int i, int end,
    int Nb) {
  Gathered<S> g;
  g.m = S(0);
  g.p = 0;
  g.cell = 0;
  if (i < end) {
    const int f = order[i];
    g.p = f % Nb;
    g.m = mask[f];
    g.x0 = xy0[f];
    g.x1 = xy1[f];
    g.cell = cell[f];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      g.X[a] = pts[(long)a * Nb + g.p];
      g.pf[a] = pts[(long)(3 + a) * Nb + g.p];
    }
  }
  return g;
}

template <typename S, int LOSS>
__global__ void __launch_bounds__(LB_THREADS, 2)
linearize_bins(const S* __restrict__ pts, const int* __restrict__ cell,
               const S* __restrict__ xy0, const S* __restrict__ xy1,
               const S* __restrict__ mask, const S* __restrict__ tables,
               const int* __restrict__ order,
               const int* __restrict__ seg_start,
               const int* __restrict__ bin_seg, const int* __restrict__ runs,
               int Nb, int B, int Vl, S scale, S* __restrict__ gc,
               S* __restrict__ hc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* st = reinterpret_cast<S*>(smem_raw);                     // [38][LB_LD]
  int* bstart = reinterpret_cast<int*>(st + LB_ROWS * LB_LD);  // [nb + 1]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b_lo = runs[blockIdx.x], nb = runs[blockIdx.x + 1] - b_lo;
  if (nb > LB_BINS) __trap();  // slot_bins cuts runs at LB_BINS bins
  for (int l = tid; l <= nb; l += LB_THREADS)
    bstart[l] = seg_start[bin_seg[b_lo + l]];
  __syncthreads();
  // a bin with no slots is a zero row
  for (int l = warp; l < nb; l += LB_WARPS) {
    if (bstart[l] != bstart[l + 1]) continue;
    for (int v = lane; v < NV_LIN; v += 32) {
      if (v < 18)
        gc[(long)(b_lo + l) * 18 + v] = S(0);
      else
        hc[(long)(b_lo + l) * 171 + v - 18] = S(0);
    }
  }

  // the lane's 3x3 block: staged rows ca (block rows) x cb (block columns)
  // of one residual row; lanes 21..26 take P^T r (cb = r), 27..31 idle
  int ca = 0, cb = 0, blkI = 0;
  if (lane < 21) {
    int l = lane;
    while (l >= 6 - blkI) {
      l -= 6 - blkI;
      ++blkI;
    }
    ca = 3 * blkI;
    cb = 3 * (blkI + l);
  } else {
    ca = lane < 27 ? 3 * (lane - 21) : 0;
    cb = 18;
  }
  const int cb_step = lane < 21 ? 1 : 0;
  // where each of the lane's nine sums goes in a bin's 189 values (-1:
  // below the diagonal, or an idle lane)
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

  const int s_lo = bstart[0], s_hi = bstart[nb];
  // the thread's slot of the next slice: its gathered inputs are loaded
  // while the current slice is summed
  Gathered<S> g = gather_slot<S>(order, mask, xy0, xy1, cell, pts, s_lo + tid,
                                 s_hi, Nb);
  int fb = 0;  // the first bin of the current slice
  for (int t0 = s_lo; t0 < s_hi; t0 += LB_THREADS) {
    const int t1 = min(t0 + LB_THREADS, s_hi);
    {
      S r0 = S(0), r1 = S(0), Pj[2][18];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < 18; ++j) Pj[k][j] = S(0);
      if (g.m != S(0)) {
        const S* c = tables + ((g.p / B) * (long)Vl + g.cell) * rig::SP_COLS;
        S jx[2][3];
        rig::slot_products<S, LOSS, 18, TileCols>(c, g.X, g.pf, g.x0, g.x1,
                                                  g.m, scale, r0, r1, jx, Pj);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int j = 0; j < 18; ++j) st[(19 * k + j) * LB_LD + tid] = Pj[k][j];
        st[(19 * k + 18) * LB_LD + tid] = k == 0 ? r0 : r1;
      }
    }
    __syncthreads();
    g = gather_slot<S>(order, mask, xy0, xy1, cell, pts, t1 + tid, s_hi, Nb);
    while (bstart[fb + 1] <= t0) ++fb;
    for (int l = fb + warp; l < nb && bstart[l] < t1; l += LB_WARPS) {
      const int lo = max(bstart[l], t0) - t0, hi = min(bstart[l + 1], t1) - t0;
      if (hi <= lo) continue;
      S acc[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[i][j] = S(0);
#pragma unroll 4
      for (int x = lo; x < hi; ++x) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          S a[3], b[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            a[i] = st[(19 * k + ca + i) * LB_LD + x];
            b[i] = st[(19 * k + cb + i * cb_step) * LB_LD + x];
          }
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) acc[i][j] += a[i] * b[j];
        }
      }
      // the bin's first piece is written, a later one added
      const bool first = bstart[l] >= t0;
      const long b = b_lo + l;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int v = vidx[i][j];
          if (v < 0) continue;
          S* o = v < 18 ? gc + b * 18 + v : hc + b * 171 + (v - 18);
          *o = first ? acc[i][j] : *o + acc[i][j];
        }
    }
    __syncthreads();
  }
}

// Dynamic shared memory of linearize_bins.
inline size_t lbins_smem(size_t esz) {
  return (size_t)LB_ROWS * LB_LD * esz + (LB_BINS + 1) * sizeof(int);
}

// ---------------------------------------------------------------------------
// Sweeps
// ---------------------------------------------------------------------------

// The sweeps' edot mode (E v per row, no bins): one thread per row. LOCAL:
// v is the per-chunk (n_chunks, 18, Vl) table and cell holds local ids;
// otherwise v is the global (V, 18) vector.
template <typename S, typename P, bool LOCAL>
__global__ void __launch_bounds__(256)
edot_rows(const int* __restrict__ cell, const P* __restrict__ jcam_t,
          const P* __restrict__ jx_t, const S* __restrict__ v, int W, int Nb,
          int B, int n_cells, S* __restrict__ ev_out) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Nb) return;
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
#pragma unroll
  for (int i = 0; i < 3; ++i) ev_out[p * 3 + i] = ev[i];
}

// A slot's two scalars t2_k = jx_k . w, stored together (one 16- or 8-byte
// access per slot).
template <typename S>
struct alignas(2 * sizeof(S)) Pair {
  S k0, k1;
};

// The sweeps' row pass in rhs/matvec: w = B^-1 (g_p or E v), then each
// slot's t2 = (jx_0 . w, jx_1 . w) is written at the slot's position in the
// sorted order (pos = inverse of SlotBins.order). tile_sweep: v is the
// global (V, 18) vector; LOCAL (tile_sweep_local): v is the per-chunk
// (n_chunks, 18, Vl) table of the row's chunk of B rows, cell holds local
// ids.
template <typename S, typename P, int MODE, bool LOCAL>
__global__ void __launch_bounds__(256)
gsweep_rows(const int* __restrict__ cell, const P* __restrict__ jcam_t,
            const P* __restrict__ jx_t, const S* __restrict__ binv,
            const S* __restrict__ gp, const S* __restrict__ v,
            const int* __restrict__ pos, int W, int Nb, int B, int Vl,
            Pair<S>* __restrict__ t2) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Nb) return;
  S rhs[3];
  if (MODE == RHS) {
#pragma unroll
    for (int i = 0; i < 3; ++i) rhs[i] = gp[(long)i * Nb + p];
  } else {
    S ev[3] = {S(0), S(0), S(0)};
    const S* vt = LOCAL ? v + (p / B) * 18L * Vl : v;
    for (int w = 0; w < W; ++w) {
      const long l = cell[(long)w * Nb + p];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        S t = S(0);
#pragma unroll
        for (int j = 0; j < 18; ++j)
          t += Plane<S, P>::load(jcam_t, (36L * w + 18 * k + j) * Nb + p) *
               (LOCAL ? vt[j * Vl + l] : vt[l * 18 + j]);
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
// jcam planes (36, n_slots) and of t2 is coalesced.
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
// tile_sweep_local (rhs / matvec): one block per chunk
// ---------------------------------------------------------------------------

// The chunk-sorted copy of a locality bucket's jcam planes: out[c][i] =
// jcam_t[36 w + c][p] for the slot order[i] = w * Nb + p, copied bit for bit
// in the planes' storage type (T is an unsigned integer of its size). The
// bins are chunk * V_local + local id, so chunk ch's slots fill sorted
// positions [ch B W, (ch + 1) B W) and its rows [ch B, (ch + 1) B). Block
// (c, ch) stages the chunk's W x B values of plane column c in shared
// memory with coalesced reads (the 36 blocks of a chunk run together, so
// its order list is read from L2), then writes the chunk's sorted row
// coalesced. A chunk too large for shared memory reads its values directly.
template <typename T>
__global__ void __launch_bounds__(256)
sort_planes(const T* __restrict__ planes, const int* __restrict__ order,
            int W, int Nb, int B, int staged, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);  // [W][B]
  const int c = blockIdx.x, ch = blockIdx.y;
  const int n = W * B;
  const long p0 = (long)ch * B, i0 = (long)ch * n, n_slots = (long)W * Nb;
  if (staged) {
    for (int w = 0; w < W; ++w) {
      const T* src = planes + (36L * w + c) * Nb + p0;
#pragma unroll 4
      for (int pp = threadIdx.x; pp < B; pp += blockDim.x) st[w * B + pp] = src[pp];
    }
    __syncthreads();
  }
#pragma unroll 4
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int f = order[i0 + k];
    const int w = f / Nb;
    const int pp = f - w * Nb - (int)p0;
    out[c * n_slots + i0 + k] =
        staged ? st[w * B + pp] : planes[(36L * w + c) * Nb + p0 + pp];
  }
}

constexpr int LS_THREADS = 256;         // threads of a chunk's block
constexpr int LS_LD = LS_THREADS + 1;   // row stride of the staged products

__device__ __forceinline__ int upper_bound(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// tile_sweep_local's bin pass (rhs / matvec), after gsweep_rows<LOCAL> has
// written each slot's t2 at its sorted position. Block ch owns chunk ch: its
// V_local bins and their sorted positions [ch B W, (ch + 1) B W), 256 at a
// time: thread k forms position k's 18 products jsrt[j] t2_0 + jsrt[18 + j]
// t2_1 from the chunk-sorted jcam copy (coalesced) into shared memory; then
// each (bin, value) pair meeting the 256 positions is summed by one thread
// (four interleaved partial sums, combined in a fixed order) and added to
// out[ch, bin, value]. The pieces of a bin are added in position order and
// the block alone writes its chunk's rows, so the per-chunk bins come out
// final: no partial rows and no second pass, the same bits every run.
template <typename S, typename P>
__global__ void __launch_bounds__(LS_THREADS)
lsweep_bins(const P* __restrict__ jsrt, const Pair<S>* __restrict__ t2,
            const int* __restrict__ seg_start,
            const int* __restrict__ bin_seg, int W, int Nb, int B, int Vl,
            S* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* bstart = reinterpret_cast<int*>(smem_raw);  // [Vl + 1]
  S* us = reinterpret_cast<S*>(smem_raw + (((Vl + 1) * 4 + 15) & ~15));
  const int tid = threadIdx.x, ch = blockIdx.x;
  const int nc = W * B;
  const long c0 = (long)ch * nc, n_slots = (long)W * Nb;
  S* o = out + (long)ch * Vl * 18;
  for (int l = tid; l <= Vl; l += LS_THREADS)
    bstart[l] = seg_start[bin_seg[(long)ch * Vl + l]] - (int)c0;
  for (int q = tid; q < Vl * 18; q += LS_THREADS) o[q] = S(0);
  __syncthreads();

  for (int t0 = 0; t0 < nc; t0 += LS_THREADS) {
    const int t1 = min(t0 + LS_THREADS, nc);
    if (t0 + tid < t1) {
      const long i = c0 + t0 + tid;
      const Pair<S> tt = t2[i];
#pragma unroll
      for (int j = 0; j < 18; ++j)
        us[j * LS_LD + tid] = Plane<S, P>::load(jsrt, j * n_slots + i) * tt.k0 +
                              Plane<S, P>::load(jsrt, (18 + j) * n_slots + i) * tt.k1;
    }
    __syncthreads();
    const int fb = upper_bound(bstart, Vl + 1, t0) - 1;
    const int lb = upper_bound(bstart, Vl + 1, t1 - 1) - 1;
    for (int q = tid; q < (lb - fb + 1) * 18; q += LS_THREADS) {
      const int b = fb + q / 18, j = q % 18;
      const int lo = max(bstart[b], t0) - t0, hi = min(bstart[b + 1], t1) - t0;
      if (hi <= lo) continue;
      const S* u = us + j * LS_LD;
      S s0 = S(0), s1 = S(0), s2 = S(0), s3 = S(0);
      int x = lo;
      for (; x + 4 <= hi; x += 4) {
        s0 += u[x];
        s1 += u[x + 1];
        s2 += u[x + 2];
        s3 += u[x + 3];
      }
      for (; x < hi; ++x) s0 += u[x];
      o[b * 18 + j] += (s0 + s1) + (s2 + s3);
    }
    __syncthreads();
  }
}

// Dynamic shared memory of lsweep_bins.
inline size_t lsweep_smem(int Vl, size_t esz) {
  return (((size_t)(Vl + 1) * 4 + 15) & ~(size_t)15) + 18 * LS_LD * esz;
}

// out[v, j] = sum of part[src[k], j] for k in [cstart[v], cstart[v + 1]),
// for rows of F <= GATHER_MAXF values: a locality bucket's per-chunk bins
// summed into the global cells (F = 18 of a sweep, 18 and 171 of the
// linearize), a cell vector into the flat camera vector (F = 1), the
// block-Jacobi's 6x6 blocks (F = 36), the torch chunk path's slot rows into
// the cells. A row's sources may number thousands (every BAL cell names the
// shared inner frame; a hub cell owns thousands of a piece's slots), so a
// row's sources are cut into stripes, each summed in list order by its own
// thread, and the stripes' sums are added in stripe order: for F > 1 one
// block takes one output row, its threads 8 stripes x 32 column lanes
// (columns l, l + 32, ...); for F = 1 each warp takes one row, its lanes
// 32 stripes. One fixed order, no float atomics.
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_COLS = 6;
constexpr int GATHER_MAXF = 32 * GATHER_COLS;

template <typename S>
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_cells(const S* __restrict__ part, const int* __restrict__ cstart,
                 const int* __restrict__ src, int V, int F,
                 S* __restrict__ out) {
  __shared__ S stripe[GATHER_THREADS / 32 * GATHER_MAXF];
  const bool one = F == 1;
  const int rows = one ? GATHER_THREADS / 32 : 1;   // output rows a block
  const int lanes = one ? 1 : 32;                   // column lanes a row
  const int gs = one ? 32 : GATHER_THREADS / 32;    // source stripes a row
  const int r = threadIdx.x / (lanes * gs);
  const int st = (threadIdx.x / lanes) % gs, l = threadIdx.x % lanes;
  const int v = blockIdx.x * rows + r;
  S acc[GATHER_COLS];
#pragma unroll
  for (int c = 0; c < GATHER_COLS; ++c) acc[c] = S(0);
  if (v < V) {
    const int k1 = cstart[v + 1];
#pragma unroll 4
    for (int k = cstart[v] + st; k < k1; k += gs) {
      const S* row = part + (long)src[k] * F;
#pragma unroll
      for (int c = 0; c < GATHER_COLS; ++c)
        if (l + 32 * c < F) acc[c] += row[l + 32 * c];
    }
  }
#pragma unroll
  for (int c = 0; c < GATHER_COLS; ++c)
    if (l + 32 * c < F) stripe[(r * gs + st) * F + l + 32 * c] = acc[c];
  __syncthreads();
  for (int q = threadIdx.x; q < rows * F; q += GATHER_THREADS) {
    const int rq = q / F, j = q % F;
    if (blockIdx.x * rows + rq >= V) continue;
    S t = stripe[rq * gs * F + j];
    for (int s = 1; s < gs; ++s) t += stripe[(rq * gs + s) * F + j];
    out[(long)(blockIdx.x * rows + rq) * F + j] = t;
  }
}

// ---------------------------------------------------------------------------
// Fixed-order second passes
// ---------------------------------------------------------------------------

// out[bin] (n_bins, nv) = sum over the bin's segments, in order, of their
// partial rows (tile_sweep's second pass).
template <typename S>
__global__ void reduce_bins(const S* __restrict__ partial,
                            const int* __restrict__ bin_seg, int n_bins,
                            int nv, S* __restrict__ out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)n_bins * nv) return;
  const long b = idx / nv;
  const int q = (int)(idx - b * nv);
  S s = S(0);
  for (int g = bin_seg[b]; g < bin_seg[b + 1]; ++g) s += partial[(long)g * nv + q];
  out[idx] = s;
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

// tile_linearize_local's bin pass: one block per run of bins, gc (n_bins,
// 18) and hc (n_bins, 171) final.
extern "C" int tile_linearize_bins(int dtype, int loss, const void* pts,
                                   const void* cell, const void* xy0,
                                   const void* xy1, const void* mask,
                                   const void* tables, const void* order,
                                   const void* seg_start, const void* bin_seg,
                                   const void* runs, int n_runs, int Nb, int B,
                                   int Vl, double scale, void* gc, void* hc,
                                   void* stream) {
  if (n_runs == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = lbins_smem(dtype == 1 ? 8 : 4);
#define TILE_BINS(T, L)                                                      \
  {                                                                          \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        linearize_bins<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
        (int)smem);                                                          \
    if (e != cudaSuccess) return (int)e;                                     \
    linearize_bins<T, L><<<n_runs, LB_THREADS, smem, s>>>(                   \
        (const T*)pts, (const int*)cell, (const T*)xy0, (const T*)xy1,       \
        (const T*)mask, (const T*)tables, (const int*)order,                 \
        (const int*)seg_start, (const int*)bin_seg, (const int*)runs, Nb, B, \
        Vl, (T)scale, (T*)gc, (T*)hc);                                       \
    return (int)cudaGetLastError();                                          \
  }
  if (dtype == 1) {
    if (loss == rig::TRIVIAL) TILE_BINS(double, rig::TRIVIAL)
    if (loss == rig::HUBER) TILE_BINS(double, rig::HUBER)
    if (loss == rig::CAUCHY) TILE_BINS(double, rig::CAUCHY)
  } else if (dtype == 0) {
    if (loss == rig::TRIVIAL) TILE_BINS(float, rig::TRIVIAL)
    if (loss == rig::HUBER) TILE_BINS(float, rig::HUBER)
    if (loss == rig::CAUCHY) TILE_BINS(float, rig::CAUCHY)
  }
#undef TILE_BINS
  return (int)cudaErrorInvalidValue;
}

// E v per row of a bucket (the sweeps' edot mode); local: v is the
// per-chunk table and cell holds local ids.
extern "C" int tile_edot(int dtype, int pdtype, int local, const void* cell,
                         const void* jcam_t, const void* jx_t, const void* v,
                         int W, int Nb, int B, int n_cells, int threads,
                         void* ev_out, void* stream) {
  if (threads % 32 != 0 || threads <= 0 || threads > 256)
    return (int)cudaErrorInvalidValue;
  if (Nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = blocks_for(Nb, threads);
#define TILE_EDOT(T, PT, LOC)                                                \
  edot_rows<T, PT, LOC><<<grid, threads, 0, s>>>(                            \
      (const int*)cell, (const PT*)jcam_t, (const PT*)jx_t, (const T*)v, W,  \
      Nb, B, n_cells, (T*)ev_out);                                           \
  return (int)cudaGetLastError()
#define TILE_EDOT_LOC(T, PT)                               \
  if (local) { TILE_EDOT(T, PT, true); }                   \
  else { TILE_EDOT(T, PT, false); }
  if (dtype == 1 && pdtype == 0) { TILE_EDOT_LOC(double, double) }
  if (dtype == 1 && pdtype == 1) { TILE_EDOT_LOC(double, __nv_bfloat16) }
  if (dtype == 0 && pdtype == 0) { TILE_EDOT_LOC(float, float) }
  if (dtype == 0 && pdtype == 1) { TILE_EDOT_LOC(float, __nv_bfloat16) }
#undef TILE_EDOT_LOC
#undef TILE_EDOT
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
  gsweep_rows<T, PT, M, false><<<rgrid, threads, 0, s>>>(                    \
      (const int*)cell, (const PT*)jcam_t, (const PT*)jx_t, (const T*)binv,  \
      (const T*)gp, (const T*)v, (const int*)pos, W, Nb, 0, 0, (Pair<T>*)t2)
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

// tile_sweep_local's chunk-sorted (36, W * Nb) copy of its (36 W, Nb) jcam
// planes, esz bytes a value.
extern "C" int tile_sort_planes(int esz, const void* planes,
                                const void* order, int W, int Nb, int B,
                                void* out, void* stream) {
  if (W <= 0 || B <= 0 || Nb % B != 0) return (int)cudaErrorInvalidValue;
  if (Nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(36, Nb / B);
  const size_t smem = (size_t)W * B * esz;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const int staged = smem <= (size_t)optin;
#define TILE_SORTP(T)                                                         \
  {                                                                           \
    if (staged) {                                                             \
      e = cudaFuncSetAttribute(sort_planes<T>,                                \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                               (int)smem);                                    \
      if (e != cudaSuccess) return (int)e;                                    \
    }                                                                         \
    sort_planes<T><<<grid, 256, staged ? smem : 0, s>>>(                      \
        (const T*)planes, (const int*)order, W, Nb, B, staged, (T*)out);      \
    return (int)cudaGetLastError();                                           \
  }
  if (esz == 8) TILE_SORTP(unsigned long long)
  if (esz == 4) TILE_SORTP(unsigned int)
  if (esz == 2) TILE_SORTP(unsigned short)
#undef TILE_SORTP
  return (int)cudaErrorInvalidValue;
}

// tile_sweep_local in rhs (mode 0) or matvec (mode 1): the row pass writes
// t2 at sorted positions, then one block per chunk sums the chunk's bins;
// out (n_chunks, Vl, 18) final.
extern "C" int tile_lsweep(int dtype, int pdtype, int mode, const void* cell,
                           const void* jcam_t, const void* jx_t,
                           const void* binv, const void* gp, const void* v,
                           const void* pos, const void* jsrt,
                           const void* seg_start, const void* bin_seg, int W,
                           int Nb, int B, int Vl, void* t2, void* out,
                           void* stream) {
  if ((mode != RHS && mode != MATVEC) || B <= 0 || Nb % B != 0 || Vl <= 0)
    return (int)cudaErrorInvalidValue;
  if (Nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = lsweep_smem(Vl, dtype == 1 ? 8 : 4);
  const int rgrid = blocks_for(Nb, 256);
#define TILE_LROWS(T, PT, M)                                                 \
  gsweep_rows<T, PT, M, true><<<rgrid, 256, 0, s>>>(                         \
      (const int*)cell, (const PT*)jcam_t, (const PT*)jx_t, (const T*)binv,  \
      (const T*)gp, (const T*)v, (const int*)pos, W, Nb, B, Vl, (Pair<T>*)t2)
#define TILE_LS(T, PT)                                                       \
  {                                                                          \
    if (mode == RHS)                                                         \
      TILE_LROWS(T, PT, RHS);                                                \
    else                                                                     \
      TILE_LROWS(T, PT, MATVEC);                                             \
    cudaError_t e = cudaGetLastError();                                      \
    if (e == cudaSuccess)                                                    \
      e = cudaFuncSetAttribute(lsweep_bins<T, PT>,                           \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               (int)smem);                                   \
    if (e != cudaSuccess) return (int)e;                                     \
    lsweep_bins<T, PT><<<Nb / B, LS_THREADS, smem, s>>>(                     \
        (const PT*)jsrt, (const Pair<T>*)t2, (const int*)seg_start,          \
        (const int*)bin_seg, W, Nb, B, Vl, (T*)out);                         \
    return (int)cudaGetLastError();                                          \
  }
  if (dtype == 1 && pdtype == 0) TILE_LS(double, double)
  if (dtype == 1 && pdtype == 1) TILE_LS(double, __nv_bfloat16)
  if (dtype == 0 && pdtype == 0) TILE_LS(float, float)
  if (dtype == 0 && pdtype == 1) TILE_LS(float, __nv_bfloat16)
#undef TILE_LS
#undef TILE_LROWS
  return (int)cudaErrorInvalidValue;
}

extern "C" int tile_gather_cells(int dtype, const void* part,
                                 const void* cstart, const void* src, int V,
                                 int F, void* out, void* stream) {
  if (V == 0 || F == 0) return 0;
  if (F > GATHER_MAXF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = F == 1 ? blocks_for(V, GATHER_THREADS / 32) : V;
  if (dtype == 1)
    gather_cells<double><<<grid, GATHER_THREADS, 0, s>>>(
        (const double*)part, (const int*)cstart, (const int*)src, V, F,
        (double*)out);
  else if (dtype == 0)
    gather_cells<float><<<grid, GATHER_THREADS, 0, s>>>(
        (const float*)part, (const int*)cstart, (const int*)src, V, F,
        (float*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int tile_reduce_bins(int dtype, const void* partial,
                                const void* bin_seg, int n_bins, int nv,
                                void* out, void* stream) {
  const long n = (long)n_bins * nv;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = blocks_for(n, 256);
  if (dtype == 1)
    reduce_bins<double><<<grid, 256, 0, s>>>(
        (const double*)partial, (const int*)bin_seg, n_bins, nv,
        (double*)out);
  else if (dtype == 0)
    reduce_bins<float><<<grid, 256, 0, s>>>(
        (const float*)partial, (const int*)bin_seg, n_bins, nv,
        (float*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int tile_reduce_cost(int dtype, const void* partial, int n,
                                void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    rig::reduce_cost_lanes<double><<<1, 32, 0, s>>>((const double*)partial,
                                                    n, (double*)out);
  else if (dtype == 0)
    rig::reduce_cost_lanes<float><<<1, 32, 0, s>>>((const float*)partial, n,
                                                   (float*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
