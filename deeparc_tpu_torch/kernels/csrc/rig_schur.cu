// The grid step's Schur reduction for Hopper (sm_90a): from the point
// Jacobian blocks E (N, 3, Cn), the inverse augmented point blocks binv
// (N, 3, 3) and the point gradient g_p (N, 3), in one pass over E,
//   corr = E^T B^-1 E   (Cn, Cn), both triangles written,
//   v    = E^T B^-1 g_p (Cn),
// with E's columns in whatever order E has them.
//
// It replaces no Pallas kernel: the JAX package leaves these two products
// to XLA (deeparc_tpu/solver/rig_grid.py:730-734, einsums over sys.E).
// On the card they were a batched 3x3 product be = B^-1 E written to
// device memory (3N x Cn values: 1.84 GB at 400k points x 192 columns in
// float64) and two library products reading E and be again.
//
// What bounds it on the card. Read once, E is 0.55 ms at 400k x 3 x 192
// in float64 (0.69 ms at 240 columns); the upper triangle of the product
// is 3N x Cn (Cn + 1) operations, 44.5 GFLOP (69.4), 0.66 ms (1.04) at the
// 67 TFLOP/s of the float64 tensor cores. The two are of one size, so the
// design keeps E out of device memory but for one read, and feeds the
// tensor cores from shared memory.
//
// Design of schur_tiles. The Cn x Cn output is cut into TILE-wide tiles;
// a block owns one tile (I, J) of the upper triangle and one slice of the
// points, and walks the slice in chunks of CP points (KR = 3 CP rows of E):
//   * cp.async copies the chunk's E column strips I and J (one strip when
//     I = J), the chunk's binv and g_p into shared memory, two stages deep,
//     so the next chunk is in flight while this one is used; rows past N
//     and columns past Cn are zero-filled;
//   * the J strip becomes (B^-1 E)_J in place, point by point, on the CUDA
//     cores (from the I strip when I = J, which then also forms B^-1 g_p);
//   * 4 warps, 2 x 2, each accumulate a 32 x 32 piece of E_I^T (B^-1 E)_J
//     over the chunk's rows: float64 with mma.sync m16n8k8 (wgmma takes no
//     float64; the older m8n8k4 ran 25% slower here), float32 with FFMA
//     (never TF32: the configuration's precision stays). A diagonal tile
//     skips its piece below the diagonal;
//   * the diagonal tile's block also sums E_I^T (B^-1 g_p) on the CUDA
//     cores.
// The blocks of one slice are adjacent in launch order and run together,
// so the strips a slice's tiles share come from L2: device memory sees E
// about once. Each block writes its tile to its slice's own partial; a
// second kernel sums the slices in slice order and mirrors the upper
// triangle. No float atomics: every run gives the same bits. The kernels
// allocate nothing and never synchronise (the graph driver captures them).
//
// On an H100 (700 W) it takes 2.1 ms at 192 columns and 3.3 ms at 240,
// about 3x its bound. Per chunk a block's shared-memory traffic (the
// copies, the in-place product and the MMA operands) takes about as long
// as its MMAs at their peak, and the two overlap little. Measured against
// these 64-wide tiles of 8-point chunks, four blocks to an SM: a
// warp-specialized variant (loading warps feeding MMA warps through named
// barriers) and larger chunks (16, 32 points) were slower; wider tiles
// (96, 128 columns) were slower at 192 columns and 6% faster at 240, so
// one shape serves both.
#include <cuda_runtime.h>

namespace schur {

constexpr int TILE = 64;            // output tile width
constexpr int CP = 8;               // points of a chunk
constexpr int KR = 3 * CP;          // rows of E in a chunk
constexpr int LD = TILE + 4;        // padded row of a staged strip
constexpr int THREADS = 128;        // 4 warps, 2 x 2 pieces of 32 x 32
// one stage: the I strip, the J strip, binv and g_p of CP points
constexpr int STAGE = 2 * KR * LD + CP * 9 + CP * 3;

static_assert(THREADS == 2 * TILE, "v takes two threads a column");
static_assert(KR % 8 == 0, "the float64 product takes 8 rows a step");

template <typename S>
constexpr size_t smem_bytes() {
  return 2 * (size_t)STAGE * sizeof(S);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float fused(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused(double a, double b, double c) {
  return fma(a, b, c);
}

// d (16 x 8) += a (16 x 8, row) . b (8 x 8, col): lane (g, t) = (lane / 4,
// lane % 4) holds a[g + 8 (i % 2)][t + 4 (i / 2)] as a[i], b[t + 4 i][g] as
// b[i], and d[g + 8 (i / 2)][2t + i % 2] as d[i]
__device__ __forceinline__ void dmma(double* d, const double* a,
                                     const double* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The chunk of np_ points from point p0 into stage st: strip I (columns
// ci + [0, wi)) and, off the diagonal, strip J (cj + [0, wj)), two values a
// copy; binv and g_p one value a copy.
template <typename S>
__device__ __forceinline__ void load_chunk(S* st, const S* __restrict__ E,
                                           const S* __restrict__ binv,
                                           const S* __restrict__ g, int Cn,
                                           long p0, int np_, int ci, int wi,
                                           int cj, int wj, bool diag) {
  constexpr int UPR = TILE / 2;
  S* Ai = st;
  S* Bj = st + KR * LD;
  S* bi = st + 2 * KR * LD;
  const int rows = 3 * np_;
  const S* Er = E + (size_t)p0 * 3 * Cn;
  for (int u = threadIdx.x; u < KR * UPR; u += THREADS) {
    const int r = u / UPR, c = (u % UPR) * 2;
    S* da = Ai + r * LD + c;
    if (r < rows && c < wi)
      cp_async<2 * sizeof(S)>(da, Er + (size_t)r * Cn + ci + c);
    else
      da[0] = da[1] = S(0);
    if (diag) continue;
    S* db = Bj + r * LD + c;
    if (r < rows && c < wj)
      cp_async<2 * sizeof(S)>(db, Er + (size_t)r * Cn + cj + c);
    else
      db[0] = db[1] = S(0);
  }
  for (int u = threadIdx.x; u < CP * 12; u += THREADS) {
    const bool is_b = u < CP * 9;
    const int q = is_b ? u : u - CP * 9;
    const S* src = is_b ? binv + (size_t)p0 * 9 + q : g + (size_t)p0 * 3 + q;
    if (q < (is_b ? 9 : 3) * np_)
      cp_async<sizeof(S)>(bi + u, src);
    else
      bi[u] = S(0);
  }
}

template <typename S>
__global__ void __launch_bounds__(THREADS, 4)
    schur_tiles(const S* __restrict__ E, const S* __restrict__ binv,
                const S* __restrict__ g, int N, int Cn, int n_tiles,
                int n_pairs, int slice_pts, S* __restrict__ part_corr,
                S* __restrict__ part_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ S bgs[KR];
  __shared__ S vsum[THREADS];
  S* sm = reinterpret_cast<S*>(smem_raw);

  const int pair = blockIdx.x % n_pairs, slice = blockIdx.x / n_pairs;
  int ti = 0, k = pair;
  while (k >= n_tiles - ti) {
    k -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + k;
  const bool diag = ti == tj;
  const int ci = ti * TILE, cj = tj * TILE;
  const int wi = min(TILE, Cn - ci), wj = min(TILE, Cn - cj);
  const long p_lo = (long)slice * slice_pts;
  const long p_hi = p_lo + slice_pts < N ? p_lo + slice_pts : (long)N;
  const int n_chunks = p_hi > p_lo ? (int)((p_hi - p_lo + CP - 1) / CP) : 0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (warp & 1) * 32, n0 = (warp >> 1) * 32;
  // a diagonal tile's piece below its diagonal is never read
  const bool skip = diag && m0 > n0;
  S acc[4][4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = S(0);
  S vacc = S(0);

  auto chunk_pts = [&](int ch) {
    const long left = p_hi - p_lo - (long)ch * CP;
    return left < CP ? (int)left : CP;
  };
  if (n_chunks > 0) {
    load_chunk(sm, E, binv, g, Cn, p_lo, chunk_pts(0), ci, wi, cj, wj, diag);
    cp_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    S* st = sm + (ch & 1) * STAGE;
    if (ch + 1 < n_chunks) {
      load_chunk(sm + ((ch + 1) & 1) * STAGE, E, binv, g, Cn,
                 p_lo + (long)(ch + 1) * CP, chunk_pts(ch + 1), ci, wi, cj,
                 wj, diag);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    S* Ai = st;
    S* Bj = st + KR * LD;
    const S* bi = st + 2 * KR * LD;
    const S* src = diag ? Ai : Bj;
    // (B^-1 E)_J in place (from strip I on the diagonal); zero past N,
    // where binv was zero-filled
    for (int u = tid; u < CP * TILE; u += THREADS) {
      const int q = u / TILE, c = u % TILE;
      const S* b = bi + 9 * q;
      const S x0 = src[(3 * q) * LD + c], x1 = src[(3 * q + 1) * LD + c],
              x2 = src[(3 * q + 2) * LD + c];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        Bj[(3 * q + i) * LD + c] =
            fused(b[3 * i + 2], x2, fused(b[3 * i + 1], x1, b[3 * i] * x0));
    }
    if (diag && tid < KR) {
      const int q = tid / 3, i = tid % 3;
      const S* b = bi + 9 * q;
      const S* gp = bi + CP * 9 + 3 * q;
      bgs[tid] = fused(b[3 * i + 2], gp[2],
                       fused(b[3 * i + 1], gp[1], b[3 * i] * gp[0]));
    }
    __syncthreads();
    if (diag) {
      const int c = tid % TILE, r0 = (tid / TILE) * (KR / 2);
#pragma unroll 8
      for (int r = r0; r < r0 + KR / 2; ++r)
        vacc = fused(Ai[r * LD + c], bgs[r], vacc);
    }
    if (!skip) {
      if constexpr (sizeof(S) == 8) {
        // two 16-row blocks by four 8-column blocks; acc[2 mb + h][nb]
        // holds rows 8 h + g of 16-row block mb
#pragma unroll
        for (int k0 = 0; k0 < KR; k0 += 8) {
          double a[2][4], b[4][2];
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[mb][i] = Ai[(k0 + tq + 4 * (i / 2)) * LD + m0 + mb * 16 +
                            8 * (i % 2) + gq];
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              b[nb][i] = Bj[(k0 + tq + 4 * i) * LD + n0 + nb * 8 + gq];
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
              double d[4] = {acc[2 * mb][nb][0], acc[2 * mb][nb][1],
                             acc[2 * mb + 1][nb][0], acc[2 * mb + 1][nb][1]};
              dmma(d, a[mb], b[nb]);
              acc[2 * mb][nb][0] = d[0];
              acc[2 * mb][nb][1] = d[1];
              acc[2 * mb + 1][nb][0] = d[2];
              acc[2 * mb + 1][nb][1] = d[3];
            }
        }
      } else {
#pragma unroll 4
        for (int r = 0; r < KR; ++r) {
          S a[4];
          S b[4][2];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            a[f] = Ai[r * LD + m0 + f * 8 + gq];
            b[f][0] = Bj[r * LD + n0 + f * 8 + 2 * tq];
            b[f][1] = Bj[r * LD + n0 + f * 8 + 2 * tq + 1];
          }
#pragma unroll
          for (int fi = 0; fi < 4; ++fi)
#pragma unroll
            for (int fj = 0; fj < 4; ++fj) {
              acc[fi][fj][0] = fused(a[fi], b[fj][0], acc[fi][fj][0]);
              acc[fi][fj][1] = fused(a[fi], b[fj][1], acc[fi][fj][1]);
            }
        }
      }
    }
    __syncthreads();  // the stage is free for the chunk after next
  }

  S* out = part_corr + (size_t)slice * Cn * Cn;
  if (!skip) {
#pragma unroll
    for (int fi = 0; fi < 4; ++fi) {
      const int row = ci + m0 + fi * 8 + gq;
      if (row >= Cn) continue;
#pragma unroll
      for (int fj = 0; fj < 4; ++fj) {
        const int col = cj + n0 + fj * 8 + 2 * tq;  // Cn is even
        if (col >= Cn) continue;
        out[(size_t)row * Cn + col] = acc[fi][fj][0];
        out[(size_t)row * Cn + col + 1] = acc[fi][fj][1];
      }
    }
  }
  if (diag) {
    vsum[tid] = vacc;
    __syncthreads();
    if (tid < wi)
      part_v[(size_t)slice * Cn + ci + tid] = vsum[tid] + vsum[tid + TILE];
  }
}

// Sum the slices' partials in slice order: corr's upper triangle, mirrored
// into the lower one, and v.
template <typename S>
__global__ void schur_sum_slices(const S* __restrict__ part_corr,
                                 const S* __restrict__ part_v, int n_slices,
                                 int Cn, S* __restrict__ corr,
                                 S* __restrict__ v) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long nn = (long)Cn * Cn;
  if (idx < nn) {
    const int r = (int)(idx / Cn), c = (int)(idx % Cn);
    if (r > c) return;
    S s = S(0);
    for (int sl = 0; sl < n_slices; ++sl) s += part_corr[sl * nn + idx];
    corr[idx] = s;
    corr[(long)c * Cn + r] = s;
  } else if (idx < nn + Cn) {
    const int c = (int)(idx - nn);
    S s = S(0);
    for (int sl = 0; sl < n_slices; ++sl) s += part_v[(long)sl * Cn + c];
    v[c] = s;
  }
}

template <typename S>
cudaError_t tiles_attr() {
  return cudaFuncSetAttribute(schur_tiles<S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<S>());
}

inline int pairs_of(int Cn) {
  const int t = (Cn + TILE - 1) / TILE;
  return t * (t + 1) / 2;
}

}  // namespace schur

using namespace schur;

// Set up schur_tiles<dtype> on the current device (its dynamic shared
// memory) and return how many of its blocks the device runs in one wave,
// or -cudaError_t. The caller does this once a device and dtype, before
// the first rig_schur_reduce there, and cuts the points into as many
// slices as fill that wave (one block a tile of the upper triangle and a
// slice). dtype: 0 = float32, 1 = float64.
extern "C" int rig_schur_setup(int dtype) {
  if (dtype != 0 && dtype != 1) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = dtype == 1 ? tiles_attr<double>()
                                       : tiles_attr<float>();
  if (e == cudaSuccess)
    e = dtype == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, schur_tiles<double>, THREADS,
                         smem_bytes<double>())
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, schur_tiles<float>, THREADS,
                         smem_bytes<float>());
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return per_sm * sms;
}

// corr (Cn, Cn) and v (Cn) from E (N, 3, Cn), binv (N, 3, 3) and g (N, 3),
// all contiguous, through n_slices partials part_corr (n_slices, Cn, Cn)
// and part_v (n_slices, Cn), on a device rig_schur_setup has set up.
// Returns the cudaError_t of the launches.
extern "C" int rig_schur_reduce(int dtype, const void* E, const void* binv,
                                const void* g, int N, int Cn, int n_slices,
                                void* part_corr, void* part_v, void* corr,
                                void* v, void* stream) {
  if (Cn <= 0 || Cn % 6 != 0 || N < 0 || n_slices < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (Cn + TILE - 1) / TILE, n_pairs = pairs_of(Cn);
  const long per = ((long)N + n_slices - 1) / n_slices;
  const int slice_pts = (int)((per + CP - 1) / CP * CP);
  const long n_out = (long)Cn * Cn + Cn;
  const int sum_blocks = (int)((n_out + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
#define RIG_SCHUR(T)                                                         \
  {                                                                          \
    schur_tiles<T><<<n_pairs * n_slices, THREADS, smem_bytes<T>(), s>>>(     \
        (const T*)E, (const T*)binv, (const T*)g, N, Cn, n_tiles, n_pairs,   \
        slice_pts > 0 ? slice_pts : CP, (T*)part_corr, (T*)part_v);          \
    cudaError_t e = cudaGetLastError();                                      \
    if (e != cudaSuccess) return (int)e;                                     \
    schur_sum_slices<T><<<sum_blocks, 256, 0, s>>>(                          \
        (const T*)part_corr, (const T*)part_v, n_slices, Cn, (T*)corr,       \
        (T*)v);                                                              \
    return (int)cudaGetLastError();                                          \
  }
  if (dtype == 1) RIG_SCHUR(double)
  if (dtype == 0) RIG_SCHUR(float)
#undef RIG_SCHUR
  return (int)cudaErrorInvalidValue;
}
