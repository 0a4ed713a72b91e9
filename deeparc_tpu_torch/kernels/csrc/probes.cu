// Measurement probes for Hopper (sm_90a): the elementwise FMA rate and
// the tile sweeps' narrow-output contraction over a deep reduction.
//
// Replaces the two Pallas TPU kernels of the repository's scripts/:
//   _fma_pass (scripts/vpu_roofline.py:46, body _fma_kernel :31)
//   _run      (scripts/microbench_sweep_payload.py:47, bodies _kern_many :30
//              and _kern_one :40)
// The wrappers and plain versions are in kernels/probes.py, the entry points
// in deeparc_tpu_torch/scripts/.
//
// fma_pass. Per element v: eight chains a_c = v * (1 + 0.001 c), then 64
// steps of a_c = fma(a_c, v, v) on every chain, then out = a_0 + ... + a_7
// in that order: 512 FMAs (1024 operations) per 8 (f32) or 16 (f64) bytes
// moved, so the card's FMA rate bounds it, not its memory. One element per
// thread, the eight chains independent in registers (one chain would be
// bound by the FMA's latency), each step an explicit fma() that the
// compiler may neither fold nor reorder (no --use_fast_math).
//
// sweep_payload. Per tile t of 8192 columns, the (128, 18) product
// a[:, tile] . b[:, tile]^T. Each a value is used 18 times and each b value
// 128 times, ~9 operations a byte, under the card's ~20 FP32 operations per
// byte of memory rate: device-memory bytes bound it. One block per tile;
// its 8 warps split the depth, each staging 16-column slices of the 128
// a-rows and 18 b-rows into its own shared memory with 16-byte cp.async
// copies (each 4 lanes read one row's 64 contiguous bytes) and summing its
// (128, 18) partial with FP32 FMAs in column order, 4 rows x 18 columns a
// lane, from float4 reads. No tensor cores (TF32 would change the numbers)
// and no float atomics: the 8 partials are summed in warp order in shared
// memory. mode many (0): warp w takes columns [1024 w, 1024 w + 1024), so
// the result is _kern_many's ((P_0 + P_1) + ...) + P_7 of the eight
// depth-1024 products; mode one (1): warp w takes every 8th slice, one
// depth-8192 product in another fixed order. Every tile's product is
// written (the Pallas probe keeps only the last tile's). Element offsets
// are 64-bit: a holds 1.0e9 values at the scripts' shape.
#include <cuda_runtime.h>

namespace probes {

constexpr int CHAINS = 8;
constexpr int STEPS = 512 / CHAINS;

__device__ __forceinline__ float fused(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename S>
__global__ void __launch_bounds__(256)
    fma_pass(const S* __restrict__ x, long n, S* __restrict__ out) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const S v = x[i];
    S a[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) a[c] = v * S(1.0 + 0.001 * c);
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) a[c] = fused(a[c], v, v);
    }
    S s = a[0];
#pragma unroll
    for (int c = 1; c < CHAINS; ++c) s = s + a[c];
    out[i] = s;
  }
}

constexpr int VL = 128;           // a rows (output rows)
constexpr int P = 18;             // b rows (output columns)
constexpr int DEPTH = 8 * 1024;   // columns of one tile
constexpr int CHUNK = 1024;       // depth of one of mode many's products
constexpr int PW = 8;             // warps per block
constexpr int KS = 16;            // columns of one staged slice
constexpr int LDA = KS + 4;       // staged a row: float4-aligned, and a
                                  // quarter-warp's float4 reads of 8 rows
                                  // fall in 8 distinct bank groups
constexpr int RL = VL / 32;       // a rows per lane
constexpr int SLICES = DEPTH / KS / PW;  // slices per warp

constexpr size_t PAYLOAD_SMEM =
    sizeof(float) * ((size_t)PW * VL * LDA + (size_t)PW * P * KS);
static_assert(sizeof(float) * PW * VL * LDA >= sizeof(float) * PW * VL * P,
              "the partials reuse the staged a slices");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <bool MANY>
__global__ void __launch_bounds__(PW * 32, 2)
    sweep_payload(const float* __restrict__ a, const float* __restrict__ b,
                  long ld, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* as = sm + (size_t)warp * VL * LDA;
  float* bs = sm + (size_t)PW * VL * LDA + (size_t)warp * P * KS;
  const long base = (long)blockIdx.x * DEPTH;
  float acc[RL][P];
#pragma unroll
  for (int i = 0; i < RL; ++i)
#pragma unroll
    for (int c = 0; c < P; ++c) acc[i][c] = 0.f;

  for (int s = 0; s < SLICES; ++s) {
    const int slice = MANY ? warp * (CHUNK / KS) + s : s * PW + warp;
    const long k0 = base + (long)slice * KS;
    __syncwarp();  // every lane is done reading the previous slice
#pragma unroll
    for (int i = 0; i < VL * KS / 4 / 32; ++i) {
      const int r = (lane >> 2) + 8 * i, c4 = (lane & 3) * 4;
      cp_async16(as + r * LDA + c4, a + (long)r * ld + k0 + c4);
    }
    for (int q = lane; q < P * KS / 4; q += 32) {
      const int r = q >> 2, c4 = (q & 3) * 4;
      cp_async16(bs + r * KS + c4, b + (long)r * ld + k0 + c4);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < KS; kk += 4) {
      float4 av[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (lane + 32 * i) * LDA +
                                                 kk);
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + c * KS + kk);
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          acc[i][c] = fmaf(av[i].x, bv.x, acc[i][c]);
          acc[i][c] = fmaf(av[i].y, bv.y, acc[i][c]);
          acc[i][c] = fmaf(av[i].z, bv.z, acc[i][c]);
          acc[i][c] = fmaf(av[i].w, bv.w, acc[i][c]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with its staged slices
  float* red = sm;  // (PW, VL, P) partials
#pragma unroll
  for (int i = 0; i < RL; ++i)
#pragma unroll
    for (int c = 0; c < P; ++c)
      red[((size_t)warp * VL + lane + 32 * i) * P + c] = acc[i][c];
  __syncthreads();
  float* o = out + (long)blockIdx.x * VL * P;
  for (int q = threadIdx.x; q < VL * P; q += blockDim.x) {
    float t = red[q];
    for (int w = 1; w < PW; ++w) t += red[(size_t)w * VL * P + q];
    o[q] = t;
  }
}

}  // namespace probes

using namespace probes;

// dtype 0 = float32, 1 = float64; x and out hold n values.
extern "C" int probe_fma_pass(int dtype, const void* x, long n, void* out,
                              void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long blocks = (n + 255) / 256;
  const int grid = (int)(blocks < (1L << 30) ? blocks : (1L << 30));
  if (dtype == 0)
    fma_pass<float><<<grid, 256, 0, s>>>((const float*)x, n, (float*)out);
  else if (dtype == 1)
    fma_pass<double><<<grid, 256, 0, s>>>((const double*)x, n, (double*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// mode 0 = many, 1 = one; a (128, n_tiles * 8192), b (18, n_tiles * 8192)
// float32, 16-byte aligned; out (n_tiles, 128, 18).
extern "C" int probe_sweep_payload(int mode, const void* a, const void* b,
                                   int n_tiles, void* out, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long ld = (long)n_tiles * DEPTH;
  cudaError_t e = cudaSuccess;
#define PROBE_PAYLOAD(MANY)                                                  \
  {                                                                          \
    e = cudaFuncSetAttribute(sweep_payload<MANY>,                            \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                             (int)PAYLOAD_SMEM);                             \
    if (e != cudaSuccess) return (int)e;                                     \
    sweep_payload<MANY><<<n_tiles, PW * 32, PAYLOAD_SMEM, s>>>(              \
        (const float*)a, (const float*)b, ld, (float*)out);                  \
    return (int)cudaGetLastError();                                          \
  }
  if (mode == 0) PROBE_PAYLOAD(true)
  if (mode == 1) PROBE_PAYLOAD(false)
#undef PROBE_PAYLOAD
  return (int)cudaErrorInvalidValue;
}
