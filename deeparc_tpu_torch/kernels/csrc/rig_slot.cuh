// Per-slot math of the grid engine, shared by the linearize and the cost
// kernels (rig_grid.cu) so both evaluate the SAME residual chain: the LM
// accept test compares the linearize's cost with the trial cost pass, and
// a borderline rho flips if the two come from different evaluators. The
// tile kernels (tile.cu) run the same chain on their own table layout
// (TileCols), as the reference's tile kernel reuses rig_pallas's losses.
//
// CUDA C++ counterpart of `_chain` and `_slot_products` in
// deeparc_tpu/kernels/rig_pallas.py (:136, :177), written per (point, cell)
// slot instead of per (cells x points) plane. The math is the closed form
// of the Snavely residual through the composed extrinsics
// (reference src/snavely_reprojection_error.hh:38-118).
#pragma once

#include <cuda_runtime.h>

namespace rig {

// Slot-table columns: the layout pack_slot_tables (kernels/rig_grid.py)
// writes, one row of SP_COLS values per cell.
constexpr int RI = 0;     // R_inner, row-major 3x3
constexpr int RO = 9;     // R_outer
constexpr int ROI = 18;   // R_outer @ R_inner
constexpr int JRO = 27;   // SO(3) right Jacobian at w_outer
constexpr int JRI = 36;   // SO(3) right Jacobian at w_inner
constexpr int TI = 45;
constexpr int TO = 48;
constexpr int CX = 51;
constexpr int CY = 52;
constexpr int FX = 53;
constexpr int FY = 54;
constexpr int D0 = 55;    // distortion coefficients, pre-masked by order
constexpr int D1 = 56;
constexpr int FSH = 57;   // focal_shared flag
constexpr int M1 = 58;    // distortion-order masks
constexpr int M2 = 59;
constexpr int FRO = 60;   // free_outer (6)
constexpr int FRI = 66;   // free_inner (6)
constexpr int FRK = 72;   // free_intr (6)
constexpr int SP_COLS = 78;

// The grid slot table's columns, as a layout the slot math reads through.
struct GridCols {
  static constexpr int RI = rig::RI, RO = rig::RO, ROI = rig::ROI;
  static constexpr int JRO = rig::JRO, JRI = rig::JRI, TI = rig::TI;
  static constexpr int TO = rig::TO, CX = rig::CX, CY = rig::CY;
  static constexpr int FX = rig::FX, FY = rig::FY, D0 = rig::D0;
  static constexpr int D1 = rig::D1, FSH = rig::FSH, M1 = rig::M1;
  static constexpr int M2 = rig::M2, FRO = rig::FRO, FRI = rig::FRI;
  static constexpr int FRK = rig::FRK;
  // grid pad cells carry z-safe translations: no guard needed
  static constexpr bool ZGUARD = false;
};

// The tile engine's packed cell table (solver/tiles.pack_cells): t_i, t_o
// come before the right Jacobians. A masked slot may carry a pad cell whose
// depth is 0, so its divide uses z = 1 (z = p3z * mask + (1 - mask)).
struct TileCols {
  static constexpr int RI = 0, RO = 9, ROI = 18, TI = 27, TO = 30;
  static constexpr int JRO = 33, JRI = 42, CX = 51, CY = 52, FX = 53;
  static constexpr int FY = 54, D0 = 55, D1 = 56, FSH = 57, M1 = 58;
  static constexpr int M2 = 59, FRO = 60, FRI = 66, FRK = 72;
  static constexpr bool ZGUARD = true;
};

enum Loss { TRIVIAL = 0, HUBER = 1, CAUCHY = 2 };

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }

// Robustified s = ||r||^2 (Ceres' loss definitions).
template <typename S, int LOSS>
__device__ __forceinline__ S loss_rho(S s, S a) {
  if (LOSS == TRIVIAL) return s;
  const S a2 = a * a;
  if (LOSS == HUBER) return s <= a2 ? s : S(2) * a * sqrt_(s > a2 ? s : a2) - a2;
  return a2 * log1p_(s / a2);
}

// w = sqrt(rho'(s)), the factor on residuals and Jacobian rows.
template <typename S, int LOSS>
__device__ __forceinline__ S loss_weight(S s, S a) {
  if (LOSS == TRIVIAL) return S(1);
  const S a2 = a * a;
  if (LOSS == HUBER) return s <= a2 ? S(1) : sqrt_(a / sqrt_(s > a2 ? s : a2));
  return sqrt_(S(1) / (S(1) + s / a2));
}

// Projection chain of one slot: point X through the cell's inner and
// outer extrinsics, perspective divide, radial distortion, masked residual.
template <typename S>
struct Chain {
  S p2[3];
  S inv_z, u0, u1, r2, dcoef, r0, r1;
};

template <typename S, typename L = GridCols>
__device__ __forceinline__ void chain(const S* c, const S X[3], S xy0, S xy1,
                                      S mask, Chain<S>& o) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    o.p2[a] = X[0] * c[L::RI + 3 * a] + X[1] * c[L::RI + 3 * a + 1] +
              X[2] * c[L::RI + 3 * a + 2] + c[L::TI + a];
  S p3[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    p3[a] = o.p2[0] * c[L::RO + 3 * a] + o.p2[1] * c[L::RO + 3 * a + 1] +
            o.p2[2] * c[L::RO + 3 * a + 2] + c[L::TO + a];
  const S z = L::ZGUARD ? p3[2] * mask + (S(1) - mask) : p3[2];
  o.inv_z = S(1) / z;
  o.u0 = p3[0] * o.inv_z;
  o.u1 = p3[1] * o.inv_z;
  o.r2 = o.u0 * o.u0 + o.u1 * o.u1;
  o.dcoef = S(1) + o.r2 * (c[L::D0] + c[L::D1] * o.r2);
  o.r0 = (c[L::FX] * o.dcoef * o.u0 + c[L::CX] - xy0) * mask;
  o.r1 = (c[L::FY] * o.dcoef * o.u1 + c[L::CY] - xy1) * mask;
}

// Robust cost term 0.5 * rho(||r||^2) * mask of one slot.
template <typename S, int LOSS, typename L = GridCols>
__device__ __forceinline__ S slot_cost(const S* c, const S X[3], S xy0, S xy1,
                                       S mask, S scale) {
  Chain<S> ch;
  chain<S, L>(c, X, xy0, xy1, mask, ch);
  const S s = ch.r0 * ch.r0 + ch.r1 * ch.r1;
  return S(0.5) * loss_rho<S, LOSS>(s, scale) * mask;
}

// Residual + derivative chain of one slot. Writes the loss-weighted
// residual (r0, r1), the point-freeze-masked point Jacobian jx[k][b] and the
// camera-freeze-masked camera Jacobian P[k][j]: NP = 18 columns
// [w_outer(3), t_outer(3), w_inner(3), t_inner(3), cx, cy, f0, f1, d0, d1],
// or the 12 extrinsic ones when the intrinsics are frozen. Returns the
// slot's cost term.
template <typename S, int LOSS, int NP, typename L = GridCols>
__device__ __forceinline__ S slot_products(const S* c, const S X[3],
                                           const S pf[3], S xy0, S xy1,
                                           S mask, S scale, S& r0, S& r1,
                                           S jx[2][3], S P[2][NP]) {
  Chain<S> ch;
  chain<S, L>(c, X, xy0, xy1, mask, ch);
  r0 = ch.r0;
  r1 = ch.r1;
  const S s = r0 * r0 + r1 * r1;
  const S cost = S(0.5) * loss_rho<S, LOSS>(s, scale) * mask;
  S wm = mask;
  if (LOSS != TRIVIAL) {
    const S w = loss_weight<S, LOSS>(s, scale);
    wm = mask * w;
    r0 *= w;
    r1 *= w;
  }
  const S u0 = ch.u0, u1 = ch.u1, r2 = ch.r2, dcoef = ch.dcoef;
  // A = d res / d p3 (2x3), masked and weighted
  const S g = c[L::D0] + S(2) * c[L::D1] * r2;
  const S c00 = dcoef + S(2) * g * u0 * u0;
  const S c11 = dcoef + S(2) * g * u1 * u1;
  const S c01 = S(2) * g * u0 * u1;
  const S ccr = dcoef + S(2) * g * r2;
  const S fxz = c[L::FX] * ch.inv_z * wm;
  const S fyz = c[L::FY] * ch.inv_z * wm;
  const S A[2][3] = {{fxz * c00, fxz * c01, -fxz * u0 * ccr},
                     {fyz * c01, fyz * c11, -fyz * u1 * ccr}};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    S jxk[3], Bk[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      jxk[b] = A[k][0] * c[L::ROI + b] + A[k][1] * c[L::ROI + 3 + b] +
               A[k][2] * c[L::ROI + 6 + b];
      Bk[b] = A[k][0] * c[L::RO + b] + A[k][1] * c[L::RO + 3 + b] +
              A[k][2] * c[L::RO + 6 + b];
    }
    // d p3 / d w_outer = -R_o [p2]x Jr_o, d p3 / d w_inner = -R_oi [X]x Jr_i:
    // row vectors M_k [v]_x = (M_k x v)
    const S Cw[3] = {Bk[1] * ch.p2[2] - Bk[2] * ch.p2[1],
                     Bk[2] * ch.p2[0] - Bk[0] * ch.p2[2],
                     Bk[0] * ch.p2[1] - Bk[1] * ch.p2[0]};
    const S Dw[3] = {jxk[1] * X[2] - jxk[2] * X[1],
                     jxk[2] * X[0] - jxk[0] * X[2],
                     jxk[0] * X[1] - jxk[1] * X[0]};
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const S jwo = -(Cw[0] * c[L::JRO + b] + Cw[1] * c[L::JRO + 3 + b] +
                      Cw[2] * c[L::JRO + 6 + b]);
      const S jwi = -(Dw[0] * c[L::JRI + b] + Dw[1] * c[L::JRI + 3 + b] +
                      Dw[2] * c[L::JRI + 6 + b]);
      P[k][b] = jwo * c[L::FRO + b];
      P[k][3 + b] = A[k][b] * c[L::FRO + 3 + b];
      P[k][6 + b] = jwi * c[L::FRI + b];
      P[k][9 + b] = Bk[b] * c[L::FRI + 3 + b];
      jx[k][b] = jxk[b] * pf[b];
    }
  }
  if (NP == 18) {
    // intrinsic columns [cx, cy, f0, f1, d0, d1]
    const S du0 = dcoef * u0, du1 = dcoef * u1, sh = c[L::FSH];
    P[0][NP - 6] = wm * c[L::FRK + 0];
    P[0][NP - 5] = S(0);
    P[0][NP - 4] = du0 * wm * c[L::FRK + 2];
    P[0][NP - 3] = S(0);
    P[0][NP - 2] = c[L::FX] * u0 * r2 * c[L::M1] * wm * c[L::FRK + 4];
    P[0][NP - 1] = c[L::FX] * u0 * r2 * r2 * c[L::M2] * wm * c[L::FRK + 5];
    P[1][NP - 6] = S(0);
    P[1][NP - 5] = wm * c[L::FRK + 1];
    P[1][NP - 4] = sh * du1 * wm * c[L::FRK + 2];
    P[1][NP - 3] = (S(1) - sh) * du1 * wm * c[L::FRK + 3];
    P[1][NP - 2] = c[L::FY] * u1 * r2 * c[L::M1] * wm * c[L::FRK + 4];
    P[1][NP - 1] = c[L::FY] * u1 * r2 * r2 * c[L::M2] * wm * c[L::FRK + 5];
  }
  return cost;
}

template <typename S>
__device__ __forceinline__ S warp_sum(S x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A fixed-order sum of n per-block partials, launched as one warp: lane l
// sums partials l, l + 32, ... in order, then a warp sum.
template <typename S>
__global__ void reduce_cost_lanes(const S* __restrict__ partial, int n,
                                  S* __restrict__ out) {
  S s = S(0);
  for (int i = threadIdx.x; i < n; i += 32) s += partial[i];
  s = warp_sum(s);
  if (threadIdx.x == 0) out[0] = s;
}

}  // namespace rig
