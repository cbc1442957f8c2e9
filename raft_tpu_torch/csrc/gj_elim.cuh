// Warp-cooperative Gauss-Jordan elimination of one augmented system,
// shared by gj_solve.cu and fused_block.cu.
//
// A group of GJ_GROUP = 16 lanes owns one system [n, m]; lane r holds
// row r in registers (x[0..m)).  n steps of
//
//   p    = argmax_{r >= i} |x_r[i]|   (first index wins ties; NaN is the
//                                       largest, as with jnp.argmax)
//   swap rows i and p
//   row  = x_i / x_i[i]
//   x_r -= x_r[i] * row               for r != i,  x_i = row
//
// The pivot search is an argmax across the group by __shfl_xor_sync; the
// row swap and the pivot-row broadcast are __shfl_sync reads of the pivot
// and target lanes.  Every loop is unrolled to the compile-time bounds
// MAXN x MAXM, so each row element stays in a register; runtime n and m
// only guard the steps.  The update is rounded as two operations, a
// product and then a difference (never a fused multiply-add), and the
// row is an IEEE division, so the result has the bits of the plain
// PyTorch version of the step (raft_tpu_torch/kernels/gj_solve.py
// _gj_step).
//
// Every shuffle runs with the full warp mask: the caller keeps the call
// warp-uniform (both half-warps call it together), and lanes past n (or
// of a system that does not exist) carry zeros.

#pragma once

#include <math.h>

namespace gj {

constexpr int GROUP = 16;           // lanes per system

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }

// (v, r) beats (w, s): NaN beats every number, a larger value beats a
// smaller one, and among equals (or two NaNs) the lower row wins.
template <typename T>
__device__ __forceinline__ bool beats(T v, int r, T w, int s) {
  const bool vn = v != v, wn = w != w;      // NaN tests
  if (vn || wn) return vn && (!wn || r < s);
  return v > w || (v == w && r < s);
}

// Eliminate the system whose row r this lane holds in x.  on_pivot(i,
// |pivot|) is called by every lane at every step i (the value is the same
// across the group).
template <typename T, int MAXN, int MAXM, typename PivotFn>
__device__ __forceinline__ void eliminate(T (&x)[MAXM], int r, int n, int m,
                                          PivotFn on_pivot) {
  const unsigned full = 0xffffffffu;
  const T ninf = -INFINITY;
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    if (i >= n) break;                          // uniform across the warp
    // pivot row: argmax of |x[i]| over rows r >= i of the group
    T v = (r >= i && r < n) ? abs_(x[i]) : ninf;
    int p = r;
#pragma unroll
    for (int off = GROUP / 2; off > 0; off >>= 1) {
      const T v2 = __shfl_xor_sync(full, v, off, GROUP);
      const int p2 = __shfl_xor_sync(full, p, off, GROUP);
      if (beats(v2, p2, v, p)) { v = v2; p = p2; }
    }
    const T piv = __shfl_sync(full, x[i], p, GROUP);
    const T xii = __shfl_sync(full, x[i], i, GROUP);
    // column i of this lane's row after the swap
    const T fac = (r == i) ? piv : ((r == p) ? xii : x[i]);
#pragma unroll
    for (int j = 0; j < MAXM; ++j) {
      if (j < m) {                              // uniform across the warp
        const T a = __shfl_sync(full, x[j], p, GROUP);   // pivot row
        const T b = __shfl_sync(full, x[j], i, GROUP);   // row i
        const T cur = (r == i) ? a : ((r == p) ? b : x[j]);
        const T row = div_rn(a, piv);
        x[j] = (r == i) ? row : sub_rn(cur, mul_rn(fac, row));
      }
    }
    on_pivot(i, abs_(piv));
  }
}

}  // namespace gj
