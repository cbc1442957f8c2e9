// Warp-cooperative Gauss-Jordan elimination of one augmented system,
// shared by gj_solve.cu and fused_block.cu (tile_inv.cu takes the
// rounding helpers and the pivot key).
//
// It is the step of the TPU kernels' one-hot elimination
// raft_tpu/pallas_kernels.py:102-125 (_gj_elim_body), which
// gauss_solve_pallas (:150) and _fused_fp_kernel (:275) run.  A group of
// W lanes (GROUP = 16, or the whole warp of 32 for systems wider than 16
// columns) owns one system [n, m] (n <= N rows, m <= W columns); lane j
// holds column j in registers, x[r] = row r of its column.  n steps of
//
//   p    = argmax_{r >= i} |x_r[i]|   (first index wins ties; NaN is the
//                                       largest, as with jnp.argmax)
//   swap rows i and p
//   row  = x_i / x_i[i]
//   x_r -= x_r[i] * row               for r != i,  x_i = row
//
// Column per lane, so that:
//   - the pivot search is lane i's scan of its own column, in registers
//     (no shuffle rounds), then one shuffle sends p to the group;
//   - the row swap is every lane's swap of its own registers i and p, an
//     unrolled compare-and-select since p is a run-time index;
//   - one shuffle brings the pivot from lane i, and each lane divides
//     only its own column's x[i]: one IEEE division per lane and step
//     (a row-per-lane form divides all m columns in every lane);
//   - lane j updates its column with column i's multipliers, n - 1
//     shuffles of compile-time register indices from lane i.
// The update is rounded as two operations, a product and then a
// difference (never a fused multiply-add), and the row is an IEEE
// division, so the result has the bits of the plain PyTorch version of
// the step (raft_tpu_torch/kernels/gj_solve.py _gj_step).  A shape known
// at compile time passes n = N as a literal, and the row guards fold
// away.
//
// What bounds it: the step is a chain of dependent latencies (the scan,
// two shuffles, the division, the multiply-subtract), about a dozen
// per step; the arithmetic is a division and 2 (n - 1) operations per
// lane.  Callers keep enough independent groups in flight per SM to hide
// the chain.
//
// Every shuffle runs with the full warp mask: the caller keeps the call
// warp-uniform (with W = 16 both half-warps call it together, with the
// same n), and lanes past m (or of a system that does not exist) carry
// zeros.

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

// The pivot search's order as an unsigned key: |x| of a candidate row as
// its bit pattern plus one (NaN made the largest), 0 for rows that are
// not candidates.  A larger key wins and the first row wins among equal
// keys: NaN beats every number, a larger value beats a smaller one, and
// among equals (or two NaNs) the lower row wins.
__device__ __forceinline__ unsigned long long pivot_key(double a, bool ok) {
  const unsigned long long b =
      a != a ? 0x7fffffffffffffffull : (unsigned long long)__double_as_longlong(a);
  return ok ? b + 1 : 0;
}

__device__ __forceinline__ unsigned long long pivot_key(float a, bool ok) {
  const unsigned b = a != a ? 0x7fffffffu : __float_as_uint(a);
  return ok ? b + 1ull : 0;
}

// Eliminate the system whose column this lane holds (see the note at the
// top), W lanes to a system.  on_pivot(i, |pivot|) is called by every
// lane at every step i (the value is the same across the group).
template <typename T, int N, int W = GROUP, typename PivotFn>
__device__ __forceinline__ void eliminate(T (&x)[N], int n,
                                          PivotFn on_pivot) {
  static_assert(W == 16 || W == 32, "a group is a half-warp or a warp");
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= n) break;                          // uniform across the warp
    // pivot row: lane i scans column i (every lane scans its own column,
    // and lane i's result is the one taken)
    unsigned long long best = pivot_key(abs_(x[i]), true);
    int p = i;
#pragma unroll
    for (int r = i + 1; r < N; ++r) {
      const unsigned long long k = pivot_key(abs_(x[r]), r < n);
      if (k > best) { best = k; p = r; }
    }
    p = __shfl_sync(full, p, i, W);
    // swap rows i and p of the column held
    const T xi = x[i];
    T xp = xi;
#pragma unroll
    for (int r = i + 1; r < N; ++r) xp = (r == p) ? x[r] : xp;
#pragma unroll
    for (int r = i + 1; r < N; ++r) x[r] = (r == p) ? xi : x[r];
    x[i] = xp;
    const T piv = __shfl_sync(full, x[i], i, W);
    const T row = div_rn(x[i], piv);
    // the multipliers are column i after the swap, held by lane i
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r == i || r >= n) continue;           // uniform across the warp
      const T fac = __shfl_sync(full, x[r], i, W);
      x[r] = sub_rn(x[r], mul_rn(fac, row));
    }
    x[i] = row;
    on_pivot(i, abs_(piv));
  }
}

}  // namespace gj
