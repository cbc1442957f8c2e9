// Batched Gauss-Jordan elimination with partial pivoting, for Hopper.
//
// Replaces the TPU kernel raft_tpu/pallas_kernels.py:128-179
// (_gj_solve_kernel / _gj_solve_call / gauss_solve_pallas, built on the
// one-hot step _gj_elim_body at :102-125).  Same function as the
// reference step raft_tpu/dynamics.py _gj_step: for each system of
// M [B, n, m], n steps of
//
//   p    = argmax_{r >= i} |M[r, i]|   (first index wins ties; NaN is the
//                                        largest, as with jnp.argmax)
//   swap rows i and p
//   row  = M[i, :] / M[i, i]
//   M[r, :] -= M[r, i] * row           for r != i,  M[i, :] = row
//
// and it also returns |pivot| of every step, [B, n], which the condition
// estimate and the recovery ladder read.
//
// Design.  A group of 16 lanes owns one system (two systems per warp);
// lane r holds row r in registers.  The pivot search is an argmax across
// the group by __shfl_xor_sync; the row swap and the pivot-row broadcast
// are __shfl_sync reads of the pivot and target lanes.  No shared memory.
// Every loop is unrolled to the compile-time bounds MAXN x MAXM, so each
// row element stays in a register; runtime n and m only guard the steps.
// A grid-stride loop covers B.  The update is rounded as two operations,
// a product and then a difference (__dmul_rn/__dsub_rn, never a fused
// multiply-add), and the row is an IEEE division, so the kernel gives the
// same bits as the plain PyTorch version of the step.
//
// Bound on this card.  At the main path's 1536 systems x 12 x 13 in f64
// one call reads and writes about 4 MB and does about 6 MFLOP: about a
// microsecond of memory time and less of arithmetic.  Launch latency
// dominates; one launch per solve (not one per step) is what the design
// does about it.
//
// C interface: gj_solve_f64 / gj_solve_f32 launch on the given stream and
// return cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXN = 16;
constexpr int MAXM = 32;
constexpr int GROUP = 16;           // lanes per system
constexpr int THREADS = 256;        // 16 systems per block

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
gj_solve_kernel(const T* __restrict__ in, T* __restrict__ out,
                T* __restrict__ piv_out, int B, int n, int m) {
  const int lane = threadIdx.x & 31;
  const int r = lane & (GROUP - 1);             // row owned by this lane
  const int half = lane >> 4;                   // system within the warp
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const unsigned full = 0xffffffffu;
  const T ninf = -INFINITY;

  // the loop bound is uniform across the warp, so every shuffle below
  // runs with all 32 lanes; lanes past B or n carry zeros and never write
  for (long base = 2L * warp; base < B; base += 2L * nwarps) {
    const long sys = base + half;
    const bool live = sys < B && r < n;
    const T* src = in + sys * n * m + (long)r * m;
    T x[MAXM];
#pragma unroll
    for (int j = 0; j < MAXM; ++j) x[j] = (live && j < m) ? src[j] : T(0);

#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i >= n) break;                        // uniform across the warp
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
        if (j < m) {                            // uniform across the warp
          const T a = __shfl_sync(full, x[j], p, GROUP);   // pivot row
          const T b = __shfl_sync(full, x[j], i, GROUP);   // row i
          const T cur = (r == i) ? a : ((r == p) ? b : x[j]);
          const T row = div_rn(a, piv);
          x[j] = (r == i) ? row : sub_rn(cur, mul_rn(fac, row));
        }
      }
      if (r == 0 && sys < B) piv_out[sys * n + i] = abs_(piv);
    }

    T* dst = out + sys * n * m + (long)r * m;
    if (live) {
#pragma unroll
      for (int j = 0; j < MAXM; ++j)
        if (j < m) dst[j] = x[j];
    }
  }
}

template <typename T>
int launch(const T* in, T* out, T* piv, int B, int n, int m,
           cudaStream_t stream) {
  if (B < 0 || n < 1 || n > MAXN || m < n || m > MAXM)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int systems_per_block = THREADS / GROUP;
  long blocks = (B + systems_per_block - 1) / systems_per_block;
  if (blocks > 65535) blocks = 65535;           // the grid-stride loop covers the rest
  gj_solve_kernel<T><<<(int)blocks, THREADS, 0, stream>>>(in, out, piv, B, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gj_solve_f64(const double* in, double* out, double* piv,
                            int B, int n, int m, void* stream) {
  return launch<double>(in, out, piv, B, n, m, (cudaStream_t)stream);
}

extern "C" int gj_solve_f32(const float* in, float* out, float* piv,
                            int B, int n, int m, void* stream) {
  return launch<float>(in, out, piv, B, n, m, (cudaStream_t)stream);
}
