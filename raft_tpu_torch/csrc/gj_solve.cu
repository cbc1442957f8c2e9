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
// Design.  The elimination of one system is gj::eliminate in
// gj_elim.cuh (shared with fused_block.cu): a group of 16 lanes owns one
// system (two systems per warp; a whole warp when m > 16), lane j holds
// column j in registers, the pivot search is lane i's scan of its
// own column, each lane divides once per step, and the update is rounded
// as a product then a difference, never a fused multiply-add, so the
// kernel gives the same bits as the plain PyTorch version of the step.
// Lane j loads and stores column j of each row, so lanes 0..m-1 of a
// group touch consecutive addresses.  The main path's shape, n = 12 and
// m = 13, has its own instantiation with both known at compile time;
// other shapes take the generic one (n <= 16, a half-warp per system up
// to 16 columns, a warp up to 32).  CTAs of 64 threads (4 systems), so
// the main path's 1536
// systems make 384 CTAs and put work on every one of the card's 132 SMs;
// a grid-stride loop covers batches beyond the grid's cap.
//
// What bounds it on this card.  At the main path's 1536 systems x 12 x
// 13 in f64 one call reads and writes about 4 MB and does about 6 MFLOP:
// about a microsecond of memory time and less of arithmetic.  Every SM
// holds 5-6 warps of independent systems, so the time is one system's
// chain of 12 dependent steps (the scan, two shuffles, one division, the
// multiply-subtract), the loads and stores, and the launch.  Predicted
// (before the first card run of this design): 0.004-0.012 ms of device
// time in f64, 0.003-0.008 ms in f32, against 0.057 / 0.038-0.050 ms for
// the row-per-lane form it replaces (13 redundant divisions per lane and
// step behind a 4-round shuffle argmax, 96 CTAs on 132 SMs); a call from
// Python then costs about as much host time as the kernel takes.
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W; docs/torch_port.md
// section 6): 0.0073 ms in f64 and 0.0057 ms in f32 of device time,
// against 0.0564 / 0.0376 ms for the row-per-lane form in the same run;
// 60 registers in f64, 32 in f32, no spills (the generic forms 110-116
// in f64, 96-112 in f32, no spills).  Of the f64 time about
// 0.002 ms is the chain of 12 divisions (a build with the division
// replaced by a product takes 0.0055 ms); the rest is the step's other
// latencies and issue (some 250 instructions per warp and step, counted
// from the source).  A call from
// Python costs 0.019-0.044 ms, so the host, not the kernel, now bounds
// each solve of the fixed point.
//
// C interface: gj_solve_f64 / gj_solve_f32 launch on the given stream and
// return cudaGetLastError() (0 = launched); gj_solve_shape reports the
// launch shape (CTAs, threads per CTA) for a batch size and column
// count.

#include <cuda_runtime.h>
#include <math.h>

#include "gj_elim.cuh"

namespace {

constexpr int MAXN = 16;
constexpr int MAXM = 32;
constexpr int THREADS = 64;                     // 4 systems per CTA (2 if m > 16)
constexpr long MAX_CTAS = 1L << 20;             // the grid-stride loop covers the rest

// Systems of n <= N rows and m <= W columns, W lanes to a system; a shape
// fixed at compile time passes its m as M (then n = N, m = M), the
// generic one M = 0.
template <typename T, int N, int W, int M>
__global__ void __launch_bounds__(THREADS)
gj_solve_kernel(const T* __restrict__ in, T* __restrict__ out,
                T* __restrict__ piv_out, int B, int n_arg, int m_arg) {
  constexpr int PER_WARP = 32 / W;              // systems per warp
  const int n = M ? N : n_arg;
  const int m = M ? M : m_arg;
  const int lane = threadIdx.x & 31;
  const int j = lane & (W - 1);                 // column held by this lane
  const int slot = lane / W;                    // system within the warp
  const long warp = ((long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long nwarps = ((long)gridDim.x * THREADS) >> 5;

  // the loop bound is uniform across the warp, so every shuffle below
  // runs with all 32 lanes; lanes past B or m carry zeros and never write
  for (long base = PER_WARP * warp; base < B; base += PER_WARP * nwarps) {
    const long sys = base + slot;
    const bool live = sys < B;
    const T* src = in + sys * n * m;
    T x[N];
#pragma unroll
    for (int r = 0; r < N; ++r)
      x[r] = (live && r < n && j < m) ? src[r * m + j] : T(0);

    gj::eliminate<T, N, W>(x, n, [&](int i, T apiv) {
      if (j == 0 && live) piv_out[sys * n + i] = apiv;
    });

    T* dst = out + sys * n * m;
    if (live && j < m) {
#pragma unroll
      for (int r = 0; r < N; ++r)
        if (r < n) dst[r * m + j] = x[r];
    }
  }
}

// lanes per system for m columns
int group_for(int m) { return m <= gj::GROUP ? gj::GROUP : 32; }

long ctas_for(int B, int m) {
  const int per_cta = THREADS / group_for(m);
  const long ctas = ((long)B + per_cta - 1) / per_cta;
  return ctas < MAX_CTAS ? ctas : MAX_CTAS;
}

template <typename T>
int launch(const T* in, T* out, T* piv, int B, int n, int m,
           cudaStream_t stream) {
  if (B < 0 || n < 1 || n > MAXN || m < n || m > MAXM)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const dim3 grid((unsigned)ctas_for(B, m));
  if (n == 12 && m == 13)                       // the main path's systems
    gj_solve_kernel<T, 12, gj::GROUP, 13><<<grid, THREADS, 0, stream>>>(
        in, out, piv, B, n, m);
  else if (m <= gj::GROUP)
    gj_solve_kernel<T, MAXN, gj::GROUP, 0><<<grid, THREADS, 0, stream>>>(
        in, out, piv, B, n, m);
  else
    gj_solve_kernel<T, MAXN, 32, 0><<<grid, THREADS, 0, stream>>>(
        in, out, piv, B, n, m);
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

extern "C" int gj_solve_shape(int B, int m, int* ctas, int* threads) {
  if (B < 0 || m < 1 || m > MAXM) return (int)cudaErrorInvalidValue;
  *ctas = (int)ctas_for(B, m);
  *threads = THREADS;
  return 0;
}
