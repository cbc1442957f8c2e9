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
// system (two systems per warp), lane r holds row r in registers, the
// pivot search is a shuffle argmax, and the update is rounded as a
// product then a difference, never a fused multiply-add, so the kernel
// gives the same bits as the plain PyTorch version of the step.  A
// grid-stride loop covers B.
//
// Bound on this card.  At the main path's 1536 systems x 12 x 13 in f64
// one call reads and writes about 4 MB and does about 6 MFLOP: about a
// microsecond of memory time and less of arithmetic.  Measured on an
// H100 80GB HBM3 at 700 W (chip_smoke.py, docs/torch_port.md section 6):
// 0.0568 ms per call, 48x that bound and well above launch latency.  The
// time is latency inside the kernel: 768 warps (under 6 per SM) each
// walk 12 dependent steps of a 4-round shuffle argmax and 13 divisions.
// One launch per solve (not one per step) is all this design does about
// it; the open options are in docs/torch_port.md section 7.
//
// C interface: gj_solve_f64 / gj_solve_f32 launch on the given stream and
// return cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <math.h>

#include "gj_elim.cuh"

namespace {

constexpr int MAXN = 16;
constexpr int MAXM = 32;
constexpr int THREADS = 256;        // 16 systems per block

template <typename T>
__global__ void __launch_bounds__(THREADS)
gj_solve_kernel(const T* __restrict__ in, T* __restrict__ out,
                T* __restrict__ piv_out, int B, int n, int m) {
  const int lane = threadIdx.x & 31;
  const int r = lane & (gj::GROUP - 1);         // row owned by this lane
  const int half = lane >> 4;                   // system within the warp
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;

  // the loop bound is uniform across the warp, so every shuffle below
  // runs with all 32 lanes; lanes past B or n carry zeros and never write
  for (long base = 2L * warp; base < B; base += 2L * nwarps) {
    const long sys = base + half;
    const bool live = sys < B && r < n;
    const T* src = in + sys * n * m + (long)r * m;
    T x[MAXM];
#pragma unroll
    for (int j = 0; j < MAXM; ++j) x[j] = (live && j < m) ? src[j] : T(0);

    gj::eliminate<T, MAXN, MAXM>(x, r, n, m, [&](int i, T apiv) {
      if (r == 0 && sys < B) piv_out[sys * n + i] = apiv;
    });

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
  const int systems_per_block = THREADS / gj::GROUP;
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
