// Gauss-Jordan inverse of one pivot tile, with partial pivoting, for Hopper.
//
// Replaces the TPU kernel raft_tpu/pallas_kernels.py:184-212
// (_tile_inv_kernel / _tile_inv_call / tile_inv_pallas), which runs n
// steps of the one-hot elimination _gj_elim_body (:102-125) on the
// augmented tile [A | I] held whole in VMEM and returns its right half.
// This kernel computes exactly that: for i = 0 .. n-1,
//
//   p    = argmax_{r >= i} |M[r, i]|   (first index wins ties; NaN is the
//                                        largest, as with jnp.argmax)
//   swap rows i and p
//   row  = M[i, :] / M[i, i]           (IEEE division)
//   M[r, :] -= M[r, i] * row           for r != i,  M[i, :] = row
//
// with the update rounded as a product and then a difference (never a
// fused multiply-add), so it has the bits of the plain PyTorch version
// (raft_tpu_torch/kernels/bem_gj.py tile_inv_reference, the _gj_step of
// kernels/gj_solve.py on [1, n, 2n]).
//
// Design.  The TPU keeps the whole [n, 2n] tile on chip (2 MB in f32 at
// n = 512); a Hopper block has 227 KB of shared memory, so the tile lives
// in device memory, where at 2-4 MB it stays resident in the 50 MB L2.
// Every block of a step must read column i, the pivot row and row i
// before any block overwrites them.  The ordering comes from the launch
// boundary: one launch per pivot step, reading one buffer and writing the
// other (ping-pong), n launches enqueued by one C call.  Each launch tiles
// [n, 2n] into 64 x 64 blocks of 256 threads (128 blocks at n = 512);
// each block finds the pivot itself (a shuffle argmax over the column,
// the same total order in every block, so every block agrees) and updates
// its tile.  This was chosen over one cooperative launch with a grid-wide
// barrier per step because it needs no co-residency guarantee and no
// grid synchronisation; a launch per step costs a few microseconds, the
// same order as a grid barrier plus the owner block's argmax.
//
// Bound on this card (H100 SXM: 67 TFLOP/s FP32 outside the tensor cores,
// 67 TFLOP/s FP64 with the FP64 tensor cores, 3.35 TB/s).  An inverse
// needs 2 n^3 operations: at n = 512, 2.7e8, so 4.0 us in f32 and in
// f64 (7.9 us on the FP64 units alone, which this kernel uses); the
// elimination as written on [A | I] does twice that.  The bytes (A read, the inverse
// written: 2 MB in f32) take 0.6 us.  So the bound is operations, and
// this design does not approach it: n dependent launches of a few
// microseconds each put it near n x (launch + argmax latency).  It keeps
// the arithmetic off the critical path of the blocked Gauss-Jordan
// (whose matrix products are ~100x larger); docs/torch_port.md has the
// measured time.
//
// C interface: tile_inv_f64 / tile_inv_f32 launch on the given stream and
// return the first launch error (0 = launched).  scratch holds 2 n 2n
// elements.

#include <cuda_runtime.h>
#include <math.h>

#include "gj_elim.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_C = 64;                 // columns per block
constexpr int ROW_LANES = THREADS / TILE_C;  // 4
constexpr int TILE_R = 64;                 // rows per block
constexpr int MAX_N = 1024;

template <typename T>
__global__ void init_kernel(const T* __restrict__ A, long lda,
                            T* __restrict__ M, int n) {
  const long m = 2L * n;
  const long total = (long)n * m;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const long r = e / m, c = e % m;
    M[e] = c < n ? A[r * lda + c] : (c - n == r ? T(1) : T(0));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
step_kernel(const T* __restrict__ in, T* __restrict__ out, int n, int i) {
  const long m = 2L * n;
  __shared__ T s_v[THREADS / 32];
  __shared__ int s_p[THREADS / 32];
  __shared__ int s_pivot;

  // pivot row: argmax of |in[r, i]| over r >= i (the same in every block)
  T v = -INFINITY;
  int p = 0x7fffffff;
  for (int r = i + threadIdx.x; r < n; r += THREADS) {
    const T a = gj::abs_(in[(long)r * m + i]);
    if (gj::beats(a, r, v, p)) { v = a; p = r; }
  }
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T v2 = __shfl_xor_sync(full, v, off);
    const int p2 = __shfl_xor_sync(full, p, off);
    if (gj::beats(v2, p2, v, p)) { v = v2; p = p2; }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) { s_v[warp] = v; s_p[warp] = p; }
  __syncthreads();
  if (threadIdx.x == 0) {
    T bv = s_v[0];
    int bp = s_p[0];
    for (int w = 1; w < THREADS / 32; ++w)
      if (gj::beats(s_v[w], s_p[w], bv, bp)) { bv = s_v[w]; bp = s_p[w]; }
    s_pivot = bp;
  }
  __syncthreads();
  p = s_pivot;

  const T piv = in[(long)p * m + i];
  const T xii = in[(long)i * m + i];
  const int tx = threadIdx.x % TILE_C;
  const int ty = threadIdx.x / TILE_C;
  const long c = (long)blockIdx.x * TILE_C + tx;
  if (c >= m) return;
  const T a = in[(long)p * m + c];           // pivot row
  const T b = in[(long)i * m + c];           // row i
  const T row = gj::div_rn(a, piv);
#pragma unroll 4
  for (int k = 0; k < TILE_R / ROW_LANES; ++k) {
    const int r = blockIdx.y * TILE_R + ty + ROW_LANES * k;
    if (r >= n) break;
    T res;
    if (r == i) {
      res = row;
    } else {
      const T cur = (r == p) ? b : in[(long)r * m + c];
      const T fac = (r == p) ? xii : in[(long)r * m + i];
      res = gj::sub_rn(cur, gj::mul_rn(fac, row));
    }
    out[(long)r * m + c] = res;
  }
}

template <typename T>
__global__ void extract_kernel(const T* __restrict__ M, T* __restrict__ inv,
                               int n) {
  const long total = (long)n * n;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const long r = e / n, c = e % n;
    inv[e] = M[r * 2L * n + n + c];
  }
}

template <typename T>
int launch(const T* A, long lda, T* inv, T* scratch, int n,
           cudaStream_t stream) {
  if (n < 1 || n > MAX_N || lda < n) return (int)cudaErrorInvalidValue;
  T* buf[2] = {scratch, scratch + 2L * n * n};
  const int flat_blocks = (int)((2L * n * n + THREADS - 1) / THREADS);
  init_kernel<T><<<flat_blocks, THREADS, 0, stream>>>(A, lda, buf[0], n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 grid((2 * n + TILE_C - 1) / TILE_C, (n + TILE_R - 1) / TILE_R);
  for (int i = 0; i < n; ++i) {
    step_kernel<T><<<grid, THREADS, 0, stream>>>(buf[i & 1], buf[(i + 1) & 1],
                                                 n, i);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  extract_kernel<T><<<(n * n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      buf[n & 1], inv, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tile_inv_f64(const double* A, long lda, double* inv,
                            double* scratch, int n, void* stream) {
  return launch<double>(A, lda, inv, scratch, n, (cudaStream_t)stream);
}

extern "C" int tile_inv_f32(const float* A, long lda, float* inv,
                            float* scratch, int n, void* stream) {
  return launch<float>(A, lda, inv, scratch, n, (cudaStream_t)stream);
}
