// Matrix product O = L @ R and fused update O = X - L @ R, for Hopper.
//
// Replaces the TPU kernels raft_tpu/pallas_kernels.py:215-270
// (_mm_kernel / _mm_sub_kernel / _mm_call / _tile, entry points
// mm_pallas and mm_sub_pallas): the dense products of every step of the
// blocked Gauss-Jordan elimination of the BEM solve (gj_stage_pallas
// :498).  At 2N = 5120 and a pivot block of 512 one step computes
// Dinv @ D [512,512]x[512,5120], Dinv @ Db [512,512]x[512,7],
// A - C @ Arow [5120,512]x[512,5120] and b - C @ brow [5120,512]x[512,7].
// mm_sub subtracts in its epilogue, so L @ R never goes to device memory
// (the point of the TPU kernel).
//
// Arithmetic.  Full float32 (float64) fused multiply-adds, summed over k
// in order; no TF32, no tensor cores: the JAX package runs these products
// under "highest" precision and the BEM's 2e-4 bars need full float32.
// The result differs from another library's product by the accumulated
// rounding, at most about K 2^-23 max(|L| @ |R|) in f32.
//
// Design.  A shared-memory tiled SIMT product: a block of 256 threads
// owns a BM x BN output tile (128 x 128 in f32, 64 x 64 in f64) and walks
// K in slices of BK = 16, staging the L slice (transposed, padded against
// bank conflicts) and the R slice in shared memory; each thread keeps a
// TM x TN = (BM/16) x (BN/16) block of accumulators in registers, on rows
// ty + 16 i and columns tx + 16 j, so shared-memory reads broadcast or hit
// consecutive banks and global writes are coalesced.  Ragged edges (the
// 7-column right-hand sides, any M, N, K) are masked in the kernel:
// out-of-range operands load as zero and out-of-range outputs are not
// written.
//
// Bound on this card (H100 SXM: 67 TFLOP/s FP32 outside the tensor cores,
// 67 TFLOP/s FP64 with the FP64 tensor cores, 3.35 TB/s).  The A-update
// at 2N = 5120 does 2.7e10 operations on about 0.23 GB: 0.40 ms, set by
// operations, in either precision; Dinv @ D 2.7e9 operations: 0.040 ms;
// the 7-column products are set by the bytes of their [n, 512] operand (a
// few microseconds).  This SIMT kernel cannot reach the FP64 bound: it
// runs on the FP64 units alone (34 TFLOP/s), as TF32 is ruled out in FP32.  Reaching the FP32 peak
// without tensor cores needs double-buffered (cp.async) tiles and more
// outputs per thread than this first version has; docs/torch_port.md has
// the measured share.
//
// C interface: mm_f64 / mm_f32 / mm_sub_f64 / mm_sub_f32 (row-major,
// contiguous operands) launch on the given stream and return
// cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 16;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T, int BM, int BN, bool SUB>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const T* __restrict__ X, const T* __restrict__ L,
          const T* __restrict__ R, T* __restrict__ O, int M, int N, int K) {
  constexpr int TM = BM / 16, TN = BN / 16;
  static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0,
                "tile loads must divide among the threads");
  __shared__ T As[BK][BM + 1];           // L slice, transposed
  __shared__ T Bs[BK][BN];               // R slice
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long row0 = (long)blockIdx.y * BM, col0 = (long)blockIdx.x * BN;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BM * BK / THREADS; ++q) {
      const int e = threadIdx.x + q * THREADS;
      const int r = e / BK, k = e % BK;
      const long gr = row0 + r;
      const int gk = k0 + k;
      As[k][r] = (gr < M && gk < K) ? L[gr * K + gk] : T(0);
    }
#pragma unroll
    for (int q = 0; q < BK * BN / THREADS; ++q) {
      const int e = threadIdx.x + q * THREADS;
      const int k = e / BN, c = e % BN;
      const int gk = k0 + k;
      const long gc = col0 + c;
      Bs[k][c] = (gk < K && gc < N) ? R[(long)gk * N + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long r = row0 + ty + 16 * i;
    if (r >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long c = col0 + tx + 16 * j;
      if (c < N) {
        const long o = r * N + c;
        if constexpr (SUB) O[o] = sub_rn(X[o], acc[i][j]);
        else O[o] = acc[i][j];
      }
    }
  }
}

template <typename T> struct Tiles;
template <> struct Tiles<float> { static constexpr int BM = 128, BN = 128; };
template <> struct Tiles<double> { static constexpr int BM = 64, BN = 64; };

template <typename T, bool SUB>
int launch(const T* X, const T* L, const T* R, T* O, int M, int N, int K,
           cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  constexpr int BM = Tiles<T>::BM, BN = Tiles<T>::BN;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  mm_kernel<T, BM, BN, SUB><<<grid, THREADS, 0, stream>>>(X, L, R, O, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mm_f64(const double* L, const double* R, double* O, int M,
                      int N, int K, void* stream) {
  return launch<double, false>(nullptr, L, R, O, M, N, K, (cudaStream_t)stream);
}

extern "C" int mm_f32(const float* L, const float* R, float* O, int M, int N,
                      int K, void* stream) {
  return launch<float, false>(nullptr, L, R, O, M, N, K, (cudaStream_t)stream);
}

extern "C" int mm_sub_f64(const double* X, const double* L, const double* R,
                          double* O, int M, int N, int K, void* stream) {
  return launch<double, true>(X, L, R, O, M, N, K, (cudaStream_t)stream);
}

extern "C" int mm_sub_f32(const float* X, const float* L, const float* R,
                          float* O, int M, int N, int K, void* stream) {
  return launch<float, true>(X, L, R, O, M, N, K, (cudaStream_t)stream);
}
