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
// (raft_tpu_torch/kernels/bem_gj.py tile_inv_reference).
//
// In place.  The tile is held as one n x n array.  Column g of the left
// half is spent once step g's multipliers are known, so its storage then
// holds the column of the right half that step g first touches: before
// step g that column is the unit vector on row g (after the swap), so
// step g writes 1 / piv (one division, as the plain version divides 1 by
// the pivot) on row g and 0 - fac[r] * (1 / piv) elsewhere.  The right
// half's other untouched columns are zero on row g and stay unchanged
// (x - fac * 0 = x), so they need no storage.  Column c ends as column
// s_0(s_1(...s_{n-1}(c))) of the inverse, s_l the swap of step l: a
// column unpermute on the way out.  For finite input these are the plain
// version's IEEE operations on the same values, so the bits agree
// (tests/test_torch_bem_hopper.py rehearses this order in PyTorch).
//
// One launch, one thread-block cluster (its CTAs are co-scheduled, which
// the flags below rely on).  The tile (1 MB in f32, 2 MB in f64 at
// n = 512) is split into panels of W = 4 columns dealt to the CTAs in
// turn; each CTA holds its 64 (f32) or 32 (f64) columns in registers,
// each of 512 threads S rows of one column (128 KB per CTA, so 8 CTAs in
// f32 and 16 in f64, a non-portable cluster size).  The steps go panel by
// panel:
//
//   the owner of panel k factors it: on a copy of its W columns in shared
//   memory (a thread per row) it finds each step's pivot (a CTA argmax on
//   gj::pivot_key's keys, by __reduce_max_sync) and multipliers,
//   applies the step to the panel's later columns, writes pivots and
//   multipliers to device memory (L2) and sets the panel's flag;
//   every CTA waits for the flag, loads the panel into shared memory and
//   applies its W steps to its columns in registers: the threads holding
//   rows g and p publish them, every thread forms row = W[p][c] / piv,
//   and updates its S elements;
//   lookahead: the owner of panel k + 1 first brings a shared-memory copy
//   of its columns through panel k's steps (a thread per row), factors and
//   publishes it, and only then updates its registers, so the chain of
//   dependent panels runs ahead of the updates.
//
// Panels of 4 ran faster on the card than panels of 2, 8 or 16 (a shorter
// chain per panel against fewer publishes).  An earlier form kept the
// tile in the cluster's shared memory and broadcast each step's
// multipliers through distributed shared memory with a cluster barrier
// per step; the barrier and, in f64, the SM-to-SM broadcast of n values
// to 16 CTAs made it slower than torch.linalg.inv (docs/torch_port.md).
//
// Bound on this card (H100 SXM: 495 TFLOP/s TF32 tensor cores, three
// passes of which make a full-f32-accurate product; 67 TFLOP/s FP64 with
// the FP64 tensor cores; 3.35 TB/s).  An inverse needs 2 n^3 operations,
// 2.7e8 at n = 512, so 1.6 us in f32 and 4.0 us in f64; the bytes (A read,
// the inverse written: 2 MB in f32) take 0.6 us.  This kernel does n
// dependent steps, each a CTA-wide exchange of two rows, a division and
// an update, behind a chain of panel factorizations: under 2 us a step.
//
// C interface: tile_inv_f64 / tile_inv_f32 launch on the given stream and
// return the launch error (0 = launched); fac ([n, n]) and ints (2 * 512
// ints) are scratch for the published panels.  tile_inv_shape reports the
// cluster size and the dynamic shared memory per CTA for a tile size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gj_elim.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int MAX_N = 512;                 // one row per thread in the argmax
constexpr int WARPS = THREADS / 32;
constexpr int W = 4;                       // panel width: steps per publish
constexpr int PW = W + 1;                  // panel row stride (no bank conflicts)

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

// columns per CTA: 64 in f32, 32 in f64 (a 128 KB slab at n = 512); the
// slab's rows are split into THREADS / S groups of S rows, so each thread
// holds S elements of one column in registers
template <typename T> __host__ __device__ constexpr int slab() {
  return 256 / (int)sizeof(T);
}

// dynamic shared memory layout, in bytes from the start
template <typename T>
struct Layout {
  static constexpr int S = slab<T>();
  __host__ __device__ static constexpr size_t pan() { return 0; }                           // [MAX_N][PW] T
  __host__ __device__ static constexpr size_t fac() { return pan() + MAX_N * PW * sizeof(T); }  // [W][MAX_N] T
  __host__ __device__ static constexpr size_t rows() { return fac() + W * MAX_N * sizeof(T); } // [2][2][S] T
  __host__ __device__ static constexpr size_t rvs() { return rows() + 4 * S * sizeof(T); }     // [2][2][W] T
  __host__ __device__ static constexpr size_t wk() { return rvs() + 4 * W * sizeof(T); }       // [WARPS] u64
  __host__ __device__ static constexpr size_t prow() { return wk() + WARPS * 8; }              // [MAX_N] int
  __host__ __device__ static constexpr size_t wp() { return prow() + MAX_N * sizeof(int); }    // [WARPS] int
  __host__ __device__ static constexpr size_t dest() { return wp() + WARPS * sizeof(int); }    // [S] int
  __host__ __device__ static constexpr size_t bytes() { return dest() + S * sizeof(int); }
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// the first lane holding the warp's largest key
__device__ __forceinline__ int first_max_lane(unsigned long long key) {
  const unsigned full = 0xffffffffu;
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_max_sync(full, hi);
  const unsigned ml = __reduce_max_sync(full, hi == mh ? lo : 0u);
  return __ffs(__ballot_sync(full, hi == mh && lo == ml)) - 1;
}

// argmax over the CTA of thread r's key for row r; every thread gets the
// row.  wk / wp hold each warp's best key and row.
__device__ __forceinline__ int argmax_block(unsigned long long key,
                                            unsigned long long* wk, int* wp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == first_max_lane(key)) { wk[warp] = key; wp[warp] = threadIdx.x; }
  __syncthreads();
  return wp[first_max_lane(lane < WARPS ? wk[lane] : 0ull)];
}

// x[k] of a register array at a run-time k (a select tree on the bits of
// k), and x[k] = v; both unrolled, so x stays in registers
template <typename T, int R>
__device__ __forceinline__ T pick(const T (&x)[R], int k) {
  T y[R];
#pragma unroll
  for (int j = 0; j < R; ++j) y[j] = x[j];
#pragma unroll
  for (int h = 1; h < R; h <<= 1) {
    const bool bit = (k & h) != 0;
#pragma unroll
    for (int j = 0; j + h < R; j += 2 * h) y[j] = bit ? y[j + h] : y[j];
  }
  return y[0];
}

template <typename T, int R>
__device__ __forceinline__ void put(T (&x)[R], int k, T v) {
#pragma unroll
  for (int j = 0; j < R; ++j) if (j == k) x[j] = v;
}

// Step g on one column of rows r0 .. r0 + R: x[r] - fac[r] * row for
// every row, then row p = (old row g) - fac[p] * row, then row g = row.
template <typename T, int R>
__device__ __forceinline__ void update(T (&x)[R], const T* f, int r0, T rv,
                                       T ro, T fp, int g, int p) {
  using V = typename Vec<T>::type;
  constexpr int VN = Vec<T>::n;
#pragma unroll
  for (int j = 0; j < R; j += VN) {
    const V fv = *reinterpret_cast<const V*>(f + r0 + j);
    const T* fs = reinterpret_cast<const T*>(&fv);
#pragma unroll
    for (int k = 0; k < VN; ++k)
      x[j + k] = gj::sub_rn(x[j + k], gj::mul_rn(fs[k], rv));
  }
  if ((unsigned)(p - r0) < (unsigned)R)
    put(x, p - r0, gj::sub_rn(ro, gj::mul_rn(fp, rv)));
  if ((unsigned)(g - r0) < (unsigned)R) put(x, g - r0, rv);
}

// One step (pivot row g, pivot p, multiplier f of row r) on the columns
// c0 .. w of the panel pan [MAX_N][PW], in shared memory; thread r holds
// row r.  rv / ro get row p / piv and the old row g first.
template <typename T>
__device__ __forceinline__ void pan_step(T* pan, T* rv, T* ro, T f, T piv,
                                         int g, int p, int c0, int w, int n) {
  const int r = threadIdx.x;
  if (r >= c0 && r < w) {
    rv[r] = gj::div_rn(pan[p * PW + r], piv);
    ro[r] = pan[g * PW + r];
  }
  __syncthreads();
  if (r < n) {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < c0 || c >= w) continue;
      T y;
      if (r == g) y = rv[c];
      else if (r == p) y = gj::sub_rn(ro[c], gj::mul_rn(f, rv[c]));
      else y = gj::sub_rn(pan[r * PW + c], gj::mul_rn(f, rv[c]));
      pan[r * PW + c] = y;
    }
  }
}

// The pivot steps g0 .. g0 + w of the panel pan (its columns updated
// through step g0 - 1): for each, the pivot row and the column with rows
// g and p swapped (the multipliers) go to facg / pg in device memory, and
// the step is applied to the panel's later columns.
template <typename T>
__device__ void factor_panel(T* pan, T* rvs, unsigned long long* wk, int* wp,
                             T* facg, int* pg, int g0, int w, int n) {
  const int r = threadIdx.x;
  for (int j = 0; j < w; ++j) {
    const int g = g0 + j;
    const int p = argmax_block(
        gj::pivot_key(gj::abs_(pan[r * PW + j]), r >= g && r < n), wk, wp);
    const T f = r < n ? pan[(r == g ? p : (r == p ? g : r)) * PW + j] : T(0);
    if (r < n) facg[(long)g * n + r] = f;
    if (r == 0) pg[g] = p;
    T* rv = rvs + (j & 1) * 2 * W;
    pan_step(pan, rv, rv + W, f, pan[p * PW + j], g, p, j + 1, w, n);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
tile_inv_kernel(const T* __restrict__ A, long lda, T* __restrict__ inv,
                T* __restrict__ facg, int* __restrict__ ints, int n) {
  constexpr int S = slab<T>();
  constexpr int R = S;                     // rows per thread: THREADS / S groups
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* pan = reinterpret_cast<T*>(smem + L::pan());
  T* fac = reinterpret_cast<T*>(smem + L::fac());
  T* rows = reinterpret_cast<T*>(smem + L::rows());
  T* rvs = reinterpret_cast<T*>(smem + L::rvs());
  auto* wk = reinterpret_cast<unsigned long long*>(smem + L::wk());
  int* prow = reinterpret_cast<int*>(smem + L::prow());
  int* wp = reinterpret_cast<int*>(smem + L::wp());
  int* dest = reinterpret_cast<int*>(smem + L::dest());
  int* pg = ints;                          // [n] pivot rows
  int* flag = ints + MAX_N;                // [n / W] panels published

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncta = (int)cluster.num_blocks();
  const int t = threadIdx.x;
  const int c = t % S;                     // this thread's column of the slab
  const int r0 = (t / S) * R;              // and its first row
  const int npan = (n + W - 1) / W;
  // panels are dealt to the CTAs in turn: local column c is global column
  // gc of panel (c / W) * ncta + rank
  const int gc = ((c / W) * ncta + rank) * W + c % W;

  // the slab, in registers, zero padded
  T x[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    x[k] = (gc < n && r0 + k < n) ? A[(long)(r0 + k) * lda + gc] : T(0);
  for (int e = t; e < W * MAX_N; e += THREADS) fac[e] = T(0);
  if (rank == 0)
    for (int e = t; e < npan; e += THREADS) flag[e] = 0;
  cluster.sync();                    // the flags cleared before any is set

  // copy this CTA's panel at local columns lc .. lc + W into pan
  auto to_pan = [&](int lc) {
    if (c >= lc && c < lc + W) {
#pragma unroll
      for (int q = 0; q < R; ++q) pan[(r0 + q) * PW + c - lc] = x[q];
    }
    __syncthreads();
  };
  auto factor = [&](int k) {
    factor_panel(pan, rvs, wk, wp, facg, pg, k * W, min(W, n - k * W), n);
    __threadfence();                 // every thread's stores, then the flag
    __syncthreads();
    if (t == 0) store_release(flag + k, 1);
  };

  if (rank == 0) {
    to_pan(0);
    factor(0);
  }
  int step = 0;
  for (int k = 0; k < npan; ++k) {
    const int g0 = k * W, w = min(W, n - g0);
    if (k % ncta != rank && t == 0)
      while (load_acquire(flag + k) == 0) {}
    __syncthreads();
    for (int e = t; e < w * n; e += THREADS)
      fac[(e / n) * MAX_N + e % n] = __ldcg(facg + (long)g0 * n + e);
    if (t < w) prow[g0 + t] = __ldcg(pg + g0 + t);
    __syncthreads();
    // lookahead: the owner of panel k + 1 brings a copy of its columns
    // through panel k in shared memory (a thread per row), factors and
    // publishes it; then every CTA applies panel k to its slab
    const int k1 = k + 1;
    if (k1 < npan && k1 % ncta == rank) {
      to_pan((k1 / ncta) * W);
      for (int j = 0; j < w; ++j) {
        const int g = g0 + j;
        T* rv = rvs + (j & 1) * 2 * W;
        pan_step(pan, rv, rv + W, fac[j * MAX_N + t], fac[j * MAX_N + g], g,
                 prow[g], 0, W, n);
        __syncthreads();
      }
      factor(k1);
    }
    for (int j = 0; j < w; ++j, ++step) {
      const int g = g0 + j;
      const T* f = fac + j * MAX_N;
      const int p = prow[g];
      const T piv = f[g];
      T* rowi = rows + (step & 1) * 2 * S;
      T* rowp = rowi + S;
      // column g becomes the unit column of the right half it first
      // touches: 0, with 1 on row g
      if (gc == g) {
#pragma unroll
        for (int q = 0; q < R; ++q) x[q] = T(0);
      }
      if ((unsigned)(g - r0) < (unsigned)R) rowi[c] = pick(x, g - r0);
      if ((unsigned)(p - r0) < (unsigned)R) rowp[c] = pick(x, p - r0);
      __syncthreads();
      const T rv = gc == g ? gj::div_rn(T(1), piv) : gj::div_rn(rowp[c], piv);
      update(x, f, r0, rv, rowi[c], f[p], g, p);
    }
  }

  // column unpermute: global column gc of the slab is the inverse's
  // column s_0(s_1(... s_{n-1}(gc)))
  if (t < S) {
    int y = gc;
    for (int l = n - 1; l >= 0; --l) {
      const int pl = prow[l];
      y = y == l ? pl : (y == pl ? l : y);
    }
    dest[t] = y;
  }
  __syncthreads();
  if (gc < n) {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (r0 + k < n) inv[(long)(r0 + k) * n + dest[c]] = x[k];
  }
}

template <typename T>
int shape(int n, int* cluster, int* smem) {
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const int npan = (n + W - 1) / W;
  *cluster = (npan + slab<T>() / W - 1) / (slab<T>() / W);
  *smem = (int)Layout<T>::bytes();
  return 0;
}

template <typename T>
int launch(const T* A, long lda, T* inv, T* facg, int* ints, int n,
           cudaStream_t stream) {
  int ncta, smem;
  int rc = shape<T>(n, &ncta, &smem);
  if (rc || lda < n) return rc ? rc : (int)cudaErrorInvalidValue;
  auto kernel = tile_inv_kernel<T>;
  rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc) return rc;
  if (ncta > 8) {
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ncta);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, A, lda, inv, facg, ints, n);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tile_inv_f64(const double* A, long lda, double* inv,
                            double* fac, int* ints, int n, void* stream) {
  return launch<double>(A, lda, inv, fac, ints, n, (cudaStream_t)stream);
}

extern "C" int tile_inv_f32(const float* A, long lda, float* inv, float* fac,
                            int* ints, int n, void* stream) {
  return launch<float>(A, lda, inv, fac, ints, n, (cudaStream_t)stream);
}

extern "C" int tile_inv_shape(int n, int f64, int* cluster, int* smem) {
  return f64 ? shape<double>(n, cluster, smem) : shape<float>(n, cluster, smem);
}
