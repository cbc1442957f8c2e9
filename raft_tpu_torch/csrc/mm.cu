// Matrix product O = L @ R and fused update O = X - L @ R, for Hopper.
//
// Replaces the TPU kernels raft_tpu/pallas_kernels.py:215-270
// (_mm_kernel / _mm_sub_kernel / _mm_call / _tile, entry points
// mm_pallas and mm_sub_pallas): the dense products of every step of the
// blocked Gauss-Jordan elimination of the BEM solve (gj_stage_pallas
// :498).  The port holds [A | b] as one buffer (kernels/bem_gj.py
// gj_stage), so at 2N = 5120 and a pivot block of 512 one step computes
// Dinv @ [D | Db] [512,512]x[512,5128] and [A | b] - C @ [Arow | brow]
// [5120,512]x[512,5128].  mm_sub subtracts in its epilogue, so L @ R never
// goes to device memory (the point of the TPU kernel).
//
// Arithmetic.  The JAX package runs these products at "highest"
// precision, full float32 accuracy built from several low-precision
// passes on the TPU's matrix unit.  Here the same on the tensor cores:
// float32 operands are split in registers into a TF32 high part and a
// low part, a_hi = a with its low 13 mantissa bits cleared and a_lo =
// a - a_hi (exact; the tensor cores read its top 10 mantissa bits), and
// three mma.sync.m16n8k8 TF32 passes, a_lo b_hi + a_hi b_lo + a_hi b_hi,
// are accumulated in float32: each product is exact to about 2^-20 of
// |a b| (the dropped a_lo b_lo term and the low parts' truncation).  float64 runs on the FP64 tensor cores, mma.sync.m16n8k8
// .f64 (DMMA), in full precision.  Each output element sums over k in the
// same order whatever N is, so folding columns into a wider product does
// not change them.  Against another library's product the gap is the
// accumulated rounding, within K eps max(|L| @ |R|).
//
// Design.  A block of 256 threads (8 warps) owns a BM x BN output tile
// (128 x 128, or 64 x 128 with two blocks per SM when the product has
// fewer than two waves of large tiles) and walks K in slices of BK
// through a ring of shared-memory tiles fed by cp.async (5 stages of 16
// in the large f32 tile, 3 of 32 or 16 elsewhere), so later slices load
// while one is multiplied.  Each warp computes a 32 x 64, 64 x 32 or
// 32 x 32 sub-tile with register fragments read from padded rows (no bank
// conflicts); the shapes and depths are the fastest of those tried on the
// card.  Ragged M, N, K
// are masked by cp.async's zero fill (out-of-range operands load as zero)
// and by the epilogue's bounds; 16-byte copies need rows that are 16-byte
// multiples (gj_stage pads [A | b] so), other shapes load element by
// element.
//
// Bound on this card (H100 SXM: 495 TFLOP/s TF32 dense on the tensor
// cores, so 165 TFLOP/s for the three passes of a full-f32-accurate
// product; 67 TFLOP/s FP64 with the FP64 tensor cores; 3.35 TB/s).  The
// A-update does 2.69e10 operations on about 0.23 GB: 0.163 ms in f32 and
// 0.401 ms in f64, set by operations; Dinv @ [D | Db] 2.69e9 operations:
// 0.0163 ms in f32.  This kernel reaches about a third of that rate
// (docs/torch_port.md): mma.sync issued by two warps per scheduler, not
// wgmma, which is the full-rate path.
//
// C interface: mm_f64 / mm_f32 / mm_sub_f64 / mm_sub_f32 (row-major,
// contiguous operands) launch on the given stream and return the launch
// error (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// BM x BN block tile, BK slice, WM x WN warp tile, row padding of the
// shared L (PA) and R (PB) tiles in elements (conflict-free fragment
// reads), stages of the ring, blocks per SM.  The large tile for products
// that fill the card several times over (the A-update: 1640 tiles); the
// small one, two blocks per SM, for those that fill it about once
// (Dinv @ [D | Db]: 164 large tiles on 132 SMs would leave most of the
// second wave idle).
template <typename T, bool SMALL> struct Tiles;
template <> struct Tiles<float, false> {
  static constexpr int BM = 128, BN = 128, BK = 16, WM = 32, WN = 64, PA = 4, PB = 8, ST = 5, MINB = 1;
};
template <> struct Tiles<float, true> {
  static constexpr int BM = 64, BN = 128, BK = 32, WM = 32, WN = 32, PA = 4, PB = 8, ST = 3, MINB = 2;
};
template <> struct Tiles<double, false> {
  static constexpr int BM = 128, BN = 128, BK = 16, WM = 64, WN = 32, PA = 4, PB = 4, ST = 3, MINB = 1;
};
template <> struct Tiles<double, true> {
  static constexpr int BM = 64, BN = 128, BK = 16, WM = 32, WN = 32, PA = 4, PB = 4, ST = 3, MINB = 2;
};

template <typename T, bool SMALL>
__host__ __device__ constexpr int stage_elems() {
  using C = Tiles<T, SMALL>;
  return C::BM * (C::BK + C::PA) + C::BK * (C::BN + C::PB);
}

template <typename T, bool SMALL>
__host__ __device__ constexpr int smem_bytes() {
  return Tiles<T, SMALL>::ST * stage_elems<T, SMALL>() * (int)sizeof(T);
}

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = pred ? BYTES : 0;        // 0: fill the destination with zeros
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the TF32 high part of x: its top 10 mantissa bits (the tensor cores
// read only those); x - hi is exact in float32, and the tensor cores take
// its top 10 bits in turn
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// D = A B + D, m16n8k8; A row-major 16 x 8 (a[4]), B column-major 8 x 8
// (b[2]), D 16 x 8 (d[4]): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4); b0 (k = t, n = g), b1 (t + 4, g); d0/d1 (g, 2t / 2t + 1),
// d2/d3 (g + 8, ...), with g = lane / 4, t = lane % 4 — the same for the
// TF32 and the f64 shape.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[4],
                                    const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// one 8-deep slice of the warp tile: MT x NT fragments
template <int MT, int NT>
__device__ __forceinline__ void mma_slice(float (&acc)[MT][NT][4],
                                          const float (&a)[MT][4],
                                          const float (&b)[NT][2]) {
  uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ah[i][k] = tf32_hi(a[i][k]);
      al[i][k] = __float_as_uint(a[i][k] - __uint_as_float(ah[i][k]));
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      bh[j][k] = tf32_hi(b[j][k]);
      bl[j][k] = __float_as_uint(b[j][k] - __uint_as_float(bh[j][k]));
    }
  // pass by pass, so consecutive mma.sync write different accumulators
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[i][j], al[i], bh[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[i][j], ah[i], bl[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[i][j], ah[i], bh[j]);
}

template <int MT, int NT>
__device__ __forceinline__ void mma_slice(double (&acc)[MT][NT][4],
                                          const double (&a)[MT][4],
                                          const double (&b)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[i][j], a[i], b[j]);
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// VEC: 16-byte copies (rows of L and R, pointers 16-byte aligned);
// otherwise one element per copy
template <typename T, bool SUB, bool VEC, bool SMALL>
__global__ void __launch_bounds__(THREADS, (Tiles<T, SMALL>::MINB))
mm_kernel(const T* __restrict__ X, const T* __restrict__ L,
          const T* __restrict__ R, T* __restrict__ O, int M, int N, int K) {
  using C = Tiles<T, SMALL>;
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, WM = C::WM, WN = C::WN;
  constexpr int ST = C::ST;
  constexpr int AS = BK + C::PA, BS = BN + C::PB;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int WARPS_N = BN / WN;
  static_assert((BM / WM) * WARPS_N * 32 == THREADS, "8 warps");
  constexpr int CE = VEC ? 16 / (int)sizeof(T) : 1;    // elements per copy
  constexpr int CB = CE * (int)sizeof(T);              // bytes per copy

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tg = lane & 3;
  const long row0 = (long)blockIdx.y * BM, col0 = (long)blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    T* As = smem + stage * stage_elems<T, SMALL>();
    T* Bs = As + BM * AS;
    const int k0 = kt * BK;
    for (int e = tid; e < BM * BK / CE; e += THREADS) {
      const int r = e / (BK / CE), c = (e % (BK / CE)) * CE;
      const long gr = row0 + r;
      const int gk = k0 + c;
      const bool ok = gr < M && gk < K;
      cp_async<CB>(As + r * AS + c, ok ? L + gr * K + gk : L, ok);
    }
    for (int e = tid; e < BK * BN / CE; e += THREADS) {
      const int k = e / (BN / CE), c = (e % (BN / CE)) * CE;
      const int gk = k0 + k;
      const long gc = col0 + c;
      const bool ok = gk < K && gc < N;
      cp_async<CB>(Bs + k * BS + c, ok ? R + (long)gk * N + gc : R, ok);
    }
  };

  T acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = T(0);

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    const int nk = kt + ST - 1;
    if (nk < KT) load(nk % ST, nk);
    cp_async_commit();
    const T* As = smem + (kt % ST) * stage_elems<T, SMALL>();
    const T* Bs = As + BM * AS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      T a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T* p = As + (wm * WM + i * 16 + g) * AS + kk + tg;
        a[i][0] = p[0];
        a[i][1] = p[8 * AS];
        a[i][2] = p[4];
        a[i][3] = p[8 * AS + 4];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* p = Bs + (kk + tg) * BS + wn * WN + j * 8 + g;
        b[j][0] = p[0];
        b[j][1] = p[4 * BS];
      }
      mma_slice(acc, a, b);
    }
  }
  cp_async_wait<0>();

  // epilogue: O = acc, or X - acc
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long r = row0 + wm * WM + i * 16 + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const long c = col0 + wn * WN + j * 8 + 2 * tg;
        if (c >= N) continue;
        T v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const long o = r * N + c;
        if constexpr (VEC) {               // N even: c + 1 < N too
          using P = typename Pair<T>::type;
          if constexpr (SUB) {
            const P x = *reinterpret_cast<const P*>(X + o);
            v0 = sub_rn(x.x, v0);
            v1 = sub_rn(x.y, v1);
          }
          P out;
          out.x = v0;
          out.y = v1;
          *reinterpret_cast<P*>(O + o) = out;
        } else {
          if constexpr (SUB) v0 = sub_rn(X[o], v0);
          O[o] = v0;
          if (c + 1 < N) {
            if constexpr (SUB) v1 = sub_rn(X[o + 1], v1);
            O[o + 1] = v1;
          }
        }
      }
    }
}

template <typename T, bool SUB, bool VEC, bool SMALL>
int launch_tiles(const T* X, const T* L, const T* R, T* O, int M, int N,
                 int K, cudaStream_t stream) {
  using C = Tiles<T, SMALL>;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = mm_kernel<T, SUB, VEC, SMALL>;
  constexpr int smem = smem_bytes<T, SMALL>();
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc) return rc;
  kernel<<<grid, THREADS, smem, stream>>>(X, L, R, O, M, N, K);
  return (int)cudaGetLastError();
}

// fewer large tiles than two waves on the card's 132 SMs: the small tile
template <typename T, bool SUB, bool VEC>
int launch_sized(const T* X, const T* L, const T* R, T* O, int M, int N,
                 int K, cudaStream_t stream) {
  using C = Tiles<T, false>;
  const long tiles = (long)((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
  if (tiles < 2 * 132)
    return launch_tiles<T, SUB, VEC, true>(X, L, R, O, M, N, K, stream);
  return launch_tiles<T, SUB, VEC, false>(X, L, R, O, M, N, K, stream);
}

template <typename T, bool SUB>
int launch(const T* X, const T* L, const T* R, T* O, int M, int N, int K,
           cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  constexpr int CE = 16 / (int)sizeof(T);
  const uintptr_t ptrs = (uintptr_t)L | (uintptr_t)R | (uintptr_t)O |
                         (uintptr_t)(SUB ? X : O);
  if (N % CE == 0 && K % CE == 0 && ptrs % 16 == 0)
    return launch_sized<T, SUB, true>(X, L, R, O, M, N, K, stream);
  return launch_sized<T, SUB, false>(X, L, R, O, M, N, K, stream);
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
