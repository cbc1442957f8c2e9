// One block of the drag-linearization fixed point, fused, for Hopper.
//
// Replaces the TPU kernel raft_tpu/pallas_kernels.py:275-495
// (_fused_fp_kernel, _lane_spec and fused_block_fn: the waterfall's
// `fused` block program).  For every (design x case) lane it runs K gated
// fixed-point trips.  One trip at the linearization point XL [6, W]:
//
//   node motion dr = XL[:3] + th x r_n, relative velocity
//   v = (u - i w dr) on submerged nodes, and per node the directional RMS
//   velocities sqrt(dw sum_{i,w} |v_i q_i|^2), ... |v_i|^2 p1_i^2, p2_i^2;
//   drag matrices Bmat_n, B_drag = sum_n T(Bmat_n, r_n) (the 3->6
//   transform) and drag force F = sum_n [Bmat_n u_n; r_n x Bmat_n u_n];
//   Z = -w^2 M + C + i w (B + B_drag); W augmented 12x13 real block
//   systems [[Zr, -Zi], [Zi, Zr]] | [FR; FI] by Gauss-Jordan;
//   finite = all entries finite; conv = all |X - XL| / (|X| + tol) < tol;
//   XiNext = done ? XL : w_old XL + relax X; XiPoint = XL;
//   Xi_lastfinite = finite ? X : Xi_lastfinite; done |= conv | !finite;
//   froze |= !finite; i += 1.
//
// A trip runs only while (i < nIter + 1) & !done; a lane whose gate is
// false keeps its state bit for bit.  The gate cannot reopen, so the CTA
// leaves the trip loop the first time it is false (the Pallas kernel
// computes the body and throws it away; skipping gives the same output).
//
// Design.  One CTA of 256 threads per lane, the K trips inside it: each
// trip couples every frequency and node of the lane through the per-node
// RMS sums and the all-entries convergence test, so a trip is a sequence
// of CTA-wide passes separated by __syncthreads:
//   1. one warp per node: the lanes stride over w, then a shuffle sum
//      gives the node's three RMS sums; lane 0 forms Bmat_n in shared;
//   2. threads over w sum the drag force over nodes; 36 other threads
//      sum the 36 entries of B_drag over nodes;
//   3. 16 groups of 16 lanes build and eliminate the W systems, 16 at a
//      time, with gj::eliminate (gj_elim.cuh, shared with gj_solve.cu);
//   4. the convergence and finiteness tests (__syncthreads_and), then the
//      update of the state.
// XiNext and the trip's solution live in shared memory; XiPoint and
// Xi_lastfinite are written straight to the outputs.  The node arrays
// are read with a lane stride (0 for a bundle shared by every lane), so a
// shared bundle is never broadcast.  Complex arrays are read and written
// in PyTorch's interleaved layout (re, im).  Every product and sum is
// rounded on its own (__dmul_rn/__dadd_rn, -fmad=false); the sums run in
// another order than the plain PyTorch version's, so the two agree to
// round-off, not to the bit.
//
// Bound on this card.  Drag acts on the submerged nodes only, and the
// node passes skip the others, so the work counts S submerged nodes, not
// all N.  Per lane and trip at W frequencies: about 135 S W operations
// for the node passes, 3745 W for the assembly and the systems, 240 S
// and 90 W more (kernels/fused_block.py, lane_iteration_flops): 1.16
// MFLOP at the flagship's S = 38 (of N = 74), W = 128.  A call at L = 16
// lanes and K = 4 in f64 moves about 6.3 MB (the submerged nodes' rows
// of u, 3.7 MB, M and B, the state in and out) and does at most 74
// MFLOP: 1.9 us of memory time, at most 2.2 us of FP64 time, so about
// two microseconds.  The flagship gives only 16 CTAs for 132
// SMs, so the kernel will sit far from that bound; splitting W across
// the CTAs of a thread-block cluster, with the reductions in distributed
// shared memory, is the later fix.
//
// C interface: fused_block_f64 / fused_block_f32 launch on the given
// stream and return cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <math.h>

#include "gj_elim.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_NODES = 512;
constexpr int MAX_W = 256;
constexpr int NSYS = 12;            // rows of the real block system
constexpr int NAUG = 13;            // columns with the right-hand side

using gj::add_rn;
using gj::mul_rn;
using gj::sub_rn;
using gj::div_rn;

__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

template <typename T> struct Cplx;
template <> struct Cplx<double> { using type = double2; };
template <> struct Cplx<float> { using type = float2; };

template <typename T>
struct Args {
  using C2 = typename Cplx<T>::type;
  const T* w;                                   // [W]
  const T* r;                                   // [(L,) N, 3]
  const T* q;                                   // [(L,) N, 3]
  const T* qMat;                                // [(L,) N, 3, 3]
  const T* p1Mat;
  const T* p2Mat;
  const T* a_q;                                 // [(L,) N]
  const T* a_p1;
  const T* a_p2;
  const T* a_end_abs;
  const T* Cd_q;
  const T* Cd_p1;
  const T* Cd_p2;
  const T* Cd_End;
  const unsigned char* sub;                     // [(L,) N] bool
  const C2* u;                                  // [L, N, 3, W]
  const T* C;                                   // [L, 6, 6]
  const T* M;                                   // [L, W, 6, 6]
  const T* B;
  const T* Fr;                                  // [L, W, 6]
  const T* Fi;
  const long long* it_in;                       // [L]
  const C2* xn_in;                              // [L, 6, W]
  const C2* xp_in;
  const C2* xf_in;
  const unsigned char* dn_in;                   // [L] bool
  const unsigned char* fz_in;
  long long* it_out;
  C2* xn_out;
  C2* xp_out;
  C2* xf_out;
  unsigned char* dn_out;
  unsigned char* fz_out;
  int N, W, nodes_per_lane, nIter, K;
  T dw, c_drag, tol, relax, w_old;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = add_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// entry (a, b) of translate_matrix_3to6(Bm, r) = [[Bm, Bm H], [(Bm H)^T,
// H Bm H^T]] with H = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
template <typename T>
__device__ __forceinline__ T translate_entry(const T* Bm, const T* r,
                                             int a, int b) {
  const T H[3][3] = {{T(0), r[2], -r[1]}, {-r[2], T(0), r[0]},
                     {r[1], -r[0], T(0)}};
  if (a < 3 && b < 3) return Bm[a * 3 + b];
  if (a >= 3 && b >= 3) {
    // (H Bm) H^T
    T s = T(0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T hb = T(0);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        hb = add_rn(hb, mul_rn(H[a - 3][j], Bm[j * 3 + k]));
      s = add_rn(s, mul_rn(hb, H[b - 3][k]));
    }
    return s;
  }
  // (Bm H)[i][j], transposed in the lower-left block
  const int i = a < 3 ? a : b;
  const int j = a < 3 ? b - 3 : a - 3;
  T s = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) s = add_rn(s, mul_rn(Bm[i * 3 + k], H[k][j]));
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_block_kernel(const Args<T> a) {
  using C2 = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, W = a.W, E = 6 * W;
  T* xnr = reinterpret_cast<T*>(smem_raw);      // XiNext [6, W], re
  T* xni = xnr + E;
  T* Xr = xni + E;                              // this trip's solution
  T* Xi = Xr + E;
  T* Fdr = Xi + E;                              // drag force [W, 6]
  T* Fdi = Fdr + E;
  T* Bm = Fdi + E;                              // drag matrices [N, 9]
  T* Bd = Bm + 9 * N;                           // B_drag [6, 6]

  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long nl = a.nodes_per_lane ? (long)l * N : 0;
  const T* r = a.r + 3 * nl;
  const T* q = a.q + 3 * nl;
  const T* qMat = a.qMat + 9 * nl;
  const T* p1Mat = a.p1Mat + 9 * nl;
  const T* p2Mat = a.p2Mat + 9 * nl;
  const unsigned char* sub = a.sub + nl;
  const C2* u = a.u + (long)l * N * 3 * W;
  const T* C = a.C + 36L * l;
  const T* M = a.M + 36L * W * l;
  const T* B = a.B + 36L * W * l;
  const T* Fr = a.Fr + 6L * W * l;
  const T* Fi = a.Fi + 6L * W * l;
  const long so = (long)l * E;

  for (int e = tid; e < E; e += THREADS) {
    const C2 v = a.xn_in[so + e];
    xnr[e] = v.x;
    xni[e] = v.y;
    a.xp_out[so + e] = a.xp_in[so + e];
    a.xf_out[so + e] = a.xf_in[so + e];
  }
  long long it = a.it_in[l];
  bool dn = a.dn_in[l] != 0;
  bool fz = a.fz_in[l] != 0;
  __syncthreads();

  for (int k = 0; k < a.K; ++k) {
    // the gate is the same in every thread, and once false stays false
    if (!(it < a.nIter + 1) || dn) break;

    // ---- 1. per-node RMS velocities and drag matrices, a warp per node
    for (int n = warp; n < N; n += WARPS) {
      T sq = T(0), s1 = T(0), s2 = T(0);
      const bool sn = sub[n] != 0;              // uniform across the warp
      if (sn) {
        const T r0 = r[3 * n], r1 = r[3 * n + 1], r2 = r[3 * n + 2];
        for (int wi = lane; wi < W; wi += 32) {
          const T wv = a.w[wi];
          const T tr0 = xnr[3 * W + wi], tr1 = xnr[4 * W + wi],
                  tr2 = xnr[5 * W + wi];
          const T ti0 = xni[3 * W + wi], ti1 = xni[4 * W + wi],
                  ti2 = xni[5 * W + wi];
          // dr = XL[:3] + cross(th, r):  [t2 (-r1) + t1 r2,
          //   t2 r0 - t0 r2, (-t1) r0 + t0 r1]
          const T drr[3] = {
              add_rn(xnr[wi], add_rn(mul_rn(tr2, -r1), mul_rn(tr1, r2))),
              add_rn(xnr[W + wi], sub_rn(mul_rn(tr2, r0), mul_rn(tr0, r2))),
              add_rn(xnr[2 * W + wi],
                     add_rn(mul_rn(-tr1, r0), mul_rn(tr0, r1)))};
          const T dri[3] = {
              add_rn(xni[wi], add_rn(mul_rn(ti2, -r1), mul_rn(ti1, r2))),
              add_rn(xni[W + wi], sub_rn(mul_rn(ti2, r0), mul_rn(ti0, r2))),
              add_rn(xni[2 * W + wi],
                     add_rn(mul_rn(-ti1, r0), mul_rn(ti0, r1)))};
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const C2 uv = u[(3L * n + i) * W + wi];
            // v = u - i w dr  ->  (ur - (-w) dri, ui - w drr)
            const T vr = sub_rn(uv.x, mul_rn(-wv, dri[i]));
            const T vi = sub_rn(uv.y, mul_rn(wv, drr[i]));
            const T qi = q[3 * n + i];
            const T cr = mul_rn(vr, qi), ci = mul_rn(vi, qi);
            sq = add_rn(sq, add_rn(mul_rn(cr, cr), mul_rn(ci, ci)));
            const T ab2 = add_rn(mul_rn(vr, vr), mul_rn(vi, vi));
            s1 = add_rn(s1, mul_rn(ab2, p1Mat[9 * n + 4 * i]));
            s2 = add_rn(s2, mul_rn(ab2, p2Mat[9 * n + 4 * i]));
          }
        }
        sq = warp_sum(sq);
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
      }
      if (lane == 0) {
        const long o = nl + n;
        const T vq = sqrt_rn(mul_rn(sq, a.dw));
        const T v1 = sqrt_rn(mul_rn(s1, a.dw));
        const T v2 = sqrt_rn(mul_rn(s2, a.dw));
        const T Bq = mul_rn(mul_rn(mul_rn(a.c_drag, vq), a.a_q[o]), a.Cd_q[o]);
        const T Bp1 = mul_rn(mul_rn(mul_rn(a.c_drag, v1), a.a_p1[o]),
                             a.Cd_p1[o]);
        const T Bp2 = mul_rn(mul_rn(mul_rn(a.c_drag, v2), a.a_p2[o]),
                             a.Cd_p2[o]);
        const T Bend = mul_rn(mul_rn(mul_rn(a.c_drag, vq), a.a_end_abs[o]),
                              a.Cd_End[o]);
        const T bqe = add_rn(Bq, Bend);
#pragma unroll
        for (int ij = 0; ij < 9; ++ij)
          Bm[9 * n + ij] = add_rn(add_rn(mul_rn(bqe, qMat[9 * n + ij]),
                                         mul_rn(Bp1, p1Mat[9 * n + ij])),
                                  mul_rn(Bp2, p2Mat[9 * n + ij]));
      }
    }
    __syncthreads();

    // ---- 2. drag force per frequency, B_drag per entry, summed over the
    // submerged nodes
    for (int wi = tid; wi < W; wi += THREADS) {
      T fr[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      T fi[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int n = 0; n < N; ++n) {
        if (!sub[n]) continue;
        const C2 u0 = u[(3L * n) * W + wi];
        const C2 u1 = u[(3L * n + 1) * W + wi];
        const C2 u2 = u[(3L * n + 2) * W + wi];
        const T* b = Bm + 9 * n;
        T f3r[3], f3i[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          f3r[i] = add_rn(add_rn(mul_rn(b[3 * i], u0.x),
                                 mul_rn(b[3 * i + 1], u1.x)),
                          mul_rn(b[3 * i + 2], u2.x));
          f3i[i] = add_rn(add_rn(mul_rn(b[3 * i], u0.y),
                                 mul_rn(b[3 * i + 1], u1.y)),
                          mul_rn(b[3 * i + 2], u2.y));
        }
        const T r0 = r[3 * n], r1 = r[3 * n + 1], r2 = r[3 * n + 2];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          fr[i] = add_rn(fr[i], f3r[i]);
          fi[i] = add_rn(fi[i], f3i[i]);
        }
        // r x f3
        fr[3] = add_rn(fr[3], sub_rn(mul_rn(r1, f3r[2]), mul_rn(r2, f3r[1])));
        fr[4] = add_rn(fr[4], sub_rn(mul_rn(r2, f3r[0]), mul_rn(r0, f3r[2])));
        fr[5] = add_rn(fr[5], sub_rn(mul_rn(r0, f3r[1]), mul_rn(r1, f3r[0])));
        fi[3] = add_rn(fi[3], sub_rn(mul_rn(r1, f3i[2]), mul_rn(r2, f3i[1])));
        fi[4] = add_rn(fi[4], sub_rn(mul_rn(r2, f3i[0]), mul_rn(r0, f3i[2])));
        fi[5] = add_rn(fi[5], sub_rn(mul_rn(r0, f3i[1]), mul_rn(r1, f3i[0])));
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        Fdr[6 * wi + c] = fr[c];
        Fdi[6 * wi + c] = fi[c];
      }
    }
    {
      const int bt = tid - (THREADS - 36);      // the last 36 threads
      if (bt >= 0) {
        T s = T(0);
        for (int n = 0; n < N; ++n)
          if (sub[n])
            s = add_rn(s, translate_entry(Bm + 9 * n, r + 3 * n, bt / 6,
                                          bt % 6));
        Bd[bt] = s;
      }
    }
    __syncthreads();

    // ---- 3. the W block systems, 16 at a time; the round count is
    // uniform, so both half-warps always call the elimination together
    {
      const int g = tid >> 4;                   // system slot 0..15
      const int row = tid & 15;                 // row of this lane
      const int rounds = (W + 15) / 16;
      for (int rd = 0; rd < rounds; ++rd) {
        const int wi = rd * 16 + g;
        const bool live = wi < W && row < NSYS;
        T x[NAUG];
#pragma unroll
        for (int j = 0; j < NAUG; ++j) x[j] = T(0);
        if (live) {
          const T wv = a.w[wi];
          const T nw2 = -mul_rn(wv, wv);
          const int d = row < 6 ? row : row - 6;
          const T* Mr = M + 36L * wi + 6 * d;
          const T* Br = B + 36L * wi + 6 * d;
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            const T zr = add_rn(mul_rn(nw2, Mr[c]), C[6 * d + c]);
            const T zi = mul_rn(wv, add_rn(Br[c], Bd[6 * d + c]));
            x[c] = row < 6 ? zr : zi;
            x[6 + c] = row < 6 ? -zi : zr;
          }
          x[12] = row < 6 ? add_rn(Fdr[6 * wi + d], Fr[6L * wi + d])
                          : add_rn(Fdi[6 * wi + d], Fi[6L * wi + d]);
        }
        gj::eliminate<T, NSYS, NAUG>(x, row, NSYS, NAUG, [](int, T) {});
        if (live) {
          if (row < 6) Xr[row * W + wi] = x[12];
          else Xi[(row - 6) * W + wi] = x[12];
        }
      }
    }
    __syncthreads();

    // ---- 4. convergence, NaN quarantine and the relaxed update
    bool fin = true, conv = true;
    for (int e = tid; e < E; e += THREADS) {
      const T xr = Xr[e], xi = Xi[e];
      fin = fin && isfinite(xr) && isfinite(xi);
      const T dr = sub_rn(xr, xnr[e]), di = sub_rn(xi, xni[e]);
      const T num = sqrt_rn(add_rn(mul_rn(dr, dr), mul_rn(di, di)));
      const T den = add_rn(sqrt_rn(add_rn(mul_rn(xr, xr), mul_rn(xi, xi))),
                           a.tol);
      conv = conv && (div_rn(num, den) < a.tol);   // NaN compares false
    }
    const bool all_fin = __syncthreads_and(fin) != 0;
    const bool all_conv = __syncthreads_and(conv) != 0;
    const bool newdone = all_conv || !all_fin;
    for (int e = tid; e < E; e += THREADS) {
      const T xr = xnr[e], xi = xni[e];
      C2 v;
      v.x = xr;
      v.y = xi;
      a.xp_out[so + e] = v;                      // XiPoint <- XL
      if (!newdone) {
        xnr[e] = add_rn(mul_rn(a.w_old, xr), mul_rn(a.relax, Xr[e]));
        xni[e] = add_rn(mul_rn(a.w_old, xi), mul_rn(a.relax, Xi[e]));
      }
      if (all_fin) {
        v.x = Xr[e];
        v.y = Xi[e];
        a.xf_out[so + e] = v;                    // last finite iterate
      }
    }
    it += 1;
    dn = newdone;
    fz = fz || !all_fin;
    __syncthreads();
  }

  for (int e = tid; e < E; e += THREADS) {
    C2 v;
    v.x = xnr[e];
    v.y = xni[e];
    a.xn_out[so + e] = v;
  }
  if (tid == 0) {
    a.it_out[l] = it;
    a.dn_out[l] = dn;
    a.fz_out[l] = fz;
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, int L, int N, int W,
           int nodes_per_lane, double dw, double c_drag, double tol,
           double relax, double w_old, int nIter, int K,
           cudaStream_t stream) {
  if (L < 0 || N < 1 || N > MAX_NODES || W < 1 || W > MAX_W || K < 0)
    return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  using C2 = typename Cplx<T>::type;
  Args<T> a;
  int i = 0;
  a.w = static_cast<const T*>(in[i++]);
  a.r = static_cast<const T*>(in[i++]);
  a.q = static_cast<const T*>(in[i++]);
  a.qMat = static_cast<const T*>(in[i++]);
  a.p1Mat = static_cast<const T*>(in[i++]);
  a.p2Mat = static_cast<const T*>(in[i++]);
  a.a_q = static_cast<const T*>(in[i++]);
  a.a_p1 = static_cast<const T*>(in[i++]);
  a.a_p2 = static_cast<const T*>(in[i++]);
  a.a_end_abs = static_cast<const T*>(in[i++]);
  a.Cd_q = static_cast<const T*>(in[i++]);
  a.Cd_p1 = static_cast<const T*>(in[i++]);
  a.Cd_p2 = static_cast<const T*>(in[i++]);
  a.Cd_End = static_cast<const T*>(in[i++]);
  a.sub = static_cast<const unsigned char*>(in[i++]);
  a.u = static_cast<const C2*>(in[i++]);
  a.C = static_cast<const T*>(in[i++]);
  a.M = static_cast<const T*>(in[i++]);
  a.B = static_cast<const T*>(in[i++]);
  a.Fr = static_cast<const T*>(in[i++]);
  a.Fi = static_cast<const T*>(in[i++]);
  a.it_in = static_cast<const long long*>(in[i++]);
  a.xn_in = static_cast<const C2*>(in[i++]);
  a.xp_in = static_cast<const C2*>(in[i++]);
  a.xf_in = static_cast<const C2*>(in[i++]);
  a.dn_in = static_cast<const unsigned char*>(in[i++]);
  a.fz_in = static_cast<const unsigned char*>(in[i++]);
  a.it_out = static_cast<long long*>(out[0]);
  a.xn_out = static_cast<C2*>(out[1]);
  a.xp_out = static_cast<C2*>(out[2]);
  a.xf_out = static_cast<C2*>(out[3]);
  a.dn_out = static_cast<unsigned char*>(out[4]);
  a.fz_out = static_cast<unsigned char*>(out[5]);
  a.N = N;
  a.W = W;
  a.nodes_per_lane = nodes_per_lane;
  a.nIter = nIter;
  a.K = K;
  a.dw = T(dw);
  a.c_drag = T(c_drag);
  a.tol = T(tol);
  a.relax = T(relax);
  a.w_old = T(w_old);
  const size_t smem = (size_t)(36 * W + 9 * N + 36) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_block_kernel<T><<<L, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_block_f64(const void* const* in, void* const* out,
                               int L, int N, int W, int nodes_per_lane,
                               double dw, double c_drag, double tol,
                               double relax, double w_old, int nIter, int K,
                               void* stream) {
  return launch<double>(in, out, L, N, W, nodes_per_lane, dw, c_drag, tol,
                        relax, w_old, nIter, K, (cudaStream_t)stream);
}

extern "C" int fused_block_f32(const void* const* in, void* const* out,
                               int L, int N, int W, int nodes_per_lane,
                               double dw, double c_drag, double tol,
                               double relax, double w_old, int nIter, int K,
                               void* stream) {
  return launch<float>(in, out, L, N, W, nodes_per_lane, dw, c_drag, tol,
                       relax, w_old, nIter, K, (cudaStream_t)stream);
}
