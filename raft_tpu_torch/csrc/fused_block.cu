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
// false keeps its state bit for bit.  The gate cannot reopen, so the
// lane leaves the trip loop the first time it is false (the Pallas kernel
// computes the body and throws it away; skipping gives the same output).
//
// Design.  Each lane is one thread-block cluster of G CTAs of 256
// threads (G = min(8, ceil(W / 16)): 8 at the flagship's W = 128, so its
// 16 lanes make 128 CTAs, one wave on 132 SMs).  CTA rank g owns F =
// ceil(W / G) consecutive frequencies, their slice of XiNext and of the
// trip's solution in its shared memory.  Only two things couple the
// frequencies of a lane: the per-node RMS sums and the convergence and
// finiteness tests.  A trip in a CTA:
//   1. partial RMS sums over its own frequencies for every submerged node
//      (a list built once per call): 16 groups of 16 lanes, a group per
//      node and a lane per frequency, summed across the group by a
//      shuffle tree; then cluster.sync(), and every CTA reads the G
//      partials through distributed shared memory and adds them in rank
//      order 0..G-1, so every CTA holds bit-identical RMS velocities,
//      Bmat_n and (each CTA computes it itself, over 7 node chunks added
//      in order) B_drag;
//   2. the drag force of its frequencies: a group per frequency, a lane
//      per node chunk, a shuffle tree;
//   3. its F systems (16 per round: one round at F <= 16, two at W = 256)
//      built straight into column layout and eliminated by gj::eliminate
//      (gj_elim.cuh, shared with gj_solve.cu);
//   4. the convergence and finiteness tests over its slice
//      (__syncthreads_and), the two flags published in its shared memory,
//      cluster.sync(), and every warp reads all G flags: every CTA makes
//      the same done / froze decision, so the gate stays uniform across
//      the cluster; then each CTA updates its slice.
// Two cluster barriers a trip.  They also make the buffers read from
// other CTAs safe to reuse: a CTA rewrites its partials in trip k + 1
// only after the flags barrier of trip k, which every CTA passes after
// its last read of those partials; it rewrites its flags only after the
// partials barrier of trip k + 1, which every CTA passes after reading
// the flags of trip k.  A last cluster barrier keeps every CTA resident
// until no other can still read its shared memory.  The node arrays are
// read with a lane stride (0 for a bundle shared by every lane), so a
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
// two microseconds.  What bounds this design is latency: a trip is a
// chain of the phases above, each a few hundred cycles of dependent
// loads, shuffles and arithmetic, two cluster barriers, and one
// elimination round (12 steps of the chain in gj_elim.cuh).  Predicted
// (before the first card run of this design): about 8-15 us a trip, so
// 0.04-0.10 ms a call in f64 and 0.03-0.08 ms in f32 at the flagship's
// L = 16, K = 4, against 0.87 / 0.60 ms for the one-CTA-per-lane form it
// replaces (16 CTAs, eight elimination rounds a trip).  Measured
// (chip_smoke.py on an H100 80GB HBM3 at 700 W; docs/torch_port.md
// section 6): 0.0875 ms in f64 and 0.0645 ms in f32 a call, against
// 0.870 / 0.601 ms for the one-CTA-per-lane form in the same run; a trip
// takes 18-19 us in f64 (14 in f32), above the prediction: the
// elimination round 5.7 us (0.48 us a step, a third of it the division),
// the B_drag partials 2.9 us (5-6 nodes of translate_entry a thread, its
// H in local memory and its three kinds of entry branching apart within
// a warp), the drag force 2.2 us, the RMS partials and their rank-order
// totals 3.8 us, the two cluster barriers 1.3 us.  128 registers, no
// spills (a 72-byte stack frame in f64).
//
// C interface: fused_block_f64 / fused_block_f32 launch on the given
// stream and return the launch error (0 = launched); fused_block_shape
// reports the cluster size, the frequencies per CTA and the dynamic
// shared memory per CTA for N nodes and W frequencies.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gj_elim.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / gj::GROUP;     // 16 groups of 16 lanes
constexpr int MAX_NODES = 512;
constexpr int MAX_W = 256;
constexpr int MAX_CLUSTER = 8;                  // the portable cluster size
constexpr int BD_CHUNKS = THREADS / 36;         // node chunks of B_drag
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
  int N, W, F, nodes_per_lane, nIter, K;
  T dw, c_drag, tol, relax, w_old;
};

// the cluster: G CTAs of F frequencies each
__host__ __device__ inline int cluster_size(int W) {
  const int g = (W + gj::GROUP - 1) / gj::GROUP;
  return g < MAX_CLUSTER ? g : MAX_CLUSTER;
}

// dynamic shared memory layout of a CTA, the same in every CTA of the
// cluster (distributed shared memory reads use these offsets)
template <typename T>
struct Layout {
  int N, F;
  __host__ __device__ size_t xn() const { return 0; }                        // XiNext slice [2][6][F]
  __host__ __device__ size_t xs() const { return xn() + 12 * F; }            // trip's solution [2][6][F]
  __host__ __device__ size_t fd() const { return xs() + 12 * F; }            // drag force [F][12]
  __host__ __device__ size_t part() const { return fd() + 12 * F; }          // RMS partials [S][3]
  __host__ __device__ size_t bm() const { return part() + 3 * N; }           // Bmat [S][9]
  __host__ __device__ size_t bdp() const { return bm() + 9 * N; }            // B_drag chunks [7][36]
  __host__ __device__ size_t bd() const { return bdp() + BD_CHUNKS * 36; }   // B_drag [36]
  __host__ __device__ size_t reals() const { return bd() + 36; }
  // then ints: the submerged list [N], the flags [2], the count [1]
  __host__ __device__ size_t bytes() const {
    return reals() * sizeof(T) + (N + 3) * sizeof(int);
  }
};

// sum over the 16 lanes of a group, by a shuffle tree (every lane of the
// group ends with the same bits); both half-warps call it together
template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = gj::GROUP / 2; off > 0; off >>= 1)
    v = add_rn(v, __shfl_xor_sync(0xffffffffu, v, off, gj::GROUP));
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
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int N = a.N, W = a.W, F = a.F;
  const Layout<T> lay{N, F};
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* xnr = sm + lay.xn();                       // XiNext [6][F], re
  T* xni = xnr + 6 * F;
  T* Xr = sm + lay.xs();                        // this trip's solution
  T* Xi = Xr + 6 * F;
  T* Fd = sm + lay.fd();                        // drag force [F][12]
  T* part = sm + lay.part();                    // RMS partials [S][3]
  T* Bm = sm + lay.bm();                        // drag matrices [S][9]
  T* Bdp = sm + lay.bdp();                      // B_drag chunks [7][36]
  T* Bd = sm + lay.bd();                        // B_drag [6, 6]
  int* sidx = reinterpret_cast<int*>(sm + lay.reals());   // submerged nodes
  int* flags = sidx + N;                        // this CTA's fin, conv
  int* nsub = flags + 2;

  const int l = blockIdx.x / G;                 // the lane
  const int f0 = rank * F;                      // this CTA's frequencies
  const int nf = max(0, min(F, W - f0));
  const int tid = threadIdx.x;
  const int j = tid & (gj::GROUP - 1);          // lane in its group
  const int grp = tid >> 4;                     // group 0..15
  const long nl = a.nodes_per_lane ? (long)l * N : 0;
  const T* r = a.r + 3 * nl;
  const T* q = a.q + 3 * nl;
  const T* qMat = a.qMat + 9 * nl;
  const T* p1Mat = a.p1Mat + 9 * nl;
  const T* p2Mat = a.p2Mat + 9 * nl;
  const unsigned char* sub = a.sub + nl;
  const C2* u = a.u + (long)l * N * 3 * W + f0;   // [N, 3, W] from f0
  const T* C = a.C + 36L * l;
  const T* M = a.M + 36L * ((long)W * l + f0);
  const T* B = a.B + 36L * ((long)W * l + f0);
  const T* Fr = a.Fr + 6L * ((long)W * l + f0);
  const T* Fi = a.Fi + 6L * ((long)W * l + f0);
  const T* wv_ = a.w + f0;
  const long so = 6L * W * l + f0;              // state [6, W] from f0

  // the submerged nodes, in node order (warp 0)
  if (tid < 32) {
    int cnt = 0;
    for (int n0 = 0; n0 < N; n0 += 32) {
      const int n = n0 + tid;
      const bool s = n < N && sub[n] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, s);
      if (s) sidx[cnt + __popc(bal & ((1u << tid) - 1))] = n;
      cnt += __popc(bal);
    }
    if (tid == 0) *nsub = cnt;
  }
  for (int e = tid; e < 6 * nf; e += THREADS) {
    const int c = e / nf, f = e % nf;
    const long g = so + (long)c * W + f;
    const C2 v = a.xn_in[g];
    xnr[c * F + f] = v.x;
    xni[c * F + f] = v.y;
    a.xp_out[g] = a.xp_in[g];
    a.xf_out[g] = a.xf_in[g];
  }
  long long it = a.it_in[l];
  bool dn = a.dn_in[l] != 0;
  bool fz = a.fz_in[l] != 0;
  __syncthreads();
  const int S = *nsub;
  const int node_rounds = (S + GROUPS - 1) / GROUPS;    // uniform
  const int freq_rounds = (F + GROUPS - 1) / GROUPS;    // uniform

  for (int k = 0; k < a.K; ++k) {
    // the gate is the same in every thread of the cluster, and once false
    // stays false
    if (!(it < a.nIter + 1) || dn) break;

    // ---- 1. partial RMS sums over this CTA's frequencies: a group per
    // submerged node, a lane per frequency
    for (int nr = 0; nr < node_rounds; ++nr) {
      const int s = nr * GROUPS + grp;
      T sq = T(0), s1 = T(0), s2 = T(0);
      if (s < S) {
        const int n = sidx[s];
        const T r0 = r[3 * n], r1 = r[3 * n + 1], r2 = r[3 * n + 2];
        for (int f = j; f < nf; f += gj::GROUP) {
          const T wv = wv_[f];
          const T tr0 = xnr[3 * F + f], tr1 = xnr[4 * F + f],
                  tr2 = xnr[5 * F + f];
          const T ti0 = xni[3 * F + f], ti1 = xni[4 * F + f],
                  ti2 = xni[5 * F + f];
          // dr = XL[:3] + cross(th, r):  [t2 (-r1) + t1 r2,
          //   t2 r0 - t0 r2, (-t1) r0 + t0 r1]
          const T drr[3] = {
              add_rn(xnr[f], add_rn(mul_rn(tr2, -r1), mul_rn(tr1, r2))),
              add_rn(xnr[F + f], sub_rn(mul_rn(tr2, r0), mul_rn(tr0, r2))),
              add_rn(xnr[2 * F + f],
                     add_rn(mul_rn(-tr1, r0), mul_rn(tr0, r1)))};
          const T dri[3] = {
              add_rn(xni[f], add_rn(mul_rn(ti2, -r1), mul_rn(ti1, r2))),
              add_rn(xni[F + f], sub_rn(mul_rn(ti2, r0), mul_rn(ti0, r2))),
              add_rn(xni[2 * F + f],
                     add_rn(mul_rn(-ti1, r0), mul_rn(ti0, r1)))};
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const C2 uv = u[(3L * n + i) * W + f];
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
      }
      sq = group_sum(sq);
      s1 = group_sum(s1);
      s2 = group_sum(s2);
      if (j == 0 && s < S) {
        part[3 * s] = sq;
        part[3 * s + 1] = s1;
        part[3 * s + 2] = s2;
      }
    }
    cluster.sync();                             // partials of every CTA

    // ---- the lane's RMS sums, the G partials added in rank order; the
    // drag matrices of the submerged nodes
    for (int s = tid; s < S; s += THREADS) {
      T sq = T(0), s1 = T(0), s2 = T(0);
      for (int g = 0; g < G; ++g) {
        const T* pg = cluster.map_shared_rank(part, g);
        sq = add_rn(sq, pg[3 * s]);
        s1 = add_rn(s1, pg[3 * s + 1]);
        s2 = add_rn(s2, pg[3 * s + 2]);
      }
      const int n = sidx[s];
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
        Bm[9 * s + ij] = add_rn(add_rn(mul_rn(bqe, qMat[9 * n + ij]),
                                       mul_rn(Bp1, p1Mat[9 * n + ij])),
                                mul_rn(Bp2, p2Mat[9 * n + ij]));
    }
    __syncthreads();

    // ---- 2. B_drag over node chunks; the drag force of this CTA's
    // frequencies, a group per frequency and a lane per node chunk
    if (tid < BD_CHUNKS * 36) {
      const int e = tid % 36, c = tid / 36;
      T acc = T(0);
      for (int s = c; s < S; s += BD_CHUNKS)
        acc = add_rn(acc, translate_entry(Bm + 9 * s, r + 3 * sidx[s],
                                          e / 6, e % 6));
      Bdp[tid] = acc;
    }
    for (int fr = 0; fr < freq_rounds; ++fr) {
      const int f = fr * GROUPS + grp;
      T acc[12];
#pragma unroll
      for (int v = 0; v < 12; ++v) acc[v] = T(0);
      if (f < nf) {
        for (int s = j; s < S; s += gj::GROUP) {
          const int n = sidx[s];
          const C2 u0 = u[(3L * n) * W + f];
          const C2 u1 = u[(3L * n + 1) * W + f];
          const C2 u2 = u[(3L * n + 2) * W + f];
          const T* b = Bm + 9 * s;
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
            acc[i] = add_rn(acc[i], f3r[i]);
            acc[6 + i] = add_rn(acc[6 + i], f3i[i]);
          }
          // r x f3
          acc[3] = add_rn(acc[3], sub_rn(mul_rn(r1, f3r[2]), mul_rn(r2, f3r[1])));
          acc[4] = add_rn(acc[4], sub_rn(mul_rn(r2, f3r[0]), mul_rn(r0, f3r[2])));
          acc[5] = add_rn(acc[5], sub_rn(mul_rn(r0, f3r[1]), mul_rn(r1, f3r[0])));
          acc[9] = add_rn(acc[9], sub_rn(mul_rn(r1, f3i[2]), mul_rn(r2, f3i[1])));
          acc[10] = add_rn(acc[10], sub_rn(mul_rn(r2, f3i[0]), mul_rn(r0, f3i[2])));
          acc[11] = add_rn(acc[11], sub_rn(mul_rn(r0, f3i[1]), mul_rn(r1, f3i[0])));
        }
      }
#pragma unroll
      for (int v = 0; v < 12; ++v) acc[v] = group_sum(acc[v]);
      if (j == 0 && f < nf) {
#pragma unroll
        for (int v = 0; v < 12; ++v) Fd[12 * f + v] = acc[v];
      }
    }
    __syncthreads();
    if (tid < 36) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < BD_CHUNKS; ++c) acc = add_rn(acc, Bdp[36 * c + tid]);
      Bd[tid] = acc;
    }
    __syncthreads();

    // ---- 3. this CTA's systems, 16 a round, built in column layout: lane
    // j of group g holds column j of frequency f's [[Zr, -Zi], [Zi, Zr]] |
    // [FR; FI]; the round count is uniform, so both half-warps always
    // call the elimination together
    for (int fr = 0; fr < freq_rounds; ++fr) {
      const int f = fr * GROUPS + grp;
      const bool live = f < nf;
      T x[NSYS];
#pragma unroll
      for (int d = 0; d < NSYS; ++d) x[d] = T(0);
      if (live && j < NSYS) {
        const T wv = wv_[f];
        const T nw2 = -mul_rn(wv, wv);
        const int c = j < 6 ? j : j - 6;
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          const T zr = add_rn(mul_rn(nw2, M[36L * f + 6 * d + c]), C[6 * d + c]);
          const T zi = mul_rn(wv, add_rn(B[36L * f + 6 * d + c], Bd[6 * d + c]));
          x[d] = j < 6 ? zr : -zi;
          x[6 + d] = j < 6 ? zi : zr;
        }
      } else if (live && j == NAUG - 1) {
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          x[d] = add_rn(Fd[12 * f + d], Fr[6L * f + d]);
          x[6 + d] = add_rn(Fd[12 * f + 6 + d], Fi[6L * f + d]);
        }
      }
      gj::eliminate<T, NSYS>(x, NSYS, [](int, T) {});
      if (live && j == NAUG - 1) {
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          Xr[d * F + f] = x[d];
          Xi[d * F + f] = x[6 + d];
        }
      }
    }
    __syncthreads();

    // ---- 4. convergence and NaN quarantine over the cluster, then the
    // relaxed update of this CTA's slice
    bool fin = true, conv = true;
    for (int e = tid; e < 6 * nf; e += THREADS) {
      const int c = e / nf, f = e % nf;
      const T xr = Xr[c * F + f], xi = Xi[c * F + f];
      fin = fin && isfinite(xr) && isfinite(xi);
      const T dr = sub_rn(xr, xnr[c * F + f]), di = sub_rn(xi, xni[c * F + f]);
      const T num = sqrt_rn(add_rn(mul_rn(dr, dr), mul_rn(di, di)));
      const T den = add_rn(sqrt_rn(add_rn(mul_rn(xr, xr), mul_rn(xi, xi))),
                           a.tol);
      conv = conv && (div_rn(num, den) < a.tol);   // NaN compares false
    }
    fin = __syncthreads_and(fin) != 0;
    conv = __syncthreads_and(conv) != 0;
    if (tid == 0) {
      flags[0] = fin;
      flags[1] = conv;
    }
    cluster.sync();                             // flags of every CTA
    {
      const int lane = tid & 31;
      int fg = 1, cg_ = 1;
      if (lane < G) {
        const int* fl = cluster.map_shared_rank(flags, lane);
        fg = fl[0];
        cg_ = fl[1];
      }
      fin = __all_sync(0xffffffffu, fg != 0) != 0;
      conv = __all_sync(0xffffffffu, cg_ != 0) != 0;
    }
    const bool newdone = conv || !fin;
    for (int e = tid; e < 6 * nf; e += THREADS) {
      const int c = e / nf, f = e % nf;
      const int o = c * F + f;
      const long g = so + (long)c * W + f;
      const T xr = xnr[o], xi = xni[o];
      C2 v;
      v.x = xr;
      v.y = xi;
      a.xp_out[g] = v;                          // XiPoint <- XL
      if (!newdone) {
        xnr[o] = add_rn(mul_rn(a.w_old, xr), mul_rn(a.relax, Xr[o]));
        xni[o] = add_rn(mul_rn(a.w_old, xi), mul_rn(a.relax, Xi[o]));
      }
      if (fin) {
        v.x = Xr[o];
        v.y = Xi[o];
        a.xf_out[g] = v;                        // last finite iterate
      }
    }
    it += 1;
    dn = newdone;
    fz = fz || !fin;
    __syncthreads();
  }

  for (int e = tid; e < 6 * nf; e += THREADS) {
    const int c = e / nf, f = e % nf;
    C2 v;
    v.x = xnr[c * F + f];
    v.y = xni[c * F + f];
    a.xn_out[so + (long)c * W + f] = v;
  }
  if (tid == 0 && rank == 0) {
    a.it_out[l] = it;
    a.dn_out[l] = dn;
    a.fz_out[l] = fz;
  }
  cluster.sync();       // no CTA leaves while another may read its memory
}

template <typename T>
int shape(int N, int W, int* cluster, int* per_cta, int* smem) {
  if (N < 1 || N > MAX_NODES || W < 1 || W > MAX_W)
    return (int)cudaErrorInvalidValue;
  const int G = cluster_size(W);
  const int F = (W + G - 1) / G;
  *cluster = G;
  *per_cta = F;
  *smem = (int)Layout<T>{N, F}.bytes();
  return 0;
}

template <typename T>
int launch(const void* const* in, void* const* out, int L, int N, int W,
           int nodes_per_lane, double dw, double c_drag, double tol,
           double relax, double w_old, int nIter, int K,
           cudaStream_t stream) {
  int G, F, smem;
  int rc = shape<T>(N, W, &G, &F, &smem);
  if (rc || L < 0 || K < 0) return rc ? rc : (int)cudaErrorInvalidValue;
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
  a.F = F;
  a.nodes_per_lane = nodes_per_lane;
  a.nIter = nIter;
  a.K = K;
  a.dw = T(dw);
  a.c_drag = T(c_drag);
  a.tol = T(tol);
  a.relax = T(relax);
  a.w_old = T(w_old);
  auto kernel = fused_block_kernel<T>;
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(L * G));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, a);
  if (rc) return rc;
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

extern "C" int fused_block_shape(int N, int W, int f64, int* cluster,
                                 int* per_cta, int* smem) {
  return f64 ? shape<double>(N, W, cluster, per_cta, smem)
             : shape<float>(N, W, cluster, per_cta, smem);
}
