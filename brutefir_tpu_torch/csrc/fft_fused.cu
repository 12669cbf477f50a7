// Fused real FFT: the whole packed real transform of a channel in one
// kernel, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pair of brutefir_tpu/ops/pallas_fft.py:
// `_fwd_kernel` (:154, via `rfft_planes_fused` :215-244) and `_inv_kernel`
// (:184, via `_inv_call` :247-273). The TPU runs a four-step transform as
// dense f32 matmuls on its matrix unit and gets the Hermitian mirror as a
// second, conjugate-input transform, because a lane reversal is expensive
// there. On the card the same four-step split runs as FFTs, and the mirror
// is a warp shuffle.
//
// What it computes, per channel c (R = M/128; tile position p = k1*128 + k2
// holds natural bin k = k2*R + k1, the JAX package's `bin_order`):
//   bf_fft_fused_fwd: real x [C, 2M] -> packed planes [C, 2, M] in the
//     permuted order: z[n] = x[2n] + i x[2n+1], Z = DFT_M(z), then the
//     forward glue X[k] = a Z[k] + b conj(Z[(M-k) % M]) with Nyquist in
//     bin 0's imaginary slot (csrc/fft_common.cuh), X[k] written to p;
//   bf_fft_fused_inv: permuted packed planes [C, 2, M] -> real
//     [C, 2 n_out]: the inverse glue V[k] = a' K[k] + b' R[k],
//     z = IDFT_M(V) / M, and the first n_out complex outputs written as
//     re/im pairs (n_out = M: the full frame; n_out = M/2: its valid half).
//
// The four-step transform, M = R x 128, n = n1*128 + n2, k = k2*R + k1:
//   Z[k] = sum_n2 W_128^{n2 k2} W_M^{n2 k1} sum_n1 W_R^{n1 k1} z[n1*128+n2]
// so the forward runs R-point DFTs down the 128 columns n2, the twiddle
// W_M^{n2 k1}, and 128-point DFTs along the R rows k1; row k1 of the result
// IS positions k1*128 ... k1*128+127 of the permuted order, stored as it
// stands (no gather). The inverse runs the mirror image: rows, twiddle,
// columns. ops/fft_fused.py's plain version runs the same stages in the
// same order.
//
// What bounds it on an H100: bytes. A channel reads 8M bytes and writes 8M
// (the valid inverse 4M), and the tables add 24M once: at M = 8192 3.6 MB
// at C = 26 and 33.8 MB at C = 256, 1.1 and 10.1 us at 3.35 TB/s. The
// arithmetic, about 5 M log2 M operations a channel, is far below. The
// design keeps every intermediate on chip and spreads a channel over many
// SMs:
// - One channel is one thread-block cluster of S blocks of 128 threads
//   (ops/fft_fused.cluster_size: 8 from R = 8 up, else 4 or 2; 4 where C
//   clusters of 8 would not all be resident at once). Block s owns the
//   columns s*128/S ... (s+1)*128/S - 1: it loads them (coalesced rows of
//   128/S points), runs their R-point DFTs as mixed-radix Stockham stages
//   (4, then 2, then the odd factors) in shared memory laid out
//   [k1][column], which no two lanes of a warp hit on the same bank, then
//   the cluster syncs. At M = 8192 and S = 8 that is 16 KB a block, 208
//   blocks at C = 26.
// - The row phase reads each row straight out of the peers' shared memory
//   (distributed shared memory, cluster.map_shared_rank): nothing crosses
//   device memory between the two phases. A warp takes a row unit, row
//   k1 = u and its mirror row R - u (block u % S takes unit u:
//   ops/fft_fused.cluster_rows), 4 points a lane a row, and transforms
//   each row in registers: a 4-point DFT, the twiddle W_128^{l r}, five
//   radix-2 stages across lanes by __shfl_xor_sync. Lane l then holds bins
//   k2 = 4 brev5(l) + r in its registers r: the mirror bin of (k1, k2),
//   (R-k1, 127-k2), sits in lane 31-l, register 3-r of the other row (row
//   0: (0, (128-k2) % 128)), one shuffle away, so the glue reads each bin
//   and its mirror once; the lane writes 4 consecutive floats of each
//   plane (one float4), and the warp a whole 512-byte row.
// - The cluster barriers are split (arrive, then wait later): the forward
//   arrives once a warp has read its peers' rows and waits only before it
//   exits; the inverse arrives at the start and waits just before its
//   first write into a peer.
// - Twiddles are entries of one table e^{-2 pi i j/M} built in float64 and
//   rounded once (the inverse uses their conjugates), laid out for the
//   reader: W_R and W_128 (every 128th and every R-th entry) copied into
//   shared memory, the four-step twiddles W_M^{n2 k1} gathered into rows
//   [R, 128], and the combine table in row order, so that every warp load
//   of a table is contiguous (strided reads of the M-point table held up
//   the row phase, PERF.md).
// What is left (PERF.md): at C = 26 a cluster's chain of dependent steps
// (load, three column stages, barrier, row gather, glue); at C = 256 the
// waves of blocks that 80 registers a thread allow (6 blocks an SM).
// Where the two column buffers and the tables (16M/S + 8(R + 128) bytes)
// outgrow a block's shared memory (M > 112128 at S = 8,
// ops/fft_fused.needs_scratch) the wrapper passes a scratch buffer of
// [C, 2M] complex in device memory; the same code runs there and the row
// phase reads the peers' share from it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

// 128 threads a block, at most 80 registers a thread (at least 6 blocks
// resident on an SM, ops/fft_fused.BLOCKS_PER_SM): the best of the sizes
// measured at C = 26 and 256 (PERF.md).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 6;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;
constexpr int kSmemMax = 232448;      // 227 KB: a block's opt-in maximum

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 shfl(float2 v, int lane) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, lane),
                     __shfl_sync(0xffffffffu, v.y, lane));
}
__device__ __forceinline__ float2 shfl_xor(float2 v, int mask) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, mask),
                     __shfl_xor_sync(0xffffffffu, v.y, mask));
}
__device__ __forceinline__ int brev5(int l) { return __brev(l) >> 27; }

// The two halves of a cluster barrier: arrive (release: this thread's
// reads and writes so far are done) and wait (acquire: every thread of
// the cluster has arrived). Work between them overlaps the wait; a warp
// executes each as a whole.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A table entry e^{-2 pi i j / N} as the transform needs it: itself
// (forward, kSign = -1) or its conjugate (inverse, kSign = +1).
template <int kSign>
__device__ __forceinline__ float2 dir(float2 w) {
  return kSign < 0 ? w : make_float2(w.x, -w.y);
}

// The radix of the next stage: 4 while it divides, then 2, then the odd
// factors in ascending order.
__device__ __forceinline__ int next_radix(int rem) {
  if (rem % 4 == 0) return 4;
  if (rem % 2 == 0) return 2;
  int f = 3;
  while (rem % f) f += 2;
  return f;
}

// The 4-point DFT (kSign = -1) or unnormalised inverse of v[0..3].
template <int kSign>
__device__ __forceinline__ void dft4(float2 (&v)[4]) {
  const float2 a0 = cadd(v[0], v[2]), a1 = csub(v[0], v[2]);
  const float2 b0 = cadd(v[1], v[3]), d = csub(v[1], v[3]);
  // d times -i (forward) or +i (inverse)
  const float2 b1 = kSign < 0 ? make_float2(d.y, -d.x)
                              : make_float2(-d.y, d.x);
  v[0] = cadd(a0, b0);
  v[1] = cadd(a1, b1);
  v[2] = csub(a0, b0);
  v[3] = csub(a1, b1);
}

// The R-point DFT (kSign = -1) or its unnormalised inverse down each of
// the kCols columns of the [R][kCols] buffer `src`, by the whole block, as
// Stockham stages; `dst` is the other buffer, `wr` the table W_R^j in
// shared memory. Returns the buffer that holds the result. Thread t takes
// column t % kCols of butterfly t / kCols: a warp reads and writes whole
// rows of the buffer. The caller synchronised after writing src.
template <int kSign, int kCols>
__device__ __forceinline__ float2* columns(float2* src, float2* dst,
                                           const float2* wr, int R) {
  int p = 1;
  for (int rem = R; rem > 1;) {
    const int r = next_radix(rem);
    const int n = R / r;                  // butterflies: input m at i + m n
    const int step = R / (p * r);         // table stride of W_{p r}
    for (int t = threadIdx.x; t < n * kCols; t += kThreads) {
      const int i = t / kCols;
      const int c = t % kCols;
      const float2* s = src + c;
      float2* d = dst + c;
      // p is a power of two while the radix is 4 or 2
      const int k = r <= 4 ? i & (p - 1) : i % p;
      const int j = (i - k) * r + k;
      if (r == 4) {
        float2 v[4] = {s[i * kCols], s[(i + n) * kCols],
                       s[(i + 2 * n) * kCols], s[(i + 3 * n) * kCols]};
        v[1] = cmul(v[1], dir<kSign>(wr[k * step]));
        v[2] = cmul(v[2], dir<kSign>(wr[2 * k * step]));
        v[3] = cmul(v[3], dir<kSign>(wr[3 * k * step]));
        dft4<kSign>(v);
#pragma unroll
        for (int q = 0; q < 4; ++q) d[(j + q * p) * kCols] = v[q];
      } else if (r == 2) {
        const float2 x0 = s[i * kCols];
        const float2 x1 =
            cmul(s[(i + n) * kCols], dir<kSign>(wr[k * step]));
        d[j * kCols] = cadd(x0, x1);
        d[(j + p) * kCols] = csub(x0, x1);
      } else {
        const int pr = p * r;
        for (int q = 0; q < r; ++q) {
          const long long e = k + q * p;
          float2 acc = s[i * kCols];
          for (int m = 1; m < r; ++m) {
            const int ix = static_cast<int>((m * e) % pr) * step;
            acc = cadd(acc,
                       cmul(s[(i + m * n) * kCols], dir<kSign>(wr[ix])));
          }
          d[(j + q * p) * kCols] = acc;
        }
      }
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
    p *= r;
    rem /= r;
  }
  return src;
}

// The twiddle and the sign of one radix-2 stage across lanes (partner lane
// lane ^ h): the upper lane of a pair (bit h set) takes W_{2h}^{lane % h}
// from the table W_128^j in shared memory and the sign -1, the lower one 1
// and +1, so that both run the same instructions: multiplying by 1 is
// exact.
template <int kSign>
__device__ __forceinline__ float2 lane_twiddle(const float2* w, int lane,
                                               int h, float& sign) {
  const bool hi = lane & h;
  sign = hi ? -1.f : 1.f;
  return hi ? dir<kSign>(w[(lane & (h - 1)) * (64 / h)])
            : make_float2(1.f, 0.f);
}

// The 128-point DFT of one row by a warp: in, v[j] = y[lane + 32 j]; out,
// v[r] = Y[r + 4 brev5(lane)]. A 4-point DFT, the twiddle W_128^{lane r},
// five radix-2 decimation-in-frequency stages across lanes: the lower lane
// of a pair keeps v + o, the upper one (o - v) W.
__device__ __forceinline__ void row_fwd(float2 (&v)[4], const float2* w,
                                        int lane) {
  dft4<-1>(v);
#pragma unroll
  for (int r = 1; r < 4; ++r) v[r] = cmul(v[r], w[lane * r]);
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    float sign;
    const float2 wh = lane_twiddle<-1>(w, lane, h, sign);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 o = shfl_xor(v[r], h);
      v[r] = cmul(make_float2(fmaf(sign, v[r].x, o.x),
                              fmaf(sign, v[r].y, o.y)), wh);
    }
  }
}

// Its unnormalised inverse, the mirror image: in, v[r] = Y[r + 4
// brev5(lane)]; out, v[j] = y[lane + 32 j]. Five radix-2
// decimation-in-time stages across lanes (the upper lane of a pair
// multiplies by W first; the lower keeps v + o, the upper o - v W), the
// twiddle W_128^{-lane r}, a 4-point inverse DFT.
__device__ __forceinline__ void row_inv(float2 (&v)[4], const float2* w,
                                        int lane) {
#pragma unroll
  for (int h = 1; h <= 16; h <<= 1) {
    float sign;
    const float2 wh = lane_twiddle<1>(w, lane, h, sign);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 t = cmul(v[r], wh);
      const float2 o = shfl_xor(t, h);
      v[r] = make_float2(fmaf(sign, t.x, o.x), fmaf(sign, t.y, o.y));
    }
  }
#pragma unroll
  for (int r = 1; r < 4; ++r) v[r] = cmul(v[r], dir<1>(w[lane * r]));
  dft4<1>(v);
}

// The mirror bins m[r] of row 0's bins v[r] (layout of row_fwd's output):
// bin k2 = r + 4 brev5(lane) mirrors to (128 - k2) % 128, which is lane
// brev5(32 - brev5(lane)) register 0 for r = 0, lane 31 - lane register
// 4 - r else.
__device__ __forceinline__ void mirror_row0(const float2 (&v)[4], int lane,
                                            float2 (&m)[4]) {
  m[0] = shfl(v[0], brev5((32 - brev5(lane)) & 31));
  m[1] = shfl(v[3], 31 - lane);
  m[2] = shfl(v[2], 31 - lane);
  m[3] = shfl(v[1], 31 - lane);
}

// The mirror bins m[r] of row k1 > 0, taken from `w`, row R - k1: bin k2
// mirrors to 127 - k2, which is lane 31 - lane, register 3 - r.
__device__ __forceinline__ void mirror_row(const float2 (&w)[4],
                                           float2 (&m)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = shfl_xor(w[3 - r], 31);
}

// The geometry of a cluster of kS blocks (a channel, blockIdx.x / kS):
// this block's rank s,
// its columns s*cols ..., its two column buffers (shared memory, or its
// slice of `scratch`) and the tables W_R^j (j < R) and W_128^j (j < 128)
// in shared memory behind them.
template <int kS>
struct Split {
  static constexpr int S = kS;
  static constexpr int cols = kLanes / kS;
  int s, R;
  size_t c, share;
  float2* a;
  float2* b;
  float2* wr;
  float2* w128;
  __device__ Split(cg::cluster_group& cluster, float2* smem, float2* scratch,
                   int M) {
    s = static_cast<int>(cluster.block_rank());
    R = M / kLanes;
    c = blockIdx.x / S;
    share = static_cast<size_t>(R) * cols;
    a = scratch ? scratch + (c * S + s) * 2 * share : smem;
    b = a + share;
    wr = scratch ? smem : smem + 2 * share;
    w128 = wr + R;
  }
  // Copy the two tables, W_R then W_128 (`tw`, R + 128 entries). The
  // caller synchronises.
  __device__ void load_tables(const float2* __restrict__ tw) const {
    for (int j = threadIdx.x; j < R + kLanes; j += kThreads)
      wr[j] = __ldg(tw + j);
  }
  // The column buffer `buf` (this block's a or b) as it lies in cluster
  // block `rank`: in its shared memory (distributed shared memory), or in
  // its slice of the scratch buffer.
  __device__ float2* peer(cg::cluster_group& cluster, float2* buf,
                          bool scratch, int rank) const {
    return scratch ? buf + (rank - s) * static_cast<long long>(2 * share)
                   : cluster.map_shared_rank(buf, rank);
  }
};

// Forward row phase, the loads of one row: row k1 of the column DFTs'
// result `Y` (spread over the cluster) and its twiddles W_M^{n2 k1}, row
// k1 of `tw_rows` (entry n2 k1 of the M-point table, gathered into rows).
template <int kS>
__device__ __forceinline__ void gather_row(
    cg::cluster_group& cluster, const Split<kS>& g, float2* Y, bool scratch,
    const float2* __restrict__ tw_rows, int k1, int lane, float2 (&v)[4],
    float2 (&t)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n2 = lane + 32 * j;
    const int rank = n2 / g.cols;
    v[j] = g.peer(cluster, Y, scratch, rank)[k1 * g.cols + n2 - rank * g.cols];
    t[j] = __ldg(tw_rows + k1 * kLanes + n2);
  }
}

// Forward glue of row k1 (bins v, mirror bins m) and its store: lane l
// writes positions k1*128 + 4 brev5(l) + 0..3 of both planes, one float4
// each. The combine table `ab` holds position k1*128 + 4q + r at
// k1*128 + 32r + q (ops/fft_fused._ab_rows): a warp reads it in order.
__device__ __forceinline__ void store_row_fwd(
    const float4* __restrict__ ab, float* xr, float* xi, int k1,
    int lane, const float2 (&v)[4], const float2 (&m)[4]) {
  const int q = brev5(lane);
  const int p0 = k1 * kLanes + 4 * q;
  float X[2][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 t = bf_untangle(__ldg(ab + k1 * kLanes + 32 * r + q), v[r],
                                 m[r], p0 + r == 0);
    X[0][r] = t.x;
    X[1][r] = t.y;
  }
  *reinterpret_cast<float4*>(xr + p0) =
      make_float4(X[0][0], X[0][1], X[0][2], X[0][3]);
  *reinterpret_cast<float4*>(xi + p0) =
      make_float4(X[1][0], X[1][1], X[1][2], X[1][3]);
}

template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_fwd_kernel(const float2* __restrict__ x, const float2* __restrict__ tw,
                 const float2* __restrict__ tw_rows,
                 const float4* __restrict__ ab, float* __restrict__ out,
                 float2* scratch, int M) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float2 smem[];
  const Split<kS> g(cluster, smem, scratch, M);
  const float2* xc = x + g.c * M + g.s * g.cols;  // (even, odd) pairs
  for (int t = threadIdx.x; t < static_cast<int>(g.share); t += kThreads) {
    const int i = t / g.cols;
    g.a[t] = xc[i * kLanes + (t - i * g.cols)];
  }
  g.load_tables(tw);
  __syncthreads();
  float2* Y = columns<-1, kLanes / kS>(g.a, g.b, g.wr, g.R);
  cluster.sync();                         // every block's columns are done

  const int lane = threadIdx.x & 31;
  float* xr = out + g.c * 2 * M;
  float* xi = xr + M;
  const bool sc = scratch != nullptr;
  // row unit u: rows u and v = R - u, or u alone where u = 0 or 2u = R
  // (then v = u, and the second row's work is a copy of the first's). A
  // warp arrives at the cluster barrier once it has read its last rows
  // from its peers, and the block waits for its peers at the end.
  const int first = g.s + g.S * (threadIdx.x >> 5);
  if (first > g.R / 2) cluster_arrive();
  for (int u = first; u <= g.R / 2; u += g.S * kWarps) {
    const int v = u == 0 || 2 * u == g.R ? u : g.R - u;
    float2 A[4], B[4], tA[4], tB[4], m[4];
    gather_row(cluster, g, Y, sc, tw_rows, u, lane, A, tA);
    gather_row(cluster, g, Y, sc, tw_rows, v, lane, B, tB);
    if (u + g.S * kWarps > g.R / 2) cluster_arrive();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      A[j] = cmul(A[j], tA[j]);
      B[j] = cmul(B[j], tB[j]);
    }
    row_fwd(A, g.w128, lane);
    row_fwd(B, g.w128, lane);
    if (u == 0) {
      mirror_row0(A, lane, m);
    } else {
      mirror_row(B, m);
    }
    store_row_fwd(ab, xr, xi, u, lane, A, m);
    mirror_row(A, m);
    if (v != u) store_row_fwd(ab, xr, xi, v, lane, B, m);
  }
  cluster_wait();           // the peers have read this block's buffer
}

// Row k1 of the permuted planes: lane l reads positions k1*128 +
// 4 brev5(l) + 0..3 of both planes, one float4 each.
__device__ __forceinline__ void load_row_inv(const float* pr, const float* pi,
                                             int k1, int lane,
                                             float2 (&P)[4]) {
  const int p0 = k1 * kLanes + 4 * brev5(lane);
  const float4 re = __ldg(reinterpret_cast<const float4*>(pr + p0));
  const float4 im = __ldg(reinterpret_cast<const float4*>(pi + p0));
  P[0] = make_float2(re.x, im.x);
  P[1] = make_float2(re.y, im.y);
  P[2] = make_float2(re.z, im.z);
  P[3] = make_float2(re.w, im.w);
}

// Inverse row phase, one row: the planes' row k1 (P, mirror bins Q)
// through the inverse glue, the row inverse DFT and the twiddle
// W_M^{-n2 k1}, in place in P (layout of row_inv's output).
__device__ __forceinline__ void row_inv_glued(
    const float2* w128, const float2* __restrict__ tw_rows,
    const float4* __restrict__ ab, int k1, int lane, float2 (&P)[4],
    const float2 (&Q)[4]) {
  const int q = brev5(lane);
  const int p0 = k1 * kLanes + 4 * q;
  float2 t[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    t[j] = __ldg(tw_rows + k1 * kLanes + lane + 32 * j);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 c = __ldg(ab + k1 * kLanes + 32 * r + q);
    P[r] = p0 + r == 0 ? bf_combine_inv(c, P[r].x, 0.f, P[r].y, 0.f)
                       : bf_combine_inv(c, P[r].x, P[r].y, Q[r].x, -Q[r].y);
  }
  row_inv(P, w128, lane);
#pragma unroll
  for (int j = 0; j < 4; ++j) P[j] = cmul(P[j], dir<1>(t[j]));
}

// Row k1 (v[j] = point n2 = lane + 32 j) into the first column buffer of
// the block that owns each column n2.
template <int kS>
__device__ __forceinline__ void scatter_row(cg::cluster_group& cluster,
                                            const Split<kS>& g, bool scratch,
                                            int k1, int lane,
                                            const float2 (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n2 = lane + 32 * j;
    const int rank = n2 / g.cols;
    g.peer(cluster, g.a, scratch, rank)[k1 * g.cols + n2 - rank * g.cols] =
        v[j];
  }
}

template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_inv_kernel(const float* __restrict__ planes,
                 const float2* __restrict__ tw,
                 const float2* __restrict__ tw_rows,
                 const float4* __restrict__ ab, float2* __restrict__ out,
                 float2* scratch, int M, int n_out) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float2 smem[];
  const Split<kS> g(cluster, smem, scratch, M);
  g.load_tables(tw);
  __syncthreads();
  // a peer may write into this block once every block of the cluster
  // runs: arrive now, wait just before the first write
  cluster_arrive();

  const int lane = threadIdx.x & 31;
  const float* pr = planes + g.c * 2 * M;
  const float* pi = pr + M;
  const bool sc = scratch != nullptr;
  const int first = g.s + g.S * (threadIdx.x >> 5);
  if (first > g.R / 2) cluster_wait();
  for (int u = first; u <= g.R / 2; u += g.S * kWarps) {
    const int v = u == 0 || 2 * u == g.R ? u : g.R - u;
    float2 A[4], B[4], mA[4], mB[4];
    load_row_inv(pr, pi, u, lane, A);
    load_row_inv(pr, pi, v, lane, B);
    if (u == 0) {
      mirror_row0(A, lane, mA);
    } else {
      mirror_row(B, mA);
    }
    mirror_row(A, mB);
    row_inv_glued(g.w128, tw_rows, ab, u, lane, A, mA);
    row_inv_glued(g.w128, tw_rows, ab, v, lane, B, mB);
    if (u == first) cluster_wait();
    scatter_row(cluster, g, sc, u, lane, A);
    if (v != u) scatter_row(cluster, g, sc, v, lane, B);
  }
  cluster_arrive();                       // every row is in its columns
  cluster_wait();
  const float2* z = columns<1, kLanes / kS>(g.a, g.b, g.wr, g.R);
  const float scale = 1.0f / static_cast<float>(M);
  float2* o = out + g.c * n_out + g.s * g.cols;
  for (int t = threadIdx.x; t < static_cast<int>(g.share); t += kThreads) {
    const int i = t / g.cols;
    const int j = t - i * g.cols;
    if (i * kLanes + g.s * g.cols + j < n_out)
      o[i * kLanes + j] = make_float2(z[t].x * scale, z[t].y * scale);
  }
}

// Launch `kernel` over C clusters of S blocks.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int C, int M, int S, bool in_smem,
           void* stream, Args... args) {
  if (C <= 0) return 0;
  if (M % kLanes || M / kLanes < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // the two column buffers (unless in scratch) and the two tables
  const long long smem = (in_smem ? 2LL * M / S : 0) + M / kLanes + kLanes;
  const long long bytes = smem * static_cast<long long>(sizeof(float2));
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch C clusters of S blocks (ops/fft_fused.cluster_size) on
// `stream` and return a cudaError (0 on success; a refused cluster launch
// included). `tw` holds W_R^j (j < R) then W_128^j (j < 128), `tw_rows`
// the four-step twiddles [R, 128] and `ab` the combine table in row order
// (ops/fft_fused._stage_twiddles, _row_twiddles, _ab_rows), all entries of
// the one M-point table e^{-2 pi i j/M}. `scratch` is null (shared
// memory) or [C, 2M] complex, as ops/fft_fused.needs_scratch says. The
// caller allocates the output and checks shapes; nothing here
// synchronises.
extern "C" int bf_fft_fused_fwd(const float2* x, const float2* tw,
                                const float2* tw_rows, const float4* ab,
                                float* out, float2* scratch, int C, int M,
                                int S, void* stream) {
  const bool in_smem = scratch == nullptr;
  switch (S) {
    case 2: return launch(fused_fwd_kernel<2>, C, M, 2, in_smem, stream, x,
                          tw, tw_rows, ab, out, scratch, M);
    case 4: return launch(fused_fwd_kernel<4>, C, M, 4, in_smem, stream, x,
                          tw, tw_rows, ab, out, scratch, M);
    case 8: return launch(fused_fwd_kernel<8>, C, M, 8, in_smem, stream, x,
                          tw, tw_rows, ab, out, scratch, M);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bf_fft_fused_inv(const float* planes, const float2* tw,
                                const float2* tw_rows, const float4* ab,
                                float2* out, float2* scratch, int C, int M,
                                int n_out, int S, void* stream) {
  const bool in_smem = scratch == nullptr;
  switch (S) {
    case 2: return launch(fused_inv_kernel<2>, C, M, 2, in_smem, stream,
                          planes, tw, tw_rows, ab, out, scratch, M, n_out);
    case 4: return launch(fused_inv_kernel<4>, C, M, 4, in_smem, stream,
                          planes, tw, tw_rows, ab, out, scratch, M, n_out);
    case 8: return launch(fused_inv_kernel<8>, C, M, 8, in_smem, stream,
                          planes, tw, tw_rows, ab, out, scratch, M, n_out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
