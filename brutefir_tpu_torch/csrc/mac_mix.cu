// Fused partitioned spectral MAC + output mix, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels `_mac_mix_kernel_rowmajor` and
// `_mac_mix_kernel_uniform` (brutefir_tpu/ops/pallas_mac.py:582-643,
// called through `pallas_spectral_mac_mix`). One kernel, two forms:
//   uniform = 1: every filter reads bank row coeff_idx[0] and mask row 0;
//   uniform = 0: filter f reads bank row coeff_idx[f] and mask row f.
//
// What it computes, per packed bin k (planes 0 = re, 1 = im):
//   Y_f[k]     = sum_{b=0}^{B-1} ring[f, (t-b)%B, :, k] (x) bank[e_f, b, :, k] * mask[f, b]
//   out[c,:,k] = sum_{f=0}^{F-1} w[c, f] * Y_f[k]
// where (x) is a complex multiply, except at bin 0: there DC (plane 0)
// and Nyquist (plane 1) are two independent real products (the d1s/d2s
// rule of the reference, pallas_mac.py:291-299). Y_f never reaches device
// memory, which is the point of the fused TPU kernel. Sums run b = 0..B-1
// within Y_f, then f = 0..F-1 in the mix, in FP32 with FMA (never TF32),
// like the TPU kernel: no atomics, no reduction across blocks, the same
// result from run to run. Bank indices are clamped into [0, E) like the
// TPU gather, so a bad index cannot read out of bounds.
//
// Layout: ring [F, B, 2, K], bank [E, B, 2, K], coeff_idx [F] int32,
// mask [F, B], t a device int32 scalar (read here, so the host never
// synchronises on it), w [C_out, F], out [C_out, 2, K]; all float32,
// contiguous. The caller wrote the current block into the ring first.
//
// What bounds it on an H100: bytes. At the massive shape (F = C_out = 26,
// B = 16, K = 8192) a call streams the 27 MB ring, one 1 MB bank row and
// writes a 1.7 MB output: about 30 MB, 9 us at 3.35 TB/s. A first form
// (one thread a bin, 128 blocks of two warps, the F x B chain of loads
// serial in each thread) kept too few loads in flight: it was latency
// bound at about 0.29 TB/s, and above 32 outputs it accumulated in `out`
// in device memory. To stream at the card's rate an SM needs some 25-30 KB
// in flight (its share of 3.35 TB/s times a device-memory latency), and
// the instructions that keep it in flight must be few. Tensor cores do
// not serve here: the products are FP32 elementwise complex MACs and the
// mix is a small FP32 sum (TF32 would round it).
//
// Design. A block of nw warps (4-16) owns a tile of TK = 32 bins (lane l
// owns bin l). Round r gives filter r * nw + w to warp w; the block walks
// the rounds, and in each the partitions b = 0..B-1, as one
// pipeline of stages: stage (r, b) holds, for each warp's filter, the re
// and im runs of TK floats of ring[f, (t-b)%B] (K apart), the bank's runs
// beside them in the per-filter form, and the mask value. All threads
// issue a stage's 16-byte cp.async copies together (the helpers below),
// kStages - 1 stages ahead, and pass one block barrier a stage; each warp
// then MACs its item from shared memory into registers. Which copies a
// thread issues is fixed for the whole kernel, and the stage's round,
// partition and ring slot are counters: no division on the way. Where K is
// a multiple of 4 and ring and bank are 16-byte aligned (every path of the
// engine), each run is whole 16-byte chunks and no skew is computed; else
// a run's unaligned ends are copied 4 bytes at a time. In the uniform
// form the bank tile [B, 2, TK] is staged once a block and read by every
// filter. Filters come in chunks of FC (R rounds): at the end of a round
// each warp's Y_f tile goes to shared memory, and at the end of a chunk
// the block mixes it from there (w's chunk is there too): each thread owns
// (c, plane, bin) outputs and runs the FMA chain over the chunk's filters
// in order. With one chunk the sums go straight to `out`; with more, the
// running sums stay in a shared-memory out tile between chunks. nw, FC and
// whether the uniform bank tile fits shared memory come from
// ops/mac_mix.plan, whose byte count is smem_bytes below. Forms measured
// slower on the card and gone: each warp running its own copy pipeline
// (more issue slots on addresses, waits and warp barriers than on MACs),
// 64-bin tiles (half the blocks), and deeper stage rings (no faster at 12
// stages, fewer blocks an SM at 16).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Asynchronous copies from device memory into shared memory (cp.async). A
// "run" is n consecutive floats at `src` in device memory. It is staged
// into a 16-byte aligned shared-memory buffer in chunks of 16 bytes that
// are aligned in device memory, so src[i] lands at dst[bf_run_skew(src) + i]
// (the skew is 0-3 floats). A chunk that lies wholly inside the run is one
// 16-byte copy; a chunk at an unaligned end of the run copies its floats
// that lie inside the run 4 bytes at a time, so nothing outside the run is
// read. A run of up to `cap` floats (cap a multiple of 4) needs a buffer
// of cap + 4 floats.

__device__ __forceinline__ uint32_t bf_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bf_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   bf_smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void bf_cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   bf_smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void bf_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void bf_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int bf_run_skew(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
}

// Number of 16-byte chunks of the run (src, n).
__device__ __forceinline__ int bf_run_chunks(const float* src, int n) {
  return n > 0 ? (bf_run_skew(src) + n + 3) >> 2 : 0;
}

// Issue the copy of chunk q of the run (src, n) into dst.
__device__ __forceinline__ void bf_stage_chunk(float* dst, const float* src,
                                               int n, int q) {
  const int skew = bf_run_skew(src);
  const int i0 = 4 * q - skew;                // the chunk's first float
  if (i0 >= 0 && i0 + 4 <= n) {
    bf_cp_async16(dst + 4 * q, src + i0);
    return;
  }
  for (int i = max(i0, 0); i < min(i0 + 4, n); ++i)
    bf_cp_async4(dst + skew + i, src + i);
}


constexpr int kMaxWarps = 16;
constexpr int TK = 32;               // bins a block: one a lane
constexpr int kStages = 8;           // stage buffers: kStages - 1 in flight
constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block

// Shared-memory layout, in floats (ops/mac_mix.smem_bytes mirrors it).
constexpr int kRun = TK + 4;         // a run of TK floats and its skew
__host__ __device__ constexpr int item_floats(bool bank_smem) {
  return (bank_smem ? 2 : 4) * kRun + 4;
}
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

size_t smem_bytes(int nw, int FC, int F, int B, int C_out, bool bank_smem) {
  const int chunks = F > FC ? (F + FC - 1) / FC : 1;
  const size_t floats =
      (bank_smem ? (size_t)B * 2 * kRun : 0) +
      (size_t)kStages * nw * item_floats(bank_smem) + round4(F) +
      (size_t)FC * 2 * TK + round4(FC * C_out) +
      (chunks > 1 ? (size_t)C_out * 2 * TK : 0);
  return floats * sizeof(float);
}

// kAligned: K % 4 == 0 and ring and bank 16-byte aligned, so every run
// starts 16-byte aligned and holds whole chunks: no skews, no 4-byte ends.
template <bool kBankSmem, bool kAligned>
__global__ void __launch_bounds__(32 * kMaxWarps)
mac_mix_kernel(const float* __restrict__ ring, const float* __restrict__ bank,
               const int* __restrict__ coeff_idx,
               const float* __restrict__ mask, const int* __restrict__ t_ptr,
               const float* __restrict__ w, float* __restrict__ out, int F,
               int B, int K, int E, int C_out, int uniform, int FC) {
  constexpr int kRuns = kBankSmem ? 2 : 4;
  constexpr int kItem = item_floats(kBankSmem);
  constexpr int kCq = (kAligned ? TK : kRun) / 4;   // chunks a run at most
  constexpr int kJobs = kRuns * kCq + 1;       // copies an item, mask last
  extern __shared__ __align__(16) float sm[];
  const int nthreads = blockDim.x, nw = nthreads >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * TK;
  const int nk = min(TK, K - k0);
  const int t = *t_ptr;
  const size_t plane = (size_t)K;              // re -> im plane
  const size_t part = 2 * (size_t)K;           // one partition
  const size_t row = (size_t)B * part;         // one filter / bank entry
  const int chunks = F > FC ? (F + FC - 1) / FC : 1;
  const int rounds = (F + nw - 1) / nw;
  const int per_chunk = FC / nw;               // rounds a chunk
  const int stages = rounds * B;

  float* bank_s = sm;                                    // [B][2][kRun]
  float* stage_s = bank_s + (kBankSmem ? B * 2 * kRun : 0);
  int* e_s = reinterpret_cast<int*>(stage_s + kStages * nw * kItem);  // [F]
  float* ys = reinterpret_cast<float*>(e_s) + round4(F);   // [FC][2][TK]
  float* ws = ys + FC * 2 * TK;                            // [FC][C_out]
  float* out_s = ws + round4(FC * C_out);                  // [C_out][2][TK]

  // the bank rows, clamped (the uniform form: row 0's for all)
  for (int f = tid; f < F; f += nthreads)
    e_s[f] = min(max(coeff_idx[uniform ? 0 : f], 0), E - 1);
  const int e0 = F > 0 ? min(max(coeff_idx[0], 0), E - 1) : 0;
  // the uniform bank tile, with stage 0's copies
  if (kBankSmem) {
    for (int i = tid; i < 2 * B * kCq; i += nthreads) {
      const int r = i / kCq, q = i - r * kCq;
      const float* src = bank + e0 * row + (size_t)r * plane + k0;
      if (q < bf_run_chunks(src, nk))
        bf_stage_chunk(bank_s + r * kRun, src, nk, q);
    }
  }
  __syncthreads();   // e_s

  // A stage's copies are nw x kJobs jobs (a warp's item: kRuns runs of
  // kCq chunks, then the mask value), at most kPer a thread; which jobs a
  // thread takes is the same in every stage.
  constexpr int kPer = (kJobs + 31) / 32;
  const int s0 = ((t % B) + B) % B;            // the slot of partition 0
  int jw[kPer], jd[kPer], jr[kPer], jq[kPer];  // warp, offset, run, chunk
  const int njobs = nw * kJobs;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * nthreads;
    jw[u] = i < njobs ? i / kJobs : kMaxWarps * 2;   // out of range: none
    const int job = i - jw[u] * kJobs;
    jr[u] = job / kCq;                         // kRuns: the mask
    jq[u] = job - jr[u] * kCq;
    jd[u] = jw[u] * kItem + jr[u] * kRun;
  }
  // the stage issued next: index gi, round gr, partition gb, ring slot gs
  int gi = 0, gr = 0, gb = 0, gs = s0;
  auto issue = [&]() {
    float* st = stage_s + (gi % kStages) * nw * kItem;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int f = gr * nw + jw[u];
      if (jw[u] >= nw || f >= F) continue;
      if (jr[u] == kRuns) {
        bf_cp_async4(st + jd[u], mask + (size_t)(uniform ? 0 : f) * B + gb);
        continue;
      }
      const float* src =
          (jr[u] < 2 ? ring + (f * (size_t)B + gs) * part
                     : bank + (e_s[f] * (size_t)B + gb) * part) +
          (jr[u] & 1) * plane + k0;
      if (kAligned) {
        if (4 * jq[u] < nk)
          bf_cp_async16(st + jd[u] + 4 * jq[u], src + 4 * jq[u]);
      } else if (jq[u] < bf_run_chunks(src, nk)) {
        bf_stage_chunk(st + jd[u], src, nk, jq[u]);
      }
    }
    ++gi;
    gs = gs ? gs - 1 : B - 1;
    if (++gb == B) {
      gb = 0;
      ++gr;
      gs = s0;
    }
  };
#pragma unroll 1
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < stages) issue();
    bf_cp_async_commit();
  }

  float yr = 0.f, yi = 0.f;
  int g = 0;
  for (int ch = 0; ch < chunks; ++ch) {
    const int f0 = ch * FC;
    const int fc = max(0, min(FC, F - f0));
    for (int i = tid; i < fc * C_out; i += nthreads) {
      const int fl = i / C_out, c = i - fl * C_out;
      ws[i] = w[(size_t)c * F + f0 + fl];
    }
    const int r1 = min(rounds, (ch + 1) * per_chunk);
    for (int r = ch * per_chunk; r < r1; ++r) {
      const int f = r * nw + warp;     // this warp's filter of the round
      const float* rf = ring + f * (size_t)B * part + k0;
      const float* hf = bank + (kBankSmem ? e0 : (f < F ? e_s[f] : 0)) *
                                   (size_t)B * part + k0;
      for (int b = 0, s = s0; b < B; ++b, ++g, s = s ? s - 1 : B - 1) {
        bf_cp_async_wait<kStages - 2>();   // stage g landed
        __syncthreads();                   // ... for every thread; and
        // stage g - 1's buffer is free again: refill it kStages - 1 ahead
        if (gi < stages) issue();
        bf_cp_async_commit();
        if (f >= F) continue;
        const float* item = stage_s + ((g % kStages) * nw + warp) * kItem;
        const float* rsrc = rf + s * part;
        const float* rre = item + (kAligned ? 0 : bf_run_skew(rsrc));
        const float* rim =
            item + kRun + (kAligned ? 0 : bf_run_skew(rsrc + plane));
        const float* hsrc = hf + b * part;
        const float* hre = kBankSmem ? bank_s + 2 * b * kRun : item + 2 * kRun;
        const float* him =
            hre + kRun + (kAligned ? 0 : bf_run_skew(hsrc + plane));
        hre += kAligned ? 0 : bf_run_skew(hsrc);
        const float m = item[kRuns * kRun];
        if (lane < nk) {
          const float rr = rre[lane], ri = rim[lane];
          const float hr = hre[lane] * m, hi = him[lane] * m;
          if (k0 + lane == 0) {
            // packed bin 0: DC and Nyquist are independent real products
            yr += rr * hr;
            yi += ri * hi;
          } else {
            yr += rr * hr - ri * hi;
            yi += rr * hi + ri * hr;
          }
        }
      }
      if (f < F) {
        float* y = ys + (f - f0) * 2 * TK;
        y[lane] = yr;
        y[TK + lane] = yi;
        yr = yi = 0.f;
      }
    }
    __syncthreads();
    // the mix of the chunk, f in order, from shared memory
    const bool last = ch == chunks - 1;
    for (int i = tid; i < C_out * 2 * TK; i += nthreads) {
      const int c = i / (2 * TK), p = (i / TK) & 1, kk = i % TK;
      float acc = ch ? out_s[i] : 0.f;
      for (int fl = 0; fl < fc; ++fl)
        acc = fmaf(ws[fl * C_out + c], ys[(2 * fl + p) * TK + kk], acc);
      if (!last)
        out_s[i] = acc;
      else if (kk < nk)
        out[c * part + p * plane + k0 + kk] = acc;
    }
    __syncthreads();
  }
}

template <bool kBankSmem, bool kAligned>
int launch(const float* ring, const float* bank, const int* coeff_idx,
           const float* mask, const int* t, const float* w, float* out,
           int F, int B, int K, int E, int C_out, int uniform, int nw, int FC,
           cudaStream_t s) {
  const size_t bytes = smem_bytes(nw, FC, F, B, C_out, kBankSmem);
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    // raise the kernel's limit once per device to the most it was asked
    static size_t granted[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (bytes > granted[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          mac_mix_kernel<kBankSmem, kAligned>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      granted[dev] = bytes;
    }
  }
  const int grid = (K + TK - 1) / TK;
  mac_mix_kernel<kBankSmem, kAligned><<<grid, 32 * nw, bytes, s>>>(
      ring, bank, coeff_idx, mask, t, w, out, F, B, K, E, C_out, uniform, FC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan the kernel does not take: nw warps
// (4-16), FC a positive multiple of nw, the bank tile in shared memory only
// in the uniform form, shared memory within 227 KB. The caller allocates
// `out` and checks shapes; nothing here synchronises.
extern "C" int bf_mac_mix(const float* ring, const float* bank,
                          const int* coeff_idx, const float* mask,
                          const int* t, const float* w, float* out, int F,
                          int B, int K, int E, int C_out, int uniform, int nw,
                          int FC, int bank_smem, void* stream) {
  if (K <= 0 || C_out <= 0) return 0;
  if (nw < 4 || nw > kMaxWarps || FC <= 0 || FC % nw || B <= 0 || E <= 0 ||
      (bank_smem && !uniform))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = K % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(ring) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(bank) % 16 == 0;
#define BF_LAUNCH(BANK, ALIGNED)                                            \
  return launch<BANK, ALIGNED>(ring, bank, coeff_idx, mask, t, w, out, F, B, \
                               K, E, C_out, uniform, nw, FC, s)
  if (bank_smem) {
    if (aligned) BF_LAUNCH(true, true);
    BF_LAUNCH(true, false);
  }
  if (aligned) BF_LAUNCH(false, true);
  BF_LAUNCH(false, false);
#undef BF_LAUNCH
}
