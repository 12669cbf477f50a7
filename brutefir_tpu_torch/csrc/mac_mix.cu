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
//
// The bf16 operand forms (the entry's ring_bf16 / bank_bf16 flags;
// BRUTEFIR_TPU_RING_DTYPE / BRUTEFIR_TPU_BANK_DTYPE = bf16 on a float32
// graph): the ring and/or the bank (X, H) are bfloat16, staged as they
// are, densely: a bf16 run's 32 bins are 64 bytes, four 16-byte chunks,
// in a slot of that size (the uniform bank tile's too), never a float32
// copy; each lane widens its bin to float32 on the shared-to-register
// read, as the JAX kernels' `.astype` on load. A bf16 form's stage holds
// two partitions, so a round takes half the stages: half the waits and
// block barriers, which set this kernel's time, not its bytes (a first
// bf16 form, one partition a stage in float32-sized slots, was no faster
// than float32 at half the bytes). Its shared memory a block follows the
// operand sizes (smem_bytes; ops/mac_mix.plan mirrors it). The mask, w,
// the sums and the output stay float32. The bf16 forms take the aligned
// path only: K % 8 == 0 and ring and bank 16-byte aligned (every engine
// path: its routes need K % 128 == 0); the wrapper raises ValueError
// elsewhere. The float32 form is the instantiation with X = H = float,
// one partition a stage: the same code as before.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
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


// Stage chunk q of a run of nk values of T at src into its slot dst. The
// aligned path: whole 16-byte chunks (4 float32 or 8 bf16 values), chunk q
// at byte 16 q of the slot; else (float32 only) bf_stage_chunk's skewed
// copies.
template <bool kAligned, class T>
__device__ __forceinline__ void bf_stage_run(float* dst, const T* src,
                                             int nk, int q) {
  if constexpr (kAligned) {
    constexpr int kPer = 16 / sizeof(T);
    if (kPer * q < nk) bf_cp_async16(dst + 4 * q, src + kPer * q);
  } else {
    static_assert(std::is_same_v<T, float>, "unaligned runs: float32 only");
    if (q < bf_run_chunks(src, nk)) bf_stage_chunk(dst, src, nk, q);
  }
}

// Where the run of src was staged in its slot: the slot itself (aligned),
// or past the run's skew (float32 only).
template <bool kAligned, class T>
__device__ __forceinline__ const T* bf_staged(const float* slot,
                                              const T* src) {
  if constexpr (kAligned) {
    return reinterpret_cast<const T*>(slot);
  } else {
    static_assert(std::is_same_v<T, float>, "unaligned runs: float32 only");
    return slot + bf_run_skew(src);
  }
}

// A staged value as float32 (bf16 -> float32 is exact: the 16 bits are
// the top half of the float).
__device__ __forceinline__ float bf_val(const float* p) { return *p; }
__device__ __forceinline__ float bf_val(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
      << 16);
}

constexpr int kMaxWarps = 16;
constexpr int TK = 32;               // bins a block: one a lane
constexpr int kStages = 8;           // stage buffers: kStages - 1 in flight
constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block

// Shared-memory layout, in floats (ops/mac_mix.smem_bytes mirrors it).
constexpr int kRun = TK + 4;         // a float32 run of TK and its skew
// The slot of a run of TK values of T: float32 kRun; bf16 densely, 64
// bytes (always aligned).
template <class T>
__host__ __device__ constexpr int run_floats() {
  return std::is_same_v<T, float> ? kRun : TK * (int)sizeof(T) / 4;
}
// Partitions a stage: 1 in float32, 2 in a bf16 form.
template <class X, class H>
__host__ __device__ constexpr int parts_a_stage() {
  return std::is_same_v<X, float> && std::is_same_v<H, float> ? 1 : 2;
}
// One partition of a warp's item: the ring's two runs, the bank's two
// when streamed, the mask value (padded to 16 bytes).
template <class X, class H, bool kBankSmem>
__host__ __device__ constexpr int part_floats() {
  return 2 * run_floats<X>() + (kBankSmem ? 0 : 2 * run_floats<H>()) + 4;
}
template <class X, class H, bool kBankSmem>
__host__ __device__ constexpr int item_floats() {
  return parts_a_stage<X, H>() * part_floats<X, H, kBankSmem>();
}
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

template <class X, class H, bool kBankSmem>
size_t smem_bytes(int nw, int FC, int F, int B, int C_out) {
  const int chunks = F > FC ? (F + FC - 1) / FC : 1;
  const size_t floats =
      (kBankSmem ? (size_t)B * 2 * run_floats<H>() : 0) +
      (size_t)kStages * nw * item_floats<X, H, kBankSmem>() + round4(F) +
      (size_t)FC * 2 * TK + round4(FC * C_out) +
      (chunks > 1 ? (size_t)C_out * 2 * TK : 0);
  return floats * sizeof(float);
}

// Chunks of 16 bytes a run of T takes at most: kAligned, its TK values
// whole (8 in float32, 4 in bf16); else (float32) with its skew.
template <class T, bool kAligned>
__host__ __device__ constexpr int run_chunks() {
  return kAligned ? TK * (int)sizeof(T) / 16 : kRun / 4;
}

// kAligned: K % 4 == 0 (8 in bf16) and ring and bank 16-byte aligned, so
// every run starts 16-byte aligned and holds whole chunks: no skews, no
// 4-byte ends. X, H: the ring's and the bank's storage types.
template <class X, class H, bool kBankSmem, bool kAligned>
__global__ void __launch_bounds__(32 * kMaxWarps)
mac_mix_kernel(const X* __restrict__ ring, const H* __restrict__ bank,
               const int* __restrict__ coeff_idx,
               const float* __restrict__ mask, const int* __restrict__ t_ptr,
               const float* __restrict__ w, float* __restrict__ out, int F,
               int B, int K, int E, int C_out, int uniform, int FC,
               int has_bin0) {
  constexpr int kRuns = kBankSmem ? 2 : 4;
  constexpr int kPP = parts_a_stage<X, H>();   // partitions a stage
  constexpr int kRX = run_floats<X>(), kRH = run_floats<H>();   // slots
  constexpr int kCX = run_chunks<X, kAligned>();   // chunks a run at most
  constexpr int kCH = run_chunks<H, kAligned>();
  constexpr int kPart = part_floats<X, H, kBankSmem>();
  constexpr int kMask = kPart - 4;             // the mask value's place
  constexpr int kItem = item_floats<X, H, kBankSmem>();
  // copies a partition: the ring's runs, the bank's, the mask value
  constexpr int kJobsP = 2 * kCX + (kBankSmem ? 0 : 2 * kCH) + 1;
  constexpr int kJobs = kPP * kJobsP;          // copies an item, mask last
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
  const int stages = rounds * ((B + kPP - 1) / kPP);

  float* bank_s = sm;                                    // [B][2][kRH]
  float* stage_s = bank_s + (kBankSmem ? B * 2 * kRH : 0);
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
    for (int i = tid; i < 2 * B * kCH; i += nthreads) {
      const int r = i / kCH, q = i - r * kCH;
      bf_stage_run<kAligned>(bank_s + r * kRH,
                             bank + e0 * row + (size_t)r * plane + k0, nk,
                             q);
    }
  }
  __syncthreads();   // e_s

  // A stage's copies are nw x kJobs jobs (a warp's item: kPP partitions
  // of the ring's runs, the bank's runs and the mask value), at most kPer
  // a thread; which jobs a thread takes is the same in every stage.
  constexpr int kPer = (kJobs + 31) / 32;
  const int s0 = ((t % B) + B) % B;            // the slot of partition 0
  int jw[kPer], jd[kPer], jr[kPer], jq[kPer];  // warp, offset, run, chunk
  int jp[kPer];                                // partition of the stage
  const int njobs = nw * kJobs;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * nthreads;
    jw[u] = i < njobs ? i / kJobs : kMaxWarps * 2;   // out of range: none
    int job = i - jw[u] * kJobs;
    jp[u] = kPP == 1 ? 0 : job / kJobsP;
    job -= jp[u] * kJobsP;
    if constexpr (kCX == kCH) {   // every run one size (float32's code)
      jr[u] = job / kCX;                       // kRuns: the mask
      jq[u] = job - jr[u] * kCX;
      jd[u] = jw[u] * kItem + jp[u] * kPart + jr[u] * kRX;
    } else {                                   // the ring's, the bank's
      const bool rng = job < 2 * kCX, msk = job == kJobsP - 1;
      const int j = rng ? job : job - 2 * kCX, c = rng ? kCX : kCH;
      jr[u] = msk ? kRuns : (rng ? 0 : 2) + j / c;
      jq[u] = msk ? 0 : j % c;
      jd[u] = jw[u] * kItem + jp[u] * kPart +
              (msk ? kMask : rng ? jr[u] * kRX : 2 * kRX + (jr[u] - 2) * kRH);
    }
  }
  // the stage issued next: index gi, round gr, (first) partition gb, its
  // ring slot gs
  int gi = 0, gr = 0, gb = 0, gs = s0;
  auto issue = [&]() {
    float* st = stage_s + (gi % kStages) * nw * kItem;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int f = gr * nw + jw[u];
      const int b = gb + jp[u];
      if (jw[u] >= nw || f >= F || (kPP > 1 && b >= B)) continue;
      if (jr[u] == kRuns) {
        bf_cp_async4(st + jd[u], mask + (size_t)(uniform ? 0 : f) * B + b);
        continue;
      }
      const int sl = kPP == 1 || gs >= jp[u] ? gs - jp[u] : gs - jp[u] + B;
      const size_t lane_off = (jr[u] & 1) * plane + k0;
      if constexpr (std::is_same_v<X, H>) {
        const X* src = (jr[u] < 2 ? ring + (f * (size_t)B + sl) * part
                                  : bank + (e_s[f] * (size_t)B + b) * part) +
                       lane_off;
        bf_stage_run<kAligned>(st + jd[u], src, nk, jq[u]);
      } else if (jr[u] < 2) {
        bf_stage_run<kAligned>(
            st + jd[u], ring + (f * (size_t)B + sl) * part + lane_off, nk,
            jq[u]);
      } else {
        bf_stage_run<kAligned>(
            st + jd[u], bank + (e_s[f] * (size_t)B + b) * part + lane_off,
            nk, jq[u]);
      }
    }
    ++gi;
    if constexpr (kPP == 1) {
      gs = gs ? gs - 1 : B - 1;
      if (++gb == B) {
        gb = 0;
        ++gr;
        gs = s0;
      }
    } else {
      gs = gs >= kPP ? gs - kPP : gs - kPP + B;
      if ((gb += kPP) >= B) {
        gb = 0;
        ++gr;
        gs = s0;
      }
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
      const X* rf = ring + f * (size_t)B * part + k0;
      const H* hf = bank + (kBankSmem ? e0 : (f < F ? e_s[f] : 0)) *
                               (size_t)B * part + k0;
      for (int b0 = 0, s0b = s0; b0 < B; b0 += kPP, ++g,
               s0b = kPP == 1 ? (s0b ? s0b - 1 : B - 1)
                              : (s0b >= kPP ? s0b - kPP : s0b - kPP + B)) {
        bf_cp_async_wait<kStages - 2>();   // stage g landed
        __syncthreads();                   // ... for every thread; and
        // stage g - 1's buffer is free again: refill it kStages - 1 ahead
        if (gi < stages) issue();
        bf_cp_async_commit();
        if (f >= F) continue;
#pragma unroll
        for (int p = 0; p < kPP; ++p) {    // partition b, ring slot s
          const int b = b0 + p, s = p == 0 ? s0b : (s0b ? s0b - 1 : B - 1);
          if (kPP > 1 && b >= B) break;
          const float* item =
              stage_s + ((g % kStages) * nw + warp) * kItem + p * kPart;
          const X* rsrc = rf + s * part;
          const X* rre = bf_staged<kAligned>(item, rsrc);
          const X* rim = bf_staged<kAligned>(item + kRX, rsrc + plane);
          const H* hsrc = hf + b * part;
          const float* hslot =
              kBankSmem ? bank_s + 2 * b * kRH : item + 2 * kRX;
          const H* hre = bf_staged<kAligned>(hslot, hsrc);
          const H* him = bf_staged<kAligned>(hslot + kRH, hsrc + plane);
          const float m = item[kMask];
          if (lane < nk) {
            const float rr = bf_val(rre + lane), ri = bf_val(rim + lane);
            const float hr = bf_val(hre + lane) * m,
                        hi = bf_val(him + lane) * m;
            if (has_bin0 && k0 + lane == 0) {
              // packed bin 0: DC and Nyquist are independent real products
              yr += rr * hr;
              yi += ri * hi;
            } else {
              yr += rr * hr - ri * hi;
              yi += rr * hi + ri * hr;
            }
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

template <class X, class H, bool kBankSmem, bool kAligned>
int launch(const X* ring, const H* bank, const int* coeff_idx,
           const float* mask, const int* t, const float* w, float* out,
           int F, int B, int K, int E, int C_out, int uniform, int nw, int FC,
           int has_bin0, cudaStream_t s) {
  const size_t bytes = smem_bytes<X, H, kBankSmem>(nw, FC, F, B, C_out);
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    // raise the kernel's limit once per device to the most it was asked
    static size_t granted[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (bytes > granted[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          mac_mix_kernel<X, H, kBankSmem, kAligned>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      granted[dev] = bytes;
    }
  }
  const int grid = (K + TK - 1) / TK;
  mac_mix_kernel<X, H, kBankSmem, kAligned><<<grid, 32 * nw, bytes, s>>>(
      ring, bank, coeff_idx, mask, t, w, out, F, B, K, E, C_out, uniform, FC,
      has_bin0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan the kernel does not take: nw warps
// (4-16), FC a positive multiple of nw, the bank tile in shared memory only
// in the uniform form, shared memory within 227 KB. `has_bin0`: 1 where
// local bin 0 is the packed DC/Nyquist bin (an unsharded call, the first
// bin shard of a mesh), else 0, and bin 0 is an ordinary complex product.
// ring_bf16 / bank_bf16: 1 where that operand is bfloat16, else float32
// (both 0: the float32 form); a bf16 form takes the aligned path only,
// cudaErrorInvalidValue unless K % 8 == 0 and ring and bank are 16-byte
// aligned. The plan (nw, FC, bank_smem) is ops/mac_mix.plan's for the
// operands' sizes. The caller allocates `out` and checks shapes; nothing
// here synchronises.
extern "C" int bf_mac_mix(const void* ring, const void* bank,
                          const int* coeff_idx, const float* mask,
                          const int* t, const float* w, float* out, int F,
                          int B, int K, int E, int C_out, int uniform, int nw,
                          int FC, int bank_smem, int has_bin0, int ring_bf16,
                          int bank_bf16, void* stream) {
  if (K <= 0 || C_out <= 0) return 0;
  if (nw < 4 || nw > kMaxWarps || FC <= 0 || FC % nw || B <= 0 || E <= 0 ||
      (bank_smem && !uniform))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a16 = reinterpret_cast<uintptr_t>(ring) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bank) % 16 == 0;
  const bool bf16 = ring_bf16 || bank_bf16;
  if (bf16 && (K % 8 || !a16)) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = K % 4 == 0 && a16;
  using bf = __nv_bfloat16;
#define BF_LAUNCH(X, H, BANK, ALIGNED)                                      \
  return launch<X, H, BANK, ALIGNED>(                                       \
      static_cast<const X*>(ring), static_cast<const H*>(bank), coeff_idx,  \
      mask, t, w, out, F, B, K, E, C_out, uniform, nw, FC, has_bin0, s)
#define BF_LAUNCH_BF16(X, H)                                                \
  do {                                                                      \
    if (bank_smem) BF_LAUNCH(X, H, true, true);                             \
    BF_LAUNCH(X, H, false, true);                                           \
  } while (0)
  if (ring_bf16 && bank_bf16) BF_LAUNCH_BF16(bf, bf);
  if (ring_bf16) BF_LAUNCH_BF16(bf, float);
  if (bank_bf16) BF_LAUNCH_BF16(float, bf);
  if (bank_smem) {
    if (aligned) BF_LAUNCH(float, float, true, true);
    BF_LAUNCH(float, float, true, false);
  }
  if (aligned) BF_LAUNCH(float, float, false, true);
  BF_LAUNCH(float, float, false, false);
#undef BF_LAUNCH_BF16
#undef BF_LAUNCH
}
