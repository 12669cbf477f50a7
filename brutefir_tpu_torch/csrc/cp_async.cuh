// cp.async copies into shared memory for the kernels that stage runs
// through a copy pipeline (csrc/mac_group.cu's fused grouped MAC + mix,
// csrc/mac_mix_tiled.cu's bf16 forms), and the card's shared-memory
// limit a block. In an anonymous namespace: each source has its own copy.

#pragma once

#include <cstddef>
#include <cstdint>

namespace {

constexpr size_t kSmemMax = 232448;          // dynamic shared memory a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or nothing where `on` is false.
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"((int)on)
      : "memory");
}

// 4 bytes; zeros where `on` is false (src is not read then).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool on = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 bytes where `on`, else nothing.
__device__ __forceinline__ void cp_async4_if(float* dst, const float* src,
                                             bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"((int)on)
      : "memory");
}

}  // namespace
