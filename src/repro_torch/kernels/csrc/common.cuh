// Helpers shared by the attention kernels: element conversion to f32, a
// rounding store, four consecutive elements loaded as one float4, and
// asynchronous copies from global to shared memory (cp.async).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Masked scores and the running max start here, as in the Pallas kernels:
// a finite sentinel, so exp(NEG - NEG) is 1 and never NaN.
constexpr float NEG = -1e30f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// p[0..3] as f32.  p is aligned to four elements: the wrappers check the
// data pointer and every stride but the last (which is 1).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
// The four int8 of a word as f32, exactly: each byte, offset to unsigned,
// becomes the low mantissa byte of 2^23 (0x4B000000), and one add removes
// 2^23 + 128.  A byte permute and an add, where I2F runs at a quarter of
// the f32 rate.
__device__ __forceinline__ float4 i8x4_to_f32(uint32_t w) {
  constexpr float OFF = 8388736.f;  // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - OFF,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - OFF,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - OFF,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - OFF);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  return i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// acc += p * x, elementwise
__device__ __forceinline__ void axpy4(float p, float4 x, float4& acc) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, through L2 only; zeros where
// !pred (src is then not read, but stays a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}
// 4 bytes global -> shared, asynchronously; zeros where !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace repro_torch
