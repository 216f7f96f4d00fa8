// Helpers shared by the divided-attention kernels (divided_fwd.cu,
// divided_bwd.cu): fp32/bf16 conversion and warp reductions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace lavila {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- bf16 tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate)

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// D += A (16x16 bf16, row-major) * B (16x8 bf16, col-major), fp32 D.
// Fragment layouts are PTX's: lane = 4*g + t holds rows g and g+8,
// columns 2t, 2t+1 (+8).
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor-core kernels move bf16 pairs: every pointer 4-byte aligned
// and every row stride even.
inline bool bf16_pairs_ok(std::initializer_list<const void*> ptrs,
                          std::initializer_list<long long> strides) {
  for (const void* p : ptrs)
    if ((unsigned long long)p & 3ull) return false;
  for (long long s : strides)
    if (s & 1ll) return false;
  return true;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per
// kernel; the call is cheap, so launchers make it every time.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace lavila
