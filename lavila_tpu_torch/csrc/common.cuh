// Helpers shared by the divided-attention kernels (divided_fwd.cu,
// divided_bwd.cu, divided_big.cu): fp32/bf16 conversion, warp and quad
// reductions, the tensor-core product, and the two small passes of the
// backward kernels (delta and the fixed-order sum of per-group partials).

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

// max / sum over the 4 lanes of a quad, which share one mma fragment row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// Kernels used by more than one source: internal linkage, so every source
// that includes this header compiles its own copy.
namespace {

// delta[i] = sum over the d dims of row i of dO * O (one row = one token's
// head): one thread per (token, head).
template <typename T>
__global__ void delta_kernel(const T* __restrict__ dout,
                             const T* __restrict__ out,
                             float* __restrict__ delta, long long n, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* g = dout + i * d;
  const T* o = out + i * d;
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(to_float(g[c]), to_float(o[c]), s);
  delta[i] = s;
}

template <typename T>
cudaError_t launch_delta(const void* dout, const void* out, void* delta,
                         long long rows, int d, cudaStream_t stream) {
  delta_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      (const T*)dout, (const T*)out, (float*)delta, rows, d);
  return cudaGetLastError();
}

// out[b, c] = sum over g of part[b, g, c], in order g = 0..G-1: the
// second, deterministic pass over the per-group partials of dck/dcv.
template <typename T>
__global__ void sum_groups_kernel(const float* __restrict__ part_k,
                                  const float* __restrict__ part_v,
                                  T* __restrict__ dck, T* __restrict__ dcv,
                                  int B, int G, long long D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * D) return;
  const long long b = i / D, c = i - b * D;
  float ak = 0.f, av = 0.f;
  for (int g = 0; g < G; ++g) {
    ak += part_k[(b * G + g) * D + c];
    av += part_v[(b * G + g) * D + c];
  }
  dck[i] = from_float<T>(ak);
  dcv[i] = from_float<T>(av);
}

template <typename T>
cudaError_t launch_sum_groups(const float* part_k, const float* part_v,
                              void* dck, void* dcv, int B, int G, long long D,
                              cudaStream_t stream) {
  const long long n = (long long)B * D;
  sum_groups_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part_k, part_v, (T*)dck, (T*)dcv, B, G, D);
  return cudaGetLastError();
}

}  // namespace

}  // namespace lavila
