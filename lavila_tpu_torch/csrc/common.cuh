// Helpers shared by the attention kernels (divided_fwd.cu,
// divided_bwd.cu, divided_big.cu, flash_attention.cu): fp32/bf16
// conversion, warp and quad reductions, the tensor-core product, cp.async
// and the head_dim-64 fragment helpers of the 64-key-tile kernels,
// Hopper's mbarriers, TMA and wgmma, and the two small passes of the
// divided backward kernels (delta and the fixed-order sum of per-group
// partials).

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

// a bf16 pair -> two floats
__device__ __forceinline__ float2 unpack_bf16(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
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

// ---- cp.async: 16 bytes global -> shared without passing through
// registers

// zeros when !valid (src is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes; zeros when !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---- a warp's 16 rows x 64 dims (head_dim 64) on mma.sync: fragments
// of row-major [row][d] operands, tiles in shared memory with rows padded
// by 8 bf16 (144 bytes) so that fragment loads hit 32 distinct banks.
// Used by the 64-key-tile kernels (divided_big.cu, flash_attention.cu).
namespace d64 {

constexpr int kD = 64;
constexpr int kRow = kD + 8;     // bf16 per smem row
constexpr int kChunks = kD / 8;  // 16-byte chunks per row

// The A fragments of a warp's 16 rows x 64 dims: x0 and x1 point at this
// lane's rows g and g + 8 (head slice included); a row that is not `ok`
// reads as zeros.
__device__ __forceinline__ void load_rows(unsigned (&a)[kD / 16][4],
                                          const __nv_bfloat16* x0,
                                          const __nv_bfloat16* x1, bool ok0,
                                          bool ok1, int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = ok0 ? ld32(x0 + c) : 0u;
    a[kk][1] = ok1 ? ld32(x1 + c) : 0u;
    a[kk][2] = ok0 ? ld32(x0 + c + 8) : 0u;
    a[kk][3] = ok1 ? ld32(x1 + c + 8) : 0u;
  }
}

// B fragments of the product with a row-major [k][n] tile (rows k0..k0+15
// of `tile`): for the 8-column blocks 2p and 2p+1, b[0..1] and b[2..3],
// transposed on the way by ldmatrix.
__device__ __forceinline__ void ldsm_b_pair(unsigned (&b)[4],
                                            const __nv_bfloat16* tile, int k0,
                                            int p, int lane) {
  const __nv_bfloat16* src = tile +
                             (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
                             p * 16 + (lane >> 4) * 8;
  const unsigned a = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(a));
}

// acc[16 rows x 64] += A (16 x 16, fragments a) * tile rows k0..k0+15
__device__ __forceinline__ void mma_rows(float (&acc)[kD / 8][4],
                                         const unsigned (&a)[4],
                                         const __nv_bfloat16* tile, int k0,
                                         int lane) {
#pragma unroll
  for (int p = 0; p < kD / 16; ++p) {
    unsigned b[4];
    ldsm_b_pair(b, tile, k0, p, lane);
    mma_16816(acc[2 * p], a, b[0], b[1]);
    mma_16816(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// S (16 rows x 8 columns) = A rows (fragments a, 64 dims) . rows r of a
// [row][d] tile, r = 8*nt + g for this lane
__device__ __forceinline__ void mma_scores(float (&s)[4],
                                           const unsigned (&a)[kD / 16][4],
                                           const __nv_bfloat16* tile, int nt,
                                           int g, int t) {
  s[0] = s[1] = s[2] = s[3] = 0.f;
  const __nv_bfloat16* r = tile + (nt * 8 + g) * kRow + 2 * t;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    mma_16816(s, a[kk], ld32(r + kk * 16), ld32(r + kk * 16 + 8));
}

__device__ __forceinline__ void zero(float (&acc)[kD / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
}

// Store a warp's 16 x 64 result (rows r0 = this lane's g and r0 + 8) as
// bf16 pairs, times mul0/mul1, rows that are not `ok` skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* y0,
                                           __nv_bfloat16* y1, bool ok0,
                                           bool ok1,
                                           const float (&acc)[kD / 8][4],
                                           float mul0, float mul1, int t) {
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (ok0)
      *reinterpret_cast<unsigned*>(y0 + c) =
          pack_bf16(acc[dn][0] * mul0, acc[dn][1] * mul0);
    if (ok1)
      *reinterpret_cast<unsigned*>(y1 + c) =
          pack_bf16(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

}  // namespace d64

// ---- Hopper's asynchronous units (sm_90a): mbarriers, TMA tile loads and
// warpgroup matrix products (wgmma), for the K1 forward (divided_fwd.cu).
namespace sm90 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the TMA unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies still to land
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// TMA: the box at coordinates (c0, c1, c2), innermost first, of the 3-D
// tensor map `map` (a __grid_constant__ kernel parameter) into shared
// memory at dst; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            unsigned long long* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Matrix descriptor of a bf16 tile in shared memory laid out as a
// 128-byte-swizzled TMA box: 128-byte rows, the swizzle's 8-row period
// (1024 bytes) as the stride between row groups. The same descriptor
// serves a K-major operand (rows = M or N, 64 k-values a row; start
// advanced 32 bytes per 16-deep k-step) and an MN-major one (rows = k,
// 64 n-values a row; start advanced 2048 bytes per k-step).
__device__ __forceinline__ unsigned long long sw128_desc(const void* p) {
  return (unsigned long long)((smem_addr(p) & 0x3FFFF) >> 4) |
         (1ull << 16) |                // leading offset: unused here
         ((1024ull >> 4) << 32) |      // stride between 8-row groups
         (1ull << 62);                 // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep registers that an asynchronous wgmma reads or writes in place
// until wgmma_wait_all: the compiler sees the asm as their last writer.
template <int n>
__device__ __forceinline__ void hold(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int n>
__device__ __forceinline__ void hold(unsigned (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define LAVILA_ACC32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define LAVILA_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// D (64 x 64 fp32, the warpgroup's accumulator: thread 32w + 4g + t holds
// rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1 in
// d[4j..4j+3], as mma.sync's m16n8 fragments) += A (64 x 16, K-major, in
// shared memory) * B (16 x 64, K-major, in shared memory); D is not read
// when accumulate is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32],
                                         unsigned long long da,
                                         unsigned long long db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LAVILA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : LAVILA_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A (64 x 16 bf16 in registers, per warp mma.sync's m16n8k16 A
// fragment) * B (16 x 64, MN-major in shared memory: read transposed)
__device__ __forceinline__ void wgmma_rs_tn(float (&d)[32],
                                            const unsigned (&a)[4],
                                            unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LAVILA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : LAVILA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef LAVILA_ACC32
#undef LAVILA_D32

}  // namespace sm90

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
