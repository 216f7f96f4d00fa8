// Helpers shared by the attention kernels (divided_fwd.cu,
// divided_bwd.cu, divided_big.cu, flash_attention.cu) and the LayerNorm
// backward (layernorm_bwd.cu: conversion, warp sums, mbarriers, bulk
// copies): fp32/bf16 conversion, warp and quad reductions, the
// tensor-core product, cp.async and the head_dim-64 fragment helpers of
// K8's split backward (past 128 tokens), Hopper's mbarriers, TMA copies,
// the refilled ring of tiles, wgmma and the tensor map of a row view (the
// spatial phase's tensor-core kernels, shared by K1 and K6, declared
// below; K7/K8's TMA kernels), and the fixed-order sum of the divided
// backward kernels' per-group partials.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <initializer_list>
#include <type_traits>

namespace lavila {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The divided phases' SIMT backward (divided_bwd.cu, divided_big.cu) takes
// delta = rowsum(dO * O) from the forward's O where O is fp32, the Pallas
// kernels' form, and rowsum(P * dP) over the P it recomputes in bf16,
// where O's rounding leaves a residue that dq = dS K keeps at near-copy
// keys (divided_bwd.cu says how large).
template <typename T>
constexpr bool kDeltaFromOut = std::is_same<T, float>::value;

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
// Used by K8's split dq and dk/dv kernels (flash_attention.cu).
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

// ---- Hopper's asynchronous units (sm_90a): mbarriers, TMA copies and
// warpgroup matrix products (wgmma), and the pieces of the spatial
// phase's tensor-core kernels (K1 and K6 share them: divided_fwd.cu,
// divided_bwd.cu) built on them: 64 x 64 bf16 tiles of 128-byte rows,
// 128-byte swizzled as TMA writes them, a warpgroup of 128 threads
// owning 64 rows.
namespace sm90 {

constexpr int kD = 64;     // head_dim
constexpr int kTile = 64;  // rows of a tile: queries or keys
constexpr int kTileElems = kTile * kD;
constexpr unsigned kTileBytes = kTileElems * 2;  // 8 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the first 1024-byte boundary (the 128-byte swizzle's period) at or past
// p: where a kernel's dynamic shared memory puts its first tile
__device__ __forceinline__ __nv_bfloat16* align1024(void* p) {
  return reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<unsigned long long>(p) + 1023) & ~1023ull);
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

// one plain arrival
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
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

// Order this thread's generic writes to shared memory before the TMA
// unit's reads of it (a tma_store_3d that follows).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: shared memory at src (laid out as map's box) to the box at
// coordinates (c0, c1, c2) of `map`; box elements past the tensor's ends
// are not written. Returns once the copy has read shared memory.
__device__ __forceinline__ void tma_store_3d(const void* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(map),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// a contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A ring of S slots that one producer thread refills by TMA while the
// consumer warpgroups use them: tile t lives in slot t % S. Each slot has
// a `full` barrier (the copies' bytes) and an `empty` one on which every
// thread of every live consumer warpgroup arrives once it is done with
// the slot; the producer waits on `empty` before it refills. With at
// most S tiles no slot is refilled and nobody waits on `empty`.
template <int S>
struct Ring {
  unsigned long long full[S], empty[S];

  // by one thread, before the block's first __syncthreads
  __device__ __forceinline__ void init(unsigned consumers) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
  }
  // producer: the barrier to load tile t on, once its slot is free
  __device__ __forceinline__ unsigned long long* acquire(int t) {
    if (t >= S) mbar_wait(&empty[t % S], ((t / S) - 1) & 1);
    return &full[t % S];
  }
  // consumers: until tile t has landed (the warp converged again for
  // wgmma's .aligned instructions); then release it
  __device__ __forceinline__ void wait(int t) {
    mbar_wait(&full[t % S], (t / S) & 1);
    __syncwarp();
  }
  __device__ __forceinline__ void release(int t) { mbar_arrive(&empty[t % S]); }
};

// Element (r, c) of a 64 x 64 bf16 tile written by TMA with the 128-byte
// swizzle: 16-byte chunk c/8 of row r sits at chunk (c/8) ^ (r % 8).
__device__ __forceinline__ char* swizzled(const void* tile, int r, int c) {
  return const_cast<char*>(static_cast<const char*>(tile)) + r * 128 +
         (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// the bf16 pair (c, c + 1) of row r of a swizzled tile, as floats
__device__ __forceinline__ float2 tile_pair(const void* tile, int r, int c) {
  return unpack_bf16(*reinterpret_cast<const unsigned*>(swizzled(tile, r, c)));
}

// the 128 threads of warpgroup `wg` wait for each other (named barrier
// 1 + wg; 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
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
// until at most n of the warpgroup's committed wgmma groups are still
// running (groups finish in the order they were committed)
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// 2^x by the SFU (ex2.approx: ~2 ulp, denormals flushed; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// D = A (64 x 64 in tile a, K-major) * B^T (tile b, K-major: its rows are
// D's columns), over the 4 k-steps of head_dim 64; committed, not waited
__device__ __forceinline__ void wgmma_tile_ss(float (&d)[32], const void* a,
                                              const void* b) {
  const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
  const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(b);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(d, sw128_desc(pa + 16 * kk), sw128_desc(pb + 16 * kk), kk);
}

// D += A (64 x 64 bf16 in registers: the A fragments of 4 k-steps) * B
// (tile b, MN-major: its 64 rows are the k index)
__device__ __forceinline__ void wgmma_tile_rs(float (&d)[32],
                                              const unsigned (&a)[kD / 16][4],
                                              const void* b) {
  const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(b);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs_tn(d, a[kk], sw128_desc(pb + 16 * kk * kD));
}

// An fp32 accumulator rounded to bf16 as the A fragments of the product
// with its columns as the k index (columns 16kk..16kk+15 are the
// accumulator's blocks 2kk and 2kk+1)
__device__ __forceinline__ void acc_to_a(unsigned (&a)[kD / 16][4],
                                         const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Store warpgroup wg's accumulator (this thread's rows r0 and r0 + 8
// times mul0 / mul1) as bf16 rows row0.. of dst (row stride ld), rows at
// or past `rows` skipped: through `tile` (a swizzled tile that no wgmma
// reads any more) to 16-byte row-contiguous stores.
__device__ __forceinline__ void store_tile(void* tile, const float (&o)[32],
                                           float mul0, float mul1,
                                           __nv_bfloat16* dst, long long ld,
                                           int row0, int rows, int wg) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  wg_sync(wg);  // every product of the warpgroup is done with the tile
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t4;
    *reinterpret_cast<unsigned*>(swizzled(tile, r0, c)) =
        pack_bf16(o[4 * j] * mul0, o[4 * j + 1] * mul0);
    *reinterpret_cast<unsigned*>(swizzled(tile, r0 + 8, c)) =
        pack_bf16(o[4 * j + 2] * mul1, o[4 * j + 3] * mul1);
  }
  wg_sync(wg);
  for (int i = threadIdx.x & 127; i < kTile * kD / 8; i += 128) {
    const int r = i >> 3, c = (i & 7) * 8;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * ld + c) =
          *reinterpret_cast<const uint4*>(swizzled(tile, r, c));
  }
}

// cuTensorMapEncodeTiled from the libcuda the process already loaded
// (it is not linked: the library is loaded next to PyTorch's own)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
  }();
  return fn;
}

// The (frames, N rows, D columns) bf16 row view at p with row stride rs
// elements, as a 3-D tensor map with a 64 x box_rows x 1 box (a head's 64
// columns of box_rows rows of one frame; at most 256), 128-byte swizzle;
// rows past N read as zeros. p must be 16-byte aligned and rs a multiple
// of 8.
inline bool rows_map(CUtensorMap* map, const void* p, long long rs, int D,
                     int N, int frames, int box_rows = kTile) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N,
                              (cuuint64_t)frames};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 2,
                                 (cuuint64_t)rs * 2 * N};
  const cuuint32_t box[3] = {kD, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((unsigned long long)p & 15ull) return false;
  return true;
}

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

// ---- the temporal phase's slab kernels (K2 on the tensor cores:
// divided_fwd.cu, divided_bwd.cu). A tile is `span` = 16 / F positions
// n0 .. n0 + span - 1 of one clip, all F frames, for G heads: 16 rows,
// row r = f * span + p holding frame f of position n0 + p (rows past
// F * span or positions past N are zeros). Each tensor's tile is one
// slab in shared memory, a row's G * 64 columns (G * 128 bytes) padded by
// 16 bytes, so that the 8 rows an ldmatrix reads start 4 banks apart.
// One warp owns one head: its 16 rows are the m16 of mma.sync m16n8k16,
// and the tile's 16 rows are also its keys, masked block-diagonally
// (query and key at one position); the CLS key is a 17th column kept out
// of the products.
namespace tslab {

constexpr int kD = 64;     // head_dim
constexpr int kRows = 16;  // rows of a tile
constexpr int kMaxFrames = kRows;

template <int G>
struct Geo {
  static constexpr int kCols = G * kD;             // bf16 a row
  static constexpr int kLd = kCols + 8;            // padded row
  static constexpr int kElems = kRows * kLd;       // one tensor's slab
  static constexpr int kChunks = kCols / 8;        // 16-byte copies a row
  static constexpr size_t kBytes = kElems * 2;
};

// heads a block: 4 where they divide H (2 timed within 1-3% of it at
// the three shapes of scripts/time_library_calls.py, NVIDIA H100 80GB
// HBM3 at 700 W), else 2, else 1
inline int heads_per_block(int H) { return H % 4 == 0 ? 4 : H % 2 ? 1 : 2; }

// Where a tile's rows come from: tile `tile` of clip b (positions n0 =
// tile * span ..), row r < 16 holding frame r / span of position n0 + r %
// span. r / span is (r * mul) >> 8 with mul = ceil(256 / span), exact for
// r < 16, so no row costs an integer division.
struct Tile {
  int F, N, span, mul, n0, b;
  __device__ __forceinline__ Tile(int F_, int N_, int tile, int b_)
      : F(F_), N(N_), span(kRows / F_), mul((256 + span - 1) / span),
        n0(tile * span), b(b_) {}
  __device__ __forceinline__ int frame(int r) const { return (r * mul) >> 8; }
  __device__ __forceinline__ int pos(int r) const {
    return r - frame(r) * span;
  }
  __device__ __forceinline__ bool valid(int r) const {
    return r < F * span && n0 + pos(r) < N;
  }
  // the row index of row r in the (B, F, N) rows
  __device__ __forceinline__ long long row(int r) const {
    return ((long long)b * F + frame(r)) * N + n0 + pos(r);
  }
};

// The rows a thread copies in and out: the block's G warps move a
// tensor's 16 rows x G * 8 chunks of 16 bytes, a thread chunk c of rows
// r0, r0 + 4, r0 + 8, r0 + 12 (r0 < 4), the same in every tensor.
template <int G>
struct Rows {
  static constexpr int kChunks = Geo<G>::kChunks;
  int r0, c;
  long long at[4];  // row index in the (B, F, N) rows; 0 where invalid
  bool ok[4];
  __device__ __forceinline__ explicit Rows(const Tile& t)
      : r0(threadIdx.x / kChunks), c((threadIdx.x % kChunks) * 8) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ok[k] = t.valid(r0 + 4 * k);
      at[k] = ok[k] ? t.row(r0 + 4 * k) : 0;
    }
  }
};

// One tensor's slab: 16-byte cp.async copies of the tile's rows, columns
// col0 .. col0 + G * 64 of rows rs elements apart; invalid rows zero.
template <int G>
__device__ __forceinline__ void load(__nv_bfloat16* dst,
                                     const __nv_bfloat16* src, long long rs,
                                     const Rows<G>& w, int col0) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    cp_async16(dst + (w.r0 + 4 * k) * Geo<G>::kLd + w.c,
               src + w.at[k] * rs + col0 + w.c, w.ok[k]);
}

// The slab's valid rows to rows rs elements apart, 16 bytes a store.
template <int G>
__device__ __forceinline__ void store(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long rs,
                                      const Rows<G>& w, int col0) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (w.ok[k])
      *reinterpret_cast<uint4*>(dst + w.at[k] * rs + col0 + w.c) =
          *reinterpret_cast<const uint4*>(
              src + (w.r0 + 4 * k) * Geo<G>::kLd + w.c);
}

// seen[r][nt][e]: this lane's row g + 8r sees key 8 nt + 2t + e, a valid
// row of the same position (the block-diagonal mask)
__device__ __forceinline__ void keys_seen(bool (&seen)[2][2][2],
                                          const Tile& tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * nt + 2 * t + e;
      const bool ok = tile.valid(c);
      seen[0][nt][e] = ok && tile.pos(c) == tile.pos(g);
      seen[1][nt][e] = ok && tile.pos(c) == tile.pos(g + 8);
    }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// The A fragments of the 16 rows x 64 columns at x (row stride ld).
template <int ld>
__device__ __forceinline__ void rows_a(unsigned (&a)[kD / 16][4],
                                       const __nv_bfloat16* x, int lane) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldsm_x4(a[kk], x + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
}

// s[2][4] = A (16 rows, fragments a) . the 16 rows at x (64 columns, row
// stride ld) as keys: B read row-major, key = column of s
template <int ld>
__device__ __forceinline__ void scores(float (&s)[2][4],
                                       const unsigned (&a)[kD / 16][4],
                                       const __nv_bfloat16* x, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    unsigned b[4];
    ldsm_x4(b, x + ((lane >> 4) * 8 + (lane & 7)) * ld + kk * 16 +
                   ((lane >> 3) & 1) * 8);
    mma_16816(s[0], a[kk], b[0], b[1]);
    mma_16816(s[1], a[kk], b[2], b[3]);
  }
}

// acc[8][4] = A (16 x 16, fragments a) . the 16 rows x 64 columns at x
// (row stride ld): B read transposed
template <int ld>
__device__ __forceinline__ void times_rows(float (&acc)[kD / 8][4],
                                           const unsigned (&a)[4],
                                           const __nv_bfloat16* x, int lane) {
#pragma unroll
  for (int p = 0; p < kD / 16; ++p) {
    unsigned b[4];
    ldsm_x4_t(b, x + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + p * 16 +
                     (lane >> 4) * 8);
    acc[2 * p][0] = acc[2 * p][1] = acc[2 * p][2] = acc[2 * p][3] = 0.f;
    acc[2 * p + 1][0] = acc[2 * p + 1][1] = acc[2 * p + 1][2] =
        acc[2 * p + 1][3] = 0.f;
    mma_16816(acc[2 * p], a, b[0], b[1]);
    mma_16816(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// The A fragment of a 16 x 16 score tile held as mma accumulators
// (s[nt]: columns 8 nt + 2t, +1 of rows g and g + 8), rounded to bf16.
__device__ __forceinline__ void acc_a(unsigned (&a)[4],
                                      const float (&s)[2][4]) {
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
}

// A 16 x 64 accumulator, times mul0 (row g) and mul1 (row g + 8), as
// bf16 into the 16 rows at x (row stride ld).
template <int ld>
__device__ __forceinline__ void put_rows(__nv_bfloat16* x,
                                         const float (&acc)[kD / 8][4],
                                         float mul0, float mul1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    *reinterpret_cast<unsigned*>(x + g * ld + 8 * j + 2 * t) =
        pack_bf16(acc[j][0] * mul0, acc[j][1] * mul0);
    *reinterpret_cast<unsigned*>(x + (g + 8) * ld + 8 * j + 2 * t) =
        pack_bf16(acc[j][2] * mul1, acc[j][3] * mul1);
  }
}

// a . c over one row's 16 columns that this lane's A fragments hold
// (row g: registers 0 and 2; row g + 8: 1 and 3), c[j] the pair at
// columns 8 j + 2t; the quad's lanes then sum the row.
__device__ __forceinline__ float row_dot(const unsigned (&a)[kD / 16][4],
                                         const float2 (&c)[kD / 8], int hi) {
  float s = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const float2 x = unpack_bf16(a[kk][hi]), y = unpack_bf16(a[kk][2 + hi]);
    s = fmaf(x.x, c[2 * kk].x, s);
    s = fmaf(x.y, c[2 * kk].y, s);
    s = fmaf(y.x, c[2 * kk + 1].x, s);
    s = fmaf(y.y, c[2 * kk + 1].y, s);
  }
  return quad_sum(s);
}

// One step of a reduce-scatter over lanes `half` apart (16, 8, 4): of
// red[0 .. 2 half), a lane keeps the half its bit `half` selects, summed
// with its partner's, in red[0 .. half).
template <int half>
__device__ __forceinline__ void halve(float (&red)[32], int lane) {
  const bool up = lane & half;
#pragma unroll
  for (int i = 0; i < half; ++i) {
    const float send = up ? red[i] : red[i + half];
    red[i] = (up ? red[i + half] : red[i]) +
             __shfl_xor_sync(0xffffffffu, send, half);
  }
}

// the pairs of a (B, D) row at columns 8 j + 2t of a head
__device__ __forceinline__ void cls_pairs(float2 (&c)[kD / 8],
                                          const __nv_bfloat16* row, int t) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
    c[j] = unpack_bf16(ld32(row + 8 * j + 2 * t));
}

}  // namespace tslab

// What K2's slab kernels take (kernels/divided.py:time_branch mirrors it):
// head_dim 64, 1 <= F <= 16 (the tile's 16 rows), q/k/v rows on 16-byte
// boundaries (cp.async), ck/cv read as bf16 pairs; for the backward also
// dO and O (contiguous) on 16-byte boundaries.
inline bool time_tc_fits(std::initializer_list<const void*> rows,
                         const void* ck, const void* cv, int F, int d,
                         long long q_rs, long long k_rs, long long v_rs,
                         long long ck_rs, long long cv_rs) {
  if (d != tslab::kD || F < 1 || F > tslab::kMaxFrames) return false;
  for (const void* p : rows)
    if ((unsigned long long)p & 15ull) return false;
  for (long long s : {q_rs, k_rs, v_rs})
    if (s & 7ll) return false;
  return bf16_pairs_ok({ck, cv}, {ck_rs, cv_rs});
}

// The spatial phase's tensor-core kernels (bf16, head_dim 64, any N):
// K1 (N <= 256, divided_fwd.cu / divided_bwd.cu) and K6 (N > 256,
// divided_big.cu) launch the same ones. The forward is defined in
// divided_fwd.cu, the backward in divided_bwd.cu; the *_fits functions
// say what they take (kernels/divided.py:space_branch mirrors them).
bool space_tc_fits(const void* q, const void* k, const void* v,
                   const void* ck, const void* cv, int N, int d,
                   long long q_rs, long long k_rs, long long v_rs,
                   long long ck_rs, long long cv_rs);
cudaError_t launch_space_tc(const void* q, const void* k, const void* v,
                            const void* ck, const void* cv, void* out,
                            void* lse, int B, int F, int N, int H,
                            long long q_rs, long long k_rs, long long v_rs,
                            long long ck_rs, long long cv_rs, float scale,
                            cudaStream_t stream);
bool space_bwd_tc_fits(const void* q, const void* k, const void* v,
                       const void* ck, const void* cv, const void* dout,
                       int N, int d, long long q_rs, long long k_rs,
                       long long v_rs, long long ck_rs, long long cv_rs);
cudaError_t launch_space_bwd_tc(const void* q, const void* k, const void* v,
                                const void* ck, const void* cv,
                                const void* dout, const void* lse,
                                void* stats, void* dq,
                                void* dk, void* dv, void* dck, void* dcv,
                                void* part_k, void* part_v, int B, int F,
                                int N, int H, long long q_rs, long long k_rs,
                                long long v_rs, long long ck_rs,
                                long long cv_rs, float scale,
                                cudaStream_t stream);

// Kernels used by more than one source: internal linkage, so every source
// that includes this header compiles its own copy.
namespace {

constexpr int kSumSlices = 16;  // warps a block of sum_groups_kernel

// out[b, c] = sum over g of part[b, g, c]: the second, deterministic pass
// over the per-group partials of dck/dcv. A block takes 32 columns; its
// warp s sums the groups g = s, s + 16, ... in order, then the first warp
// adds the 16 warps' sums in order.
template <typename T>
__global__ void __launch_bounds__(32 * kSumSlices)
    sum_groups_kernel(const float* __restrict__ part_k,
                      const float* __restrict__ part_v, T* __restrict__ dck,
                      T* __restrict__ dcv, int B, int G, long long D) {
  __shared__ float sums[2][kSumSlices][32];
  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + lane;
  const bool ok = i < (long long)B * D;
  const long long b = ok ? i / D : 0, c = ok ? i - b * D : 0;
  float ak = 0.f, av = 0.f;
  if (ok)
    for (int g = s; g < G; g += kSumSlices) {
      ak += part_k[(b * G + g) * D + c];
      av += part_v[(b * G + g) * D + c];
    }
  sums[0][s][lane] = ak;
  sums[1][s][lane] = av;
  __syncthreads();
  if (s == 0 && ok) {
    ak = av = 0.f;
#pragma unroll
    for (int j = 0; j < kSumSlices; ++j) {
      ak += sums[0][j][lane];
      av += sums[1][j][lane];
    }
    dck[i] = from_float<T>(ak);
    dcv[i] = from_float<T>(av);
  }
}

template <typename T>
cudaError_t launch_sum_groups(const float* part_k, const float* part_v,
                              void* dck, void* dcv, int B, int G, long long D,
                              cudaStream_t stream) {
  const long long n = (long long)B * D;
  sum_groups_kernel<T><<<(unsigned)((n + 31) / 32), 32 * kSumSlices, 0,
                         stream>>>(part_k, part_v, (T*)dck, (T*)dcv, B, G,
                                   D);
  return cudaGetLastError();
}

}  // namespace

}  // namespace lavila
