// Divided space-time attention, forward phases, for Hopper (sm_90a).
//
// Replaces the Pallas kernels lavila_tpu/ops/pallas/divided.py:
// _space_fwd_kernel (K1) and _time_fwd_kernel (K2). Both take the patch
// tokens token-major, (B, F, N, D = H*d), as row views with a row stride
// (so q/k/v can be the three column blocks of one qkv projection output
// without copies), plus the CLS token's key/value rows (B, D) that every
// group attends to. Each writes the output (B, F, N, D) contiguous and the
// per-row log-sum-exp (B, F, N, H) in fp32. Inputs are fp32 or bf16;
// scores, softmax and sums are fp32.
//
// K1, spatial phase: each patch query of frame f attends over the N+1 keys
// [cls_k; k_f], N <= 256 (larger frames go to K6, divided_big.cu). The
// caller picks one of two kernels (kernels/divided.py asks for the tensor
// cores by the `tc` argument, and the entry point refuses a call they
// cannot take):
//
//  * bf16, head_dim 64, q/k/v rows on 16-byte boundaries: space_fwd_tc,
//    one design for every N <= 256 (TSF-B's 196, TSF-L@224's 256, ragged
//    N between). The phase is bound by bytes: 4*(N+1)*d FLOPs per query
//    row against 4*d*2 bytes of q/k/v/out, ~98 FLOPs a byte at N = 196
//    (38.5 MB and 3.8 GFLOP at TSF-B's batch 8, 0.0116 ms at 3.35 TB/s)
//    and ~128 at N = 256 (67 MB and 8.6 GFLOP at TSF-L@224's batch 8,
//    0.0202 ms), below the H100's ~295. So the design is about the
//    memory side:
//    - Grid: one block per (128-query tile, head, clip*frame), two
//      warpgroups, each owning 64 query rows; 2 x 12 x 32 = 768 blocks at
//      TSF-B batch 8, 1024 at TSF-L@224. The two warpgroups share the
//      frame's K and V in shared memory, so a frame's keys cross from L2
//      half as often as with one warpgroup a block (which measured
//      slower). A warpgroup past the frame's last query leaves at once.
//    - Copies: thread 0 issues every copy at entry by TMA (3-D tensor maps
//      over the strided row views: columns, the frame's N rows, frames;
//      rows past N come in as zeros): each query tile and each 64-key K
//      and V tile lands in shared memory (128-byte swizzle) on a barrier
//      of its own, so the products of key tile t run while tiles t+1..
//      are still in flight. With N <= 256 the ring holds every key tile
//      (2 query + 8 key tiles, ~81 KB: two blocks an SM) and no slot is
//      ever refilled.
//    - Products: S = Q K^T and O += P V are wgmma m64n64k16 (bf16 in,
//      fp32 accumulate): Q and K from shared memory, K-major; P from
//      registers (the S accumulator rounded to bf16 is wgmma's A
//      fragment); V from shared memory read MN-major, so no tile is
//      stored transposed.
//    - The CLS key is the online softmax's starting state: per row
//      s_cls = scale*q.ck, m = s_cls, l = 1, acc = cv (the Pallas
//      kernel's order, divided.py:63-72), so the key tiles are plain rows
//      of k_f and only the last one is masked (196 = 3*64 + 4; 256 =
//      4*64). The softmax runs in the log2 domain (exp2).
//    - Output through the warpgroup's query tile in shared memory to
//      16-byte coalesced stores; lse = m + log(l).
//    - Numerics: the *unnormalised* P = exp(s - m) is rounded to bf16 for
//      P V and the sum divided at the end, as K6 does; the JAX kernel
//      rounds the normalised P. bf16 rounding only (the 2e-2 bf16 limit).
//  * everything else (fp32, whose 1e-4 bound rules out bf16 or TF32
//    tensor cores, other head sizes, unaligned rows): SIMT fp32 FMA,
//    bound by FMA issue and its ~2 shared-memory loads per FMA. K/V are
//    staged in fp32 (~100 KB at N = 196, dynamic shared memory), rows
//    padded to d+1 floats so that lane j reading key row j hits its own
//    bank.
//
// K2, temporal phase: each query at (frame f, position n) attends over the
// F keys at position n plus the CLS key. Only F+1 keys, so the phase is
// bound by reading q/k/v from device memory. One warp owns one
// (clip, position, head); each lane holds d/32 dims, the scores are warp
// reductions and the softmax is online, so F is only bounded by the loop
// (16 frames, the fine-tune clip length, runs the same code as 4).

#include <cuda.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using lavila::allow_smem;
using lavila::from_float;
using lavila::ld32;
using lavila::pack_bf16;
using lavila::quad_max;
using lavila::quad_sum;
using lavila::to_float;
using lavila::unpack_bf16;
using lavila::warp_max;
using lavila::warp_sum;

constexpr int kWarps = 8;           // warps per block, the SIMT kernels
constexpr int kMaxDimsPerLane = 4;  // head_dim <= 128

size_t space_smem_bytes(int N, int d) {
  const size_t L = (size_t)N + 1;
  return (2 * L * (d + 1) + (size_t)kWarps * d + (size_t)kWarps * L) *
         sizeof(float);
}

// grid (H, F, B), kWarps*32 threads.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    space_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ ck,
                     const T* __restrict__ cv, T* __restrict__ out,
                     float* __restrict__ lse, int F, int N, int H, int d,
                     long long q_rs, long long k_rs, long long v_rs,
                     long long ck_rs, long long cv_rs, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int L = N + 1;   // key 0 is the CLS token, keys 1..N the frame
  const int ld = d + 1;  // padded row length, see the header
  float* ks = smem;
  float* vs = ks + (size_t)L * ld;
  float* qbuf = vs + (size_t)L * ld;  // one scaled query row per warp
  float* pbuf = qbuf + kWarps * d;    // one probability row per warp
  const long long frame_row = ((long long)b * F + f) * N;
  const int col = h * d;
  const long long D = (long long)H * d;

  for (int i = threadIdx.x; i < L * d; i += blockDim.x) {
    const int j = i / d, c = i - j * d;
    float kv, vv;
    if (j == 0) {
      kv = to_float(ck[b * ck_rs + col + c]);
      vv = to_float(cv[b * cv_rs + col + c]);
    } else {
      const long long r = frame_row + j - 1;
      kv = to_float(k[r * k_rs + col + c]);
      vv = to_float(v[r * v_rs + col + c]);
    }
    ks[j * ld + c] = kv;
    vs[j * ld + c] = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qbuf + warp * d;
  float* pw = pbuf + warp * L;
  for (int n = warp; n < N; n += kWarps) {
    const long long row = frame_row + n;
    for (int c = lane; c < d; c += 32)
      qw[c] = to_float(q[row * q_rs + col + c]) * scale;
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float* kr = ks + j * ld;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qw[c], kr[c], s);
      pw[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(pw[j] - m);
      pw[j] = p;
      l += p;
    }
    l = warp_sum(l);
    __syncwarp();

    const float inv = 1.f / l;
    for (int c = lane; c < d; c += 32) {
      float o = 0.f;
      for (int j = 0; j < L; ++j) o = fmaf(pw[j], vs[j * ld + c], o);
      out[row * D + col + c] = from_float<T>(o * inv);
    }
    if (lane == 0) lse[row * H + h] = m + logf(l);
    __syncwarp();  // qw/pw are rewritten by the next query
  }
}

// ---- K1, bf16 head_dim 64: TMA and wgmma ---------------------------------

constexpr int kTcD = 64;         // head_dim of the tensor-core kernel
constexpr int kTcTile = 64;      // queries per warpgroup, keys per tile
constexpr int kTcMaxTiles = 4;   // key tiles: N <= 256
constexpr int kWG = 2;           // warpgroups per block: 128 queries
constexpr int kTcTileElems = kTcTile * kTcD;
constexpr unsigned kTcTileBytes = kTcTileElems * 2;  // 8 KB of 128-B rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

size_t space_tc_smem_bytes(int tiles) {
  // a query tile per warpgroup, `tiles` K and V tiles, and slack to put
  // the first tile on a 1024-byte boundary (the 128-byte swizzle's period)
  return (size_t)(kWG + 2 * tiles) * kTcTileBytes + 1024;
}

// Element (r, c) of a 64 x 64 bf16 tile written by TMA with the 128-byte
// swizzle: 16-byte chunk c/8 of row r sits at chunk (c/8) ^ (r % 8).
__device__ __forceinline__ char* swizzled(void* tile, int r, int c) {
  return static_cast<char*>(tile) + r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// the 128 threads of warpgroup `wg` wait for each other (named barrier
// 1 + wg; 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The online softmax over key tile kt's scores s (log2 domain after the
// scale): keys past N masked, the running max and sum of the thread's
// rows r0 and r0 + 8 updated, c0/c1 the factors that rescale what came
// before, and P = exp2(s - m) packed to bf16 as wgmma's A operand (keys
// 16kk..16kk+15 are the accumulator's column blocks 2kk and 2kk+1).
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             unsigned (&pa)[kTcD / 16][4],
                                             int kt, int N, int t4, float sl2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& c0,
                                             float& c1) {
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = kt * kTcTile + 8 * j + 2 * t4 + e < N;
      s[4 * j + e] = valid ? s[4 * j + e] * sl2 : -INFINITY;
      s[4 * j + 2 + e] = valid ? s[4 * j + 2 + e] * sl2 : -INFINITY;
      t0 = fmaxf(t0, s[4 * j + e]);
      t1 = fmaxf(t1, s[4 * j + 2 + e]);
    }
  }
  // finite: m0/m1 start at the CLS score
  const float mn0 = fmaxf(m0, quad_max(t0)), mn1 = fmaxf(m1, quad_max(t1));
  c0 = exp2f(m0 - mn0);
  c1 = exp2f(m1 - mn1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = exp2f(s[4 * j + e] - mn0);
      s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn1);
      rs0 += s[4 * j + e];
      rs1 += s[4 * j + 2 + e];
    }
  }
  l0 = l0 * c0 + quad_sum(rs0);
  l1 = l1 * c1 + quad_sum(rs1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int kk = 0; kk < kTcD / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], float c0, float c1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= c0;
    o[4 * j + 1] *= c0;
    o[4 * j + 2] *= c1;
    o[4 * j + 3] *= c1;
  }
}

// grid (ceil(N / (64 kWG)), H, B*F), 128 kWG threads: warpgroup w owns
// queries 64 (kWG blockIdx.x + w) .. +63. tq/tk/tv: 3-D tensor maps
// (columns, the frame's N rows, frames) with a 64 x 64 x 1 box.
__global__ void __launch_bounds__(128 * kWG)
    space_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __nv_bfloat16* __restrict__ ck,
                        const __nv_bfloat16* __restrict__ cv,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int F, int N, int H,
                        long long ck_rs, long long cv_rs, float scale) {
  using namespace lavila::sm90;
  extern __shared__ unsigned char smem_raw[];
  // a barrier per query tile, per K tile and per V tile
  __shared__ __align__(8) unsigned long long bar_q[kWG];
  __shared__ __align__(8) unsigned long long bar_k[kTcMaxTiles];
  __shared__ __align__(8) unsigned long long bar_v[kTcMaxTiles];
  __nv_bfloat16* qs0 = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tiles = (N + kTcTile - 1) / kTcTile;
  __nv_bfloat16* ks = qs0 + kWG * kTcTileElems;
  __nv_bfloat16* vs = ks + tiles * kTcTileElems;
  const int h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const int col = h * kTcD;
  const int wg = threadIdx.x >> 7;
  const int row0 = (blockIdx.x * kWG + wg) * kTcTile;  // this warpgroup's

  if (threadIdx.x == 0) {
    for (int w = 0; w < kWG; ++w) mbar_init(&bar_q[w], 1);
    for (int t = 0; t < tiles; ++t) {
      mbar_init(&bar_k[t], 1);
      mbar_init(&bar_v[t], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWG; ++w) {
      const int r = (blockIdx.x * kWG + w) * kTcTile;
      if (r >= N) break;
      mbar_expect_tx(&bar_q[w], kTcTileBytes);
      tma_load_3d(qs0 + w * kTcTileElems, &tq, &bar_q[w], col, r, bf);
    }
    for (int t = 0; t < tiles; ++t) {
      mbar_expect_tx(&bar_k[t], kTcTileBytes);
      tma_load_3d(ks + t * kTcTileElems, &tk, &bar_k[t], col, t * kTcTile,
                  bf);
      mbar_expect_tx(&bar_v[t], kTcTileBytes);
      tma_load_3d(vs + t * kTcTileElems, &tv, &bar_v[t], col, t * kTcTile,
                  bf);
    }
  }
  // a warpgroup past the frame's last query has nothing to do; no
  // block-wide barrier follows
  if (row0 >= N) return;
  __nv_bfloat16* qs = qs0 + wg * kTcTileElems;

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const float sl2 = scale * kLog2e;  // scores in the log2 domain

  // the CLS key opens the softmax: acc = cv, l = 1, m = s_cls
  float o[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 c = unpack_bf16(ld32(cv + b * cv_rs + col + 8 * j + 2 * t4));
    o[4 * j] = o[4 * j + 2] = c.x;
    o[4 * j + 1] = o[4 * j + 3] = c.y;
  }
  float ckf[16];  // ck's dims 16*t4 .. 16*t4 + 15
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 c = unpack_bf16(ld32(ck + b * ck_rs + col + 16 * t4 + 2 * i));
    ckf[2 * i] = c.x;
    ckf[2 * i + 1] = c.y;
  }
  mbar_wait(&bar_q[wg], 0);
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 16 * t4 + 2 * i;
    const float2 a = unpack_bf16(*reinterpret_cast<unsigned*>(
        swizzled(qs, r0, c)));
    const float2 e = unpack_bf16(*reinterpret_cast<unsigned*>(
        swizzled(qs, r0 + 8, c)));
    d0 = fmaf(a.x, ckf[2 * i], fmaf(a.y, ckf[2 * i + 1], d0));
    d1 = fmaf(e.x, ckf[2 * i], fmaf(e.y, ckf[2 * i + 1], d1));
  }
  float m0 = quad_sum(d0) * sl2, m1 = quad_sum(d1) * sl2;
  float l0 = 1.f, l1 = 1.f;

  for (int kt = 0; kt < tiles; ++kt) {
    mbar_wait(&bar_k[kt], 0);
    __syncwarp();
    const __nv_bfloat16* kst = ks + kt * kTcTileElems;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcD / 16; ++kk)
      wgmma_ss(s, sw128_desc(qs + 16 * kk), sw128_desc(kst + 16 * kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    hold(s);

    unsigned pa[kTcD / 16][4];
    float c0, c1;
    softmax_tile(s, pa, kt, N, t4, sl2, m0, m1, l0, l1, c0, c1);
    rescale(o, c0, c1);
    mbar_wait(&bar_v[kt], 0);
    __syncwarp();
    const __nv_bfloat16* vst = vs + kt * kTcTileElems;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcTile / 16; ++kk)
      wgmma_rs_tn(o, pa[kk], sw128_desc(vst + 16 * kk * kTcD));
    wgmma_commit();
    wgmma_wait_all();
    hold(o);
#pragma unroll
    for (int kk = 0; kk < kTcTile / 16; ++kk) hold(pa[kk]);
  }

  // out: through this warpgroup's query tile (same swizzle) to 16-byte
  // row-contiguous stores
  wg_sync(wg);  // every product of the warpgroup is done with qs
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t4;
    *reinterpret_cast<unsigned*>(swizzled(qs, r0, c)) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<unsigned*>(swizzled(qs, r0 + 8, c)) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  wg_sync(wg);
  const long long frame_row = (long long)bf * N;
  const long long D = (long long)H * kTcD;
  for (int i = threadIdx.x & 127; i < kTcTile * kTcD / 8; i += 128) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int n = row0 + r;
    if (n < N)
      *reinterpret_cast<uint4*>(out + (frame_row + n) * D + col + c) =
          *reinterpret_cast<const uint4*>(swizzled(qs, r, c));
  }
  if (t4 == 0) {
    const int n0 = row0 + r0, n1 = n0 + 8;
    if (n0 < N) lse[(frame_row + n0) * H + h] = (m0 + log2f(l0)) * kLn2;
    if (n1 < N) lse[(frame_row + n1) * H + h] = (m1 + log2f(l1)) * kLn2;
  }
}

// one warp per (clip, position, head); ceil(B*N*H / kWarps) blocks.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    time_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ ck,
                    const T* __restrict__ cv, T* __restrict__ out,
                    float* __restrict__ lse, int B, int F, int N, int H,
                    int d, long long q_rs, long long k_rs, long long v_rs,
                    long long ck_rs, long long cv_rs, float scale) {
  const long long w =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= (long long)B * N * H) return;  // whole warps leave together
  const int h = (int)(w % H);
  const long long bn = w / H;
  const int n = (int)(bn % N);
  const int b = (int)(bn / N);
  const int col = h * d;
  const long long D = (long long)H * d;

  float ckr[kMaxDimsPerLane], cvr[kMaxDimsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i) {
    const int c = lane + 32 * i;
    ckr[i] = c < d ? to_float(ck[b * ck_rs + col + c]) : 0.f;
    cvr[i] = c < d ? to_float(cv[b * cv_rs + col + c]) : 0.f;
  }

  for (int f = 0; f < F; ++f) {
    const long long qrow = ((long long)b * F + f) * N + n;
    float qr[kMaxDimsPerLane], acc[kMaxDimsPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      qr[i] = c < d ? to_float(q[qrow * q_rs + col + c]) * scale : 0.f;
      s = fmaf(qr[i], ckr[i], s);
    }
    // the CLS key opens the online softmax
    float m = warp_sum(s), l = 1.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) acc[i] = cvr[i];

    for (int g = 0; g < F; ++g) {
      const long long krow = ((long long)b * F + g) * N + n;
      float vr[kMaxDimsPerLane];
      float sg = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int c = lane + 32 * i;
        const float kv = c < d ? to_float(k[krow * k_rs + col + c]) : 0.f;
        vr[i] = c < d ? to_float(v[krow * v_rs + col + c]) : 0.f;
        sg = fmaf(qr[i], kv, sg);
      }
      sg = warp_sum(sg);
      const float m_new = fmaxf(m, sg);
      const float corr = expf(m - m_new);
      const float p = expf(sg - m_new);
      l = l * corr + p;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i)
        acc[i] = fmaf(acc[i], corr, p * vr[i]);
      m = m_new;
    }

    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < d) out[qrow * D + col + c] = from_float<T>(acc[i] * inv);
    }
    if (lane == 0) lse[qrow * H + h] = m + logf(l);
  }
}

template <typename T>
cudaError_t launch_space(const void* q, const void* k, const void* v,
                         const void* ck, const void* cv, void* out, void* lse,
                         int B, int F, int N, int H, int d, long long q_rs,
                         long long k_rs, long long v_rs, long long ck_rs,
                         long long cv_rs, float scale, cudaStream_t stream) {
  const size_t smem = space_smem_bytes(N, d);
  cudaError_t err = allow_smem(space_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  space_fwd_kernel<T><<<dim3(H, F, B), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (T*)out, (float*)lse, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs,
      scale);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the libcuda the process already loaded
// (it is not linked: the library is loaded next to PyTorch's own)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
  }();
  return fn;
}

// The (B*F frames, N rows, D columns) bf16 row view at p with row stride
// rs elements, as a 3-D tensor map with a 64 x 64 x 1 box, 128-byte
// swizzle; rows past N read as zeros.
bool rows_map(CUtensorMap* map, const void* p, long long rs, int D, int N,
              int frames) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N,
                              (cuuint64_t)frames};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 2,
                                 (cuuint64_t)rs * 2 * N};
  const cuuint32_t box[3] = {kTcD, kTcTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What the tensor-core K1 takes (kernels/divided.py mirrors it): head_dim
// 64, 1 <= N <= 256, q/k/v rows on 16-byte boundaries (TMA), ck/cv read
// as bf16 pairs.
bool space_tc_fits(const void* q, const void* k, const void* v,
                   const void* ck, const void* cv, int N, int d,
                   long long q_rs, long long k_rs, long long v_rs,
                   long long ck_rs, long long cv_rs) {
  if (d != kTcD || N < 1 || N > kTcMaxTiles * kTcTile) return false;
  for (const void* p : {q, k, v})
    if ((uintptr_t)p & 15u) return false;
  for (long long s : {q_rs, k_rs, v_rs})
    if (s & 7ll) return false;
  return lavila::bf16_pairs_ok({ck, cv}, {ck_rs, cv_rs});
}

cudaError_t launch_space_tc(const void* q, const void* k, const void* v,
                            const void* ck, const void* cv, void* out,
                            void* lse, int B, int F, int N, int H,
                            long long q_rs, long long k_rs, long long v_rs,
                            long long ck_rs, long long cv_rs, float scale,
                            cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int D = H * kTcD;
  if (!rows_map(&tq, q, q_rs, D, N, B * F) ||
      !rows_map(&tk, k, k_rs, D, N, B * F) ||
      !rows_map(&tv, v, v_rs, D, N, B * F))
    return cudaErrorInvalidValue;
  const int tiles = (N + kTcTile - 1) / kTcTile;
  const size_t smem = space_tc_smem_bytes(tiles);
  cudaError_t err = allow_smem(space_fwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (tiles + kWG - 1) / kWG;
  space_fwd_tc_kernel<<<dim3(blocks, H, B * F), 128 * kWG, smem, stream>>>(
      tq, tk, tv, (const __nv_bfloat16*)ck, (const __nv_bfloat16*)cv,
      (__nv_bfloat16*)out, (float*)lse, F, N, H, ck_rs, cv_rs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_time(const void* q, const void* k, const void* v,
                        const void* ck, const void* cv, void* out, void* lse,
                        int B, int F, int N, int H, int d, long long q_rs,
                        long long k_rs, long long v_rs, long long ck_rs,
                        long long cv_rs, float scale, cudaStream_t stream) {
  const long long warps = (long long)B * N * H;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  time_fwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (T*)out, (float*)lse, B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = fp32, 1 = bf16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" {

// tc: 1 runs the tensor-core kernel (bf16; refused with
// cudaErrorInvalidValue where space_tc_fits does not hold), 0 the SIMT one.
int lavila_divided_space_fwd(const void* q, const void* k, const void* v,
                             const void* ck, const void* cv, void* out,
                             void* lse, int B, int F, int N, int H, int d,
                             long long q_rs, long long k_rs, long long v_rs,
                             long long ck_rs, long long cv_rs, float scale,
                             int dtype, int tc, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    if (dtype != 1 || !space_tc_fits(q, k, v, ck, cv, N, d, q_rs, k_rs,
                                     v_rs, ck_rs, cv_rs))
      return (int)cudaErrorInvalidValue;
    return (int)launch_space_tc(q, k, v, ck, cv, out, lse, B, F, N, H, q_rs,
                                k_rs, v_rs, ck_rs, cv_rs, scale, s);
  }
  if (dtype == 0)
    return (int)launch_space<float>(q, k, v, ck, cv, out, lse, B, F, N, H, d,
                                    q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 1)
    return (int)launch_space<__nv_bfloat16>(q, k, v, ck, cv, out, lse, B, F,
                                            N, H, d, q_rs, k_rs, v_rs, ck_rs,
                                            cv_rs, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lavila_divided_time_fwd(const void* q, const void* k, const void* v,
                            const void* ck, const void* cv, void* out,
                            void* lse, int B, int F, int N, int H, int d,
                            long long q_rs, long long k_rs, long long v_rs,
                            long long ck_rs, long long cv_rs, float scale,
                            int dtype, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_time<float>(q, k, v, ck, cv, out, lse, B, F, N, H, d,
                                   q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 1)
    return (int)launch_time<__nv_bfloat16>(q, k, v, ck, cv, out, lse, B, F,
                                           N, H, d, q_rs, k_rs, v_rs, ck_rs,
                                           cv_rs, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
