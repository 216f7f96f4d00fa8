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
// [cls_k; k_f], N <= 256 (larger frames go to K6's entry points,
// divided_big.cu, whose tensor-core route is the kernel below too). The
// caller picks one of two kernels (kernels/divided.py asks for the tensor
// cores by the `tc` argument, and the entry point refuses a call they
// cannot take):
//
//  * bf16, head_dim 64, q/k/v rows on 16-byte boundaries: space_fwd_tc,
//    one design for every N: TSF-B's 196, TSF-L@224's 256 and, for K6,
//    TSF-L@336's 576. 4*(N+1)*d FLOPs per query row against 4*d*2 bytes
//    of q/k/v/out: ~98 FLOPs a byte at N = 196 (38.5 MB and 3.8 GFLOP at
//    TSF-B's batch 8, 0.0116 ms at 3.35 TB/s), ~128 at N = 256 (0.0202
//    ms), ~290 at N = 576 (151 MB and 38.7 GFLOP at batch 8: 0.0454 ms
//    by bytes, 0.039 by the tensor cores), at the H100's balance point.
//    So the design keeps the copies ahead of the products and the
//    products on wgmma:
//    - Grid: one block per (128-query tile, head, clip*frame): two
//      consumer warpgroups, each owning 64 query rows, and one producer
//      warp. The two warpgroups share the frame's K and V in shared
//      memory, so a frame's keys cross from L2 half as often as with one
//      warpgroup a block (which measured slower in K1's first version).
//    - Copies: the producer's first thread issues every copy by TMA (3-D
//      tensor maps over the strided row views: columns, the frame's N
//      rows, frames; rows past N come in as zeros), the query tiles first,
//      then the 64-key K and V tiles through a ring of kTcStages slots
//      (128-byte swizzle), K and V of a slot on barriers of their own.
//      Each consumer warpgroup arrives on the slot's `empty` barrier when
//      its P V on that tile is done, and the producer waits on it before
//      it refills the slot (lavila::sm90::Ring): K/V for tile t+4 are in
//      flight while tile t is used. A warpgroup past the frame's last
//      query leaves at once and is not counted on `empty`. With N <= 256
//      the ring holds every key tile and no slot is refilled (K1's
//      resident case: 2 query + 8 key tiles, ~81 KB: two blocks an SM).
//    - Products: S = Q K^T and O += P V are wgmma m64n64k16 (bf16 in,
//      fp32 accumulate): Q and K from shared memory, K-major; P from
//      registers (the S accumulator rounded to bf16 is wgmma's A
//      fragment); V from shared memory read MN-major, so no tile is
//      stored transposed.
//    - The CLS key is the online softmax's starting state: per row
//      s_cls = scale*q.ck, m = s_cls, l = 1, acc = cv (the Pallas
//      kernel's order, divided.py:63-72), so the key tiles are plain rows
//      of k_f and only the last one is masked (196 = 3*64 + 4; 256 =
//      4*64; 576 = 9*64). The softmax runs in the log2 domain (exp2).
//    - Output through the warpgroup's query tile in shared memory to
//      16-byte coalesced stores; lse = m + log(l).
//    - The softmax is the loop's critical path at head_dim 64 (one ex2
//      per 128 multiply-adds of the products): per score one FFMA folds
//      the scale into exp2's argument, ex2.approx, and a running sum each
//      thread keeps for its share of a row (reduced over the quad once, at
//      the end); only the last tile is masked. S and P V run in turn
//      within a warpgroup: issuing S of tile t+1 before P V of tile t
//      (FlashAttention-3's order) needs ~16 more registers, which cost the
//      second block an SM and measured slower.
//    - Numerics: the *unnormalised* P = exp(s - m) is rounded to bf16 for
//      P V and the sum divided at the end; the JAX kernels round the
//      normalised P. bf16 rounding only (the 2e-2 bf16 limit).
//  * everything else (fp32, whose 1e-4 bound rules out bf16 or TF32
//    tensor cores, other head sizes, unaligned rows): SIMT fp32 FMA,
//    bound by FMA issue and its ~2 shared-memory loads per FMA. K/V are
//    staged in fp32 (~100 KB at N = 196, dynamic shared memory), rows
//    padded to d+1 floats so that lane j reading key row j hits its own
//    bank.
//
// K2, temporal phase: each query at (frame f, position n) attends over the
// F keys at position n plus the CLS key. Only F+1 keys: (F+1)/2 FLOPs a
// byte of q/k/v/out in bf16 (2.5 at F = 4, 8.5 at the fine-tune's 16),
// far under the H100's ~295 and under the ~20 that fp32 FMA issue covers,
// so the phase is bound by moving its bytes: 38.5 MB at TSF-B's (8, 4,
// 196, 768), 0.0116 ms at 3.35 TB/s; 0.046 ms at 16 frames; 0.0454 ms at
// TSF-L@336's (8, 4, 576, 1024). Two kernels (kernels/divided.py asks for
// the tensor cores by `tc`; the entry point refuses a call that
// time_tc_fits does not take):
//
//  * bf16, head_dim 64, F <= 16, q/k/v rows on 16-byte boundaries:
//    time_fwd_tc, the slab kernel. The first version (one warp per
//    (clip, position, head), 2 bytes a lane) read every key and value
//    row once per query frame, F^2 row reads, and spent a 5-step warp
//    shuffle chain and two expf in series on every (query, key) pair.
//    Here:
//    - A work item is a tile: 16 / F positions x G heads of one clip, all
//      F frames: 16 rows (lavila::tslab in common.cuh). Its q, k and v
//      rows come in by 16-byte cp.async copies (a row's G * 64 columns,
//      512 bytes at G = 4) into one shared-memory slab per tensor, rows
//      padded by 16 bytes so the 8 rows an ldmatrix reads start 4 banks
//      apart: every input byte is read from device memory once.
//    - One block per tile, as many resident on an SM as registers and
//      shared memory allow (25 KB and ~64 registers a thread at G = 4):
//      their copies and arithmetic overlap across blocks. The head groups
//      of one tile are neighbouring blocks, so the blocks that run
//      together read the same rows' other columns. A thread's rows and
//      their offsets are worked out once a tile, without an integer
//      division (tslab::Tile).
//    - One warp per head: its 16 rows are mma.sync m16n8k16's m16 (bf16
//      in, fp32 accumulate). S = Q K^T takes the tile's 16 rows as keys
//      under a block-diagonal mask (a query sees its own position's
//      frames); the CLS key's score is a dot over each lane's 16 columns
//      and a quad sum, so no product is padded for it. The softmax stays
//      in registers (quad shuffles only), exp2 with the scale folded in;
//      O = P V (P from the S accumulators) + p_cls cv, written through
//      the warp's columns of the query slab to 16-byte stores.
//    - Numerics: the unnormalised P = exp(s - m) is rounded to bf16 for
//      P V and the sum divided at the end; the JAX kernel rounds the
//      normalised P (divided.py:198-201): bf16 rounding only, within the
//      2e-2 limit.
//  * everything else (fp32, whose 1e-4 bound rules out bf16 tensor cores,
//    other head sizes, unaligned rows, more than 16 frames):
//    time_fwd_kernel, SIMT: one warp per (clip, position, head), each lane
//    holding d/32 dims, the scores warp reductions, the softmax online.

#include <math.h>

#include "common.cuh"

namespace {

using lavila::allow_smem;
using lavila::cp_async_commit;
using lavila::from_float;
using lavila::ld32;
using lavila::quad_max;
using lavila::quad_sum;
using lavila::to_float;
using lavila::unpack_bf16;
using lavila::warp_max;
using lavila::warp_sum;
namespace tslab = lavila::tslab;

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

// ---- the spatial phase on the tensor cores (K1 and K6): TMA and wgmma

using namespace lavila::sm90;  // tiles, barriers, the ring, wgmma

constexpr int kTcWG = 2;      // consumer warpgroups a block: 128 queries
constexpr int kTcStages = 4;  // ring slots of K and V tiles

size_t space_tc_smem_bytes(int wgs, int stages) {
  // a query tile per warpgroup, `stages` K and V tiles, and slack to put
  // the first tile on a 1024-byte boundary (the 128-byte swizzle's period)
  return (size_t)(wgs + 2 * stages) * kTileBytes + 1024;
}

// The online softmax over key tile kt's raw scores s (q.k, in place): keys
// past N masked (only the last tile has any), the running max m0/m1 of
// the thread's rows r0 and r0 + 8 (log2 domain, after the scale; the same
// in the 4 lanes of a quad) updated, c0/c1 the factors that rescale what
// came before, s overwritten by P = exp2(scale log2(e) s - m) with one FFMA
// and one ex2 an element, and the thread's share of each row's sum
// (l0/l1: reduced over the quad once, at the end) updated.
__device__ __forceinline__ void softmax_tile(float (&s)[32], int kt, int N,
                                             int t4, float sl2, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& c0, float& c1) {
  if ((kt + 1) * kTile > N) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (kt * kTile + 8 * j + 2 * t4 + e >= N)
          s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
  }
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t0 = fmaxf(t0, fmaxf(s[4 * j], s[4 * j + 1]));
    t1 = fmaxf(t1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  // finite: m0/m1 start at the CLS score
  const float mn0 = fmaxf(m0, quad_max(t0) * sl2);
  const float mn1 = fmaxf(m1, quad_max(t1) * sl2);
  c0 = fast_exp2(m0 - mn0);
  c1 = fast_exp2(m1 - mn1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], sl2, -mn0));
      s[4 * j + 2 + e] = fast_exp2(fmaf(s[4 * j + 2 + e], sl2, -mn1));
      rs0 += s[4 * j + e];
      rs1 += s[4 * j + 2 + e];
    }
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
  m0 = mn0;
  m1 = mn1;
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

// grid (ceil(N / (64 WG)), H, B*F), 128 WG + 32 threads: warpgroup w < WG
// owns queries 64 (WG blockIdx.x + w) .. +63, the last warp is the
// producer. tq/tk/tv: 3-D tensor maps (columns, the frame's N rows,
// frames) with a 64 x 64 x 1 box.
template <int WG, int S>
__global__ void __launch_bounds__(128 * WG + 32)
    space_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __nv_bfloat16* __restrict__ ck,
                        const __nv_bfloat16* __restrict__ cv,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int F, int N, int H,
                        long long ck_rs, long long cv_rs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bar_q[WG];
  // K and V tiles of one slot land on barriers of their own, so that
  // S = Q K^T runs while V is still in flight
  __shared__ __align__(8) Ring<S> ring_k;
  __shared__ __align__(8) unsigned long long full_v[S];
  __nv_bfloat16* qs0 = align1024(smem_raw);
  __nv_bfloat16* ks = qs0 + WG * kTileElems;
  __nv_bfloat16* vs = ks + S * kTileElems;
  const int tiles = (N + kTile - 1) / kTile;
  const int h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const int col = h * kD;
  const int first = blockIdx.x * WG;  // the block's first query tile
  const int live = min(WG, tiles - first);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int w = 0; w < WG; ++w) mbar_init(&bar_q[w], 1);
    ring_k.init(128 * live);
    for (int s = 0; s < S; ++s) mbar_init(&full_v[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == WG) {  // the producer: queries, then the K/V ring
    if (threadIdx.x == 128 * WG) {
      for (int w = 0; w < live; ++w) {
        mbar_expect_tx(&bar_q[w], kTileBytes);
        tma_load_3d(qs0 + w * kTileElems, &tq, &bar_q[w], col,
                    (first + w) * kTile, bf);
      }
      for (int t = 0; t < tiles; ++t) {
        unsigned long long* fk = ring_k.acquire(t);
        const int s = t % S;
        mbar_expect_tx(fk, kTileBytes);
        tma_load_3d(ks + s * kTileElems, &tk, fk, col, t * kTile, bf);
        mbar_expect_tx(&full_v[s], kTileBytes);
        tma_load_3d(vs + s * kTileElems, &tv, &full_v[s], col, t * kTile,
                    bf);
      }
    }
    return;
  }
  // a warpgroup past the frame's last query has nothing to do; it is not
  // counted on the ring's `empty` barriers, and no block-wide barrier
  // follows
  if (wg >= live) return;
  __nv_bfloat16* qs = qs0 + wg * kTileElems;
  const int row0 = (first + wg) * kTile;

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
  __syncwarp();
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 16 * t4 + 2 * i;
    const float2 a = tile_pair(qs, r0, c), e = tile_pair(qs, r0 + 8, c);
    d0 = fmaf(a.x, ckf[2 * i], fmaf(a.y, ckf[2 * i + 1], d0));
    d1 = fmaf(e.x, ckf[2 * i], fmaf(e.y, ckf[2 * i + 1], d1));
  }
  float m0 = quad_sum(d0) * sl2, m1 = quad_sum(d1) * sl2;
  // each row's sum is split over its quad; the CLS key's 1 counts once
  float l0 = t4 == 0 ? 1.f : 0.f, l1 = l0;

  for (int kt = 0; kt < tiles; ++kt) {
    const int s = kt % S;
    ring_k.wait(kt);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
    wgmma_tile_ss(sc, qs, ks + s * kTileElems);
    wgmma_commit();
    wgmma_wait_all();
    hold(sc);

    float c0, c1;
    softmax_tile(sc, kt, N, t4, sl2, m0, m1, l0, l1, c0, c1);
    unsigned pa[kD / 16][4];
    acc_to_a(pa, sc);
    rescale(o, c0, c1);
    mbar_wait(&full_v[s], (kt / S) & 1);
    __syncwarp();
    wgmma_fence();
    wgmma_tile_rs(o, pa, vs + s * kTileElems);
    wgmma_commit();
    wgmma_wait_all();
    hold(o);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) hold(pa[kk]);
    ring_k.release(kt);  // the slot's K and V tiles are free
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // out: through this warpgroup's query tile to 16-byte stores
  const long long frame_row = (long long)bf * N;
  const long long D = (long long)H * kD;
  store_tile(qs, o, 1.f / l0, 1.f / l1, out + frame_row * D + col, D, row0,
             N, wg);
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

// K2 on the tensor cores: a block of G warps per tile (16 / F positions x
// G heads of one clip, all F frames), one warp per head; grid (H / G,
// tiles, B), so the blocks that run together read the other heads'
// columns of the same rows.
template <int G>
__global__ void __launch_bounds__(G * 32)
    time_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ ck,
                       const __nv_bfloat16* __restrict__ cv,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int F, int N, int H,
                       long long q_rs, long long k_rs, long long v_rs,
                       long long ck_rs, long long cv_rs, float scale) {
  using Geo = tslab::Geo<G>;
  using bf16 = __nv_bfloat16;
  constexpr int ld = Geo::kLd, E = Geo::kElems;
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // then k, v
  const tslab::Tile tile(F, N, blockIdx.y, blockIdx.z);
  const tslab::Rows<G> rows(tile);
  const int col0 = blockIdx.x * Geo::kCols;
  tslab::load<G>(qs, q, q_rs, rows, col0);
  tslab::load<G>(qs + E, k, k_rs, rows, col0);
  tslab::load<G>(qs + 2 * E, v, v_rs, rows, col0);
  cp_async_commit();

  // while the copies land: this warp's head, its CLS rows, its rows' and
  // keys' places in the tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x * G + warp, hc = h * tslab::kD;
  float2 ckf[8], cvf[8];
  tslab::cls_pairs(ckf, ck + tile.b * ck_rs + hc, t);
  tslab::cls_pairs(cvf, cv + tile.b * cv_rs + hc, t);
  bool allowed[2][2][2];
  tslab::keys_seen(allowed, tile, g, t);
  tslab::cp_async_wait_all();
  __syncthreads();

  const int hw = warp * tslab::kD;  // the warp's columns in the slabs
  unsigned qa[4][4];
  tslab::rows_a<ld>(qa, qs + hw, lane);
  const float c2 = scale * kLog2e;  // scores to the log2 domain
  const float sc0 = tslab::row_dot(qa, ckf, 0) * c2;
  const float sc1 = tslab::row_dot(qa, ckf, 1) * c2;
  float s[2][4];
  tslab::scores<ld>(s, qa, qs + E + hw, lane);
  // softmax over the CLS key and the row's own position's frames
  float m0 = sc0, m1 = sc1;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = allowed[0][nt][e] ? s[nt][e] * c2 : -INFINITY;
      s[nt][2 + e] = allowed[1][nt][e] ? s[nt][2 + e] * c2 : -INFINITY;
      m0 = fmaxf(m0, s[nt][e]);
      m1 = fmaxf(m1, s[nt][2 + e]);
    }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = fast_exp2(s[nt][e] - m0);
      s[nt][2 + e] = fast_exp2(s[nt][2 + e] - m1);
      l0 += s[nt][e];
      l1 += s[nt][2 + e];
    }
  const float pc0 = fast_exp2(sc0 - m0), pc1 = fast_exp2(sc1 - m1);
  l0 = quad_sum(l0) + pc0;
  l1 = quad_sum(l1) + pc1;
  // O = P V + p_cls cv, P unnormalised in bf16, divided by the sum at the
  // end
  unsigned pa[4];
  tslab::acc_a(pa, s);
  float o[8][4];
  tslab::times_rows<ld>(o, pa, qs + 2 * E + hw, lane);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j][0] = fmaf(pc0, cvf[j].x, o[j][0]);
    o[j][1] = fmaf(pc0, cvf[j].y, o[j][1]);
    o[j][2] = fmaf(pc1, cvf[j].x, o[j][2]);
    o[j][3] = fmaf(pc1, cvf[j].y, o[j][3]);
  }
  // the output through this warp's columns of the query slab (its own
  // queries are in registers) to 16-byte stores
  tslab::put_rows<ld>(qs + hw, o, 1.f / l0, 1.f / l1, lane);
  if (t == 0) {
    if (tile.valid(g))
      lse[tile.row(g) * H + h] = (m0 + log2f(l0)) * kLn2;
    if (tile.valid(g + 8))
      lse[tile.row(g + 8) * H + h] = (m1 + log2f(l1)) * kLn2;
  }
  __syncthreads();
  tslab::store<G>(out, qs, (long long)H * tslab::kD, rows, col0);
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

template <int G>
cudaError_t launch_time_tc(const void* q, const void* k, const void* v,
                           const void* ck, const void* cv, void* out,
                           void* lse, int B, int F, int N, int H,
                           long long q_rs, long long k_rs, long long v_rs,
                           long long ck_rs, long long cv_rs, float scale,
                           cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = 3 * tslab::Geo<G>::kBytes;
  cudaError_t err = allow_smem(time_fwd_tc_kernel<G>, smem);
  if (err != cudaSuccess) return err;
  const int span = tslab::kRows / F;
  time_fwd_tc_kernel<G><<<dim3(H / G, (N + span - 1) / span, B), G * 32,
                          smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ck,
      (const bf16*)cv, (bf16*)out, (float*)lse, F, N, H, q_rs, k_rs, v_rs,
      ck_rs, cv_rs, scale);
  return cudaGetLastError();
}

template <int WG, int S>
cudaError_t launch_space_tc_grid(const CUtensorMap& tq, const CUtensorMap& tk,
                                 const CUtensorMap& tv, const void* ck,
                                 const void* cv, void* out, void* lse, int B,
                                 int F, int N, int H, long long ck_rs,
                                 long long cv_rs, float scale,
                                 cudaStream_t stream) {
  const size_t smem = space_tc_smem_bytes(WG, S);
  cudaError_t err = allow_smem(space_fwd_tc_kernel<WG, S>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (N + kTile - 1) / kTile;
  space_fwd_tc_kernel<WG, S>
      <<<dim3((tiles + WG - 1) / WG, H, B * F), 128 * WG + 32, smem,
          stream>>>(tq, tk, tv, (const __nv_bfloat16*)ck,
                    (const __nv_bfloat16*)cv, (__nv_bfloat16*)out,
                    (float*)lse, F, N, H, ck_rs, cv_rs, scale);
  return cudaGetLastError();
}

}  // namespace

namespace lavila {

// What the tensor-core forward takes: head_dim 64, N >= 1, q/k/v on
// 16-byte boundaries with row strides of whole 16-byte chunks (TMA), ck/cv
// read as bf16 pairs.
bool space_tc_fits(const void* q, const void* k, const void* v,
                   const void* ck, const void* cv, int N, int d,
                   long long q_rs, long long k_rs, long long v_rs,
                   long long ck_rs, long long cv_rs) {
  if (d != sm90::kD || N < 1 || !sm90::aligned16({q, k, v})) return false;
  for (long long s : {q_rs, k_rs, v_rs})
    if (s & 7ll) return false;
  return bf16_pairs_ok({ck, cv}, {ck_rs, cv_rs});
}

cudaError_t launch_space_tc(const void* q, const void* k, const void* v,
                            const void* ck, const void* cv, void* out,
                            void* lse, int B, int F, int N, int H,
                            long long q_rs, long long k_rs, long long v_rs,
                            long long ck_rs, long long cv_rs, float scale,
                            cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int D = H * sm90::kD;
  if (!sm90::rows_map(&tq, q, q_rs, D, N, B * F) ||
      !sm90::rows_map(&tk, k, k_rs, D, N, B * F) ||
      !sm90::rows_map(&tv, v, v_rs, D, N, B * F))
    return cudaErrorInvalidValue;
  return launch_space_tc_grid<kTcWG, kTcStages>(tq, tk, tv, ck, cv, out,
                                                lse, B, F, N, H, ck_rs,
                                                cv_rs, scale, stream);
}

}  // namespace lavila

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
    if (dtype != 1 || !lavila::space_tc_fits(q, k, v, ck, cv, N, d, q_rs,
                                             k_rs, v_rs, ck_rs, cv_rs))
      return (int)cudaErrorInvalidValue;
    return (int)lavila::launch_space_tc(q, k, v, ck, cv, out, lse, B, F, N, H,
                                        q_rs, k_rs, v_rs, ck_rs, cv_rs, scale,
                                        s);
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

// tc: 1 runs the slab kernel on the tensor cores (bf16; refused with
// cudaErrorInvalidValue where time_tc_fits does not hold), 0 the SIMT one.
int lavila_divided_time_fwd(const void* q, const void* k, const void* v,
                            const void* ck, const void* cv, void* out,
                            void* lse, int B, int F, int N, int H, int d,
                            long long q_rs, long long k_rs, long long v_rs,
                            long long ck_rs, long long cv_rs, float scale,
                            int dtype, int tc, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    if (dtype != 1 || !lavila::time_tc_fits({q, k, v}, ck, cv, F, d, q_rs,
                                            k_rs, v_rs, ck_rs, cv_rs))
      return (int)cudaErrorInvalidValue;
    switch (tslab::heads_per_block(H)) {
      case 4:
        return (int)launch_time_tc<4>(q, k, v, ck, cv, out, lse, B, F, N, H,
                                      q_rs, k_rs, v_rs, ck_rs, cv_rs, scale,
                                      s);
      case 2:
        return (int)launch_time_tc<2>(q, k, v, ck, cv, out, lse, B, F, N, H,
                                      q_rs, k_rs, v_rs, ck_rs, cv_rs, scale,
                                      s);
      default:
        return (int)launch_time_tc<1>(q, k, v, ck, cv, out, lse, B, F, N, H,
                                      q_rs, k_rs, v_rs, ck_rs, cv_rs, scale,
                                      s);
    }
  }
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
