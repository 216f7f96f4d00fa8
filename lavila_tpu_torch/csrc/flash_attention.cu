// Flash attention for Hopper (sm_90a): K7 (forward only) and K8 (the
// forward with the log-sum-exp, and its backward).
//
// Replaces the Pallas kernels of lavila_tpu/ops/pallas/flash_attention.py:
// flash_attention (_kernel, K7) and fused_attention's custom VJP
// (_fwd_kernel, _dq_kernel, _dkv_kernel; K8). The contract is the JAX
// functions', laid out token-major as the CLIP text tower hands it over:
// q (B, Lq, H*d) and k/v (B, Lk, H*d) as row views with a row stride (the
// column blocks of one (B, L, 3D) in_proj output, so no head-major copies
// are made). Key j is attended by query i when j < Lk and, with `causal`,
// j <= i (the Pallas kernels' absolute mask). Scores, softmax and every
// sum are fp32; the forward rounds the unnormalised probabilities
// exp(s - m) to the input dtype before P V and divides by their sum at the
// end, as the Pallas kernels do. It writes out (B, Lq, H*d) contiguous and,
// for K8, lse (B, Lq, H) fp32. The backward takes dO contiguous with lse
// and writes dq (B, Lq, H*d) and dk/dv (B, Lk, H*d) contiguous. No
// atomics: two calls give the same bits.
//
// The backward's delta (dS = P (dP - delta)) is rowsum(P * dP) over the P
// it recomputes from lse, in a pass over the keys before dS, where the
// Pallas kernels take rowsum(dO * O) from the forward's O. The two agree
// in exact arithmetic, but dq = dS K cancels wherever the keys share a
// large common part (GPT-2's cross-attention over the narrator's 256
// pooled image tokens at initialisation), so it keeps
// whatever sum(dS) != 0 the delta leaves times that common part. From the
// forward's O, rounded to bf16 and normalised with the forward's own sum,
// that residue made dq 12.7x the fp64 gradient's norm there (bf16, H100);
// from the same P it is fp32 rounding. The pass costs two more products
// in dq (S and dP again), none in dk/dv.
//
// What bounds it on the H100: at the text towers' shape (L = 77, d = 64,
// causal) attention does ~2*L*d FLOPs per query against ~8*d bytes of
// q/k/v/out in bf16, ~40 FLOPs per byte, far below the card's ~295: the
// forward's floor is one pass over q/k/v/out (1.5 us at 16 captions x 8
// heads, 24 us at 256), the backward's one pass over q/k/v/dO/O/dq/dk/dv
// (3.0 us; 48 us). At 16 captions the 128 (caption, head) pairs are one
// block each, less than one wave of 132 SMs, so a call's time is the
// latency of one block's chain (copy, S, softmax, P V, store) and the
// design shortens that chain; at 256 captions several blocks an SM hide
// each other's. The caller picks the kernels (kernels/flash.py:
// flash_branch, one rule with *_fits below; the entry points refuse a
// tensor-core call outside it):
//
//  * bf16, head_dim 64, q/k/v (and dO/O) rows on 16-byte boundaries, the
//    tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; each warp
//    16 rows; a 64-row wgmma tile would pad 77 queries to 128, mma.sync
//    pads them to 80):
//    - Forward (K7, K8): one block per (128-query block, head, caption),
//      a warp per 16 queries (5 at L = 77). Every tile comes by TMA (3-D
//      tensor maps over the strided row views: columns, the caption's
//      rows, captions; rows past the caption's end read as zeros), 128-byte
//      swizzled, on mbarriers. At Lk <= 128 one key tile of round_up(Lk,
//      16) keys holds every key (80 at L = 77, so no key row is zero
//      filled past 80, and exp(s - m) is rounded to bf16 against the row's
//      own max, as the Pallas kernel's block_k = 80 rounds it), copied by
//      thread 0 with the queries; past 128 keys a producer warp streams
//      64-key tiles through a refilled 4-slot ring (lavila::sm90::Ring).
//      Fragments come by ldmatrix from the swizzled tiles (V transposed on
//      the way), so nothing is stored transposed. The softmax is the
//      loop's critical path at head_dim 64: ex2.approx, per-thread row
//      sums reduced over the quad once at the end, the mask applied only
//      to the 8-key tiles that reach past the warp's diagonal or past Lk
//      (the scale multiplies each score before the row max, one FMUL:
//      folding it into the exponent's FFMA, as K1 does, would need the
//      row's minimum under a negative scale);
//      under the causal mask a warp skips the keys past its last query
//      (S and P V), so at L = 77 warp w reads 16(w + 1) keys. The output
//      goes through the warp's rows of the Q tile to a TMA store of their
//      16-row box (2-4% less device time than 16-byte stores at 16 x 8,
//      32 x 12 and 256 x 8 captions x heads; a 64-row wgmma version was
//      8% faster at 16 x 8 and 7-11% slower at the other two).
//    - Backward at Lq, Lk <= 128 (every text tower, GPT-2's self-attention):
//      one launch, one block per (head, caption) owning the whole score
//      matrix. TMA brings Q, K, V and dO; then warp w (a) takes its 16
//      queries: per 8-key chunk S = Q K^T, dP = dO V^T and P = exp2(S
//      scale log2(e) - lse2) into delta = rowsum(P * dP) in registers;
//      then per 16-key chunk S, dP and P again, dS = P (dP - delta), dq +=
//      dS K (dS rounded to bf16 as the A fragment, K read transposed), P
//      and dS rounded to bf16 into shared memory; after one block barrier
//      (b) its 16 keys: dV += P^T dO and dK += dS^T Q, P^T and dS^T by
//      ldmatrix.trans from the query-major P and dS. 7 products against
//      the split's 9, one launch against two, no delta or reduction in
//      device memory. dq/dk/dv leave through their tiles' rows.
//    - Backward past 128 tokens (GPT-2's cross-attention over 256 image
//      tokens): the split of FlashAttention-2, two launches. dq: the
//      forward's layout over 64-key tiles in two cp.async stages, walked
//      twice (delta, then dS and dq), writing delta for dk/dv: one block
//      per 64 keys, 16 key rows a warp, streaming 64-query tiles of Q and
//      dO with their lse and delta. P and dS rounded to bf16 as in the
//      fused kernel.
//  * everything else (fp32, whose 1e-4 limit rules out bf16 or TF32
//    tensor cores; head sizes other than 64, up to 128; unaligned rows):
//    SIMT fp32 FMA, 64 rows a block, 8 a warp, tiles staged as fp32 rows
//    padded to d+1 floats so that lane j reading row j hits its own bank.
//    Under bf16 this path keeps P in fp32 for P V (bf16 rounding only).

#include <math.h>

#include "common.cuh"

namespace {

using lavila::allow_smem;
using lavila::cp_async16;
using lavila::cp_async_commit;
using lavila::cp_async_wait_prev;
using lavila::from_float;
using lavila::mma_16816;
using lavila::pack_bf16;
using lavila::quad_max;
using lavila::quad_sum;
using lavila::to_float;
using lavila::warp_max;
using lavila::warp_sum;
using namespace lavila::d64;  // kD, kRow, kChunks and the fragment helpers
namespace sm = lavila::sm90;  // mbarriers, TMA, the ring, swizzled tiles
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxWarps = 8;  // 16 rows each: up to 128 a block
constexpr int kTile = 64;     // split dq: keys per tile; dk/dv: keys per
                              // block and queries per tile
constexpr int kTileElems = kTile * kRow;
constexpr int kDkvWarps = 4;  // 16 key rows each
constexpr int kOneTile = 128;  // up to this many keys (and, backward,
                               // queries) the tensor cores take one tile
constexpr int kStages = 4;     // ring slots of 64-key tiles past it
constexpr int kRowBytes = kD * 2;  // a TMA tile's row: 64 bf16

// key j is attended by query i
__device__ __forceinline__ bool attends(int i, int j, int Lk, int causal) {
  return j < Lk && (!causal || j <= i);
}

// The keys that queries q_base..q_base+nq-1 need: all Lk, or under the
// causal mask those up to the block's last query.
__device__ __forceinline__ int keys_needed(int q_base, int nq, int Lq,
                                           int Lk, int causal) {
  return causal ? min(Lk, min(q_base + nq, Lq)) : Lk;
}

// ---- the TMA tensor-core kernels (bf16, head_dim 64) ---------------------

// shared address of 16-byte chunk c (0..7) of row r of a tile that TMA
// wrote with the 128-byte swizzle (from a 1024-byte boundary: chunk c of
// row r sits at c ^ (r % 8))
__device__ __forceinline__ unsigned sw_addr(unsigned tile, int r, int c) {
  return tile + r * kRowBytes + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm4(unsigned (&x)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4_t(unsigned (&x)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(addr)
      : "memory");
}

// The A fragments of rows r0..r0+15 x 64 dims (4 k-steps) of a swizzled
// tile.
__device__ __forceinline__ void sw_rows_a(unsigned (&a)[kD / 16][4],
                                          unsigned tile, int r0, int lane) {
  const int r = r0 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldsm4(a[kk], sw_addr(tile, r, 2 * kk + (lane >> 4)));
}

// s (16 rows x 8 keys) = A (16 rows x 64 dims, fragments a) . rows
// key0..key0+7 of a swizzled [key][d] tile
__device__ __forceinline__ void sw_scores(float (&s)[4],
                                          const unsigned (&a)[kD / 16][4],
                                          unsigned tile, int key0, int lane) {
  unsigned lo[4], hi[4];  // 16-byte chunks 0..3 and 4..7 of the 8 rows
  const int r = key0 + (lane & 7);
  ldsm4(lo, sw_addr(tile, r, lane >> 3));
  ldsm4(hi, sw_addr(tile, r, 4 + (lane >> 3)));
  s[0] = s[1] = s[2] = s[3] = 0.f;
  mma_16816(s, a[0], lo[0], lo[1]);
  mma_16816(s, a[1], lo[2], lo[3]);
  mma_16816(s, a[2], hi[0], hi[1]);
  mma_16816(s, a[3], hi[2], hi[3]);
}

// acc (16 rows x 64) += A (16 x 16, fragments a) * rows k0..k0+15 of a
// swizzled [k][64] tile, transposed on the way by ldmatrix
__device__ __forceinline__ void sw_mma_rows(float (&acc)[kD / 8][4],
                                            const unsigned (&a)[4],
                                            unsigned tile, int k0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < kD / 16; ++p) {
    unsigned b[4];
    ldsm4_t(b, sw_addr(tile, r, 2 * p + (lane >> 4)));
    mma_16816(acc[2 * p], a, b[0], b[1]);
    mma_16816(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// The A fragment (16 x 16) of the transpose of rows q0..q0+15, columns
// c0..c0+15 of a row-major bf16 matrix m (row stride ld elements):
// A[i][j] = m[q0 + j][c0 + i].
__device__ __forceinline__ void ldsm_at(unsigned (&a)[4], const bf16* m,
                                        int ld, int q0, int c0, int lane) {
  const int r = q0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = c0 + (((lane >> 3) & 1) << 3);
  ldsm4_t(a, sm::smem_addr(m + r * ld + c));
}

// A warp's 16 x 64 result (rows r0 + g and r0 + g + 8 of this lane, times
// mul0 / mul1) as bf16 into rows r0.. of a swizzled tile that only this
// warp uses now.
__device__ __forceinline__ void stage_rows_sw(void* tile, int r0,
                                              const float (&acc)[kD / 8][4],
                                              float mul0, float mul1,
                                              int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int c = 8 * dn + 2 * t4;
    *reinterpret_cast<unsigned*>(sm::swizzled(tile, r0 + g, c)) =
        pack_bf16(acc[dn][0] * mul0, acc[dn][1] * mul0);
    *reinterpret_cast<unsigned*>(sm::swizzled(tile, r0 + g + 8, c)) =
        pack_bf16(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

// ... and on to bf16 rows dst + r * ld (r = 0..15) by 16-byte stores, rows
// at or past `rows` skipped.
__device__ __forceinline__ void store_rows_sw(void* tile, int r0,
                                              const float (&acc)[kD / 8][4],
                                              float mul0, float mul1,
                                              bf16* dst, long long ld,
                                              int rows, int lane) {
  stage_rows_sw(tile, r0, acc, mul0, mul1, lane);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(sm::swizzled(tile, r0 + r, c));
  }
}

__device__ __forceinline__ void scale_rows(float (&o)[kD / 8][4], float c0,
                                           float c1) {
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    o[dn][0] *= c0;
    o[dn][1] *= c0;
    o[dn][2] *= c1;
    o[dn][3] *= c1;
  }
}

// Forward: grid (ceil(Lq / (16 * qwarps)), H, B), 32 * qwarps threads
// (+ 32 for the producer warp with RING). Key tiles of KT keys: one tile
// of KT = round_up(Lk, 16) <= 128 keys, or (RING) 64-key tiles in a ring
// of kStages slots. tq/tk/tv: tensor maps of the row views (columns, the
// caption's rows, captions) with boxes of 16 * qwarps and KT rows; tout:
// out's, with a box of 16 rows. lse == nullptr: K7, no lse written.
template <int KT, bool RING>
__global__ void __launch_bounds__(kMaxWarps * 32 + 32)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tout,
                        float* __restrict__ lse, int H, int Lq, int Lk,
                        float scale, int causal) {
  constexpr int S = RING ? kStages : 1;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bar_q;
  __shared__ __align__(8) sm::Ring<S> ring;
  const int qwarps = (blockDim.x >> 5) - (RING ? 1 : 0);
  const int nq = 16 * qwarps;
  const int q_base = blockIdx.x * nq;
  const int h = blockIdx.y, b = blockIdx.z, col = h * kD;
  const int keys = keys_needed(q_base, nq, Lq, Lk, causal);
  const int tiles = RING ? (keys + KT - 1) / KT : 1;
  bf16* qs = sm::align1024(smem_raw);
  bf16* kv = qs + nq * kD;  // slot s: K at kv + 2 s KT kD, then V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sm::mbar_init(&bar_q, 1);
    ring.init(32 * qwarps);
    sm::mbar_fence_init();
  }
  __syncthreads();
  // the copies: past 128 keys by the producer warp, else by thread 0,
  // which then joins the consumers
  if (threadIdx.x == (RING ? 32 * qwarps : 0)) {
    sm::mbar_expect_tx(&bar_q, nq * kRowBytes);
    sm::tma_load_3d(qs, &tq, &bar_q, col, q_base, b);
    for (int t = 0; t < tiles; ++t) {
      unsigned long long* full = ring.acquire(t);
      bf16* dst = kv + 2 * (t % S) * KT * kD;
      sm::mbar_expect_tx(full, 2 * KT * kRowBytes);
      sm::tma_load_3d(dst, &tk, full, col, t * KT, b);
      sm::tma_load_3d(dst + KT * kD, &tv, full, col, t * KT, b);
    }
  }
  if (RING && warp == qwarps) return;

  const int g = lane >> 2, t4 = lane & 3;
  const int r_lo = q_base + 16 * warp;  // the warp's first query
  const int n0 = r_lo + g, n1 = n0 + 8;
  // the keys that the warp's rows attend at most, and those that all of
  // them attend; a warp past the last query has nothing to do
  const int lim = r_lo >= Lq ? 0 : causal ? min(Lk, r_lo + 16) : Lk;
  const int all = causal ? min(Lk, r_lo + 1) : Lk;
  const float sl2 = scale * kLog2e;  // scores in the log2 domain

  sm::mbar_wait(&bar_q, 0);
  __syncwarp();
  unsigned qa[kD / 16][4];
  sw_rows_a(qa, sm::smem_addr(qs), 16 * warp, lane);
  float o[kD / 8][4];
  zero(o);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < tiles; ++kt) {
    ring.wait(kt);
    const int j0 = kt * KT;
    if (j0 < lim) {
      const unsigned kb = sm::smem_addr(kv + 2 * (kt % S) * KT * kD);
      const unsigned vb = kb + KT * kRowBytes;
      float s[KT / 8][4];
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        const int j = j0 + 8 * nt;
        if (j >= lim) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = -INFINITY;
          continue;
        }
        sw_scores(s[nt], qa, kb, 8 * nt, lane);
        const bool edge = j + 8 > all;  // some key here is masked
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[nt][e] * sl2, x1 = s[nt][2 + e] * sl2;
          if (edge) {
            const int jj = j + 2 * t4 + e;
            if (!attends(n0, jj, Lk, causal)) x0 = -INFINITY;
            if (!attends(n1, jj, Lk, causal)) x1 = -INFINITY;
          }
          s[nt][e] = x0;
          s[nt][2 + e] = x1;
          t0 = fmaxf(t0, x0);
          t1 = fmaxf(t1, x1);
        }
      }
      // finite from the warp's first tile on: every query attends key 0
      const float mn0 = fmaxf(m0, quad_max(t0));
      const float mn1 = fmaxf(m1, quad_max(t1));
      const float c0 = sm::fast_exp2(m0 - mn0), c1 = sm::fast_exp2(m1 - mn1);
      float r0 = 0.f, r1 = 0.f;  // this thread's share of the row sums
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        if (j0 + 16 * (nt / 2) >= lim) continue;  // no P V step reads it
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = sm::fast_exp2(s[nt][e] - mn0);
          s[nt][2 + e] = sm::fast_exp2(s[nt][2 + e] - mn1);
          r0 += s[nt][e];
          r1 += s[nt][2 + e];
        }
      }
      l0 = l0 * c0 + r0;
      l1 = l1 * c1 + r1;
      m0 = mn0;
      m1 = mn1;
      scale_rows(o, c0, c1);
      // O += P V: score tiles 2kk, 2kk+1 are the A fragment of keys
      // 16kk..16kk+15
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        if (j0 + 16 * kk >= lim) continue;
        const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        sw_mma_rows(o, pa, vb, 16 * kk, lane);
      }
    }
    if (RING) ring.release(kt);
  }
  if (lim == 0) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // out through the warp's rows of the Q tile (its Q is in registers) by
  // a TMA store of their 16-row box; rows past Lq are not written
  stage_rows_sw(qs, 16 * warp, o, 1.f / l0, 1.f / l1, lane);
  sm::fence_proxy_async();
  __syncwarp();
  if (lane == 0) sm::tma_store_3d(&tout, qs + 16 * warp * kD, col, r_lo, b);
  const long long row = (long long)b * Lq + r_lo;
  if (lse != nullptr && t4 == 0) {
    if (n0 < Lq) lse[(row + g) * H + h] = (m0 + log2f(l0)) * kLn2;
    if (n1 < Lq) lse[(row + g + 8) * H + h] = (m1 + log2f(l1)) * kLn2;
  }
}

size_t fwd_tc_smem_bytes(int nq, int kt, int stages) {
  // the query tile, `stages` K and V tiles, and slack to put the first on
  // a 1024-byte boundary (the 128-byte swizzle's period)
  return (size_t)(nq + 2 * stages * kt) * kRowBytes + 1024;
}

size_t bwd_fused_smem_bytes(int QR, int KR) {
  // Q, dO, dq (QR rows) and K, V (KR rows) swizzled; P and dS (QR x (KR +
  // 8) bf16: the padding puts ldmatrix's 8 rows on distinct banks); slack
  return (size_t)(3 * QR + 2 * KR) * kRowBytes +
         2 * (size_t)QR * (KR + 8) * sizeof(bf16) + 1024;
}

// Backward at Lq, Lk <= 128: grid (H, B), 32 * max(QR, KR) / 16 threads
// (QR, KR = Lq, Lk rounded up to 16). tq/tk/tv/tdo: tensor maps with
// boxes of QR (queries) and KR (keys) rows. Warp w takes queries 16w..
// (dq), then, after one block barrier, keys 16w.. (dk, dv).
__global__ void __launch_bounds__(kMaxWarps * 32)
    flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           bf16* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int H, int Lq, int Lk,
                           float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bar;
  const int QR = (Lq + 15) & ~15, KR = (Lk + 15) & ~15;
  const int ld = KR + 8;  // P and dS row stride
  const int h = blockIdx.x, b = blockIdx.y, col = h * kD;
  bf16* qs = sm::align1024(smem_raw);
  bf16* gs = qs + QR * kD;   // dO
  bf16* os = gs + QR * kD;   // dq on its way out
  bf16* ks = os + QR * kD;   // K, then dk
  bf16* vs = ks + KR * kD;   // V, then dv
  bf16* ps = vs + KR * kD;   // P [query][key]
  bf16* dss = ps + QR * ld;  // dS [query][key]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  if (threadIdx.x == 0) {
    sm::mbar_init(&bar, 1);
    sm::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm::mbar_expect_tx(&bar, (2 * QR + 2 * KR) * kRowBytes);
    sm::tma_load_3d(qs, &tq, &bar, col, 0, b);
    sm::tma_load_3d(ks, &tk, &bar, col, 0, b);
    sm::tma_load_3d(gs, &tdo, &bar, col, 0, b);
    sm::tma_load_3d(vs, &tv, &bar, col, 0, b);
  }
  const long long D = (long long)H * kD;
  const float sl2 = scale * kLog2e;
  const unsigned qb = sm::smem_addr(qs), gb = sm::smem_addr(gs);
  const unsigned kb = sm::smem_addr(ks), vb = sm::smem_addr(vs);
  sm::mbar_wait(&bar, 0);
  __syncwarp();

  // (a) queries 16w..16w+15: rows n0 = 16w + g and n1 = n0 + 8 of this lane
  if (16 * warp < Lq) {
    const int r0 = 16 * warp, n0 = r0 + g, n1 = n0 + 8;
    unsigned qa[kD / 16][4], ga[kD / 16][4];
    sw_rows_a(qa, qb, r0, lane);
    sw_rows_a(ga, gb, r0, lane);
    // log2 domain; a padded row's +inf makes its P (and dS) zero
    const long long row = (long long)b * Lq;
    const float l0 = n0 < Lq ? lse[(row + n0) * H + h] * kLog2e : INFINITY;
    const float l1 = n1 < Lq ? lse[(row + n1) * H + h] * kLog2e : INFINITY;
    const int lim = causal ? min(Lk, r0 + 16) : Lk;
    const int all = causal ? min(Lk, r0 + 1) : Lk;
    // delta = rowsum(P * dP) over the P of the loop below, bit for bit:
    // a first pass over this lane's keys of rows n0 and n1, then over the
    // quad (the header says why not rowsum(dO * O))
    float d0 = 0.f, d1 = 0.f;
    for (int j = 0; j < lim; j += 8) {
      float s[4], dp[4];
      sw_scores(s, qa, kb, j, lane);
      sw_scores(dp, ga, vb, j, lane);
      const bool edge = j + 8 > all;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = j + 2 * t4 + e;
        float p0 = sm::fast_exp2(fmaf(s[e], sl2, -l0));
        float p1 = sm::fast_exp2(fmaf(s[2 + e], sl2, -l1));
        if (edge) {
          if (!attends(n0, jj, Lk, causal)) p0 = 0.f;
          if (!attends(n1, jj, Lk, causal)) p1 = 0.f;
        }
        d0 = fmaf(p0, dp[e], d0);
        d1 = fmaf(p1, dp[2 + e], d1);
      }
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    float acc[kD / 8][4];
    zero(acc);
    for (int j16 = 0; j16 < lim; j16 += 16) {
      float ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = j16 + 8 * half;
        float s[4], dp[4], p[4];
        sw_scores(s, qa, kb, j, lane);
        sw_scores(dp, ga, vb, j, lane);
        const bool edge = j + 8 > all;  // some key here is masked
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = j + 2 * t4 + e;
          p[e] = sm::fast_exp2(fmaf(s[e], sl2, -l0));
          p[2 + e] = sm::fast_exp2(fmaf(s[2 + e], sl2, -l1));
          if (edge) {
            if (!attends(n0, jj, Lk, causal)) p[e] = 0.f;
            if (!attends(n1, jj, Lk, causal)) p[2 + e] = 0.f;
          }
          ds[half][e] = p[e] * (dp[e] - d0);
          ds[half][2 + e] = p[2 + e] * (dp[2 + e] - d1);
        }
        // P and dS, rounded to bf16, for the keys' half
        const int c = j + 2 * t4;
        *reinterpret_cast<unsigned*>(ps + n0 * ld + c) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<unsigned*>(ps + n1 * ld + c) = pack_bf16(p[2], p[3]);
        *reinterpret_cast<unsigned*>(dss + n0 * ld + c) =
            pack_bf16(ds[half][0], ds[half][1]);
        *reinterpret_cast<unsigned*>(dss + n1 * ld + c) =
            pack_bf16(ds[half][2], ds[half][3]);
      }
      // dq += dS K: dS rounded to bf16 (k's dtype) as the A fragment
      const unsigned da[4] = {pack_bf16(ds[0][0], ds[0][1]),
                              pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]),
                              pack_bf16(ds[1][2], ds[1][3])};
      sw_mma_rows(acc, da, kb, j16, lane);
    }
    // dq = scale dS K, through the warp's rows of the dq tile
    store_rows_sw(os, r0, acc, scale, scale, dq + (row + r0) * D + col, D,
                  Lq - r0, lane);
  }
  __syncthreads();  // P and dS complete; K and V free

  // (b) keys 16w..16w+15: dV = P^T dO and dK = dS^T Q over the query
  // chunks that can attend them (under the causal mask, from the warp's
  // own chunk on); P^T and dS^T by ldmatrix.trans
  if (16 * warp < Lk) {
    const int j0 = 16 * warp;
    float ak[kD / 8][4], av[kD / 8][4];
    zero(ak);
    zero(av);
    for (int q16 = causal ? j0 : 0; q16 < Lq; q16 += 16) {
      unsigned pa[4], sa[4];
      ldsm_at(pa, ps, ld, q16, j0, lane);
      ldsm_at(sa, dss, ld, q16, j0, lane);
      sw_mma_rows(av, pa, gb, q16, lane);
      sw_mma_rows(ak, sa, qb, q16, lane);
    }
    const long long row = (long long)b * Lk + j0;
    store_rows_sw(ks, j0, ak, scale, scale, dk + row * D + col, D, Lk - j0,
                  lane);
    store_rows_sw(vs, j0, av, 1.f, 1.f, dv + row * D + col, D, Lk - j0, lane);
  }
}

// ---- the split backward past 128 tokens: mma.sync over cp.async tiles

// Copy rows first..first+ROWS-1 of one batch element (row r at x + (row0 +
// r) * rs, head slice at column col) into a [row][d] bf16 tile; zeros from
// row `rows` on.
template <int ROWS>
__device__ __forceinline__ void async_rows(bf16* dst, const bf16* x,
                                           long long rs, long long row0,
                                           int col, int first, int rows) {
  for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = first + r < rows;
    const bf16* src = ok ? x + (row0 + first + r) * rs + col + 8 * c : x;
    cp_async16(dst + r * kRow + 8 * c, src, ok);
  }
}

// dq: grid (ceil(Lq / (16 * warps)), H, B), warps * 32 threads. Each
// warp's 16 query rows walk the 64-key tiles (two stages) of K and V
// [key][d] twice, S = Q K^T and dP = dO V^T on the tensor cores each
// time: the first pass sums delta = rowsum(P * dP) (written out for the
// dk/dv kernel), the second forms dS = P (dP - delta) in registers and
// multiplies dS (rounded to bf16 as the A operand) by K into dq.
__global__ void __launch_bounds__(kMaxWarps * 32)
    flash_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq,
                        int H, int Lq, int Lk, long long q_rs, long long k_rs,
                        long long v_rs, float scale, int causal) {
  __shared__ __align__(16) bf16 tiles[2 * 2 * kTileElems];
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * kD;
  const long long D = (long long)H * kD;
  const long long qrow0 = (long long)b * Lq, krow0 = (long long)b * Lk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (blockDim.x >> 5) * 16;
  const int q_base = blockIdx.x * nq;
  const int n0 = q_base + warp * 16 + g, n1 = n0 + 8;
  const bool ok0 = n0 < Lq, ok1 = n1 < Lq;
  const float sl2 = scale * kLog2e;
  const int keys = keys_needed(q_base, nq, Lq, Lk, causal);
  const int n_tiles = (keys + kTile - 1) / kTile;

  // step it of the two passes reads key tile it % n_tiles into stage it & 1
  auto stage = [&](int it) {
    const int kt = it < n_tiles ? it : it - n_tiles;
    bf16* ks = tiles + (it & 1) * 2 * kTileElems;
    async_rows<kTile>(ks, k, k_rs, krow0, col, kt * kTile, keys);
    async_rows<kTile>(ks + kTileElems, v, v_rs, krow0, col, kt * kTile,
                      keys);
    cp_async_commit();
  };
  stage(0);

  unsigned qa[kD / 16][4], ga[kD / 16][4];
  load_rows(qa, q + (qrow0 + n0) * q_rs + col, q + (qrow0 + n1) * q_rs + col,
            ok0, ok1, t);
  load_rows(ga, dout + (qrow0 + n0) * D + col, dout + (qrow0 + n1) * D + col,
            ok0, ok1, t);
  const float l0 = ok0 ? lse[(qrow0 + n0) * H + h] * kLog2e : 0.f;
  const float l1 = ok1 ? lse[(qrow0 + n1) * H + h] * kLog2e : 0.f;

  // delta over this lane's keys of rows n0 and n1, then over the quad;
  // padded rows: q = dO = 0, so dP = 0, delta = 0 and dS = 0
  float d0 = 0.f, d1 = 0.f;
  float acc[kD / 8][4];
  zero(acc);
  for (int it = 0; it < 2 * n_tiles; ++it) {
    if (it + 1 < 2 * n_tiles) stage(it + 1);
    else cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const bool first = it < n_tiles;  // the delta pass
    const int kt = first ? it : it - n_tiles;
    if (it == n_tiles) {
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
      if (t == 0) {
        if (ok0) delta[(qrow0 + n0) * H + h] = d0;
        if (ok1) delta[(qrow0 + n1) * H + h] = d1;
      }
    }
    const bf16* ks = tiles + (it & 1) * 2 * kTileElems;
    const bf16* vs = ks + kTileElems;
#pragma unroll
    for (int st = 0; st < kTile / 16; ++st) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mma_scores(s[half], qa, ks, 2 * st + half, g, t);
        mma_scores(dp[half], ga, vs, 2 * st + half, g, t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = kt * kTile + (2 * st + half) * 8 + 2 * t + e;
          const float p0 =
              attends(n0, j, Lk, causal) ? exp2f(s[half][e] * sl2 - l0) : 0.f;
          const float p1 = attends(n1, j, Lk, causal)
                               ? exp2f(s[half][2 + e] * sl2 - l1)
                               : 0.f;
          if (first) {
            d0 = fmaf(p0, dp[half][e], d0);
            d1 = fmaf(p1, dp[half][2 + e], d1);
          } else {
            s[half][e] = p0 * (dp[half][e] - d0);          // dS, row n0
            s[half][2 + e] = p1 * (dp[half][2 + e] - d1);  // dS, row n1
          }
        }
      }
      if (!first) {
        const unsigned da[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
        mma_rows(acc, da, ks, st * 16, lane);
      }
    }
    __syncthreads();  // this stage is refilled two steps on
  }
  store_rows(dq + (qrow0 + n0) * D + col, dq + (qrow0 + n1) * D + col, ok0,
             ok1, acc, scale, scale, t);
}

// dk/dv: grid (ceil(Lk / 64), H, B), kDkvWarps * 32 threads. Each warp
// holds 16 key rows; per 64-query tile (two stages), Q and dO [query][d]
// with lse and delta per query; S^T = K Q^T and dP^T = V dO^T on the
// tensor cores, P^T and dS^T in registers, then P^T dO into dV and dS^T Q
// into dK. Under the causal mask the tiles of queries before the block's
// first key are not read (none of them attends these keys).
__global__ void __launch_bounds__(kDkvWarps * 32)
    flash_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int Lq, int Lk, long long q_rs, long long k_rs,
                         long long v_rs, float scale, int causal) {
  __shared__ __align__(16) bf16 tiles[2 * 2 * kTileElems];
  __shared__ float stats[2][2][kTile];  // per stage: lse (log2), delta
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * kD;
  const long long D = (long long)H * kD;
  const long long qrow0 = (long long)b * Lq, krow0 = (long long)b * Lk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j_base = blockIdx.x * kTile;
  const int j0 = j_base + warp * 16 + g, j1 = j0 + 8;
  const float sl2 = scale * kLog2e;

  auto stage = [&](int qt) {
    bf16* qs = tiles + (qt & 1) * 2 * kTileElems;
    async_rows<kTile>(qs, q, q_rs, qrow0, col, qt * kTile, Lq);
    async_rows<kTile>(qs + kTileElems, dout, D, qrow0, col, qt * kTile, Lq);
    cp_async_commit();
    for (int nn = threadIdx.x; nn < kTile; nn += blockDim.x) {
      const int n = qt * kTile + nn;
      // padded queries: P = exp2(s - inf) = 0, so they add nothing
      stats[qt & 1][0][nn] =
          n < Lq ? lse[(qrow0 + n) * H + h] * kLog2e : INFINITY;
      stats[qt & 1][1][nn] = n < Lq ? delta[(qrow0 + n) * H + h] : 0.f;
    }
  };
  const int n_tiles = (Lq + kTile - 1) / kTile;
  const int first = causal ? j_base / kTile : 0;
  if (first < n_tiles) stage(first);

  unsigned ka[kD / 16][4], va[kD / 16][4];
  load_rows(ka, k + (krow0 + j0) * k_rs + col, k + (krow0 + j1) * k_rs + col,
            j0 < Lk, j1 < Lk, t);
  load_rows(va, v + (krow0 + j0) * v_rs + col, v + (krow0 + j1) * v_rs + col,
            j0 < Lk, j1 < Lk, t);
  float ak[kD / 8][4], av[kD / 8][4];
  zero(ak);
  zero(av);

  for (int qt = first; qt < n_tiles; ++qt) {
    if (qt + 1 < n_tiles) stage(qt + 1);
    else cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const bf16* qs = tiles + (qt & 1) * 2 * kTileElems;
    const bf16* gs = qs + kTileElems;
    const float* lses = stats[qt & 1][0];
    const float* deltas = stats[qt & 1][1];
#pragma unroll
    for (int st = 0; st < kTile / 16; ++st) {
      float s[2][4], dp[2][4], p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mma_scores(s[half], ka, qs, 2 * st + half, g, t);
        mma_scores(dp[half], va, gs, 2 * st + half, g, t);
        // columns are queries nn = (2st+half)*8 + 2t + e; rows j0 and j1
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = (2 * st + half) * 8 + 2 * t + e;
          const int n = qt * kTile + nn;
          const float l = lses[nn], dl = deltas[nn];
          p[half][e] =
              !causal || j0 <= n ? exp2f(s[half][e] * sl2 - l) : 0.f;
          p[half][2 + e] =
              !causal || j1 <= n ? exp2f(s[half][2 + e] * sl2 - l) : 0.f;
          s[half][e] = p[half][e] * (dp[half][e] - dl);
          s[half][2 + e] = p[half][2 + e] * (dp[half][2 + e] - dl);
        }
      }
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
      const unsigned sa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      mma_rows(av, pa, gs, st * 16, lane);
      mma_rows(ak, sa, qs, st * 16, lane);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  store_rows(dk + (krow0 + j0) * D + col, dk + (krow0 + j1) * D + col,
             j0 < Lk, j1 < Lk, ak, scale, scale, t);
  store_rows(dv + (krow0 + j0) * D + col, dv + (krow0 + j1) * D + col,
             j0 < Lk, j1 < Lk, av, 1.f, 1.f, t);
}

// ---- SIMT kernels (fp32 and bf16, any head_dim <= 128) -------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kTile / kWarps;  // 8
constexpr int kMaxDimsPerLane = 4;            // head_dim <= 128

// Stage rows first..first+63 of one batch element (head slice at col) as
// fp32 [row][ld], times `mul`; zeros from row `rows` on.
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const T* x,
                                          long long rs, long long row0,
                                          int col, int d, int first, int rows,
                                          float mul) {
  for (int i = threadIdx.x; i < kTile * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const int j = first + r;
    dst[r * ld + c] = j < rows ? to_float(x[(row0 + j) * rs + col + c]) * mul
                               : 0.f;
  }
}

size_t fwd_smem_bytes(int d) {
  // K and V tiles [64][d+1], the block's scaled queries [64][d], P per warp
  return ((size_t)2 * kTile * (d + 1) + (size_t)kTile * d +
          (size_t)kWarps * kTile) *
         sizeof(float);
}

// forward: grid (ceil(Lq/64), H, B), kWarps*32 threads; warp w owns query
// rows 8w..8w+7 of the block. lse == nullptr: K7.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Lq, int Lk, int d,
                     long long q_rs, long long k_rs, long long v_rs,
                     float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* ps = qs + kTile * d;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * d;
  const long long D = (long long)H * d;
  const long long qrow0 = (long long)b * Lq, krow0 = (long long)b * Lk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_base = blockIdx.x * kTile;
  float* pw = ps + warp * kTile;
  const int keys = keys_needed(n_base, kTile, Lq, Lk, causal);

  stage_f32<T>(qs, d, q, q_rs, qrow0, col, d, n_base, Lq, scale);
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int kt = 0; kt * kTile < keys; ++kt) {
    __syncthreads();
    stage_f32<T>(ks, ld, k, k_rs, krow0, col, d, kt * kTile, keys, 1.f);
    stage_f32<T>(vs, ld, v, v_rs, krow0, col, d, kt * kTile, keys, 1.f);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int n = n_base + warp * kRowsPerWarp + r;
      const float* qr = qs + (warp * kRowsPerWarp + r) * d;
      float s[2];
      float tmax = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = lane + 32 * e;
        const float* kr = ks + jj * ld;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s[e] = attends(n, kt * kTile + jj, Lk, causal) ? dot : -INFINITY;
        tmax = fmaxf(tmax, s[e]);
      }
      // finite from the first tile on: every query attends key 0
      const float mn = fmaxf(m[r], warp_max(tmax));
      const float corr = expf(m[r] - mn);
      float ts = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(s[e] - mn);
        pw[lane + 32 * e] = p;
        ts += p;
      }
      l[r] = l[r] * corr + warp_sum(ts);
      m[r] = mn;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < d) {
          float a = acc[r][i] * corr;
          for (int jj = 0; jj < kTile; ++jj)
            a = fmaf(pw[jj], vs[jj * ld + c], a);
          acc[r][i] = a;
        }
      }
      __syncwarp();  // pw is rewritten by the next row
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n_base + warp * kRowsPerWarp + r;
    if (n >= Lq) continue;
    const long long row = qrow0 + n;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < d) out[row * D + col + c] = from_float<T>(acc[r][i] * inv);
    }
    if (lse != nullptr && lane == 0) lse[row * H + h] = m[r] + logf(l[r]);
  }
}

size_t dq_smem_bytes(int d) {
  // K and V tiles [64][d+1]; the block's scaled queries and dO rows
  // [64][d]; dS per warp
  return ((size_t)2 * kTile * (d + 1) + (size_t)2 * kTile * d +
          (size_t)kWarps * kTile) *
         sizeof(float);
}

// dq: grid (ceil(Lq/64), H, B), kWarps*32 threads; warp w owns query rows
// 8w..8w+7 of the block. Two passes over the key tiles: the first sums
// (and writes) their delta = rowsum(P * dP), the second forms dS and dq.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int H,
                    int Lq, int Lk, int d, long long q_rs, long long k_rs,
                    long long v_rs, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* gs = qs + kTile * d;
  float* ss = gs + kTile * d;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * d;
  const long long D = (long long)H * d;
  const long long qrow0 = (long long)b * Lq, krow0 = (long long)b * Lk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_base = blockIdx.x * kTile;
  float* sw = ss + warp * kTile;
  const int keys = keys_needed(n_base, kTile, Lq, Lk, causal);

  stage_f32<T>(qs, d, q, q_rs, qrow0, col, d, n_base, Lq, scale);
  stage_f32<T>(gs, d, dout, D, qrow0, col, d, n_base, Lq, 1.f);
  // padded rows: q = dO = 0, so dP = 0, delta = 0 and dS = 0 there
  float lr[kRowsPerWarp], dr[kRowsPerWarp], acc[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n_base + warp * kRowsPerWarp + r;
    lr[r] = n < Lq ? lse[(qrow0 + n) * H + h] : 0.f;
    dr[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt * kTile < keys; ++kt) {
      __syncthreads();
      stage_f32<T>(ks, ld, k, k_rs, krow0, col, d, kt * kTile, keys, 1.f);
      stage_f32<T>(vs, ld, v, v_rs, krow0, col, d, kt * kTile, keys, 1.f);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int n = n_base + warp * kRowsPerWarp + r;
        const float* qr = qs + (warp * kRowsPerWarp + r) * d;
        const float* gr = gs + (warp * kRowsPerWarp + r) * d;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = lane + 32 * e;
          const float* kr = ks + jj * ld;
          const float* vr = vs + jj * ld;
          float s = 0.f, dp = 0.f;
          for (int c = 0; c < d; ++c) {
            s = fmaf(qr[c], kr[c], s);
            dp = fmaf(gr[c], vr[c], dp);
          }
          const float p =
              attends(n, kt * kTile + jj, Lk, causal) ? expf(s - lr[r]) : 0.f;
          if (pass == 0)
            dr[r] = fmaf(p, dp, dr[r]);  // this lane's keys
          else
            sw[jj] = p * (dp - dr[r]);
        }
        if (pass == 0) continue;
        __syncwarp();
#pragma unroll
        for (int i = 0; i < kMaxDimsPerLane; ++i) {
          const int c = lane + 32 * i;
          if (c < d) {
            float a = acc[r][i];
            for (int jj = 0; jj < kTile; ++jj)
              a = fmaf(sw[jj], ks[jj * ld + c], a);
            acc[r][i] = a;
          }
        }
        __syncwarp();  // sw is rewritten by the next row
      }
    }
    if (pass == 1) break;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {  // delta over the warp
      const int n = n_base + warp * kRowsPerWarp + r;
      dr[r] = warp_sum(dr[r]);
      if (n < Lq && lane == 0) delta[(qrow0 + n) * H + h] = dr[r];
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n_base + warp * kRowsPerWarp + r;
    if (n >= Lq) continue;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < d)
        dq[(qrow0 + n) * D + col + c] = from_float<T>(acc[r][i] * scale);
    }
  }
}

size_t dkv_smem_bytes(int d) {
  // Q and dO tiles [64][d+1] with lse and delta; the block's scaled keys
  // and values [64][d]; P and dS per warp
  return ((size_t)2 * kTile * (d + 1) + 2 * (size_t)kTile +
          (size_t)2 * kTile * d + (size_t)2 * kWarps * kTile) *
         sizeof(float);
}

// dk/dv: grid (ceil(Lk/64), H, B), kWarps*32 threads; warp w owns key rows
// 8w..8w+7 of the block.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Lq, int Lk, int d,
                     long long q_rs, long long k_rs, long long v_rs,
                     float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;
  float* gs = qs + kTile * ld;
  float* lses = gs + kTile * ld;
  float* deltas = lses + kTile;
  float* kw = deltas + kTile;
  float* vw = kw + kTile * d;
  float* ps = vw + kTile * d;
  float* ss = ps + kWarps * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * d;
  const long long D = (long long)H * d;
  const long long qrow0 = (long long)b * Lq, krow0 = (long long)b * Lk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j_base = blockIdx.x * kTile;
  float* pw = ps + warp * kTile;
  float* sw = ss + warp * kTile;

  stage_f32<T>(kw, d, k, k_rs, krow0, col, d, j_base, Lk, scale);
  stage_f32<T>(vw, d, v, v_rs, krow0, col, d, j_base, Lk, 1.f);
  float ak[kRowsPerWarp][kMaxDimsPerLane], av[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) ak[r][i] = av[r][i] = 0.f;

  // under the causal mask no query before the block's first key attends it
  for (int qt = causal ? j_base / kTile : 0; qt * kTile < Lq; ++qt) {
    __syncthreads();
    stage_f32<T>(qs, ld, q, q_rs, qrow0, col, d, qt * kTile, Lq, 1.f);
    stage_f32<T>(gs, ld, dout, D, qrow0, col, d, qt * kTile, Lq, 1.f);
    for (int nn = threadIdx.x; nn < kTile; nn += blockDim.x) {
      const int n = qt * kTile + nn;
      // padded queries: P = exp(s - inf) = 0, so they add nothing
      lses[nn] = n < Lq ? lse[(qrow0 + n) * H + h] : INFINITY;
      deltas[nn] = n < Lq ? delta[(qrow0 + n) * H + h] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int j = j_base + warp * kRowsPerWarp + r;
      const float* kr = kw + (warp * kRowsPerWarp + r) * d;
      const float* vr = vw + (warp * kRowsPerWarp + r) * d;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nn = lane + 32 * e;
        const float* qr = qs + nn * ld;
        const float* gr = gs + nn * ld;
        float s = 0.f, dp = 0.f;
        for (int c = 0; c < d; ++c) {
          s = fmaf(kr[c], qr[c], s);
          dp = fmaf(vr[c], gr[c], dp);
        }
        const float p =
            !causal || j <= qt * kTile + nn ? expf(s - lses[nn]) : 0.f;
        pw[nn] = p;
        sw[nn] = p * (dp - deltas[nn]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < d) {
          float gk = ak[r][i], gv = av[r][i];
          for (int nn = 0; nn < kTile; ++nn) {
            gk = fmaf(sw[nn], qs[nn * ld + c], gk);
            gv = fmaf(pw[nn], gs[nn * ld + c], gv);
          }
          ak[r][i] = gk;
          av[r][i] = gv;
        }
      }
      __syncwarp();  // pw/sw are rewritten by the next row
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int j = j_base + warp * kRowsPerWarp + r;
    if (j >= Lk) continue;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c >= d) continue;
      const long long o = (krow0 + j) * D + col + c;
      dk[o] = from_float<T>(ak[r][i] * scale);
      dv[o] = from_float<T>(av[r][i]);
    }
  }
}

// ---- launchers -----------------------------------------------------------

// What the tensor-core kernels take (kernels/flash.py:flash_branch is the
// same rule): bf16, head_dim 64, every pointer on a 16-byte boundary and
// row strides of whole 16-byte chunks (TMA; the split's cp.async). The
// backward then takes the fused kernel up to kOneTile queries and keys,
// the split past it.
bool tc_fits(int dtype, int d, std::initializer_list<const void*> ptrs,
             long long q_rs, long long k_rs, long long v_rs) {
  if (dtype != 1 || d != kD || !sm::aligned16(ptrs)) return false;
  for (long long s : {q_rs, k_rs, v_rs})
    if (s & 7ll) return false;
  return true;
}

bool fused_fits(int Lq, int Lk) { return Lq <= kOneTile && Lk <= kOneTile; }

dim3 grid(int rows, int per_block, int H, int B) {
  return dim3((unsigned)((rows + per_block - 1) / per_block), H, B);
}

// warps of the query blocks: 16 queries each, as few as hold every query
// up to 8
int query_warps(int Lq) { return Lq < 16 * kMaxWarps ? (Lq + 15) / 16 : kMaxWarps; }

int round16(int n) { return (n + 15) & ~15; }

// Dynamic shared memory above 48 KB needs an opt-in per kernel and device;
// a launcher makes it once per device (a static of its own), for the most
// that its kernel ever asks.
struct SmemOptIn {
  unsigned long long devices = 0;  // bit d: made on device d
  template <typename Kernel>
  cudaError_t ensure(Kernel kernel, size_t most) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && (devices >> dev & 1ull)) return cudaSuccess;
    if ((err = allow_smem(kernel, most)) == cudaSuccess && dev < 64)
      devices |= 1ull << dev;
    return err;
  }
};

template <int KT, bool RING>
cudaError_t launch_fwd_tc_kt(const CUtensorMap& tq, const CUtensorMap& tk,
                             const CUtensorMap& tv, const CUtensorMap& tout,
                             void* lse, int B, int H, int Lq, int Lk,
                             int qwarps, float scale, int causal,
                             cudaStream_t stream) {
  constexpr int S = RING ? kStages : 1;
  static SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(flash_fwd_tc_kernel<KT, RING>,
                                  fwd_tc_smem_bytes(16 * kMaxWarps, KT, S));
  if (err != cudaSuccess) return err;
  flash_fwd_tc_kernel<KT, RING>
      <<<grid(Lq, 16 * qwarps, H, B), 32 * qwarps + (RING ? 32 : 0),
         fwd_tc_smem_bytes(16 * qwarps, KT, S), stream>>>(
          tq, tk, tv, tout, (float*)lse, H, Lq, Lk, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* out, void* lse, int B, int H, int Lq, int Lk,
                          long long q_rs, long long k_rs, long long v_rs,
                          float scale, int causal, cudaStream_t stream) {
  const int qwarps = query_warps(Lq);
  const int kt = Lk <= kOneTile ? round16(Lk) : kTile;
  const int D = H * kD;
  CUtensorMap tq, tk, tv, tout;
  if (!sm::rows_map(&tq, q, q_rs, D, Lq, B, 16 * qwarps) ||
      !sm::rows_map(&tk, k, k_rs, D, Lk, B, kt) ||
      !sm::rows_map(&tv, v, v_rs, D, Lk, B, kt) ||
      !sm::rows_map(&tout, out, D, D, Lq, B, 16))
    return cudaErrorInvalidValue;
#define LAVILA_FWD(KT, RING)                                                 \
  return launch_fwd_tc_kt<KT, RING>(tq, tk, tv, tout, lse, B, H, Lq, Lk,     \
                                    qwarps, scale, causal, stream)
  if (Lk > kOneTile) LAVILA_FWD(kTile, true);
  switch (kt / 16) {
    case 1: LAVILA_FWD(16, false);
    case 2: LAVILA_FWD(32, false);
    case 3: LAVILA_FWD(48, false);
    case 4: LAVILA_FWD(64, false);
    case 5: LAVILA_FWD(80, false);
    case 6: LAVILA_FWD(96, false);
    case 7: LAVILA_FWD(112, false);
    case 8: LAVILA_FWD(128, false);
  }
#undef LAVILA_FWD
  return cudaErrorInvalidValue;
}

cudaError_t launch_bwd_fused(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, void* dq,
                             void* dk, void* dv, int B, int H, int Lq, int Lk,
                             long long q_rs, long long k_rs, long long v_rs,
                             float scale, int causal, cudaStream_t stream) {
  const int QR = round16(Lq), KR = round16(Lk), D = H * kD;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm::rows_map(&tq, q, q_rs, D, Lq, B, QR) ||
      !sm::rows_map(&tk, k, k_rs, D, Lk, B, KR) ||
      !sm::rows_map(&tv, v, v_rs, D, Lk, B, KR) ||
      !sm::rows_map(&tdo, dout, D, D, Lq, B, QR))
    return cudaErrorInvalidValue;
  static SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(flash_bwd_fused_kernel,
                                  bwd_fused_smem_bytes(kOneTile, kOneTile));
  if (err != cudaSuccess) return err;
  const int warps = (QR > KR ? QR : KR) / 16;
  flash_bwd_fused_kernel<<<dim3(H, B), 32 * warps,
                           bwd_fused_smem_bytes(QR, KR), stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (bf16*)dq, (bf16*)dk, (bf16*)dv, H,
      Lq, Lk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int H, int Lq, int Lk,
                       int d, long long q_rs, long long k_rs, long long v_rs,
                       float scale, int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(d);
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T><<<grid(Lq, kTile, H, B), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, H, Lq, Lk,
      d, q_rs, k_rs, v_rs, scale, causal);
  return cudaGetLastError();
}

bool shape_ok(int B, int H, int Lq, int Lk, int d) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Lq >= 1 && Lk >= 1 &&
         d >= 1 && d <= 32 * kMaxDimsPerLane;
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, void* delta,
                      void* dq, int B, int H, int Lq, int Lk, int d,
                      long long q_rs, long long k_rs, long long v_rs,
                      float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(d);
  cudaError_t err = allow_smem(flash_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T><<<grid(Lq, kTile, H, B), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (float*)delta, (T*)dq, H, Lq, Lk, d, q_rs, k_rs,
      v_rs, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Lq, int Lk,
                       int d, long long q_rs, long long k_rs, long long v_rs,
                       float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(d);
  cudaError_t err = allow_smem(flash_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T><<<grid(Lk, kTile, H, B), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H, Lq, Lk, d,
      q_rs, k_rs, v_rs, scale, causal);
  return cudaGetLastError();
}

int forward(const void* q, const void* k, const void* v, void* out,
            void* lse, int B, int H, int Lq, int Lk, int d, long long q_rs,
            long long k_rs, long long v_rs, float scale, int causal,
            int dtype, int tc, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    if (!tc_fits(dtype, d, {q, k, v, out}, q_rs, k_rs, v_rs))
      return (int)cudaErrorInvalidValue;
    return (int)launch_fwd_tc(q, k, v, out, lse, B, H, Lq, Lk, q_rs, k_rs,
                              v_rs, scale, causal, s);
  }
  if (dtype == 0)
    return (int)launch_fwd<float>(q, k, v, out, lse, B, H, Lq, Lk, d, q_rs,
                                  k_rs, v_rs, scale, causal, s);
  if (dtype == 1)
    return (int)launch_fwd<bf16>(q, k, v, out, lse, B, H, Lq, Lk, d, q_rs,
                                 k_rs, v_rs, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes. q/k/v: row views, row r of batch
// element b at (b * L + r) * rs, head h at column h * d; every other
// tensor contiguous as the header says. dtype: 0 = fp32, 1 = bf16; causal:
// 0 or 1; tc: 1 runs the tensor-core kernels, refused with
// cudaErrorInvalidValue outside tc_fits (and, for the split backward,
// where the fused kernel fits), 0 the SIMT ones. Returns the cudaError_t
// of the launch (0 on success).
extern "C" {

// K7: the forward without the log-sum-exp
int lavila_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int Lq, int Lk, int d,
                           long long q_rs, long long k_rs, long long v_rs,
                           float scale, int causal, int dtype, int tc,
                           void* stream) {
  return forward(q, k, v, out, nullptr, B, H, Lq, Lk, d, q_rs, k_rs, v_rs,
                 scale, causal, dtype, tc, stream);
}

// K8 forward: also lse (B, Lq, H) fp32
int lavila_flash_fwd(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int H, int Lq, int Lk, int d,
                     long long q_rs, long long k_rs, long long v_rs,
                     float scale, int causal, int dtype, int tc,
                     void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return forward(q, k, v, out, lse, B, H, Lq, Lk, d, q_rs, k_rs, v_rs, scale,
                 causal, dtype, tc, stream);
}

// K8 backward in one launch (tensor cores, Lq and Lk <= 128)
int lavila_flash_bwd_fused(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, void* dq,
                           void* dk, void* dv, int B, int H, int Lq, int Lk,
                           int d, long long q_rs, long long k_rs,
                           long long v_rs, float scale, int causal, int dtype,
                           void* stream) {
  if (!shape_ok(B, H, Lq, Lk, d) || !fused_fits(Lq, Lk) ||
      !tc_fits(dtype, d, {q, k, v, dout, dq, dk, dv}, q_rs, k_rs, v_rs))
    return (int)cudaErrorInvalidValue;
  return (int)launch_bwd_fused(q, k, v, dout, lse, dq, dk, dv, B, H, Lq, Lk,
                               q_rs, k_rs, v_rs, scale, causal,
                               (cudaStream_t)stream);
}

// K8 dq of the split backward; writes delta (B, Lq, H) fp32 for
// lavila_flash_bwd_dkv
int lavila_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, void* delta,
                        void* dq, int B, int H, int Lq, int Lk, int d,
                        long long q_rs, long long k_rs, long long v_rs,
                        float scale, int causal, int dtype, int tc,
                        void* stream) {
  if (!shape_ok(B, H, Lq, Lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    if (fused_fits(Lq, Lk) ||
        !tc_fits(dtype, d, {q, k, v, dout, dq}, q_rs, k_rs, v_rs))
      return (int)cudaErrorInvalidValue;
    const int warps = query_warps(Lq);
    flash_dq_mma_kernel<<<grid(Lq, 16 * warps, H, B), warps * 32, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (float*)delta, (bf16*)dq, H, Lq, Lk, q_rs, k_rs,
        v_rs, scale, causal);
    return (int)cudaGetLastError();
  }
  if (dtype == 0)
    return (int)launch_dq<float>(q, k, v, dout, lse, delta, dq, B, H, Lq, Lk,
                                 d, q_rs, k_rs, v_rs, scale, causal, s);
  if (dtype == 1)
    return (int)launch_dq<bf16>(q, k, v, dout, lse, delta, dq, B, H, Lq, Lk,
                                d, q_rs, k_rs, v_rs, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// K8 dk/dv of the split backward, after lavila_flash_bwd_dq on the same
// stream (reads its delta)
int lavila_flash_bwd_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int Lq, int Lk,
                         int d, long long q_rs, long long k_rs,
                         long long v_rs, float scale, int causal, int dtype,
                         int tc, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    if (fused_fits(Lq, Lk) ||
        !tc_fits(dtype, d, {q, k, v, dout, dk, dv}, q_rs, k_rs, v_rs))
      return (int)cudaErrorInvalidValue;
    flash_dkv_mma_kernel<<<grid(Lk, kDkvWarps * 16, H, B), kDkvWarps * 32, 0,
                           s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, H, Lq,
        Lk, q_rs, k_rs, v_rs, scale, causal);
    return (int)cudaGetLastError();
  }
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq,
                                  Lk, d, q_rs, k_rs, v_rs, scale, causal, s);
  if (dtype == 1)
    return (int)launch_dkv<bf16>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq,
                                 Lk, d, q_rs, k_rs, v_rs, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
