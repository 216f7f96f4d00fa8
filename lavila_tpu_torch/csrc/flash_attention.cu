// Flash attention for Hopper (sm_90a): K7 (forward only) and K8 (the
// forward with the log-sum-exp, and its backward: dq, then dk/dv).
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
// for K8, lse (B, Lq, H) fp32. The backward takes dO and O contiguous with
// lse; the dq kernel writes delta = rowsum(dO * O) per (query, head) (fp32
// (B, Lq, H)) as a side output, which the dk/dv kernel reads, so the
// backward is two launches. dq (B, Lq, H*d) and dk/dv (B, Lk, H*d)
// contiguous. No atomics: two calls give the same bits.
//
// What bounds it on the H100: at the text towers' shape (L = 77, d = 64,
// causal) attention does ~2*L*d FLOPs per query against ~8*d bytes of
// q/k/v/out in bf16, ~40 FLOPs per byte: far below the card's balance
// point, so the floor is one pass over q/k/v/out (~1.5 us at 16 captions
// x 8 heads), and at that size the wrapper's host cost rules. The design
// is K6's (divided_big.cu) without the CLS key:
//
//  * bf16, head_dim 64, rows on 16-byte boundaries: mma.sync m16n8k16
//    (bf16 in, fp32 accumulate), each warp 16 rows. Forward (K7, K8): one
//    block per (query block, head, batch element) of up to 8 warps (at
//    L = 77 one block of 5 warps holds every query). Keys come in tiles of
//    128 when Lk <= 128, so that at the text towers' 77 tokens one tile
//    holds every key and exp(s - m) is rounded to bf16 relative to the
//    row's own max, as in the Pallas kernel (whose block_k is 80 there);
//    in 64-key tiles in two cp.async stages otherwise. Under the causal
//    mask the key tiles past the block's last query are not read. dq: the
//    forward's layout with 64-key tiles; dS = P (dP - delta) rounded to
//    bf16 as the A operand of dS K (the Pallas kernel rounds ds to k's
//    dtype). dk/dv: one block per 64 keys, 16 key rows a warp, streaming
//    64-query tiles of Q and dO (with their lse and delta) from the first
//    tile that can see the block's keys; P^T dO and dS^T Q on the tensor
//    cores with P and dS rounded to bf16 (the Pallas kernel multiplies
//    them in fp32: bf16 rounding only), fp32 accumulators. Every B operand
//    read down its rows goes through ldmatrix's transpose.
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
using lavila::ld32;
using lavila::pack_bf16;
using lavila::quad_max;
using lavila::quad_sum;
using lavila::to_float;
using lavila::unpack_bf16;
using lavila::warp_max;
using lavila::warp_sum;
using namespace lavila::d64;  // kD, kRow, kChunks and the fragment helpers
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxWarps = 8;  // 16 query rows each: up to 128 a block
constexpr int kTile = 64;     // dq: keys per tile; dk/dv: keys per block
                              // and queries per tile
constexpr int kTileElems = kTile * kRow;
constexpr int kDkvWarps = 4;  // 16 key rows each

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

// ---- tensor-core kernels (bf16, head_dim 64) ----------------------------

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

// forward: grid (ceil(Lq / (16 * warps)), H, B), warps * 32 threads; key
// tiles of KT keys, `stages` of K and V tiles [key][d] in dynamic shared
// memory (two when there is more than one tile: the copy of tile kt+1
// runs while tile kt is used). lse == nullptr: K7, no lse written.
template <int KT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int H, int Lq, int Lk,
                         long long q_rs, long long k_rs, long long v_rs,
                         float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kElems = KT * kRow;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * kD;
  const long long D = (long long)H * kD;
  const long long qrow0 = (long long)b * Lq, krow0 = (long long)b * Lk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (blockDim.x >> 5) * 16;
  const int q_base = blockIdx.x * nq;
  const int n0 = q_base + warp * 16 + g, n1 = n0 + 8;
  const float sl2 = scale * kLog2e;  // scores in the log2 domain
  const int keys = keys_needed(q_base, nq, Lq, Lk, causal);

  auto stage = [&](int kt) {
    bf16* ks = tiles + (kt & 1) * 2 * kElems;
    async_rows<KT>(ks, k, k_rs, krow0, col, kt * KT, keys);
    async_rows<KT>(ks + kElems, v, v_rs, krow0, col, kt * KT, keys);
    cp_async_commit();
  };
  stage(0);

  unsigned qa[kD / 16][4];
  load_rows(qa, q + (qrow0 + n0) * q_rs + col, q + (qrow0 + n1) * q_rs + col,
            n0 < Lq, n1 < Lq, t);
  float o[kD / 8][4];
  zero(o);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (keys + KT - 1) / KT;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) stage(kt + 1);
    else cp_async_commit();  // an empty group keeps the count
    cp_async_wait_prev();
    __syncthreads();
    const bf16* ks = tiles + (kt & 1) * 2 * kElems;
    const bf16* vs = ks + kElems;

    float s[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) mma_scores(s[nt], qa, ks, nt, g, t);
    // online softmax: the tile's row maxima, rescale what came before
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = kt * KT + nt * 8 + 2 * t + e;
        s[nt][e] = attends(n0, j, Lk, causal) ? s[nt][e] * sl2 : -INFINITY;
        s[nt][2 + e] =
            attends(n1, j, Lk, causal) ? s[nt][2 + e] * sl2 : -INFINITY;
        t0 = fmaxf(t0, s[nt][e]);
        t1 = fmaxf(t1, s[nt][2 + e]);
      }
    }
    // finite from the first tile on: every query attends key 0
    const float mn0 = fmaxf(m0, quad_max(t0)), mn1 = fmaxf(m1, quad_max(t1));
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mn0);
        s[nt][2 + e] = exp2f(s[nt][2 + e] - mn1);
        r0 += s[nt][e];
        r1 += s[nt][2 + e];
      }
    }
    l0 = l0 * c0 + quad_sum(r0);
    l1 = l1 * c1 + quad_sum(r1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      o[dn][0] *= c0;
      o[dn][1] *= c0;
      o[dn][2] *= c1;
      o[dn][3] *= c1;
    }
    // O += P V: score tiles 2kk, 2kk+1 are the A fragment of keys
    // 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_rows(o, pa, vs, kk * 16, lane);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  store_rows(out + (qrow0 + n0) * D + col, out + (qrow0 + n1) * D + col,
             n0 < Lq, n1 < Lq, o, 1.f / l0, 1.f / l1, t);
  if (lse != nullptr && t == 0) {
    if (n0 < Lq) lse[(qrow0 + n0) * H + h] = (m0 + log2f(l0)) * kLn2;
    if (n1 < Lq) lse[(qrow0 + n1) * H + h] = (m1 + log2f(l1)) * kLn2;
  }
}

// dq: grid (ceil(Lq / (16 * warps)), H, B), warps * 32 threads. Each
// warp's 16 query rows first take delta = rowsum(dO * O) (written out for
// the dk/dv kernel), then walk the 64-key tiles (two stages) of K and V
// [key][d]: S = Q K^T and dP = dO V^T on the tensor cores, dS = P (dP -
// delta) in registers, then dS (rounded to bf16 as the A operand) times K
// into dq.
__global__ void __launch_bounds__(kMaxWarps * 32)
    flash_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const bf16* __restrict__ out,
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

  auto stage = [&](int kt) {
    bf16* ks = tiles + (kt & 1) * 2 * kTileElems;
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
  // delta over this lane's 16 columns of rows n0 and n1 (the columns of
  // its dO fragments), then over the quad; padded rows: dO = 0, delta = 0
  float d0 = 0.f, d1 = 0.f;
  const bf16* o0 = out + (qrow0 + n0) * D + col;
  const bf16* o1 = out + (qrow0 + n1) * D + col;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = kk * 16 + 2 * t + 8 * half;
      if (ok0) {
        const float2 gv = unpack_bf16(ga[kk][2 * half]);
        const float2 ov = unpack_bf16(ld32(o0 + c));
        d0 = fmaf(gv.y, ov.y, fmaf(gv.x, ov.x, d0));
      }
      if (ok1) {
        const float2 gv = unpack_bf16(ga[kk][2 * half + 1]);
        const float2 ov = unpack_bf16(ld32(o1 + c));
        d1 = fmaf(gv.y, ov.y, fmaf(gv.x, ov.x, d1));
      }
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (t == 0) {
    if (ok0) delta[(qrow0 + n0) * H + h] = d0;
    if (ok1) delta[(qrow0 + n1) * H + h] = d1;
  }
  const float l0 = ok0 ? lse[(qrow0 + n0) * H + h] * kLog2e : 0.f;
  const float l1 = ok1 ? lse[(qrow0 + n1) * H + h] * kLog2e : 0.f;

  float acc[kD / 8][4];
  zero(acc);
  const int n_tiles = (keys + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) stage(kt + 1);
    else cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const bf16* ks = tiles + (kt & 1) * 2 * kTileElems;
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
          s[half][e] = p0 * (dp[half][e] - d0);          // dS, row n0
          s[half][2 + e] = p1 * (dp[half][2 + e] - d1);  // dS, row n1
        }
      }
      const unsigned da[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      mma_rows(acc, da, ks, st * 16, lane);
    }
    __syncthreads();  // this stage is refilled two tiles on
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
// 8w..8w+7 of the block, and writes their delta = rowsum(dO * O).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const T* __restrict__ out, const float* __restrict__ lse,
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
  // padded rows: q = dO = 0 and delta = 0, so dS = 0 there
  float lr[kRowsPerWarp], dr[kRowsPerWarp], acc[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n_base + warp * kRowsPerWarp + r;
    float part = 0.f;
    if (n < Lq) {
      const long long row = (qrow0 + n) * D + col;
      for (int c = lane; c < d; c += 32)
        part = fmaf(to_float(dout[row + c]), to_float(out[row + c]), part);
    }
    dr[r] = warp_sum(part);
    if (n < Lq && lane == 0) delta[(qrow0 + n) * H + h] = dr[r];
    lr[r] = n < Lq ? lse[(qrow0 + n) * H + h] : 0.f;
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
        sw[jj] = attends(n, kt * kTile + jj, Lk, causal)
                     ? expf(s - lr[r]) * (dp - dr[r])
                     : 0.f;
      }
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

// The tensor-core kernels take bf16 with head_dim 64 and rows that start
// on 16-byte boundaries (they copy 16-byte chunks); everything else takes
// the SIMT kernels.
bool mma_fits(int dtype, int d, std::initializer_list<const void*> ptrs,
              long long q_rs, long long k_rs, long long v_rs) {
  if (dtype != 1 || d != kD) return false;
  for (const void* p : ptrs)
    if ((unsigned long long)p & 15ull) return false;
  for (long long s : {q_rs, k_rs, v_rs})
    if (s & 7ll) return false;
  return true;
}

dim3 grid(int rows, int per_block, int H, int B) {
  return dim3((unsigned)((rows + per_block - 1) / per_block), H, B);
}

// warps of the tensor-core forward and dq blocks: 16 queries each, as
// few as hold every query up to 8
int query_warps(int Lq) { return Lq < 16 * kMaxWarps ? (Lq + 15) / 16 : kMaxWarps; }

template <int KT>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int H, int Lq, int Lk,
                           long long q_rs, long long k_rs, long long v_rs,
                           float scale, int causal, cudaStream_t stream) {
  const int warps = query_warps(Lq);
  const int stages = Lk > KT ? 2 : 1;
  const size_t smem = (size_t)stages * 2 * KT * kRow * sizeof(bf16);
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<KT>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_mma_kernel<KT><<<grid(Lq, 16 * warps, H, B), warps * 32, smem,
                             stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, H, Lq, Lk, q_rs, k_rs, v_rs, scale, causal);
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

int forward(const void* q, const void* k, const void* v, void* out,
            void* lse, int B, int H, int Lq, int Lk, int d, long long q_rs,
            long long k_rs, long long v_rs, float scale, int causal,
            int dtype, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mma_fits(dtype, d, {q, k, v, out}, q_rs, k_rs, v_rs))
    return (int)(Lk <= 128
                     ? launch_fwd_mma<128>(q, k, v, out, lse, B, H, Lq, Lk,
                                           q_rs, k_rs, v_rs, scale, causal, s)
                     : launch_fwd_mma<64>(q, k, v, out, lse, B, H, Lq, Lk,
                                          q_rs, k_rs, v_rs, scale, causal, s));
  if (dtype == 0)
    return (int)launch_fwd<float>(q, k, v, out, lse, B, H, Lq, Lk, d, q_rs,
                                  k_rs, v_rs, scale, causal, s);
  if (dtype == 1)
    return (int)launch_fwd<bf16>(q, k, v, out, lse, B, H, Lq, Lk, d, q_rs,
                                 k_rs, v_rs, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* out, const void* lse,
                      void* delta, void* dq, int B, int H, int Lq, int Lk,
                      int d, long long q_rs, long long k_rs, long long v_rs,
                      float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(d);
  cudaError_t err = allow_smem(flash_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T><<<grid(Lq, kTile, H, B), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const T*)out,
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

}  // namespace

// Plain C interface, loaded with ctypes. q/k/v: row views, row r of batch
// element b at (b * L + r) * rs, head h at column h * d; every other
// tensor contiguous as the header says. dtype: 0 = fp32, 1 = bf16; causal:
// 0 or 1. Returns the cudaError_t of the launch (0 on success).
extern "C" {

// K7: the forward without the log-sum-exp
int lavila_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int Lq, int Lk, int d,
                           long long q_rs, long long k_rs, long long v_rs,
                           float scale, int causal, int dtype, void* stream) {
  return forward(q, k, v, out, nullptr, B, H, Lq, Lk, d, q_rs, k_rs, v_rs,
                 scale, causal, dtype, stream);
}

// K8 forward: also lse (B, Lq, H) fp32
int lavila_flash_fwd(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int H, int Lq, int Lk, int d,
                     long long q_rs, long long k_rs, long long v_rs,
                     float scale, int causal, int dtype, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return forward(q, k, v, out, lse, B, H, Lq, Lk, d, q_rs, k_rs, v_rs, scale,
                 causal, dtype, stream);
}

// K8 dq; writes delta (B, Lq, H) fp32 for lavila_flash_bwd_dkv
int lavila_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* out, const void* lse,
                        void* delta, void* dq, int B, int H, int Lq, int Lk,
                        int d, long long q_rs, long long k_rs, long long v_rs,
                        float scale, int causal, int dtype, void* stream) {
  if (!shape_ok(B, H, Lq, Lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mma_fits(dtype, d, {q, k, v, dout, out, dq}, q_rs, k_rs, v_rs)) {
    const int warps = query_warps(Lq);
    flash_dq_mma_kernel<<<grid(Lq, 16 * warps, H, B), warps * 32, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const bf16*)out, (const float*)lse, (float*)delta, (bf16*)dq, H, Lq,
        Lk, q_rs, k_rs, v_rs, scale, causal);
    return (int)cudaGetLastError();
  }
  if (dtype == 0)
    return (int)launch_dq<float>(q, k, v, dout, out, lse, delta, dq, B, H, Lq,
                                 Lk, d, q_rs, k_rs, v_rs, scale, causal, s);
  if (dtype == 1)
    return (int)launch_dq<bf16>(q, k, v, dout, out, lse, delta, dq, B, H, Lq,
                                Lk, d, q_rs, k_rs, v_rs, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// K8 dk/dv, after lavila_flash_bwd_dq on the same stream (reads its delta)
int lavila_flash_bwd_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int Lq, int Lk,
                         int d, long long q_rs, long long k_rs,
                         long long v_rs, float scale, int causal, int dtype,
                         void* stream) {
  if (!shape_ok(B, H, Lq, Lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mma_fits(dtype, d, {q, k, v, dout, dk, dv}, q_rs, k_rs, v_rs)) {
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
