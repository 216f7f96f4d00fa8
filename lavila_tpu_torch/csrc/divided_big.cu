// Divided space-time attention over large frames (K6), forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels lavila_tpu/ops/pallas/divided.py:
// _space_big_fwd_kernel and _space_big_bwd_kernel (spatial_phase_big),
// the JAX package's spatial phase for frames of more than 256 patches:
// the 336px towers, N = 24 x 24 = 576. The contract is K1's
// (divided_fwd.cu): q/k/v (B, F, N, D = H*d) as row views with a row
// stride, the CLS key/value rows ck/cv (B, D) folded into every frame's
// softmax as key 0; the forward writes out (B, F, N, D) contiguous and the
// per-row log-sum-exp lse (B, F, N, H) fp32; the backward takes dO, O and
// lse contiguous and writes dq/dk/dv (B, F, N, D) contiguous and dck/dcv
// (B, D). Inputs are fp32 or bf16; scores, softmax and sums are fp32.
//
// Why not K1: K1 stages a frame's whole K/V and holds a warp's 16 x (N+1)
// score tile in registers; at 577 keys that is 292 fp32 scores a lane.
// K6 tiles the keys instead, as FlashAttention-2 does: one block owns
// the queries of one (clip, frame, head) tile and streams the 577 keys
// through shared memory 64 at a time with an online softmax. Key 0 of the
// first tile is the CLS key, and the last tile (577 = 9*64 + 1) masks its
// tail; every row keeps the CLS key, so no row is ever fully masked.
//
// What bounds it on the H100: at TSF-L@336 (d = 64) the phase does
// 4*(N+1)*d FLOPs per query against ~4*d*itemsize bytes of q/k/v/out, ~290
// FLOPs per byte in bf16: about the card's balance point, so the floor is
// the larger of one pass over q/k/v/out and the products at the
// tensor-core peak. Hence, as K1:
//
//  * bf16, head_dim 64, rows on 16-byte boundaries: mma.sync m16n8k16
//    (bf16 in, fp32 accumulate). A block of 8 warps owns 128 queries, each
//    warp holding 16 rows' fragments. The key tiles ([key][d], rows
//    padded by 8 bf16 so that fragment loads hit 32 banks) come in two
//    stages by cp.async, the copy of tile k+1 running while tile k is
//    used. Per tile: S = Q K^T in registers, the online-softmax update (in
//    the log2 domain, exp2), and the unnormalised P = exp(S - m), rounded
//    to bf16, reused as the A operand of P V, whose B fragments ldmatrix
//    reads transposed from the [key][d] tile. Numerics: the JAX kernel
//    rounds the *normalised* P to bf16 before P V (divided.py:462); here
//    the unnormalised one is rounded and the sum divided at the end, which
//    differs by bf16 rounding only (the 2e-2 bf16 limit covers it; fp32
//    agrees up to summation order).
//  * everything else (fp32, whose 1e-4 limit rules out bf16 or TF32
//    tensor cores; other head sizes; unaligned rows): SIMT fp32 FMA. A block
//    of 8 warps owns 64 rows, 8 per warp, and stages 64 keys (or queries)
//    at a time as fp32 rows padded to d+1 floats, so lane j reading row j
//    hits its own bank.
//
// Backward: FlashAttention-2's split, as K1 bwd. A delta pass writes
// rowsum(dO*O) per (row, head); a dq kernel walks the key tiles for 128
// queries; a dk/dv kernel walks the query tiles for 64 keys, P recomputed
// from the saved lse. On the tensor cores both stage their tiles as the
// forward does, and every product whose B operand is a [row][d] tile read
// down its rows (dS K, P^T dO, dS^T Q) takes it through ldmatrix's
// transpose: no tile is ever stored transposed. Key 0 of the dk/dv kernel
// is the CLS key: its rows are written as fp32 per-(clip, frame) partials
// and a second pass adds them over the frames in a fixed order. No
// atomics: two calls give the same bits.

#include <math.h>

#include "common.cuh"

namespace {

using lavila::allow_smem;
using lavila::cp_async16;
using lavila::cp_async_commit;
using lavila::cp_async_wait_prev;
using lavila::from_float;
using lavila::launch_delta;
using lavila::launch_sum_groups;
using lavila::ld32;
using lavila::mma_16816;
using lavila::pack_bf16;
using lavila::quad_max;
using lavila::quad_sum;
using lavila::to_float;
using lavila::warp_max;
using lavila::warp_sum;
using namespace lavila::d64;  // kD, kRow, kChunks and the fragment helpers

constexpr int kTile = 64;  // queries per block, keys per tile (and back)

// ---- tensor-core kernels (bf16, head_dim 64) ----------------------------

constexpr int kTileElems = kTile * kRow;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The (head-sliced) row j of [cls; x_f]: key/value j of the frame.
template <typename T>
__device__ __forceinline__ const T* key_row(const T* cls, long long cls_rs,
                                            const T* x, long long x_rs, int b,
                                            long long frame_row, int j) {
  return j == 0 ? cls + b * cls_rs : x + (frame_row + j - 1) * x_rs;
}

// Copy rows first..first+63 of a frame into a [row][d] bf16 tile: the rows
// of [cls; x_f] when cls is given (keys, values), else of x_f (queries,
// dO); zeros past `rows`.
__device__ __forceinline__ void async_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* cls,
                                           long long cls_rs,
                                           const __nv_bfloat16* x,
                                           long long x_rs, int b,
                                           long long frame_row, int col,
                                           int first, int rows) {
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int jj = i / kChunks, c = i - jj * kChunks;
    const int j = first + jj;
    const bool ok = j < rows;
    const __nv_bfloat16* src = x;
    if (ok)
      src = (cls != nullptr ? key_row(cls, cls_rs, x, x_rs, b, frame_row, j)
                            : x + (frame_row + j) * x_rs) +
            col + 8 * c;
    cp_async16(dst + jj * kRow + 8 * c, src, ok);
  }
}

constexpr int kFwdWarps = 8;  // 16 query rows each: 128 queries a block
constexpr int kDqWarps = 8;
constexpr int kDkvWarps = 4;  // 16 key rows each: 64 keys a block

// forward: grid (ceil(N/128), H, B*F), kFwdWarps*32 threads. K and V tiles
// [key][d], two stages: the copy of tile kt+1 runs while tile kt is used.
__global__ void __launch_bounds__(kFwdWarps * 32)
    big_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ ck,
                       const __nv_bfloat16* __restrict__ cv,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int F, int N, int H,
                       long long q_rs, long long k_rs, long long v_rs,
                       long long ck_rs, long long cv_rs, float scale) {
  __shared__ __align__(16) float smem[2 * 2 * kTileElems / 2];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  const int h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const int L = N + 1;
  const long long frame_row = (long long)bf * N;
  const int col = h * kD;
  const long long D = (long long)H * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * (kFwdWarps * 16) + warp * 16 + g, n1 = n0 + 8;
  const float sl2 = scale * kLog2e;  // scores in the log2 domain

  auto stage = [&](int kt) {
    __nv_bfloat16* ks = tiles + (kt & 1) * 2 * kTileElems;
    async_tile(ks, ck, ck_rs, k, k_rs, b, frame_row, col, kt * kTile, L);
    async_tile(ks + kTileElems, cv, cv_rs, v, v_rs, b, frame_row, col,
               kt * kTile, L);
    cp_async_commit();
  };
  stage(0);

  unsigned qa[kD / 16][4];
  load_rows(qa, q + (frame_row + n0) * q_rs + col,
            q + (frame_row + n1) * q_rs + col, n0 < N, n1 < N, t);
  float o[kD / 8][4];
  zero(o);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (L + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) stage(kt + 1);
    else cp_async_commit();  // an empty group keeps the count
    cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* ks = tiles + (kt & 1) * 2 * kTileElems;
    const __nv_bfloat16* vs = ks + kTileElems;

    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) mma_scores(s[nt], qa, ks, nt, g, t);
    // online softmax: the tile's row maxima, rescale what came before
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = kt * kTile + nt * 8 + 2 * t + e < L;
        s[nt][e] = valid ? s[nt][e] * sl2 : -INFINITY;
        s[nt][2 + e] = valid ? s[nt][2 + e] * sl2 : -INFINITY;
        t0 = fmaxf(t0, s[nt][e]);
        t1 = fmaxf(t1, s[nt][2 + e]);
      }
    }
    // finite from the first tile on: it holds the CLS key
    const float mn0 = fmaxf(m0, quad_max(t0)), mn1 = fmaxf(m1, quad_max(t1));
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
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
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_rows(o, pa, vs, kk * 16, lane);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  store_rows(out + (frame_row + n0) * D + col, out + (frame_row + n1) * D + col,
             n0 < N, n1 < N, o, 1.f / l0, 1.f / l1, t);
  if (t == 0) {
    if (n0 < N) lse[(frame_row + n0) * H + h] = (m0 + log2f(l0)) * kLn2;
    if (n1 < N) lse[(frame_row + n1) * H + h] = (m1 + log2f(l1)) * kLn2;
  }
}

// dq: grid (ceil(N/128), H, B*F), kDqWarps*32 threads. Per key tile (two
// stages), K and V [key][d]; each warp's 16 query rows take S = Q K^T and
// dP = dO V^T on the tensor cores, dS = P (dP - delta) in registers, then
// dS (rounded to bf16 as the A operand) times K into dq.
__global__ void __launch_bounds__(kDqWarps * 32)
    big_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ ck,
                          const __nv_bfloat16* __restrict__ cv,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int F, int N, int H,
                          long long q_rs, long long k_rs, long long v_rs,
                          long long ck_rs, long long cv_rs, float scale) {
  __shared__ __align__(16) float smem[2 * 2 * kTileElems / 2];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  const int h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const int L = N + 1;
  const long long frame_row = (long long)bf * N;
  const int col = h * kD;
  const long long D = (long long)H * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * (kDqWarps * 16) + warp * 16 + g, n1 = n0 + 8;
  const float sl2 = scale * kLog2e;

  auto stage = [&](int kt) {
    __nv_bfloat16* ks = tiles + (kt & 1) * 2 * kTileElems;
    async_tile(ks, ck, ck_rs, k, k_rs, b, frame_row, col, kt * kTile, L);
    async_tile(ks + kTileElems, cv, cv_rs, v, v_rs, b, frame_row, col,
               kt * kTile, L);
    cp_async_commit();
  };
  stage(0);

  unsigned qa[kD / 16][4], ga[kD / 16][4];
  load_rows(qa, q + (frame_row + n0) * q_rs + col,
            q + (frame_row + n1) * q_rs + col, n0 < N, n1 < N, t);
  load_rows(ga, dout + (frame_row + n0) * D + col,
            dout + (frame_row + n1) * D + col, n0 < N, n1 < N, t);
  // padded rows: q = dO = 0 and delta = 0, so dS = 0 there
  const float l0 = n0 < N ? lse[(frame_row + n0) * H + h] * kLog2e : 0.f;
  const float l1 = n1 < N ? lse[(frame_row + n1) * H + h] * kLog2e : 0.f;
  const float d0 = n0 < N ? delta[(frame_row + n0) * H + h] : 0.f;
  const float d1 = n1 < N ? delta[(frame_row + n1) * H + h] : 0.f;

  float acc[kD / 8][4];
  zero(acc);
  const int n_tiles = (L + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) stage(kt + 1);
    else cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* ks = tiles + (kt & 1) * 2 * kTileElems;
    const __nv_bfloat16* vs = ks + kTileElems;
#pragma unroll
    for (int st = 0; st < kTile / 16; ++st) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mma_scores(s[half], qa, ks, 2 * st + half, g, t);
        mma_scores(dp[half], ga, vs, 2 * st + half, g, t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid =
              kt * kTile + (2 * st + half) * 8 + 2 * t + e < L;
          const float p0 = valid ? exp2f(s[half][e] * sl2 - l0) : 0.f;
          const float p1 = valid ? exp2f(s[half][2 + e] * sl2 - l1) : 0.f;
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
  store_rows(dq + (frame_row + n0) * D + col, dq + (frame_row + n1) * D + col,
             n0 < N, n1 < N, acc, scale, scale, t);
}

// dk/dv: grid (ceil((N+1)/64), H, B*F), kDkvWarps*32 threads. Each warp
// holds 16 key rows (key 0 is the CLS key); per query tile (two stages), Q
// and dO [query][d] with lse and delta per query; S^T = K Q^T and dP^T =
// V dO^T on the tensor cores, P^T and dS^T in registers, then P^T dO into
// dV and dS^T Q into dK. Key 0's rows are this frame's share of dck/dcv
// (fp32 partials (B, F, D)).
__global__ void __launch_bounds__(kDkvWarps * 32)
    big_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ ck,
                           const __nv_bfloat16* __restrict__ cv,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv,
                           float* __restrict__ dcls_k,
                           float* __restrict__ dcls_v, int F, int N, int H,
                           long long q_rs, long long k_rs, long long v_rs,
                           long long ck_rs, long long cv_rs, float scale) {
  __shared__ __align__(16) float smem[2 * 2 * kTileElems / 2];
  __shared__ float stats[2][2][kTile];  // per stage: lse (log2), delta
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  const int h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const int L = N + 1;
  const long long frame_row = (long long)bf * N;
  const int col = h * kD;
  const long long D = (long long)H * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * (kDkvWarps * 16) + warp * 16 + g, j1 = j0 + 8;
  const float sl2 = scale * kLog2e;

  auto stage = [&](int qt) {
    __nv_bfloat16* qs = tiles + (qt & 1) * 2 * kTileElems;
    async_tile(qs, nullptr, 0, q, q_rs, b, frame_row, col, qt * kTile, N);
    async_tile(qs + kTileElems, nullptr, 0, dout, D, b, frame_row, col,
               qt * kTile, N);
    cp_async_commit();
    for (int nn = threadIdx.x; nn < kTile; nn += blockDim.x) {
      const int n = qt * kTile + nn;
      // padded queries: P = exp2(s - inf) = 0, so they add nothing
      stats[qt & 1][0][nn] =
          n < N ? lse[(frame_row + n) * H + h] * kLog2e : INFINITY;
      stats[qt & 1][1][nn] = n < N ? delta[(frame_row + n) * H + h] : 0.f;
    }
  };
  stage(0);

  unsigned ka[kD / 16][4], va[kD / 16][4];
  load_rows(ka, key_row(ck, ck_rs, k, k_rs, b, frame_row, j0) + col,
            key_row(ck, ck_rs, k, k_rs, b, frame_row, j1) + col, j0 < L,
            j1 < L, t);
  load_rows(va, key_row(cv, cv_rs, v, v_rs, b, frame_row, j0) + col,
            key_row(cv, cv_rs, v, v_rs, b, frame_row, j1) + col, j0 < L,
            j1 < L, t);
  float ak[kD / 8][4], av[kD / 8][4];
  zero(ak);
  zero(av);

  const int n_tiles = (N + kTile - 1) / kTile;
  for (int qt = 0; qt < n_tiles; ++qt) {
    if (qt + 1 < n_tiles) stage(qt + 1);
    else cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* qs = tiles + (qt & 1) * 2 * kTileElems;
    const __nv_bfloat16* gs = qs + kTileElems;
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
          const float l = lses[nn], dl = deltas[nn];
          p[half][e] = exp2f(s[half][e] * sl2 - l);
          p[half][2 + e] = exp2f(s[half][2 + e] * sl2 - l);
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

#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int c = col + dn * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r ? j1 : j0;
      const float gk0 = ak[dn][2 * r] * scale, gk1 = ak[dn][2 * r + 1] * scale;
      const float gv0 = av[dn][2 * r], gv1 = av[dn][2 * r + 1];
      if (j == 0) {
        const long long o = (long long)bf * D + c;
        dcls_k[o] = gk0;
        dcls_k[o + 1] = gk1;
        dcls_v[o] = gv0;
        dcls_v[o + 1] = gv1;
      } else if (j < L) {
        const long long o = (frame_row + j - 1) * D + c;
        *reinterpret_cast<unsigned*>(dk + o) = pack_bf16(gk0, gk1);
        *reinterpret_cast<unsigned*>(dv + o) = pack_bf16(gv0, gv1);
      }
    }
  }
}

// ---- SIMT kernels (fp32, any head_dim <= 128) ---------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kTile / kWarps;  // 8
constexpr int kMaxDimsPerLane = 4;            // head_dim <= 128

// Stage rows kt*kTile.. of [cls; x_f] (or of x_f alone when cls is null)
// as fp32 [row][ld], times `mul`, zeros past `rows`.
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const T* cls,
                                          long long cls_rs, const T* x,
                                          long long x_rs, int b,
                                          long long frame_row, int col, int d,
                                          int first, int rows, float mul) {
  for (int i = threadIdx.x; i < kTile * d; i += blockDim.x) {
    const int jj = i / d, c = i - jj * d;
    const int j = first + jj;
    float val = 0.f;
    if (j < rows) {
      const T* row = cls != nullptr
                         ? key_row(cls, cls_rs, x, x_rs, b, frame_row, j)
                         : x + (frame_row + j) * x_rs;
      val = to_float(row[col + c]) * mul;
    }
    dst[jj * ld + c] = val;
  }
}

size_t fwd_smem_bytes(int d) {
  // K and V tiles [64][d+1], the block's scaled queries [64][d], P per warp
  return ((size_t)2 * kTile * (d + 1) + (size_t)kTile * d +
          (size_t)kWarps * kTile) *
         sizeof(float);
}

// forward: grid (ceil(N/64), H, B*F), kWarps*32 threads; warp w owns
// query rows 8w..8w+7 of the block.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    big_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ ck,
                   const T* __restrict__ cv, T* __restrict__ out,
                   float* __restrict__ lse, int F, int N, int H, int d,
                   long long q_rs, long long k_rs, long long v_rs,
                   long long ck_rs, long long cv_rs, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* ps = qs + kTile * d;
  const int h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const int L = N + 1;
  const long long frame_row = (long long)bf * N;
  const int col = h * d;
  const long long D = (long long)H * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_base = blockIdx.x * kTile;
  float* pw = ps + warp * kTile;

  stage_f32<T>(qs, d, nullptr, 0, q, q_rs, b, frame_row + n_base, col, d, 0,
               N - n_base, scale);
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int kt = 0; kt * kTile < L; ++kt) {
    __syncthreads();
    stage_f32<T>(ks, ld, ck, ck_rs, k, k_rs, b, frame_row, col, d,
                 kt * kTile, L, 1.f);
    stage_f32<T>(vs, ld, cv, cv_rs, v, v_rs, b, frame_row, col, d,
                 kt * kTile, L, 1.f);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float* qr = qs + (warp * kRowsPerWarp + r) * d;
      float s[2];
      float tmax = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = lane + 32 * e;
        const float* kr = ks + jj * ld;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s[e] = kt * kTile + jj < L ? dot : -INFINITY;
        tmax = fmaxf(tmax, s[e]);
      }
      // finite from the first tile on: it holds the CLS key
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
    if (n >= N) continue;
    const long long row = frame_row + n;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < d) out[row * D + col + c] = from_float<T>(acc[r][i] * inv);
    }
    if (lane == 0) lse[row * H + h] = m[r] + logf(l[r]);
  }
}

size_t dq_smem_bytes(int d) {
  // K and V tiles [64][d+1]; the block's scaled queries and dO rows
  // [64][d]; dS per warp
  return ((size_t)2 * kTile * (d + 1) + (size_t)2 * kTile * d +
          (size_t)kWarps * kTile) *
         sizeof(float);
}

// dq: grid (ceil(N/64), H, B*F), kWarps*32 threads; warp w owns query rows
// 8w..8w+7 of the block.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    big_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ ck,
                      const T* __restrict__ cv, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq,
                      int F, int N, int H, int d, long long q_rs,
                      long long k_rs, long long v_rs, long long ck_rs,
                      long long cv_rs, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* gs = qs + kTile * d;
  float* ss = gs + kTile * d;
  const int h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const int L = N + 1;
  const long long frame_row = (long long)bf * N;
  const int col = h * d;
  const long long D = (long long)H * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_base = blockIdx.x * kTile;
  float* sw = ss + warp * kTile;

  stage_f32<T>(qs, d, nullptr, 0, q, q_rs, b, frame_row + n_base, col, d, 0,
               N - n_base, scale);
  stage_f32<T>(gs, d, nullptr, 0, dout, D, b, frame_row + n_base, col, d, 0,
               N - n_base, 1.f);
  // padded rows: q = dO = 0 and delta = 0, so dS = 0 there
  float lr[kRowsPerWarp], dr[kRowsPerWarp], acc[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n_base + warp * kRowsPerWarp + r;
    lr[r] = n < N ? lse[(frame_row + n) * H + h] : 0.f;
    dr[r] = n < N ? delta[(frame_row + n) * H + h] : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int kt = 0; kt * kTile < L; ++kt) {
    __syncthreads();
    stage_f32<T>(ks, ld, ck, ck_rs, k, k_rs, b, frame_row, col, d,
                 kt * kTile, L, 1.f);
    stage_f32<T>(vs, ld, cv, cv_rs, v, v_rs, b, frame_row, col, d,
                 kt * kTile, L, 1.f);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
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
        sw[jj] = kt * kTile + jj < L ? expf(s - lr[r]) * (dp - dr[r]) : 0.f;
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
    if (n >= N) continue;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < d)
        dq[(frame_row + n) * D + col + c] = from_float<T>(acc[r][i] * scale);
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

// dk/dv: grid (ceil((N+1)/64), H, B*F), kWarps*32 threads; warp w owns key
// rows 8w..8w+7 of the block (key 0 is the CLS key). dcls_k/dcls_v: fp32
// partials (B, F, D), this frame's share of the CLS rows' gradient.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    big_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ ck,
                       const T* __restrict__ cv, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, float* __restrict__ dcls_k,
                       float* __restrict__ dcls_v, int F, int N, int H, int d,
                       long long q_rs, long long k_rs, long long v_rs,
                       long long ck_rs, long long cv_rs, float scale) {
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
  const int h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const int L = N + 1;
  const long long frame_row = (long long)bf * N;
  const int col = h * d;
  const long long D = (long long)H * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j_base = blockIdx.x * kTile;
  float* pw = ps + warp * kTile;
  float* sw = ss + warp * kTile;

  stage_f32<T>(kw, d, ck, ck_rs, k, k_rs, b, frame_row, col, d, j_base, L,
               scale);
  stage_f32<T>(vw, d, cv, cv_rs, v, v_rs, b, frame_row, col, d, j_base, L,
               1.f);
  float ak[kRowsPerWarp][kMaxDimsPerLane], av[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) ak[r][i] = av[r][i] = 0.f;

  for (int qt = 0; qt * kTile < N; ++qt) {
    __syncthreads();
    stage_f32<T>(qs, ld, nullptr, 0, q, q_rs, b, frame_row, col, d,
                 qt * kTile, N, 1.f);
    stage_f32<T>(gs, ld, nullptr, 0, dout, D, b, frame_row, col, d,
                 qt * kTile, N, 1.f);
    for (int nn = threadIdx.x; nn < kTile; nn += blockDim.x) {
      const int n = qt * kTile + nn;
      // padded queries: P = exp(s - inf) = 0, so they add nothing
      lses[nn] = n < N ? lse[(frame_row + n) * H + h] : INFINITY;
      deltas[nn] = n < N ? delta[(frame_row + n) * H + h] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
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
        const float p = expf(s - lses[nn]);
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
    if (j >= L) continue;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c >= d) continue;
      const float gk = ak[r][i] * scale, gv = av[r][i];
      if (j == 0) {
        const long long o = (long long)bf * D + col + c;
        dcls_k[o] = gk;
        dcls_v[o] = gv;
      } else {
        const long long o = (frame_row + j - 1) * D + col + c;
        dk[o] = from_float<T>(gk);
        dv[o] = from_float<T>(gv);
      }
    }
  }
}

// ---- launchers -----------------------------------------------------------

// The tensor-core kernels take bf16 with head_dim 64 and rows that start
// on 16-byte boundaries (they copy 16-byte chunks); everything else takes
// the SIMT kernels.
bool mma_fits(std::initializer_list<const void*> ptrs, int d, long long q_rs,
              long long k_rs, long long v_rs, long long ck_rs,
              long long cv_rs) {
  if (d != kD) return false;
  for (const void* p : ptrs)
    if ((unsigned long long)p & 15ull) return false;
  for (long long s : {q_rs, k_rs, v_rs, ck_rs, cv_rs})
    if (s & 7ll) return false;
  return true;
}

// (ceil(rows / per_block), H, B*F)
dim3 grid(int rows, int per_block, int H, int B, int F) {
  return dim3((unsigned)((rows + per_block - 1) / per_block), H, B * F);
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* ck, const void* cv, void* out, void* lse,
                       int B, int F, int N, int H, int d, long long q_rs,
                       long long k_rs, long long v_rs, long long ck_rs,
                       long long cv_rs, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(d);
  cudaError_t err = allow_smem(big_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  big_fwd_kernel<T><<<grid(N, kTile, H, B, F), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (T*)out, (float*)lse, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs,
      scale);
  return cudaGetLastError();
}

cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           const void* ck, const void* cv, void* out,
                           void* lse, int B, int F, int N, int H,
                           long long q_rs, long long k_rs, long long v_rs,
                           long long ck_rs, long long cv_rs, float scale,
                           cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  big_fwd_mma_kernel<<<grid(N, kFwdWarps * 16, H, B, F), kFwdWarps * 32,
                       0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ck,
      (const bf16*)cv, (bf16*)out, (float*)lse, F, N, H, q_rs, k_rs, v_rs,
      ck_rs, cv_rs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* ck, const void* cv, const void* dout,
                       const void* out, const void* lse, void* delta,
                       void* dq, void* dk, void* dv, void* dck, void* dcv,
                       void* part_k, void* part_v, int B, int F, int N, int H,
                       int d, long long q_rs, long long k_rs, long long v_rs,
                       long long ck_rs, long long cv_rs, float scale,
                       cudaStream_t stream) {
  cudaError_t err = launch_delta<T>(dout, out, delta,
                                    (long long)B * F * N * H, d, stream);
  if (err != cudaSuccess) return err;
  size_t smem = dq_smem_bytes(d);
  if ((err = allow_smem(big_bwd_dq_kernel<T>, smem)) != cudaSuccess)
    return err;
  big_bwd_dq_kernel<T><<<grid(N, kTile, H, B, F), kWarps * 32, smem,
                          stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, F, N,
      H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = dkv_smem_bytes(d);
  if ((err = allow_smem(big_bwd_dkv_kernel<T>, smem)) != cudaSuccess)
    return err;
  big_bwd_dkv_kernel<T><<<grid(N + 1, kTile, H, B, F), kWarps * 32, smem,
                           stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      (float*)part_k, (float*)part_v, F, N, H, d, q_rs, k_rs, v_rs, ck_rs,
      cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_groups<T>((const float*)part_k, (const float*)part_v,
                              dck, dcv, B, F, (long long)H * d, stream);
}

cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const void* ck, const void* cv, const void* dout,
                           const void* out, const void* lse, void* delta,
                           void* dq, void* dk, void* dv, void* dck, void* dcv,
                           void* part_k, void* part_v, int B, int F, int N,
                           int H, long long q_rs, long long k_rs,
                           long long v_rs, long long ck_rs, long long cv_rs,
                           float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  cudaError_t err = launch_delta<bf16>(dout, out, delta,
                                       (long long)B * F * N * H, kD, stream);
  if (err != cudaSuccess) return err;
  big_bwd_dq_mma_kernel<<<grid(N, kDqWarps * 16, H, B, F), kDqWarps * 32,
                          0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ck,
      (const bf16*)cv, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dq, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  big_bwd_dkv_mma_kernel<<<grid(N + 1, kDkvWarps * 16, H, B, F),
                           kDkvWarps * 32, 0,
                           stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ck,
      (const bf16*)cv, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, (float*)part_k,
      (float*)part_v, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_groups<bf16>((const float*)part_k, (const float*)part_v,
                                 dck, dcv, B, F, (long long)H * kD, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes; the signatures of
// lavila_divided_space_fwd/_bwd (divided_fwd.cu, divided_bwd.cu). dtype:
// 0 = fp32, 1 = bf16. delta: fp32 scratch (B, F, N, H); part_k/part_v:
// fp32 scratch (B, F, D). Returns the cudaError_t of the launches (0 on
// success).
extern "C" {

int lavila_divided_space_big_fwd(const void* q, const void* k, const void* v,
                                 const void* ck, const void* cv, void* out,
                                 void* lse, int B, int F, int N, int H, int d,
                                 long long q_rs, long long k_rs,
                                 long long v_rs, long long ck_rs,
                                 long long cv_rs, float scale, int dtype,
                                 void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && mma_fits({q, k, v, ck, cv, out}, d, q_rs, k_rs, v_rs,
                             ck_rs, cv_rs))
    return (int)launch_fwd_mma(q, k, v, ck, cv, out, lse, B, F, N, H, q_rs,
                               k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 0)
    return (int)launch_fwd<float>(q, k, v, ck, cv, out, lse, B, F, N, H, d,
                                  q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(q, k, v, ck, cv, out, lse, B, F, N,
                                          H, d, q_rs, k_rs, v_rs, ck_rs,
                                          cv_rs, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lavila_divided_space_big_bwd(const void* q, const void* k, const void* v,
                                 const void* ck, const void* cv,
                                 const void* dout, const void* out,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, void* dck, void* dcv,
                                 void* part_k, void* part_v, int B, int F,
                                 int N, int H, int d, long long q_rs,
                                 long long k_rs, long long v_rs,
                                 long long ck_rs, long long cv_rs, float scale,
                                 int dtype, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && mma_fits({q, k, v, ck, cv, dout, dq, dk, dv}, d, q_rs,
                             k_rs, v_rs, ck_rs, cv_rs))
    return (int)launch_bwd_mma(q, k, v, ck, cv, dout, out, lse, delta, dq, dk,
                               dv, dck, dcv, part_k, part_v, B, F, N, H, q_rs,
                               k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 0)
    return (int)launch_bwd<float>(q, k, v, ck, cv, dout, out, lse, delta, dq,
                                  dk, dv, dck, dcv, part_k, part_v, B, F, N,
                                  H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale,
                                  s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(
        q, k, v, ck, cv, dout, out, lse, delta, dq, dk, dv, dck, dcv, part_k,
        part_v, B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
