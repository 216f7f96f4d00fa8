// Divided space-time attention, backward phases, for Hopper (sm_90a).
//
// Replaces the Pallas kernels lavila_tpu/ops/pallas/divided.py:
// _space_bwd_kernel (K1 bwd) and _time_bwd_kernel (K2 bwd), reached from
// _phase_bwd. Same contract as the forward (divided_fwd.cu): q/k/v
// (B, F, N, D = H*d) as row views with a row stride, the CLS key/value
// rows ck/cv (B, D) folded into every group's softmax; plus dO, the
// forward's O (read by the fp32 kernels only) and its per-row
// log-sum-exp lse (B, F, N, H) fp32, all contiguous. Outputs dq/dk/dv
// (B, F, N, D) contiguous in the input dtype and dck/dcv (B, D): the CLS
// key/value rows get a gradient from every group. Inputs are fp32 or
// bf16; every product and sum is fp32.
//
// Per query row, with P = exp(scale*q.K^T - lse) recomputed from the
// saved lse (no probability was kept), dP = dO.V^T and delta: dS = P*(dP
// - delta), dq = scale*dS.K, dK = scale*dS^T.Q, dV = P^T.dO.
//
// delta: in bf16, rowsum(P*dP) over the CLS key and the group's keys,
// summed from the same P that forms dS in a pass over the keys before dS;
// in fp32, rowsum(dO*O) from the forward's O, the Pallas kernels' form
// (lavila::kDeltaFromOut). The two agree in exact arithmetic, but dq =
// dS.K cancels wherever the keys share a large common part, and keeps
// whatever sum(dS) != 0 the delta leaves times that part. From the
// forward's O rounded to bf16, that residue made the plain version's bf16
// dq 9.0x (space, N = 196) and 1.3x (time, F = 4) the fp64 gradient's norm
// at keys and values that share a part 20x their spread (as K8's, which
// took rowsum(P*dP) first, flash_attention.cu); from the same P it is fp32
// rounding. From an fp32 O the residue is fp32 rounding too (dq 1.2e-3 of
// the fp64 norm there, against P*dP's 1.1e-3), so fp32 keeps the form,
// and the bits, that the fp32 recipes were checked with. The pass costs
// the spatial phase's dq kernels two more products a key tile (S and dP
// again); K2's tensor-core kernel holds a row's keys at once and sums it
// in registers.
//
// Determinism: blocks run in no order, so nothing is summed across blocks
// with atomics. The CLS rows' gradient of each group (or tile of groups)
// is written to an fp32 partial (B, G, D), and sum_groups_kernel adds the
// G partials of a clip in a fixed order. Two calls on the same inputs
// give the same bits.
//
// K1 bwd, spatial phase: one (clip, frame, head) sees N <= 256 queries
// and the N+1 keys [ck; k_f] (larger frames go to K6's entry point,
// divided_big.cu, whose tensor-core route is the pair below too).
// FlashAttention-2's split: a dq kernel that walks the key tiles for a
// block of queries, a dk/dv kernel that walks the query tiles for a block
// of keys, each recomputing P from the saved lse. The caller picks one of
// two pairs (kernels/divided.py asks for the tensor cores by the `tc`
// argument; the entry point refuses a call they cannot take):
//
//  * bf16, head_dim 64, q/k/v/dO/O rows on 16-byte boundaries: the tensor
//    cores, one design for every N. ~10*(N+1)*d FLOPs per query row
//    against 8*d*2 bytes of q/k/v/dO/O/dq/dk/dv: ~123 FLOPs a byte at N =
//    196 (77 MB, 0.0231 ms at 3.35 TB/s at TSF-B's batch 8), ~160 at N =
//    256, ~360 at N = 576 (109 GFLOP at TSF-L@336's batch 8: 0.110 ms at
//    989 TFLOP/s), above the H100's ~295: there the tensor cores are the
//    limit, so every product is a wgmma m64n64k16 (bf16 in, fp32
//    accumulate), none needing a transposed store. The split recomputes S
//    and dP in both kernels, 7 products against the 5 of the bound: its
//    own floor is 1.4x the bound's operations. Both kernels are built as
//    the forward: blocks of consumer warpgroups (64 rows each; the dq
//    kernel's block size by launch_dq's rule, dk/dv two) and a producer
//    warp that issues TMA copies, its own side's tiles first, then the
//    other side's 64-row tiles through a ring of kTcStages slots that it
//    refills once every live warpgroup released a slot
//    (lavila::sm90::Ring).
//    - dq kernel (a warpgroup owns 64 queries; Q and dO stay in shared
//      memory): per row P_cls and dP_cls from the CLS key; then two walks
//      over the frame's key tiles, which the producer streams twice. The
//      first sums delta = P_cls dP_cls + rowsum(P dP) (S = Q K^T and dP =
//      dO V^T, SS, K and V K-major); the tile's lse (log2 domain; +inf on
//      padded rows) and delta then go to the fp32 scratch `stats` for the
//      dk/dv kernel, its share of dck = scale sum dS_cls q and dcv = sum
//      P_cls dO to the partials (B, F*ceil(N/64), D). The second, per key
//      tile: S and dP again, dS = P (dP - delta) in registers, dq += dS K
//      (RS: dS rounded to bf16 is the A fragment, K read MN-major); dq =
//      scale (dS K + dS_cls ck). In
//      FlashAttention-3's order: S and dP of tile t are issued before dS K
//      of tile t-1, and dS of tile t is formed while that product runs
//      (measured 1.2x faster than in turn; the same order spilled in the
//      dk/dv kernel, whose four accumulators leave no room, and did not
//      pay there).
//    - dk/dv kernel (a warpgroup owns 64 keys of k_f; K and V stay in
//      shared memory): per query tile Q, dO and the tile's lse and delta
//      (one bulk copy of `stats`) come through the ring. S^T = K Q^T and
//      dP^T = V dO^T (SS, Q and dO K-major): the accumulators' rows are
//      keys and their columns queries, which index lse and delta. P^T and
//      dS^T, rounded to bf16, are the A fragments of dV += P^T dO and dK
//      += dS^T Q (RS, dO and Q read MN-major); dK = scale dS^T Q.
//    Padded queries are zero rows of Q and dO (TMA's fill) with lse =
//    +inf in the dk/dv kernel, so their P^T and dS^T are zero; padded
//    keys are never stored.
//  * everything else (fp32, whose 1e-4 bound rules out bf16 or TF32
//    tensor cores, other head sizes, unaligned rows): SIMT fp32 FMA, bound
//    by FMA issue and shared-memory loads (~7*d FMAs per query-key pair
//    against the forward's 2*d). space_bwd_dq_kernel stages K and V in
//    fp32 (~100 KB, rows padded to d+1 floats so lane j reading row j hits
//    its own bank); each warp takes one query row: P and dP over the N+1
//    keys, delta (bf16: from them; fp32: from dO and O), then dS and dq;
//    delta goes to the scratch `stats` (B, F, N, H).
//    space_bwd_dkv_kernel stages Q, dO, lse and delta (~120 KB); each
//    warp takes one key row (row 0 the CLS key: its dK/dV rows are this
//    frame's share of dck/dcv, partials (B, F, D)), P and dS against all N
//    queries, then dK, dV.
//
// K2 bwd, temporal phase: one (clip, position, head) sees F queries and
// F+1 keys. 10(F+1)/16 FLOPs a byte of q/k/v/dO/O/dq/dk/dv in bf16 (3.1 at
// F = 4, 10.6 at 16): bound by bytes, 77 MB at TSF-B's (8, 4, 196, 768),
// 0.0231 ms at 3.35 TB/s; 0.092 ms at the fine-tune's 16 frames; 0.0905
// at TSF-L@336. Two kernels, picked as the forward's:
//
//  * bf16, head_dim 64, F <= 16, q/k/v/dO/O rows on 16-byte boundaries:
//    time_bwd_tc, one pass over the forward's slab tiles (the first
//    version swept twice, re-reading K and V for every (query, key) pair
//    and Q and dO for every key, with two warp reductions a pair):
//    - q/k/v/dO of a tile come in by cp.async into four slabs, one
//      block per tile, as the forward; a fifth takes dK.
//    - One warp per head, on mma.sync: S = Q K^T and dP = dO V^T; P =
//      exp2(S - lse) from the saved lse (+inf on rows past the tile, whose
//      P and dS are then zero) under the block-diagonal mask; delta =
//      P_cls dP_cls + rowsum(P dP), the row's 16 keys held by a quad of
//      lanes; dS = P (dP - delta). P and
//      dS go to a per-warp scratch (bf16, rows padded to 48 bytes) and
//      come back transposed by ldmatrix as the A fragments of dV = P^T dO
//      and dK = dS^T Q; dq = dS K (dS from registers) + dS_cls ck. Each
//      result is written over a slab that no later product of the warp
//      reads (dV over dO, dK over O, dq over Q), then stored in 16-byte
//      rows.
//    - The CLS key's column stays out of the products: its P, dP and dS
//      are per-row dots, and the tile's share of dck = scale sum dS_cls q
//      and dcv = sum P_cls dO is summed over the tile's rows inside the
//      warp (a reduce-scatter over the 8 lanes that share columns: 28
//      shuffles) in a fixed order, one fp32 partial per tile: (B,
//      ceil(N / (16 / F)), D), a quarter of the first version's (B, N, D)
//      at F = 4.
//    - Numerics: P stays fp32 for dS; P and dS are rounded to bf16 as
//      the products' operands, as the JAX kernel rounds them
//      (divided.py:248, :258); bf16 rounding only.
//  * everything else (fp32, other head sizes, unaligned rows, F > 16):
//    time_bwd_kernel, SIMT, one warp per (clip, position, head) with each
//    lane holding d/32 dims: a first sweep over the queries computes the
//    scores as warp reductions, per query P and dP over its F+1 keys,
//    delta (bf16: from them; fp32: from dO and O), then dS, dq and the
//    CLS rows' share (per position:
//    partials (B, N, D)), leaving P and dS (F x F per warp) in shared
//    memory for a second sweep over the keys that forms dK and dV.

#include <math.h>

#include "common.cuh"

namespace {

using lavila::allow_smem;
using lavila::cp_async_commit;
using lavila::from_float;
using lavila::kDeltaFromOut;
using lavila::launch_sum_groups;
using lavila::ld32;
using lavila::pack_bf16;
using lavila::quad_sum;
using lavila::to_float;
using lavila::unpack_bf16;
using lavila::warp_sum;
namespace tslab = lavila::tslab;

constexpr int kWarps = 8;           // warps per block, every kernel here
constexpr int kMaxDimsPerLane = 4;  // head_dim <= 128

size_t space_dq_smem_bytes(int N, int d) {
  const size_t L = (size_t)N + 1;
  return (2 * L * (d + 1) + (size_t)kWarps * (2 * d + 2 * L)) *
         sizeof(float);
}

size_t space_dkv_smem_bytes(int N, int d) {
  return (2 * (size_t)N * (d + 1) + 2 * (size_t)N +
          (size_t)kWarps * (2 * d + 2 * (size_t)N)) *
         sizeof(float);
}

// grid (H, F, B), kWarps*32 threads. delta: fp32 (B, F, N, H), written
// for space_bwd_dkv_kernel.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    space_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ ck,
                        const T* __restrict__ cv, const T* __restrict__ dout,
                        const T* __restrict__ out,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq,
                        int F, int N, int H, int d, long long q_rs,
                        long long k_rs, long long v_rs, long long ck_rs,
                        long long cv_rs, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int L = N + 1;   // key 0 is the CLS token, keys 1..N the frame
  const int ld = d + 1;  // padded row length
  float* ks = smem;
  float* vs = ks + (size_t)L * ld;
  float* qbuf = vs + (size_t)L * ld;  // per warp: one scaled query row
  float* gbuf = qbuf + kWarps * d;    // per warp: its dO row
  float* sbuf = gbuf + kWarps * d;    // per warp: P, then dS, over L keys
  float* pbuf = sbuf + kWarps * L;    // per warp: dP over the L keys
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
  float* gw = gbuf + warp * d;
  float* sw = sbuf + warp * L;
  float* pw = pbuf + warp * L;
  for (int n = warp; n < N; n += kWarps) {
    const long long row = frame_row + n;
    float part_o = 0.f;  // fp32: rowsum(dO O) over this lane's dims
    for (int c = lane; c < d; c += 32) {
      qw[c] = to_float(q[row * q_rs + col + c]) * scale;
      const float g = to_float(dout[row * D + col + c]);
      gw[c] = g;
      if constexpr (kDeltaFromOut<T>)
        part_o = fmaf(g, to_float(out[row * D + col + c]), part_o);
    }
    const float l = lse[row * H + h];
    __syncwarp();

    float part = 0.f;  // bf16: rowsum(P dP) over this lane's keys
    for (int j = lane; j < L; j += 32) {
      const float* kr = ks + j * ld;
      const float* vr = vs + j * ld;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < d; ++c) {
        s = fmaf(qw[c], kr[c], s);
        dp = fmaf(gw[c], vr[c], dp);
      }
      const float p = expf(s - l);
      sw[j] = p;
      pw[j] = dp;
      part = fmaf(p, dp, part);
    }
    const float dl = warp_sum(kDeltaFromOut<T> ? part_o : part);
    if (lane == 0) delta[row * H + h] = dl;
    for (int j = lane; j < L; j += 32) sw[j] = sw[j] * (pw[j] - dl);
    __syncwarp();

    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(sw[j], ks[j * ld + c], acc);
      dq[row * D + col + c] = from_float<T>(acc * scale);
    }
    __syncwarp();  // qw/gw/sw are rewritten by the next query
  }
}

// grid (H, F, B), kWarps*32 threads. dcls_k/dcls_v: fp32 partials
// (B, F, D), this frame's share of the CLS rows' gradient.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    space_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ ck,
                         const T* __restrict__ cv, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dcls_k,
                         float* __restrict__ dcls_v, int F, int N, int H,
                         int d, long long q_rs, long long k_rs,
                         long long v_rs, long long ck_rs, long long cv_rs,
                         float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int L = N + 1;
  const int ld = d + 1;
  float* qs = smem;                    // the frame's queries, unscaled
  float* gs = qs + (size_t)N * ld;     // their dO rows
  float* lses = gs + (size_t)N * ld;   // per query: lse
  float* deltas = lses + N;            // per query: rowsum(P*dP)
  float* kbuf = deltas + N;            // per warp: one scaled key row
  float* vbuf = kbuf + kWarps * d;     // per warp: its value row
  float* pbuf = vbuf + kWarps * d;     // per warp: P over the N queries
  float* sbuf = pbuf + kWarps * N;     // per warp: dS over the N queries
  const long long frame_row = ((long long)b * F + f) * N;
  const int col = h * d;
  const long long D = (long long)H * d;

  for (int i = threadIdx.x; i < N * d; i += blockDim.x) {
    const int n = i / d, c = i - n * d;
    const long long r = frame_row + n;
    qs[n * ld + c] = to_float(q[r * q_rs + col + c]);
    gs[n * ld + c] = to_float(dout[r * D + col + c]);
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    deltas[n] = delta[(frame_row + n) * H + h];
    lses[n] = lse[(frame_row + n) * H + h];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* kw = kbuf + warp * d;
  float* vw = vbuf + warp * d;
  float* pw = pbuf + warp * N;
  float* sw = sbuf + warp * N;
  for (int j = warp; j < L; j += kWarps) {
    for (int c = lane; c < d; c += 32) {
      float kv, vv;
      if (j == 0) {
        kv = to_float(ck[b * ck_rs + col + c]);
        vv = to_float(cv[b * cv_rs + col + c]);
      } else {
        const long long r = frame_row + j - 1;
        kv = to_float(k[r * k_rs + col + c]);
        vv = to_float(v[r * v_rs + col + c]);
      }
      kw[c] = kv * scale;
      vw[c] = vv;
    }
    __syncwarp();

    for (int n = lane; n < N; n += 32) {
      const float* qr = qs + n * ld;
      const float* gr = gs + n * ld;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < d; ++c) {
        s = fmaf(kw[c], qr[c], s);
        dp = fmaf(vw[c], gr[c], dp);
      }
      const float p = expf(s - lses[n]);
      pw[n] = p;
      sw[n] = p * (dp - deltas[n]);
    }
    __syncwarp();

    for (int c = lane; c < d; c += 32) {
      float gk = 0.f, gv = 0.f;
      for (int n = 0; n < N; ++n) {
        gk = fmaf(sw[n], qs[n * ld + c], gk);
        gv = fmaf(pw[n], gs[n * ld + c], gv);
      }
      gk *= scale;
      if (j == 0) {
        const long long o = ((long long)b * F + f) * D + col + c;
        dcls_k[o] = gk;
        dcls_v[o] = gv;
      } else {
        const long long r = frame_row + j - 1;
        dk[r * D + col + c] = from_float<T>(gk);
        dv[r * D + col + c] = from_float<T>(gv);
      }
    }
    __syncwarp();  // kw/vw/pw/sw are rewritten by the next key
  }
}

// ---- the spatial phase's backward on the tensor cores (K1 and K6): TMA
// and wgmma

using namespace lavila::sm90;  // tiles, barriers, the ring, wgmma

constexpr int kDkvWG = 2;      // consumer warpgroups a dk/dv block
constexpr int kTcStages = 4;   // ring slots
constexpr unsigned kStatBytes = 2 * kTile * sizeof(float);  // lse, delta
// K2's per-warp P and dS scratch: 16 keys a row padded to 24 bf16 (48
// bytes), so the 8 rows an ldmatrix reads start 12 banks apart
constexpr int kTimeScratchLd = 24;

// dq: grid (ceil(N / (64 WG)), H, B*F), 128 WG + 32 threads: warpgroup
// w < WG owns queries 64 (WG blockIdx.x + w) .. +63 (its query tile
// qt), the last warp is the producer. Its Q and dO tiles come in first;
// then the frame's K and V tiles stream through the ring twice. Per row:
// P_cls and dP_cls from the CLS key. First walk, per key tile: S = Q K^T
// and dP = dO V^T (wgmma SS, K and V K-major), delta += rowsum(P dP).
// Then the tile's lse (log2) and delta go to `stats` for the dk/dv
// kernel, its share of dck/dcv to the partials. Second walk, per key
// tile: S and dP again, dS = P (dP - delta) in registers, dq += dS K
// (wgmma RS, K read MN-major). dq = scale (dS K + dS_cls ck).
template <int WG, int S>
__global__ void __launch_bounds__(128 * WG + 32)
    space_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __nv_bfloat16* __restrict__ ck,
                           const __nv_bfloat16* __restrict__ cv,
                           const float* __restrict__ lse,
                           float* __restrict__ stats,
                           __nv_bfloat16* __restrict__ dq,
                           float* __restrict__ part_k,
                           float* __restrict__ part_v, int F, int N, int H,
                           long long ck_rs, long long cv_rs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bar_q[WG];
  __shared__ __align__(8) Ring<S> ring;
  __shared__ float cls[WG][2][4][kD];  // per warp: its dck, dcv shares
  __nv_bfloat16* rows0 = align1024(smem_raw);      // Q, dO per WG
  __nv_bfloat16* kv = rows0 + 2 * WG * kTileElems;  // K, V per slot
  const int tiles = (N + kTile - 1) / kTile;
  const int h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const int col = h * kD;
  const int first = blockIdx.x * WG;
  const int live = min(WG, tiles - first);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int w = 0; w < WG; ++w) mbar_init(&bar_q[w], 1);
    ring.init(128 * live);
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == WG) {  // the producer
    if (threadIdx.x == 128 * WG) {
      for (int w = 0; w < live; ++w) {
        __nv_bfloat16* dst = rows0 + 2 * w * kTileElems;
        const int r = (first + w) * kTile;
        mbar_expect_tx(&bar_q[w], 2 * kTileBytes);
        tma_load_3d(dst, &tq, &bar_q[w], col, r, bf);
        tma_load_3d(dst + kTileElems, &tdo, &bar_q[w], col, r, bf);
      }
      // step t of the two walks reads key tile t % tiles into slot t % S
      for (int t = 0; t < 2 * tiles; ++t) {
        unsigned long long* full = ring.acquire(t);
        __nv_bfloat16* dst = kv + 2 * (t % S) * kTileElems;
        mbar_expect_tx(full, 2 * kTileBytes);
        tma_load_3d(dst, &tk, full, col, (t % tiles) * kTile, bf);
        tma_load_3d(dst + kTileElems, &tv, full, col, (t % tiles) * kTile,
                    bf);
      }
    }
    return;
  }
  if (wg >= live) return;  // not counted on the ring's `empty` barriers
  const __nv_bfloat16* qs = rows0 + 2 * wg * kTileElems;
  const __nv_bfloat16* gs = qs + kTileElems;
  const int qt = first + wg, row0 = qt * kTile;
  const long long frame_row = (long long)bf * N;
  const long long D = (long long)H * kD;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int n0 = row0 + r0, n1 = n0 + 8;
  const float sl2 = scale * kLog2e;

  // per row, over this lane's dims 16 t4 .. 16 t4 + 15 (quad sums): q.ck
  // and dO.cv. Padded rows (past N) are zeros in Q and dO and read lse =
  // 0: P_cls = 1, every dP of theirs 0, so delta = 0 and their dS are 0.
  mbar_wait(&bar_q[wg], 0);
  __syncwarp();
  float s0 = 0.f, s1 = 0.f, p0 = 0.f, p1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 16 * t4 + 2 * i;
    const float2 kc = unpack_bf16(ld32(ck + b * ck_rs + col + c));
    const float2 vc = unpack_bf16(ld32(cv + b * cv_rs + col + c));
    const float2 qx = tile_pair(qs, r0, c), qy = tile_pair(qs, r0 + 8, c);
    const float2 gx = tile_pair(gs, r0, c), gy = tile_pair(gs, r0 + 8, c);
    s0 += qx.x * kc.x + qx.y * kc.y;
    s1 += qy.x * kc.x + qy.y * kc.y;
    p0 += gx.x * vc.x + gx.y * vc.y;
    p1 += gy.x * vc.x + gy.y * vc.y;
  }
  const float l0 = n0 < N ? lse[(frame_row + n0) * H + h] * kLog2e : 0.f;
  const float l1 = n1 < N ? lse[(frame_row + n1) * H + h] * kLog2e : 0.f;
  const float pc0 = exp2f(quad_sum(s0) * sl2 - l0);
  const float pc1 = exp2f(quad_sum(s1) * sl2 - l1);
  const float dpc0 = quad_sum(p0), dpc1 = quad_sum(p1);

  float acc[32], sc[32], dp[32];
  // first walk: delta = P_cls dP_cls + rowsum(P dP) over the frame's keys,
  // with the P and dP of the second walk, bit for bit
  float e0 = 0.f, e1 = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    ring.wait(kt);
    const __nv_bfloat16* ks = kv + 2 * (kt % S) * kTileElems;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    hold(sc);
    hold(dp);
    wgmma_fence();
    wgmma_tile_ss(sc, qs, ks);
    wgmma_tile_ss(dp, gs, ks + kTileElems);
    wgmma_commit();
    wgmma_wait<0>();
    hold(sc);
    hold(dp);
    ring.release(kt);
    const bool full = (kt + 1) * kTile <= N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = full || kt * kTile + 8 * j + 2 * t4 + e < N;
        const float pa = valid ? fast_exp2(fmaf(sc[4 * j + e], sl2, -l0))
                               : 0.f;
        const float pb =
            valid ? fast_exp2(fmaf(sc[4 * j + 2 + e], sl2, -l1)) : 0.f;
        e0 = fmaf(pa, dp[4 * j + e], e0);
        e1 = fmaf(pb, dp[4 * j + 2 + e], e1);
      }
    }
  }
  const float dl0 = quad_sum(e0) + pc0 * dpc0;
  const float dl1 = quad_sum(e1) + pc1 * dpc1;
  const float dc0 = pc0 * (dpc0 - dl0);
  const float dc1 = pc1 * (dpc1 - dl1);
  if (t4 == 0) {
    // the dk/dv kernel's per-query lse and delta; a padded query's lse is
    // +inf there, so its P is 0
    float* st = stats + (((long long)bf * H + h) * tiles + qt) * 2 * kTile;
    st[r0] = n0 < N ? l0 : INFINITY;
    st[r0 + 8] = n1 < N ? l1 : INFINITY;
    st[kTile + r0] = dl0;
    st[kTile + r0 + 8] = dl1;
  }
  // this warp's share of dck = scale sum dS_cls q and dcv = sum P_cls dO:
  // the lane's two rows, then the 8 lanes of equal t4 (xor over g)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 16 * t4 + 2 * i;
    const float2 qx = tile_pair(qs, r0, c), qy = tile_pair(qs, r0 + 8, c);
    const float2 gx = tile_pair(gs, r0, c), gy = tile_pair(gs, r0 + 8, c);
    float r[4] = {dc0 * qx.x + dc1 * qy.x, dc0 * qx.y + dc1 * qy.y,
                  pc0 * gx.x + pc1 * gy.x, pc0 * gx.y + pc1 * gy.y};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        r[j] += __shfl_xor_sync(0xffffffffu, r[j], o);
    if (g == 0) {
      cls[wg][0][warp][c] = r[0];
      cls[wg][0][warp][c + 1] = r[1];
      cls[wg][1][warp][c] = r[2];
      cls[wg][1][warp][c + 1] = r[3];
    }
  }

  // second walk, ring steps tiles .. 2 tiles - 1. FlashAttention-3's
  // order: S and dP of key tile kt are issued before dq += dS K of tile
  // kt - 1, and dS of tile kt is formed while that product runs; da holds
  // the dS in flight as bf16
  unsigned da[kD / 16][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    ring.wait(tiles + kt);
    const __nv_bfloat16* ks = kv + 2 * ((tiles + kt) % S) * kTileElems;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    hold(sc);
    hold(dp);
    wgmma_fence();
    wgmma_tile_ss(sc, qs, ks);
    wgmma_tile_ss(dp, gs, ks + kTileElems);
    wgmma_commit();
    if (kt > 0) {
      wgmma_tile_rs(acc, da, kv + 2 * ((tiles + kt - 1) % S) * kTileElems);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    hold(sc);
    hold(dp);
    const bool full = (kt + 1) * kTile <= N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = full || kt * kTile + 8 * j + 2 * t4 + e < N;
        const float pa = valid ? fast_exp2(fmaf(sc[4 * j + e], sl2, -l0))
                               : 0.f;
        const float pb =
            valid ? fast_exp2(fmaf(sc[4 * j + 2 + e], sl2, -l1)) : 0.f;
        sc[4 * j + e] = pa * (dp[4 * j + e] - dl0);          // dS, row r0
        sc[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl1);  // row r0 + 8
      }
    }
    wgmma_wait<0>();
    hold(acc);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) hold(da[kk]);
    if (kt > 0) ring.release(tiles + kt - 1);
    acc_to_a(da, sc);
  }
  {
    const int t = 2 * tiles - 1;
    wgmma_fence();
    wgmma_tile_rs(acc, da, kv + 2 * (t % S) * kTileElems);
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) hold(da[kk]);
    ring.release(t);
  }
  // the CLS key's term, then dq = scale * acc through the Q tile
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 kc = unpack_bf16(ld32(ck + b * ck_rs + col + 8 * j + 2 * t4));
    acc[4 * j] += dc0 * kc.x;
    acc[4 * j + 1] += dc0 * kc.y;
    acc[4 * j + 2] += dc1 * kc.x;
    acc[4 * j + 3] += dc1 * kc.y;
  }
  store_tile(const_cast<__nv_bfloat16*>(qs), acc, scale, scale,
             dq + frame_row * D + col, D, row0, N, wg);
  // the tile's dck/dcv partials: the 4 warps' shares in a fixed order
  // (store_tile's barriers made them visible)
  const long long o = ((long long)bf * tiles + qt) * D + col;
  for (int i = threadIdx.x & 127; i < 2 * kD; i += 128) {
    const int which = i / kD, c = i - which * kD;
    const float sum = cls[wg][which][0][c] + cls[wg][which][1][c] +
                      cls[wg][which][2][c] + cls[wg][which][3][c];
    if (which == 0) part_k[o + c] = sum * scale;
    else part_v[o + c] = sum;
  }
}

// dk/dv: grid (ceil(N / (64 WG)), H, B*F), 128 WG + 32 threads:
// warpgroup w < WG owns keys 64 (WG blockIdx.x + w) .. +63 of k_f (the
// CLS key's gradient is the dq kernel's), the last warp is the producer.
// Its K and V tiles come in first; then per 64-query tile Q, dO and the
// tile's lse and delta (`stats`, from the dq kernel) stream through the
// ring. S^T = K Q^T and dP^T = V dO^T (wgmma SS: the accumulators' rows
// are keys, their columns queries, which index lse and delta), P^T and
// dS^T = P^T (dP^T - delta) in registers and, rounded to bf16, the A
// operands of dV += P^T dO and dK += dS^T Q (wgmma RS, dO and Q read
// MN-major). dK = scale dS^T Q.
template <int WG, int S>
__global__ void __launch_bounds__(128 * WG + 32)
    space_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ stats,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int N, int H,
                            float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bar_kv[WG];
  __shared__ __align__(8) Ring<S> ring;
  __shared__ __align__(16) float st[S][2 * kTile];  // lse (log2), delta
  __nv_bfloat16* kv0 = align1024(smem_raw);         // K, V per WG
  __nv_bfloat16* qg = kv0 + 2 * WG * kTileElems;    // Q, dO per slot
  const int tiles = (N + kTile - 1) / kTile;
  const int h = blockIdx.y, bf = blockIdx.z;
  const int col = h * kD;
  const int first = blockIdx.x * WG;
  const int live = min(WG, tiles - first);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int w = 0; w < WG; ++w) mbar_init(&bar_kv[w], 1);
    ring.init(128 * live);
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == WG) {  // the producer
    if (threadIdx.x == 128 * WG) {
      for (int w = 0; w < live; ++w) {
        __nv_bfloat16* dst = kv0 + 2 * w * kTileElems;
        const int r = (first + w) * kTile;
        mbar_expect_tx(&bar_kv[w], 2 * kTileBytes);
        tma_load_3d(dst, &tk, &bar_kv[w], col, r, bf);
        tma_load_3d(dst + kTileElems, &tv, &bar_kv[w], col, r, bf);
      }
      const float* st0 = stats + ((long long)bf * H + h) * tiles * 2 * kTile;
      for (int t = 0; t < tiles; ++t) {
        unsigned long long* full = ring.acquire(t);
        const int s = t % S;
        __nv_bfloat16* dst = qg + 2 * s * kTileElems;
        mbar_expect_tx(full, 2 * kTileBytes + kStatBytes);
        tma_load_3d(dst, &tq, full, col, t * kTile, bf);
        tma_load_3d(dst + kTileElems, &tdo, full, col, t * kTile, bf);
        bulk_load(st[s], st0 + t * 2 * kTile, kStatBytes, full);
      }
    }
    return;
  }
  if (wg >= live) return;  // not counted on the ring's `empty` barriers
  __nv_bfloat16* ks = kv0 + 2 * wg * kTileElems;
  __nv_bfloat16* vs = ks + kTileElems;
  const int row0 = (first + wg) * kTile;
  const int t4 = threadIdx.x & 3;
  const float sl2 = scale * kLog2e;

  mbar_wait(&bar_kv[wg], 0);
  __syncwarp();
  float ak[32], av[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) ak[i] = av[i] = 0.f;
  for (int qt = 0; qt < tiles; ++qt) {
    ring.wait(qt);
    const int s = qt % S;
    const __nv_bfloat16* qs = qg + 2 * s * kTileElems;
    const __nv_bfloat16* gs = qs + kTileElems;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    wgmma_tile_ss(sc, ks, qs);
    wgmma_tile_ss(dp, vs, gs);
    wgmma_commit();
    wgmma_wait_all();
    hold(sc);
    hold(dp);
    // columns are queries 8j + 2t4 + e of the tile; padded ones read lse
    // = +inf (P = 0) and have zero dO
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * t4 + e;
        const float l = st[s][n], dl = st[s][kTile + n];
        const float p0 = fast_exp2(fmaf(sc[4 * j + e], sl2, -l));
        const float p1 = fast_exp2(fmaf(sc[4 * j + 2 + e], sl2, -l));
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
        dp[4 * j + e] = p0 * (dp[4 * j + e] - dl);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl);
      }
    }
    unsigned pa[kD / 16][4], da[kD / 16][4];
    acc_to_a(pa, sc);
    acc_to_a(da, dp);
    wgmma_fence();
    wgmma_tile_rs(av, pa, gs);
    wgmma_tile_rs(ak, da, qs);
    wgmma_commit();
    wgmma_wait_all();
    hold(av);
    hold(ak);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      hold(pa[kk]);
      hold(da[kk]);
    }
    ring.release(qt);
  }
  const long long frame_row = (long long)bf * N;
  const long long D = (long long)H * kD;
  store_tile(ks, ak, scale, scale, dk + frame_row * D + col, D, row0, N, wg);
  store_tile(vs, av, 1.f, 1.f, dv + frame_row * D + col, D, row0, N, wg);
}

// One warp per (clip, position, head); ceil(B*N*H / kWarps) blocks.
// Shared memory: per warp, P and dS of the F x F (query, frame key) pairs.
// dcls_k/dcls_v: fp32 partials (B, N, D), this position's share.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    time_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ ck,
                    const T* __restrict__ cv, const T* __restrict__ dout,
                    const T* __restrict__ out, const float* __restrict__ lse,
                    T* __restrict__ dq, T* __restrict__ dk,
                    T* __restrict__ dv, float* __restrict__ dcls_k,
                    float* __restrict__ dcls_v, int B, int F, int N, int H,
                    int d, long long q_rs, long long k_rs, long long v_rs,
                    long long ck_rs, long long cv_rs, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  if (w >= (long long)B * N * H) return;  // whole warps leave together
  const int h = (int)(w % H);
  const long long bn = w / H;
  const int n = (int)(bn % N);
  const int b = (int)(bn / N);
  const int col = h * d;
  const long long D = (long long)H * d;
  float* pw = smem + (size_t)warp * 2 * F * F;  // P[f][g]
  float* sw = pw + F * F;                       // dP, then dS[f][g]

  float ckr[kMaxDimsPerLane], cvr[kMaxDimsPerLane];
  float gck[kMaxDimsPerLane], gcv[kMaxDimsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i) {
    const int c = lane + 32 * i;
    ckr[i] = c < d ? to_float(ck[b * ck_rs + col + c]) : 0.f;
    cvr[i] = c < d ? to_float(cv[b * cv_rs + col + c]) : 0.f;
    gck[i] = gcv[i] = 0.f;
  }

  // sweep 1, over the queries: dq, the CLS rows' share, P and dS
  for (int f = 0; f < F; ++f) {
    const long long row = ((long long)b * F + f) * N + n;
    float qr[kMaxDimsPerLane], gr[kMaxDimsPerLane], acc[kMaxDimsPerLane];
    float part = 0.f, sc = 0.f, dpc = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      qr[i] = c < d ? to_float(q[row * q_rs + col + c]) : 0.f;
      gr[i] = c < d ? to_float(dout[row * D + col + c]) : 0.f;
      if constexpr (kDeltaFromOut<T>) {
        const float o = c < d ? to_float(out[row * D + col + c]) : 0.f;
        part = fmaf(gr[i], o, part);
      }
      sc = fmaf(qr[i], ckr[i], sc);
      dpc = fmaf(gr[i], cvr[i], dpc);
    }
    const float l = lse[row * H + h];
    const float pc = expf(warp_sum(sc) * scale - l);
    const float dpcs = warp_sum(dpc);
    // P and dP over the frame keys, and delta: fp32 rowsum(dO O), bf16
    // rowsum(P dP) (every lane holds the warp sums)
    float delta = kDeltaFromOut<T> ? warp_sum(part) : pc * dpcs;
    for (int g = 0; g < F; ++g) {
      const long long krow = ((long long)b * F + g) * N + n;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int c = lane + 32 * i;
        const float kv = c < d ? to_float(k[krow * k_rs + col + c]) : 0.f;
        const float vv = c < d ? to_float(v[krow * v_rs + col + c]) : 0.f;
        s = fmaf(qr[i], kv, s);
        dp = fmaf(gr[i], vv, dp);
      }
      const float p = expf(warp_sum(s) * scale - l);
      dp = warp_sum(dp);
      if constexpr (!kDeltaFromOut<T>) delta = fmaf(p, dp, delta);
      if (lane == 0) {
        pw[f * F + g] = p;
        sw[f * F + g] = dp;
      }
    }
    __syncwarp();  // P and dP, written by lane 0, are read by every lane
    const float dsc = pc * (dpcs - delta);
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      acc[i] = dsc * ckr[i];
      gck[i] = fmaf(dsc, qr[i], gck[i]);
      gcv[i] = fmaf(pc, gr[i], gcv[i]);
    }
    for (int g = 0; g < F; ++g) {
      const long long krow = ((long long)b * F + g) * N + n;
      const float ds = pw[f * F + g] * (sw[f * F + g] - delta);
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int c = lane + 32 * i;
        const float kv = c < d ? to_float(k[krow * k_rs + col + c]) : 0.f;
        acc[i] = fmaf(ds, kv, acc[i]);
      }
    }
    __syncwarp();  // every lane has read this query's dP
    if (lane == 0)
      for (int g = 0; g < F; ++g)
        sw[f * F + g] = pw[f * F + g] * (sw[f * F + g] - delta);
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < d) dq[row * D + col + c] = from_float<T>(acc[i] * scale);
    }
  }
  __syncwarp();  // P and dS, written by lane 0, are read by every lane

  // sweep 2, over the frame keys: dK and dV
  for (int g = 0; g < F; ++g) {
    float ak[kMaxDimsPerLane], av[kMaxDimsPerLane];
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) ak[i] = av[i] = 0.f;
    for (int f = 0; f < F; ++f) {
      const long long row = ((long long)b * F + f) * N + n;
      const float p = pw[f * F + g], ds = sw[f * F + g];
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < d) {
          ak[i] = fmaf(ds, to_float(q[row * q_rs + col + c]), ak[i]);
          av[i] = fmaf(p, to_float(dout[row * D + col + c]), av[i]);
        }
      }
    }
    const long long krow = ((long long)b * F + g) * N + n;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < d) {
        dk[krow * D + col + c] = from_float<T>(ak[i] * scale);
        dv[krow * D + col + c] = from_float<T>(av[i]);
      }
    }
  }

  const long long o = ((long long)b * N + n) * D + col;
#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      dcls_k[o + c] = gck[i] * scale;
      dcls_v[o + c] = gcv[i];
    }
  }
}

// K2 bwd on the tensor cores, laid out as the forward: a block of G warps
// per tile (16 / F positions x G heads of one clip, all F frames), one
// warp per head; grid (H / G, tiles, B). part_k/part_v: fp32 (B, tiles,
// D), each tile's share of dck/dcv.
template <int G>
__global__ void __launch_bounds__(G * 32)
    time_bwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ ck,
                       const __nv_bfloat16* __restrict__ cv,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       __nv_bfloat16* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       float* __restrict__ part_k, float* __restrict__ part_v,
                       int F, int N, int H, long long q_rs, long long k_rs,
                       long long v_rs, long long ck_rs, long long cv_rs,
                       float scale) {
  using Geo = tslab::Geo<G>;
  using bf16 = __nv_bfloat16;
  constexpr int ld = Geo::kLd, E = Geo::kElems;
  constexpr int lp = kTimeScratchLd;
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + E;
  bf16* vs = qs + 2 * E;
  bf16* gs = qs + 3 * E;  // dO
  bf16* os = qs + 4 * E;  // dK, once formed
  const tslab::Tile tile(F, N, blockIdx.y, blockIdx.z);
  const tslab::Rows<G> rows(tile);
  const int col0 = blockIdx.x * Geo::kCols;
  const long long D = (long long)H * tslab::kD;
  tslab::load<G>(qs, q, q_rs, rows, col0);
  tslab::load<G>(ks, k, k_rs, rows, col0);
  tslab::load<G>(vs, v, v_rs, rows, col0);
  tslab::load<G>(gs, dout, D, rows, col0);
  cp_async_commit();

  // while the copies land: this warp's head, its CLS rows, its rows' lse
  // (log2 domain; +inf on invalid rows, whose P and dS are then zero) and
  // which keys each row sees
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x * G + warp, hc = h * tslab::kD;
  float2 ckf[8], cvf[8];
  tslab::cls_pairs(ckf, ck + tile.b * ck_rs + hc, t);
  tslab::cls_pairs(cvf, cv + tile.b * cv_rs + hc, t);
  const float l0 =
      tile.valid(g) ? lse[tile.row(g) * H + h] * kLog2e : INFINITY;
  const float l1 =
      tile.valid(g + 8) ? lse[tile.row(g + 8) * H + h] * kLog2e : INFINITY;
  bool allowed[2][2][2];
  tslab::keys_seen(allowed, tile, g, t);
  tslab::cp_async_wait_all();
  __syncthreads();

  const int hw = warp * tslab::kD;  // the warp's columns in the slabs
  bf16* pw = os + E + warp * 2 * 16 * lp;  // this warp's P, then dS
  bf16* dw = pw + 16 * lp;
  unsigned qa[4][4], ga[4][4];
  tslab::rows_a<ld>(qa, qs + hw, lane);
  tslab::rows_a<ld>(ga, gs + hw, lane);
  const float c2 = scale * kLog2e;
  // the CLS key: P and dP = dO . cv
  const float pc0 = fast_exp2(tslab::row_dot(qa, ckf, 0) * c2 - l0);
  const float pc1 = fast_exp2(tslab::row_dot(qa, ckf, 1) * c2 - l1);
  const float dpc0 = tslab::row_dot(ga, cvf, 0);
  const float dpc1 = tslab::row_dot(ga, cvf, 1);
  // the frame keys: S = Q K^T, dP = dO V^T, then P in place and delta =
  // rowsum(P dP) over the CLS key and the row's 16 keys (a quad's)
  float p[2][4], ds[2][4];
  tslab::scores<ld>(p, qa, ks + hw, lane);
  tslab::scores<ld>(ds, ga, vs + hw, lane);
  float delta0 = 0.f, delta1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p0 =
          allowed[0][nt][e] ? fast_exp2(p[nt][e] * c2 - l0) : 0.f;
      const float p1 =
          allowed[1][nt][e] ? fast_exp2(p[nt][2 + e] * c2 - l1) : 0.f;
      delta0 = fmaf(p0, ds[nt][e], delta0);
      delta1 = fmaf(p1, ds[nt][2 + e], delta1);
      p[nt][e] = p0;
      p[nt][2 + e] = p1;
    }
  delta0 = quad_sum(delta0) + pc0 * dpc0;
  delta1 = quad_sum(delta1) + pc1 * dpc1;
  const float dsc0 = pc0 * (dpc0 - delta0);
  const float dsc1 = pc1 * (dpc1 - delta1);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ds[nt][e] = p[nt][e] * (ds[nt][e] - delta0);
      ds[nt][2 + e] = p[nt][2 + e] * (ds[nt][2 + e] - delta1);
    }

  // this tile's share of dck = scale sum dS_cls q and dcv = sum P_cls dO:
  // per lane red[2j], red[2j + 1] at dck's columns 8j + 2t, +1 (rows g
  // and g + 8), red[16 + ...] at dcv's; then a reduce-scatter over the 8
  // lanes of one t (xor 16, 8, 4: 28 shuffles, each step halving what a
  // lane keeps), after which lane (g, t) holds the sums of values 4g ..
  // 4g + 3
  float red[32];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int j = 2 * kk + hi;
      const float2 q0 = unpack_bf16(qa[kk][2 * hi]),
                   q1 = unpack_bf16(qa[kk][2 * hi + 1]);
      const float2 g0 = unpack_bf16(ga[kk][2 * hi]),
                   g1 = unpack_bf16(ga[kk][2 * hi + 1]);
      red[2 * j] = fmaf(dsc0, q0.x, dsc1 * q1.x);
      red[2 * j + 1] = fmaf(dsc0, q0.y, dsc1 * q1.y);
      red[16 + 2 * j] = fmaf(pc0, g0.x, pc1 * g1.x);
      red[17 + 2 * j] = fmaf(pc0, g0.y, pc1 * g1.y);
    }
  tslab::halve<16>(red, lane);
  tslab::halve<8>(red, lane);
  tslab::halve<4>(red, lane);
  {
    const int jj = 2 * (g & 3);  // this lane's pair of 8-column groups
    const float mul = g < 4 ? scale : 1.f;
    float* part = (g < 4 ? part_k : part_v) +
                  ((long long)tile.b * gridDim.y + blockIdx.y) * D + hc +
                  8 * jj + 2 * t;
    *reinterpret_cast<float2*>(part) =
        make_float2(red[0] * mul, red[1] * mul);
    *reinterpret_cast<float2*>(part + 8) =
        make_float2(red[2] * mul, red[3] * mul);
  }

  // P and dS (bf16) to this warp's scratch, read back transposed as the
  // A fragments of dV = P^T dO and dK = dS^T Q
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c = 8 * nt + 2 * t;
    *reinterpret_cast<unsigned*>(pw + g * lp + c) =
        pack_bf16(p[nt][0], p[nt][1]);
    *reinterpret_cast<unsigned*>(pw + (g + 8) * lp + c) =
        pack_bf16(p[nt][2], p[nt][3]);
    *reinterpret_cast<unsigned*>(dw + g * lp + c) =
        pack_bf16(ds[nt][0], ds[nt][1]);
    *reinterpret_cast<unsigned*>(dw + (g + 8) * lp + c) =
        pack_bf16(ds[nt][2], ds[nt][3]);
  }
  __syncwarp();
  const int tr =
      ((lane >> 4) * 8 + (lane & 7)) * lp + ((lane >> 3) & 1) * 8;
  unsigned a[4];
  float acc[8][4];
  // each product's result goes to this warp's columns of a slab that no
  // later product reads: dV over dO, dK over O, dq over Q
  tslab::ldsm_x4_t(a, pw + tr);
  tslab::times_rows<ld>(acc, a, gs + hw, lane);
  __syncwarp();
  tslab::put_rows<ld>(gs + hw, acc, 1.f, 1.f, lane);
  tslab::ldsm_x4_t(a, dw + tr);
  tslab::times_rows<ld>(acc, a, qs + hw, lane);
  __syncwarp();
  tslab::put_rows<ld>(os + hw, acc, scale, scale, lane);
  tslab::acc_a(a, ds);  // dq = scale (dS K + dS_cls ck)
  tslab::times_rows<ld>(acc, a, ks + hw, lane);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = fmaf(dsc0, ckf[j].x, acc[j][0]);
    acc[j][1] = fmaf(dsc0, ckf[j].y, acc[j][1]);
    acc[j][2] = fmaf(dsc1, ckf[j].x, acc[j][2]);
    acc[j][3] = fmaf(dsc1, ckf[j].y, acc[j][3]);
  }
  __syncwarp();
  tslab::put_rows<ld>(qs + hw, acc, scale, scale, lane);
  __syncthreads();
  tslab::store<G>(dq, qs, D, rows, col0);
  tslab::store<G>(dk, os, D, rows, col0);
  tslab::store<G>(dv, gs, D, rows, col0);
}

template <typename T>
cudaError_t launch_space_bwd(const void* q, const void* k, const void* v,
                             const void* ck, const void* cv, const void* dout,
                             const void* out, const void* lse, void* delta,
                             void* dq,
                             void* dk, void* dv, void* dck, void* dcv,
                             void* part_k, void* part_v, int B, int F, int N,
                             int H, int d, long long q_rs, long long k_rs,
                             long long v_rs, long long ck_rs, long long cv_rs,
                             float scale, cudaStream_t stream) {
  const dim3 grid(H, F, B);
  size_t smem = space_dq_smem_bytes(N, d);
  cudaError_t err = allow_smem(space_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  space_bwd_dq_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (const T*)dout, (const T*)out, (const float*)lse, (float*)delta,
      (T*)dq, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = space_dkv_smem_bytes(N, d);
  if ((err = allow_smem(space_bwd_dkv_kernel<T>, smem)) != cudaSuccess)
    return err;
  space_bwd_dkv_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
      (T*)dv, (float*)part_k, (float*)part_v, F, N, H, d, q_rs, k_rs, v_rs,
      ck_rs, cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_groups<T>((const float*)part_k, (const float*)part_v,
                              dck, dcv, B, F, (long long)H * d, stream);
}

template <typename T>
cudaError_t launch_time_bwd(const void* q, const void* k, const void* v,
                            const void* ck, const void* cv, const void* dout,
                            const void* out, const void* lse, void* dq,
                            void* dk, void* dv, void* dck, void* dcv,
                            void* part_k, void* part_v, int B, int F, int N,
                            int H, int d, long long q_rs, long long k_rs,
                            long long v_rs, long long ck_rs, long long cv_rs,
                            float scale, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * 2 * F * F * sizeof(float);
  cudaError_t err = allow_smem(time_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const long long warps = (long long)B * N * H;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  time_bwd_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (const T*)dout, (const T*)out, (const float*)lse, (T*)dq, (T*)dk,
      (T*)dv, (float*)part_k, (float*)part_v, B, F, N, H, d, q_rs, k_rs,
      v_rs, ck_rs, cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_groups<T>((const float*)part_k, (const float*)part_v,
                              dck, dcv, B, N, (long long)H * d, stream);
}

template <int G>
cudaError_t launch_time_bwd_tc(const void* q, const void* k, const void* v,
                               const void* ck, const void* cv,
                               const void* dout, const void* lse, void* dq,
                               void* dk, void* dv,
                               void* dck, void* dcv, void* part_k,
                               void* part_v, int B, int F, int N, int H,
                               long long q_rs, long long k_rs, long long v_rs,
                               long long ck_rs, long long cv_rs, float scale,
                               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = 5 * tslab::Geo<G>::kBytes +
                      (size_t)G * 2 * tslab::kRows * kTimeScratchLd * 2;
  cudaError_t err = allow_smem(time_bwd_tc_kernel<G>, smem);
  if (err != cudaSuccess) return err;
  const int span = tslab::kRows / F, tiles = (N + span - 1) / span;
  time_bwd_tc_kernel<G><<<dim3(H / G, tiles, B), G * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ck,
      (const bf16*)cv, (const bf16*)dout, (const float*)lse, (bf16*)dq,
      (bf16*)dk, (bf16*)dv, (float*)part_k, (float*)part_v, F, N, H, q_rs,
      k_rs, v_rs, ck_rs, cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_groups<bf16>((const float*)part_k, (const float*)part_v,
                                 dck, dcv, B, tiles,
                                 (long long)H * tslab::kD, stream);
}

template <int WG>
cudaError_t launch_dq(const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, const CUtensorMap& tdo,
                      const void* ck, const void* cv,
                      const void* lse, void* stats, void* dq, void* part_k,
                      void* part_v, int B, int F, int N, int H,
                      long long ck_rs, long long cv_rs, float scale,
                      cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kernel = space_bwd_dq_tc_kernel<WG, kTcStages>;
  const size_t smem = (size_t)(2 * WG + 2 * kTcStages) * kTileBytes + 1024;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (N + kTile - 1) / kTile;
  kernel<<<dim3((tiles + WG - 1) / WG, H, B * F), 128 * WG + 32, smem,
           stream>>>(tq, tk, tv, tdo, (const bf16*)ck, (const bf16*)cv,
                     (const float*)lse, (float*)stats, (bf16*)dq,
                     (float*)part_k, (float*)part_v, F, N, H, ck_rs, cv_rs,
                     scale);
  return cudaGetLastError();
}

}  // namespace

namespace lavila {

// What the tensor-core backward takes (kernels/divided.py mirrors it):
// the forward's conditions (space_tc_fits: head_dim 64, N >= 1, q/k/v
// rows on 16-byte boundaries, ck/cv as bf16 pairs), and dO, which TMA
// reads too, on a 16-byte boundary.
bool space_bwd_tc_fits(const void* q, const void* k, const void* v,
                       const void* ck, const void* cv, const void* dout,
                       int N, int d, long long q_rs, long long k_rs,
                       long long v_rs, long long ck_rs, long long cv_rs) {
  return space_tc_fits(q, k, v, ck, cv, N, d, q_rs, k_rs, v_rs, ck_rs,
                       cv_rs) &&
         sm90::aligned16({dout});
}

cudaError_t launch_space_bwd_tc(const void* q, const void* k, const void* v,
                                const void* ck, const void* cv,
                                const void* dout, const void* lse,
                                void* stats, void* dq,
                                void* dk, void* dv, void* dck, void* dcv,
                                void* part_k, void* part_v, int B, int F,
                                int N, int H, long long q_rs, long long k_rs,
                                long long v_rs, long long ck_rs,
                                long long cv_rs, float scale,
                                cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int D = H * sm90::kD;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm90::rows_map(&tq, q, q_rs, D, N, B * F) ||
      !sm90::rows_map(&tk, k, k_rs, D, N, B * F) ||
      !sm90::rows_map(&tv, v, v_rs, D, N, B * F) ||
      !sm90::rows_map(&tdo, dout, D, D, N, B * F))
    return cudaErrorInvalidValue;
  const int tiles = (N + sm90::kTile - 1) / sm90::kTile;
  // dq blocks of 3 warpgroups where a frame has at least 9 query tiles and
  // they split into threes, so none idles; else 2. Timed at two shapes
  // only: N = 576 (9 tiles), where 3 made dq 7% faster (0.281 -> 0.262 ms
  // at B = 8, the whole backward 3%), the extra warpgroup hiding the
  // products' latency; N = 196 (4 tiles), where 2 were faster (0.066
  // against 0.073 ms). Fewer tiles keep 2, the form timed there.
  cudaError_t err =
      tiles >= 9 && tiles % 3 == 0
          ? launch_dq<3>(tq, tk, tv, tdo, ck, cv, lse, stats, dq,
                         part_k, part_v, B, F, N, H, ck_rs, cv_rs, scale,
                         stream)
          : launch_dq<2>(tq, tk, tv, tdo, ck, cv, lse, stats, dq,
                         part_k, part_v, B, F, N, H, ck_rs, cv_rs, scale,
                         stream);
  if (err != cudaSuccess) return err;
  auto dkv_kernel = space_bwd_dkv_tc_kernel<kDkvWG, kTcStages>;
  const size_t smem =
      (size_t)(2 * kDkvWG + 2 * kTcStages) * sm90::kTileBytes + 1024;
  if ((err = allow_smem(dkv_kernel, smem)) != cudaSuccess) return err;
  dkv_kernel<<<dim3((tiles + kDkvWG - 1) / kDkvWG, H, B * F),
               128 * kDkvWG + 32, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)stats, (bf16*)dk, (bf16*)dv, N, H,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_groups<bf16>((const float*)part_k, (const float*)part_v,
                                 dck, dcv, B, F * tiles, D, stream);
}

}  // namespace lavila

// Plain C interface, loaded with ctypes. dtype: 0 = fp32, 1 = bf16.
// part_k/part_v: fp32 scratch the caller allocates: (B, F*ceil(N/64), D)
// for the spatial phase's tensor-core kernels, (B, F, D) for its SIMT
// ones, (B, ceil(N / (16 / F)), D) for the temporal phase's tensor-core
// kernel, (B, N, D) for its SIMT one; stats: fp32 scratch (B, F, H,
// ceil(N/64), 2, 64) for the spatial phase's tensor-core kernels (each
// 64-query tile's lse, then its delta), (B, F, N, H) for its SIMT ones
// (delta). `out`, the forward's O, is read by the fp32 kernels only.
// Returns the cudaError_t of the launches (0 on success).
extern "C" {

// tc: 1 runs the tensor-core kernels (bf16; refused with
// cudaErrorInvalidValue where space_bwd_tc_fits does not hold), 0 the SIMT
// ones.
int lavila_divided_space_bwd(const void* q, const void* k, const void* v,
                             const void* ck, const void* cv,
                             const void* dout, const void* out,
                             const void* lse, void* stats, void* dq,
                             void* dk, void* dv, void* dck, void* dcv,
                             void* part_k, void* part_v, int B, int F, int N,
                             int H, int d, long long q_rs, long long k_rs,
                             long long v_rs, long long ck_rs, long long cv_rs,
                             float scale, int dtype, int tc, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    if (dtype != 1 ||
        !lavila::space_bwd_tc_fits(q, k, v, ck, cv, dout, N, d, q_rs, k_rs,
                                   v_rs, ck_rs, cv_rs))
      return (int)cudaErrorInvalidValue;
    return (int)lavila::launch_space_bwd_tc(
        q, k, v, ck, cv, dout, lse, stats, dq, dk, dv, dck, dcv, part_k,
        part_v, B, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  }
  if (dtype == 0)
    return (int)launch_space_bwd<float>(
        q, k, v, ck, cv, dout, out, lse, stats, dq, dk, dv, dck, dcv, part_k,
        part_v, B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 1)
    return (int)launch_space_bwd<__nv_bfloat16>(
        q, k, v, ck, cv, dout, out, lse, stats, dq, dk, dv, dck, dcv, part_k,
        part_v, B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  return (int)cudaErrorInvalidValue;
}

// tc: 1 runs the slab kernel on the tensor cores (bf16; refused with
// cudaErrorInvalidValue where time_tc_fits does not hold), 0 the SIMT one.
int lavila_divided_time_bwd(const void* q, const void* k, const void* v,
                            const void* ck, const void* cv, const void* dout,
                            const void* out, const void* lse, void* dq,
                            void* dk, void* dv, void* dck, void* dcv,
                            void* part_k, void* part_v, int B, int F, int N,
                            int H, int d, long long q_rs, long long k_rs,
                            long long v_rs, long long ck_rs, long long cv_rs,
                            float scale, int dtype, int tc, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    if (dtype != 1 || !lavila::time_tc_fits({q, k, v, dout}, ck, cv, F,
                                            d, q_rs, k_rs, v_rs, ck_rs,
                                            cv_rs))
      return (int)cudaErrorInvalidValue;
    switch (tslab::heads_per_block(H)) {
      case 4:
        return (int)launch_time_bwd_tc<4>(
            q, k, v, ck, cv, dout, lse, dq, dk, dv, dck, dcv, part_k,
            part_v, B, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
      case 2:
        return (int)launch_time_bwd_tc<2>(
            q, k, v, ck, cv, dout, lse, dq, dk, dv, dck, dcv, part_k,
            part_v, B, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
      default:
        return (int)launch_time_bwd_tc<1>(
            q, k, v, ck, cv, dout, lse, dq, dk, dv, dck, dcv, part_k,
            part_v, B, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
    }
  }
  if (dtype == 0)
    return (int)launch_time_bwd<float>(
        q, k, v, ck, cv, dout, out, lse, dq, dk, dv, dck, dcv, part_k,
        part_v, B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 1)
    return (int)launch_time_bwd<__nv_bfloat16>(
        q, k, v, ck, cv, dout, out, lse, dq, dk, dv, dck, dcv, part_k,
        part_v, B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
