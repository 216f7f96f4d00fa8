// Divided space-time attention, backward phases, for Hopper (sm_90a).
//
// Replaces the Pallas kernels lavila_tpu/ops/pallas/divided.py:
// _space_bwd_kernel (K1 bwd) and _time_bwd_kernel (K2 bwd), reached from
// _phase_bwd. Same contract as the forward (divided_fwd.cu): q/k/v
// (B, F, N, D = H*d) as row views with a row stride, the CLS key/value
// rows ck/cv (B, D) folded into every group's softmax; plus dO, the
// forward's O and its per-row log-sum-exp lse (B, F, N, H) fp32, all
// contiguous. Outputs dq/dk/dv (B, F, N, D) contiguous in the input dtype
// and dck/dcv (B, D): the CLS key/value rows get a gradient from every
// group. Inputs are fp32 or bf16; every product and sum is fp32.
//
// Per query row, with P = exp(scale*q.K^T - lse) recomputed from the
// saved lse (no probability was kept), dP = dO.V^T and
// delta = rowsum(dO*O): dS = P*(dP - delta), dq = scale*dS.K,
// dK = scale*dS^T.Q, dV = P^T.dO.
//
// Determinism: blocks run in no order, so nothing is summed across blocks
// with atomics. The CLS rows' gradient of each group is written to an
// fp32 partial (B, G, D), and sum_groups_kernel adds the G partials of a
// clip in a fixed order. Two calls on the same inputs give the same bits.
//
// K1 bwd, spatial phase: one (clip, frame, head) sees N queries and the
// N+1 keys [ck; k_f]. One kernel that stages K and V and also accumulates
// dK and dV in shared memory would need ~200 KB of the 227 KB a block may
// hold in fp32 and run one block per SM, so the backward is split as
// FlashAttention-2 splits it: a dq kernel that stages the keys' side (K,
// V) and walks the queries, and a dk/dv kernel that stages the queries'
// side (Q, dO, lse, delta) and walks the keys. Key row 0 of the second is
// the CLS key: its dK/dV rows are this frame's share of dck/dcv. Two
// pairs, chosen by what the call gives:
//
//  * bf16, head_dim 64, N+1 <= 208 (TSF-B: N = 196): tensor cores, as the
//    forward. With mma.sync (bf16 in, fp32 accumulate) the backward does
//    ~2.5x the forward's FLOPs over the same bytes, still below the
//    H100's ~295 FLOPs per byte, so its floor is one read of q/k/v/dO and
//    one write of dq/dk/dv. A small pass first writes delta (fp32, per row
//    and head). space_bwd_dq_mma_kernel stages K, V as [key][d] and K^T as
//    [d][key] (~88 KB); each warp takes 16 query rows and walks the keys
//    16 at a time: S and dP on the tensor cores, P and dS in registers,
//    dS (rounded to bf16, the accumulator layout reused as the A operand)
//    times K into dq. space_bwd_dkv_mma_kernel stages Q and dO in both
//    layouts (~117 KB); each warp takes 16 key rows and walks the queries:
//    S^T and dP^T, then P^T.dO into dV and dS^T.Q into dK. Padded queries
//    get lse = +inf, so P = 0 there; padded keys are masked in dq. Rows
//    are padded by 8 elements so that fragment loads hit 32 banks.
//  * everything else (fp32, whose 1e-4 bound rules out bf16 or TF32
//    tensor cores, other head sizes, N up to 256): SIMT fp32 FMA, bound by
//    FMA issue and shared-memory loads (~7*d FMAs per query-key pair
//    against the forward's 2*d). space_bwd_dq_kernel stages K and V in
//    fp32 (~100 KB, rows padded to d+1 floats so lane j reading row j hits
//    its own bank); each warp takes one query row, computes its delta,
//    then dS over the N+1 keys and dq. space_bwd_dkv_kernel stages Q, dO,
//    lse and delta (recomputed from dO and O while staging; ~120 KB); each
//    warp takes one key row, P and dS against all N queries, then dK, dV.
//
// K2 bwd, temporal phase: one (clip, position, head) sees F queries and
// F+1 keys, so one warp owns it, each lane holding d/32 dims as in the
// forward. A first sweep over the queries computes the scores as warp
// reductions, dq, and the CLS rows' share; it leaves P and dS (F x F
// scalars per warp) in shared memory, and a second sweep over the keys
// forms dK and dV from them. Bound by reading q/k/v/dO/O (L2 serves the
// re-reads); F = 16 runs the same code as F = 4.

#include <math.h>

#include "common.cuh"

namespace {

using lavila::allow_smem;
using lavila::from_float;
using lavila::launch_delta;
using lavila::launch_sum_groups;
using lavila::ld32;
using lavila::mma_16816;
using lavila::pack_bf16;
using lavila::to_float;
using lavila::warp_sum;

constexpr int kWarps = 8;           // warps per block, every kernel here
constexpr int kMaxDimsPerLane = 4;  // head_dim <= 128

size_t space_dq_smem_bytes(int N, int d) {
  const size_t L = (size_t)N + 1;
  return (2 * L * (d + 1) + (size_t)kWarps * (2 * d + L)) * sizeof(float);
}

size_t space_dkv_smem_bytes(int N, int d) {
  return (2 * (size_t)N * (d + 1) + 2 * (size_t)N +
          (size_t)kWarps * (2 * d + 2 * (size_t)N)) *
         sizeof(float);
}

// grid (H, F, B), kWarps*32 threads.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    space_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ ck,
                        const T* __restrict__ cv, const T* __restrict__ dout,
                        const T* __restrict__ out,
                        const float* __restrict__ lse, T* __restrict__ dq,
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
  float* sbuf = gbuf + kWarps * d;    // per warp: dS over the L keys
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
  for (int n = warp; n < N; n += kWarps) {
    const long long row = frame_row + n;
    float part = 0.f;
    for (int c = lane; c < d; c += 32) {
      qw[c] = to_float(q[row * q_rs + col + c]) * scale;
      const float g = to_float(dout[row * D + col + c]);
      gw[c] = g;
      part = fmaf(g, to_float(out[row * D + col + c]), part);
    }
    const float delta = warp_sum(part);
    const float l = lse[row * H + h];
    __syncwarp();

    for (int j = lane; j < L; j += 32) {
      const float* kr = ks + j * ld;
      const float* vr = vs + j * ld;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < d; ++c) {
        s = fmaf(qw[c], kr[c], s);
        dp = fmaf(gw[c], vr[c], dp);
      }
      sw[j] = expf(s - l) * (dp - delta);
    }
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
                         const T* __restrict__ out,
                         const float* __restrict__ lse, T* __restrict__ dk,
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
  float* deltas = lses + N;            // per query: rowsum(dO*O)
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
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = warp; n < N; n += kWarps) {
    const long long r = frame_row + n;
    float part = 0.f;
    for (int c = lane; c < d; c += 32)
      part = fmaf(gs[n * ld + c], to_float(out[r * D + col + c]), part);
    part = warp_sum(part);
    if (lane == 0) {
      deltas[n] = part;
      lses[n] = lse[r * H + h];
    }
  }
  __syncthreads();

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

// ---- K1 bwd, bf16 on the tensor cores ---------------------------------

constexpr int kMmaD = 64;               // head_dim of the tensor-core path
constexpr int kTiles = 13;              // 16-row tiles: N + 1 <= 208 keys
constexpr int kPad = kTiles * 16;       // keys and queries, padded
constexpr int kMmaWarps = 8;
constexpr int kRowStride = kMmaD + 8;   // bf16 per [row][d] row in smem
constexpr int kColStride = kPad + 8;    // bf16 per [d][row] row in smem
constexpr int kWords = kMmaD / 2;       // bf16 pairs per row

size_t space_dq_mma_smem_bytes() {
  return (2 * (size_t)kPad * kRowStride + (size_t)kMmaD * kColStride) *
         sizeof(__nv_bfloat16);
}

size_t space_dkv_mma_smem_bytes() {
  return 2 * ((size_t)kPad * kRowStride + (size_t)kMmaD * kColStride) *
             sizeof(__nv_bfloat16) +
         2 * (size_t)kPad * sizeof(float);
}

// Store one bf16 pair of row j both as [j][d] and transposed as [d][j].
__device__ __forceinline__ void stage_pair(__nv_bfloat16* rows,
                                           __nv_bfloat16* cols, int j, int w,
                                           unsigned word) {
  *reinterpret_cast<unsigned*>(rows + j * kRowStride + 2 * w) = word;
  if (cols != nullptr) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&word);
    cols[(2 * w) * kColStride + j] = v.x;
    cols[(2 * w + 1) * kColStride + j] = v.y;
  }
}

// dq: grid (H, F, B), kMmaWarps*32 threads. K and V of the (frame, head)
// staged as [key][d] and K^T as [d][key]; each warp takes 16 query rows
// and walks the keys 16 at a time: S = Q K^T and dP = dO V^T on the
// tensor cores, dS = P (dP - delta) in registers, then dS (rounded to
// bf16, reusing the accumulator layout as the A operand, as the forward
// does with P) times K into dq.
__global__ void __launch_bounds__(kMmaWarps * 32)
    space_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ ck,
                            const __nv_bfloat16* __restrict__ cv,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int F, int N,
                            int H, long long q_rs, long long k_rs,
                            long long v_rs, long long ck_rs, long long cv_rs,
                            float scale) {
  extern __shared__ float smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [key][d]
  __nv_bfloat16* vs = ks + kPad * kRowStride;                  // [key][d]
  __nv_bfloat16* kts = vs + kPad * kRowStride;                 // [d][key]
  const int h = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int L = N + 1;  // key 0 is the CLS token; keys >= L are zero pads
  const long long frame_row = ((long long)b * F + f) * N;
  const int col = h * kMmaD;
  const long long D = (long long)H * kMmaD;

  for (int i = threadIdx.x; i < kPad * kWords; i += blockDim.x) {
    const int j = i / kWords, w = i - j * kWords;
    unsigned kw = 0u, vw = 0u;
    if (j == 0) {
      kw = ld32(ck + b * ck_rs + col + 2 * w);
      vw = ld32(cv + b * cv_rs + col + 2 * w);
    } else if (j < L) {
      const long long r = frame_row + j - 1;
      kw = ld32(k + r * k_rs + col + 2 * w);
      vw = ld32(v + r * v_rs + col + 2 * w);
    }
    stage_pair(ks, kts, j, w, kw);
    stage_pair(vs, nullptr, j, w, vw);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int rt = warp; rt * 16 < N; rt += kMmaWarps) {
    const int n0 = rt * 16 + g, n1 = n0 + 8;  // this lane's two query rows
    const __nv_bfloat16* q0 = q + (frame_row + n0) * q_rs + col + 2 * t;
    const __nv_bfloat16* q1 = q + (frame_row + n1) * q_rs + col + 2 * t;
    const __nv_bfloat16* g0 = dout + (frame_row + n0) * D + col + 2 * t;
    const __nv_bfloat16* g1 = dout + (frame_row + n1) * D + col + 2 * t;
    unsigned qa[kMmaD / 16][4], ga[kMmaD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk) {
      qa[kk][0] = n0 < N ? ld32(q0 + kk * 16) : 0u;
      qa[kk][1] = n1 < N ? ld32(q1 + kk * 16) : 0u;
      qa[kk][2] = n0 < N ? ld32(q0 + kk * 16 + 8) : 0u;
      qa[kk][3] = n1 < N ? ld32(q1 + kk * 16 + 8) : 0u;
      ga[kk][0] = n0 < N ? ld32(g0 + kk * 16) : 0u;
      ga[kk][1] = n1 < N ? ld32(g1 + kk * 16) : 0u;
      ga[kk][2] = n0 < N ? ld32(g0 + kk * 16 + 8) : 0u;
      ga[kk][3] = n1 < N ? ld32(g1 + kk * 16 + 8) : 0u;
    }
    const float l0 = n0 < N ? lse[(frame_row + n0) * H + h] : 0.f;
    const float l1 = n1 < N ? lse[(frame_row + n1) * H + h] : 0.f;
    const float d0 = n0 < N ? delta[(frame_row + n0) * H + h] : 0.f;
    const float d1 = n1 < N ? delta[(frame_row + n1) * H + h] : 0.f;

    float acc[kMmaD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn)
      acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
    for (int kt = 0; kt < kTiles; ++kt) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (2 * kt + half) * 8 + g;
        const __nv_bfloat16* kr = ks + row * kRowStride + 2 * t;
        const __nv_bfloat16* vr = vs + row * kRowStride + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[half][e] = dp[half][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kMmaD / 16; ++kk) {
          mma_16816(s[half], qa[kk], ld32(kr + kk * 16),
                    ld32(kr + kk * 16 + 8));
          mma_16816(dp[half], ga[kk], ld32(vr + kk * 16),
                    ld32(vr + kk * 16 + 8));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = (2 * kt + half) * 8 + 2 * t + e < L;
          const float p0 = valid ? expf(s[half][e] * scale - l0) : 0.f;
          const float p1 = valid ? expf(s[half][2 + e] * scale - l1) : 0.f;
          s[half][e] = p0 * (dp[half][e] - d0);  // dS, row n0
          s[half][2 + e] = p1 * (dp[half][2 + e] - d1);  // dS, row n1
        }
      }
      const unsigned da[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        const __nv_bfloat16* kc =
            kts + (dn * 8 + g) * kColStride + kt * 16 + 2 * t;
        mma_16816(acc[dn], da, ld32(kc), ld32(kc + 8));
      }
    }
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      const int c = col + dn * 8 + 2 * t;
      if (n0 < N)
        *reinterpret_cast<unsigned*>(dq + (frame_row + n0) * D + c) =
            pack_bf16(acc[dn][0] * scale, acc[dn][1] * scale);
      if (n1 < N)
        *reinterpret_cast<unsigned*>(dq + (frame_row + n1) * D + c) =
            pack_bf16(acc[dn][2] * scale, acc[dn][3] * scale);
    }
  }
}

// The (head-sliced) row j of the keys [ck; k_f] or values [cv; v_f].
__device__ __forceinline__ const __nv_bfloat16* key_row(
    const __nv_bfloat16* cls, long long cls_rs, const __nv_bfloat16* x,
    long long x_rs, int b, long long frame_row, int j) {
  return j == 0 ? cls + b * cls_rs : x + (frame_row + j - 1) * x_rs;
}

// dk/dv: grid (H, F, B), kMmaWarps*32 threads. The frame's Q and dO are
// staged as [query][d] and [d][query], lse and delta per query; each warp
// takes 16 key rows (row 0 is the CLS key) and walks the queries 16 at a
// time: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in registers, then
// P^T dO into dV and dS^T Q into dK. Key 0's rows are this frame's share
// of dck/dcv (fp32 partials, summed by sum_groups_kernel).
__global__ void __launch_bounds__(kMmaWarps * 32)
    space_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
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
  extern __shared__ float smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [n][d]
  __nv_bfloat16* gs = qs + kPad * kRowStride;                  // [n][d]
  __nv_bfloat16* qts = gs + kPad * kRowStride;                 // [d][n]
  __nv_bfloat16* gts = qts + kMmaD * kColStride;               // [d][n]
  float* lses = reinterpret_cast<float*>(gts + kMmaD * kColStride);
  float* deltas = lses + kPad;
  const int h = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int L = N + 1;
  const long long frame_row = ((long long)b * F + f) * N;
  const int col = h * kMmaD;
  const long long D = (long long)H * kMmaD;

  for (int i = threadIdx.x; i < kPad * kWords; i += blockDim.x) {
    const int n = i / kWords, w = i - n * kWords;
    const long long r = frame_row + n;
    stage_pair(qs, qts, n, w, n < N ? ld32(q + r * q_rs + col + 2 * w) : 0u);
    stage_pair(gs, gts, n, w, n < N ? ld32(dout + r * D + col + 2 * w) : 0u);
  }
  for (int n = threadIdx.x; n < kPad; n += blockDim.x) {
    // padded queries: P = exp(s - inf) = 0, so they add nothing
    lses[n] = n < N ? lse[(frame_row + n) * H + h] : INFINITY;
    deltas[n] = n < N ? delta[(frame_row + n) * H + h] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int kt = warp; kt * 16 < L; kt += kMmaWarps) {
    const int j0 = kt * 16 + g, j1 = j0 + 8;  // this lane's two key rows
    const __nv_bfloat16* k0 = key_row(ck, ck_rs, k, k_rs, b, frame_row, j0);
    const __nv_bfloat16* k1 = key_row(ck, ck_rs, k, k_rs, b, frame_row, j1);
    const __nv_bfloat16* v0 = key_row(cv, cv_rs, v, v_rs, b, frame_row, j0);
    const __nv_bfloat16* v1 = key_row(cv, cv_rs, v, v_rs, b, frame_row, j1);
    unsigned ka[kMmaD / 16][4], va[kMmaD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk) {
      const int c = col + kk * 16 + 2 * t;
      ka[kk][0] = j0 < L ? ld32(k0 + c) : 0u;
      ka[kk][1] = j1 < L ? ld32(k1 + c) : 0u;
      ka[kk][2] = j0 < L ? ld32(k0 + c + 8) : 0u;
      ka[kk][3] = j1 < L ? ld32(k1 + c + 8) : 0u;
      va[kk][0] = j0 < L ? ld32(v0 + c) : 0u;
      va[kk][1] = j1 < L ? ld32(v1 + c) : 0u;
      va[kk][2] = j0 < L ? ld32(v0 + c + 8) : 0u;
      va[kk][3] = j1 < L ? ld32(v1 + c + 8) : 0u;
    }
    float ak[kMmaD / 8][4], av[kMmaD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[dn][e] = av[dn][e] = 0.f;

    for (int qt = 0; qt * 16 < N; ++qt) {
      float s[2][4], dp[2][4], p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (2 * qt + half) * 8 + g;
        const __nv_bfloat16* qr = qs + row * kRowStride + 2 * t;
        const __nv_bfloat16* gr = gs + row * kRowStride + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[half][e] = dp[half][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kMmaD / 16; ++kk) {
          mma_16816(s[half], ka[kk], ld32(qr + kk * 16),
                    ld32(qr + kk * 16 + 8));
          mma_16816(dp[half], va[kk], ld32(gr + kk * 16),
                    ld32(gr + kk * 16 + 8));
        }
        // columns are queries n = (2qt+half)*8 + 2t + e; rows j0 and j1
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = (2 * qt + half) * 8 + 2 * t + e;
          const float l = lses[n], dl = deltas[n];
          p[half][e] = expf(s[half][e] * scale - l);
          p[half][2 + e] = expf(s[half][2 + e] * scale - l);
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
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        const int off = (dn * 8 + g) * kColStride + qt * 16 + 2 * t;
        mma_16816(av[dn], pa, ld32(gts + off), ld32(gts + off + 8));
        mma_16816(ak[dn], sa, ld32(qts + off), ld32(qts + off + 8));
      }
    }

#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      const int c = col + dn * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = r ? j1 : j0;
        const float gk0 = ak[dn][2 * r] * scale, gk1 = ak[dn][2 * r + 1] * scale;
        const float gv0 = av[dn][2 * r], gv1 = av[dn][2 * r + 1];
        if (j == 0) {
          const long long o = ((long long)b * F + f) * D + c;
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
  float* sw = pw + F * F;                       // dS[f][g]

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
      const float o = c < d ? to_float(out[row * D + col + c]) : 0.f;
      part = fmaf(gr[i], o, part);
      sc = fmaf(qr[i], ckr[i], sc);
      dpc = fmaf(gr[i], cvr[i], dpc);
    }
    const float delta = warp_sum(part);
    const float l = lse[row * H + h];
    const float pc = expf(warp_sum(sc) * scale - l);
    const float dsc = pc * (warp_sum(dpc) - delta);
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      acc[i] = dsc * ckr[i];
      gck[i] = fmaf(dsc, qr[i], gck[i]);
      gcv[i] = fmaf(pc, gr[i], gcv[i]);
    }
    for (int g = 0; g < F; ++g) {
      const long long krow = ((long long)b * F + g) * N + n;
      float kv[kMaxDimsPerLane];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int c = lane + 32 * i;
        kv[i] = c < d ? to_float(k[krow * k_rs + col + c]) : 0.f;
        const float vv = c < d ? to_float(v[krow * v_rs + col + c]) : 0.f;
        s = fmaf(qr[i], kv[i], s);
        dp = fmaf(gr[i], vv, dp);
      }
      const float p = expf(warp_sum(s) * scale - l);
      const float ds = p * (warp_sum(dp) - delta);
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) acc[i] = fmaf(ds, kv[i], acc[i]);
      if (lane == 0) {
        pw[f * F + g] = p;
        sw[f * F + g] = ds;
      }
    }
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

template <typename T>
cudaError_t launch_space_bwd(const void* q, const void* k, const void* v,
                             const void* ck, const void* cv, const void* dout,
                             const void* out, const void* lse, void* dq,
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
      (const T*)dout, (const T*)out, (const float*)lse, (T*)dq, F, N, H, d,
      q_rs, k_rs, v_rs, ck_rs, cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = space_dkv_smem_bytes(N, d);
  if ((err = allow_smem(space_bwd_dkv_kernel<T>, smem)) != cudaSuccess)
    return err;
  space_bwd_dkv_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (const T*)dout, (const T*)out, (const float*)lse, (T*)dk, (T*)dv,
      (float*)part_k, (float*)part_v, F, N, H, d, q_rs, k_rs, v_rs, ck_rs,
      cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_groups<T>((const float*)part_k, (const float*)part_v,
                              dck, dcv, B, F, (long long)H * d, stream);
}

// The tensor-core K1 bwd takes bf16 with head_dim 64, at most 207
// patches and bf16-pair aligned rows, as the forward's; everything else
// takes the SIMT kernels.
bool space_bwd_mma_fits(const void* q, const void* k, const void* v,
                        const void* ck, const void* cv, const void* dout,
                        const void* out, int N, int d, long long q_rs,
                        long long k_rs, long long v_rs, long long ck_rs,
                        long long cv_rs) {
  return d == kMmaD && N + 1 <= kPad &&
         lavila::bf16_pairs_ok({q, k, v, ck, cv, dout, out},
                               {q_rs, k_rs, v_rs, ck_rs, cv_rs});
}

cudaError_t launch_space_bwd_mma(const void* q, const void* k, const void* v,
                                 const void* ck, const void* cv,
                                 const void* dout, const void* out,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, void* dck, void* dcv,
                                 void* part_k, void* part_v, int B, int F,
                                 int N, int H, long long q_rs, long long k_rs,
                                 long long v_rs, long long ck_rs,
                                 long long cv_rs, float scale,
                                 cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  cudaError_t err = launch_delta<bf16>(dout, out, delta,
                                       (long long)B * F * N * H, kMmaD,
                                       stream);
  if (err != cudaSuccess) return err;

  const dim3 grid(H, F, B);
  size_t smem = space_dq_mma_smem_bytes();
  if ((err = allow_smem(space_bwd_dq_mma_kernel, smem)) != cudaSuccess)
    return err;
  space_bwd_dq_mma_kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ck,
      (const bf16*)cv, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dq, F, N, H, q_rs, k_rs, v_rs, ck_rs,
      cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = space_dkv_mma_smem_bytes();
  if ((err = allow_smem(space_bwd_dkv_mma_kernel, smem)) != cudaSuccess)
    return err;
  space_bwd_dkv_mma_kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ck,
      (const bf16*)cv, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, (float*)part_k,
      (float*)part_v, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_groups<bf16>((const float*)part_k, (const float*)part_v,
                                 dck, dcv, B, F, (long long)H * kMmaD,
                                 stream);
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

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = fp32, 1 = bf16.
// part_k/part_v: fp32 scratch the caller allocates, (B, F, D) for the
// spatial phase and (B, N, D) for the temporal one; delta: fp32 scratch
// (B, F, N, H) for the spatial phase's tensor-core path. Returns the
// cudaError_t of the launches (0 on success).
extern "C" {

int lavila_divided_space_bwd(const void* q, const void* k, const void* v,
                             const void* ck, const void* cv,
                             const void* dout, const void* out,
                             const void* lse, void* delta, void* dq,
                             void* dk, void* dv, void* dck, void* dcv,
                             void* part_k, void* part_v, int B, int F, int N,
                             int H, int d, long long q_rs, long long k_rs,
                             long long v_rs, long long ck_rs, long long cv_rs,
                             float scale, int dtype, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && space_bwd_mma_fits(q, k, v, ck, cv, dout, out, N, d,
                                       q_rs, k_rs, v_rs, ck_rs, cv_rs))
    return (int)launch_space_bwd_mma(
        q, k, v, ck, cv, dout, out, lse, delta, dq, dk, dv, dck, dcv, part_k,
        part_v, B, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 0)
    return (int)launch_space_bwd<float>(
        q, k, v, ck, cv, dout, out, lse, dq, dk, dv, dck, dcv, part_k, part_v,
        B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 1)
    return (int)launch_space_bwd<__nv_bfloat16>(
        q, k, v, ck, cv, dout, out, lse, dq, dk, dv, dck, dcv, part_k, part_v,
        B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lavila_divided_time_bwd(const void* q, const void* k, const void* v,
                            const void* ck, const void* cv, const void* dout,
                            const void* out, const void* lse, void* dq,
                            void* dk, void* dv, void* dck, void* dcv,
                            void* part_k, void* part_v, int B, int F, int N,
                            int H, int d, long long q_rs, long long k_rs,
                            long long v_rs, long long ck_rs, long long cv_rs,
                            float scale, int dtype, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_time_bwd<float>(
        q, k, v, ck, cv, dout, out, lse, dq, dk, dv, dck, dcv, part_k, part_v,
        B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 1)
    return (int)launch_time_bwd<__nv_bfloat16>(
        q, k, v, ck, cv, dout, out, lse, dq, dk, dv, dck, dcv, part_k, part_v,
        B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
