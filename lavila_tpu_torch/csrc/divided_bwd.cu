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
// K1 bwd, spatial phase: one (clip, frame, head) sees N <= 256 queries
// and the N+1 keys [ck; k_f]. FlashAttention-2's split, as K6's
// (divided_big.cu): a dq kernel that walks the key tiles for a block of
// queries, a dk/dv kernel that walks the query tiles for a block of keys,
// each recomputing P from the saved lse. The caller picks one of two
// pairs (kernels/divided.py asks for the tensor cores by the `tc`
// argument; the entry point refuses a call they cannot take):
//
//  * bf16, head_dim 64, q/k/v/dO rows on 16-byte boundaries: tensor
//    cores, mma.sync m16n8k16 (bf16 in, fp32 accumulate), one design for
//    every N <= 256. Bound by bytes: ~10*(N+1)*d FLOPs per query row
//    against 8*d*2 bytes of q/k/v/dO/O/dq/dk/dv, ~123 FLOPs a byte at N =
//    196 (77 MB and 9.5 GFLOP at TSF-B's batch 8, 0.0231 ms at 3.35 TB/s)
//    and ~160 at N = 256 (134 MB, 21.5 GFLOP at TSF-L@224's, 0.040 ms),
//    below the H100's ~295. So, as the forward, the design is about the
//    memory side. Both kernels take 64 rows a block of 4 warps (16 rows a
//    warp), ceil(N/64) x H x B*F blocks (1536 at TSF-B batch 8), and
//    stream the other side's 64-row tiles through two cp.async stages
//    ([row][d], rows padded by 8 bf16 so that fragment loads hit 32
//    banks; the dk/dv kernel's per-query lse and delta ride in the same
//    stage), the copy of tile t+1 in flight while tile t is used; every
//    product whose B operand is a [row][d] tile read down its rows (dS K,
//    P^T dO, dS^T Q) takes it through ldmatrix's transpose. (128 rows a
//    block of 8 warps measured no faster.) The CLS key is handled as the
//    forward's starting state: the dq kernel computes, per query row,
//    delta = rowsum(dO*O) (a side output the dk/dv kernel reads: no delta
//    pass), P_cls and dS_cls, adds dS_cls*ck to dq, and writes its 64
//    queries' share of dck = scale * sum dS_cls*q and dcv = sum P_cls*dO
//    as fp32 partials (B, F*ceil(N/64), D); the key tiles are plain rows
//    of k_f, masked past N. Padded queries are zero rows of Q and dO with
//    lse = delta = 0, so their dS and P^T dO are zero.
//  * everything else (fp32, whose 1e-4 bound rules out bf16 or TF32
//    tensor cores, other head sizes, unaligned rows): SIMT fp32 FMA, bound
//    by FMA issue and shared-memory loads (~7*d FMAs per query-key pair
//    against the forward's 2*d). space_bwd_dq_kernel stages K and V in
//    fp32 (~100 KB, rows padded to d+1 floats so lane j reading row j hits
//    its own bank); each warp takes one query row, computes its delta,
//    then dS over the N+1 keys and dq. space_bwd_dkv_kernel stages Q, dO,
//    lse and delta (recomputed from dO and O while staging; ~120 KB); each
//    warp takes one key row (row 0 the CLS key: its dK/dV rows are this
//    frame's share of dck/dcv, partials (B, F, D)), P and dS against all N
//    queries, then dK, dV.
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
using lavila::launch_sum_groups;
using lavila::ld32;
using lavila::pack_bf16;
using lavila::quad_sum;
using lavila::to_float;
using lavila::unpack_bf16;
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

// ---- K1 bwd, bf16 head_dim 64: mma.sync on 64-row tiles ----------------

using namespace lavila::d64;  // kD, kRow, kChunks and the fragment helpers

constexpr int kTile = 64;         // queries (dq) or keys (dk/dv) a block
constexpr int kTcWarps = 4;       // 16 rows each
constexpr int kTileElems = kTile * kRow;
constexpr float kLog2e = 1.4426950408889634f;

// Copy rows first..first+63 of frame x_f (head slice at col) into a
// [row][d] tile by cp.async, zeros past `rows`.
__device__ __forceinline__ void async_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* x,
                                           long long x_rs,
                                           long long frame_row, int col,
                                           int first, int rows) {
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int n = first + r;
    const bool ok = n < rows;
    lavila::cp_async16(dst + r * kRow + 8 * c,
                       ok ? x + (frame_row + n) * x_rs + col + 8 * c : x,
                       ok);
  }
}

// dq: grid (ceil(N/64), H, B*F), kTcWarps*32 threads; warp w owns queries
// 16w..16w+15 of the block's 64. First, per query row (fragments loaded
// from device memory): delta = rowsum(dO*O), written for the dk/dv kernel,
// and the CLS key's P and dS. Then per 64-key tile of k_f (two cp.async
// stages), S = Q K^T and dP = dO V^T on the tensor cores, dS = P (dP -
// delta) in registers, dS (bf16) times K into dq. dq = scale*(dS K +
// dS_cls ck). The block's share of dck/dcv (its 64 queries' scale*dS_cls*q
// and P_cls*dO) goes to the fp32 partials (B, F*ceil(N/64), D).
__global__ void __launch_bounds__(kTcWarps * 32)
    space_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ ck,
                           const __nv_bfloat16* __restrict__ cv,
                           const __nv_bfloat16* __restrict__ dout,
                           const __nv_bfloat16* __restrict__ out,
                           const float* __restrict__ lse,
                           float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq,
                           float* __restrict__ part_k,
                           float* __restrict__ part_v, int F, int N, int H,
                           long long q_rs, long long k_rs, long long v_rs,
                           long long ck_rs, long long cv_rs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 tiles[2][2][kTileElems];  // K, V
  __shared__ float cls[2][kTcWarps][kD];  // per warp: dck, dcv shares
  const int qt = blockIdx.x, h = blockIdx.y, bf = blockIdx.z, b = bf / F;
  const long long frame_row = (long long)bf * N;
  const int col = h * kD;
  const long long D = (long long)H * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = qt * kTile + warp * 16 + g, n1 = n0 + 8;
  const bool ok0 = n0 < N, ok1 = n1 < N;
  const float sl2 = scale * kLog2e;

  auto stage = [&](int kt) {
    async_rows(tiles[kt & 1][0], k, k_rs, frame_row, col, kt * kTile, N);
    async_rows(tiles[kt & 1][1], v, v_rs, frame_row, col, kt * kTile, N);
    lavila::cp_async_commit();
  };
  stage(0);

  unsigned qa[kD / 16][4], ga[kD / 16][4];
  float dl0, dl1, pc0, pc1, dc0, dc1;  // delta, P_cls, dS_cls per row
  {
    unsigned oa[kD / 16][4];
    load_rows(qa, q + (frame_row + n0) * q_rs + col,
              q + (frame_row + n1) * q_rs + col, ok0, ok1, t);
    load_rows(ga, dout + (frame_row + n0) * D + col,
              dout + (frame_row + n1) * D + col, ok0, ok1, t);
    load_rows(oa, out + (frame_row + n0) * D + col,
              out + (frame_row + n1) * D + col, ok0, ok1, t);
    // this lane's 16 dims of rows g and g + 8: fragment kk, half hf holds
    // dims 16kk + 8hf + 2t, +1 (rows g in [2hf], g + 8 in [2hf + 1])
    float s0 = 0.f, s1 = 0.f, p0 = 0.f, p1 = 0.f, e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = col + kk * 16 + hf * 8 + 2 * t;
        const float2 kc = unpack_bf16(ld32(ck + b * ck_rs + c));
        const float2 vc = unpack_bf16(ld32(cv + b * cv_rs + c));
        const float2 qx = unpack_bf16(qa[kk][2 * hf]);
        const float2 qy = unpack_bf16(qa[kk][2 * hf + 1]);
        const float2 gx = unpack_bf16(ga[kk][2 * hf]);
        const float2 gy = unpack_bf16(ga[kk][2 * hf + 1]);
        const float2 ox = unpack_bf16(oa[kk][2 * hf]);
        const float2 oy = unpack_bf16(oa[kk][2 * hf + 1]);
        s0 += qx.x * kc.x + qx.y * kc.y;
        s1 += qy.x * kc.x + qy.y * kc.y;
        p0 += gx.x * vc.x + gx.y * vc.y;
        p1 += gy.x * vc.x + gy.y * vc.y;
        e0 += gx.x * ox.x + gx.y * ox.y;
        e1 += gy.x * oy.x + gy.y * oy.y;
      }
    }
    dl0 = quad_sum(e0);
    dl1 = quad_sum(e1);
    if (t == 0) {
      if (ok0) delta[(frame_row + n0) * H + h] = dl0;
      if (ok1) delta[(frame_row + n1) * H + h] = dl1;
    }
    // padded rows: q = dO = 0, lse = 0, so P_cls = 1 and dS_cls = 0; they
    // add nothing to dck/dcv
    const float l0 = ok0 ? lse[(frame_row + n0) * H + h] * kLog2e : 0.f;
    const float l1 = ok1 ? lse[(frame_row + n1) * H + h] * kLog2e : 0.f;
    pc0 = exp2f(quad_sum(s0) * sl2 - l0);
    pc1 = exp2f(quad_sum(s1) * sl2 - l1);
    dc0 = pc0 * (quad_sum(p0) - dl0);
    dc1 = pc1 * (quad_sum(p1) - dl1);
  }
  // the block's share of dck/dcv, this warp's 16 rows: sum the lane's two
  // rows, then the 8 lanes of equal t (xor over g)
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 qx = unpack_bf16(qa[kk][2 * hf]);
      const float2 qy = unpack_bf16(qa[kk][2 * hf + 1]);
      const float2 gx = unpack_bf16(ga[kk][2 * hf]);
      const float2 gy = unpack_bf16(ga[kk][2 * hf + 1]);
      float r[4] = {dc0 * qx.x + dc1 * qy.x, dc0 * qx.y + dc1 * qy.y,
                    pc0 * gx.x + pc1 * gy.x, pc0 * gx.y + pc1 * gy.y};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          r[i] += __shfl_xor_sync(0xffffffffu, r[i], o);
      if (g == 0) {
        const int c = kk * 16 + hf * 8 + 2 * t;
        cls[0][warp][c] = r[0];
        cls[0][warp][c + 1] = r[1];
        cls[1][warp][c] = r[2];
        cls[1][warp][c + 1] = r[3];
      }
    }
  }

  const float l0 = ok0 ? lse[(frame_row + n0) * H + h] * kLog2e : 0.f;
  const float l1 = ok1 ? lse[(frame_row + n1) * H + h] * kLog2e : 0.f;
  float acc[kD / 8][4];
  zero(acc);
  const int n_tiles = (N + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) stage(kt + 1);
    else lavila::cp_async_commit();  // an empty group keeps the count
    lavila::cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* ks = tiles[kt & 1][0];
    const __nv_bfloat16* vs = tiles[kt & 1][1];
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
              kt * kTile + (2 * st + half) * 8 + 2 * t + e < N;
          const float p0 = valid ? exp2f(s[half][e] * sl2 - l0) : 0.f;
          const float p1 = valid ? exp2f(s[half][2 + e] * sl2 - l1) : 0.f;
          s[half][e] = p0 * (dp[half][e] - dl0);          // dS, row n0
          s[half][2 + e] = p1 * (dp[half][2 + e] - dl1);  // dS, row n1
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
  // the CLS key's term, then dq = scale * acc
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const float2 kc = unpack_bf16(ld32(ck + b * ck_rs + col + dn * 8 + 2 * t));
    acc[dn][0] += dc0 * kc.x;
    acc[dn][1] += dc0 * kc.y;
    acc[dn][2] += dc1 * kc.x;
    acc[dn][3] += dc1 * kc.y;
  }
  store_rows(dq + (frame_row + n0) * D + col, dq + (frame_row + n1) * D + col,
             ok0, ok1, acc, scale, scale, t);
  // the block's dck/dcv partials: the 4 warps' shares in a fixed order
  // (the last __syncthreads of the loop made them visible)
  const long long o = ((long long)bf * gridDim.x + qt) * D + col;
  for (int i = threadIdx.x; i < 2 * kD; i += blockDim.x) {
    const int which = i / kD, c = i - which * kD;
    float sum = 0.f;
    for (int w = 0; w < kTcWarps; ++w) sum += cls[which][w][c];
    if (which == 0) part_k[o + c] = sum * scale;
    else part_v[o + c] = sum;
  }
}

// dk/dv: grid (ceil(N/64), H, B*F), kTcWarps*32 threads; warp w owns keys
// 16w..16w+15 of the block's 64 (rows of k_f and v_f: the CLS key's
// gradient is the dq kernel's). Per query tile (two cp.async stages), Q and
// dO [query][d] with lse and delta per query; S^T = K Q^T and dP^T = V
// dO^T on the tensor cores, P^T and dS^T in registers, then P^T dO into
// dV and dS^T Q into dK, both through ldmatrix's transpose.
__global__ void __launch_bounds__(kTcWarps * 32)
    space_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int N, int H,
                            long long q_rs, long long k_rs, long long v_rs,
                            float scale) {
  __shared__ __align__(16) __nv_bfloat16 tiles[2][2][kTileElems];  // Q, dO
  __shared__ float stats[2][2][kTile];  // per stage: lse, delta
  const int h = blockIdx.y, bf = blockIdx.z;
  const long long frame_row = (long long)bf * N;
  const int col = h * kD;
  const long long D = (long long)H * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kTile + warp * 16 + g, j1 = j0 + 8;
  const float sl2 = scale * kLog2e;

  auto stage = [&](int qt) {
    async_rows(tiles[qt & 1][0], q, q_rs, frame_row, col, qt * kTile, N);
    async_rows(tiles[qt & 1][1], dout, D, frame_row, col, qt * kTile, N);
    // lse and delta by cp.async too; padded queries read lse = delta = 0:
    // their Q and dO rows are zeros, so dS = P (dP - delta) = 0 and
    // P^T dO = 0 whatever P is
    for (int nn = threadIdx.x; nn < kTile; nn += blockDim.x) {
      const int n = qt * kTile + nn;
      const long long r = (frame_row + (n < N ? n : 0)) * H + h;
      lavila::cp_async4(&stats[qt & 1][0][nn], lse + r, n < N);
      lavila::cp_async4(&stats[qt & 1][1][nn], delta + r, n < N);
    }
    lavila::cp_async_commit();
  };
  stage(0);

  unsigned ka[kD / 16][4], va[kD / 16][4];
  load_rows(ka, k + (frame_row + j0) * k_rs + col,
            k + (frame_row + j1) * k_rs + col, j0 < N, j1 < N, t);
  load_rows(va, v + (frame_row + j0) * v_rs + col,
            v + (frame_row + j1) * v_rs + col, j0 < N, j1 < N, t);
  float ak[kD / 8][4], av[kD / 8][4];
  zero(ak);
  zero(av);

  const int n_tiles = (N + kTile - 1) / kTile;
  for (int qt = 0; qt < n_tiles; ++qt) {
    if (qt + 1 < n_tiles) stage(qt + 1);
    else lavila::cp_async_commit();
    lavila::cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* qs = tiles[qt & 1][0];
    const __nv_bfloat16* gs = tiles[qt & 1][1];
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
          const float l = lses[nn] * kLog2e, dl = deltas[nn];
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
  store_rows(dk + (frame_row + j0) * D + col, dk + (frame_row + j1) * D + col,
             j0 < N, j1 < N, ak, scale, scale, t);
  store_rows(dv + (frame_row + j0) * D + col, dv + (frame_row + j1) * D + col,
             j0 < N, j1 < N, av, 1.f, 1.f, t);
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

// What the tensor-core K1 bwd takes (kernels/divided.py mirrors it): the
// forward's conditions (head_dim 64, 1 <= N <= 256, q/k/v rows on 16-byte
// boundaries, ck/cv as bf16 pairs), dO on a 16-byte boundary (cp.async)
// and O 4-byte aligned (read as bf16 pairs).
bool space_bwd_tc_fits(const void* q, const void* k, const void* v,
                       const void* ck, const void* cv, const void* dout,
                       const void* out, int N, int d, long long q_rs,
                       long long k_rs, long long v_rs, long long ck_rs,
                       long long cv_rs) {
  if (d != kD || N < 1 || N > 4 * kTile) return false;
  for (const void* p : {q, k, v, dout})
    if ((unsigned long long)p & 15ull) return false;
  for (long long s : {q_rs, k_rs, v_rs})
    if (s & 7ll) return false;
  return lavila::bf16_pairs_ok({ck, cv, out}, {ck_rs, cv_rs});
}

cudaError_t launch_space_bwd_tc(const void* q, const void* k, const void* v,
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
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid(tiles, H, B * F);
  space_bwd_dq_tc_kernel<<<grid, kTcWarps * 32, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)ck,
      (const bf16*)cv, (const bf16*)dout, (const bf16*)out,
      (const float*)lse, (float*)delta, (bf16*)dq, (float*)part_k,
      (float*)part_v, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  space_bwd_dkv_tc_kernel<<<grid, kTcWarps * 32, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, N, H,
      q_rs, k_rs, v_rs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_groups<bf16>((const float*)part_k, (const float*)part_v,
                                 dck, dcv, B, F * tiles, (long long)H * kD,
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
// part_k/part_v: fp32 scratch the caller allocates: (B, F*ceil(N/64), D)
// for the spatial phase's tensor-core kernels, (B, F, D) for its SIMT
// ones, (B, N, D) for the temporal phase; delta: fp32 scratch (B, F, N, H)
// for the spatial phase's tensor-core kernels. Returns the cudaError_t of
// the launches (0 on success).
extern "C" {

// tc: 1 runs the tensor-core kernels (bf16; refused with
// cudaErrorInvalidValue where space_bwd_tc_fits does not hold), 0 the SIMT
// ones.
int lavila_divided_space_bwd(const void* q, const void* k, const void* v,
                             const void* ck, const void* cv,
                             const void* dout, const void* out,
                             const void* lse, void* delta, void* dq,
                             void* dk, void* dv, void* dck, void* dcv,
                             void* part_k, void* part_v, int B, int F, int N,
                             int H, int d, long long q_rs, long long k_rs,
                             long long v_rs, long long ck_rs, long long cv_rs,
                             float scale, int dtype, int tc, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    if (dtype != 1 || !space_bwd_tc_fits(q, k, v, ck, cv, dout, out, N, d,
                                         q_rs, k_rs, v_rs, ck_rs, cv_rs))
      return (int)cudaErrorInvalidValue;
    return (int)launch_space_bwd_tc(
        q, k, v, ck, cv, dout, out, lse, delta, dq, dk, dv, dck, dcv, part_k,
        part_v, B, F, N, H, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  }
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
