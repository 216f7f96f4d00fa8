// The CLS token's global attention row of divided space-time attention,
// forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package writes this row in XLA ops
// (lavila_tpu/ops/attention.py:_cls_row_attention, a custom VJP of
// token-major mul-reduces whose backward keeps every full-size tensor in
// the input dtype). The port's plain version made fp32 copies of the
// strided k/v row views and ran batched GEMVs on them, ~10x the bytes
// the row needs; these kernels read each row once in the input dtype.
// Per clip b and head h, with the CLS query q = cls_q * d^-0.5 (fp32) over
// its own key and the L = F*N patch keys k_j (products and sums in fp32
// from the stored inputs, as the plain version computes them):
//
//   s_0 = q . cls_k,  s_j = q . k_j,  lse = log(exp(s_0) + sum_j exp(s_j))
//   out = exp(s_0 - lse) cls_v + sum_j exp(s_j - lse) v_j
//
// and, g being the output's gradient and o the fp32 out:
//
//   delta = g . o,  p_j = exp(s_j - lse),  ds_j = p_j (g . v_j - delta)
//   dk_j = ds_j q,  dv_j = p_j g,  dq = (ds_0 cls_k + sum_j ds_j k_j) d^-0.5
//   dcls_k = ds_0 q,  dcls_v = p_0 g
//
// What bounds it on the H100: ~2 FLOPs a byte, against the ~295 where the
// tensor cores would matter, so one read of k and v (and one write of dk
// and dv) at 3.35 TB/s: at TSF-L@336 (F 4, N 576, D 1024, bf16) the
// forward reads 151 MB at 16 clips (45 us), the backward moves 604 MB at
// 32 clips (180 us). The design serves that alone:
//  - Grid (S key splits, B clips); the wrapper picks S from B so that the
//    blocks fill the 132 SMs a few times over. A block walks rows
//    [s * c, (s + 1) * c) of its clip, R rows at a time and kAhead row
//    steps per load round, so each thread has 2 * kAhead 16-byte loads in
//    flight.
//  - A row holds all H heads of k (then v) as H * d contiguous elements of
//    the qkv projection's row view (its row stride is passed: no copy). A
//    thread reads one 16-byte chunk of one head (8 bf16 or 4 fp32); a
//    head's chunks lie on P = pow2ceil(d / chunk) neighbouring lanes (the
//    lanes past d / chunk idle), whose partial dots meet by shuffles, so
//    neighbouring lanes read neighbouring 16 bytes.
//  - Forward: an online softmax per (row slot, head) in registers, (m, l)
//    and the lane's chunk of the fp32 sum; the block's row slots merge in
//    shared memory into one fp32 partial (m, l, acc[d]) per (clip, split,
//    head), and cls_row_combine_kernel folds the CLS key and the splits
//    into out (input dtype), lse and o (fp32, (B, H, d): the backward's
//    delta, as autograd of the plain version takes it).
//  - Backward: the same walk; each row's dk and dv chunks go out in the
//    input dtype straight from registers, dq's sums stay in fp32 per
//    split, and cls_row_bwd_combine_kernel gives dcls_q, dcls_k, dcls_v.
//    No fp32 tensor of the patches' size exists in either direction.
//  - Row views whose chunks are not on 16-byte boundaries (an odd row
//    stride) take element loads: the VEC = false instantiation.
// Any H (a tensor-parallel rank's local heads too), head_dim a multiple
// of 8 up to 128, fp32 or bf16; the entry points refuse anything else.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using lavila::from_float;
using lavila::pack_bf16;
using lavila::to_float;
using lavila::warp_max;
using lavila::warp_sum;

constexpr int kThreads = 256;     // a block's lanes when a row needs fewer
constexpr int kMaxThreads = 512;  // one row's lanes at most (H * P)
constexpr int kAhead = 4;         // row steps a thread loads per round
constexpr int kCombineWarps = 4;  // (clip, head) pairs a combine block
constexpr int kMaxSplits = 256;
constexpr int kSumLanes = 8;      // independent sums over the splits

// sum over k < S of w(k) * x[k * stride]: kSumLanes loads in flight,
// each into a sum of its own, so no load waits on the one before it
template <typename W>
__device__ __forceinline__ float sum_splits(const float* x, long long stride,
                                            int S, W w) {
  float a[kSumLanes];
#pragma unroll
  for (int j = 0; j < kSumLanes; ++j) a[j] = 0.f;
  int k = 0;
  for (; k + kSumLanes <= S; k += kSumLanes) {
#pragma unroll
    for (int j = 0; j < kSumLanes; ++j)
      a[j] = fmaf(w(k + j), x[(k + j) * stride], a[j]);
  }
  for (; k < S; ++k) a[0] = fmaf(w(k), x[k * stride], a[0]);
#pragma unroll
  for (int h = kSumLanes / 2; h > 0; h >>= 1)
#pragma unroll
    for (int j = 0; j < h; ++j) a[j] += a[j + h];
  return a[0];
}

template <typename T>
constexpr int kChunk = 16 / sizeof(T);  // elements in 16 bytes

// one 16-byte chunk at p: a vector load where VEC (p 16-byte aligned),
// else element loads packed the same way
template <bool VEC>
__device__ __forceinline__ uint4 load_chunk(const float* p) {
  if constexpr (VEC) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                      __float_as_uint(p[2]), __float_as_uint(p[3]));
  }
}

template <bool VEC>
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* p) {
  if constexpr (VEC) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
    return make_uint4(e[0] | (unsigned)e[1] << 16, e[2] | (unsigned)e[3] << 16,
                      e[4] | (unsigned)e[5] << 16, e[6] | (unsigned)e[7] << 16);
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// sum over the P lanes of a head's chunks (P a power of two up to 32; the
// groups are aligned, so no shuffle leaves its group)
__device__ __forceinline__ float group_sum(float v, int P) {
  for (int o = P >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A thread's place: row slot, head and chunk; `live` if the slot is one
// of the block's R, `on` if it also holds a chunk of the head (chunk
// index below d / E).
struct Lane {
  int slot, h, c, col;
  bool live, on;
};

template <typename T>
__device__ __forceinline__ Lane lane_of(int H, int d, int P, int R) {
  const int TR = H * P;
  Lane ln;
  ln.slot = threadIdx.x / TR;
  const int w = threadIdx.x - ln.slot * TR;
  ln.h = w / P;
  ln.c = w - ln.h * P;
  ln.col = ln.h * d + ln.c * kChunk<T>;
  ln.live = ln.slot < R;
  ln.on = ln.live && ln.c * kChunk<T> < d;
  return ln;
}

// Forward over one split of one clip's rows. Grid (S, B); blockDim.x =
// R * H * P lanes rounded up to a warp; dynamic shared memory R * H *
// (d + 2) floats. part: (B, S, H, d + 2) fp32, per head (m, l, acc[d]).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    cls_row_fwd_kernel(const T* __restrict__ cq, const T* __restrict__ kp,
                       const T* __restrict__ vp, float* __restrict__ part,
                       int L, int H, int d, int P, int R, int rows,
                       long long cq_bs, long long kp_rs, long long vp_rs,
                       float scale) {
  constexpr int E = kChunk<T>;
  extern __shared__ float smem[];
  const int s = blockIdx.x, b = blockIdx.y;
  const Lane ln = lane_of<T>(H, d, P, R);
  float q[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    q[e] = ln.on ? to_float(cq[b * cq_bs + ln.col + e]) * scale : 0.f;
  const int r0 = s * rows, r1 = min(L, r0 + rows);
  const T* kb = kp + (long long)b * L * kp_rs + ln.col;
  const T* vb = vp + (long long)b * L * vp_rs + ln.col;

  float m = -INFINITY, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  // every thread runs the same rounds, so the shuffles stay converged
  for (int r = r0; r < r1; r += R * kAhead) {
    uint4 kr[kAhead], vr[kAhead];
    bool ok[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int row = r + u * R + ln.slot;
      ok[u] = ln.live && row < r1;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u] && ln.on) {
        kr[u] = load_chunk<VEC>(kb + (long long)row * kp_rs);
        vr[u] = load_chunk<VEC>(vb + (long long)row * vp_rs);
      }
    }
    float sc[kAhead];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      float f[E];
      unpack(kr[u], f);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(q[e], f[e], dot);
      dot = group_sum(dot, P);
      sc[u] = ok[u] ? dot : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    if (mx != -INFINITY) {
      const float corr = expf(m - mx);  // 0 while m is -inf
      l *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const float p = expf(sc[u] - mx);
        float f[E];
        unpack(vr[u], f);
        l += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p, f[e], acc[e]);
      }
      m = mx;
    }
  }

  // merge the block's row slots: one partial per head
  const int HD = H * (d + 2);
  if (ln.on) {
    float* mine = smem + ln.slot * HD + ln.h * (d + 2);
#pragma unroll
    for (int e = 0; e < E; ++e) mine[2 + ln.c * E + e] = acc[e];
    if (ln.c == 0) {
      mine[0] = m;
      mine[1] = l;
    }
  }
  __syncthreads();
  float* dst = part + ((long long)b * gridDim.x + s) * HD;
  for (int i = threadIdx.x; i < H * d; i += blockDim.x) {
    const int h = i / d, j = i - h * d;
    float M = -INFINITY;
    for (int k = 0; k < R; ++k) M = fmaxf(M, smem[k * HD + h * (d + 2)]);
    float A = 0.f, Ls = 0.f;
    if (M != -INFINITY) {
      for (int k = 0; k < R; ++k) {
        const float* sl = smem + k * HD + h * (d + 2);
        if (sl[0] == -INFINITY) continue;  // a slot with no rows
        const float w = expf(sl[0] - M);
        A = fmaf(w, sl[2 + j], A);
        Ls = fmaf(w, sl[1], Ls);
      }
    }
    dst[h * (d + 2) + 2 + j] = A;
    if (j == 0) {
      dst[h * (d + 2)] = M;
      dst[h * (d + 2) + 1] = Ls;
    }
  }
}

// One warp per (clip, head): the CLS key and the S splits' partials into
// out (B, 1, H, d) in T, lse (B, H) and o (B, H, d) in fp32.
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
    cls_row_combine_kernel(const T* __restrict__ cq, const T* __restrict__ ck,
                           const T* __restrict__ cv,
                           const float* __restrict__ part, T* __restrict__ out,
                           float* __restrict__ lse, float* __restrict__ o,
                           int B, int H, int d, int S, long long cq_bs,
                           long long ck_bs, long long cv_bs, float scale) {
  __shared__ float wts[kCombineWarps][kMaxSplits];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int task = blockIdx.x * kCombineWarps + warp;
  if (task >= B * H) return;  // no block-wide barrier below
  const int b = task / H, h = task - b * H;
  const int col = h * d;
  float s0 = 0.f;
  for (int i = lane; i < d; i += 32)
    s0 = fmaf(to_float(cq[b * cq_bs + col + i]) * scale,
              to_float(ck[b * ck_bs + col + i]), s0);
  s0 = warp_sum(s0);
  const int HD = H * (d + 2);
  const float* pp = part + (long long)b * S * HD + h * (d + 2);
  float M = s0;
  for (int k = lane; k < S; k += 32) M = fmaxf(M, pp[(long long)k * HD]);
  M = warp_max(M);
  float Ls = 0.f;
  for (int k = lane; k < S; k += 32) {
    const float mk = pp[(long long)k * HD];
    const float w = mk == -INFINITY ? 0.f : expf(mk - M);
    wts[warp][k] = w;
    Ls = fmaf(w, pp[(long long)k * HD + 1], Ls);
  }
  const float w0 = expf(s0 - M);
  Ls = warp_sum(Ls) + w0;
  __syncwarp();
  const float inv = 1.f / Ls;
  const float* wk = wts[warp];
  for (int i = lane; i < d; i += 32) {
    float a = sum_splits(pp + 2 + i, HD, S, [wk](int k) { return wk[k]; });
    a = fmaf(w0, to_float(cv[b * cv_bs + col + i]), a) * inv;
    const long long at = (long long)task * d + i;
    o[at] = a;
    out[at] = from_float<T>(a);
  }
  if (lane == 0) lse[task] = M + logf(Ls);
}

// Backward over one split of one clip's rows, the forward's grid and
// lanes; dynamic shared memory R * H * d floats. g (B, 1, H, d), o (B, H,
// d) and dkp/dvp (B, L, H, d) contiguous; part: (B, S, H, d) fp32, the
// split's sum of ds_j k_j.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    cls_row_bwd_kernel(const T* __restrict__ cq, const T* __restrict__ kp,
                       const T* __restrict__ vp, const T* __restrict__ g,
                       const float* __restrict__ o,
                       const float* __restrict__ lse, T* __restrict__ dkp,
                       T* __restrict__ dvp, float* __restrict__ part, int L,
                       int H, int d, int P, int R, int rows, long long cq_bs,
                       long long kp_rs, long long vp_rs, float scale) {
  constexpr int E = kChunk<T>;
  extern __shared__ float smem[];
  const int s = blockIdx.x, b = blockIdx.y;
  const Lane ln = lane_of<T>(H, d, P, R);
  const long long D = (long long)H * d;
  float q[E], gg[E], dq[E];
  float delta = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    q[e] = ln.on ? to_float(cq[b * cq_bs + ln.col + e]) * scale : 0.f;
    gg[e] = ln.on ? to_float(g[b * D + ln.col + e]) : 0.f;
    if (ln.on) delta = fmaf(gg[e], o[b * D + ln.col + e], delta);
    dq[e] = 0.f;
  }
  delta = group_sum(delta, P);
  const float ls = lse[b * H + ln.h];
  const int r0 = s * rows, r1 = min(L, r0 + rows);
  const T* kb = kp + (long long)b * L * kp_rs + ln.col;
  const T* vb = vp + (long long)b * L * vp_rs + ln.col;
  T* dkb = dkp + (long long)b * L * D + ln.col;
  T* dvb = dvp + (long long)b * L * D + ln.col;

  for (int r = r0; r < r1; r += R * kAhead) {
    uint4 kr[kAhead], vr[kAhead];
    bool ok[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int row = r + u * R + ln.slot;
      ok[u] = ln.on && row < r1;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        kr[u] = load_chunk<VEC>(kb + (long long)row * kp_rs);
        vr[u] = load_chunk<VEC>(vb + (long long)row * vp_rs);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      float fk[E], fv[E];
      unpack(kr[u], fk);
      unpack(vr[u], fv);
      float sdot = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sdot = fmaf(q[e], fk[e], sdot);
        dp = fmaf(gg[e], fv[e], dp);
      }
      sdot = group_sum(sdot, P);
      dp = group_sum(dp, P);
      if (ok[u]) {
        const float p = expf(sdot - ls);
        const float ds = p * (dp - delta);
        float tk[E], tv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          tk[e] = ds * q[e];
          tv[e] = p * gg[e];
          dq[e] = fmaf(ds, fk[e], dq[e]);
        }
        const long long at = (long long)(r + u * R + ln.slot) * D;
        *reinterpret_cast<uint4*>(dkb + at) = pack(tk);
        *reinterpret_cast<uint4*>(dvb + at) = pack(tv);
      }
    }
  }

  // sum the block's row slots: one partial per head
  const int HD = H * d;
  if (ln.on) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      smem[ln.slot * HD + ln.col + e] = dq[e];
  }
  __syncthreads();
  float* dst = part + ((long long)b * gridDim.x + s) * HD;
  for (int i = threadIdx.x; i < HD; i += blockDim.x) {
    float a = 0.f;
    for (int k = 0; k < R; ++k) a += smem[k * HD + i];
    dst[i] = a;
  }
}

// One warp per (clip, head): dcls_q (the splits' sums and the CLS key's
// term), dcls_k and dcls_v, each (B, 1, H, d) in T.
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
    cls_row_bwd_combine_kernel(
        const T* __restrict__ cq, const T* __restrict__ ck,
        const T* __restrict__ cv, const T* __restrict__ g,
        const float* __restrict__ o, const float* __restrict__ lse,
        const float* __restrict__ part, T* __restrict__ dcq,
        T* __restrict__ dck, T* __restrict__ dcv, int B, int H, int d, int S,
        long long cq_bs, long long ck_bs, long long cv_bs, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int task = blockIdx.x * kCombineWarps + warp;
  if (task >= B * H) return;
  const int b = task / H, h = task - b * H;
  const int col = h * d;
  const long long row = (long long)task * d;  // (b, h) of g, o, the grads
  float s0 = 0.f, dp0 = 0.f, delta = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float gi = to_float(g[row + i]);
    s0 = fmaf(to_float(cq[b * cq_bs + col + i]) * scale,
              to_float(ck[b * ck_bs + col + i]), s0);
    dp0 = fmaf(gi, to_float(cv[b * cv_bs + col + i]), dp0);
    delta = fmaf(gi, o[row + i], delta);
  }
  s0 = warp_sum(s0);
  dp0 = warp_sum(dp0);
  delta = warp_sum(delta);
  const float p0 = expf(s0 - lse[task]);
  const float ds0 = p0 * (dp0 - delta);
  const float* pp = part + (long long)b * S * H * d + col;
  for (int i = lane; i < d; i += 32) {
    const float qi = to_float(cq[b * cq_bs + col + i]) * scale;
    float a = sum_splits(pp + i, (long long)H * d, S,
                         [](int) { return 1.f; });
    a = fmaf(ds0, to_float(ck[b * ck_bs + col + i]), a);
    dcq[row + i] = from_float<T>(a * scale);
    dck[row + i] = from_float<T>(ds0 * qi);
    dcv[row + i] = from_float<T>(p0 * to_float(g[row + i]));
  }
}

// The block shape of a (H, d) row: P lanes a head, R row slots, threads.
struct Plan {
  int P, R, threads;
};

template <typename T>
Plan plan(int H, int d) {
  const int chunks = d / kChunk<T>;
  int P = 1;
  while (P < chunks) P <<= 1;
  const int TR = H * P;
  const int R = TR >= kThreads ? 1 : kThreads / TR;
  return {P, R, (R * TR + 31) / 32 * 32};
}

bool shape_ok(int B, int L, int H, int d, int S) {
  return B >= 1 && L >= 1 && H >= 1 && d >= 8 && d <= 128 && d % 8 == 0 &&
         S >= 1 && S <= kMaxSplits && S <= L;
}

template <typename T>
bool rows_aligned(const void* kp, const void* vp, long long kp_rs,
                  long long vp_rs) {
  return (uintptr_t)kp % 16 == 0 && (uintptr_t)vp % 16 == 0 &&
         (kp_rs * (long long)sizeof(T)) % 16 == 0 &&
         (vp_rs * (long long)sizeof(T)) % 16 == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* cq, const void* ck, const void* cv,
                       const void* kp, const void* vp, void* out, void* lse,
                       void* o, void* part, int B, int L, int H, int d, int S,
                       long long cq_bs, long long ck_bs, long long cv_bs,
                       long long kp_rs, long long vp_rs, float scale,
                       cudaStream_t st) {
  const Plan pl = plan<T>(H, d);
  if (pl.threads > kMaxThreads) return cudaErrorInvalidValue;
  const int rows = (L + S - 1) / S;
  const size_t smem = (size_t)pl.R * H * (d + 2) * sizeof(float);
  const dim3 grid(S, B);
  auto kernel = rows_aligned<T>(kp, vp, kp_rs, vp_rs)
                    ? cls_row_fwd_kernel<T, true>
                    : cls_row_fwd_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = lavila::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, pl.threads, smem, st>>>(
      (const T*)cq, (const T*)kp, (const T*)vp, (float*)part, L, H, d, pl.P,
      pl.R, rows, cq_bs, kp_rs, vp_rs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (B * H + kCombineWarps - 1) / kCombineWarps;
  cls_row_combine_kernel<T><<<blocks, kCombineWarps * 32, 0, st>>>(
      (const T*)cq, (const T*)ck, (const T*)cv, (const float*)part, (T*)out,
      (float*)lse, (float*)o, B, H, d, S, cq_bs, ck_bs, cv_bs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* cq, const void* ck, const void* cv,
                       const void* kp, const void* vp, const void* g,
                       const void* o, const void* lse, void* dkp, void* dvp,
                       void* dcq, void* dck, void* dcv, void* part, int B,
                       int L, int H, int d, int S, long long cq_bs,
                       long long ck_bs, long long cv_bs, long long kp_rs,
                       long long vp_rs, float scale, cudaStream_t st) {
  const Plan pl = plan<T>(H, d);
  if (pl.threads > kMaxThreads) return cudaErrorInvalidValue;
  const int rows = (L + S - 1) / S;
  const size_t smem = (size_t)pl.R * H * d * sizeof(float);
  const dim3 grid(S, B);
  auto kernel = rows_aligned<T>(kp, vp, kp_rs, vp_rs)
                    ? cls_row_bwd_kernel<T, true>
                    : cls_row_bwd_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = lavila::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, pl.threads, smem, st>>>(
      (const T*)cq, (const T*)kp, (const T*)vp, (const T*)g, (const float*)o,
      (const float*)lse, (T*)dkp, (T*)dvp, (float*)part, L, H, d, pl.P, pl.R,
      rows, cq_bs, kp_rs, vp_rs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (B * H + kCombineWarps - 1) / kCombineWarps;
  cls_row_bwd_combine_kernel<T><<<blocks, kCombineWarps * 32, 0, st>>>(
      (const T*)cq, (const T*)ck, (const T*)cv, (const T*)g, (const float*)o,
      (const float*)lse, (const float*)part, (T*)dcq, (T*)dck, (T*)dcv, B, H,
      d, S, cq_bs, ck_bs, cv_bs, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cls_q/cls_k/cls_v: (B, H*d) rows, unit stride inside a row, batch
// strides cq_bs/ck_bs/cv_bs in elements; kp/vp: (B*L, H*d) rows (the
// patches of every clip, frame-major), row strides kp_rs/vp_rs; out (B,
// H*d) in the input dtype, lse (B, H) and o (B, H*d) fp32, part (B, S, H,
// d + 2) fp32 scratch, all contiguous. S key splits, 1 <= S <= min(L,
// 256). dtype 0 = fp32, 1 = bf16.
int lavila_cls_row_fwd(const void* cq, const void* ck, const void* cv,
                       const void* kp, const void* vp, void* out, void* lse,
                       void* o, void* part, int B, int L, int H, int d, int S,
                       long long cq_bs, long long ck_bs, long long cv_bs,
                       long long kp_rs, long long vp_rs, float scale,
                       int dtype, void* stream) {
  if (!shape_ok(B, L, H, d, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_fwd<float>(cq, ck, cv, kp, vp, out, lse, o, part, B,
                                  L, H, d, S, cq_bs, ck_bs, cv_bs, kp_rs,
                                  vp_rs, scale, st);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(cq, ck, cv, kp, vp, out, lse, o,
                                          part, B, L, H, d, S, cq_bs, ck_bs,
                                          cv_bs, kp_rs, vp_rs, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The forward's inputs, lse and o as it wrote them, and g (B, H*d), the
// output's gradient, contiguous in the input dtype; dkp/dvp (B*L, H*d)
// and dcq/dck/dcv (B, H*d) contiguous in the input dtype; part (B, S, H,
// d) fp32 scratch.
int lavila_cls_row_bwd(const void* cq, const void* ck, const void* cv,
                       const void* kp, const void* vp, const void* g,
                       const void* o, const void* lse, void* dkp, void* dvp,
                       void* dcq, void* dck, void* dcv, void* part, int B,
                       int L, int H, int d, int S, long long cq_bs,
                       long long ck_bs, long long cv_bs, long long kp_rs,
                       long long vp_rs, float scale, int dtype,
                       void* stream) {
  if (!shape_ok(B, L, H, d, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_bwd<float>(cq, ck, cv, kp, vp, g, o, lse, dkp, dvp,
                                  dcq, dck, dcv, part, B, L, H, d, S, cq_bs,
                                  ck_bs, cv_bs, kp_rs, vp_rs, scale, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(
        cq, ck, cv, kp, vp, g, o, lse, dkp, dvp, dcq, dck, dcv, part, B, L,
        H, d, S, cq_bs, ck_bs, cv_bs, kp_rs, vp_rs, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
