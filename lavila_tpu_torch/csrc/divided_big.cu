// Divided space-time attention over large frames (K6), forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels lavila_tpu/ops/pallas/divided.py:
// _space_big_fwd_kernel and _space_big_bwd_kernel (spatial_phase_big),
// the JAX package's spatial phase for frames of more than 256 patches:
// the 336px towers, N = 24 x 24 = 576. The contract is K1's
// (divided_fwd.cu): q/k/v (B, F, N, D = H*d) as row views with a row
// stride, the CLS key/value rows ck/cv (B, D) folded into every frame's
// softmax; the forward writes out (B, F, N, D) contiguous and the per-row
// log-sum-exp lse (B, F, N, H) fp32; the backward takes dO, O (read in
// fp32 only) and lse contiguous and writes dq/dk/dv (B, F, N, D)
// contiguous and dck/dcv (B, D). Inputs are fp32 or bf16; scores, softmax
// and sums are fp32.
//
// The caller picks one of two routes (kernels/divided.py asks for the
// tensor cores by the `tc` argument; the entry points refuse a call they
// cannot take):
//
//  * bf16, head_dim 64, rows on 16-byte boundaries: the spatial phase's
//    tensor-core kernels, the same ones K1 runs (lavila::launch_space_tc,
//    divided_fwd.cu; lavila::launch_space_bwd_tc, divided_bwd.cu): their
//    64-key tiles stream through a ring that a producer refills, so one
//    design serves every N. At TSF-L@336 the forward does 4*(N+1)*d
//    FLOPs per query against ~4*d*2 bytes of q/k/v/out (~290 FLOPs a
//    byte, the card's balance point); the backward ~10*(N+1)*d against
//    ~8*d*2 (~360 FLOPs a byte): bound by the tensor cores, hence wgmma.
//  * everything else (fp32, whose 1e-4 limit rules out bf16 or TF32
//    tensor cores; other head sizes; unaligned rows): the SIMT kernels
//    below, fp32 FMA. K1's SIMT kernels stage a whole frame in fp32 and
//    cannot hold 577 keys; these tile it: a block of 8 warps owns 64 rows,
//    8 per warp, and stages 64 keys (or queries) at a time as fp32 rows
//    padded to d+1 floats, so lane j reading row j hits its own bank. Key
//    0 of the first tile is the CLS key and the last tile (577 = 9*64 + 1)
//    masks its tail, so no row is ever fully masked.
//
// SIMT backward: FlashAttention-2's split. delta per (row, head) is
// rowsum(dO*O) in fp32, from a pass over the rows (the Pallas kernels'
// form), and rowsum(P*dP) in bf16, from a first walk of the dq kernel
// over the key tiles (divided_bwd.cu says why); the dq kernel walks the
// key tiles for 64 queries, the dk/dv kernel the query tiles for 64 keys,
// P recomputed from the saved lse. Key 0 of the dk/dv kernel is the CLS
// key: its rows are written as fp32 per-(clip, frame) partials and a
// second pass adds them over the frames in a fixed order. No atomics: two
// calls give the same bits.

#include <math.h>

#include "common.cuh"

namespace {

using lavila::allow_smem;
using lavila::from_float;
using lavila::kDeltaFromOut;
using lavila::launch_sum_groups;
using lavila::to_float;
using lavila::warp_max;
using lavila::warp_sum;

// ---- SIMT kernels (fp32, any head_dim <= 128) ---------------------------

constexpr int kTile = 64;  // queries per block, keys per tile (and back)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kTile / kWarps;  // 8
constexpr int kMaxDimsPerLane = 4;            // head_dim <= 128

// The (head-sliced) row j of [cls; x_f]: key/value j of the frame.
template <typename T>
__device__ __forceinline__ const T* key_row(const T* cls, long long cls_rs,
                                            const T* x, long long x_rs, int b,
                                            long long frame_row, int j) {
  return j == 0 ? cls + b * cls_rs : x + (frame_row + j - 1) * x_rs;
}

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

// fp32: delta[i] = sum over the d dims of row i of dO * O (one row = one
// token's head), one thread per (token, head).
__global__ void delta_kernel(const float* __restrict__ dout,
                             const float* __restrict__ out,
                             float* __restrict__ delta, long long n, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* g = dout + i * d;
  const float* o = out + i * d;
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(g[c], o[c], s);
  delta[i] = s;
}

size_t dq_smem_bytes(int d) {
  // K and V tiles [64][d+1]; the block's scaled queries and dO rows
  // [64][d]; dS per warp
  return ((size_t)2 * kTile * (d + 1) + (size_t)2 * kTile * d +
          (size_t)kWarps * kTile) *
         sizeof(float);
}

// dq: grid (ceil(N/64), H, B*F), kWarps*32 threads; warp w owns query rows
// 8w..8w+7 of the block. fp32 reads delta; bf16 walks the key tiles twice:
// the first sums (and writes) their delta = rowsum(P * dP), the second
// forms dS and dq.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    big_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ ck,
                      const T* __restrict__ cv, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ delta, T* __restrict__ dq,
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
  // padded rows: q = dO = 0, so dP = 0, delta = 0 and dS = 0 there
  float lr[kRowsPerWarp], dr[kRowsPerWarp], acc[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n_base + warp * kRowsPerWarp + r;
    lr[r] = n < N ? lse[(frame_row + n) * H + h] : 0.f;
    dr[r] = kDeltaFromOut<T> && n < N ? delta[(frame_row + n) * H + h] : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int pass = kDeltaFromOut<T> ? 1 : 0; pass < 2; ++pass) {
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
          const float p = kt * kTile + jj < L ? expf(s - lr[r]) : 0.f;
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
      if (n < N && lane == 0) delta[(frame_row + n) * H + h] = dr[r];
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

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* ck, const void* cv, const void* dout,
                       const void* out, const void* lse, void* delta,
                       void* dq, void* dk, void* dv, void* dck, void* dcv,
                       void* part_k, void* part_v, int B, int F, int N, int H,
                       int d, long long q_rs, long long k_rs, long long v_rs,
                       long long ck_rs, long long cv_rs, float scale,
                       cudaStream_t stream) {
  cudaError_t err;
  if constexpr (kDeltaFromOut<T>) {
    const long long rows = (long long)B * F * N * H;
    delta_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
        (const float*)dout, (const float*)out, (float*)delta, rows, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  size_t smem = dq_smem_bytes(d);
  if ((err = allow_smem(big_bwd_dq_kernel<T>, smem)) != cudaSuccess)
    return err;
  big_bwd_dq_kernel<T><<<grid(N, kTile, H, B, F), kWarps * 32, smem,
                          stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (const T*)dout, (const float*)lse, (float*)delta, (T*)dq, F, N, H, d,
      q_rs, k_rs, v_rs, ck_rs, cv_rs, scale);
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

}  // namespace

// Plain C interface, loaded with ctypes; the signatures of
// lavila_divided_space_fwd/_bwd (divided_fwd.cu, divided_bwd.cu). dtype:
// 0 = fp32, 1 = bf16; tc: 1 runs the tensor-core kernels (bf16; refused
// with cudaErrorInvalidValue where lavila::space_tc_fits /
// space_bwd_tc_fits do not hold), 0 the SIMT ones. Scratch the caller
// allocates: for the tensor cores `stats` and part_k/part_v as
// lavila_divided_space_bwd takes them; for SIMT `stats` holds delta, fp32
// (B, F, N, H), and part_k/part_v are fp32 (B, F, D). Returns the
// cudaError_t of the launches (0 on success).
extern "C" {

int lavila_divided_space_big_fwd(const void* q, const void* k, const void* v,
                                 const void* ck, const void* cv, void* out,
                                 void* lse, int B, int F, int N, int H, int d,
                                 long long q_rs, long long k_rs,
                                 long long v_rs, long long ck_rs,
                                 long long cv_rs, float scale, int dtype,
                                 int tc, void* stream) {
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
                                 const void* lse, void* stats, void* dq,
                                 void* dk, void* dv, void* dck, void* dcv,
                                 void* part_k, void* part_v, int B, int F,
                                 int N, int H, int d, long long q_rs,
                                 long long k_rs, long long v_rs,
                                 long long ck_rs, long long cv_rs, float scale,
                                 int dtype, int tc, void* stream) {
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
    return (int)launch_bwd<float>(q, k, v, ck, cv, dout, out, lse, stats, dq,
                                  dk, dv, dck, dcv, part_k, part_v, B, F, N,
                                  H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale,
                                  s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(
        q, k, v, ck, cv, dout, out, lse, stats, dq, dk, dv, dck, dcv, part_k,
        part_v, B, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
