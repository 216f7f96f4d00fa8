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
// [cls_k; k_{f,1..N}]. One block owns one (clip, frame, head) and stages
// that head's K and V and the CLS row in shared memory once; its warps
// sweep all N queries against them. Two kernels, chosen by what the call
// gives:
//
//  * bf16, head_dim 64, N+1 <= 208 keys (TSF-B: N = 196): tensor cores.
//    With mma.sync (bf16 in, fp32 accumulate) the phase does (N+1)/2 ~ 98
//    FLOPs per byte of q/k/v/out, below the H100's ~295, so its floor is
//    one read of q/k/v and one write of out. K and V^T sit in shared
//    memory as bf16 (~57 KB, so dynamic shared memory above the 48 KB
//    static limit), rows padded by 8 elements so fragment loads hit 32
//    distinct banks. Each warp takes 16 query rows at a time, holds the
//    whole 16 x 208 score tile in registers, takes the softmax there (a
//    row is spread over the 4 lanes of a quad) and reuses the score
//    accumulators, rounded to bf16, as the A operand of P·V, as
//    FlashAttention-2 does: no score or probability touches memory.
//  * everything else (fp32, whose 1e-4 bound rules out bf16 or TF32
//    tensor cores, other head sizes, N up to 256): SIMT fp32 FMA, bound by
//    FMA issue and its ~2 shared-memory loads per FMA. K/V are staged in
//    fp32 (~100 KB at N = 196, dynamic shared memory), rows padded to d+1
//    floats so that lane j reading key row j hits its own bank.
//
// K2, temporal phase: each query at (frame f, position n) attends over the
// F keys at position n plus the CLS key. Only F+1 keys, so the phase is
// bound by reading q/k/v from device memory. One warp owns one
// (clip, position, head); each lane holds d/32 dims, the scores are warp
// reductions and the softmax is online, so F is only bounded by the loop
// (16 frames, the fine-tune clip length, runs the same code as 4).

#include <math.h>

#include "common.cuh"

namespace {

using lavila::from_float;
using lavila::ld32;
using lavila::mma_16816;
using lavila::pack_bf16;
using lavila::quad_max;
using lavila::quad_sum;
using lavila::to_float;
using lavila::warp_max;
using lavila::warp_sum;

constexpr int kWarps = 8;           // warps per block, both kernels
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

// ---- K1, bf16 on the tensor cores -------------------------------------

constexpr int kMmaD = 64;           // head_dim of the tensor-core path
constexpr int kMmaKeyTiles = 26;    // 8-key tiles: N + 1 <= 208 keys
constexpr int kMmaKeys = kMmaKeyTiles * 8;
constexpr int kMmaWarps = 4;
constexpr int kKsStride = kMmaD + 8;    // bf16 per K row in shared memory
constexpr int kVtStride = kMmaKeys + 8; // bf16 per V^T row in shared memory

size_t space_mma_smem_bytes() {
  return ((size_t)kMmaKeys * kKsStride + (size_t)kMmaD * kVtStride) *
         sizeof(__nv_bfloat16);
}

// grid (H, F, B), kMmaWarps*32 threads. Fragment layouts are PTX's for
// m16n8k16: lane = 4*g + t holds rows g and g+8, columns 2t, 2t+1 (+8).
__global__ void __launch_bounds__(kMmaWarps * 32)
    space_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ ck,
                         const __nv_bfloat16* __restrict__ cv,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int F, int N, int H,
                         long long q_rs, long long k_rs, long long v_rs,
                         long long ck_rs, long long cv_rs, float scale) {
  extern __shared__ float smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [key][d]
  __nv_bfloat16* vt = ks + kMmaKeys * kKsStride;               // [d][key]
  const int h = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int L = N + 1;  // key 0 is the CLS token; keys >= L are zero pads
  const long long frame_row = ((long long)b * F + f) * N;
  const int col = h * kMmaD;
  const long long D = (long long)H * kMmaD;

  constexpr int kWords = kMmaD / 2;  // bf16 pairs per row
  for (int i = threadIdx.x; i < kMmaKeys * kWords; i += blockDim.x) {
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
    *reinterpret_cast<unsigned*>(ks + j * kKsStride + 2 * w) = kw;
    const __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(&vw);
    vt[(2 * w) * kVtStride + j] = vv.x;
    vt[(2 * w + 1) * kVtStride + j] = vv.y;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int rt = warp; rt * 16 < N; rt += kMmaWarps) {
    const int n0 = rt * 16 + g, n1 = n0 + 8;  // this lane's two query rows
    const __nv_bfloat16* q0 = q + (frame_row + n0) * q_rs + col + 2 * t;
    const __nv_bfloat16* q1 = q + (frame_row + n1) * q_rs + col + 2 * t;
    unsigned qa[kMmaD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kMmaD / 16; ++kk) {
      qa[kk][0] = n0 < N ? ld32(q0 + kk * 16) : 0u;
      qa[kk][1] = n1 < N ? ld32(q1 + kk * 16) : 0u;
      qa[kk][2] = n0 < N ? ld32(q0 + kk * 16 + 8) : 0u;
      qa[kk][3] = n1 < N ? ld32(q1 + kk * 16 + 8) : 0u;
    }

    // S = Q K^T for 16 rows x kMmaKeys keys, in registers
    float s[kMmaKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kMmaKeyTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + g) * kKsStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kMmaD / 16; ++kk)
        mma_16816(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    // softmax over each row's keys (columns 2t, 2t+1 of every tile)
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kMmaKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = nt * 8 + 2 * t + e < L;
        s[nt][e] = valid ? s[nt][e] * scale : -INFINITY;
        s[nt][2 + e] = valid ? s[nt][2 + e] * scale : -INFINITY;
        m0 = fmaxf(m0, s[nt][e]);
        m1 = fmaxf(m1, s[nt][2 + e]);
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kMmaKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = expf(s[nt][e] - m0);
        s[nt][2 + e] = expf(s[nt][2 + e] - m1);
        l0 += s[nt][e];
        l1 += s[nt][2 + e];
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // O = P V: the score tiles 2kt, 2kt+1 are the A fragment of keys
    // 16kt..16kt+15
    float o[kMmaD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn)
      o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kMmaKeyTiles / 2; ++kt) {
      const unsigned pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                              pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                              pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        const __nv_bfloat16* vr = vt + (dn * 8 + g) * kVtStride + kt * 16 + 2 * t;
        mma_16816(o[dn], pa, ld32(vr), ld32(vr + 8));
      }
    }

    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      const int c = col + dn * 8 + 2 * t;
      if (n0 < N)
        *reinterpret_cast<unsigned*>(out + (frame_row + n0) * D + c) =
            pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
      if (n1 < N)
        *reinterpret_cast<unsigned*>(out + (frame_row + n1) * D + c) =
            pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
    }
    if (t == 0) {
      if (n0 < N) lse[(frame_row + n0) * H + h] = m0 + logf(l0);
      if (n1 < N) lse[(frame_row + n1) * H + h] = m1 + logf(l1);
    }
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
  cudaError_t err = cudaFuncSetAttribute(
      space_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  space_fwd_kernel<T><<<dim3(H, F, B), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)ck, (const T*)cv,
      (T*)out, (float*)lse, F, N, H, d, q_rs, k_rs, v_rs, ck_rs, cv_rs,
      scale);
  return cudaGetLastError();
}

// The tensor-core K1 takes bf16 with head_dim 64, at most 207 patches and
// 4-byte aligned rows (it moves bf16 pairs); everything else takes the
// SIMT kernel.
bool space_mma_fits(const void* q, const void* k, const void* v,
                    const void* ck, const void* cv, int N, int d,
                    long long q_rs, long long k_rs, long long v_rs,
                    long long ck_rs, long long cv_rs) {
  return d == kMmaD && N + 1 <= kMmaKeys &&
         lavila::bf16_pairs_ok({q, k, v, ck, cv},
                               {q_rs, k_rs, v_rs, ck_rs, cv_rs});
}

cudaError_t launch_space_mma(const void* q, const void* k, const void* v,
                             const void* ck, const void* cv, void* out,
                             void* lse, int B, int F, int N, int H,
                             long long q_rs, long long k_rs, long long v_rs,
                             long long ck_rs, long long cv_rs, float scale,
                             cudaStream_t stream) {
  const size_t smem = space_mma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      space_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  space_fwd_mma_kernel<<<dim3(H, F, B), kMmaWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)ck,
      (const __nv_bfloat16*)cv, (__nv_bfloat16*)out, (float*)lse, F, N, H,
      q_rs, k_rs, v_rs, ck_rs, cv_rs, scale);
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

int lavila_divided_space_fwd(const void* q, const void* k, const void* v,
                             const void* ck, const void* cv, void* out,
                             void* lse, int B, int F, int N, int H, int d,
                             long long q_rs, long long k_rs, long long v_rs,
                             long long ck_rs, long long cv_rs, float scale,
                             int dtype, void* stream) {
  if (d < 1 || d > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_space<float>(q, k, v, ck, cv, out, lse, B, F, N, H, d,
                                    q_rs, k_rs, v_rs, ck_rs, cv_rs, scale, s);
  if (dtype == 1 && space_mma_fits(q, k, v, ck, cv, N, d, q_rs, k_rs, v_rs,
                                   ck_rs, cv_rs))
    return (int)launch_space_mma(q, k, v, ck, cv, out, lse, B, F, N, H, q_rs,
                                 k_rs, v_rs, ck_rs, cv_rs, scale, s);
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
