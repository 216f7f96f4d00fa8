// Single-query decode attention over a flat KV cache (K9), for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel lavila_tpu/ops/pallas/decode_attention.py:
// decode_attention_fused (body _kernel): one decoder step of the
// narrator's self-attention. Per batch row b and head h (head_dim 64,
// head h in columns [64h, 64h + 64) of the flat D = H*64 rows):
//
//   s_j   = q . k_cache[b, j] / 8          for the cache positions j < nv
//   s_new = q . k_new[b] / 8               the current token
//   p     = softmax([s_0 .. s_{nv-1}, s_new])   in fp32
//   out   = sum_j p_j v_cache[b, j] + p_new v_new[b]
//
// The probabilities are rounded to the input dtype before p.v, as the
// JAX package rounds them; every sum is fp32 and the output is written
// once in the input dtype. Only the nv valid rows are read: the Pallas
// kernel gives the masked rows exp(-huge) = 0, so skipping them is the
// same function, and nv = 0 (the first step, an empty cache) returns
// v_new exactly. The TPU kernel left the current-token term to XLA
// because Mosaic cannot lower a one-row dot; here it is one more warp
// reduction.
//
// What bounds it on the H100: the call reads 2 * B * nv * D cache
// elements and does ~4 FLOPs per element read (0.5-1 FLOP per byte), far
// below the ~295 FLOPs per byte where the tensor cores would matter, so
// its floor is one read of the valid cache rows at 3.35 TB/s (1.02 MB
// per valid position at B = 160, D = 1600 in bf16). Design for that: one
// warp owns one (row, head), so a launch has B * H warps (4,000 for the
// narrator's 160 rows of GPT-2 XL) to keep loads in flight. Scores: the
// lanes read 16-byte chunks of consecutive keys (a 64-dim bf16 head row
// is 8 chunks, so a warp reads 4 keys per step; fp32: 16 chunks, 2 keys),
// each lane dots its chunk with its slice of q and the chunk sums meet by
// shuffles. The scores sit in the warp's slice of shared memory (nv
// floats). Max, exponentials and their sum are warp reductions over
// them; then each lane owns 2 of the 64 output dims and streams the value
// rows, 128 contiguous bytes per row per warp in bf16. No tensor cores:
// a one-row product has nothing for them to win.

#include <math.h>

#include "common.cuh"

namespace {

using lavila::from_float;
using lavila::to_float;
using lavila::warp_max;
using lavila::warp_sum;

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;  // warps per block, one (row, head) each

// the 16 bytes at p as floats (p 16-byte aligned)
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// two consecutive elements at p as floats (p aligned to two elements)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// grid ceil(B*H / kWarps), kWarps*32 threads, kWarps*max(nv, 1) floats of
// dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const T* __restrict__ kn,
                  const T* __restrict__ vn, T* __restrict__ out, int B,
                  int H, int Kmax, int nv, long long q_rs, long long kn_rs,
                  long long vn_rs, float scale) {
  extern __shared__ float smem[];
  constexpr int E = 16 / sizeof(T);      // elements in a 16-byte chunk
  constexpr int LPK = kHeadDim / E;      // lanes per key row
  constexpr int KPS = 32 / LPK;          // keys per warp step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= B * H) return;  // no block-wide barrier below
  const int b = task / H, h = task - b * H;
  const long long D = (long long)H * kHeadDim;
  float* s = smem + (size_t)warp * (nv > 0 ? nv : 1);

  const T* qrow = q + b * q_rs + h * kHeadDim;
  const T* knrow = kn + b * kn_rs + h * kHeadDim;
  const T* vnrow = vn + b * vn_rs + h * kHeadDim;
  // the current token's score: each lane 2 dims
  float s_new = to_float(qrow[2 * lane]) * to_float(knrow[2 * lane]) +
                to_float(qrow[2 * lane + 1]) * to_float(knrow[2 * lane + 1]);
  s_new = warp_sum(s_new) * scale;

  // cache scores: lane = (key in step) * LPK + chunk
  const int c = lane % LPK, sub = lane / LPK;
  float qc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qc[e] = to_float(qrow[c * E + e]);
  const T* kbase = kc + (long long)b * Kmax * D + h * kHeadDim + c * E;
  for (int j0 = 0; j0 < nv; j0 += KPS) {
    const int j = j0 + sub;
    float part = 0.f;
    if (j < nv) {
      float kf[E];
      load16(kbase + (long long)j * D, kf);
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(qc[e], kf[e], part);
    }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (j < nv && c == 0) s[j] = part * scale;
  }
  __syncwarp();

  // softmax over [s_0 .. s_{nv-1}, s_new] in fp32
  float m = s_new;
  for (int j = lane; j < nv; j += 32) m = fmaxf(m, s[j]);
  m = warp_max(m);
  float z = 0.f;
  for (int j = lane; j < nv; j += 32) {
    const float e = expf(s[j] - m);
    s[j] = e;
    z += e;
  }
  const float e_new = expf(s_new - m);
  z = warp_sum(z) + e_new;
  const float inv = 1.f / z;
  __syncwarp();

  // out = sum_j p_j v_j + p_new v_new; lane owns dims 2*lane, 2*lane + 1
  float a0 = 0.f, a1 = 0.f;
  const T* vbase = vc + (long long)b * Kmax * D + h * kHeadDim + 2 * lane;
#pragma unroll 4
  for (int j = 0; j < nv; ++j) {
    const float p = to_float(from_float<T>(s[j] * inv));
    const float2 v = load2(vbase + (long long)j * D);
    a0 = fmaf(p, v.x, a0);
    a1 = fmaf(p, v.y, a1);
  }
  const float p_new = to_float(from_float<T>(e_new * inv));
  a0 = fmaf(p_new, to_float(vnrow[2 * lane]), a0);
  a1 = fmaf(p_new, to_float(vnrow[2 * lane + 1]), a1);
  T* orow = out + (long long)b * D + h * kHeadDim + 2 * lane;
  orow[0] = from_float<T>(a0);
  orow[1] = from_float<T>(a1);
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* kn, const void* vn, void* out, int B, int H,
                   int Kmax, int nv, long long q_rs, long long kn_rs,
                   long long vn_rs, float scale, cudaStream_t s) {
  const int tasks = B * H;
  const int blocks = (tasks + kWarps - 1) / kWarps;
  const size_t smem = (size_t)kWarps * (nv > 0 ? nv : 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = lavila::allow_smem(decode_kernel<T>, smem);
    if (err != cudaSuccess) return err;
  }
  decode_kernel<T><<<blocks, kWarps * 32, smem, s>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (const T*)kn, (const T*)vn,
      (T*)out, B, H, Kmax, nv, q_rs, kn_rs, vn_rs, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k_new, v_new: (B, D) rows, unit stride inside a row, row strides
// q_rs/kn_rs/vn_rs in elements; k_cache, v_cache: (B, Kmax, D)
// contiguous and 16-byte aligned; out: (B, D) contiguous. D = H * 64.
// dtype 0 = fp32, 1 = bf16.
int lavila_decode_attention(const void* q, const void* k_cache,
                            const void* v_cache, const void* k_new,
                            const void* v_new, void* out, int B, int H,
                            int Kmax, int nv, long long q_rs, long long kn_rs,
                            long long vn_rs, float scale, int dtype,
                            void* stream) {
  if (B < 1 || H < 1 || nv < 0 || nv > Kmax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k_cache, v_cache, k_new, v_new, out, B, H,
                              Kmax, nv, q_rs, kn_rs, vn_rs, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_cache, v_cache, k_new, v_new, out,
                                      B, H, Kmax, nv, q_rs, kn_rs, vn_rs,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
