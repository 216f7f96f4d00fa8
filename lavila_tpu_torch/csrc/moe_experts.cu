// The routed expert layer of a mixture-of-experts decoder (the Moonlight
// narrator's layers 1-26: DeepSeek-V3's MoE), for Hopper (sm_90a), bf16.
//
// Replaces no TPU kernel: the JAX package has no mixture-of-experts model.
// It was added with the Moonlight-16B-A3B narrator, whose decode steps
// spend most of their device time here. Per layer and call, T tokens
// x (T, D), E routed experts of a SwiGLU of width I (gate and up rows
// stacked: w1 (E, 2I, D), w2 (E, D, I)) and S shared experts of the same
// shape (w1s (S, 2I, D), w2s (S, D, I)) that every token takes:
//
//   moe_route_kernel    s = sigmoid(x W_r^T) in fp32 (E scores), the top
//                       K of s + bias, weights s_k / sum(s_k) * scale
//   moe_sort_kernel     the T*K routed rows grouped by expert, stable in
//                       token order, then the S shared groups (every
//                       token once each): the source token of every
//                       sorted row, each routed slot's sorted place, and
//                       the groups' offsets, all on the device
//   moe_gemm_kernel     one launch over every group's rows:
//     <gate_up>           h = silu(x W_gate^T) * (x W_up^T)   (N, I)
//     <down>              y = h W_down^T                      (N, D)
//   moe_combine_kernel  out[t] = sum_k w[t,k] y[pos[t,k]] + sum_s y[shared
//                       row of t], in that order, in fp32: no atomics
//
// Nothing here reads a count on the host, and the launches are the same
// five whatever the routing, so a decode step can be captured in a graph.
//
// What bounds it on the H100: at decode (160 tokens x 6 experts at
// Moonlight's D = 2048, I = 1408) an even routing gives every expert
// about 15 rows, so one call reads all of its 66 experts' weights once,
// 1.14 GB, and
// does 2 x 1280 rows x 8.65 M multiply-adds: ~10 operations per byte,
// far below the ~295 where the tensor cores are the limit. The floor is
// the weights' read at 3.35 TB/s (0.34 ms a layer). Design for that: a
// block owns one group and one tile of weight rows (128 rows: 64 gate
// and the 64 matching up rows, or 128 down rows) and walks the whole
// reduction dimension through a 3-stage cp.async ring of 64-wide tiles,
// so every weight byte is read once per 64 rows of its group; the
// group's rows (gathered through the sorted source index, zeros past the
// group's end) ride along in the same ring. A group holds at most T rows
// (a token takes an expert once), so the launch has ceil(T / 64) blocks
// on z for each (tile, group): block z takes the group's 64-row passes z,
// z + splits, ..., and a group longer than one pass (the shared experts
// take all T rows) is spread over blocks, while the others' extra blocks
// return at once. Products on mma.sync
// (m16n8k16, fp32 accumulation); a warp skips the 16-row slices that hold
// no row. Tiles sit in shared memory with rows padded by 8 bf16
// (144 bytes), so the fragment loads hit 32 distinct banks.

#include <math.h>

#include "common.cuh"

namespace {

using lavila::cp_async16;
using lavila::cp_async_commit;
using lavila::mma_16816;
using lavila::pack_bf16;
using lavila::warp_sum;
using bf16 = __nv_bfloat16;

constexpr int kMaxExperts = 64;  // routed experts a route/sort call takes
constexpr int kMaxTopK = 8;
constexpr int kMaxD = 2048;      // the router's width (x in registers)

// ---- routing: one warp a token

__global__ void __launch_bounds__(128)
    moe_route_kernel(const bf16* __restrict__ x, long long x_rs,
                     const bf16* __restrict__ w, const bf16* __restrict__ bias,
                     int T, int D, int E, int K, float scale,
                     int* __restrict__ idx, float* __restrict__ wts) {
  const int lane = threadIdx.x & 31;
  const int token = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (token >= T) return;
  // this lane's elements: the 16-byte chunks lane + 32 i
  const int chunks = D / 256;
  float xf[kMaxD / 256][8];
  const bf16* xr = x + token * x_rs;
#pragma unroll
  for (int i = 0; i < kMaxD / 256; ++i) {
    if (i < chunks) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(xr + (lane + 32 * i) * 8);
      const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = lavila::unpack_bf16(u[j]);
        xf[i][2 * j] = f.x;
        xf[i][2 * j + 1] = f.y;
      }
    }
  }
  // the scores of experts lane and lane + 32
  float s0 = 0.f, s1 = 0.f;
  for (int e = 0; e < E; ++e) {
    const bf16* wr = w + (long long)e * D;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 256; ++i) {
      if (i < chunks) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(wr + (lane + 32 * i) * 8);
        const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = lavila::unpack_bf16(u[j]);
          acc = fmaf(xf[i][2 * j], f.x, acc);
          acc = fmaf(xf[i][2 * j + 1], f.y, acc);
        }
      }
    }
    acc = warp_sum(acc);
    const float sig = 1.f / (1.f + expf(-acc));
    if (e == lane) s0 = sig;
    if (e == lane + 32) s1 = sig;
  }
  const float ninf = -INFINITY;
  float z0 = lane < E ? s0 + __bfloat162float(bias[lane]) : ninf;
  float z1 = lane + 32 < E ? s1 + __bfloat162float(bias[lane + 32]) : ninf;
  int picked[kMaxTopK];
  float score[kMaxTopK];
  float total = 0.f;
  for (int k = 0; k < K; ++k) {
    // the best unchosen expert; a tie goes to the lower index
    float bz = z0;
    int be = lane;
    if (z1 > bz) {
      bz = z1;
      be = lane + 32;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float oz = __shfl_xor_sync(0xffffffffu, bz, o);
      const int oe = __shfl_xor_sync(0xffffffffu, be, o);
      if (oz > bz || (oz == bz && oe < be)) {
        bz = oz;
        be = oe;
      }
    }
    const float mine = be < 32 ? s0 : s1;
    const float s = __shfl_sync(0xffffffffu, mine, be & 31);
    if (be == lane) z0 = ninf;
    if (be == lane + 32) z1 = ninf;
    picked[k < kMaxTopK ? k : 0] = be;
    score[k < kMaxTopK ? k : 0] = s;
    total += s;
  }
  if (lane == 0) {
    const float mul = scale / total;
    for (int k = 0; k < K; ++k) {
      idx[token * K + k] = picked[k];
      wts[token * K + k] = score[k] * mul;
    }
  }
}

// ---- the sort: one block of 1024 threads, stable counting sort

__global__ void __launch_bounds__(1024)
    moe_sort_kernel(const int* __restrict__ idx, int T, int K, int E, int S,
                    int* __restrict__ src, int* __restrict__ pos,
                    int* __restrict__ offsets) {
  __shared__ int count[kMaxExperts];
  __shared__ int base[kMaxExperts];
  __shared__ int chunk_total[kMaxExperts];
  __shared__ int warp_hist[32][kMaxExperts];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = T * K;
  for (int e = tid; e < E; e += blockDim.x) count[e] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) atomicAdd(&count[idx[i]], 1);
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int e = 0; e < E; ++e) {
      base[e] = run;
      offsets[e] = run;
      run += count[e];
    }
    for (int s = 0; s <= S; ++s) offsets[E + s] = n + s * T;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int chunk = 0; chunk < n; chunk += blockDim.x) {
    const int i = chunk + tid;
    const bool valid = i < n;
    const int e = valid ? idx[i] : kMaxExperts;
    for (int j = lane; j < E; j += 32) warp_hist[warp][j] = 0;
    __syncwarp();
    const unsigned same = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(same & below);
    if (valid && rank == 0) warp_hist[warp][e] = __popc(same);
    __syncthreads();
    if (tid < E) {
      int run = 0;
      for (int w = 0; w < 32; ++w) {
        const int c = warp_hist[w][tid];
        warp_hist[w][tid] = run;
        run += c;
      }
      chunk_total[tid] = run;
    }
    __syncthreads();
    if (valid) {
      const int p = base[e] + warp_hist[warp][e] + rank;
      src[p] = i / K;
      pos[i] = p;
    }
    __syncthreads();
    if (tid < E) base[tid] += chunk_total[tid];
    __syncthreads();
  }
  for (int r = tid; r < S * T; r += blockDim.x) src[n + r] = r % T;
}

// ---- the grouped products

constexpr int kBM = 64;            // rows a pass
constexpr int kBK = 64;            // reduction tile
constexpr int kBW = 128;           // weight rows a block
constexpr int kRow = kBK + 8;      // bf16 per padded smem row
constexpr int kStages = 3;
constexpr int kStageElems = (kBM + kBW) * kRow;
constexpr int kSmemBytes = kStages * kStageElems * 2;

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// kGateUp: A rows are x rows gathered through src, the block's weight
// rows are 64 gate rows (j0 + r) and the matching 64 up rows (I + j0 + r),
// out = h (N, I). Otherwise A rows are h's sorted rows as they lie, the
// weight rows are d0 + r, out = y (N, D). K is the reduction width, wrow
// the output width (I or D), w_stride the elements of one expert's
// weights.
template <bool kGateUp>
__global__ void __launch_bounds__(128)
    moe_gemm_kernel(const bf16* __restrict__ a, long long a_rs,
                    const int* __restrict__ src,
                    const int* __restrict__ offsets,
                    const bf16* __restrict__ w, const bf16* __restrict__ ws,
                    int E, int K, int wrow, long long w_stride,
                    bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int g = blockIdx.y;
  const int begin = offsets[g], end = offsets[g + 1];
  if (begin >= end) return;
  const bf16* wg = g < E ? w + g * w_stride : ws + (g - E) * w_stride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * (kGateUp ? kBW / 2 : kBW);
  // the global weight row of tile row r
  auto weight_row = [&](int r) -> const bf16* {
    const int row = kGateUp ? (r < kBW / 2 ? n0 + r : wrow + n0 + r - kBW / 2)
                            : n0 + r;
    return wg + (long long)row * K;
  };
  // this warp's two 16-row slices of the weight tile
  const int wb0 = kGateUp ? 16 * warp : 32 * warp;
  const int wb1 = kGateUp ? kBW / 2 + 16 * warp : 32 * warp + 16;
  const int nk = K / kBK;

  for (int row0 = begin + blockIdx.z * kBM; row0 < end;
       row0 += gridDim.z * kBM) {
    const int rows = min(kBM, end - row0);
    auto load = [&](int kt) {
      bf16* sa = smem + (kt % kStages) * kStageElems;
      bf16* sb = sa + kBM * kRow;
      const int k0 = kt * kBK;
#pragma unroll
      for (int i = 0; i < kBM * 8 / 128; ++i) {
        const int c = tid + 128 * i, r = c >> 3, ch = c & 7;
        const bool ok = r < rows;
        const long long ar = ok ? (kGateUp ? src[row0 + r] : row0 + r) : 0;
        cp_async16(sa + r * kRow + ch * 8, a + ar * a_rs + k0 + ch * 8, ok);
      }
#pragma unroll
      for (int i = 0; i < kBW * 8 / 128; ++i) {
        const int c = tid + 128 * i, r = c >> 3, ch = c & 7;
        cp_async16(sb + r * kRow + ch * 8, weight_row(r) + k0 + ch * 8, true);
      }
    };
    float acc[4][4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (kt + kStages - 1 < nk) load(kt + kStages - 1);
      cp_async_commit();
      const bf16* sa = smem + (kt % kStages) * kStageElems;
      const bf16* sb = sa + kBM * kRow;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // B fragments: n8 tiles 0, 1 from rows wb0.., tiles 2, 3 from wb1..
        unsigned b0[4], b1[4];
        const int br = (lane & 7) + ((lane >> 4) << 3);
        const int bc = kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(b0, sb + (wb0 + br) * kRow + bc);
        ldsm_x4(b1, sb + (wb1 + br) * kRow + bc);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (16 * m < rows) {
            unsigned af[4];
            ldsm_x4(af, sa + (16 * m + (lane & 15)) * kRow + kk * 16 +
                            (lane >> 4) * 8);
            mma_16816(acc[m][0], af, b0[0], b0[1]);
            mma_16816(acc[m][1], af, b0[2], b0[3]);
            mma_16816(acc[m][2], af, b1[0], b1[1]);
            mma_16816(acc[m][3], af, b1[2], b1[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next pass
    const int gi = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (16 * m >= rows) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * m + gi + 8 * half;
        if (r >= rows) continue;
        bf16* o = out + (long long)(row0 + r) * wrow;
        if (kGateUp) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float g0 = acc[m][nt][2 * half],
                        g1 = acc[m][nt][2 * half + 1];
            const float u0 = acc[m][nt + 2][2 * half],
                        u1 = acc[m][nt + 2][2 * half + 1];
            const int col = n0 + 16 * warp + 8 * nt + 2 * t;
            *reinterpret_cast<unsigned*>(o + col) =
                pack_bf16(g0 / (1.f + expf(-g0)) * u0,
                          g1 / (1.f + expf(-g1)) * u1);
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + 32 * warp + 8 * nt + 2 * t;
            *reinterpret_cast<unsigned*>(o + col) =
                pack_bf16(acc[m][nt][2 * half], acc[m][nt][2 * half + 1]);
          }
        }
      }
    }
  }
}

// ---- the combine: a block a token, 8 elements a thread and step

__global__ void __launch_bounds__(256)
    moe_combine_kernel(const bf16* __restrict__ y, const int* __restrict__ pos,
                       const float* __restrict__ wts, int T, int K, int S,
                       int D, bf16* __restrict__ out) {
  const int t = blockIdx.x;
  const long long n = (long long)T * K;
  for (int c = threadIdx.x; c < D / 8; c += blockDim.x) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < K + S; ++j) {
      const long long row =
          j < K ? pos[t * K + j] : n + (long long)(j - K) * T + t;
      const float wj = j < K ? wts[t * K + j] : 1.f;
      const uint4 v = *reinterpret_cast<const uint4*>(y + row * D + c * 8);
      const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = lavila::unpack_bf16(u[q]);
        acc[2 * q] = j < K ? fmaf(wj, f.x, acc[2 * q]) : acc[2 * q] + f.x;
        acc[2 * q + 1] =
            j < K ? fmaf(wj, f.y, acc[2 * q + 1]) : acc[2 * q + 1] + f.y;
      }
    }
    uint4 o;
    o.x = pack_bf16(acc[0], acc[1]);
    o.y = pack_bf16(acc[2], acc[3]);
    o.z = pack_bf16(acc[4], acc[5]);
    o.w = pack_bf16(acc[6], acc[7]);
    *reinterpret_cast<uint4*>(out + (long long)t * D + c * 8) = o;
  }
}

}  // namespace

extern "C" {

// x: (T, D) bf16 rows of stride x_rs (elements), 16-byte aligned; w (E,
// D), bias (E,) bf16 contiguous; idx (T, K) int32, wts (T, K) fp32 out.
// D a multiple of 256 up to 2048, E <= 64, K <= 8.
int lavila_moe_route(const void* x, long long x_rs, const void* w,
                     const void* bias, void* idx, void* wts, int T, int D,
                     int E, int K, float scale, void* stream) {
  if (T < 1 || D % 256 || D > kMaxD || E < K || E > kMaxExperts || K < 1 ||
      K > kMaxTopK)
    return (int)cudaErrorInvalidValue;
  moe_route_kernel<<<(T + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, x_rs, (const bf16*)w, (const bf16*)bias, T, D, E, K,
      scale, (int*)idx, (float*)wts);
  return (int)cudaGetLastError();
}

// idx (T, K) int32 in [0, E); src (T*K + S*T), pos (T, K), offsets
// (E + S + 1) int32 out.
int lavila_moe_sort(const void* idx, void* src, void* pos, void* offsets,
                    int T, int K, int E, int S, void* stream) {
  if (T < 1 || K < 1 || E < 1 || E > kMaxExperts || S < 0)
    return (int)cudaErrorInvalidValue;
  moe_sort_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (const int*)idx, T, K, E, S, (int*)src, (int*)pos, (int*)offsets);
  return (int)cudaGetLastError();
}

// gate_up: x (T, D) rows of stride x_rs, w1 (E, 2I, D), w1s (S, 2I, D),
// h (N, I) out; down: h (N, I), w2 (E, D, I), w2s (S, D, I), y (N, D) out.
// I a multiple of 64, D of 128, both of 64 (the reduction tile); T the
// tokens (a group's most rows).
static inline int splits(int T) { return (T + kBM - 1) / kBM; }

int lavila_moe_gate_up(const void* x, long long x_rs, const void* src,
                       const void* offsets, const void* w1, const void* w1s,
                       void* h, int E, int S, int D, int I, int T,
                       void* stream) {
  if (E < 1 || S < 0 || T < 1 || D % kBK || I % (kBW / 2))
    return (int)cudaErrorInvalidValue;
  auto kernel = moe_gemm_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(I / (kBW / 2), E + S, splits(T)), 128, kSmemBytes,
           (cudaStream_t)stream>>>(
      (const bf16*)x, x_rs, (const int*)src, (const int*)offsets,
      (const bf16*)w1, (const bf16*)w1s, E, D, I, 2LL * I * D, (bf16*)h);
  return (int)cudaGetLastError();
}

int lavila_moe_down(const void* h, const void* offsets, const void* w2,
                    const void* w2s, void* y, int E, int S, int D, int I,
                    int T, void* stream) {
  if (E < 1 || S < 0 || T < 1 || I % kBK || D % kBW)
    return (int)cudaErrorInvalidValue;
  auto kernel = moe_gemm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(D / kBW, E + S, splits(T)), 128, kSmemBytes,
           (cudaStream_t)stream>>>(
      (const bf16*)h, (long long)I, nullptr, (const int*)offsets,
      (const bf16*)w2, (const bf16*)w2s, E, I, D, (long long)D * I, (bf16*)y);
  return (int)cudaGetLastError();
}

// y (T*K + S*T, D) bf16, pos (T, K) int32, wts (T, K) fp32; out (T, D)
// bf16. D a multiple of 8.
int lavila_moe_combine(const void* y, const void* pos, const void* wts,
                       void* out, int T, int K, int S, int D, void* stream) {
  if (T < 1 || K < 1 || S < 0 || D % 8) return (int)cudaErrorInvalidValue;
  const int threads = D / 8 < 256 ? (D / 8 + 31) / 32 * 32 : 256;
  moe_combine_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)y, (const int*)pos, (const float*)wts, T, K, S, D,
      (bf16*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
