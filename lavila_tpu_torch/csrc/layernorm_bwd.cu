// LayerNorm backward for Hopper (sm_90a): K3, K4 and K5 backward in one
// persistent kernel.
//
// Replaces the Pallas kernel lavila_tpu/ops/pallas/layernorm.py:
// _bwd_kernel (:82), in its three instantiations: K3 (fused_layernorm's
// VJP, x read), K4 (_add_vjp_bwd :243, has_dsum: x is the saved sum and
// the sum's own gradient d(sum) is added into dx) and K5 (_addns_vjp_bwd
// :273, two_inputs: x = a + b re-added in fp32). Per row of D columns,
// with g = dy * gamma and fp32 one-pass statistics recomputed from x
// (max(E[x^2] - E[x]^2, 0), then rsqrt with eps; nothing was saved):
//
//   dx     = rstd * (g - mean(g) - xhat * mean(g * xhat))  [+ d(sum)]
//   dgamma = sum over rows of dy * xhat,   dbeta = sum over rows of dy
//
// dx in x's dtype (fp32 or bf16); dgamma/dbeta in gamma's dtype, which is
// independent of the rows' (the bf16 train step hands bf16 rows with fp32
// gamma).
//
// What bounds it on the H100: about 20 fp32 operations per element read,
// against ~295 FLOPs per byte where the card turns compute-bound, so
// bytes: K3 reads x and dy and writes dx, 3 * R * D * itemsize; K4 reads
// the sum, dy and d(sum), K5 a, b and dy, and both write dx, 4 * R * D *
// itemsize; plus gamma and the dgamma/dbeta partials (2 * D fp32 a block,
// written once and read once, in L2). TSF-B's (6272, 768) bf16 rows are
// 28.9 MB for K3, 8.6 us at 3.35 TB/s; TSF-L@336's (18432, 1024) K4/K5
// 151 MB, 45 us.
//
// What the design does about it:
//
// * One warp per row, no block barrier per row. Lane l owns the row's
//   16-byte chunks l, l + 32, ... (24 bf16 values at D = 768, 32 at
//   1024, no lane padded to a power of two); the row's sums, mean(g) and
//   mean(g * xhat) are warp shuffles. Each lane keeps fp32 dgamma/dbeta
//   accumulators for its columns across its warp's rows, and nothing
//   else across rows: x, dy (and the residual, d(sum)) are read again
//   from shared memory in each of the three passes (statistics; g and the
//   accumulators; dx), which keeps a lane at 111-128 registers at D =
//   768-1024 in bf16 and two blocks of 8 warps on an SM.
// * Rows in flight. Each warp keeps a ring of two of its next rows'
//   inputs in shared memory, filled by 1-D bulk async copies
//   (cp.async.bulk, one per tensor) that complete on the slot's mbarrier;
//   lane 0 issues the first rows before gamma is staged and refills a
//   slot once the warp has read it for the last time. Two slots a warp
//   and 8 warps a block timed best against 4 slots and 4- or 2-warp
//   blocks (PERF.md, PR 10): at (6272, 768) bf16, 16 warps
//   an SM x 2 slots x 3 KB = 96 KB asked for at once, every row of the
//   call; at (18432, 1024) K4/K5 16 warps x 2 slots x 6 KB = 192 KB.
//   Little's law at 3.35 TB/s and ~1 us asks for ~25 KB an SM. dx goes
//   out by 16-byte stores from registers.
// * Persistent grid: blocks of 8 warps (4 where two slots of a large
//   row do not fit 8), as many as are resident at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, from the
//   wrapper) and no more, each over a contiguous run of at least a row a
//   warp, its warps interleaved over the run.
// * dgamma/dbeta inside the launch, in a fixed order: each warp writes
//   its accumulators into its own row of the freed ring, and a thread a
//   column adds the rows in warp order (independent loads: a sum carried
//   warp by warp through shared memory made a dependent load-add-store
//   chain that cost more than the rows themselves at small calls); the
//   block writes one fp32 partial row of 2 * D; one grid-wide barrier (a
//   cooperative launch: every block is resident by construction); then
//   each block sums its 8-column groups over all partial rows, 32
//   readers a block (partials p = q, q + 32, ... each in order, then the
//   readers in order), and writes dgamma/dbeta in gamma's dtype. No
//   atomics on values: two calls give the same bits. The barrier timed
//   cheaper than a second launch for the column sums (PERF.md, PR 10).
// * Small calls (every row in one block's ring at once: CLS rows up to
//   16, one row): one block, no partials, no barrier, one launch.
// * Rows whose bytes are not a multiple of 16 or not 16-byte aligned take
//   the scalar variant of the same kernel: a lane owns columns l, l + 32,
//   ... and reads them from device memory, no ring.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using lavila::from_float;
using lavila::pack_bf16;
using lavila::to_float;
using lavila::unpack_bf16;
using lavila::warp_sum;
using lavila::sm90::bulk_load;
using lavila::sm90::mbar_expect_tx;
using lavila::sm90::mbar_fence_init;
using lavila::sm90::mbar_init;
using lavila::sm90::mbar_wait;

constexpr int kMaxWarps = 8;
constexpr int kSlots = 2;  // rows a warp's ring holds
constexpr int kSumCols = 8;  // columns of a group in the column sums
constexpr size_t kMaxSmem = 232448;  // 227 KB a block

struct Args {
  const void* x;   // (R, D): K3's x, K4's saved sum, K5's a
  const void* r;   // K5's b, else null
  const void* w;   // (D,) gamma
  const void* dy;  // (R, D)
  const void* ds;  // K4's d(sum), else null
  void* dx;        // (R, D), x's dtype
  void* dwb;       // (2, D): dgamma then dbeta, gamma's dtype
  float* part;     // (grid, 2, D) fp32 partials; null for one block
  long long R;
  int D, rows_per_block;
  float eps;
  int w_bf16;  // gamma (and dgamma/dbeta) in bf16
};

__host__ __device__ constexpr size_t pad16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Dynamic shared memory of a block (kernels/layernorm.py:bwd_smem mirrors
// it): gamma in fp32; for the vector path an mbarrier a ring slot; then
// each warp's ring of kSlots rows of `nt` tensors, which after the rows
// holds each warp's dgamma/dbeta row (2 * D floats; also the column sums'
// 32 floats a warp).
__host__ __device__ constexpr size_t sums_bytes(int D, int warps) {
  return 4 * (size_t)warps * (2 * D > 32 ? 2 * D : 32);
}

__host__ __device__ size_t smem_bytes(int D, int itemsize, int nt, int warps,
                                      bool vec) {
  const size_t ring = vec ? (size_t)warps * kSlots * nt * D * itemsize : 0;
  const size_t sums = sums_bytes(D, warps);
  return pad16(4 * (size_t)D) + (vec ? pad16(8 * (size_t)warps * kSlots) : 0) +
         (ring > sums ? ring : sums);
}

// EPC elements of a row at p as floats: one 16-byte load (the vector
// path) or one element (the scalar one)
template <typename T, int EPC>
__device__ __forceinline__ void load_chunk(const T* p, float (&f)[EPC]) {
  static_assert(EPC == 1 || EPC * sizeof(T) == 16, "16-byte chunks");
  if constexpr (EPC == 1) {
    f[0] = to_float(p[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = unpack_bf16(u[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

template <typename T, int EPC>
__device__ __forceinline__ void store_chunk(T* p, const float (&f)[EPC]) {
  if constexpr (EPC == 1) {
    p[0] = from_float<T>(f[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                   pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
}

// gamma's EPC fp32 values at p (shared memory, 16-byte aligned)
template <int EPC>
__device__ __forceinline__ void load_gamma(const float* p, float (&f)[EPC]) {
  if constexpr (EPC == 1) {
    f[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < EPC; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x;
      f[i + 1] = v.y;
      f[i + 2] = v.z;
      f[i + 3] = v.w;
    }
  }
}

// gamma (D values, fp32 or bf16) into shared memory as fp32 by the
// block's threads: 16-byte loads where gamma is whole aligned chunks (one
// load a thread at D <= 1024 fp32, 2048 bf16), so that the stage costs
// one load's latency
__device__ __forceinline__ void stage_gamma(const void* w, int bf16, int D,
                                            float* w32) {
  const bool chunks = (D * (bf16 ? 2 : 4)) % 16 == 0 &&
                      !((unsigned long long)w & 15ull);
  if (chunks && bf16) {
    for (int c = threadIdx.x; c < D / 8; c += blockDim.x) {
      float f[8];
      load_chunk<__nv_bfloat16, 8>(
          static_cast<const __nv_bfloat16*>(w) + c * 8, f);
      for (int e = 0; e < 8; ++e) w32[c * 8 + e] = f[e];
    }
  } else if (chunks) {
    for (int c = threadIdx.x; c < D / 4; c += blockDim.x)
      *reinterpret_cast<float4*>(w32 + c * 4) =
          reinterpret_cast<const float4*>(w)[c];
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      w32[i] = bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i])
                    : static_cast<const float*>(w)[i];
  }
}

__device__ __forceinline__ void store_weight(void* out, int i, float v,
                                             int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

// out[i] = sum over w < warps of sums[w * 2D + i] for i < 2D, each column
// by one thread, 4 columns at a time where D is even: into `part` (fp32)
// when it is not null, else into `dwb` in gamma's dtype
__device__ __forceinline__ void block_sums(const float* sums, int warps, int D,
                                           float* part, void* dwb,
                                           int w_bf16) {
  const int n = 2 * D;
  if (D % 2) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kMaxWarps; ++w)
        if (w < warps) t += sums[(size_t)w * n + i];
      if (part)
        part[i] = t;
      else
        store_weight(dwb, i, t, w_bf16);
    }
    return;
  }
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {  // every warp's load at once
      if (w < warps) {
        const float4 v =
            *reinterpret_cast<const float4*>(sums + (size_t)w * n + i);
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
    }
    if (part) {
      *reinterpret_cast<float4*>(part + i) = t;
    } else if (w_bf16) {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(dwb) + i) =
          make_uint2(pack_bf16(t.x, t.y), pack_bf16(t.z, t.w));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(dwb) + i) = t;
    }
  }
}

// out[c] = sum over p < P of part[p * cols + c], for the 8-column groups
// g = block, block + nblocks, ...: a warp's lanes are 4 readers x 8
// columns; reader q (of 4 * warps) adds the partials p = q, q + 4 * warps,
// ... in order, then the readers' sums are added in reader order.
// `red` holds 32 floats a warp. Every thread of the block calls it.
__device__ void column_sums(const float* __restrict__ part, int P, int cols,
                            void* out, int out_bf16, float* red, int block,
                            int nblocks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, readers = 4 * warps;
  const int q = warp * 4 + lane / kSumCols;
  for (int g = block; g * kSumCols < cols; g += nblocks) {
    const int c = g * kSumCols + lane % kSumCols;
    float s = 0.f;
    if (c < cols) {
#pragma unroll 8
      for (int p = q; p < P; p += readers) s += part[(size_t)p * cols + c];
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < kSumCols && c < cols) {
      float t = 0.f;
      for (int i = 0; i < readers; ++i) t += red[i * kSumCols + threadIdx.x];
      store_weight(out, c, t, out_bf16);
    }
    __syncthreads();
  }
}

// NC: chunks a lane may own (the row's chunk count rounded up to 32 x a
// bucket); EPC: elements a chunk (16 bytes, or 1 for the scalar variant)
template <typename T, int NC, int EPC, bool RES, bool DSUM>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ln_bwd_kernel(const Args a) {
  constexpr bool kVec = EPC > 1;
  constexpr int kNT = 2 + RES + DSUM;  // row tensors read
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D;
  constexpr int S = kSlots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int C = D / EPC;  // chunks a row
  float* w32 = reinterpret_cast<float*>(smem);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      smem + pad16(4 * (size_t)D));
  // the scalar variant has no barriers and no ring
  T* ring = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(bars) +
                                 (kVec ? pad16(8 * (size_t)warps * S) : 0));
  float* sums = reinterpret_cast<float*>(ring);  // once the rows are done

  // this block's rows: rows_per_block from `first` (the last block
  // fewer); warp w takes first + w, first + w + warps, ...
  const long long first = (long long)blockIdx.x * a.rows_per_block;
  const long long left = a.R - first;
  const int span =
      (left < a.rows_per_block ? (int)left : a.rows_per_block) - warp;
  const int n = span > 0 ? (span + warps - 1) / warps : 0;
  const T* src[kNT];
  {
    int t = 0;
    src[t++] = static_cast<const T*>(a.x);
    if constexpr (RES) src[t++] = static_cast<const T*>(a.r);
    src[t++] = static_cast<const T*>(a.dy);
    if constexpr (DSUM) src[t++] = static_cast<const T*>(a.ds);
  }
  T* wring = ring + (size_t)warp * S * kNT * D;
  unsigned long long* wbar = bars + warp * S;
  const unsigned row_bytes = (unsigned)(D * sizeof(T));
  // lane 0: the warp's k-th row into slot k % S
  auto issue = [&](int k) {
    const long long row = first + warp + (long long)k * warps;
    const int s = k % S;
    mbar_expect_tx(&wbar[s], kNT * row_bytes);
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      bulk_load(wring + ((size_t)s * kNT + t) * D, src[t] + row * D,
                row_bytes, &wbar[s]);
  };
  // the first rows' copies go out before gamma is staged (the barriers
  // are the warp's own: no block barrier between)
  if constexpr (kVec) {
    if (lane == 0) {
      for (int s = 0; s < S; ++s) mbar_init(&wbar[s], 1);
      mbar_fence_init();
      for (int k = 0; k < n && k < S; ++k) issue(k);
    }
  }
  stage_gamma(a.w, a.w_bf16, D, w32);
  __syncthreads();  // gamma staged

  float dw[NC][EPC], db[NC][EPC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < EPC; ++e) dw[j][e] = db[j][e] = 0.f;
  const float inv_d = 1.f / (float)D;

  for (int k = 0; k < n; ++k) {
    const long long row = first + warp + (long long)k * warps;
    const T* in[kNT];
    size_t off;  // the chunks' element offset from in[t]
    if constexpr (kVec) {
      const int s = k % S;
      mbar_wait(&wbar[s], (unsigned)(k / S) & 1u);
#pragma unroll
      for (int t = 0; t < kNT; ++t) in[t] = wring + ((size_t)s * kNT + t) * D;
      off = 0;
    } else {
#pragma unroll
      for (int t = 0; t < kNT; ++t) in[t] = src[t];
      off = (size_t)row * D;
    }
    const T* px = in[0] + off;
    const T* pr = in[RES ? 1 : 0] + off;
    const T* pdy = in[1 + RES] + off;
    const T* pds = in[kNT - 1] + off;
    // x (K5: a + b) of chunk c, in fp32
    auto load_x = [&](int c, float(&xv)[EPC]) {
      load_chunk<T, EPC>(px + c * EPC, xv);
      if constexpr (RES) {
        float rv[EPC];
        load_chunk<T, EPC>(pr + c * EPC, rv);
#pragma unroll
        for (int e = 0; e < EPC; ++e) xv[e] += rv[e];
      }
    };

    // statistics; each sum a partial a chunk (short dependency chains),
    // added in chunk order
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        float xv[EPC], p1 = 0.f, p2 = 0.f;
        load_x(c, xv);
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          p1 += xv[e];
          p2 = fmaf(xv[e], xv[e], p2);
        }
        s1 += p1;
        s2 += p2;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mean = s1 * inv_d;
    const float rstd = rsqrtf(fmaxf(s2 * inv_d - mean * mean, 0.f) + a.eps);
    const float shift = -mean * rstd;  // xhat = x * rstd + shift

    // g = dy * gamma: mean(g), mean(g * xhat); dgamma, dbeta
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        float xv[EPC], dv[EPC], wv[EPC], pg = 0.f, pgx = 0.f;
        load_x(c, xv);
        load_chunk<T, EPC>(pdy + c * EPC, dv);
        load_gamma<EPC>(w32 + c * EPC, wv);
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          const float xh = fmaf(xv[e], rstd, shift);
          const float g = dv[e] * wv[e];
          pg += g;
          pgx = fmaf(g, xh, pgx);
          dw[j][e] = fmaf(dv[e], xh, dw[j][e]);
          db[j][e] += dv[e];
        }
        sg += pg;
        sgx += pgx;
      }
    }
    sg = warp_sum(sg) * inv_d;
    sgx = warp_sum(sgx) * inv_d;

    // dx
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        float xv[EPC], dv[EPC], wv[EPC], out[EPC];
        load_x(c, xv);
        load_chunk<T, EPC>(pdy + c * EPC, dv);
        load_gamma<EPC>(w32 + c * EPC, wv);
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          const float xh = fmaf(xv[e], rstd, shift);
          out[e] = rstd * (dv[e] * wv[e] - sg - xh * sgx);
        }
        if constexpr (DSUM) {
          float sv[EPC];
          load_chunk<T, EPC>(pds + c * EPC, sv);
#pragma unroll
          for (int e = 0; e < EPC; ++e) out[e] += sv[e];
        }
        store_chunk<T, EPC>(static_cast<T*>(a.dx) + (size_t)row * D + c * EPC,
                            out);
      }
    }
    if constexpr (kVec) {
      __syncwarp();  // every lane has read the slot
      if (lane == 0 && k + S < n) issue(k + S);
    }
  }

  // the block's dgamma/dbeta: each warp's row into `sums` (the ring, free
  // once every warp is done; 16-byte stores, as scalar ones 32 bytes apart
  // would meet 8 to a bank), then added in warp order, each column by one
  // thread
  __syncthreads();
  float* wsum = sums + (size_t)warp * 2 * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c < C) {
      if constexpr (EPC == 1) {
        wsum[c] = dw[j][0];
        wsum[D + c] = db[j][0];
      } else {
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          *reinterpret_cast<float4*>(wsum + c * EPC + e) =
              make_float4(dw[j][e], dw[j][e + 1], dw[j][e + 2], dw[j][e + 3]);
          *reinterpret_cast<float4*>(wsum + D + c * EPC + e) =
              make_float4(db[j][e], db[j][e + 1], db[j][e + 2], db[j][e + 3]);
        }
      }
    }
  }
  __syncthreads();
  float* mine = gridDim.x == 1 ? nullptr : a.part + (size_t)blockIdx.x * 2 * D;
  block_sums(sums, warps, D, mine, a.dwb, a.w_bf16);
  if (!mine) return;
  __syncthreads();  // `sums` is read; the column sums reuse it
  cg::this_grid().sync();
  column_sums(a.part, gridDim.x, 2 * D, a.dwb, a.w_bf16, sums, blockIdx.x,
              gridDim.x);
}

using KernelFn = void (*)(const Args);

template <typename T, bool RES, bool DSUM>
KernelFn pick(int vec, int nc) {
  constexpr int E = 16 / sizeof(T);
  if (vec) switch (nc) {
      case 1: return ln_bwd_kernel<T, 1, E, RES, DSUM>;
      case 2: return ln_bwd_kernel<T, 2, E, RES, DSUM>;
      case 3: return ln_bwd_kernel<T, 3, E, RES, DSUM>;
      case 4: return ln_bwd_kernel<T, 4, E, RES, DSUM>;
      case 6: return ln_bwd_kernel<T, 6, E, RES, DSUM>;
      case 8: return ln_bwd_kernel<T, 8, E, RES, DSUM>;
      case 16: return ln_bwd_kernel<T, 16, E, RES, DSUM>;
      default: return nullptr;
    }
  switch (nc) {
    case 8: return ln_bwd_kernel<T, 8, 1, RES, DSUM>;
    case 32: return ln_bwd_kernel<T, 32, 1, RES, DSUM>;
    default: return nullptr;
  }
}

template <typename T>
KernelFn pick_mode(int has_res, int has_dsum, int vec, int nc) {
  if (has_res && has_dsum) return nullptr;
  if (has_res) return pick<T, true, false>(vec, nc);
  if (has_dsum) return pick<T, false, true>(vec, nc);
  return pick<T, false, false>(vec, nc);
}

// the kernel for a shape, with the dynamic shared memory it needs; null
// for a shape it does not take
KernelFn kernel_for(int D, int dtype, int has_res, int has_dsum, int vec,
                    int nc, int warps, size_t* smem) {
  if (D < 1 || warps < 1 || warps > kMaxWarps || (dtype != 0 && dtype != 1))
    return nullptr;
  const int item = dtype == 1 ? 2 : 4;
  const int epc = vec ? 16 / item : 1;
  if (vec && (D * item) % 16) return nullptr;
  if ((long long)nc * 32 * epc < D) return nullptr;  // a lane owns too few
  *smem = smem_bytes(D, item, 2 + has_res + has_dsum, warps, vec);
  if (*smem > kMaxSmem) return nullptr;
  return dtype == 1 ? pick_mode<__nv_bfloat16>(has_res, has_dsum, vec, nc)
                    : pick_mode<float>(has_res, has_dsum, vec, nc);
}

}  // namespace

extern "C" {

// Blocks of the kernel for this shape that are resident on one SM at
// once (the grid's sizing: this x the SMs), and the dynamic shared
// memory a block asks for. dtype (the rows'): 0 = fp32, 1 = bf16.
int lavila_ln_bwd_occupancy(int D, int dtype, int has_res, int has_dsum,
                            int vec, int nc, int warps, int* blocks_per_sm,
                            int* smem) {
  size_t bytes = 0;
  KernelFn k = kernel_for(D, dtype, has_res, has_dsum, vec, nc, warps, &bytes);
  if (!k) return (int)cudaErrorInvalidValue;
  cudaError_t err = lavila::allow_smem(k, bytes);
  if (err != cudaSuccess) return (int)err;
  *smem = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, 32 * warps, bytes);
}

// x, dy, dx (and K5's r, K4's ds): (R, D) contiguous; w: (D,); dwb:
// (2, D) contiguous, dgamma then dbeta; part: (grid, 2, D) fp32 when grid
// > 1; dwb and part 16-byte aligned. Block b takes rows
// [b * rows_per_block, (b + 1) * rows_per_block). vec: 16-byte chunks
// through the ring (every pointer 16-byte aligned, D * itemsize a
// multiple of 16); nc: the chunks (vec) or values a lane may own. dtype:
// the rows', wdtype: gamma's, 0 = fp32, 1 = bf16. A grid of more than one
// block is a cooperative launch (the caller sizes it by
// lavila_ln_bwd_occupancy).
int lavila_ln_bwd(const void* x, const void* r, const void* w, const void* dy,
                  const void* ds, void* dx, void* dwb, void* part, long long R,
                  int D, int rows_per_block, int grid, int warps, int vec,
                  int nc, float eps, int dtype, int wdtype, void* stream) {
  size_t bytes = 0;
  KernelFn k = kernel_for(D, dtype, r != nullptr, ds != nullptr, vec, nc,
                          warps, &bytes);
  if (!k || R < 1 || grid < 1 || rows_per_block < 1 ||
      (long long)rows_per_block * grid < R ||
      (long long)rows_per_block * (grid - 1) >= R || (grid > 1 && !part) ||
      (wdtype != 0 && wdtype != 1))
    return (int)cudaErrorInvalidValue;
  // dgamma/dbeta and the partials go out 4 columns at a time; the vector
  // path reads the rows in 16-byte chunks
  auto odd = [](const void* p) { return ((unsigned long long)p & 15ull) != 0; };
  if (odd(dwb) || odd(part) ||
      (vec && (odd(x) || odd(r) || odd(dy) || odd(ds) || odd(dx))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = lavila::allow_smem(k, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  Args a{x, r, w, dy, ds, dx, dwb, (float*)part, R, D, rows_per_block, eps,
         wdtype};
  void* args[] = {&a};
  const dim3 block(32 * warps);
  if (grid == 1)
    return (int)cudaLaunchKernel((const void*)k, dim3(grid), block, args,
                                 bytes, s);
  return (int)cudaLaunchCooperativeKernel((const void*)k, dim3(grid), block,
                                          args, bytes, s);
}

}  // extern "C"
