// Flash-attention forward kernels (K1, K2) for Hopper, sm_90a.
//
// Replaces: dnn_tpu/ops/pallas/flash_attention.py:_flash_kernel (K1, the
// forward without a gradient) and :_fwd_lse_kernel (K2, the same forward
// plus the per-row logsumexp the backward recomputes from). One kernel
// serves both: a null `lse` pointer is K1, a real one K2.
//
// What it computes: softmax(scale * q.k^T, masked) @ v for q (BH, T, D)
// and k/v (BH, S, D), scale = 1/sqrt(D). Causal masking is aligned
// bottom-right: query t sees keys <= t + (S - T), as the reference's
// tril(k=S-T). Output in the inputs' dtype (f32 or bf16); statistics and
// accumulation in f32; lse = m + log(l) stored as a plain (BH, T) f32.
//
// What bounds it on an H100: the f32 arithmetic. At the training shape
// (BH=96, T=S=512, D=64, causal) the two products are ~3.2 GFLOP of live
// work, 0.048 ms at 67 TFLOP/s on the CUDA cores, against ~50 MB of q,
// k, v and out in f32, 0.015 ms at 3.35 TB/s. Tensor cores (mma/wgmma on bf16
// operands) would lift the bound 15x for bf16 inputs; that is a later
// redesign. Here the products are f32 FMAs with operands in shared
// memory, and the design aims at keeping the FMA pipes fed from there.
//
// Design. The TPU kernel carries the online-softmax state across a
// SEQUENTIAL k grid axis in VMEM scratch and skips dead key blocks with
// pl.when. Hopper blocks run in parallel in no order, so each block owns
// kBQ = 64 query rows of one (batch, head) and loops over 64-key tiles
// itself, up to the tile that holds the block's last live column: that
// one bound replaces both the sequential axis and pl.when(live). Blocks
// are issued heaviest first (the last query tile of a causal row sees
// the most keys). 256 threads form a 16 x 16 grid; thread (ty, tx)
// owns the 4 x 4 patch of rows 4ty.. and keys 4tx.. of every 64 x 64
// score tile. q and k are staged d-major in shared memory, so each step
// of the dot product is one 16-byte load of 4 q values and one of 4 k
// values for 16 FMAs. Row max and row sum reduce over the 16 threads of
// a row by shuffles within a half warp; every thread of a row keeps the
// same (m, l). The probabilities go through shared memory (key-major)
// for P @ V, where the thread owns its 4 rows x D/16 output dims.
//
// Numerics: masked scores sit at -1e30 (not -inf) as in the reference
// and add exactly 0 to l and acc. Key 0 is live for every real row
// (S >= T, checked by the caller), and the first tile is always
// processed, so every real row ends with a real maximum. Ragged T and S
// are masked here: rows past T and keys past S are staged as zeros and
// never stored. The score is q.k times scale, as the reference divides
// q.k by sqrt(D): differences are at the ulp level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 patch of a tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// N consecutive floats from shared memory, vectorised where N allows.
template <int N>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + u);
      o[u] = x.x;
      o[u + 1] = x.y;
      o[u + 2] = x.z;
      o[u + 3] = x.w;
    }
  } else {
    static_assert(N == 2, "D / 16 must be 2 or a multiple of 4");
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  }
}

// Rows [r0, r0 + kRows) of a row-major (len, D) matrix into shared
// memory d-major: sT[d * kRows + r]. Rows at or past `len` are zeros.
// Consecutive threads take consecutive rows, so the transposed stores
// hit distinct banks.
template <typename T, int D, int kRows>
__device__ __forceinline__ void stage_transposed(const T* g, int r0, int len,
                                                 float* sT) {
  for (int i = threadIdx.x; i < kRows * (D / 4); i += kThreads) {
    const int r = i % kRows, d = (i / kRows) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < len) load4(g + (size_t)(r0 + r) * D + d, x);
#pragma unroll
    for (int u = 0; u < 4; ++u) sT[(d + u) * kRows + r] = x[u];
  }
}

// The same rows row-major: s[r * D + d].
template <typename T, int D, int kRows>
__device__ __forceinline__ void stage_rows(const T* g, int r0, int len,
                                           float* s) {
  for (int i = threadIdx.x; i < kRows * (D / 4); i += kThreads) {
    const int r = (4 * i) / D, d = (4 * i) % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < len) load4(g + (size_t)(r0 + r) * D + d, x);
    *reinterpret_cast<float4*>(&s[r * D + d]) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// acc[i][j] = sum_d aT[d][4ty + i] * bT[d][4tx + j] over two d-major
// 64-row tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* aT, const float* bT,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&aT[d * kBQ + 4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&bT[d * kBK + 4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Reductions over the 16 threads of one score row (one half warp).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * kBQ * D + kBK * kBQ);
}

// q (BH, T, D); k, v (BH, S, D); out (BH, T, D) in T's type; lse (BH, T)
// f32 or null. Grid (ceil(T / kBQ), BH), block kThreads, dynamic shared
// memory fwd_smem_bytes<D>().
template <typename Tp, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                 const Tp* __restrict__ v, Tp* __restrict__ out,
                 float* __restrict__ lse, int T, int S, int causal,
                 float scale) {
  constexpr int DV = D / 16;  // output dims owned by each thread
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;            // [D][kBQ]
  float* kT = qT + D * kBQ;    // [D][kBK]
  float* vs = kT + D * kBK;    // [kBK][D]
  float* pT = vs + kBK * D;    // [kBK][kBQ]

  const int nq = (T + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int offset = S - T;
  const Tp* qb = q + (size_t)bh * T * D;
  const Tp* kb = k + (size_t)bh * S * D;
  const Tp* vb = v + (size_t)bh * S * D;

  stage_transposed<Tp, D, kBQ>(qb, q0, T, qT);
  const int last_row = min(T, q0 + kBQ) - 1;
  const int last_col = causal ? min(S - 1, last_row + offset) : S - 1;

  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < DV; ++u) acc[i][u] = 0.f;
  }

  for (int k0 = 0; k0 <= last_col; k0 += kBK) {
    __syncthreads();  // every thread is done with the previous tile
    stage_transposed<Tp, D, kBK>(kb, k0, S, kT);
    stage_rows<Tp, D, kBK>(vb, k0, S, vs);
    __syncthreads();

    float s[4][4];
    tile_dot<D>(qT, kT, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
      bool live[4];
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + 4 * tx + j;
        live[j] = t < T && c < S && (!causal || c <= t + offset);
        s[i][j] = live[j] ? s[i][j] * scale : kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < DV; ++u) acc[i][u] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pT[(4 * tx + j) * kBQ + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pT[c * kBQ + 4 * ty]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DV];
      lds<DV>(&vs[c * D + DV * tx], vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < DV; ++u) acc[i][u] = fmaf(pv[i], vv[u], acc[i][u]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= T) continue;
    const float inv = 1.f / l[i];
    Tp* o = out + ((size_t)bh * T + t) * D + DV * tx;
#pragma unroll
    for (int u = 0; u < DV; ++u) store1(o + u, acc[i][u] * inv);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * T + t] = m[i] + logf(l[i]);
  }
}

template <typename Tp, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int BH, int T, int S, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<Tp, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((T + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<Tp, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tp*>(q), static_cast<const Tp*>(k),
      static_cast<const Tp*>(v), static_cast<Tp*>(out), lse, T, S, causal,
      scale);
  return cudaGetLastError();
}

template <typename Tp>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, int BH, int T, int S, int D, int causal,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<Tp, 32>(q, k, v, out, lse, BH, T, S, causal, scale, stream);
    case 64:
      return launch<Tp, 64>(q, k, v, out, lse, BH, T, S, causal, scale, stream);
    case 128:
      return launch<Tp, 128>(q, k, v, out, lse, BH, T, S, causal, scale,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (loaded with ctypes). kind: 0 = f32 q/k/v/out, 1 = bf16.
// lse: null for K1, a (BH, T) f32 buffer for K2. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int dnn_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int BH, int T, int S, int D, int causal,
                                   int kind, float scale, void* stream) {
  if (BH <= 0 || T <= 0 || S <= 0 || BH > 65535 || (causal && S < T))
    return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return (int)launch_d<float>(q, k, v, out, l, BH, T, S, D, causal, scale,
                                  st);
    case 1:
      return (int)launch_d<__nv_bfloat16>(q, k, v, out, l, BH, T, S, D, causal,
                                          scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
