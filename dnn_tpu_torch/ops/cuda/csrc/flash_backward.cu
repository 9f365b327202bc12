// Flash-attention backward kernels (K3 dQ, K4 dK/dV) for Hopper, sm_90a.
//
// Replaces: dnn_tpu/ops/pallas/flash_attention.py:_bwd_dq_kernel (K3)
// and :_bwd_dkv_kernel (K4), the two pallas_calls of _flash_tpu_bwd.
// Given q, k, v, the upstream gradient dO (in q's dtype), the forward's
// logsumexp lse (BH, T) and D = rowsum(dO * O) (BH, T), both f32 and both
// computed outside these kernels:
//   P  = exp(scale * q.k^T - lse)   (0 where masked)
//   dP = dO . v^T,   dS = P * (dP - D)
//   K3:  dQ = scale * dS . K
//   K4:  dV = P^T . dO,   dK = scale * dS^T . Q
// with the forward's bottom-right causal mask (query t sees keys
// <= t + S - T). Outputs in the inputs' dtype, accumulation in f32.
//
// What bounds them on an H100: the f32 arithmetic. Per live (row, key)
// pair K3 does 3 products of length D (scores, dP, dS.K) and K4 four
// (scores, dP, P^T.dO, dS^T.Q): 14 T S D / 2 flops over both at causal,
// ~11.3 GFLOP at BH=96, T=S=512, D=64, 0.17 ms at 67 TFLOP/s, against
// ~100 MB of inputs and outputs (0.03 ms at 3.35 TB/s). As in the
// forward the products are f32 FMAs on the CUDA cores with operands
// staged in shared memory; tensor cores are a later redesign.
//
// Design. The JAX split is kept, so neither kernel needs atomics and
// both are deterministic (a resumed training run reproduces an
// uninterrupted one bit for bit):
//   * K3: one block per (b*h, 64-row query tile), looping over the key
//     tiles up to the tile of the block's last live column;
//   * K4: one block per (b*h, 64-key tile), looping over the query tiles
//     from the first one that can see it: for causal the first live row
//     is max(0, k0 - (S - T)).
// Both rebuild P and dS through ONE device function, recompute_pds (as
// _recompute_pds is shared in JAX), so the two kernels cannot disagree
// on masking or scaling. Thread layout as in the forward: 16 x 16
// threads, thread (ty, tx) owns the 4 x 4 patch of query rows 4ty.. and
// keys 4tx.. of a 64 x 64 tile; the operands of both products of the
// recompute are staged d-major, so each dot-product step is two 16-byte
// shared loads for 16 FMAs. The patches of P and dS then go through
// shared memory to the accumulation product, where the thread owns 4
// rows (K3: query rows; K4: keys) x D/16 dims. dQ and dK are multiplied
// by `scale` once, at the end.
//
// Ragged T and S: rows past T and keys past S are staged as zeros,
// masked out of P (so they add nothing) and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 patch of a tile

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

// Rows [r0, r0 + kB) of a row-major (len, D) matrix into shared memory
// d-major, sT[d * kB + r]; rows at or past `len` are zeros. Consecutive
// threads take consecutive rows, so the transposed stores hit distinct
// banks.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(const T* g, int r0, int len,
                                                 float* sT) {
  for (int i = threadIdx.x; i < kB * (D / 4); i += kThreads) {
    const int r = i % kB, d = (i / kB) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < len) load4(g + (size_t)(r0 + r) * D + d, x);
#pragma unroll
    for (int u = 0; u < 4; ++u) sT[(d + u) * kB + r] = x[u];
  }
}

// The same rows row-major: s[r * D + d].
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* g, int r0, int len,
                                           float* s) {
  for (int i = threadIdx.x; i < kB * (D / 4); i += kThreads) {
    const int r = (4 * i) / D, d = (4 * i) % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < len) load4(g + (size_t)(r0 + r) * D + d, x);
    *reinterpret_cast<float4*>(&s[r * D + d]) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The per-row statistics of query tile q0: lse and D, zero past T.
__device__ __forceinline__ void stage_stats(const float* lse, const float* di,
                                            int q0, int T, float* lse_s,
                                            float* di_s) {
  const int r = threadIdx.x;
  if (r < kB) {
    const bool in = q0 + r < T;
    lse_s[r] = in ? lse[q0 + r] : 0.f;
    di_s[r] = in ? di[q0 + r] : 0.f;
  }
}

// acc[i][j] = sum_d aT[d][4ty + i] * bT[d][4tx + j] over two d-major
// tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* aT, const float* bT,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&aT[d * kB + 4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&bT[d * kB + 4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// THE backward recompute, shared by K3 and K4: for the thread's patch
// (query rows q0 + 4ty + i, keys k0 + 4tx + j) rebuild the normalised
// probabilities p = exp(scale * q.k - lse), 0 where masked, and
// ds = p * (dO.v - D). qT/doT hold the query tile d-major, kT/vT the key
// tile; lse_s/di_s the query tile's row statistics.
template <int D>
__device__ __forceinline__ void recompute_pds(
    const float* qT, const float* kT, const float* doT, const float* vT,
    const float* lse_s, const float* di_s, int q0, int k0, int T, int S,
    int causal, float scale, int ty, int tx, float p[4][4], float ds[4][4]) {
  const int offset = S - T;
  float dp[4][4];
  tile_dot<D>(qT, kT, ty, tx, p);
  tile_dot<D>(doT, vT, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, t = q0 + r;
    const float lse = lse_s[r], di = di_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + 4 * tx + j;
      const bool live = t < T && c < S && (!causal || c <= t + offset);
      const float pp = live ? expf(p[i][j] * scale - lse) : 0.f;
      p[i][j] = pp;
      ds[i][j] = pp * (dp[i][j] - di);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (5 * kB * D + kB * kB + 2 * kB);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (6 * kB * D + 2 * kB * kB + 2 * kB);
}

// K3. q, do (BH, T, D); k, v (BH, S, D); lse, di (BH, T) f32; dq
// (BH, T, D). Grid (ceil(T / kB), BH), block kThreads.
template <typename Tp, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                    const Tp* __restrict__ v, const Tp* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, Tp* __restrict__ dq, int T,
                    int S, int causal, float scale) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [D][kB]
  float* doT = qT + D * kB;     // [D][kB]
  float* kT = doT + D * kB;     // [D][kB]
  float* vT = kT + D * kB;      // [D][kB]
  float* ks = vT + D * kB;      // [kB][D]
  float* dsT = ks + kB * D;     // [kB keys][kB rows]
  float* lse_s = dsT + kB * kB;
  float* di_s = lse_s + kB;

  const int nq = (T + kB - 1) / kB;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kB;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t qoff = (size_t)bh * T * D, koff = (size_t)bh * S * D;

  stage_transposed<Tp, D>(q + qoff, q0, T, qT);
  stage_transposed<Tp, D>(dout + qoff, q0, T, doT);
  stage_stats(lse + (size_t)bh * T, di + (size_t)bh * T, q0, T, lse_s, di_s);
  const int last_row = min(T, q0 + kB) - 1;
  const int last_col = causal ? min(S - 1, last_row + S - T) : S - 1;

  float acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < DV; ++u) acc[i][u] = 0.f;

  for (int k0 = 0; k0 <= last_col; k0 += kB) {
    __syncthreads();
    stage_transposed<Tp, D>(k + koff, k0, S, kT);
    stage_transposed<Tp, D>(v + koff, k0, S, vT);
    stage_rows<Tp, D>(k + koff, k0, S, ks);
    __syncthreads();

    float p[4][4], ds[4][4];
    recompute_pds<D>(qT, kT, doT, vT, lse_s, di_s, q0, k0, T, S, causal,
                     scale, ty, tx, p, ds);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dsT[(4 * tx + j) * kB + 4 * ty]) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dsT[c * kB + 4 * ty]);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      float kv[DV];
      lds<DV>(&ks[c * D + DV * tx], kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < DV; ++u) acc[i][u] = fmaf(dv[i], kv[u], acc[i][u]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= T) continue;
    Tp* o = dq + qoff + (size_t)t * D + DV * tx;
#pragma unroll
    for (int u = 0; u < DV; ++u) store1(o + u, acc[i][u] * scale);
  }
}

// K4. Shapes as K3; dk, dv (BH, S, D). Grid (ceil(S / kB), BH), block
// kThreads.
template <typename Tp, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                     const Tp* __restrict__ v, const Tp* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, Tp* __restrict__ dk,
                     Tp* __restrict__ dv, int T, int S, int causal,
                     float scale) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;             // [D][kB]   the block's keys, resident
  float* vT = kT + D * kB;      // [D][kB]
  float* qT = vT + D * kB;      // [D][kB]   the current query tile
  float* doT = qT + D * kB;     // [D][kB]
  float* qs = doT + D * kB;     // [kB][D]
  float* dos = qs + kB * D;     // [kB][D]
  float* ps = dos + kB * D;     // [kB rows][kB keys]
  float* dss = ps + kB * kB;    // [kB rows][kB keys]
  float* lse_s = dss + kB * kB;
  float* di_s = lse_s + kB;

  const int k0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t qoff = (size_t)bh * T * D, koff = (size_t)bh * S * D;

  stage_transposed<Tp, D>(k + koff, k0, S, kT);
  stage_transposed<Tp, D>(v + koff, k0, S, vT);
  // the first query row that sees key k0 (row t sees keys <= t + S - T)
  const int first_row = causal ? max(0, k0 - (S - T)) : 0;

  float ak[4][DV], av[4][DV];  // key rows 4ty + i, dims DV * tx + u
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < DV; ++u) ak[i][u] = av[i][u] = 0.f;

  for (int q0 = (first_row / kB) * kB; q0 < T; q0 += kB) {
    __syncthreads();
    stage_transposed<Tp, D>(q + qoff, q0, T, qT);
    stage_transposed<Tp, D>(dout + qoff, q0, T, doT);
    stage_rows<Tp, D>(q + qoff, q0, T, qs);
    stage_rows<Tp, D>(dout + qoff, q0, T, dos);
    stage_stats(lse + (size_t)bh * T, di + (size_t)bh * T, q0, T, lse_s,
                di_s);
    __syncthreads();

    float p[4][4], ds[4][4];
    recompute_pds<D>(qT, kT, doT, vT, lse_s, di_s, q0, k0, T, S, causal,
                     scale, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(&ps[(4 * ty + i) * kB + 4 * tx]) =
          make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
      *reinterpret_cast<float4*>(&dss[(4 * ty + i) * kB + 4 * tx]) =
          make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kB; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(&ps[r * kB + 4 * ty]);
      const float4 d4 = *reinterpret_cast<const float4*>(&dss[r * kB + 4 * ty]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
      float dov[DV], qv[DV];
      lds<DV>(&dos[r * D + DV * tx], dov);
      lds<DV>(&qs[r * D + DV * tx], qv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < DV; ++u) {
          av[i][u] = fmaf(pv[i], dov[u], av[i][u]);
          ak[i][u] = fmaf(dsv[i], qv[u], ak[i][u]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + 4 * ty + i;
    if (c >= S) continue;
    Tp* ok = dk + koff + (size_t)c * D + DV * tx;
    Tp* ov = dv + koff + (size_t)c * D + DV * tx;
#pragma unroll
    for (int u = 0; u < DV; ++u) {
      store1(ok + u, ak[i][u] * scale);
      store1(ov + u, av[i][u]);
    }
  }
}

template <typename Tp, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int BH, int T, int S, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<Tp, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((T + kB - 1) / kB, BH);
  flash_bwd_dq_kernel<Tp, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tp*>(q), static_cast<const Tp*>(k),
      static_cast<const Tp*>(v), static_cast<const Tp*>(dout), lse, di,
      static_cast<Tp*>(dq), T, S, causal, scale);
  return cudaGetLastError();
}

template <typename Tp, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int BH, int T, int S, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<Tp, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kB - 1) / kB, BH);
  flash_bwd_dkv_kernel<Tp, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tp*>(q), static_cast<const Tp*>(k),
      static_cast<const Tp*>(v), static_cast<const Tp*>(dout), lse, di,
      static_cast<Tp*>(dk), static_cast<Tp*>(dv), T, S, causal, scale);
  return cudaGetLastError();
}

template <typename Tp>
cudaError_t dq_d(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* di, void* dq,
                 int BH, int T, int S, int D, int causal, float scale,
                 cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_dq<Tp, 32>(q, k, v, dout, lse, di, dq, BH, T, S, causal,
                               scale, st);
    case 64:
      return launch_dq<Tp, 64>(q, k, v, dout, lse, di, dq, BH, T, S, causal,
                               scale, st);
    case 128:
      return launch_dq<Tp, 128>(q, k, v, dout, lse, di, dq, BH, T, S, causal,
                                scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Tp>
cudaError_t dkv_d(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* di,
                  void* dk, void* dv, int BH, int T, int S, int D, int causal,
                  float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_dkv<Tp, 32>(q, k, v, dout, lse, di, dk, dv, BH, T, S,
                                causal, scale, st);
    case 64:
      return launch_dkv<Tp, 64>(q, k, v, dout, lse, di, dk, dv, BH, T, S,
                                causal, scale, st);
    case 128:
      return launch_dkv<Tp, 128>(q, k, v, dout, lse, di, dk, dv, BH, T, S,
                                 causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(int BH, int T, int S, int causal) {
  return BH <= 0 || T <= 0 || S <= 0 || BH > 65535 || (causal && S < T);
}

}  // namespace

// C entry points (loaded with ctypes). kind: 0 = f32 tensors, 1 = bf16;
// lse and di are (BH, T) f32 either way. Return the launch's cudaError_t
// (0 = launched).
extern "C" int dnn_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, void* dq, int BH, int T,
                                int S, int D, int causal, int kind,
                                float scale, void* stream) {
  if (bad_shape(BH, T, S, causal)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return (int)dq_d<float>(q, k, v, dout, l, d, dq, BH, T, S, D, causal,
                              scale, st);
    case 1:
      return (int)dq_d<__nv_bfloat16>(q, k, v, dout, l, d, dq, BH, T, S, D,
                                      causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dnn_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, void* dk, void* dv, int BH,
                                 int T, int S, int D, int causal, int kind,
                                 float scale, void* stream) {
  if (bad_shape(BH, T, S, causal)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return (int)dkv_d<float>(q, k, v, dout, l, d, dk, dv, BH, T, S, D,
                               causal, scale, st);
    case 1:
      return (int)dkv_d<__nv_bfloat16>(q, k, v, dout, l, d, dk, dv, BH, T, S,
                                       D, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
