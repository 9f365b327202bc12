// Cached-attention prefill kernel (K5) for Hopper, sm_90a.
//
// Replaces: dnn_tpu/ops/pallas/cached_attention.py:_cached_attn_kernel
// (entry cached_attention) -- a prompt chunk's queries attend a
// preallocated K/V cache with a RUNTIME base position: row t of batch b
// sees cache columns <= pos[b] + t.
//
// What bounds it on an H100: the live K/V bytes and the f32 work come
// out close. Per (batch, head) the chunk's T rows read the live columns
// 0..pos+T-1 once (q and out are small) and do 4*D flops per live
// score. At the serving shape (T=64, D=64, f32 cache) the least time
// from bytes at 3.35 TB/s and from f32 FMAs at 67 TFLOP/s are within
// 1.5x of each other: bytes bound a chunk near the start of the cache,
// the f32 arithmetic a chunk deep into it (chip_smoke.py prints both).
// Tensor cores would lift the arithmetic bound only through TF32 or
// bf16 operands, which the f32 reference does not allow.
//
// Design. The TPU kernel carries the online-softmax state (row max m,
// row sum l, accumulator acc) across a SEQUENTIAL grid axis in VMEM
// scratch. Hopper blocks run in parallel in no order, so each block
// here owns kBQ query rows of one (batch, head) and loops over the keys
// itself, keeping m/l/acc in registers (one float each per row, not the
// TPU's 128-lane broadcast). The loop stops at the block's last live
// column (pos + last row): that one bound replaces both the TPU
// kernel's pl.when(live) compute skip and its repeated-block-index DMA
// skip -- dead cache columns are never read. Each step stages 64 keys
// of K and V in shared memory with 16-byte loads, read once per block
// and shared by its kBQ rows. Two warps work each row, each on its own
// 32-key half of every step (more warps in flight to hide latency);
// their partial (m, l, acc) merge once at the end. Scores use one lane
// per key against the query held in registers; P@V uses one lane per
// output dim with the probabilities broadcast by shuffle.
//
// int8 caches carry one f32 scale per (position, head) for K and for V;
// each step stages its keys' two scales in shared memory beside the
// widened payload. The K scale multiplies the score before 1/sqrt(D);
// the V scale is folded into the probability that is broadcast for the
// P@V product only -- the row sum l adds the unscaled probability, as
// the reference's softmax denominator never sees the V scales. The
// payload is read at 1 byte an element (4-byte loads) and widened once,
// in the staging step; an int8 cache moves a quarter of the f32 bytes.
//
// Numerics: f32 accumulation and f32 output for every cache type.
// Masked scores sit at -1e30 (not -inf) as in the reference, and a
// masked column adds exactly 0 to l and acc; a warp that has seen no
// live column yet keeps m = -1e30, l = 0, acc = 0, and weighs
// exp(-1e30 - M) = 0 when the halves merge. Column 0 is live for every
// row, so every row ends with a real maximum. The kernel multiplies the
// dot by scale = 1/sqrt(D) where the reference divides by sqrt(D):
// differences are at the ulp level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kBQ = 8;                   // query rows per block
constexpr int kBK = 32;                  // keys per warp tile, one per lane
constexpr int kSplit = 2;                // warps sharing one row's keys
constexpr int kKeys = kBK * kSplit;      // keys staged per step
constexpr int kWarps = kBQ * kSplit;     // warp (r, h): row r, tile half h
constexpr int kThreads = kWarps * 32;
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

__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  o[0] = static_cast<float>(x.x);
  o[1] = static_cast<float>(x.y);
  o[2] = static_cast<float>(x.z);
  o[3] = static_cast<float>(x.w);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// q (BH, T, D) f32; k, v (BH, S, D) KV; k_scale, v_scale (BH, S) f32
// (kQuant only); pos (B,) int32 with B = BH / H; out (BH, T, D) f32;
// q/k/v/out 16-byte aligned. Grid (BH, ceil(T / kBQ)), block kThreads.
// Warp (r, h) owns query row q0 + r and, of every kKeys-key step, the
// h-th 32-key tile; the kSplit partial softmax states of a row merge at
// the end.
template <typename KV, int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
cached_attn_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ pos, float* __restrict__ out,
                   int H, int T, int S, float scale) {
  constexpr int DL = D / 32;   // output dims owned by each lane
  constexpr int KS = D + 4;    // padded K row: float4 reads by lane-per-key
                               // hit every bank once per quarter warp
  __shared__ __align__(16) float ks[kKeys][KS];
  __shared__ __align__(16) float vs[kKeys][D];
  __shared__ float kss[kKeys], vss[kKeys];  // int8 scales of the step
  __shared__ float sm[kSplit][kBQ], sl[kSplit][kBQ];
  __shared__ float sacc[kSplit][kBQ][D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = warp % kBQ, h = warp / kBQ;
  const int t = q0 + r;
  const int base = pos[bh / H];
  const size_t q_off = (size_t)bh * T * D;
  const size_t kv_off = (size_t)bh * S * D;
  const size_t sc_off = (size_t)bh * S;

  // the row's query, in registers (the same values in every lane)
  float qreg[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    if (t < T) {
      load4(q + q_off + (size_t)t * D + d, &qreg[d]);
    } else {
      qreg[d] = qreg[d + 1] = qreg[d + 2] = qreg[d + 3] = 0.f;
    }
  }

  // the block's last live column: its last real row's limit
  const int last_row = min(T, q0 + kBQ) - 1;
  const int last_col = min(S - 1, base + last_row);

  float m = kNegBig, l = 0.f, acc[DL];
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) acc[dd] = 0.f;

  for (int c0 = 0; c0 <= last_col; c0 += kKeys) {
    __syncthreads();  // every warp is done with the previous step's keys
    for (int i = tid; i < kKeys * D / 4; i += kThreads) {
      const int j = (4 * i) / D, d = (4 * i) % D;
      const int col = c0 + j;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (col <= last_col) {
        load4(k + kv_off + (size_t)col * D + d, kx);
        load4(v + kv_off + (size_t)col * D + d, vx);
      }
      *reinterpret_cast<float4*>(&ks[j][d]) =
          make_float4(kx[0], kx[1], kx[2], kx[3]);
      *reinterpret_cast<float4*>(&vs[j][d]) =
          make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    if constexpr (kQuant) {
      if (tid < kKeys) {
        const int col = c0 + tid;
        kss[tid] = col <= last_col ? k_scale[sc_off + col] : 0.f;
        vss[tid] = col <= last_col ? v_scale[sc_off + col] : 0.f;
      }
    }
    __syncthreads();

    const int jj = h * kBK + lane;  // this lane's key in the staged step
    const int col = c0 + jj;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[jj][d]);
      s = fmaf(qreg[d], kk.x, s);
      s = fmaf(qreg[d + 1], kk.y, s);
      s = fmaf(qreg[d + 2], kk.z, s);
      s = fmaf(qreg[d + 3], kk.w, s);
    }
    const bool live = (t < T) && (col <= base + t) && (col < S);
    if constexpr (kQuant) s *= kss[jj];
    s = live ? s * scale : kNegBig;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    float pv = p;
    if constexpr (kQuant) pv *= vss[jj];
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[dd] *= alpha;
#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      const float pj = __shfl_sync(kFull, pv, j);
#pragma unroll
      for (int dd = 0; dd < DL; ++dd)
        acc[dd] = fmaf(pj, vs[h * kBK + j][lane + 32 * dd], acc[dd]);
    }
    m = m_new;
  }

  // merge the row's kSplit partial states (a half that saw no live key
  // holds m = -1e30, l = 0 and weighs exp(-1e30 - M) = 0)
  if (lane == 0) {
    sm[h][r] = m;
    sl[h][r] = l;
  }
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) sacc[h][r][lane + 32 * dd] = acc[dd];
  __syncthreads();
  if (h == 0 && t < T) {
    float mx = sm[0][r];
#pragma unroll
    for (int hh = 1; hh < kSplit; ++hh) mx = fmaxf(mx, sm[hh][r]);
    float tot = 0.f, o[DL];
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) o[dd] = 0.f;
#pragma unroll
    for (int hh = 0; hh < kSplit; ++hh) {
      const float f = expf(sm[hh][r] - mx);
      tot += sl[hh][r] * f;
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) o[dd] += sacc[hh][r][lane + 32 * dd] * f;
    }
    const float inv = 1.f / tot;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd)
      out[q_off + (size_t)t * D + lane + 32 * dd] = o[dd] * inv;
  }
}

template <typename KV, bool kQuant>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos,
                   float* out, int BH, int H, int T, int S, int D,
                   float scale, cudaStream_t stream) {
  const dim3 grid(BH, (T + kBQ - 1) / kBQ);
  const KV* kk = static_cast<const KV*>(k);
  const KV* vv = static_cast<const KV*>(v);
  switch (D) {
    case 32:
      cached_attn_kernel<KV, 32, kQuant><<<grid, kThreads, 0, stream>>>(
          q, kk, vv, ks, vs, pos, out, H, T, S, scale);
      break;
    case 64:
      cached_attn_kernel<KV, 64, kQuant><<<grid, kThreads, 0, stream>>>(
          q, kk, vv, ks, vs, pos, out, H, T, S, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). kv_kind: 0 = f32 cache, 1 = bf16,
// 2 = int8 with ks/vs scales (null for the float kinds). Returns the
// launch's cudaError_t (0 = launched).
extern "C" int dnn_cached_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* pos,
                                    void* out, int BH, int H, int T, int S,
                                    int D, int kv_kind, float scale,
                                    void* stream) {
  if (BH <= 0 || H <= 0 || T <= 0 || S <= 0 || BH % H != 0 ||
      (T + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (kv_kind == 2 ? (ks == nullptr || vs == nullptr)
                   : (ks != nullptr || vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const float* qq = static_cast<const float*>(q);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* pp = static_cast<const int*>(pos);
  float* oo = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0:
      return (int)launch<float, false>(qq, k, v, kss, vss, pp, oo, BH, H, T,
                                       S, D, scale, st);
    case 1:
      return (int)launch<__nv_bfloat16, false>(qq, k, v, kss, vss, pp, oo,
                                               BH, H, T, S, D, scale, st);
    case 2:
      return (int)launch<int8_t, true>(qq, k, v, kss, vss, pp, oo, BH, H, T,
                                       S, D, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
