// Dense decode-attention kernel (K6) for Hopper, sm_90a.
//
// Replaces: dnn_tpu/ops/pallas/cached_attention.py:_decode_attn_kernel
// (entry decode_attention) -- one decode step of every slot against its
// dense per-slot cache: R query rows per (slot, KV head), every row of
// slot b attending cache columns <= pos[b]. It is the paged kernel (K7,
// paged_decode.cu) with the identity table.
//
// What bounds it on an H100: bytes. A decode row does ~4 flops per K/V
// element it reads (a dot and an axpy), so the least time is each slot's
// live K/V bytes -- columns 0..pos[b] -- read once: at B=4 Hk=12 D=64
// with pos {0, 15, 16, 1023}, 6.5 MB of f32 cache (1.9 us at 3.35 TB/s),
// or 1.6 MB of int8 payload plus 0.1 MB of f32 scales (0.5 us).
//
// Design. The TPU kernel streams (Hk, block_s, D) slabs down a
// SEQUENTIAL grid axis, carrying (m, l, acc) in VMEM and clamping the
// cache index map at the slot's last live block so dead blocks are
// never copied. Here one thread block owns one query row of one (slot,
// KV head) and loops over the live keys itself, 0..min(pos[b], S-1):
// nothing past the live limit is read. The clamp at S-1 matters: an
// inactive dense slot keeps a stale pos that can equal the cache length,
// and its (discarded) output must still come from valid memory. As in
// K7, the block's 16 warps split the live keys between them (warp w
// takes chunks w, w+16, ... of 8 keys), each keeping its own (m, l, acc)
// in registers, so many loads are in flight for a bytes-bound loop; the
// partial states merge once at the end through shared memory. Inside a
// warp one lane owns D/32 CONTIGUOUS head dims, so each key row is one
// coalesced vector load (8 bytes a lane for f32 at D=64, 2 for int8) and
// its score one warp reduction; a chunk of 8 keys is loaded into
// registers before any of it is used.
//
// int8 caches store one f32 scale per (position, head) for K and for V.
// The K scale multiplies the score before 1/sqrt(D), as the reference
// does. The V scale is folded into the probability for the P.V product
// ONLY: the row sum l adds the unscaled probability (the reference
// scales the softmax output, whose denominator never saw the V scales).
// The int8 payload is read at 1 byte an element and turned into f32 in
// registers; no dequantized cache exists.
//
// Numerics: f32 accumulation and f32 output for every cache type, masked
// scores at -1e30 (not -inf) as the reference does. Each warp's first
// key is live (it is <= the clamped limit), so a warp's running max is a
// real score before a masked column counts; a warp with no live key
// contributes exp(-1e30 - M) = 0 at the merge. scale = 1/sqrt(D)
// multiplies where the reference divides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 8;  // keys loaded into registers per step
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// N contiguous elements at p (aligned to N * sizeof(element)) -> f32.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* o) {
  if constexpr (N == 1) {
    o[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 1) {
    o[0] = __bfloat162float(p[0]);
  } else if constexpr (N == 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = x.x;
    o[1] = x.y;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const int8_t* p, float* o) {
  if constexpr (N == 1) {
    o[0] = static_cast<float>(p[0]);
  } else if constexpr (N == 2) {
    const char2 x = *reinterpret_cast<const char2*>(p);
    o[0] = static_cast<float>(x.x);
    o[1] = static_cast<float>(x.y);
  } else {
    const char4 x = *reinterpret_cast<const char4*>(p);
    o[0] = static_cast<float>(x.x);
    o[1] = static_cast<float>(x.y);
    o[2] = static_cast<float>(x.z);
    o[3] = static_cast<float>(x.w);
  }
}

// q (B, Hk, R, D) f32; k, v (B, Hk, S, D) KV; ks, vs (B, Hk, S) f32
// (kQuant only); pos (B,) int32; out (B, Hk, R, D) f32.
// Grid (B * Hk, R), block kThreads.
template <typename KV, int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs,
                   const int* __restrict__ pos, float* __restrict__ out,
                   int Hk, int R, int S, float scale) {
  constexpr int DL = D / 32;  // contiguous head dims owned by each lane
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ float sacc[kWarps][D];

  const int bh = blockIdx.x;
  const int b = bh / Hk;
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int last = min(pos[b], S - 1);
  const size_t row_off = ((size_t)bh * R + r) * D + lane * DL;
  const size_t kv_off = (size_t)bh * S * D + lane * DL;
  const size_t sc_off = (size_t)bh * S;

  float qv[DL];
  load_f32<DL>(q + row_off, qv);

  float m = kNegBig, l = 0.f, acc[DL];
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) acc[dd] = 0.f;

  for (int c0 = warp * kChunk; c0 <= last; c0 += kWarps * kChunk) {
    float kr[kChunk][DL], vr[kChunk][DL], ksc[kChunk], vsc[kChunk];
    bool ok[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int col = c0 + i;
      ok[i] = col <= last;
      if (ok[i]) {
        load_f32<DL>(k + kv_off + (size_t)col * D, kr[i]);
        load_f32<DL>(v + kv_off + (size_t)col * D, vr[i]);
      } else {
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) kr[i][dd] = vr[i][dd] = 0.f;
      }
      if constexpr (kQuant) {
        ksc[i] = ok[i] ? ks[sc_off + col] : 0.f;
        vsc[i] = ok[i] ? vs[sc_off + col] : 0.f;
      }
    }
    float s[kChunk];
    float cmax = kNegBig;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      float x = 0.f;
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) x = fmaf(qv[dd], kr[i][dd], x);
      x = warp_sum(x);
      if constexpr (kQuant) x *= ksc[i];
      s[i] = ok[i] ? x * scale : kNegBig;
      cmax = fmaxf(cmax, s[i]);
    }
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[dd] *= alpha;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float p = ok[i] ? expf(s[i] - m_new) : 0.f;
      l += p;
      float pv = p;
      if constexpr (kQuant) pv *= vsc[i];
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) acc[dd] = fmaf(pv, vr[i][dd], acc[dd]);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) sacc[warp][lane * DL + dd] = acc[dd];
  __syncthreads();
  if (warp == 0) {
    float mx = sm[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm[w]);
    float tot = 0.f, o[DL];
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) o[dd] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm[w] - mx);
      tot += sl[w] * f;
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) o[dd] += sacc[w][lane * DL + dd] * f;
    }
    const float inv = 1.f / tot;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) out[row_off + dd] = o[dd] * inv;
  }
}

template <typename KV, bool kQuant>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos,
                   float* out, int B, int Hk, int R, int S, int D,
                   float scale, cudaStream_t stream) {
  const dim3 grid(B * Hk, R);
  const KV* kk = static_cast<const KV*>(k);
  const KV* vv = static_cast<const KV*>(v);
  switch (D) {
    case 32:
      decode_attn_kernel<KV, 32, kQuant><<<grid, kThreads, 0, stream>>>(
          q, kk, vv, ks, vs, pos, out, Hk, R, S, scale);
      break;
    case 64:
      decode_attn_kernel<KV, 64, kQuant><<<grid, kThreads, 0, stream>>>(
          q, kk, vv, ks, vs, pos, out, Hk, R, S, scale);
      break;
    case 128:
      decode_attn_kernel<KV, 128, kQuant><<<grid, kThreads, 0, stream>>>(
          q, kk, vv, ks, vs, pos, out, Hk, R, S, scale);
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
extern "C" int dnn_decode_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* pos,
                                    void* out, int B, int Hk, int R, int S,
                                    int D, int kv_kind, float scale,
                                    void* stream) {
  if (B <= 0 || Hk <= 0 || R <= 0 || R > 65535 || S <= 0)
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
      return (int)launch<float, false>(qq, k, v, kss, vss, pp, oo, B, Hk, R,
                                       S, D, scale, st);
    case 1:
      return (int)launch<__nv_bfloat16, false>(qq, k, v, kss, vss, pp, oo, B,
                                               Hk, R, S, D, scale, st);
    case 2:
      return (int)launch<int8_t, true>(qq, k, v, kss, vss, pp, oo, B, Hk, R,
                                       S, D, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
