// Paged decode-attention kernel (K7) for Hopper, sm_90a.
//
// Replaces: dnn_tpu/ops/pallas/cached_attention.py:_paged_decode_kernel
// (entry paged_decode_attention) -- one decode step of every slot
// against a shared block pool through a per-slot block table: logical
// block j of slot b lives at pool block tables[b, j], and every query
// row of slot b attends logical columns <= pos[b].
//
// What bounds it on an H100: bytes. A decode row does ~4 flops per K/V
// element it reads (a dot and an axpy), so the least time is each
// slot's live K/V bytes -- columns 0..pos[b] -- read once.
//
// Design. The TPU kernel streams the table-chased blocks down a
// SEQUENTIAL grid axis, carrying the online-softmax state in VMEM
// scratch and re-targeting dead logical blocks at the last live one so
// the pipeline skips their copy. Here one thread block owns one query
// row of one (slot, KV head) and walks the slot's table itself: it
// reads table entries 0..pos[b]/bp only (an inactive slot's entry 0 is
// the reserved junk block) and never touches a dead block -- no dense
// view of the pool is ever materialised. To keep enough loads in
// flight for a bytes-bound loop, the block's 16 warps split the live
// blocks between them (warp w takes blocks w, w+16, ...), each keeping
// its own (m, l, acc) in registers, one float per row; the partial
// states merge once at the end through shared memory. Inside a warp one
// lane owns D/32 head dims: each key row is one coalesced load, its
// score one warp reduction, and a chunk of 8 keys is loaded into
// registers before any of it is used.
//
// int8 pools carry one f32 scale per (position, head) for K and for V,
// in (n_blocks, Hk, bp) scale blocks read through the same table entry
// as their payload block. The K scale multiplies the score before
// 1/sqrt(D); the V scale is folded into the probability for the P.V
// product only -- the row sum l adds the unscaled probability, as the
// reference's softmax denominator never sees the V scales. The payload
// is read at 1 byte an element and widened in registers.
//
// Numerics: f32 accumulation and f32 output for every pool type,
// masked scores at -1e30 (not -inf) as the reference does. Each warp's
// first key is the first column of a live block, hence live, so a
// warp's running max is a real score before a masked column counts;
// a warp with no live block contributes exp(-1e30 - M) = 0 at the
// merge. scale = 1/sqrt(D) multiplies where the reference divides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 8;  // keys loaded into registers per step
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// q (B, Hk, R, D) f32; kp, vp (n_blocks, Hk, bp, D) KV; ks, vs
// (n_blocks, Hk, bp) f32 (kQuant only); tables (B, nb_max) int32; pos
// (B,) int32; out (B, Hk, R, D) f32. Grid (B * Hk, R), block kThreads.
template <typename KV, int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, float* __restrict__ out,
                    int Hk, int R, int bp, int nb_max, float scale) {
  constexpr int DL = D / 32;
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ float sacc[kWarps][D];

  const int bh = blockIdx.x;
  const int b = bh / Hk, hk = bh % Hk;
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int limit = pos[b];
  const int last_blk = min(limit / bp, nb_max - 1);
  const size_t row_off = ((size_t)bh * R + r) * D;

  float qv[DL];
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) qv[dd] = q[row_off + lane + 32 * dd];

  float m = kNegBig, l = 0.f, acc[DL];
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) acc[dd] = 0.f;

  for (int j = warp; j <= last_blk; j += kWarps) {
    const int phys = tables[(size_t)b * nb_max + j];
    const size_t sc_off = ((size_t)phys * Hk + hk) * bp;
    const size_t blk_off = sc_off * D;
    for (int i0 = 0; i0 < bp; i0 += kChunk) {
      float kr[kChunk][DL], vr[kChunk][DL], ksc[kChunk], vsc[kChunk];
      bool ok[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        ok[i] = (i0 + i < bp) && (j * bp + i0 + i <= limit);
        const size_t off = blk_off + (size_t)(i0 + i) * D + lane;
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) {
          kr[i][dd] = ok[i] ? to_f32(kp[off + 32 * dd]) : 0.f;
          vr[i][dd] = ok[i] ? to_f32(vp[off + 32 * dd]) : 0.f;
        }
        if constexpr (kQuant) {
          ksc[i] = ok[i] ? ks[sc_off + i0 + i] : 0.f;
          vsc[i] = ok[i] ? vs[sc_off + i0 + i] : 0.f;
        }
      }
      float s[kChunk];
      float cmax = kNegBig;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        float x = 0.f;
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) x += qv[dd] * kr[i][dd];
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
        for (int dd = 0; dd < DL; ++dd) acc[dd] += pv * vr[i][dd];
      }
      m = m_new;
    }
  }

  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) sacc[warp][lane + 32 * dd] = acc[dd];
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
      for (int dd = 0; dd < DL; ++dd) o[dd] += sacc[w][lane + 32 * dd] * f;
    }
    const float inv = 1.f / tot;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) out[row_off + lane + 32 * dd] = o[dd] * inv;
  }
}

template <typename KV, bool kQuant>
cudaError_t launch(const float* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* tables,
                   const int* pos, float* out, int B, int Hk, int R, int D,
                   int bp, int nb_max, float scale, cudaStream_t stream) {
  const dim3 grid(B * Hk, R);
  const KV* kk = static_cast<const KV*>(kp);
  const KV* vv = static_cast<const KV*>(vp);
  switch (D) {
    case 32:
      paged_decode_kernel<KV, 32, kQuant><<<grid, kThreads, 0, stream>>>(
          q, kk, vv, ks, vs, tables, pos, out, Hk, R, bp, nb_max, scale);
      break;
    case 64:
      paged_decode_kernel<KV, 64, kQuant><<<grid, kThreads, 0, stream>>>(
          q, kk, vv, ks, vs, tables, pos, out, Hk, R, bp, nb_max, scale);
      break;
    case 128:
      paged_decode_kernel<KV, 128, kQuant><<<grid, kThreads, 0, stream>>>(
          q, kk, vv, ks, vs, tables, pos, out, Hk, R, bp, nb_max, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). kv_kind: 0 = f32 pool, 1 = bf16,
// 2 = int8 with ks/vs scale blocks (null for the float kinds). Returns
// the launch's cudaError_t (0 = launched).
extern "C" int dnn_paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables, const void* pos, void* out, int B,
    int Hk, int R, int D, int bp, int nb_max, int kv_kind, float scale,
    void* stream) {
  if (B <= 0 || Hk <= 0 || R <= 0 || R > 65535 || bp <= 0 || nb_max <= 0)
    return (int)cudaErrorInvalidValue;
  if (kv_kind == 2 ? (ks == nullptr || vs == nullptr)
                   : (ks != nullptr || vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const float* qq = static_cast<const float*>(q);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* tt = static_cast<const int*>(tables);
  const int* pp = static_cast<const int*>(pos);
  float* oo = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0:
      return (int)launch<float, false>(qq, kp, vp, kss, vss, tt, pp, oo, B,
                                       Hk, R, D, bp, nb_max, scale, st);
    case 1:
      return (int)launch<__nv_bfloat16, false>(qq, kp, vp, kss, vss, tt, pp,
                                               oo, B, Hk, R, D, bp, nb_max,
                                               scale, st);
    case 2:
      return (int)launch<int8_t, true>(qq, kp, vp, kss, vss, tt, pp, oo, B,
                                       Hk, R, D, bp, nb_max, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
