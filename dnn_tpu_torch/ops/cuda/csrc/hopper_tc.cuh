// Tensor-core building blocks for Hopper (sm_90a), shared by the
// tensor-core flash kernels -- the forward (flash_attention.cu, K1/K2)
// and the backward (flash_backward.cu, K3/K4) -- and the cached-attention
// prefill (cached_attention.cu, K5). Inline PTX over cuda_bf16.h only (no
// CUTLASS or CuTe headers), so a library that includes it still builds
// in seconds. What is here: cp.async copies into shared memory, the
// wgmma fence / commit / wait and register pins, the shared-memory matrix
// descriptor, wgmma m64nNk16 (f32 += bf16 x bf16) with A from shared
// memory or registers, the swizzled tile layout both operand forms read,
// the tile copies (swizzled, and raw for a kernel to convert), exp2 on
// the SFU, and the packing of an f32 accumulator fragment into bf16 A
// fragments; for f32 operands, wgmma m64n64k8 on TF32, the splits of an
// f32 value into TF32 or bf16 hi + lo (K5 and the f32 flash kernels,
// K1-K4), and for the f32 flash kernels the split of an f32 tile into
// operand tiles and the split products (3xTF32 Q.K^T, bf16 x3 P.V); the
// kernels' shared-memory attributes and the dispatch over the head dims
// they take; and, for K5-K7, the query and output element type (f32, or
// bf16 under bf16 compute), its dispatch and its stores, head dim 256
// (m64n256k16 for K5's P.V), the sliding-window band and the softcap. The library's
// hash (_build.lib_path) covers this header, so an edit rebuilds every
// source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// fn(std::integral_constant<int, D>) for the head dims the kernels take.
template <typename F>
cudaError_t with_head_dim(int D, F fn) {
  switch (D) {
    case 32:
      return fn(std::integral_constant<int, 32>{});
    case 64:
      return fn(std::integral_constant<int, 64>{});
    case 128:
      return fn(std::integral_constant<int, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// fn(std::integral_constant<int, D>) for the head dims the cache-attention
// kernels take (K5, K6, K7): the flash kernels' and 256 (Gemma).
template <typename F>
cudaError_t with_cache_head_dim(int D, F fn) {
  if (D == 256) return fn(std::integral_constant<int, 256>{});
  return with_head_dim(D, fn);
}

// The sliding-window band of the cache-attention kernels (K5, K6, K7): a
// row whose causal limit is `limit` (the key positions it may see end
// there) keeps the keys after limit - window, so its first live key is
// band_lo = limit - window + 1, or 0 without a window (window <= 0); the
// JAX codecs' band_keep (dnn_tpu/runtime/kvcache.py:74).
__device__ __forceinline__ int band_lo(int limit, int window) {
  return window > 0 ? max(0, limit - window + 1) : 0;
}

// Gemma-2's attention-logit softcap, cap * tanh(s / cap), applied to a
// score in whatever units it is kept (the cap in the same units); tanhf,
// not tanh.approx, whose 2^-11 relative error would move a capped score by
// up to cap / 2000.
__device__ __forceinline__ float soft_cap(float s, float cap) {
  return cap * tanhf(s / cap);
}

// The query and output element type of the cache-attention kernels (K5,
// K6, K7): f32, or bf16 under bf16 compute. A bool template argument, so
// the build lines name it (kernel_label prints it as a trailing 0 / 1).
template <bool kBF16>
using Elem = typename std::conditional<kBF16, __nv_bfloat16, float>::type;

// fn(std::integral_constant<bool, q is bf16>) for q_kind 0 (f32) or 1
// (bf16).
template <typename F>
cudaError_t with_q_kind(int q_kind, F fn) {
  switch (q_kind) {
    case 0:
      return fn(std::integral_constant<bool, false>{});
    case 1:
      return fn(std::integral_constant<bool, true>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// Two and four consecutive outputs, stored in f32 or rounded to bf16.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, const float4& x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

namespace tc {

constexpr int kRows = 64;                // rows per warpgroup; keys per tile
constexpr int kWG = 2;                   // warpgroups per block
constexpr int kThreads = 128 * kWG;
constexpr int kBlockRows = kRows * kWG;  // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros when !in (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared through L1 (cp.async's only size for data that
// is 4-byte aligned); zeros when !in.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads and writes across the
// asynchronous wgmma (the asm statements above name no registers).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (each in 16-byte units) and the swizzle mode
// (0 none, 1 128-byte, 2 64-byte).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)mode << 62;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x = hi + lo in bf16 (to 2^-17 relative), for a pair of values packed as
// wgmma takes them.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

// Eight consecutive f32 values as one 16-byte chunk of hi and one of lo.
__device__ __forceinline__ void split8(const float4& a, const float4& b,
                                       uint4& hi, uint4& lo) {
  split2(a.x, a.y, hi.x, lo.x);
  split2(a.z, a.w, hi.y, lo.y);
  split2(b.x, b.y, hi.z, lo.z);
  split2(b.z, b.w, hi.w, lo.w);
}

// x rounded to TF32 (nearest, ties away), as the f32 bit pattern wgmma
// reads; the 13 bits below TF32's mantissa, which cvt leaves undefined,
// cleared.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y & 0xffffe000u;
}

// x = hi + lo in TF32 (to 2^-22 relative), four values.
__device__ __forceinline__ void split_tf32(const float4& x, uint4& hi,
                                           uint4& lo) {
  hi = make_uint4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
  lo = make_uint4(tf32(x.x - __uint_as_float(hi.x)),
                  tf32(x.y - __uint_as_float(hi.y)),
                  tf32(x.z - __uint_as_float(hi.z)),
                  tf32(x.w - __uint_as_float(hi.w)));
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, on one warpgroup. The
// accumulator fragment: thread (warp w, lane) holds rows 16w + lane/4
// (d[4j], d[4j+1]) and 16w + lane/4 + 8 (d[4j+2], d[4j+3]) at columns
// 8j + 2(lane%4) + {0, 1}. The A fragment from registers is the same
// per 16 x 16 slice: a[0] row r cols c, c+1; a[1] row r+8; a[2] row r cols
// c+8, c+9; a[3] row r+8 cols c+8, c+9.
template <int N>
struct Mma;

template <>
struct Mma<32> {
  // A from registers, B from shared memory MN-major (imm-trans-b 1).
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Mma<64> {
  // A and B from shared memory, both K-major.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }

  // m64n64k8, f32 += tf32 x tf32: A and B from shared memory, both
  // K-major (TF32 has no transpose). A k8 step spans 32 bytes of a row,
  // as a bf16 k16 step does, so an f32 tile of width D reads as a bf16
  // tile of width 2 D (Layout<2 D>).
  static __device__ __forceinline__ void ss_tf32(float (&d)[32], uint64_t a,
                                                 uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }

  // A from registers, B from shared memory MN-major (imm-trans-b 1).
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Mma<128> {
  // A from registers, B from shared memory MN-major (imm-trans-b 1).
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Mma<256> {
  // A from registers, B from shared memory MN-major (imm-trans-b 1): the
  // P.V product of K5 at head dim 256, all 256 output columns in one
  // instruction (128 accumulators a thread).
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

// The shared layout of a 64-row tile of a row-major (rows, D) bf16
// matrix, as wgmma's swizzled descriptors read it: rows of kAtom =
// min(128, 2 D) bytes (a row of 2 D bytes splits into 2 D / kAtom column
// blocks of 64 rows each), and within every 8-row atom the 16-byte chunks
// of a row XOR-permuted by the row (bits 4.. of the address ^= bits 7..),
// so that the 8 rows of an atom spread a chunk over all banks. Q and K
// tiles are read K-major (the k16 step kk starts 32 kk bytes into the
// row); V tiles, in the same layout, MN-major (the step kk starts at row
// 16 kk; the next 64 columns are the next column block).
template <int D>
struct Layout {
  static constexpr int kTile = kRows * D * 2;  // bytes of one tile
  static constexpr int kAtom = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kBits = kAtom == 128 ? 3 : 2;  // chunk bits permuted
  static constexpr uint32_t kMode = kAtom == 128 ? 1 : 2;  // SW128 | SW64
  static constexpr int kBlock = kRows * kAtom;  // bytes of one column block

  // Byte offset of 16-byte chunk c of row r.
  static __device__ __forceinline__ int offset(int r, int c) {
    constexpr int kPer = kAtom / 16;  // chunks per atom row
    const int lin = (c / kPer) * kBlock + r * kAtom + (c % kPer) * 16;
    return lin ^ (((lin >> 7) & ((1 << kBits) - 1)) << 4);
  }
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    const int byte = 32 * kk;
    return desc(base + (byte / kAtom) * kBlock + byte % kAtom, 16,
                8 * kAtom, kMode);
  }
  static __device__ __forceinline__ uint64_t mn_major(uint32_t base, int kk) {
    return desc(base + 16 * kk * kAtom, kBlock, 8 * kAtom, kMode);
  }
};

// Rows [r0, r0 + 64) of a row-major (len, D) bf16 matrix into a shared
// tile at `dst` (Layout<D>); rows at or past `len` are zeros. Consecutive
// threads copy consecutive 16-byte chunks of a row, so 8 of them read 128
// contiguous bytes and write one 128-byte line of the tile. kThr threads
// of the block take part (all of them by default).
template <int D, int kThr = kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* g, int r0,
                                          int len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int u = 0; u < kRows * kChunks / kThr; ++u) {
    const int i = (int)threadIdx.x + u * kThr;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < len;
    cp_async16(dst + Layout<D>::offset(r, c),
               g + (size_t)(in ? r0 + r : 0) * D + 8 * c, in);
  }
}

// Rows [r0, r0 + 64) of a row-major (len, D) matrix of T into shared
// memory at dst as stored (row-major, unswizzled), for a kernel to convert
// (cp.async cannot); rows at or past len are zeros. kThr threads of the
// block take part.
template <typename T, int D, int kThr = kThreads>
__device__ __forceinline__ void load_raw(uint32_t dst, const T* g, int r0,
                                         int len) {
  constexpr int kRowBytes = D * (int)sizeof(T);
  constexpr int kChunks = kRowBytes / 16;
  const char* gb = reinterpret_cast<const char*>(g);
#pragma unroll
  for (int u = 0; u < kRows * kChunks / kThr; ++u) {
    const int i = (int)threadIdx.x + u * kThr;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < len;
    cp_async16(dst + r * kRowBytes + 16 * c,
               gb + (size_t)(in ? r0 + r : 0) * kRowBytes + 16 * c, in);
  }
}

// 2^x on the SFU; flushes results below 2^-126 to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s = Q.K^T for one 64-key tile: D/16 steps of m64n64k16.
template <int D>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<64>::ss(s, Layout<D>::k_major(sq, kk), Layout<D>::k_major(sk, kk), kk);
}

// o += P.V for one 64-key tile: four steps of m64nDk16, P from registers.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], uint32_t (&pa)[4][4],
                                   uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Mma<D>::rs(o, pa[kk], Layout<D>::mn_major(sv, kk), 1);
}

// Sets a kernel's shared-memory attributes, once per kernel (the caller
// keeps `configured` in a static): `smem` bytes of dynamic shared memory,
// and all of L1 as shared memory (two blocks of 64 KB per SM at D = 64).
template <typename K>
cudaError_t configure(K kernel, int smem, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  configured = e == cudaSuccess;
  return e;
}

// P in bf16 as the A fragments of four k16 steps.
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);
}

// An f32 accumulator fragment (P, or dS) as the bf16 hi and lo A
// fragments of four k16 steps.
__device__ __forceinline__ void split_p(const float (&s)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pin(hi[kk]);
    pin(lo[kk]);
  }
}

// Rows [0, 64) of a row-major (rows, D) f32 tile at src (global or shared
// memory; rows at or past n read as zeros), split into operand tiles:
// TF32 hi, then lo, at t32 (Layout<2 D>) when kTF32; bf16 hi, then lo, at
// b16 (Layout<D>) when kBF16. kThr threads take part, each 8 consecutive
// values at a time.
template <int D, int kThr, bool kTF32, bool kBF16>
__device__ __forceinline__ void split_tile(const float* src, int n,
                                           unsigned char* t32,
                                           unsigned char* b16) {
  constexpr int kUnits = D / 8;
  // in a one-warpgroup block (D = 128) a thread splits 8 units of a
  // tile: two at a time, or their loads all in flight hold 64 registers
#pragma unroll(kThr == 128 ? 2 : kRows * kUnits / kThr)
  for (int u = 0; u < kRows * kUnits / kThr; ++u) {
    const int i = (int)threadIdx.x + u * kThr;
    const int r = i / kUnits, c = i % kUnits;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r < n) {
      const float4* p = reinterpret_cast<const float4*>(src + r * D + 8 * c);
      a = p[0];
      b = p[1];
    }
    if constexpr (kTF32) {
      uint4 hi, lo;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        split_tf32(h ? b : a, hi, lo);
        const int off = Layout<2 * D>::offset(r, 2 * c + h);
        *reinterpret_cast<uint4*>(t32 + off) = hi;
        *reinterpret_cast<uint4*>(t32 + Layout<2 * D>::kTile + off) = lo;
      }
    }
    if constexpr (kBF16) {
      uint4 hi, lo;
      split8(a, b, hi, lo);
      const int off = Layout<D>::offset(r, c);
      *reinterpret_cast<uint4*>(b16 + off) = hi;
      *reinterpret_cast<uint4*>(b16 + Layout<D>::kTile + off) = lo;
    }
  }
}

// s = A.B^T over head dim D from TF32 hi and lo tiles (lo a tile after hi,
// Layout<2 D>, both K-major): hi.lo + lo.hi + hi.hi, 3 D / 8 steps of
// m64n64k8; lo.lo, 2^-22 relative, is dropped. The small terms go first:
// the tensor cores add each step's products into the accumulator with
// truncation, an error of up to an ulp of the running sum a step, so the
// D / 8 steps of hi.hi, which bring the sum to full size, come last.
template <int D>
__device__ __forceinline__ void qk_tf32x3(float (&s)[32], uint32_t a,
                                          uint32_t b) {
  using L = Layout<2 * D>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    Mma<64>::ss_tf32(s, L::k_major(a, kk), L::k_major(b + L::kTile, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    Mma<64>::ss_tf32(s, L::k_major(a + L::kTile, kk), L::k_major(b, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    Mma<64>::ss_tf32(s, L::k_major(a, kk), L::k_major(b, kk), 1);
}

// acc += P.B for one 64-key tile, P split in registers into bf16 hi and
// lo, B's bf16 hi and lo tiles read MN-major: hi.lo + lo.hi + hi.hi.
template <int D>
__device__ __forceinline__ void pv_bf16x3(float (&acc)[D / 2],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4], uint32_t b) {
  pv<D>(acc, hi, b + Layout<D>::kTile);
  pv<D>(acc, lo, b);
  pv<D>(acc, hi, b);
}

}  // namespace tc
}  // namespace
