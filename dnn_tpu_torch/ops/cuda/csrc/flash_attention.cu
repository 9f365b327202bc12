// Flash-attention forward kernels (K1, K2) for Hopper, sm_90a.
//
// Replaces: dnn_tpu/ops/pallas/flash_attention.py:_flash_kernel (K1, the
// forward without a gradient) and :_fwd_lse_kernel (K2, the same forward
// plus the per-row logsumexp the backward recomputes from). One kernel
// per input type serves both: a null `lse` pointer is K1, a real one K2,
// and nothing else differs, so K1's output equals K2's bit for bit.
//
// What it computes: softmax(scale * q.k^T, masked) @ v for q (BH, T, D)
// and k/v (BH, S, D), scale = 1/sqrt(D). Causal masking is aligned
// bottom-right: query t sees keys <= t + (S - T), as the reference's
// tril(k=S-T); masked scores sit at -1e30. Output in the inputs' dtype;
// statistics in f32; lse = m + log(l) stored as a plain (BH, T) f32.
//
// bf16 (tc::flash_fwd_tc_kernel). What bounds it on an H100: bytes. At
// the training shape (BH=96, T=S=512, D=64, causal) q, k, v and out in
// bf16 are 25.2 MB, 0.0075 ms at 3.35 TB/s; the two products are 3.2
// GFLOP of live work, 0.0033 ms at the tensor cores' 989 TFLOP/s. What
// the design does about it:
//  * Both products run on the tensor cores as wgmma.mma_async m64nNk16
//    (f32 += bf16 x bf16). A block of two warpgroups (256 threads) owns
//    128 query rows, 64 per warpgroup, and both share each K/V tile, so
//    a tile is read from L2 once per 128 rows. S = Q.K^T reads Q and K
//    from shared memory (both K-major); O += P.V takes P from registers
//    and V from shared memory MN-major (imm-trans-b), so V needs no
//    transpose. wgmma, not mma.sync: it is the instruction that reaches
//    the card's full tensor-core rate, and it reads its B operand
//    straight from shared memory, with no ldmatrix.
//  * P never leaves registers: wgmma's accumulator fragment of S is,
//    pair by pair, the A fragment of the P.V product, so the f32
//    probabilities are rounded to bf16 in place (as JAX's
//    reference_attention casts p to v's dtype). Row max, exp, the
//    rescale alpha and the row sum l stay in f32 registers; l is summed
//    from the f32 probabilities. The scale is applied to the f32
//    accumulator (in log2 units, for exp2), never folded into a bf16 q.
//  * Within a warpgroup the softmax of tile j runs on the CUDA cores
//    while the tensor cores add P_{j-1}.V_{j-1} (the wgmma groups are
//    waited for one at a time).
//  * K and V tiles stream through a ring of kStages = 3 in shared memory,
//    as bf16, by cp.async (16 bytes a copy, zero-filled past S): tile
//    j + 1 is in flight while tile j is multiplied. Q is loaded once.
//    Tiles are stored in wgmma's 128-byte swizzled layout (64-byte for
//    D = 32): the 16-byte chunks of a row are XOR-permuted by the row, so
//    the tensor cores read 8 rows of a chunk from 8 different banks
//    (without the swizzle they wait on bank conflicts). Shared memory:
//    (2 + 2 kStages) x 64 x D x 2 bytes, 64 KB at D = 64.
//  * Blocks are issued heaviest first (blockIdx.x is the head, so every
//    head's last query tile is issued before any head's second-to-last)
//    and each warpgroup stops at the tile that holds its last live key,
//    as the TPU kernel's pl.when(live) skips dead blocks. Only tiles on
//    the causal diagonal or past S take the mask.
// The instructions are inline PTX (no CUTLASS or CuTe headers), so the
// library builds in seconds.
//
// f32 (flash_fwd_kernel). What bounds it: the f32 arithmetic. At the
// training shape the products are ~3.2 GFLOP, 0.048 ms at 67 TFLOP/s on
// the CUDA cores, against ~50 MB of q, k, v and out, 0.015 ms at
// 3.35 TB/s (3xTF32 on the tensor cores would lift that; a later
// redesign). The products are f32 FMAs with operands in shared memory,
// and the design aims at keeping the FMA pipes fed from there. The TPU
// kernel carries the online-softmax state across a SEQUENTIAL k grid axis
// in VMEM scratch and skips dead key blocks with pl.when. Hopper blocks
// run in parallel in no order, so each block owns kBQ = 64 query rows of
// one (batch, head) and loops over 64-key tiles itself, up to the tile
// that holds the block's last live column: that one bound replaces both
// the sequential axis and pl.when(live). Blocks are issued heaviest first
// (the last query tile of a causal row sees the most keys). 256 threads
// form a 16 x 16 grid; thread (ty, tx) owns the 4 x 4 patch of rows 4ty..
// and keys 4tx.. of every 64 x 64 score tile. q and k are staged d-major
// in shared memory, so each step of the dot product is one 16-byte load
// of 4 q values and one of 4 k values for 16 FMAs. Row max and row sum
// reduce over the 16 threads of a row by shuffles within a half warp;
// every thread of a row keeps the same (m, l). The probabilities go
// through shared memory (key-major) for P @ V, where the thread owns its
// 4 rows x D/16 output dims.
//
// Numerics (both): masked scores sit at -1e30 (not -inf) as in the
// reference and add exactly 0 to l and acc. Key 0 is live for every row
// (S >= T when causal, checked by the caller), and the first tile is
// always processed, so every row ends with a real maximum. Ragged T and
// S are masked here: rows past T and keys past S are staged as zeros and
// never stored. The f32 score is q.k times scale, as the reference
// divides q.k by sqrt(D): differences are at the ulp level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 patch of a tile

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, K/V through a cp.async ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 64;                // rows per warpgroup; keys per tile
constexpr int kWG = 2;                   // warpgroups per block
constexpr int kThreads = 128 * kWG;
constexpr int kBlockRows = kRows * kWG;  // query rows per block
constexpr int kStages = 3;               // depth of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
// contiguous bytes and write one 128-byte line of the tile.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* g, int r0,
                                          int len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int u = 0; u < kRows * kChunks / kThreads; ++u) {
    const int i = (int)threadIdx.x + u * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < len;
    cp_async16(dst + Layout<D>::offset(r, c),
               g + (size_t)(in ? r0 + r : 0) * D + 8 * c, in);
  }
}

template <int D>
constexpr int smem_bytes() {
  return (kWG + 2 * kStages) * Layout<D>::kTile;
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

// The online softmax of one tile of raw scores, in place: masks where
// `masked` (keys past S, or past the causal diagonal of rows t0 and
// t0 + 8), moves the row max m (log2 units) and returns in alpha the
// factor 2^(m_old - m_new) for O; s becomes p = 2^(s * scale2 - m), one
// FFMA and one ex2 each, and l (this thread's part of the row sum) takes
// alpha * l + the sum of p.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool masked, int k0, int t0,
                                             int c_lane, int S, int causal,
                                             int offset, float scale2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = k0 + 8 * (i / 4) + c_lane + (i & 1);
      const int t = t0 + 8 * ((i / 2) & 1);
      if (c >= S || (causal && c > t + offset)) s[i] = kNegBig;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegBig;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
      mx = fmaxf(mx, fmaxf(s[4 * jn + 2 * h], s[4 * jn + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m[h], mx * scale2);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * jn + 2 * h + e];
        x = ex2(fmaf(x, scale2, -m_new));
        sum += x;
      }
    l[h] = l[h] * alpha[h] + sum;
  }
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

// q (BH, T, D); k, v (BH, S, D); out (BH, T, D), all bf16; lse (BH, T) f32
// or null. Grid (BH, ceil(T / kBlockRows)), block kThreads, dynamic shared
// memory smem_bytes<D>(): kWG Q tiles, then kStages (K, V) tile pairs.
//
// Each warpgroup owns 64 query rows and runs the loop below over the K/V
// tiles it needs; all warpgroups of the block share the ring, and a
// warpgroup whose rows need fewer tiles (the first one on the causal
// diagonal) only waits at the block's barriers for the rest. Iteration
// j >= 1: tile j has landed; issue S_j = Q.K_j^T, then
// O += P_{j-1}.V_{j-1}; wait for S_j only, and run the softmax of S_j on
// the CUDA cores while the tensor cores add P_{j-1}.V_{j-1}; then wait
// for that, and rescale O by alpha_j. So O holds alpha_j * O_{j-1} after
// iteration j; tile 0 has no P.V before it, and the last P.V is added
// after the warpgroup's last tile. Tile j + 1 is loaded into the stage
// that tile j - 2 left, which no wgmma reads any more: kStages = 3.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int T, int S, int causal, float scale) {
  constexpr int kTile = Layout<D>::kTile;
  // 1024-byte aligned: the swizzle pattern repeats every 8 rows of 128 B
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sq = smem_addr(smem);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // heaviest first
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31;
  const int offset = S - T;
  const __nv_bfloat16* qb = q + (size_t)bh * T * D;
  const __nv_bfloat16* kb = k + (size_t)bh * S * D;
  const __nv_bfloat16* vb = v + (size_t)bh * S * D;
  auto tiles_to = [&](int first_row, int rows) {  // key tiles rows need
    const int last_row = min(T, first_row + rows) - 1;
    if (last_row < first_row) return 0;
    return (causal ? min(S - 1, last_row + offset) : S - 1) / kRows + 1;
  };
  const int n_tiles = tiles_to(q0, kBlockRows);  // the block's
  const int qw = q0 + kRows * wg;                // this warpgroup's rows
  const int my_tiles = tiles_to(qw, kRows);
  const uint32_t sqw = sq + kTile * wg;
  const float scale2 = scale * kLog2e;  // raw score -> log2 units
  const int t0 = qw + 16 * warp + (lane >> 2);  // this thread's rows t0, t0 + 8
  const int c_lane = 2 * (lane & 3);            // its first column of each 8

  auto stage = [&](int j) {
    return sq + kTile * (kWG + 2 * (j % kStages));
  };
  // Waits for tile j, then starts loading tile j + 1.
  auto next_tile = [&](int j) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile j landed; every warp is past iteration j - 1
    if (j + 1 < n_tiles) {
      load_tile<D>(stage(j + 1), kb, (j + 1) * kRows, S);
      load_tile<D>(stage(j + 1) + kTile, vb, (j + 1) * kRows, S);
      cp_async_commit();
    }
  };
  auto masked = [&](int j) {
    const int k0 = j * kRows;
    return k0 + kRows > S || (causal && k0 + kRows - 1 > qw + offset);
  };

#pragma unroll
  for (int w = 0; w < kWG; ++w)
    load_tile<D>(sq + kTile * w, qb, q0 + kRows * w, T);
  load_tile<D>(stage(0), kb, 0, S);
  load_tile<D>(stage(0) + kTile, vb, 0, S);
  cp_async_commit();

  // m: running row max in log2 units; l: this thread's part of the row sum
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, alpha[2];
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[32];
  uint32_t pa[4][4];  // P_{j-1} in bf16
  // O += P.V of the warpgroup's last tile j.
  auto finish = [&](int j) {
    wgmma_fence();
    pv<D>(o, pa, stage(j) + kTile);
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
  };

  next_tile(0);
  if (my_tiles > 0) {
    wgmma_fence();
    qk<D>(s, sqw, stage(0));
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    softmax_tile(s, m, l, alpha, masked(0), 0, t0, c_lane, S, causal, offset,
                 scale2);
    pack_p(s, pa);
  }
  for (int j = 1; j < n_tiles; ++j) {
    next_tile(j);
    if (j < my_tiles) {
      wgmma_fence();
      qk<D>(s, sqw, stage(j));
      wgmma_commit();
      pv<D>(o, pa, stage(j - 1) + kTile);
      wgmma_commit();
      wgmma_wait<1>();  // S_j is in s; P_{j-1}.V_{j-1} may still run
      pin(s);
      softmax_tile(s, m, l, alpha, masked(j), j * kRows, t0, c_lane, S,
                   causal, offset, scale2);
      wgmma_wait<0>();
      pin(o);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) & 1];
      pin(o);
      pack_p(s, pa);
    } else if (j == my_tiles) {
      finish(j - 1);  // tile j - 1 stays in the ring until the next barrier
    }
  }
  if (my_tiles == 0) return;
  if (my_tiles == n_tiles) finish(n_tiles - 1);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 8 * h;
    if (t >= T) continue;
    const float inv = 1.f / l[h];
    __nv_bfloat16* orow = out + ((size_t)bh * T + t) * D + c_lane;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) = __floats2bfloat162_rn(
          o[4 * c + 2 * h] * inv, o[4 * c + 2 * h + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * T + t] = m[h] * kLn2 + logf(l[h]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int BH, int T, int S, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    // all of L1 as shared memory: two blocks of 64 KB per SM at D = 64
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(BH, (T + kBlockRows - 1) / kBlockRows);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, T, S, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

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

}  // namespace

// C entry point (loaded with ctypes). kind: 0 = f32 q/k/v/out (CUDA-core
// kernel), 1 = bf16 (tensor-core kernel). lse: null for K1, a (BH, T) f32
// buffer for K2. Returns the launch's cudaError_t (0 = launched).
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
      return (int)with_head_dim(D, [&](auto d) {
        return launch<float, decltype(d)::value>(q, k, v, out, l, BH, T, S,
                                                 causal, scale, st);
      });
    case 1:
      return (int)with_head_dim(D, [&](auto d) {
        return tc::launch<decltype(d)::value>(q, k, v, out, l, BH, T, S,
                                              causal, scale, st);
      });
    default:
      return (int)cudaErrorInvalidValue;
  }
}
