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
// The instructions are inline PTX, in hopper_tc.cuh beside the backward's
// (no CUTLASS or CuTe headers), so the library builds in seconds.
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

#include "hopper_tc.cuh"

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

constexpr int kStages = 3;               // depth of the K/V ring
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr int smem_bytes() {
  return (kWG + 2 * kStages) * Layout<D>::kTile;
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
  static bool configured = false;
  const cudaError_t e = configure(flash_fwd_tc_kernel<D>, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (T + kBlockRows - 1) / kBlockRows);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, T, S, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

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
