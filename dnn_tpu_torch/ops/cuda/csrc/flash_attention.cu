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
// f32 (tc::flash_fwd_f32_tc_kernel). The same loop, on the tensor cores
// too, with the operands split so that the products keep f32 accuracy
// (1e-4 against the plain version), as the f32 backward splits them
// (csrc/flash_backward.cu). What bounds it on an H100: bytes. At the
// training shape q, k, v and out are 50.3 MB, 0.0150 ms at 3.35 TB/s;
// the two products, 1.61 GFLOP each of live work, take 0.0065 ms at the
// TF32 tensor cores' 494.7 TFLOP/s. The design issues each product as
// three, 4.8 GFLOP on TF32 and 4.8 on bf16, 0.0147 ms: about the bytes.
//  * S = Q.K^T runs as 3xTF32 (wgmma m64n64k8.f32.tf32.tf32, both
//    operands K-major from shared memory, an f32 tile laid out as a bf16
//    tile of width 2 D): hi = tf32(x), lo = tf32(x - hi), S = hi.lo +
//    lo.hi + hi.hi, the small terms issued first. The tensor cores
//    truncate each step's sum, up to an ulp of the running sum a step, so
//    the hi.hi steps, which bring S to full size, run in two chains (the
//    first and second half of the head dim, the second into its own
//    accumulator from zero), added on the CUDA cores: each chain reaches
//    about half of S. O += P.V runs as bf16 hi + lo, three products over
//    the bf16 kernel's MN-major read of V (TF32 has no MN-major operand,
//    so V needs no transposed tile): P is split in registers from S's f32
//    accumulator fragment, V's tile once a tile. l is summed from the f32
//    P. Why the mix: an error in S goes through exp, and the lse inherits
//    it (and passes it on into K3/K4's P = exp(s - lse)); P.V's only adds
//    up. Emulated at D = 64, T = S = 512, causal, as max |error| against
//    f64 of O / lse (tools/flash_split_numerics.py, which adds exactly):
//    S as bf16 hi + lo, q, k x 1 1.0e-5 / 5.5e-6, x 3 1.7e-4 / 1.7e-4,
//    x 4 3.0e-4 / 4.8e-4, over the 1e-4 limit; S as 3xTF32 (this design)
//    x 1 1.0e-5 / 8.2e-8, x 3 1.5e-5 / 2.3e-6, x 4 1.5e-5 / 4.1e-6, the
//    O error P.V's bf16 split. On an H100 at q, k x 4 (scores of tens,
//    lse up to ~93) the truncation dominates the lse: with hi.hi in one
//    chain the worst lse read 4.3e-5 against f64 at D = 128 (16 steps);
//    in two, 2.2e-5, below the plain f32 forward's own error there.
//  * Staging: cp.async cannot convert, so K and V tiles land raw in one
//    slot and are split at the top of their iteration, K into TF32 hi
//    and lo, V into bf16 hi and lo, while the next raw pair is in flight.
//    Q is split once from global memory into TF32 hi and lo. V's operand
//    tiles take two slots, so that tile j's split does not overwrite
//    V_{j-1} while P_{j-1}.V_{j-1} runs beside S_j's softmax, as in bf16.
//  * Shared memory, bytes a block: D = 32, two warpgroups, raw slot:
//    81920; D = 64, the same: 163840; D = 128, Q alone is 64 KB a
//    warpgroup, so one warpgroup a block and no raw slot (a tile is read
//    through registers and split at the top of its iteration, its load
//    not overlapped): 196608 of the 232448 a block may use.
//  * Registers: S's two accumulators, O and P's hi and lo fragments are
//    live across the P.V wgmma (128 at D = 64), so a block takes an SM
//    at every D (at D = 32 two blocks would cap a thread at 128
//    registers, where ptxas spilled and serialized the wgmma). Every
//    wgmma of a tile is issued and waited for under the same branch, so
//    ptxas does not serialize them; the first tile is peeled and the
//    warpgroup's last P.V is added in finish(), as in bf16.
//
// Numerics (both): masked scores sit at -1e30 (not -inf) as in the
// reference and add exactly 0 to l and O. Key 0 is live for every row
// (S >= T when causal, checked by the caller), and the first tile is
// always processed, so every row ends with a real maximum. Ragged T and
// S are masked here: rows past T and keys past S are staged as zeros and
// never stored. The score is multiplied by scale (in log2 units) in f32,
// as the reference divides q.k by sqrt(D): differences are at the ulp
// level.

#include "hopper_tc.cuh"

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// f32: split operands on the tensor cores, the bf16 loop
// ---------------------------------------------------------------------------

// A block of the f32 kernel, and its shared memory in bytes from the
// 1024-aligned base: per warpgroup its Q tile as TF32 hi and lo; the
// key tile's K as TF32 hi and lo; two slots of V as bf16 hi and lo (tile
// j's, and tile j - 1's, which P_{j-1}.V_{j-1} still reads); where kRaw,
// the next K and V tiles as stored, which cp.async fills while the
// current tile is multiplied.
template <int D>
struct F32 {
  static constexpr int kWG = D == 128 ? 1 : 2;  // warpgroups a block
  static constexpr int kThr = 128 * kWG;
  static constexpr int kBlockRows = kRows * kWG;
  static constexpr bool kRaw = D <= 64;
  static constexpr int kQ = 2 * Layout<2 * D>::kTile;  // TF32 hi, lo
  static constexpr int kV = 2 * Layout<D>::kTile;      // bf16 hi, lo
  static constexpr int kKOff = kWG * kQ;
  static constexpr int kVOff = kKOff + kQ;
  static constexpr int kRawOff = kVOff + 2 * kV;
  static constexpr int kBytes = kRawOff + (kRaw ? 2 * kRows * D * 4 : 0);
};

// s = Q.K^T as qk_tf32x3 issues it (hi.lo, lo.hi, then hi.hi, 3 D / 8
// steps of m64n64k8), but with the hi.hi steps over the second half of
// the head dim summed from zero into a second accumulator, s2. The tensor
// cores truncate each step's sum, an error of up to an ulp of the running
// sum a step; two chains that each reach about half the full sum halve
// that error. The caller adds s2 into s on the CUDA cores (rounded to
// nearest) once both are waited for.
template <int D>
__device__ __forceinline__ void qk_tf32x3_halves(float (&s)[32],
                                                 float (&s2)[32], uint32_t a,
                                                 uint32_t b) {
  using L = Layout<2 * D>;
  constexpr int kHalf = D / 16;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    Mma<64>::ss_tf32(s, L::k_major(a, kk), L::k_major(b + L::kTile, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    Mma<64>::ss_tf32(s, L::k_major(a + L::kTile, kk), L::k_major(b, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kHalf; ++kk)
    Mma<64>::ss_tf32(s, L::k_major(a, kk), L::k_major(b, kk), 1);
#pragma unroll
  for (int kk = kHalf; kk < D / 8; ++kk)
    Mma<64>::ss_tf32(s2, L::k_major(a, kk), L::k_major(b, kk), kk > kHalf);
}

template <int N>
__device__ __forceinline__ void add_into(float (&s)[N], const float (&s2)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] += s2[i];
}

// q (BH, T, D); k, v (BH, S, D); out (BH, T, D), all f32; lse (BH, T) or
// null. Grid (BH, ceil(T / F32<D>::kBlockRows)), block F32<D>::kThr,
// dynamic shared memory F32<D>::kBytes. Q is split once into TF32 hi and
// lo; per key tile the block splits K into TF32 and V into bf16 (V into
// slot j % 2), then each warpgroup runs the bf16 kernel's iteration with
// split products: S_j = Q.K_j^T as 3xTF32 (qk_tf32x3_halves), then O +=
// P_{j-1}.V_{j-1} as bf16 x3 (P split in registers into hi and lo, V
// read MN-major); waits for S_j only and runs its softmax while the
// tensor cores add P.V; then waits for that and rescales O by alpha_j.
// Every warp is past iteration j - 1 at the barrier that opens iteration
// j, so K's tile and the V slot of tile j - 2 are free to be overwritten.
template <int D>
__global__ void __launch_bounds__(F32<D>::kThr, 1)
flash_fwd_f32_tc_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int T, int S, int causal,
                        float scale) {
  using C = F32<D>;
  constexpr int kThr = C::kThr;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBlockRows;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31;
  const int offset = S - T;
  const size_t qoff = (size_t)bh * T * D, koff = (size_t)bh * S * D;
  auto tiles_to = [&](int first_row, int rows) {  // key tiles rows need
    const int last_row = min(T, first_row + rows) - 1;
    if (last_row < first_row) return 0;
    return (causal ? min(S - 1, last_row + offset) : S - 1) / kRows + 1;
  };
  const int n_tiles = tiles_to(q0, C::kBlockRows);  // the block's
  const int qw = q0 + kRows * wg;                   // this warpgroup's rows
  const int my_tiles = tiles_to(qw, kRows);
  const uint32_t sq = base + C::kQ * wg;  // Q TF32 hi, lo
  const uint32_t sk = base + C::kKOff;    // K TF32 hi, lo
  auto sv = [&](int j) { return base + C::kVOff + C::kV * (j % 2); };
  const float* raw = reinterpret_cast<const float*>(smem + C::kRawOff);
  const float scale2 = scale * kLog2e;  // raw score -> log2 units
  const int t0 = qw + 16 * warp + (lane >> 2);  // this thread's rows t0, t0 + 8
  const int c_lane = 2 * (lane & 3);            // its first column of each 8

  auto load = [&](int j) {  // starts copying K and V tile j as stored
    const uint32_t raw_k = base + C::kRawOff, raw_v = raw_k + kRows * D * 4;
    load_raw<float, D, kThr>(raw_k, k + koff, j * kRows, S);
    load_raw<float, D, kThr>(raw_v, v + koff, j * kRows, S);
    cp_async_commit();
  };
  // Splits key tile j into the operand tiles; then starts copying j + 1.
  auto stage = [&](int j) {
    const float *kt = raw, *vt = raw + kRows * D;
    int n = kRows;
    if constexpr (C::kRaw) {
      cp_async_wait_all();
    } else {
      kt = k + koff + (size_t)j * kRows * D;
      vt = v + koff + (size_t)j * kRows * D;
      n = S - j * kRows;
    }
    __syncthreads();  // tile j landed; every warp is past iteration j - 1
    split_tile<D, kThr, true, false>(kt, n, smem + C::kKOff, nullptr);
    split_tile<D, kThr, false, true>(vt, n, nullptr,
                                     smem + C::kVOff + C::kV * (j % 2));
    fence_async_smem();
    __syncthreads();  // the operand tiles are written; the raw pair is free
    if constexpr (C::kRaw)
      if (j + 1 < n_tiles) load(j + 1);
  };
  auto masked = [&](int j) {
    const int k0 = j * kRows;
    return k0 + kRows > S || (causal && k0 + kRows - 1 > qw + offset);
  };

  if constexpr (C::kRaw) load(0);
#pragma unroll
  for (int w = 0; w < C::kWG; ++w) {
    const int r0 = min(q0 + kRows * w, T);
    split_tile<D, kThr, true, false>(q + qoff + (size_t)r0 * D, T - r0,
                                     smem + C::kQ * w, nullptr);
  }

  // m: running row max in log2 units; l: this thread's part of the row sum
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, alpha[2];
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[32], s2[32];
  uint32_t ph[4][4], pl[4][4];  // P_{j-1} as bf16 hi + lo
  // O += P.V of the warpgroup's last tile j.
  auto finish = [&](int j) {
    wgmma_fence();
    pv_bf16x3<D>(o, ph, pl, sv(j));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
  };

  stage(0);
  if (my_tiles > 0) {
    wgmma_fence();
    qk_tf32x3_halves<D>(s, s2, sq, sk);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    pin(s2);
    add_into(s, s2);
    softmax_tile(s, m, l, alpha, masked(0), 0, t0, c_lane, S, causal, offset,
                 scale2);
    split_p(s, ph, pl);
  }
  for (int j = 1; j < n_tiles; ++j) {
    stage(j);
    if (j < my_tiles) {
      wgmma_fence();
      qk_tf32x3_halves<D>(s, s2, sq, sk);
      wgmma_commit();
      pv_bf16x3<D>(o, ph, pl, sv(j - 1));
      wgmma_commit();
      wgmma_wait<1>();  // S_j is in s, s2; P_{j-1}.V_{j-1} may still run
      pin(s);
      pin(s2);
      add_into(s, s2);
      softmax_tile(s, m, l, alpha, masked(j), j * kRows, t0, c_lane, S,
                   causal, offset, scale2);
      wgmma_wait<0>();
      pin(o);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) & 1];
      pin(o);
      split_p(s, ph, pl);
    } else if (j == my_tiles) {
      finish(j - 1);  // V_{j-1} stays in its slot until the next barrier
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
    float* orow = out + qoff + (size_t)t * D + c_lane;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(o[4 * c + 2 * h] * inv, o[4 * c + 2 * h + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * T + t] = m[h] * kLn2 + logf(l[h]);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int BH, int T, int S,
                       int causal, float scale, cudaStream_t stream) {
  using C = F32<D>;
  static bool configured = false;
  const cudaError_t e =
      configure(flash_fwd_f32_tc_kernel<D>, C::kBytes, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (T + C::kBlockRows - 1) / C::kBlockRows);
  flash_fwd_f32_tc_kernel<D><<<grid, C::kThr, C::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, T, S,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C entry point (loaded with ctypes). kind: 0 = f32 q/k/v/out, 1 = bf16
// (tensor-core kernels either way). lse: null for K1, a (BH, T) f32
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
        return tc::launch_f32<decltype(d)::value>(q, k, v, out, l, BH, T, S,
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
