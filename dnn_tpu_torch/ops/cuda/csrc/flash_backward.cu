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
// <= t + S - T). Outputs in the inputs' dtype, accumulation in f32. The
// JAX split is kept in both paths, so neither kernel needs atomics and
// both are deterministic (a resumed training run reproduces an
// uninterrupted one bit for bit): K3 accumulates dQ over key tiles, K4
// dK and dV over query tiles. ONE device function, pds() under the one
// mask live(), rebuilds P and dS for both kernels in both types (as
// _recompute_pds is shared in JAX), so K3 and K4 cannot disagree on
// masking or scaling. Ragged T and S: rows
// past T and keys past S are loaded as zeros, masked out of P and never
// stored.
//
// bf16 (tc::flash_bwd_dq_tc_kernel, tc::flash_bwd_dkv_tc_kernel). What
// bounds them on an H100: bytes. At the training shape (BH=96, T=S=512,
// D=64, causal) K3 reads q, k, v, dO and writes dQ, 31.5 MB in bf16 plus
// 0.4 MB of lse and D: 0.0095 ms at 3.35 TB/s; K4 moves one tensor more,
// 0.0114 ms. Their products, 6 and 8 x D flops per live (row, key) pair
// (4.8 and 6.5 GFLOP), take 0.0049 / 0.0065 ms at the tensor cores' 989
// TFLOP/s. What the design does about it (the forward's, csrc/
// flash_attention.cu, with the building blocks of hopper_tc.cuh):
//  * All five products run on the tensor cores as wgmma m64nNk16 (f32 +=
//    bf16 x bf16), two warpgroups (256 threads) a block, each owning 64
//    rows of the product, so a streamed tile is read from L2 once per 128
//    rows. K3: a block owns 128 query rows; S = Q.K^T and dP = dO.V^T
//    read both operands from shared memory (K-major) and are issued
//    together; dQ += dS.K takes dS from registers and K's tile MN-major,
//    the same copy as S read K-major, so K needs no transposed copy.
//  * K4 computes the transposed tile, so that P and dS never leave
//    registers: a block owns 128 keys; S^T = K.Q^T and dP^T = V.dO^T give
//    an accumulator whose rows are keys and columns query rows, which is,
//    pair by pair, the A fragment of dV += P^T.dO and dK += dS^T.Q (dO and
//    Q read MN-major). lse and D are indexed by column there, from a row
//    of 64 f32 each staged beside the query tile.
//  * P and dS are formed in f32 registers by pds() under the one mask
//    predicate live(), and rounded to bf16 in place as A fragments.
//  * The streamed tiles (K3: K and V; K4: Q, dO, lse and D) arrive by
//    cp.async into a ring of kStages = 2 in wgmma's swizzled layout (zeros
//    past T or S): tile j + 1 is in flight while tile j is multiplied.
//    Every wgmma of tile j is waited for within its iteration, so two
//    stages suffice. (Overlapping tile j's element work with tile j - 1's
//    accumulation, as the forward does, and rings of 3 or 4 stages
//    prefetching further ahead timed no faster on an H100 at the training
//    shape, so the plain loop stays.) The resident tiles (K3: Q and dO;
//    K4: K and V) are loaded once. Shared memory (2 + 2 kStages) x 64 x
//    D x 2 bytes per warpgroup pair (64 KB at D = 64; K4 adds 1 KB of lse
//    and D).
//  * Heaviest blocks first (K3: the last query rows; K4: the first keys),
//    each warpgroup skips the tiles it has no live pair in while keeping
//    the block's barriers, and only tiles on the causal diagonal or past
//    T or S take the mask.
//  * Registers: K3 holds S, dP and dQ (96 f32 at D = 64) and runs two
//    blocks an SM up to D = 64; K4 holds S^T, dP^T, dK and dV (128 at
//    D = 64) and runs one block an SM above D = 32.
// Numerics: q, k, v and dO enter the products as exact bf16 values; S, dP
// and every accumulator are f32; the scale multiplies the f32 score (in
// log2 units, for ex2), never a bf16 q. P and dS are rounded to bf16 to
// feed the second products (JAX's kernel keeps them in f32): at most
// 2^-9 relative per term, this path's only error beyond summation order.
// dQ and dK are multiplied by `scale` once, at the end.
//
// f32 (tc::flash_bwd_dq_f32_tc_kernel, tc::flash_bwd_dkv_f32_tc_kernel).
// The same loops, on the tensor cores too, with every operand split so
// that the products keep f32 accuracy (1e-4 x the gradient's max). What
// bounds them on an H100: bytes. At the training shape K3 moves 63.3 MB
// (0.0189 ms at 3.35 TB/s) and K4 75.9 MB (0.0227 ms); each product of
// the backward is 2 D flops per live pair, 1.61 GFLOP, so K3's three
// and K4's four take 0.0098 / 0.0130 ms at the TF32 tensor cores' 494.7
// TFLOP/s. This design issues each product as three (the score product
// on TF32, the others on bf16 at 989): 0.0196 ms for K3 and 0.0245 for
// K4, above the bytes, so the split itself costs time.
//  * The score product (S = Q.K^T in K3, S^T = K.Q^T in K4) runs as
//    3xTF32, wgmma m64n64k8.f32.tf32.tf32 with both operands K-major from
//    shared memory: hi = tf32(x), lo = tf32(x - hi) (round to nearest),
//    S = hi.hi + hi.lo + lo.hi. An f32 row of D values is 4 D bytes and a
//    k8 step 32 of them, so an f32 tile is laid out and addressed as a
//    bf16 tile of width 2 D (Layout<2 D>).
//  * The other products run as bf16 hi + lo (x = hi + lo to 2^-17), three
//    products each, over the bf16 backward's helpers: dP and dP^T
//    (K-major), and dQ += dS.K, dV += P^T.dO, dK += dS^T.Q with P and dS
//    split in registers into hi and lo A fragments and K, dO, Q read
//    MN-major. Why the mix: an error in S goes through exp, the others'
//    only add up. Emulated at D = 64, T = S = 512, causal, with q and k
//    x 4 (scores of tens), as max |error| / max |gradient| against f64
//    for dQ / dK / dV (tools/flash_split_numerics.py): bf16 hi + lo in every product 1.4e-4 / 1.3e-4 / 1.7e-4,
//    over the 1e-4 limit; S as 3xTF32 and the rest bf16 hi + lo (this
//    design) 1.3e-5 / 2.0e-5 / 5.1e-6; 3xTF32 throughout 2.2e-6 /
//    2.1e-6 / 1.8e-6. 3xTF32 throughout would need K (K3) and Q and dO
//    (K4) again as transposed TF32 tiles, since TF32 has no transposed
//    (MN-major) operand: more shared memory and half the rate of bf16.
//    On the card the tensor cores add each k-step's products into the
//    accumulator with truncation, which the emulation leaves out: issued
//    hi.hi first, the score product's running sum took up to an ulp a
//    step over 3 D / 8 steps, and K4 at D = 128 read dK 1.1e-4 x its max
//    with q, k x 4; so every split product issues its small terms first
//    and hi.hi last (D / 8 truncations of a full-size sum). So issued, on
//    an H100 at q, k x 4 over four seeds, D 32 / 64 / 128, causal and
//    full, T = S = 512 and T = 65 S = 1000, the worst gradient read
//    2.9e-5 / 3.0e-5 / 4.6e-5 x its max against the plain f32 backward
//    and 2.9e-5 / 2.6e-5 / 3.3e-5 against it in f64: the kernels' own
//    error barely grows with D; what grows at D = 128 is the f32
//    reference's.
//  * Staging: cp.async cannot convert, so a streamed tile lands raw (K3:
//    K and V; K4: Q, dO, and lse and D as in bf16) and is split once per
//    tile into the operand tiles: the score side into TF32 hi, lo and
//    bf16 hi, lo (K3: K; K4: Q, each read by two products), the other
//    into bf16 hi, lo. The raw pair is split at the top of the tile's
//    iteration, so one raw slot suffices: tile j + 1 is copied into it
//    while tile j is multiplied. The resident tiles (K3: Q as TF32, dO as
//    bf16; K4: K as TF32, V as bf16) are split once from global memory.
//  * Shared memory, bytes a block (K3 / K4; K4 adds two slots of 64 lse
//    and 64 D): D = 32, two warpgroups, raw slot: 98304 / 99328 (K3 two
//    blocks an SM); D = 64, the same: 196608 / 197632, one block; D = 128
//    the resident pair alone is 96 KB a warpgroup and the operand tiles
//    128 KB, so one warpgroup a block and no raw slot (a tile is read
//    through registers and split at the top of its iteration, its load
//    not overlapped): 229376 / 230400 of the 232448 a block may use.
//  * Registers (K3 / K4): D = 32 121 / 178, D = 64 161 / 231, D = 128
//    190 / 255, no spills; K4 takes one block an SM at D = 32 too (two
//    would cap it at 128 registers, where ptxas spilled and serialized
//    its wgmma), and at D = 128 a thread splits two units of a tile at a
//    time (all in flight, K3 and K4 spilled). Every wgmma of a tile is
//    issued and waited for under the same branch, so ptxas does not
//    serialize them.

#include "hopper_tc.cuh"

namespace {

bool bad_shape(int BH, int T, int S, int causal) {
  return BH <= 0 || T <= 0 || S <= 0 || BH > 65535 || (causal && S < T);
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, tiles through a cp.async ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kStages = 2;  // depth of the ring of streamed tiles

// THE mask of the backward, shared by K3 and K4 in both types: query row
// t sees key c (both in range; causal aligned bottom-right, offset = S - T).
__device__ __forceinline__ bool live(int t, int c, int T, int S, int causal,
                                     int offset) {
  return t < T && c < S && (!causal || c <= t + offset);
}

// THE element function of the backward, shared by K3 and K4 in both
// types, in place: the raw score s becomes p = exp(scale * s - lse), 0
// where !lv, computed as 2^(s * scale2 - lse * log2 e) (scale2 = scale *
// log2 e), and dp becomes ds = p * (dp - di).
__device__ __forceinline__ void pds(float& s, float& dp, float lse, float di,
                                    bool lv, float scale2) {
  const float p = lv ? ex2(fmaf(s, scale2, -lse * kLog2e)) : 0.f;
  s = p;
  dp = p * (dp - di);
}

// K3's tile: rows are the thread's query rows t0 and t0 + 8 (their lse
// and D in registers), element i sits at key k0 + 8 (i / 4) + c_lane +
// (i & 1) of the accumulator fragment (hopper_tc.cuh, Mma).
template <bool kMasked>
__device__ __forceinline__ void dq_tile_pds(float (&s)[32], float (&dp)[32],
                                            const float (&lse)[2],
                                            const float (&di)[2], int t0,
                                            int k0, int c_lane, int T, int S,
                                            int causal, int offset,
                                            float scale2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i / 2) & 1;
    const bool lv = !kMasked || live(t0 + 8 * h, k0 + 8 * (i / 4) + c_lane +
                                                     (i & 1),
                                     T, S, causal, offset);
    pds(s[i], dp[i], lse[h], di[h], lv, scale2);
  }
}

// K4's transposed tile: rows are the thread's keys c0 and c0 + 8, element
// 4j + u sits at query row qt0 + 8j + c_lane + (u & 1) (row c0 + 8 (u / 2));
// lse and D of the tile's 64 query rows come from shared memory.
template <bool kMasked>
__device__ __forceinline__ void dkv_tile_pds(float (&s)[32], float (&dp)[32],
                                             const float* lse_s,
                                             const float* di_s, int c0,
                                             int qt0, int c_lane, int T,
                                             int S, int causal, int offset,
                                             float scale2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + c_lane;
    const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
    const float2 d = *reinterpret_cast<const float2*>(di_s + col);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = u & 1;
      const bool lv =
          !kMasked || live(qt0 + col + e, c0 + 8 * (u / 2), T, S, causal,
                           offset);
      pds(s[4 * j + u], dp[4 * j + u], e ? l.y : l.x, e ? d.y : d.x, lv,
          scale2);
    }
  }
}

// The 64 x D bf16 accumulator rows r0 and r0 + 8 (those < len) of `acc`
// times `mul` into row-major `out`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2], int r0,
                                           int len, int c_lane, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= len) continue;
    __nv_bfloat16* row = out + (size_t)r * D + c_lane;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c) = __floats2bfloat162_rn(
          acc[4 * c + 2 * h] * mul, acc[4 * c + 2 * h + 1] * mul);
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kWG + 2 * kStages) * Layout<D>::kTile;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kWG + 2 * kStages) * Layout<D>::kTile +
         kStages * 2 * kRows * (int)sizeof(float);
}

// K3. q, do (BH, T, D); k, v (BH, S, D); lse, di (BH, T) f32; dq (BH, T,
// D); all tensors bf16. Grid (BH, ceil(T / kBlockRows)), block kThreads,
// dynamic shared memory dq_smem_bytes<D>(): kWG Q tiles, kWG dO tiles,
// then kStages (K, V) tile pairs. Per key tile j a warpgroup that has a
// live pair in it issues S = Q.K_j^T and dP = dO.V_j^T, waits, forms P
// and dS, and adds dS.K_j to dQ; the first warpgroup on the causal
// diagonal needs one tile fewer and only keeps the barriers for it.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di,
                       __nv_bfloat16* __restrict__ dq, int T, int S,
                       int causal, float scale) {
  constexpr int kTile = Layout<D>::kTile;
  // 1024-byte aligned: the swizzle pattern repeats every 8 rows of 128 B
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // heaviest first
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31;
  const int offset = S - T;
  const size_t qoff = (size_t)bh * T * D, koff = (size_t)bh * S * D;
  auto tiles_to = [&](int first_row, int rows) {  // key tiles rows need
    const int last_row = min(T, first_row + rows) - 1;
    if (last_row < first_row) return 0;
    return (causal ? min(S - 1, last_row + offset) : S - 1) / kRows + 1;
  };
  const int n_tiles = tiles_to(q0, kBlockRows);  // the block's
  const int qw = q0 + kRows * wg;                // this warpgroup's rows
  const int my_tiles = tiles_to(qw, kRows);
  const uint32_t sq = base + kTile * wg, sdo = base + kTile * (kWG + wg);
  const float scale2 = scale * kLog2e;
  const int t0 = qw + 16 * warp + (lane >> 2);  // this thread's rows t0, t0 + 8
  const int c_lane = 2 * (lane & 3);            // its first column of each 8

  auto stage = [&](int j) {
    return base + kTile * (2 * kWG + 2 * (j % kStages));
  };
  // Waits for tile j, then starts loading tile j + 1.
  auto next_tile = [&](int j) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile j landed; every warp is past iteration j - 1
    if (j + 1 < n_tiles) {
      load_tile<D>(stage(j + 1), k + koff, (j + 1) * kRows, S);
      load_tile<D>(stage(j + 1) + kTile, v + koff, (j + 1) * kRows, S);
      cp_async_commit();
    }
  };
  auto masked = [&](int j) {
    const int k0 = j * kRows;
    return k0 + kRows > S || qw + kRows > T ||
           (causal && k0 + kRows - 1 > qw + offset);
  };

#pragma unroll
  for (int w = 0; w < kWG; ++w) {
    load_tile<D>(base + kTile * w, q + qoff, q0 + kRows * w, T);
    load_tile<D>(base + kTile * (kWG + w), dout + qoff, q0 + kRows * w, T);
  }
  load_tile<D>(stage(0), k + koff, 0, S);
  load_tile<D>(stage(0) + kTile, v + koff, 0, S);
  cp_async_commit();

  float lse_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 8 * h;
    lse_r[h] = t < T ? lse[(size_t)bh * T + t] : 0.f;
    di_r[h] = t < T ? di[(size_t)bh * T + t] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t da[4][4];  // dS in bf16

  for (int j = 0; j < n_tiles; ++j) {
    next_tile(j);
    if (j >= my_tiles) continue;
    wgmma_fence();
    qk<D>(s, sq, stage(j));
    qk<D>(dp, sdo, stage(j) + kTile);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    pin(dp);
    if (masked(j))
      dq_tile_pds<true>(s, dp, lse_r, di_r, t0, j * kRows, c_lane, T, S,
                        causal, offset, scale2);
    else
      dq_tile_pds<false>(s, dp, lse_r, di_r, t0, j * kRows, c_lane, T, S,
                         causal, offset, scale2);
    pack_p(dp, da);
    wgmma_fence();
    pv<D>(acc, da, stage(j));  // dQ += dS.K, K's tile read MN-major
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
  }
  if (my_tiles == 0) return;
  store_rows<D>(dq + qoff, acc, t0, T, c_lane, scale);
}

// K4. Shapes as K3; dk, dv (BH, S, D) bf16. Grid (BH, ceil(S /
// kBlockRows)), block kThreads, dynamic shared memory dkv_smem_bytes<D>():
// kWG K tiles, kWG V tiles, kStages (Q, dO) tile pairs, then kStages rows
// of 64 lse and 64 D. The block's keys see query tiles j0.. (for causal
// the first live row is max(0, k0 - (S - T))); per query tile a
// warpgroup with a live pair in it issues S^T = K.Q^T and dP^T = V.dO^T,
// waits, forms P^T and dS^T, and adds P^T.dO to dV and dS^T.Q to dK. On
// the causal diagonal the second warpgroup starts a tile later and only
// keeps the barriers until then.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 32 ? 2 : 1)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int T, int S,
                        int causal, float scale) {
  constexpr int kTile = Layout<D>::kTile;
  constexpr int kStats = (2 * kWG + 2 * kStages) * kTile;  // byte offset
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const float* stats = reinterpret_cast<const float*>(smem + kStats);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;  // heaviest first: the first keys
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31;
  const int offset = S - T;
  const size_t qoff = (size_t)bh * T * D, koff = (size_t)bh * S * D;
  auto first_tile = [&](int key) {  // the first query tile that sees key
    return causal ? max(0, key - offset) / kRows : 0;
  };
  const int j0 = first_tile(k0);
  const int n_tiles = (T + kRows - 1) / kRows - j0;  // the block's
  const int kw = k0 + kRows * wg;                    // this warpgroup's keys
  const int my_first = kw < S ? first_tile(kw) - j0 : n_tiles;
  const uint32_t sk = base + kTile * wg, sv = base + kTile * (kWG + wg);
  const float scale2 = scale * kLog2e;
  const int c0 = kw + 16 * warp + (lane >> 2);  // this thread's keys c0, c0 + 8
  const int c_lane = 2 * (lane & 3);  // its first query row of each 8

  auto stage = [&](int i) {
    return base + kTile * (2 * kWG + 2 * (i % kStages));
  };
  auto stats_at = [&](int i) { return (i % kStages) * 2 * kRows; };
  // Query tile j0 + i: Q, dO, then 64 lse and 64 D (4-byte copies: a row
  // of lse starts at any multiple of 4 bytes).
  auto load_query_tile = [&](int i) {
    const int qt0 = (j0 + i) * kRows;
    load_tile<D>(stage(i), q + qoff, qt0, T);
    load_tile<D>(stage(i) + kTile, dout + qoff, qt0, T);
    if (threadIdx.x < 2 * kRows) {
      const int r = threadIdx.x % kRows;
      const bool in = qt0 + r < T;
      const float* src = threadIdx.x < kRows ? lse : di;
      cp_async4(base + kStats + 4 * (stats_at(i) + threadIdx.x),
                src + (size_t)bh * T + (in ? qt0 + r : 0), in);
    }
    cp_async_commit();
  };
  // Waits for tile i, then starts loading tile i + 1.
  auto next_tile = [&](int i) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile i landed; every warp is past iteration i - 1
    if (i + 1 < n_tiles) load_query_tile(i + 1);
  };
  auto masked = [&](int i) {
    const int qt0 = (j0 + i) * kRows;
    return qt0 + kRows > T || kw + kRows > S ||
           (causal && kw + kRows - 1 > qt0 + offset);
  };

#pragma unroll
  for (int w = 0; w < kWG; ++w) {
    load_tile<D>(base + kTile * w, k + koff, k0 + kRows * w, S);
    load_tile<D>(base + kTile * (kWG + w), v + koff, k0 + kRows * w, S);
  }
  load_query_tile(0);  // commits the K and V tiles with it

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4], da[4][4];  // P^T and dS^T in bf16

  for (int i = 0; i < n_tiles; ++i) {
    next_tile(i);
    if (i < my_first) continue;
    wgmma_fence();
    qk<D>(s, sk, stage(i));             // S^T = K.Q^T
    qk<D>(dp, sv, stage(i) + kTile);    // dP^T = V.dO^T
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    pin(dp);
    const float* st = stats + stats_at(i);
    const int qt0 = (j0 + i) * kRows;
    if (masked(i))
      dkv_tile_pds<true>(s, dp, st, st + kRows, c0, qt0, c_lane, T, S,
                         causal, offset, scale2);
    else
      dkv_tile_pds<false>(s, dp, st, st + kRows, c0, qt0, c_lane, T, S,
                          causal, offset, scale2);
    pack_p(s, pa);
    pack_p(dp, da);
    wgmma_fence();
    pv<D>(adv, pa, stage(i) + kTile);  // dV += P^T.dO, dO read MN-major
    pv<D>(adk, da, stage(i));          // dK += dS^T.Q, Q read MN-major
    wgmma_commit();
    wgmma_wait<0>();
    pin(adv);
    pin(adk);
  }
  if (my_first >= n_tiles) return;
  store_rows<D>(dk + koff, adk, c0, S, c_lane, scale);
  store_rows<D>(dv + koff, adv, c0, S, c_lane, 1.f);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int BH, int T, int S, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  static bool configured = false;
  const cudaError_t e =
      configure(flash_bwd_dq_tc_kernel<D>, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (T + kBlockRows - 1) / kBlockRows);
  using bf = __nv_bfloat16;
  flash_bwd_dq_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, di,
      static_cast<bf*>(dq), T, S, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int BH, int T, int S, int causal,
                       float scale, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  static bool configured = false;
  const cudaError_t e =
      configure(flash_bwd_dkv_tc_kernel<D>, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (S + kBlockRows - 1) / kBlockRows);
  using bf = __nv_bfloat16;
  flash_bwd_dkv_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, di,
      static_cast<bf*>(dk), static_cast<bf*>(dv), T, S, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: split operands on the tensor cores
// ---------------------------------------------------------------------------

// A block of the f32 kernels, and its shared memory in bytes from the
// 1024-aligned base: per warpgroup its resident tiles (one tensor as TF32
// hi and lo, the other as bf16 hi and lo); the operand tiles of the
// streamed tile (the first tensor as TF32 hi, lo and bf16 hi, lo, the
// second as bf16 hi, lo); where kRaw, the streamed pair as stored, which
// cp.async fills while the previous tile is multiplied; then (K4) two
// slots of 64 lse and 64 D.
template <int D>
struct F32 {
  static constexpr int kWG = D == 128 ? 1 : 2;  // warpgroups a block
  static constexpr int kThr = 128 * kWG;
  static constexpr int kBlockRows = kRows * kWG;
  static constexpr bool kRaw = D <= 64;
  static constexpr int kT32 = kRows * D * 4;  // a TF32 tile, Layout<2 D>
  static constexpr int kB16 = kRows * D * 2;  // a bf16 tile, Layout<D>
  static constexpr int kResident = 2 * kT32 + 2 * kB16;
  static constexpr int kOps = kWG * kResident;
  static constexpr int kRawOff = kOps + 2 * kT32 + 4 * kB16;
  static constexpr int kStats = kRawOff + (kRaw ? 2 * kRows * D * 4 : 0);
  static constexpr int kBytes = kStats + 2 * 2 * kRows * 4;
};

// The same from bf16 hi and lo tiles (Layout<D>): 3 D / 16 steps of
// m64n64k16, small terms first.
template <int D>
__device__ __forceinline__ void qk_bf16x3(float (&s)[32], uint32_t a,
                                          uint32_t b) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<64>::ss(s, L::k_major(a, kk), L::k_major(b + L::kTile, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<64>::ss(s, L::k_major(a + L::kTile, kk), L::k_major(b, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<64>::ss(s, L::k_major(a, kk), L::k_major(b, kk), 1);
}

// The 64 x D f32 accumulator rows r0 and r0 + 8 (those < len) of `acc`
// times `mul` into row-major `out`.
template <int D>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[D / 2], int r0,
                                           int len, int c_lane, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= len) continue;
    float* row = out + (size_t)r * D + c_lane;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(row + 8 * c) = make_float2(
          acc[4 * c + 2 * h] * mul, acc[4 * c + 2 * h + 1] * mul);
  }
}

// K3 in f32. Shapes as the bf16 K3, all tensors f32. Grid (BH, ceil(T /
// F32<D>::kBlockRows)), block F32<D>::kThr, dynamic shared memory
// F32<D>::kStats. Q (TF32) and dO (bf16) are split once; per key tile the
// block splits K into TF32 and bf16 and V into bf16, then a warpgroup with
// a live pair in the tile issues S = Q.K^T (3xTF32) and dP = dO.V^T (bf16
// x3), waits, forms P and dS, splits dS in registers and adds dS.K (bf16
// x3, K read MN-major) to dQ.
template <int D>
__global__ void __launch_bounds__(F32<D>::kThr, D == 32 ? 2 : 1)
flash_bwd_dq_f32_tc_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           float* __restrict__ dq, int T, int S, int causal,
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
  const uint32_t sq = base + C::kResident * wg;  // Q TF32 hi, lo
  const uint32_t sdo = sq + 2 * C::kT32;         // dO bf16 hi, lo
  const uint32_t sk = base + C::kOps;            // K TF32 hi, lo
  const uint32_t sk16 = sk + 2 * C::kT32;        // K bf16 hi, lo
  const uint32_t sv16 = sk16 + 2 * C::kB16;      // V bf16 hi, lo
  const float* raw = reinterpret_cast<const float*>(smem + C::kRawOff);
  const float scale2 = scale * kLog2e;
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
    split_tile<D, kThr, true, true>(kt, n, smem + C::kOps,
                                    smem + C::kOps + 2 * C::kT32);
    split_tile<D, kThr, false, true>(vt, n, nullptr,
                                     smem + C::kOps + 2 * C::kT32 +
                                         2 * C::kB16);
    fence_async_smem();
    __syncthreads();  // the operand tiles are written; the raw pair is free
    if constexpr (C::kRaw)
      if (j + 1 < n_tiles) load(j + 1);
  };
  auto masked = [&](int j) {
    const int k0 = j * kRows;
    return k0 + kRows > S || qw + kRows > T ||
           (causal && k0 + kRows - 1 > qw + offset);
  };

  if constexpr (C::kRaw) load(0);
#pragma unroll
  for (int w = 0; w < C::kWG; ++w) {
    const int r0 = min(q0 + kRows * w, T);
    unsigned char* res = smem + C::kResident * w;
    split_tile<D, kThr, true, false>(q + qoff + (size_t)r0 * D, T - r0, res,
                                     nullptr);
    split_tile<D, kThr, false, true>(dout + qoff + (size_t)r0 * D, T - r0,
                                     nullptr, res + 2 * C::kT32);
  }

  float lse_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 8 * h;
    lse_r[h] = t < T ? lse[(size_t)bh * T + t] : 0.f;
    di_r[h] = t < T ? di[(size_t)bh * T + t] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t dh[4][4], dl[4][4];  // dS as bf16 hi + lo

  for (int j = 0; j < n_tiles; ++j) {
    stage(j);
    if (j >= my_tiles) continue;
    wgmma_fence();
    qk_tf32x3<D>(s, sq, sk);
    qk_bf16x3<D>(dp, sdo, sv16);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    pin(dp);
    if (masked(j))
      dq_tile_pds<true>(s, dp, lse_r, di_r, t0, j * kRows, c_lane, T, S,
                        causal, offset, scale2);
    else
      dq_tile_pds<false>(s, dp, lse_r, di_r, t0, j * kRows, c_lane, T, S,
                         causal, offset, scale2);
    split_p(dp, dh, dl);
    wgmma_fence();
    pv_bf16x3<D>(acc, dh, dl, sk16);  // dQ += dS.K
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
  }
  if (my_tiles == 0) return;
  store_rows<D>(dq + qoff, acc, t0, T, c_lane, scale);
}

// K4 in f32. Shapes as K3; dk, dv (BH, S, D) f32. Grid (BH, ceil(S /
// F32<D>::kBlockRows)), block F32<D>::kThr, dynamic shared memory
// F32<D>::kBytes. K (TF32) and V (bf16) are split once; per query tile
// the block splits Q into TF32 and bf16 and dO into bf16 and stages the
// tile's 64 lse and D, then a warpgroup with a live pair in the tile
// issues S^T = K.Q^T (3xTF32) and dP^T = V.dO^T (bf16 x3), waits, forms
// P^T and dS^T, splits both in registers, and adds P^T.dO to dV and
// dS^T.Q to dK (bf16 x3 each, dO and Q read MN-major).
template <int D>
__global__ void __launch_bounds__(F32<D>::kThr, 1)
flash_bwd_dkv_f32_tc_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int T, int S, int causal, float scale) {
  using C = F32<D>;
  constexpr int kThr = C::kThr;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  float* stats = reinterpret_cast<float*>(smem + C::kStats);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * C::kBlockRows;  // heaviest first: the first keys
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31;
  const int offset = S - T;
  const size_t qoff = (size_t)bh * T * D, koff = (size_t)bh * S * D;
  auto first_tile = [&](int key) {  // the first query tile that sees key
    return causal ? max(0, key - offset) / kRows : 0;
  };
  const int j0 = first_tile(k0);
  const int n_tiles = (T + kRows - 1) / kRows - j0;  // the block's
  const int kw = k0 + kRows * wg;                    // this warpgroup's keys
  const int my_first = kw < S ? first_tile(kw) - j0 : n_tiles;
  const uint32_t sk = base + C::kResident * wg;  // K TF32 hi, lo
  const uint32_t sv = sk + 2 * C::kT32;          // V bf16 hi, lo
  const uint32_t sq = base + C::kOps;            // Q TF32 hi, lo
  const uint32_t sq16 = sq + 2 * C::kT32;        // Q bf16 hi, lo
  const uint32_t sdo16 = sq16 + 2 * C::kB16;     // dO bf16 hi, lo
  const float* raw = reinterpret_cast<const float*>(smem + C::kRawOff);
  const float scale2 = scale * kLog2e;
  const int c0 = kw + 16 * warp + (lane >> 2);  // this thread's keys c0, c0 + 8
  const int c_lane = 2 * (lane & 3);  // its first query row of each 8

  auto stats_at = [&](int i) { return (i % 2) * 2 * kRows; };
  // Starts copying query tile j0 + i: Q and dO as stored, then 64 lse
  // and 64 D into stats slot i % 2.
  auto load = [&](int i) {
    const int qt0 = (j0 + i) * kRows;
    const uint32_t raw_q = base + C::kRawOff, raw_do = raw_q + kRows * D * 4;
    load_raw<float, D, kThr>(raw_q, q + qoff, qt0, T);
    load_raw<float, D, kThr>(raw_do, dout + qoff, qt0, T);
    if (threadIdx.x < 2 * kRows) {
      const int r = threadIdx.x % kRows;
      const bool in = qt0 + r < T;
      const float* src = threadIdx.x < kRows ? lse : di;
      cp_async4(base + C::kStats + 4 * (stats_at(i) + threadIdx.x),
                src + (size_t)bh * T + (in ? qt0 + r : 0), in);
    }
    cp_async_commit();
  };
  // Splits query tile j0 + i into the operand tiles; then starts copying
  // tile i + 1.
  auto stage = [&](int i) {
    const int qt0 = (j0 + i) * kRows;
    const float *qt = raw, *dot = raw + kRows * D;
    int n = kRows;
    if constexpr (C::kRaw) {
      cp_async_wait_all();
    } else {
      qt = q + qoff + (size_t)qt0 * D;
      dot = dout + qoff + (size_t)qt0 * D;
      n = T - qt0;
    }
    __syncthreads();  // tile i landed; every warp is past iteration i - 1
    if constexpr (!C::kRaw) {
      if (threadIdx.x < 2 * kRows) {
        const int r = threadIdx.x % kRows;
        const float* src = threadIdx.x < kRows ? lse : di;
        stats[stats_at(i) + threadIdx.x] =
            qt0 + r < T ? src[(size_t)bh * T + qt0 + r] : 0.f;
      }
    }
    split_tile<D, kThr, true, true>(qt, n, smem + C::kOps,
                                    smem + C::kOps + 2 * C::kT32);
    split_tile<D, kThr, false, true>(dot, n, nullptr,
                                     smem + C::kOps + 2 * C::kT32 +
                                         2 * C::kB16);
    fence_async_smem();
    __syncthreads();  // the operand tiles are written; the raw pair is free
    if constexpr (C::kRaw)
      if (i + 1 < n_tiles) load(i + 1);
  };
  auto masked = [&](int i) {
    const int qt0 = (j0 + i) * kRows;
    return qt0 + kRows > T || kw + kRows > S ||
           (causal && kw + kRows - 1 > qt0 + offset);
  };

  if constexpr (C::kRaw) load(0);
#pragma unroll
  for (int w = 0; w < C::kWG; ++w) {
    const int r0 = min(k0 + kRows * w, S);
    unsigned char* res = smem + C::kResident * w;
    split_tile<D, kThr, true, false>(k + koff + (size_t)r0 * D, S - r0, res,
                                     nullptr);
    split_tile<D, kThr, false, true>(v + koff + (size_t)r0 * D, S - r0,
                                     nullptr, res + 2 * C::kT32);
  }

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  float s[32], dp[32];
  uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];  // P^T, dS^T: hi + lo

  for (int i = 0; i < n_tiles; ++i) {
    stage(i);
    if (i < my_first) continue;
    wgmma_fence();
    qk_tf32x3<D>(s, sk, sq);     // S^T = K.Q^T
    qk_bf16x3<D>(dp, sv, sdo16);  // dP^T = V.dO^T
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    pin(dp);
    const float* st = stats + stats_at(i);
    const int qt0 = (j0 + i) * kRows;
    if (masked(i))
      dkv_tile_pds<true>(s, dp, st, st + kRows, c0, qt0, c_lane, T, S,
                         causal, offset, scale2);
    else
      dkv_tile_pds<false>(s, dp, st, st + kRows, c0, qt0, c_lane, T, S,
                          causal, offset, scale2);
    split_p(s, ph, pl);
    split_p(dp, dh, dl);
    wgmma_fence();
    pv_bf16x3<D>(adv, ph, pl, sdo16);  // dV += P^T.dO
    pv_bf16x3<D>(adk, dh, dl, sq16);   // dK += dS^T.Q
    wgmma_commit();
    wgmma_wait<0>();
    pin(adv);
    pin(adk);
  }
  if (my_first >= n_tiles) return;
  store_rows<D>(dk + koff, adk, c0, S, c_lane, scale);
  store_rows<D>(dv + koff, adv, c0, S, c_lane, 1.f);
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* di,
                          void* dq, int BH, int T, int S, int causal,
                          float scale, cudaStream_t stream) {
  using C = F32<D>;
  static bool configured = false;
  const cudaError_t e =
      configure(flash_bwd_dq_f32_tc_kernel<D>, C::kStats, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (T + C::kBlockRows - 1) / C::kBlockRows);
  flash_bwd_dq_f32_tc_kernel<D><<<grid, C::kThr, C::kStats, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
      static_cast<float*>(dq), T, S, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* di, void* dk, void* dv, int BH, int T,
                           int S, int causal, float scale,
                           cudaStream_t stream) {
  using C = F32<D>;
  static bool configured = false;
  const cudaError_t e =
      configure(flash_bwd_dkv_f32_tc_kernel<D>, C::kBytes, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (S + C::kBlockRows - 1) / C::kBlockRows);
  flash_bwd_dkv_f32_tc_kernel<D><<<grid, C::kThr, C::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
      static_cast<float*>(dk), static_cast<float*>(dv), T, S, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C entry points (loaded with ctypes). kind: 0 = f32 tensors, 1 = bf16
// (tensor-core kernels either way); lse and di are (BH, T) f32 either
// way. Return the launch's cudaError_t (0 = launched).
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
      return (int)with_head_dim(D, [&](auto dim) {
        return tc::launch_dq_f32<decltype(dim)::value>(
            q, k, v, dout, l, d, dq, BH, T, S, causal, scale, st);
      });
    case 1:
      return (int)with_head_dim(D, [&](auto dim) {
        return tc::launch_dq<decltype(dim)::value>(
            q, k, v, dout, l, d, dq, BH, T, S, causal, scale, st);
      });
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
      return (int)with_head_dim(D, [&](auto dim) {
        return tc::launch_dkv_f32<decltype(dim)::value>(
            q, k, v, dout, l, d, dk, dv, BH, T, S, causal, scale, st);
      });
    case 1:
      return (int)with_head_dim(D, [&](auto dim) {
        return tc::launch_dkv<decltype(dim)::value>(
            q, k, v, dout, l, d, dk, dv, BH, T, S, causal, scale, st);
      });
    default:
      return (int)cudaErrorInvalidValue;
  }
}
