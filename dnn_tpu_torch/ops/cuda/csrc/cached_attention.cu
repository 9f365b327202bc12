// Cached-attention prefill kernel (K5) for Hopper, sm_90a.
//
// Replaces: dnn_tpu/ops/pallas/cached_attention.py:77 _cached_attn_kernel
// (entry cached_attention) -- a prompt chunk's queries attend a
// preallocated K/V cache with a RUNTIME base position: row t of batch b
// sees cache columns <= pos[b] + t. q is f32, or bf16 under bf16
// compute; the cache is f32, bf16, or int8 with one f32 scale per
// (position, head) for K and for V; the output is of q's type, as the
// TPU kernel writes o in q's dtype. Grouped-query attention: the cache may hold fewer heads
// than q, Hk = H / G, and query head h reads KV head h / G (G = 1 is
// multi-head attention; llama3-8b has G = 4).
//
// What bounds it on an H100: bytes, and before them latency. At the
// serving shape (B=1, H=12, one 64-row chunk, D=64, base 960: 1024 live
// columns) the live K/V are 6.3 MB in f32, 3.1 MB in bf16 and 1.6 MB in
// int8 with its scales, 0.0020 / 0.0010 / 0.0006 ms at 3.35 TB/s; the
// products the kernel issues on the tensor cores take 0.0004-0.0006 ms
// at 989 TFLOP/s. A chunk is only B * H * ceil(T/64) = 12 query tiles,
// far too few blocks to fill 132 SMs if each walks its keys alone.
//
// Grouped heads (llama3-8b's chunk: B=1, H=32 over Hk=8 KV heads, T=64,
// D=128): the grid keeps one block per query head, so the G query heads
// of a KV head read its cache rows G times -- from L2 after the first
// (8.4 MB of live f32 K/V at base 960 against a 50 MB L2). The bytes the
// call must move are those of the Hk heads. Nothing else changes: a
// call with G = 1 launches the same grid as before grouping existed.
//
// Design (one kernel per cache type and head dim, tc::cached_attn_tc_kernel):
//  * Split-KV grid (n_split, ceil(T/64), B*H). A block is one warpgroup
//    (128 threads) that owns a 64-row query tile -- wgmma's m64 -- and
//    the keys [split * split_keys, (split + 1) * split_keys) of it,
//    clipped to the tile's last live column pos + last row. The split is
//    sized from S on the host (the positions stay on the device, no
//    sync) so that the grid holds about one block an SM (at the serving
//    shape 8 splits of two tiles: fewer, longer splits timed slower at
//    base 960, more, shorter ones slower at every base); a block whose
//    range lies wholly past the tile's last live column exits at once,
//    and dead columns are never read, as the TPU kernel's pl.when(live)
//    skips them.
//  * Each block writes its partial online-softmax state -- the row max m
//    (log2 units), the row sum l and the unnormalised accumulator -- to
//    an f32 workspace the wrapper allocates, and a second kernel
//    (cached_attn_merge_kernel) combines a row's partials in split order,
//    so the result is the same bit for bit from run to run. A second
//    kernel rather than last-block-merges: electing the last block needs
//    a per-tile counter zeroed before every call and atomics, state that
//    outlives a call; the merge costs one more launch and keeps a call
//    stateless. It is launched as a programmatic dependent (PDL), so its
//    blocks are resident before the split grid ends and only wait for its
//    writes. A row whose live columns all lie in split 0 (a whole chunk
//    at base 0) is divided by l and written by its split-0 block, and the
//    merge skips it; where the cache is a single split no merge runs.
//  * Both products run on the tensor cores as wgmma m64nNk16 (f32 +=
//    bf16 x bf16), through the helpers of hopper_tc.cuh. f32 accuracy
//    comes from splitting only the f32 side into bf16 hi + lo (x = hi +
//    lo to 2^-16 relative): the cache side is exact in bf16 -- a bf16
//    cache as stored, an int8 payload widened to bf16 exactly (|x| <=
//    127) -- so S = Q.K^T is q_hi.k + q_lo.k and O += P.V is p_hi.v +
//    p_lo.v, two wgmma each. An f32 cache is split too and takes three
//    (hi.hi + hi.lo + lo.hi; lo.lo is below f32's own rounding of the
//    sum). Q is split once into two swizzled tiles; P is split in
//    registers: wgmma's accumulator fragment of S is, pair by pair, the A
//    fragment of P.V.
//  * A bf16 q (bf16 compute) is exact in bf16: it is copied into the Q
//    tile as it is, its lo is zero, and the q_lo products are not issued
//    (Q.K^T is q.k, or q.k_hi + q.k_lo against an f32 cache). P keeps its
//    hi + lo split, so the f32 statistics and accumulator are those of an
//    f32 q; only the stored output is rounded to bf16. An f32 q runs the
//    code it ran before bf16 q existed.
//  * K and V stream through a two-stage cp.async ring (16-byte copies,
//    zero-filled past S), tile j + 1 in flight while tile j is
//    multiplied. A bf16 cache lands straight in wgmma's 128-byte swizzled
//    layout; an f32 or int8 cache lands raw and is converted once per
//    tile into the swizzled operand tiles (hi and lo, or widened).
//  * Only tiles on the diagonal (a column past the tile's first row's
//    limit) or past S take the mask; rows at or past T are computed on
//    zero queries and never stored.
//  * int8: the tile's K and V scales are staged beside the payload. The
//    K scale multiplies the f32 score column before the softmax; the V
//    scale folds into P for P.V only, while l sums the unscaled P (the
//    reference's softmax denominator never sees the V scales).
//  * The sliding-window band (window > 0; Mistral, Gemma-2's even layers):
//    row t keeps the columns after pos + t - window. The tile's first row
//    has the lowest first live column, so a block starts at the 64-key
//    tile that holds it and never reads the tiles before (a windowed
//    paged row's reclaimed blocks among them); a split wholly before it
//    exits at once. Tiles a row's band crosses take the mask. The merge
//    reads only the splits that hold a live column of the row.
//  * The softcap (softcap > 0; Gemma-2): each score, after the int8 K
//    scale, is scaled by 1/sqrt(D) and capped at softcap * tanh(s /
//    softcap) (tanhf) before the mask; scale2 is then log2 e alone.
//  * D = 256 (Gemma): P.V is one m64n256k16 (128 accumulators a thread).
//    A bf16 cache's ring (192 KB with Q) and an int8 cache's (194 KB) fit
//    a block's 227 KB; an f32 cache's raw ring would not, so its tiles
//    are read and split into the operand tiles straight from global
//    memory (Direct), behind the block's barrier.
//
// Numerics: f32 statistics and accumulation for every cache type; the
// output is written in q's type (rounded to nearest once, for bf16). The
// scale 1/sqrt(D) multiplies the f32 score in log2 units (exp2 on the
// SFU) where the reference divides by sqrt(D); masked scores are -inf
// and add exactly 0 to l and O (a banded row's first tiles may hold no
// live column of it: its m stays at its finite start there, and its l
// and O at 0). A split that holds no live column of a row leaves that
// row's partial undefined, and the merge never reads it: row t reads the
// splits from the one that holds its first live column to the one that
// holds its last.

#include "hopper_tc.cuh"

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

namespace tc {

constexpr int kWGThreads = 128;  // one warpgroup a block
constexpr int kRing = 2;         // stages of the K/V ring

// What a cache type needs beside the ring.
template <typename KV>
struct Kind {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  // K and V split into hi and lo (an f32 cache)
  static constexpr bool kSplit = std::is_same<KV, float>::value;
  // the ring holds the raw cache, converted into operand tiles per tile
  static constexpr bool kStaged = !std::is_same<KV, __nv_bfloat16>::value;
};

// An f32 cache at head dim 256 has no ring: two stages of raw 64-key f32
// tiles (256 KB) beside its four operand tiles (128 KB) are past a block's
// 227 KB, so each tile is read from global memory and split into the
// operand tiles in one step (convert_direct), behind the block's barrier.
template <typename KV, int D>
struct Direct {
  static constexpr bool value = Kind<KV>::kSplit && D > 128;
};

// Shared memory, in bytes from the 1024-aligned base: Q hi and Q lo
// tiles; the operand tiles K, V (hi) and K lo, V lo of a converted cache;
// then kRing stages (none for Direct). A bf16 stage is a K and a V
// operand tile; a raw stage is the K and V rows as stored, then (int8) 64
// K and 64 V scales. At D = 256: 192 KB (bf16, f32) and 194 KB (int8).
template <typename KV, int D>
struct Smem {
  static constexpr int kTile = Layout<D>::kTile;
  static constexpr int kRaw = kRows * D * (int)sizeof(KV);
  static constexpr int kOps = 2 * kTile;
  static constexpr int kOperands =
      Kind<KV>::kStaged ? (Kind<KV>::kSplit ? 4 : 2) : 0;
  static constexpr int kStage =
      Direct<KV, D>::value ? 0
      : Kind<KV>::kStaged
          ? (2 * kRaw + (Kind<KV>::kQuant ? 2 * kRows * 4 : 0) + 1023) / 1024 *
                1024
          : 2 * kTile;
  static constexpr int kRingOff = kOps + kOperands * kTile;
  static constexpr int kBytes = kRingOff + kRing * kStage;
  static_assert(kBytes <= 227 * 1024, "a block's shared memory");
};

// Four int8 values (one 32-bit word) as two bf16 pairs; exact.
__device__ __forceinline__ void widen4(uint32_t x, uint32_t& a, uint32_t& b) {
  const char4 c = *reinterpret_cast<const char4*>(&x);
  a = pack_bf16((float)c.x, (float)c.y);
  b = pack_bf16((float)c.z, (float)c.w);
}

// A raw stage's K and V into the operand tiles at `ops` (Layout<D>):
// f32 split into K hi, V hi, K lo, V lo; int8 widened into K, V.
template <typename KV, int D>
__device__ __forceinline__ void convert(const unsigned char* raw,
                                        unsigned char* ops) {
  using L = Smem<KV, D>;
  constexpr int kChunks = D / 8;  // 16-byte bf16 chunks per row
#pragma unroll
  for (int u = 0; u < kRows * kChunks / kWGThreads; ++u) {
    const int i = (int)threadIdx.x + u * kWGThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int off = Layout<D>::offset(r, c);
#pragma unroll
    for (int w = 0; w < 2; ++w) {  // K, then V
      const KV* src =
          reinterpret_cast<const KV*>(raw + w * L::kRaw) + r * D + 8 * c;
      if constexpr (Kind<KV>::kSplit) {
        const float4* f = reinterpret_cast<const float4*>(src);
        uint4 hi, lo;
        split8(f[0], f[1], hi, lo);
        *reinterpret_cast<uint4*>(ops + w * L::kTile + off) = hi;
        *reinterpret_cast<uint4*>(ops + (2 + w) * L::kTile + off) = lo;
      } else {
        const uint2 x = *reinterpret_cast<const uint2*>(src);
        uint4 h;
        widen4(x.x, h.x, h.y);
        widen4(x.y, h.z, h.w);
        *reinterpret_cast<uint4*>(ops + w * L::kTile + off) = h;
      }
    }
  }
}

// Direct: rows [k0, k0 + 64) of an f32 cache's K and V straight from
// global memory (zeros past S), split into the operand tiles at `ops` as
// convert does: K hi, V hi, K lo, V lo.
template <int D>
__device__ __forceinline__ void convert_direct(const float* kb,
                                               const float* vb, int k0, int S,
                                               unsigned char* ops) {
  using L = Smem<float, D>;
  constexpr int kChunks = D / 8;
#pragma unroll 2
  for (int u = 0; u < kRows * kChunks / kWGThreads; ++u) {
    const int i = (int)threadIdx.x + u * kWGThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int off = Layout<D>::offset(r, c);
#pragma unroll
    for (int w = 0; w < 2; ++w) {  // K, then V
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (k0 + r < S) {
        const float4* f = reinterpret_cast<const float4*>(
            (w ? vb : kb) + (size_t)(k0 + r) * D + 8 * c);
        a = f[0];
        b = f[1];
      }
      uint4 hi, lo;
      split8(a, b, hi, lo);
      *reinterpret_cast<uint4*>(ops + w * L::kTile + off) = hi;
      *reinterpret_cast<uint4*>(ops + (2 + w) * L::kTile + off) = lo;
    }
  }
}

// The online softmax of one 64-key tile of f32 scores at k0, in place:
// masks columns past each row's limit and before its band's first live
// column lo (only where `masked`), moves the row max m (log2 units),
// returns in alpha the factor 2^(m_old - m_new) for O; s becomes p = 2^(s *
// scale2 - m), and l (this thread's part of the row sum) takes alpha * l +
// the sum of p. A masked score is -inf (the bits 0xff800000), so its p is
// exactly 0 even in a tile where a row has no live column (a banded row's
// first tiles): m stays at its finite start there, and 2^(-1e30 * scale2 -
// m) would leave fmaf's rounding of the huge product, about 1e22, for ex2
// to make inf (and inf * alpha = 0 a NaN).
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2], bool masked,
                                               int k0, const int (&limit)[2],
                                               const int (&lo)[2], int c_lane,
                                               float scale2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = k0 + 8 * (i / 4) + c_lane + (i & 1);
      const int h = (i / 2) & 1;
      if (c > limit[h] || c < lo[h]) s[i] = __int_as_float(0xff800000);
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

// q (BH, T, D) Elem<kBF16Q>; k, v (BH / G, S, D) KV; k_scale, v_scale
// (BH / G, S) f32 (int8 only); pos (B,) int32, B = BH / H; out (BH, T, D)
// of q's type; the workspace is f32 whatever q's type. Query
// head bh reads the cache's head bh / G: with H = G * Hk, b * H + h over G
// is b * Hk + h / G. Only the cache's addressing sees G; q, the output,
// pos and the workspace are indexed by bh as for G = 1. ws null
// (one split: out is written here) or the workspace of n_split =
// gridDim.x splits: acc (n_split, BH, T, D), then m and l (n_split, BH,
// T) each (rows whose live columns all lie in one split go to out
// instead). window > 0: row t keeps only the columns after pos + t -
// window (the band; band_lo); softcap > 0: each score s (after the int8 K
// scale and the 1/sqrt(D) scale) becomes softcap * tanh(s / softcap)
// before the mask. Grid (n_split, ceil(T / 64), BH), block kWGThreads,
// dynamic shared memory Smem<KV, D>::kBytes.
template <typename KV, int D, bool kBF16Q>
__global__ void __launch_bounds__(kWGThreads, D >= 128 ? 1 : 2)
cached_attn_tc_kernel(const Elem<kBF16Q>* __restrict__ q,
                      const KV* __restrict__ k, const KV* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ pos,
                      Elem<kBF16Q>* __restrict__ out, float* __restrict__ ws,
                      int H, int G, int T, int S, int split_keys,
                      float scale, int window, float softcap) {
  using K = Kind<KV>;
  using L = Smem<KV, D>;
  constexpr int kTile = L::kTile;
  // 1024-byte aligned: the swizzle pattern repeats every 8 rows of 128 B
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);

  // the merge (launched as a programmatic dependent) may start its blocks
  // now; it waits for this grid's completion before it reads a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, q0 = blockIdx.y * kRows, bh = blockIdx.z;
  const int base = pos[bh / H];
  const int last_col = min(S - 1, base + min(T, q0 + kRows) - 1);
  const int k_begin = split * split_keys;
  const int k_end = min(last_col, k_begin + split_keys - 1);
  // the band: the tile's first row has the lowest first live column, so
  // the 64-key tiles wholly before it are skipped, never read (a windowed
  // paged row's reclaimed blocks among them)
  const int k_first =
      max(k_begin, min(band_lo(base + q0, window), last_col) / kRows * kRows);
  if (k_first > k_end) return;  // no live column of the tile here
  const int n_tiles = (k_end - k_first) / kRows + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows r0, r0 + 8
  const int c_lane = 2 * (lane & 3);       // its first column of each 8
  const int limit[2] = {min(S - 1, base + q0 + r0),
                        min(S - 1, base + q0 + r0 + 8)};
  // each row's first live column, never past its last (a stale base's row
  // past the cache's end keeps its last column)
  const int lo[2] = {min(band_lo(base + q0 + r0, window), limit[0]),
                     min(band_lo(base + q0 + r0 + 8, window), limit[1])};
  // tiles wholly at or below the first row's limit, and at or after the
  // last row's first live column, need no mask
  const int first_limit = min(S - 1, base + q0);
  const int last_lo = band_lo(base + q0 + kRows - 1, window);
  const size_t kv_row = (size_t)(bh / G) * S;  // this head's cache rows
  const KV* kb = k + kv_row * D;
  const KV* vb = v + kv_row * D;

  auto stage = [&](int j) { return L::kRingOff + L::kStage * (j % kRing); };
  // Starts copying tile j of the split into its stage (Direct: nothing;
  // the tile is read when it is converted).
  auto load = [&](int j) {
    const int k0 = k_first + j * kRows;
    const uint32_t st = sbase + stage(j);
    if constexpr (Direct<KV, D>::value) {
      (void)k0;
      (void)st;
    } else if constexpr (K::kStaged) {
      load_raw<KV, D, kWGThreads>(st, kb, k0, S);
      load_raw<KV, D, kWGThreads>(st + L::kRaw, vb, k0, S);
      if constexpr (K::kQuant) {  // 64 K scales, then 64 V scales
        const int i = threadIdx.x & (kRows - 1);
        const float* sc = (threadIdx.x < kRows ? k_scale : v_scale) + kv_row;
        const bool in = k0 + i < S;
        cp_async4(st + 2 * L::kRaw + 4 * threadIdx.x, sc + (in ? k0 + i : 0),
                  in);
      }
    } else {
      load_tile<D, kWGThreads>(st, kb, k0, S);
      load_tile<D, kWGThreads>(st + kTile, vb, k0, S);
    }
    cp_async_commit();
  };

  load(0);
  {  // Q, split once into hi and lo tiles (a bf16 q as it is); zeros
     // past T
    constexpr int kChunks = D / 8;
    const Elem<kBF16Q>* qb = q + (size_t)bh * T * D;
#pragma unroll
    for (int u = 0; u < kRows * kChunks / kWGThreads; ++u) {
      const int i = (int)threadIdx.x + u * kWGThreads;
      const int r = i / kChunks, c = i % kChunks;
      const int off = Layout<D>::offset(r, c);
      if constexpr (kBF16Q) {
        uint4 h = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < T)
          h = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D +
                                              8 * c);
        *reinterpret_cast<uint4*>(smem + off) = h;
      } else {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
        if (q0 + r < T) {
          const float4* g = reinterpret_cast<const float4*>(
              qb + (size_t)(q0 + r) * D + 8 * c);
          a = g[0];
          b = g[1];
        }
        uint4 hi, lo;
        split8(a, b, hi, lo);
        *reinterpret_cast<uint4*>(smem + off) = hi;
        *reinterpret_cast<uint4*>(smem + kTile + off) = lo;
      }
    }
  }

  const uint32_t sq = sbase, sq_lo = sbase + kTile;
  // a raw score -> log2 units (a capped score is already scaled)
  const float scale2 = softcap > 0.f ? kLog2e : scale * kLog2e;
  // m: running row max in log2 units; l: this thread's part of the row sum
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, alpha[2];
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[32];
  uint32_t pa[4][4], pl[4][4];  // P hi, P lo

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < n_tiles) load(j + 1);
    uint32_t sk, sv, sk_lo = 0, sv_lo = 0;
    if constexpr (K::kStaged) {
      if constexpr (Direct<KV, D>::value) {
        convert_direct<D>(kb, vb, k_first + j * kRows, S, smem + L::kOps);
      } else {
        convert<KV, D>(smem + stage(j), smem + L::kOps);
      }
      fence_async_smem();
      __syncthreads();
      sk = sbase + L::kOps;
      sv = sk + kTile;
      sk_lo = sk + 2 * kTile;
      sv_lo = sk + 3 * kTile;
    } else {
      sk = sbase + stage(j);
      sv = sk + kTile;
    }

    // S = q_hi.K [+ q_hi.K_lo] [+ q_lo.K: an f32 q]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<64>::ss(s, Layout<D>::k_major(sq, kk), Layout<D>::k_major(sk, kk),
                  kk);
    if constexpr (K::kSplit) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<64>::ss(s, Layout<D>::k_major(sq, kk),
                    Layout<D>::k_major(sk_lo, kk), 1);
    }
    if constexpr (!kBF16Q) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<64>::ss(s, Layout<D>::k_major(sq_lo, kk),
                    Layout<D>::k_major(sk, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);

    const int k0 = k_first + j * kRows;
    const float* scales =
        reinterpret_cast<const float*>(smem + stage(j) + 2 * L::kRaw);
    if constexpr (K::kQuant) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] *= scales[8 * (i / 4) + c_lane + (i & 1)];
    }
    if (softcap > 0.f) {  // scores scaled, then capped (scale2 is log2e)
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = soft_cap(s[i] * scale, softcap);
    }
    online_softmax(s, m, l, alpha,
                   k0 + kRows - 1 > first_limit || k0 < last_lo, k0, limit,
                   lo, c_lane, scale2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) & 1];
    if constexpr (K::kQuant) {  // P.V sees P times the V scales
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] *= scales[kRows + 8 * (i / 4) + c_lane + (i & 1)];
    }
    split_p(s, pa, pl);
    pin(o);

    // O += p_hi.V [+ p_hi.V_lo] + p_lo.V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<D>::rs(o, pa[kk], Layout<D>::mn_major(sv, kk), 1);
    if constexpr (K::kSplit) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Mma<D>::rs(o, pa[kk], Layout<D>::mn_major(sv_lo, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<D>::rs(o, pl[kk], Layout<D>::mn_major(sv, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
  const int BH = gridDim.z;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + r0 + 8 * h;
    // rows past T, and rows with no live column in this split (its live
    // columns lo .. limit all before or all after it), are not stored: the
    // merge never reads their partials; a row whose live columns all lie in
    // this one split is finished here
    if (t >= T || limit[h] < k_begin || lo[h] > k_begin + split_keys - 1)
      continue;
    if (ws == nullptr || lo[h] / split_keys == limit[h] / split_keys) {
      const float inv = 1.f / l[h];
      Elem<kBF16Q>* orow = out + ((size_t)bh * T + t) * D + c_lane;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        store2(orow + 8 * c, o[4 * c + 2 * h] * inv,
               o[4 * c + 2 * h + 1] * inv);
    } else {
      const size_t rows = (size_t)BH * T;
      const size_t row = (size_t)split * rows + (size_t)bh * T + t;
      float* arow = ws + row * D + c_lane;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<float2*>(arow + 8 * c) =
            make_float2(o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
      if ((lane & 3) == 0) {
        float* ms = ws + (size_t)gridDim.x * rows * D;
        ms[row] = m[h];
        ms[(size_t)gridDim.x * rows + row] = l[h];
      }
    }
  }
}

// out (rows = BH * T, D) from the n_split partials in ws (the layout
// above): row (bh, t) reads the splits that hold a live column of it,
// those of its first live column lo (band_lo; 0 without a window) through
// its last, min(S - 1, pos + t), and takes sum_s 2^(m_s - M) acc_s /
// sum_s 2^(m_s - M) l_s with M = max_s m_s, in split order; a split
// wholly outside the row's band is never read (its partial was not
// written), so no empty state enters the sum; a row whose live columns lie
// in one split was written by that split's block. D / 4
// threads a row, four output dims each, written in q's type. Launched as
// a programmatic dependent of the split kernel: its blocks start while
// that grid runs, and wait for it (griddepcontrol.wait) before the first
// partial is read.
template <int D, bool kBF16Q>
__global__ void __launch_bounds__(kWGThreads)
cached_attn_merge_kernel(const float* __restrict__ ws,
                         const int* __restrict__ pos,
                         Elem<kBF16Q>* __restrict__ out, int H, int T, int S,
                         int split_keys, int n_split, int rows, int window) {
  constexpr int kPer = D / 4;  // threads a row
  const int row = blockIdx.x * (kWGThreads / kPer) + threadIdx.x / kPer;
  if (row >= rows) return;
  const int d = 4 * (threadIdx.x % kPer);
  const int bh = row / T, t = row % T;
  const int limit = min(S - 1, pos[bh / H] + t);
  const int first = min(band_lo(pos[bh / H] + t, window), limit) / split_keys;
  const int last = limit / split_keys;
  if (first == last) return;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t stride = (size_t)rows;  // one split's rows
  const float* ms = ws + (size_t)n_split * stride * D;
  const float* ls = ms + (size_t)n_split * stride;
  float mx = kNegBig;
  for (int sp = first; sp <= last; ++sp)
    mx = fmaxf(mx, ms[sp * stride + row]);
  float tot = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = first; sp <= last; ++sp) {
    const size_t i = sp * stride + row;
    const float w = exp2f(ms[i] - mx);
    tot = fmaf(ls[i], w, tot);
    const float4 a = *reinterpret_cast<const float4*>(ws + i * D + d);
    acc.x = fmaf(a.x, w, acc.x);
    acc.y = fmaf(a.y, w, acc.y);
    acc.z = fmaf(a.z, w, acc.z);
    acc.w = fmaf(a.w, w, acc.w);
  }
  const float inv = 1.f / tot;
  store4(out + (size_t)row * D + d,
         make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
}

template <typename KV, int D, bool kBF16Q>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos,
                   void* out_, float* ws, int BH, int H, int G, int T, int S,
                   int split_keys, int n_split, float scale, int window,
                   float softcap, cudaStream_t stream) {
  constexpr int smem = Smem<KV, D>::kBytes;
  static bool configured = false;
  cudaError_t e =
      configure(cached_attn_tc_kernel<KV, D, kBF16Q>, smem, configured);
  if (e != cudaSuccess) return e;
  Elem<kBF16Q>* out = static_cast<Elem<kBF16Q>*>(out_);
  const dim3 grid(n_split, (T + kRows - 1) / kRows, BH);
  cached_attn_tc_kernel<KV, D, kBF16Q><<<grid, kWGThreads, smem, stream>>>(
      static_cast<const Elem<kBF16Q>*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, pos, out, ws, H, G, T, S,
      split_keys, scale, window, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess || ws == nullptr) return e;
  constexpr int kRowsPer = kWGThreads / (D / 4);
  const int rows = BH * T;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kRowsPer - 1) / kRowsPer);
  cfg.blockDim = dim3(kWGThreads);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cached_attn_merge_kernel<D, kBF16Q>,
                            static_cast<const float*>(ws), pos, out, H, T, S,
                            split_keys, n_split, rows, window);
}

}  // namespace tc
}  // namespace

// C entry point (loaded with ctypes). D: 32, 64, 128 or 256. G: query
// heads a KV head (H / Hk; 1 for multi-head attention). window: the
// band's width (<= 0: none); softcap: the score cap (<= 0: none). kv_kind:
// 0 = f32 cache, 1 = bf16,
// 2 = int8 with ks/vs scales (null for the float kinds). q_kind: 0 = f32
// q and out, 1 = bf16 q and out. split_tiles:
// 64-key tiles per split; the keys fall into n_split = ceil(ceil(S / 64)
// / split_tiles) splits, and ws is null when n_split is 1, else an f32
// workspace of n_split * BH * T * (D + 2) floats. One call launches the
// split kernel and, with a workspace, the merge. Returns the first
// launch error (0 = launched).
extern "C" int dnn_cached_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* pos,
                                    void* out, void* ws, int BH, int H,
                                    int G, int T, int S, int D, int kv_kind,
                                    int q_kind, int split_tiles, float scale,
                                    int window, float softcap,
                                    void* stream) {
  using tc::kRows;
  if (BH <= 0 || H <= 0 || G <= 0 || T <= 0 || S <= 0 || split_tiles <= 0 ||
      BH % H != 0 || H % G != 0 || BH > 65535 ||
      (T + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (S + kRows - 1) / kRows;
  const int n_split = (n_tiles + split_tiles - 1) / split_tiles;
  if ((n_split > 1) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  if (kv_kind == 2 ? (ks == nullptr || vs == nullptr)
                   : (ks != nullptr || vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* pp = static_cast<const int*>(pos);
  float* ww = static_cast<float*>(ws);
  const int split_keys = split_tiles * kRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_cache_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return with_q_kind(q_kind, [&](auto qk) {
      constexpr bool kQ = decltype(qk)::value;
      switch (kv_kind) {
        case 0:
          return tc::launch<float, kD, kQ>(q, k, v, kss, vss, pp, out, ww, BH,
                                           H, G, T, S, split_keys, n_split,
                                           scale, window, softcap, st);
        case 1:
          return tc::launch<__nv_bfloat16, kD, kQ>(q, k, v, kss, vss, pp, out,
                                                   ww, BH, H, G, T, S,
                                                   split_keys, n_split, scale,
                                                   window, softcap, st);
        case 2:
          return tc::launch<int8_t, kD, kQ>(q, k, v, kss, vss, pp, out, ww,
                                            BH, H, G, T, S, split_keys,
                                            n_split, scale, window, softcap,
                                            st);
        default:
          return cudaErrorInvalidValue;
      }
    });
  });
}
