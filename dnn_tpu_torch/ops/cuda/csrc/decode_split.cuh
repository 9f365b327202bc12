// The split-KV decode step shared by the dense decode kernel (K6,
// decode_attention.cu) and the paged one (K7, paged_decode.cu): the body
// of one split block, written once over an address policy (a dense
// per-slot cache, or a block table into a shared pool), and the merge
// kernel that combines the splits. The design and its reasons are in
// decode_attention.cu's header. The library's hash (_build.lib_path)
// covers this header, so an edit rebuilds both sources.
//
// Layouts. q and out (B, Hk, R, D), f32 or bf16 (Elem<kBF16Q>: bf16
// under bf16 compute; the scores, softmax statistics, accumulator and
// workspace stay f32 either way, and only the stored output is rounded to
// q's type); a dense cache (B, Hk, S, D) with
// (B, Hk, S) scales; a pool (n_blocks, Hk, bp, D) with (n_blocks, Hk, bp)
// scales, tables (B, nb_max) int32. Both caches are read as an array of
// D-wide rows: row (bh, col) = bh * S + col, or (tables[b, col / bp] *
// Hk + hk) * bp + col % bp. A slot's logical length `len` is S, or
// nb_max * bp; its live columns are 0 .. min(pos[b], len - 1).
//
// Workspace (n_split > 1): acc (n_split, rows, D), then m and l
// (n_split, rows) each, rows = B * Hk * R; m in log2 units.
//
// The band (window > 0, Mistral's and Gemma-2's sliding windows): slot b's
// live columns are lo .. min(pos[b], len - 1), lo = band_lo(pos[b],
// window); a split wholly before lo returns at once, as one wholly past the
// limit does, and reads nothing (a windowed paged slot's reclaimed blocks,
// whose table entries point at the junk block, lie there); a split's tiles
// start at its first live column. The merge reads only the splits that
// hold a live column of the row. The softcap (softcap > 0, Gemma-2) caps
// each score after its scales, before the mask.

#pragma once

#include "hopper_tc.cuh"

namespace {
namespace dec {

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::kLog2e;
using tc::smem_addr;

constexpr float kNegBig = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // a block's warps, each its own pipeline
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;      // a warp's ring
constexpr int kMaxRows = 8;     // query rows a KV head (R)
constexpr int kMergeThreads = 128;
constexpr int kMergeChunk = 8;  // the merge's splits loaded together
constexpr int kMaxSmem = 227 * 1024;  // an H100 block's shared memory

// What one (cache type, head dim) needs. A lane computes on kVec head
// dims (4; 8 at D = 256), so a key row is read by a group of kG = D / kVec
// neighbouring lanes (at most the warp); a warp's kGroups groups take the
// keys of its tiles in turn, kKeys each (4 in f32, 8 in the narrow types:
// about 4 KB of K and V a tile; 4 at D = 256, whose lanes hold twice the
// state a row).
template <typename KV, int D>
struct Cfg {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte copies a row
  static constexpr int kVec = D > 128 ? 8 : 4;
  static constexpr int kG = D / kVec;
  static_assert(kG <= 32, "a key row's lanes fill at most the warp");
  static constexpr int kGroups = 32 / kG;
  static constexpr int kKeys =
      std::is_same<KV, float>::value || D > 128 ? 4 : 8;
  static constexpr int kTile = kKeys * kGroups;  // keys a warp's tile
  static_assert(kTile * kChunks % 32 == 0, "a tile's copies fill the warp");
  static constexpr int kKV = kTile * kRowBytes;  // a K (or V) tile
  // K tile, V tile, then (int8) the tile's K and V scales
  static constexpr int kStage = 2 * kKV + (kQuant ? 2 * kTile * 4 : 0);
  static constexpr int kRing = kWarps * kStages * kStage;
  // every group's partial state, merged through shared memory at the end
  // (in the ring's bytes, once it is drained)
  template <int kR>
  static constexpr int merge_bytes() {
    return (kWarps * kGroups * kR * (D + 2)) * 4;
  }
  // dynamic shared memory: `rows` bytes of pool rows, then the ring
  template <int kR>
  static constexpr int smem(int rows) {
    return rows + (kRing > merge_bytes<kR>() ? kRing : merge_bytes<kR>());
  }
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 elements at p (shared memory, aligned to 4 elements) -> f32.
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
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

// One block of the split grid (n_split, B * Hk): all R <= kR query rows
// of one (slot b, KV head hk), over the keys [split * split_keys,
// (split + 1) * split_keys) clipped to the slot's live columns (its band
// lo .. limit). kPaged
// reads the cache through `tables` (bp rows a block; split_keys is a
// multiple of bp), else as the dense (B, Hk, len, D) array. The partial
// state goes to ws, or, where the slot's live columns all lie in split
// 0 (or ws is null: one split), the normalised rows go to out. Block
// kThreads, dynamic shared memory Cfg<KV, D>::smem<kR>(rows), rows =
// split_keys pool rows of 4 bytes, rounded up to 16 bytes (0 if dense);
// a pool holds fewer than 2^31 rows (n_blocks * Hk * bp). q and out are
// of one type, f32 or (kBF16Q) bf16.
template <typename KV, int D, int kR, bool kPaged, bool kBF16Q>
__device__ __forceinline__ void split_block(
    const Elem<kBF16Q>* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ pos, Elem<kBF16Q>* __restrict__ out,
    float* __restrict__ ws, int Hk, int R, int len, int bp, int split_keys,
    float scale, int window, float softcap) {
  using C = Cfg<KV, D>;
  constexpr int kVec = C::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  // the merge (a programmatic dependent) may start its blocks now; it
  // waits for this grid's completion before it reads a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / Hk, hk = bh - b * Hk;
  const int c0 = split * split_keys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gl = lane % C::kG, grp = lane / C::kG, d0 = kVec * gl;
  // q, pos and (paged) the split's table entries are loaded together:
  // none of them depends on another, and the K/V copies wait for pos
  const int limit = min(pos[b], len - 1);
  // the band's first live column, never past the last (a stale slot)
  const int lo = min(band_lo(pos[b], window), limit);
  float qr[kR][kVec];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r < R) {
#pragma unroll
      for (int u = 0; u < kVec; u += 4)
        load4(q + ((size_t)bh * R + r) * D + d0 + u, qr[r] + u);
    } else {
#pragma unroll
      for (int d = 0; d < kVec; ++d) qr[r][d] = 0.f;
    }
  }
  // paged: the pool row of every column of the split, computed once here
  // from its table entry (the table, not the pool: the blocks past the
  // live limit are never read), so that a tile's copies cost one shared
  // load an address
  int* rows_at = reinterpret_cast<int*>(smem);
  const int rows_bytes = kPaged ? (split_keys * 4 + 15) / 16 * 16 : 0;
  unsigned char* ring = smem + rows_bytes;
  if constexpr (kPaged) {
    const int* entries = tables + (size_t)b * (len / bp);
    for (int rel = tid; rel < split_keys && c0 + rel < len;
         rel += kThreads) {
      const int col = c0 + rel, j = col / bp;
      rows_at[rel] = (entries[j] * Hk + hk) * bp + (col - j * bp);
    }
  }
  // no live column of the slot here: the split lies past its limit, or
  // wholly before its band
  if (c0 > limit || c0 + split_keys <= lo) return;
  const int c1 = max(c0, lo);  // the split's first live column
  const int n_keys = min(c0 + split_keys - 1, limit) + 1 - c1;
  const int n_tiles = (n_keys + C::kTile - 1) / C::kTile;
  if constexpr (kPaged) __syncthreads();
  // the D-wide row of column c1 + rel
  auto row_of = [&](int rel) -> size_t {
    if constexpr (kPaged) {
      return (size_t)(unsigned)rows_at[c1 - c0 + rel];
    } else {
      return (size_t)bh * len + c1 + rel;
    }
  };
  // Warp w takes the tiles w, w + kWarps, ... of the split through its
  // own ring of kStages stages: the i-th of them lands in stage i %
  // kStages. Its K and V rows (and int8 scales) are 16-byte copies by the
  // warp's lanes; rows past the live range are zero-filled and never
  // read. One commit group a call, empty past the warp's last tile.
  unsigned char* own = ring + warp * kStages * C::kStage;
  auto issue = [&](int i) {
    const int t = warp + i * kWarps;
    if (t < n_tiles) {
      const uint32_t sk = smem_addr(own + (i % kStages) * C::kStage);
      const uint32_t sv = sk + C::kKV;
      const int rel0 = t * C::kTile;
#pragma unroll
      for (int c = lane; c < C::kTile * C::kChunks; c += 32) {
        const int r = c / C::kChunks;
        const bool in = rel0 + r < n_keys;
        const size_t off = (in ? row_of(rel0 + r) : 0) * C::kRowBytes +
                           (c - r * C::kChunks) * 16;
        cp_async16(sk + c * 16, reinterpret_cast<const char*>(k) + off, in);
        cp_async16(sv + c * 16, reinterpret_cast<const char*>(v) + off, in);
      }
      if constexpr (C::kQuant) {
#pragma unroll
        for (int c = lane; c < 2 * C::kTile; c += 32) {
          const int r = c % C::kTile;
          const bool in = rel0 + r < n_keys;
          const size_t row = in ? row_of(rel0 + r) : 0;
          cp_async4(sv + C::kKV + c * 4, (c < C::kTile ? ks : vs) + row, in);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) issue(i);

  const float scale2 = scale * kLog2e;  // scores in log2 units
  const float cap2 = softcap * kLog2e;  // the cap in log2 units
  float m[kR], l[kR], acc[kR][kVec];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kVec; ++d) acc[r][d] = 0.f;
  }

#pragma unroll 1
  for (int i = 0; warp + i * kWarps < n_tiles; ++i) {
    cp_async_wait<kStages - 1>();  // the warp's i-th tile has landed
    __syncwarp();
    const int t = warp + i * kWarps;
    const unsigned char* st = own + (i % kStages) * C::kStage;
    const KV* sk = reinterpret_cast<const KV*>(st);
    const KV* sv = reinterpret_cast<const KV*>(st + C::kKV);
    // (int8) the tile's K scales, then its V scales
    const float* scales = reinterpret_cast<const float*>(st + 2 * C::kKV);
    // a group's j-th key of the tile is row grp + j * kGroups
    auto live = [&](int j) {
      return t * C::kTile + grp + j * C::kGroups < n_keys;
    };
    float s[kR][C::kKeys];  // scores, then probabilities
#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) {
      const int row = grp + j * C::kGroups;
      float kr[kVec];
#pragma unroll
      for (int u = 0; u < kVec; u += 4) load4(sk + row * D + d0 + u, kr + u);
      // the K scale multiplies the score before 1/sqrt(D)
      const float ksc = C::kQuant ? scale2 * scales[row] : scale2;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        float x = qr[r][0] * kr[0];
#pragma unroll
        for (int d = 1; d < kVec; ++d) x = fmaf(qr[r][d], kr[d], x);
#pragma unroll
        for (int o = C::kG / 2; o > 0; o >>= 1)
          x += __shfl_xor_sync(kFull, x, o);
        x *= ksc;
        if (softcap > 0.f) x = soft_cap(x, cap2);
        s[r][j] = live(j) ? x : kNegBig;
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) mx = fmaxf(mx, s[r][j]);
      const float alpha = exp2f(m[r] - mx);
      l[r] *= alpha;
#pragma unroll
      for (int d = 0; d < kVec; ++d) acc[r][d] *= alpha;
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) {
        s[r][j] = live(j) ? exp2f(s[r][j] - mx) : 0.f;
        l[r] += s[r][j];  // the row sum never sees the V scale
      }
      m[r] = mx;
    }
    // P.V, each V row read once for all R rows; the V scale folds into P
#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) {
      const int row = grp + j * C::kGroups;
      float vr[kVec];
#pragma unroll
      for (int u = 0; u < kVec; u += 4) load4(sv + row * D + d0 + u, vr + u);
      const float vsc = C::kQuant ? scales[C::kTile + row] : 1.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float pv = s[r][j] * vsc;
#pragma unroll
        for (int d = 0; d < kVec; ++d) acc[r][d] = fmaf(pv, vr[d], acc[r][d]);
      }
    }
    __syncwarp();  // the stage is free for the warp's tile i + kStages
    issue(i + kStages);
  }

  // every group's state, merged in (warp, group) order through the ring
  // once every warp has left it
  constexpr int kAll = kWarps * C::kGroups;
  float* s_acc = reinterpret_cast<float*>(ring);  // (kAll, kR, D)
  float* s_ml = s_acc + kAll * kR * D;             // (kAll, kR, 2)
  const int g_all = warp * C::kGroups + grp;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int u = 0; u < kVec; u += 4)
      *reinterpret_cast<float4*>(s_acc + (g_all * kR + r) * D + d0 + u) =
          make_float4(acc[r][u], acc[r][u + 1], acc[r][u + 2], acc[r][u + 3]);
    if (gl == 0) {
      s_ml[(g_all * kR + r) * 2] = m[r];
      s_ml[(g_all * kR + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  // the slot's live columns all in this one split: finished here
  const bool direct = ws == nullptr || lo / split_keys == limit / split_keys;
  const size_t rows = (size_t)gridDim.y * R;
  for (int o = tid; o < R * (D / 4); o += kThreads) {
    const int r = o / (D / 4), d = 4 * (o - r * (D / 4));
    float mx = kNegBig;
    for (int g = 0; g < kAll; ++g) mx = fmaxf(mx, s_ml[(g * kR + r) * 2]);
    float tot = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < kAll; ++g) {
      // a group with no live key has l = 0, acc = 0 and weight 0
      const float w = exp2f(s_ml[(g * kR + r) * 2] - mx);
      tot = fmaf(s_ml[(g * kR + r) * 2 + 1], w, tot);
      const float4 x =
          *reinterpret_cast<const float4*>(s_acc + (g * kR + r) * D + d);
      a.x = fmaf(x.x, w, a.x);
      a.y = fmaf(x.y, w, a.y);
      a.z = fmaf(x.z, w, a.z);
      a.w = fmaf(x.w, w, a.w);
    }
    const size_t row = (size_t)bh * R + r;
    if (direct) {
      const float inv = 1.f / tot;
      store4(out + row * D + d,
             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    } else {
      const size_t wrow = (size_t)split * rows + row;
      *reinterpret_cast<float4*>(ws + wrow * D + d) = a;
      if (d == 0) {
        float* ms = ws + (size_t)gridDim.x * rows * D;
        ms[wrow] = mx;
        ms[(size_t)gridDim.x * rows + wrow] = tot;
      }
    }
  }
}

// out (rows = B * Hk * R, D) from the n_split partials in ws: row (bh, r)
// reads the splits that hold a live column of its slot, those of its first
// live column lo = band_lo(pos[b], window) through its last, min(pos[b],
// len - 1), and takes sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s
// with M = max_s m_s, in split order; a split wholly before the band
// returned without a partial and is never read, so no empty (m = -inf, l =
// 0) state enters the sum; a row whose live columns lie in one split was
// written by that split's block. The splits' partials are
// loaded kMergeChunk at a time, all in flight together (one round trip
// for up to 8 splits), the sums rescaled between chunks. D / 4 threads a
// row, four output dims each, written in q's type. Launched as a
// programmatic dependent of the split kernel: its blocks may start while
// that grid runs, and wait for it (griddepcontrol.wait) before the first
// partial is read.
template <int D, bool kBF16Q>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ ws, const int* __restrict__ pos,
                    Elem<kBF16Q>* __restrict__ out, int Hk, int R, int len,
                    int split_keys, int n_split, int rows, int window) {
  constexpr int kPer = D / 4;  // threads a row
  const int row = blockIdx.x * (kMergeThreads / kPer) + threadIdx.x / kPer;
  if (row >= rows) return;
  const int d = 4 * (threadIdx.x % kPer);
  const int p = pos[row / (Hk * R)];
  const int limit = min(p, len - 1);
  const int first = min(band_lo(p, window), limit) / split_keys;
  const int n = limit / split_keys + 1;  // the splits up to the last
  if (first == n - 1) return;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t stride = (size_t)rows;  // one split's rows
  const float* ms = ws + (size_t)n_split * stride * D;
  const float* ls = ms + (size_t)n_split * stride;
  float mx = kNegBig, tot = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = first; s0 < n; s0 += kMergeChunk) {
    float mc[kMergeChunk], lc[kMergeChunk];
    float4 ac[kMergeChunk];
#pragma unroll
    for (int u = 0; u < kMergeChunk; ++u) {
      const size_t i = (size_t)(s0 + u) * stride + row;
      const bool in = s0 + u < n;
      mc[u] = in ? ms[i] : kNegBig;
      lc[u] = in ? ls[i] : 0.f;
      ac[u] = in ? *reinterpret_cast<const float4*>(ws + i * D + d)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float m_new = mx;
#pragma unroll
    for (int u = 0; u < kMergeChunk; ++u) m_new = fmaxf(m_new, mc[u]);
    const float c = exp2f(mx - m_new);  // 0 on the first chunk
    tot *= c;
    acc.x *= c;
    acc.y *= c;
    acc.z *= c;
    acc.w *= c;
#pragma unroll
    for (int u = 0; u < kMergeChunk; ++u) {
      const float w = exp2f(mc[u] - m_new);
      tot = fmaf(lc[u], w, tot);
      acc.x = fmaf(ac[u].x, w, acc.x);
      acc.y = fmaf(ac[u].y, w, acc.y);
      acc.z = fmaf(ac[u].z, w, acc.z);
      acc.w = fmaf(ac[u].w, w, acc.w);
    }
    mx = m_new;
  }
  const float inv = 1.f / tot;
  store4(out + (size_t)row * D + d,
         make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
}

// fn(std::integral_constant<int, kR>) for the smallest kR in {1, 2, 4, 8}
// that holds R rows.
template <typename F>
cudaError_t with_rows(int R, F fn) {
  if (R == 1) return fn(std::integral_constant<int, 1>{});
  if (R == 2) return fn(std::integral_constant<int, 2>{});
  if (R <= 4) return fn(std::integral_constant<int, 4>{});
  if (R <= kMaxRows) return fn(std::integral_constant<int, 8>{});
  return cudaErrorInvalidValue;
}

// Launches a split kernel `kernel` (grid (n_split, BHk), `smem` bytes of
// dynamic shared memory; `args` its arguments) and, with a workspace,
// the merge as its programmatic dependent. Returns the first error.
template <int D, bool kBF16Q, typename K, typename... Args>
cudaError_t launch(K kernel, int smem, bool& configured, int n_split,
                   int BHk, const float* ws, const int* pos,
                   Elem<kBF16Q>* out, int Hk, int R, int len, int split_keys,
                   int window, cudaStream_t stream, Args... args) {
  if (!configured) {
    // all of what a block may take: the table entries grow with split_keys
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  kernel<<<dim3(n_split, BHk), kThreads, smem, stream>>>(args...);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ws == nullptr) return e;
  constexpr int kRowsPer = kMergeThreads / (D / 4);
  const int rows = BHk * R;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kRowsPer - 1) / kRowsPer);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_merge_kernel<D, kBF16Q>, ws, pos,
                            out, Hk, R, len, split_keys, n_split, rows,
                            window);
}

}  // namespace dec
}  // namespace
