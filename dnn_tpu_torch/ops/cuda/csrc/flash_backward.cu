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
// dK and dV over query tiles. In each path ONE device function rebuilds
// P and dS for both kernels (as _recompute_pds is shared in JAX), so K3
// and K4 cannot disagree on masking or scaling. Ragged T and S: rows
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
//    shape, so the plain loop stays.) The resident tiles (K3: Q and dO; K4: K and V) are
//    loaded once. Shared memory (2 + 2 kStages) x 64 x D x 2 bytes per
//    warpgroup pair (64 KB at D = 64; K4 adds 1 KB of lse and D).
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
// f32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel). What bounds them: the
// f32 arithmetic. Per live (row, key) pair K3 does 3 products of length D
// and K4 four: 14 T S D / 2 flops over both at causal, ~11.3 GFLOP at the
// training shape, 0.17 ms at 67 TFLOP/s on the CUDA cores, against ~100
// MB of inputs and outputs (0.03 ms at 3.35 TB/s). The products are f32
// FMAs with operands staged in shared memory (3xTF32 on the tensor cores
// is a later redesign). K3: one block per (b*h, 64-row query tile),
// looping over the key tiles up to the tile of the block's last live
// column; K4: one block per (b*h, 64-key tile), looping over the query
// tiles from the first one that can see it (for causal the first live
// row is max(0, k0 - (S - T))). Both rebuild P and dS through
// recompute_pds. Thread layout as in the f32 forward: 16 x 16 threads,
// thread (ty, tx) owns the 4 x 4 patch of query rows 4ty.. and keys 4tx..
// of a 64 x 64 tile; the operands of both products of the recompute are
// staged d-major, so each dot-product step is two 16-byte shared loads
// for 16 FMAs. The patches of P and dS then go through shared memory to
// the accumulation product, where the thread owns 4 rows (K3: query rows;
// K4: keys) x D/16 dims.

#include "hopper_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kB = 64;         // query rows and keys per tile
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

// Rows [r0, r0 + kB) of a row-major (len, D) matrix into shared memory
// d-major, sT[d * kB + r]; rows at or past `len` are zeros. Consecutive
// threads take consecutive rows, so the transposed stores hit distinct
// banks.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(const T* g, int r0, int len,
                                                 float* sT) {
  for (int i = threadIdx.x; i < kB * (D / 4); i += kThreads) {
    const int r = i % kB, d = (i / kB) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < len) load4(g + (size_t)(r0 + r) * D + d, x);
#pragma unroll
    for (int u = 0; u < 4; ++u) sT[(d + u) * kB + r] = x[u];
  }
}

// The same rows row-major: s[r * D + d].
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* g, int r0, int len,
                                           float* s) {
  for (int i = threadIdx.x; i < kB * (D / 4); i += kThreads) {
    const int r = (4 * i) / D, d = (4 * i) % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < len) load4(g + (size_t)(r0 + r) * D + d, x);
    *reinterpret_cast<float4*>(&s[r * D + d]) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The per-row statistics of query tile q0: lse and D, zero past T.
__device__ __forceinline__ void stage_stats(const float* lse, const float* di,
                                            int q0, int T, float* lse_s,
                                            float* di_s) {
  const int r = threadIdx.x;
  if (r < kB) {
    const bool in = q0 + r < T;
    lse_s[r] = in ? lse[q0 + r] : 0.f;
    di_s[r] = in ? di[q0 + r] : 0.f;
  }
}

// acc[i][j] = sum_d aT[d][4ty + i] * bT[d][4tx + j] over two d-major
// tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* aT, const float* bT,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&aT[d * kB + 4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&bT[d * kB + 4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// THE backward recompute, shared by K3 and K4: for the thread's patch
// (query rows q0 + 4ty + i, keys k0 + 4tx + j) rebuild the normalised
// probabilities p = exp(scale * q.k - lse), 0 where masked, and
// ds = p * (dO.v - D). qT/doT hold the query tile d-major, kT/vT the key
// tile; lse_s/di_s the query tile's row statistics.
template <int D>
__device__ __forceinline__ void recompute_pds(
    const float* qT, const float* kT, const float* doT, const float* vT,
    const float* lse_s, const float* di_s, int q0, int k0, int T, int S,
    int causal, float scale, int ty, int tx, float p[4][4], float ds[4][4]) {
  const int offset = S - T;
  float dp[4][4];
  tile_dot<D>(qT, kT, ty, tx, p);
  tile_dot<D>(doT, vT, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, t = q0 + r;
    const float lse = lse_s[r], di = di_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + 4 * tx + j;
      const bool live = t < T && c < S && (!causal || c <= t + offset);
      const float pp = live ? expf(p[i][j] * scale - lse) : 0.f;
      p[i][j] = pp;
      ds[i][j] = pp * (dp[i][j] - di);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (5 * kB * D + kB * kB + 2 * kB);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (6 * kB * D + 2 * kB * kB + 2 * kB);
}

// K3. q, do (BH, T, D); k, v (BH, S, D); lse, di (BH, T) f32; dq
// (BH, T, D). Grid (ceil(T / kB), BH), block kThreads.
template <typename Tp, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                    const Tp* __restrict__ v, const Tp* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, Tp* __restrict__ dq, int T,
                    int S, int causal, float scale) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [D][kB]
  float* doT = qT + D * kB;     // [D][kB]
  float* kT = doT + D * kB;     // [D][kB]
  float* vT = kT + D * kB;      // [D][kB]
  float* ks = vT + D * kB;      // [kB][D]
  float* dsT = ks + kB * D;     // [kB keys][kB rows]
  float* lse_s = dsT + kB * kB;
  float* di_s = lse_s + kB;

  const int nq = (T + kB - 1) / kB;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kB;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t qoff = (size_t)bh * T * D, koff = (size_t)bh * S * D;

  stage_transposed<Tp, D>(q + qoff, q0, T, qT);
  stage_transposed<Tp, D>(dout + qoff, q0, T, doT);
  stage_stats(lse + (size_t)bh * T, di + (size_t)bh * T, q0, T, lse_s, di_s);
  const int last_row = min(T, q0 + kB) - 1;
  const int last_col = causal ? min(S - 1, last_row + S - T) : S - 1;

  float acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < DV; ++u) acc[i][u] = 0.f;

  for (int k0 = 0; k0 <= last_col; k0 += kB) {
    __syncthreads();
    stage_transposed<Tp, D>(k + koff, k0, S, kT);
    stage_transposed<Tp, D>(v + koff, k0, S, vT);
    stage_rows<Tp, D>(k + koff, k0, S, ks);
    __syncthreads();

    float p[4][4], ds[4][4];
    recompute_pds<D>(qT, kT, doT, vT, lse_s, di_s, q0, k0, T, S, causal,
                     scale, ty, tx, p, ds);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dsT[(4 * tx + j) * kB + 4 * ty]) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dsT[c * kB + 4 * ty]);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      float kv[DV];
      lds<DV>(&ks[c * D + DV * tx], kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < DV; ++u) acc[i][u] = fmaf(dv[i], kv[u], acc[i][u]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= T) continue;
    Tp* o = dq + qoff + (size_t)t * D + DV * tx;
#pragma unroll
    for (int u = 0; u < DV; ++u) store1(o + u, acc[i][u] * scale);
  }
}

// K4. Shapes as K3; dk, dv (BH, S, D). Grid (ceil(S / kB), BH), block
// kThreads.
template <typename Tp, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                     const Tp* __restrict__ v, const Tp* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, Tp* __restrict__ dk,
                     Tp* __restrict__ dv, int T, int S, int causal,
                     float scale) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;             // [D][kB]   the block's keys, resident
  float* vT = kT + D * kB;      // [D][kB]
  float* qT = vT + D * kB;      // [D][kB]   the current query tile
  float* doT = qT + D * kB;     // [D][kB]
  float* qs = doT + D * kB;     // [kB][D]
  float* dos = qs + kB * D;     // [kB][D]
  float* ps = dos + kB * D;     // [kB rows][kB keys]
  float* dss = ps + kB * kB;    // [kB rows][kB keys]
  float* lse_s = dss + kB * kB;
  float* di_s = lse_s + kB;

  const int k0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t qoff = (size_t)bh * T * D, koff = (size_t)bh * S * D;

  stage_transposed<Tp, D>(k + koff, k0, S, kT);
  stage_transposed<Tp, D>(v + koff, k0, S, vT);
  // the first query row that sees key k0 (row t sees keys <= t + S - T)
  const int first_row = causal ? max(0, k0 - (S - T)) : 0;

  float ak[4][DV], av[4][DV];  // key rows 4ty + i, dims DV * tx + u
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < DV; ++u) ak[i][u] = av[i][u] = 0.f;

  for (int q0 = (first_row / kB) * kB; q0 < T; q0 += kB) {
    __syncthreads();
    stage_transposed<Tp, D>(q + qoff, q0, T, qT);
    stage_transposed<Tp, D>(dout + qoff, q0, T, doT);
    stage_rows<Tp, D>(q + qoff, q0, T, qs);
    stage_rows<Tp, D>(dout + qoff, q0, T, dos);
    stage_stats(lse + (size_t)bh * T, di + (size_t)bh * T, q0, T, lse_s,
                di_s);
    __syncthreads();

    float p[4][4], ds[4][4];
    recompute_pds<D>(qT, kT, doT, vT, lse_s, di_s, q0, k0, T, S, causal,
                     scale, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(&ps[(4 * ty + i) * kB + 4 * tx]) =
          make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
      *reinterpret_cast<float4*>(&dss[(4 * ty + i) * kB + 4 * tx]) =
          make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kB; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(&ps[r * kB + 4 * ty]);
      const float4 d4 = *reinterpret_cast<const float4*>(&dss[r * kB + 4 * ty]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
      float dov[DV], qv[DV];
      lds<DV>(&dos[r * D + DV * tx], dov);
      lds<DV>(&qs[r * D + DV * tx], qv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < DV; ++u) {
          av[i][u] = fmaf(pv[i], dov[u], av[i][u]);
          ak[i][u] = fmaf(dsv[i], qv[u], ak[i][u]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + 4 * ty + i;
    if (c >= S) continue;
    Tp* ok = dk + koff + (size_t)c * D + DV * tx;
    Tp* ov = dv + koff + (size_t)c * D + DV * tx;
#pragma unroll
    for (int u = 0; u < DV; ++u) {
      store1(ok + u, ak[i][u] * scale);
      store1(ov + u, av[i][u]);
    }
  }
}

template <typename Tp, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int BH, int T, int S, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<Tp, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((T + kB - 1) / kB, BH);
  flash_bwd_dq_kernel<Tp, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tp*>(q), static_cast<const Tp*>(k),
      static_cast<const Tp*>(v), static_cast<const Tp*>(dout), lse, di,
      static_cast<Tp*>(dq), T, S, causal, scale);
  return cudaGetLastError();
}

template <typename Tp, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int BH, int T, int S, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<Tp, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kB - 1) / kB, BH);
  flash_bwd_dkv_kernel<Tp, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tp*>(q), static_cast<const Tp*>(k),
      static_cast<const Tp*>(v), static_cast<const Tp*>(dout), lse, di,
      static_cast<Tp*>(dk), static_cast<Tp*>(dv), T, S, causal, scale);
  return cudaGetLastError();
}

bool bad_shape(int BH, int T, int S, int causal) {
  return BH <= 0 || T <= 0 || S <= 0 || BH > 65535 || (causal && S < T);
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, tiles through a cp.async ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kStages = 2;  // depth of the ring of streamed tiles

// THE mask of the bf16 backward, shared by K3 and K4: query row t sees
// key c (both in range; causal aligned bottom-right, offset = S - T).
__device__ __forceinline__ bool live(int t, int c, int T, int S, int causal,
                                     int offset) {
  return t < T && c < S && (!causal || c <= t + offset);
}

// THE element function of the bf16 backward, shared by K3 and K4, in
// place: the raw score s becomes p = exp(scale * s - lse), 0 where !lv,
// computed as 2^(s * scale2 - lse * log2 e) (scale2 = scale * log2 e),
// and dp becomes ds = p * (dp - di).
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

}  // namespace tc

}  // namespace

// C entry points (loaded with ctypes). kind: 0 = f32 tensors (CUDA-core
// kernels), 1 = bf16 (tensor-core kernels); lse and di are (BH, T) f32
// either way. Return the launch's cudaError_t (0 = launched).
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
        return launch_dq<float, decltype(dim)::value>(
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
        return launch_dkv<float, decltype(dim)::value>(
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
