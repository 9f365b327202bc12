// Paged decode-attention kernel (K7) for Hopper, sm_90a.
//
// Replaces: dnn_tpu/ops/pallas/cached_attention.py:459 _paged_decode_kernel
// (entry paged_decode_attention) -- one decode step of every slot
// against a shared block pool through a per-slot block table: logical
// block j of slot b lives at pool block tables[b, j], and every query
// row of slot b attends logical columns <= pos[b].
//
// What bounds it on an H100: bytes, as K6 (decode_attention.cu): ~4
// flops per K/V element read, so the least time is each slot's live K/V
// bytes -- columns 0..pos[b] -- and their table entries, read once. The
// TPU kernel streams the table-chased blocks down a SEQUENTIAL grid axis
// with the online-softmax state in VMEM and re-targets dead logical
// blocks at the last live one so the pipeline skips their copy.
//
// Design: K6's, through the table -- the body is dec::split_block of
// decode_split.cuh, whose header comment in decode_attention.cu gives
// the reasons. A split-KV grid (n_split, B * Hk), each block all R query
// rows of one (slot, KV head) over a range of split_keys logical columns
// (a whole number of blocks: the plan, decode_split in
// cached_attention.py, rounds it up to a multiple of bp), clipped to the
// live limit min(pos[b], nb_max * bp - 1). A block reads the table
// entries of its own range once, beside pos, and keeps the pool row of
// each of its columns in shared memory (an inactive slot's entry 0 is the
// reserved junk block); it never touches a dead block or reads outside
// the pool, and no dense view of the pool is materialised. One
// (physical block, head) slab is bp * D contiguous elements, so each key
// row is 16-byte copies into a warp's cp.async ring, neighbouring lanes
// on neighbouring addresses. The splits merge in dec::decode_merge_kernel,
// in split order, no atomics.
//
// int8 pools carry one f32 scale per (position, head) for K and for V,
// in (n_blocks, Hk, bp) scale blocks read through the same table entry
// as their payload block, copied into the same ring stage. The K scale
// multiplies the score before 1/sqrt(D); the V scale is folded into the
// probability for the P.V product only -- the row sum l adds the
// unscaled probability, as the reference's softmax denominator never
// sees the V scales. The payload is read at 1 byte an element and
// widened in registers.
//
// Numerics: as K6 -- f32 accumulation, output in q's type, masked scores at
// -1e30, scale = 1/sqrt(D) multiplying, log2 units inside.

#include "decode_split.cuh"

namespace {

// q and out (B, Hk, R, D) of one type, f32 or (kBF16Q) bf16; kp, vp
// (n_blocks, Hk, bp, D) KV; ks, vs (n_blocks, Hk, bp) f32 (int8 only);
// tables (B, len / bp) int32; pos (B,) int32; ws null or the workspace of
// decode_split.cuh. Grid (n_split, B * Hk).
template <typename KV, int D, int kR, bool kBF16Q>
__global__ void __launch_bounds__(dec::kThreads, 1)
paged_decode_kernel(const Elem<kBF16Q>* __restrict__ q,
                    const KV* __restrict__ kp, const KV* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos,
                    Elem<kBF16Q>* __restrict__ out, float* __restrict__ ws,
                    int Hk, int R, int len, int bp, int split_keys,
                    float scale, int window) {
  dec::split_block<KV, D, kR, true, kBF16Q>(q, kp, vp, ks, vs, tables, pos,
                                            out, ws, Hk, R, len, bp,
                                            split_keys, scale, window, 0.f);
}

template <typename KV, int D, int kR, bool kBF16Q>
cudaError_t launch(const void* q_, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* tables,
                   const int* pos, void* out_, float* ws, int B, int Hk,
                   int R, int bp, int nb_max, int split_keys, int n_split,
                   float scale, int window, cudaStream_t stream) {
  static bool configured = false;
  const Elem<kBF16Q>* q = static_cast<const Elem<kBF16Q>*>(q_);
  Elem<kBF16Q>* out = static_cast<Elem<kBF16Q>*>(out_);
  const KV* kk = static_cast<const KV*>(kp);
  const KV* vv = static_cast<const KV*>(vp);
  const int len = nb_max * bp;
  const int rows = (split_keys * 4 + 15) / 16 * 16;
  return dec::launch<D, kBF16Q>(
      paged_decode_kernel<KV, D, kR, kBF16Q>,
      dec::Cfg<KV, D>::template smem<kR>(rows), configured, n_split, B * Hk,
      ws, pos, out, Hk, R, len, split_keys, window, stream, q, kk, vv, ks, vs,
      tables, pos, out, ws, Hk, R, len, bp, split_keys, scale, window);
}

}  // namespace

// C entry point (loaded with ctypes). D: 32, 64, 128 or 256. kv_kind: 0 =
// f32 pool, 1 = bf16, 2 = int8 and 3 = int4 (Int4: rows of D / 2 bytes)
// with ks/vs scale blocks (null for the float kinds). q_kind: 0 = f32 q and out, 1 = bf16 q and out. window: the
// band's width (<= 0: none; no softcap: the softcapped families never
// reach a paged pool). split_keys: logical columns a split, a multiple of bp; the nb_max * bp
// columns fall into n_split = ceil(nb_max * bp / split_keys) splits, and
// ws is null when n_split is 1, else an f32 workspace of n_split * B *
// Hk * R * (D + 2) floats. One call launches the split kernel and, with
// a workspace, the merge. Returns the first launch error (0 = launched).
extern "C" int dnn_paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables, const void* pos, void* out,
    void* ws, int B, int Hk, int R, int D, int bp, int nb_max, int kv_kind,
    int q_kind, int split_keys, float scale, int window, void* stream) {
  if (B <= 0 || Hk <= 0 || R <= 0 || R > dec::kMaxRows || bp <= 0 ||
      nb_max <= 0 || (long long)nb_max * bp > 0x7fffffff ||
      split_keys <= 0 || split_keys % bp != 0 ||
      (long long)B * Hk > 65535)
    return (int)cudaErrorInvalidValue;
  const int len = nb_max * bp;
  const int n_split = (len + split_keys - 1) / split_keys;
  if ((n_split > 1) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  if (kv_kind >= 2 ? (ks == nullptr || vs == nullptr)
                    : (ks != nullptr || vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* tt = static_cast<const int*>(tables);
  const int* pp = static_cast<const int*>(pos);
  float* ww = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_cache_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dec::with_rows(R, [&](auto rows) {
      constexpr int kR = decltype(rows)::value;
      return with_q_kind(q_kind, [&](auto qk) {
        constexpr bool kQ = decltype(qk)::value;
        switch (kv_kind) {
          case 0:
            return launch<float, kD, kR, kQ>(q, kp, vp, kss, vss, tt, pp, out,
                                             ww, B, Hk, R, bp, nb_max,
                                             split_keys, n_split, scale,
                                             window, st);
          case 1:
            return launch<__nv_bfloat16, kD, kR, kQ>(
                q, kp, vp, kss, vss, tt, pp, out, ww, B, Hk, R, bp, nb_max,
                split_keys, n_split, scale, window, st);
          case 2:
            return launch<int8_t, kD, kR, kQ>(q, kp, vp, kss, vss, tt, pp,
                                              out, ww, B, Hk, R, bp, nb_max,
                                              split_keys, n_split, scale,
                                              window, st);
          case 3:
            return launch<Int4, kD, kR, kQ>(q, kp, vp, kss, vss, tt, pp, out,
                                            ww, B, Hk, R, bp, nb_max,
                                            split_keys, n_split, scale,
                                            window, st);
          default:
            return cudaErrorInvalidValue;
        }
      });
    });
  });
}
