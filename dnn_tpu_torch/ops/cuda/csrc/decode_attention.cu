// Dense decode-attention kernel (K6) for Hopper, sm_90a.
//
// Replaces: dnn_tpu/ops/pallas/cached_attention.py:296 _decode_attn_kernel
// (entry decode_attention) -- one decode step of every slot against its
// dense per-slot cache: R query rows per (slot, KV head), every row of
// slot b attending cache columns <= pos[b]. It is the paged kernel (K7,
// paged_decode.cu) with the identity table: both are one body,
// dec::split_block of decode_split.cuh, over two address policies.
//
// What bounds it on an H100: bytes. A decode row does ~4 flops per K/V
// element it reads (a dot and an axpy), about 1 flop a byte in f32 --
// far below the ~295 operations a byte at which the tensor cores would
// be the limit, so the design uses no wgmma. The least time is each
// slot's live K/V bytes -- columns 0..pos[b] -- read once: at B=4 Hk=12
// D=64 with pos {0, 15, 16, 1023}, 6.5 MB of f32 cache (1.9 us at 3.35
// TB/s), or 1.6 MB of int8 payload plus 0.1 MB of f32 scales (0.5 us).
// What keeps a kernel from that is a card left mostly idle -- one block
// per (slot, head) is 48 blocks on 132 SMs, and the one long slot puts
// all of its keys on 12 of them -- and too few bytes in flight a block.
//
// Design.
//  * A split-KV grid (n_split, B * Hk). Each block owns all R query
//    rows of one (slot, KV head) and one range of split_keys columns,
//    clipped to the live limit min(pos[b], S - 1); a block whose range
//    starts past the limit exits at once, and no column past the limit
//    is read. The clamp at S - 1 matters: an inactive dense slot keeps a
//    stale pos that can equal the cache length. The plan (split_keys,
//    n_split) comes from the shapes alone (decode_split in
//    cached_attention.py: about 192 blocks of at least 64 keys), so the
//    positions stay on the device and a call can be captured in a CUDA
//    graph; it cannot see which slot is long, so it lets every slot
//    spread over many SMs: at B = 4, S = 1024, 4 splits of 256 keys (the
//    long slot alone takes 48 blocks, and a slot shorter than 256 needs
//    no merge; 128-key splits timed the same at pos {0, 15, 16, 1023}
//    and slower at a decode step's short positions); at the solo
//    decoder's B = 1, S = 316, 5 splits of 64 keys.
//  * One block for all R rows: each K/V row is read once per KV head and
//    used by every query row of it (q and the R rows' states sit in
//    registers; R <= 8, compiled for 1, 2, 4 and 8 rows). The launch
//    bounds name one block an SM as the floor, so ptxas keeps the 8-row
//    instances in registers (without it, it capped them for occupancy
//    and spilled a few bytes).
//  * The block's 8 warps are 8 pipelines: warp w takes the tiles w, w +
//    8, ... of the split (4 keys a group in f32, 8 in bf16 and int8:
//    about 4 KB of K and V a tile) through its own two-stage cp.async
//    ring in shared memory, 16 bytes a copy, neighbouring lanes on
//    neighbouring addresses, and waits only for its own copies
//    (__syncwarp). A 256-key split is two or four tiles a warp, all
//    issued at once: each tile is a dependent chain of shared loads,
//    shuffles and exp2 (about 0.3 us at the serving shape), so the
//    warps must walk their tiles side by side, not the block one tile
//    after another behind barriers. The int8 scales ride in the same
//    stage. q, pos (and K7's table entries) are loaded together, before
//    the first copy waits for pos. The payload is widened to f32 in
//    registers after the copy; no dequantized cache exists.
//  * A group of D / 4 neighbouring lanes reads one key row from shared
//    memory, 4 head dims a lane (a warp reads contiguous rows: no bank
//    conflict); the group's score is a reduction over its lanes, and each
//    group keeps its own online-softmax state (m, l, acc) per query row.
//    The block's groups merge once at the end, in (warp, group) order,
//    through the drained rings.
//  * The splits merge in a second kernel, in split order and without
//    atomics, so the result is the same bit for bit from run to run: each
//    block writes its partial (acc, m, l) to an f32 workspace that the
//    wrapper allocates, and dec::decode_merge_kernel, launched as a
//    programmatic dependent (PDL), reads for each row only the splits
//    that hold a live column, up to 8 of them in one round of loads. A
//    slot whose live columns all lie in split 0 is finished by its
//    split-0 block, and the merge skips it; where the plan has one split,
//    no merge runs.
//
// int8 caches store one f32 scale per (position, head) for K and for V.
// The K scale multiplies the score before 1/sqrt(D), as the reference
// does. The V scale is folded into the probability for the P.V product
// ONLY: the row sum l adds the unscaled probability (the reference
// scales the softmax output, whose denominator never saw the V scales).
//
// The band, the softcap and D = 256 (decode_split.cuh's header): a split
// wholly before a slot's band returns without reading, a split's tiles
// start at its first live column, the merge reads only the splits inside
// the band; the softcap caps each score in log2 units (cap * log2 e);
// at D = 256 a lane holds 8 head dims, so a key row is one warp.
//
// Numerics: f32 accumulation for every cache type, the output in q's type
// (f32, or bf16 under bf16 compute: q is read as it is), masked
// scores at -1e30 (not -inf) as the reference does, and their
// probabilities set to 0. scale = 1/sqrt(D) multiplies where the
// reference divides; the scores are kept in log2 units (exp2). A block's
// first key is live, so its first group's running max is a real score; a
// group or split with no live key has l = 0 and adds nothing.

#include "decode_split.cuh"

namespace {

// q and out (B, Hk, R, D) of one type, f32 or (kBF16Q) bf16; k, v (B,
// Hk, S, D) KV; ks, vs (B, Hk, S) f32 (int8 only); pos (B,) int32; ws
// null or the workspace of decode_split.cuh. Grid (n_split, B * Hk).
template <typename KV, int D, int kR, bool kBF16Q>
__global__ void __launch_bounds__(dec::kThreads, 1)
decode_attn_kernel(const Elem<kBF16Q>* __restrict__ q,
                   const KV* __restrict__ k, const KV* __restrict__ v,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ pos,
                   Elem<kBF16Q>* __restrict__ out, float* __restrict__ ws,
                   int Hk, int R, int S, int split_keys, float scale,
                   int window, float softcap) {
  dec::split_block<KV, D, kR, false, kBF16Q>(q, k, v, ks, vs, nullptr, pos,
                                             out, ws, Hk, R, S, 1, split_keys,
                                             scale, window, softcap);
}

template <typename KV, int D, int kR, bool kBF16Q>
cudaError_t launch(const void* q_, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos,
                   void* out_, float* ws, int B, int Hk, int R, int S,
                   int split_keys, int n_split, float scale, int window,
                   float softcap, cudaStream_t stream) {
  static bool configured = false;
  const Elem<kBF16Q>* q = static_cast<const Elem<kBF16Q>*>(q_);
  Elem<kBF16Q>* out = static_cast<Elem<kBF16Q>*>(out_);
  const KV* kk = static_cast<const KV*>(k);
  const KV* vv = static_cast<const KV*>(v);
  return dec::launch<D, kBF16Q>(
      decode_attn_kernel<KV, D, kR, kBF16Q>,
      dec::Cfg<KV, D>::template smem<kR>(0), configured, n_split, B * Hk, ws,
      pos, out, Hk, R, S, split_keys, window, stream, q, kk, vv, ks, vs, pos,
      out, ws, Hk, R, S, split_keys, scale, window, softcap);
}

}  // namespace

// C entry point (loaded with ctypes). D: 32, 64, 128 or 256. kv_kind: 0 =
// f32 cache, 1 = bf16, 2 = int8 with ks/vs scales (null for the float
// kinds). q_kind: 0 = f32 q and out, 1 = bf16 q and out. window: the
// band's width (<= 0: none); softcap: the score cap (<= 0: none).
// split_keys:
// columns a split; the cache falls into n_split = ceil(S / split_keys)
// splits, and ws is null when n_split is 1, else an f32 workspace of
// n_split * B * Hk * R * (D + 2) floats. One call launches the split
// kernel and, with a workspace, the merge. Returns the first launch
// error (0 = launched).
extern "C" int dnn_decode_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* pos,
                                    void* out, void* ws, int B, int Hk,
                                    int R, int S, int D, int kv_kind,
                                    int q_kind, int split_keys, float scale,
                                    int window, float softcap, void* stream) {
  if (B <= 0 || Hk <= 0 || R <= 0 || R > dec::kMaxRows || S <= 0 ||
      split_keys <= 0 || (long long)B * Hk > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_split = (S + split_keys - 1) / split_keys;
  if ((n_split > 1) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  if (kv_kind == 2 ? (ks == nullptr || vs == nullptr)
                   : (ks != nullptr || vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
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
            return launch<float, kD, kR, kQ>(q, k, v, kss, vss, pp, out, ww,
                                             B, Hk, R, S, split_keys, n_split,
                                             scale, window, softcap, st);
          case 1:
            return launch<__nv_bfloat16, kD, kR, kQ>(
                q, k, v, kss, vss, pp, out, ww, B, Hk, R, S, split_keys,
                n_split, scale, window, softcap, st);
          case 2:
            return launch<int8_t, kD, kR, kQ>(q, k, v, kss, vss, pp, out, ww,
                                              B, Hk, R, S, split_keys,
                                              n_split, scale, window, softcap,
                                              st);
          default:
            return cudaErrorInvalidValue;
        }
      });
    });
  });
}
