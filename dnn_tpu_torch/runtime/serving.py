"""Continuous-batching decode server for the GPT and LLaMA families
(port of the convoy path of dnn_tpu/runtime/serving.py).

A fixed pool of decode slots holds its KV cache in one of two layouts,
chosen by `kv` as the JAX batcher chooses it:
  * "paged": one shared block pool with per-slot block tables
    (runtime/paged_kvcache.py); admission by actual request length.
    Decode attention is K7.
  * "dense": one (L, slots, H, S, D) cache, a row per slot; decode
    attention is K6. With `decode_buckets` the dense cache is allocated
    at the smallest rung of a length ladder covering the live positions
    and grown rung by rung (runtime/decode_buckets.py).
  * "auto" (the default): paged whenever the configuration can page,
    else dense — the reason is logged, where the JAX batcher records a
    `kv_fallback_dense` flight event.
`kv_dtype` stores either layout as f32, bf16, int8 or int4
(per-(position, head) scales; the kernels' int8 and int4 variants); by
default it follows
`compute_dtype`. `compute_dtype=torch.bfloat16` serves in bf16 compute,
as the JAX batcher does: the residual stream and every block product in
bf16 over matmul weights held in bf16 (gpt.for_compute, cast once at
construction where they come in f32), K5/K6/K7 with bf16 queries, norms
in f32 and f32 logits. With an explicit `family` the family's type wins
and a different batcher-level one raises.

`family` supplies the model's hooks, as in the JAX batcher; by default
it follows the config (`default_family`): GPT-2's `GPTFamilyRows` (with
`ffn=`, the GPT-MoE family's routed FFN), or
`models/llama.LlamaFamilyRows` for the LLaMA family (Mixtral's and
Qwen2-MoE's experts resolved from the config), whose decode steps fold
each query group into the rows of its KV head (K6 / K7 at G rows).
Either pool is sized at the model's KV heads (`kvcache.cache_shape`).
A routed FFN runs inside the captured steps: it routes every row the
step computes, idle slots and a chunk's padding included, as JAX's.

Sliding windows and softcaps (JAX serving.py:350-503): the codecs take
the family's `window` and `softcap` (K5-K7 band and cap); an
alternating-window family hands each layer its window. Softcapped and
alternating-window families have no paged channel, and a windowed pool
does not compose with the prefix cache: kv="auto" falls back to the
dense pool for them (logged), kv="paged" raises with JAX's message. A
windowed paged pool reclaims each request's blocks once the band has
left them behind (`_free_rolled_blocks`, at install and after each
committed token), pointing their table entries at the junk block, which
K7 never reads there: a long stream holds O(window) blocks.

A request enters by `submit`. On the convoy path (the default) its
prompt prefills in `prompt_pad`-sized chunks (full chunks plus one
right-padded tail) into a transient dense row cache of the pool's dtype
(K5), the first token is sampled from the true last prompt row, and the
row installs into the request's pool blocks or dense slot. Every `step`
then advances all active slots one token; requests retire on eos, a stop
sequence or their token budget, independently of each other.

The JAX batcher's serving features of ROADMAP item 4 b-c:
  * `allow_logit_bias` / `submit(logit_bias=)`: a per-slot (B, V) bias
    added after the repetition penalty, in the step and in the
    first-token finish; `logprobs_k` / `submit(logprobs=True)`: the
    chosen token's logprob and the top k of the raw model logits per
    token, first token included, in `token_logprobs[rid]`;
  * `prefix_cache=N`: on a dense pool the exact-prefix LRU of row copies
    at full-chunk boundaries; on a paged pool the radix store
    (dnn_tpu_torch/kvtier) — shared blocks by reference, the boundary
    block copied on write, the chunk loop resumed at the first uncached
    position (mid-block: K5 at an unaligned base), insertion at
    admission and at retirement;
  * `prefill_chunk_tokens=N`: interleaved admission — `submit` only
    validates, allocates and queues; each step then runs the MIXED step,
    the decode leg exactly as the plain step plus one N-token chunk of
    the queue head's prompt, and the chunk that ends the prompt runs
    the fused finish (install, first token with the request's own
    parameters, the slot's state) with the first token read back at the
    next commit;
  * `overlap=True`: `step` dispatches step N and then commits step N-1,
    so the host's bookkeeping of N-1 runs while the card computes N;
    `flush_overlap`/`drain` commit the trailing step. A slot that
    retires at a commit has run one more masked step, whose row the
    commit discards.

And item 4 e's KV movement between replicas (JAX serving.py:1909-2276):
  * the prefill->decode row handoff: `export_prefill` (a PREFILL
    replica runs only the prompt's chunk loop and returns the row's
    leaves on the host with the last logits row, control/handoff.py's
    payload) and `submit(prefilled=)` (a DECODE replica copies that row
    into its admission row in place and finishes as a local prefill
    would: zero prompt chunks, the first token from the shipped logits
    row); `handoff_fingerprint` is the geometry both must share;
  * block migration over the radix store (kvtier/migrate.py):
    `kvtier_export` reads the resident block run of a token prefix off
    the pool, `kvtier_adopt` writes a sibling's run into fresh local
    blocks in place and inserts it with origin "adopted", and
    `stage_prefix` prefills a prompt's full blocks straight into the
    store (no slot, no sampling); `kvtier_fingerprint` is their
    geometry.

And item 4 d's constraints: `allow_constraints` / `submit(constraint=)`
(a runtime/constrain.TokenConstraint) masks every generated token to a
regex or JSON grammar. Two device pools of `constraint_rows` rows,
allocated once and written in place, hold each resident grammar's mask
rows (bool) and next-state rows (int32, global row indices; row 0 is the
unconstrained row); every slot's DFA row lives on the device and is
walked there by the step that sampled its token (and by the admission
finish, for the first token), so constrained requests ride the captured
steps, interleaved admission and overlap with no host round trip. The
host walks a mirror at commit to retire a request whose grammar admits
nothing more (finish reason "constraint"). Grammars are refcounted by
live slots and evicted in LRU order when unreferenced. The speculative
batcher (runtime/serving_spec.py) builds on this class.

On the card a step's forward (`family.decode_rows` over every slot of
the pool, inactive ones writing to the junk block — and for a mixed step
also `family.prefill` of the chunk into the transient row) is one
captured CUDA graph (`CapturedDecode`), the port's form of JAX's jitted
decode and mixed steps: captured after one eager run, replayed over
static device buffers (the slots' tokens, positions and active flags;
the chunk's ids and its start position), and captured again when the
cache tensors are replaced (a bucket grow), as JAX recompiles per
bucket. Sampling, the penalty, the bias, the grammar's mask and walk
and the logprobs run eagerly after it, on the device. A failed capture
or replay raises; the step never falls back to eager. On the CPU the
step is eager. The slots' state lives on the device, updated there by
each step (the DFA rows too), with host mirrors for bookkeeping: a
greedy step reads nothing back before its tokens, and those come
through pinned memory after a CUDA event, so under overlap the host
never waits on the step it has just dispatched.

Against the JAX batcher:
  * the cache is updated IN PLACE (torch has no donation — where the
    JAX batcher donates its cache and per-slot state to each jitted
    program and reassigns the outputs, the port writes into the same
    tensors);
  * the layer loop and the slot bookkeeping are plain Python;
  * one transient row serves every admission (JAX builds one a
    request): only the queue head folds chunks, and it finishes before
    the next begins; positions an earlier prompt left behind lie past
    every later query's limit and are overwritten before decode attends
    them;
  * sampled requests draw from a per-request torch.Generator seeded from
    (server seed, request id or seed), so a sampled stream matches the
    JAX package's only in distribution; greedy streams are identical;
  * an export prefills into the admission row on a convoy server and
    into an export row of its own, allocated at first use, on an
    interleaved one (whose admission row may hold an in-flight prompt);
    the row's positions past the prompt are blanked (zeros, int8 scales
    ones), as JAX's fresh row has them;
  * JAX's int4 pools attend on the einsum; the port's run K6/K7 on the
    packed payload (the same function).

The server runs on CUDA unless constructed with device="cpu"; without a
card the default raises. TF32 is switched off for the matmuls: the JAX
reference computes in f32.
"""

from __future__ import annotations

import logging
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from dnn_tpu_torch import obs, resolve_device
from dnn_tpu_torch.obs.compile_watch import note_capture
from dnn_tpu_torch.obs.profile import annotation_ctx as _prof_annotation
from dnn_tpu_torch.control.handoff import (
    HandoffFormatError,
    as_tensor,
    np_dtype_name,
)
from dnn_tpu_torch.models.gpt import GPTConfig, for_compute, head, layer_params
from dnn_tpu_torch.ops.attention import merge_heads
from dnn_tpu_torch.ops.cuda.cached_attention import (
    LaunchLog,
    head_dim_of,
    pack_nibbles,
    recording_launches,
    unpack_nibbles,
)
from dnn_tpu_torch.ops.nn import embedding, layer_norm, linear
from dnn_tpu_torch.runtime.decode_buckets import (
    bucket_for,
    bucket_ladder,
    normalize_ladder,
    pad_cache_to,
)
from dnn_tpu_torch.runtime.generate import (
    TOP_P_PREFILTER_K,
    _NEG_BIG,
    _cache_dtype,
    _ffn_out,
    _qkv_heads,
    _sample_rows,
    apply_repetition_penalty,
    check_compute_dtype,
    forward_with_cache,
    init_cache,
    logit_bias_array,
    logprob_outputs,
)
from dnn_tpu_torch.runtime.kvcache import codec_for_cache
from dnn_tpu_torch.runtime.paged_kvcache import (
    BlockAllocator,
    InsufficientBlocks,
    PagedKV,
    init_paged_cache,
)
from dnn_tpu_torch.utils.metrics import Throughput, labeled

log = logging.getLogger("dnn_tpu_torch.serving")

def install_dense_row(cache, row, slot: int):
    """Copy a finished transient row cache (leaves (L, 1, H, row_len[,
    D])) into `slot` of a dense pool, in place, CLAMPED at the pool's own
    position count: the row is chunk-rounded and may overhang the pool
    (a bucketed pool especially); the overhang holds only tail-pad
    garbage."""
    for kk, leaf in cache.items():
        leaf[:, slot] = row[kk][:, 0, :, :leaf.shape[3]]


class GPTFamilyRows:
    """The GPT family's per-slot hooks: the padded-prompt prefill
    forward and the per-row decode forward, at `compute_dtype` (None:
    f32; torch.bfloat16: bf16 compute, JAX's GPTFamilyRows). `ffn(bp,
    h)` overrides every block's MLP (the MoE family,
    runtime/generate_moe.moe_cache_ffn): a prefill chunk routes its
    padded (1, P) tokens, a decode step every slot's token, idle slots
    included, and a verify block its (B, T) tokens, as JAX's adapter
    routes them."""

    def __init__(self, cfg: GPTConfig, *, compute_dtype=None, ffn=None):
        self.cfg = cfg
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.ffn = ffn

    def init_cache(self, batch: int, max_len: int, dtype, device):
        return init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, prepared, padded, row_cache, start_pos):
        """One (1, P) prompt chunk at [start_pos, start_pos + P) ->
        logits (1, P, V); row_cache is written in place. `start_pos` is
        an int or a (1,) int32 device tensor (the captured mixed step)."""
        logits, _ = forward_with_cache(prepared, padded, row_cache,
                                       start_pos, cfg=self.cfg,
                                       compute_dtype=self.compute_dtype,
                                       ffn=self.ffn)
        return logits

    @torch.no_grad()
    def decode_rows(self, prepared, cache, tok, pos, active, codec):
        """One step of every slot: tok/pos/active (B,) device tensors ->
        logits (B, V). Inactive slots run too (their writes go to the
        paged pool's junk block, or re-write a dense row's own value);
        their rows are discarded by the caller. Per-layer views are taken
        here, each step: a bucket grow replaces the cache tensors."""
        return self._rows(prepared, cache, tok[:, None], pos, active,
                          codec, codec.attend_rows)[:, -1]

    @torch.no_grad()
    def verify_rows(self, prepared, cache, chunk, pos, active, codec):
        """A (B, T) token block at per-slot bases pos (B,) -> logits (B, T,
        V): K/V written at pos .. pos + T - 1 of each active slot, row t
        attending columns <= pos[b] + t (codec.attend_rows_causal, K5);
        row t's logits predict the token at pos + t + 1. The speculative
        batcher's target verify and draft sync (JAX serving.py:156-200)."""
        return self._rows(prepared, cache, chunk, pos, active, codec,
                          codec.attend_rows_causal)

    def _rows(self, prepared, cache, ids, pos, active, codec, attend):
        """ids (B, T) at per-slot positions pos[b] + t through every layer:
        the shared body of decode_rows (T = 1) and verify_rows. The
        position embedding's index clamps at the table's end, as JAX's
        gather does: only an inactive slot's stale position reaches
        it, and its row is discarded."""
        cfg, cdt = self.cfg, self.compute_dtype
        t = ids.shape[1]
        positions = (pos.long()[:, None] + torch.arange(t, device=pos.device)
                     ).clamp(max=cfg.block_size - 1)
        x = embedding(prepared["wte"], ids) + embedding(prepared["wpe"],
                                                        positions)
        if cdt is not None:
            x = x.to(cdt)
        for i in range(cfg.n_layer):
            bp = layer_params(prepared["blocks"], i)
            c = {kk: leaf if kk == "tables" else leaf[i]
                 for kk, leaf in cache.items()}
            h = layer_norm(bp["ln_1"], x, eps=cfg.ln_eps)
            q, k, v = _qkv_heads(bp, h, cfg=cfg, compute_dtype=cdt)
            codec.write_rows(c, k, v, pos, active)
            y = attend(q, c, pos)
            x = x + linear(bp["attn"]["proj"], merge_heads(y.to(x.dtype)),
                           compute_dtype=cdt)
            h = layer_norm(bp["ln_2"], x, eps=cfg.ln_eps)
            x = x + _ffn_out(bp, h, x, cdt, self.ffn)
        return head(prepared, x.float(), cfg=cfg, compute_dtype=cdt)


def default_family(cfg, compute_dtype=None, ffn=None):
    """The family hooks a config is served with: LlamaFamilyRows for a
    LlamaConfig (its MoE hook resolved from the config, Mixtral's
    default_ffn, unless `ffn` is given), else GPTFamilyRows with `ffn`
    (the GPT-MoE family's moe_cache_ffn); either at `compute_dtype`."""
    from dnn_tpu_torch.models.llama import LlamaConfig, LlamaFamilyRows

    if isinstance(cfg, LlamaConfig):
        return LlamaFamilyRows(cfg, compute_dtype=compute_dtype, ffn=ffn)
    return GPTFamilyRows(cfg, compute_dtype=compute_dtype, ffn=ffn)




def capture_cuda_graph(fn):
    """fn() captured into one CUDA graph on the current device: returns
    (graph, fn's output -- the graph's static output, rewritten by every
    replay --, the LaunchLog of the kernel calls it captured). The
    capture mode is thread-local: another thread's CUDA calls do not
    break it. Raises whatever the capture raises."""
    log = LaunchLog()
    graph = torch.cuda.CUDAGraph()
    with recording_launches(log), torch.cuda.graph(
            graph, capture_error_mode="thread_local"):
        out = fn()
    return graph, out, log


class CapturedDecode:
    """A batcher's step forwards as captured CUDA graphs: the decode step
    (`__call__`) and the mixed step (`mixed`: the decode leg plus one
    prompt chunk into the transient row), one graph each. They read the
    static device buffers `tok`, `pos`, `active` and, for the mixed step,
    `chunk` (the chunk's ids) and `start` (its first position), which a
    call refills with copy_ from the tensors or host arrays it is given
    (nothing is copied when it is given the buffers themselves, as the
    batcher that built it does). The first call of a kind, and the first
    after the cache dict (or the row) it was captured over is replaced (a
    bucket grow hands the batcher a new cache), runs the step eagerly --
    which also loads each kernel library and sets each kernel's launch
    attributes, host work a capture must not see -- and then captures
    it; every other call replays the graph and counts the kernel
    launches the capture recorded (LaunchLog.replayed), so the wrappers'
    counters keep counting launches. A graph holds the tensors it was
    captured over until it is recaptured; a capture over a new cache
    drops every graph over the old one. `capture` is `capture_cuda_graph`
    (a test may pass a stand-in with the same contract)."""

    def __init__(self, slots: int, device, capture=capture_cuda_graph,
                 chunk_tokens: int = 0, names=None):
        self.tok = torch.zeros((slots,), dtype=torch.int64, device=device)
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=device)
        self.active = torch.zeros((slots,), dtype=torch.bool, device=device)
        self.chunk = (torch.zeros((1, chunk_tokens), dtype=torch.int64,
                                  device=device) if chunk_tokens else None)
        self.start = torch.zeros((1,), dtype=torch.int32, device=device)
        self._capture = capture
        # kind -> the name its captures are counted under
        # (obs/compile_watch: a constrained pool's graphs say so)
        self._names = dict(names or {})
        self._graphs: dict = {}  # kind -> (graph, output, LaunchLog, key)
        self.counts = {"decode": [0, 0], "mixed": [0, 0]}  # captures, replays

    captures = property(lambda self: sum(c[0] for c in self.counts.values()))
    replays = property(lambda self: sum(c[1] for c in self.counts.values()))

    @staticmethod
    def _load(buf, src):
        if src is not buf:
            buf.copy_(torch.from_numpy(src) if isinstance(src, np.ndarray)
                      else src)

    def __call__(self, decode, cache, tok, pos, active):
        """decode(cache, tok, pos, active) -> logits (B, V), run on the
        static buffers after loading tok/pos/active into them. Returns the
        logits: the graph's static output on a replay, valid until the
        next call."""
        for buf, src in ((self.tok, tok), (self.pos, pos),
                         (self.active, active)):
            self._load(buf, src)
        return self.run("decode", lambda: decode(
            cache, self.tok, self.pos, self.active), (cache,))

    def mixed(self, mixed, cache, row, tok, pos, active, chunk, start):
        """mixed(cache, tok, pos, active, row, chunk, start) -> (logits
        (B, V), the chunk's logits (1, N, V)), run on the static buffers
        after loading the inputs into them; as __call__."""
        if self.chunk is None:
            self.chunk = torch.zeros_like(chunk)
        for buf, src in ((self.tok, tok), (self.pos, pos),
                         (self.active, active), (self.chunk, chunk),
                         (self.start, start)):
            self._load(buf, src)
        return self.run("mixed", lambda: mixed(
            cache, self.tok, self.pos, self.active, row, self.chunk,
            self.start), (cache, row))

    def run(self, kind, fn, key):
        """fn() -> a tensor or a tuple of them, as the graph of `kind`:
        eager and then captured at the first call and whenever `key` (the
        tensors it reads that a grow may replace: the caches, the rows)
        changes, replayed otherwise. fn must read and write only static
        buffers (as the speculative batcher's steps do: the slots' state
        lives in this object's buffers and the batcher's own)."""
        g = self._graphs.get(kind)
        if g is None or any(a is not b for a, b in zip(g[3], key)):
            out = fn()
            # the graphs over an old cache, and their memory pools, go
            # before the new capture
            for k in [k for k, v in self._graphs.items()
                      if k == kind or v[3][0] is not key[0]]:
                del self._graphs[k]
            t0 = time.perf_counter()
            graph, static, log = self._capture(fn)
            note_capture(self._names.get(kind, kind),
                         time.perf_counter() - t0)
            self._graphs[kind] = (graph, static, log, key)
            self.counts.setdefault(kind, [0, 0])[0] += 1
            return out
        graph, static, log, _ = g
        graph.replay()
        log.replayed()
        self.counts.setdefault(kind, [0, 0])[1] += 1
        return static

    def _part(self, i):
        g = self._graphs.get("decode")
        return None if g is None else g[i]

    # the decode graph's parts, by the names the card tests read
    _graph = property(lambda self: self._part(0))
    _logits = property(lambda self: self._part(1))
    _log = property(lambda self: self._part(2))
    _cache = property(lambda self: (self._part(3) or (None,))[0])


class _Readback:
    """Device tensors copied to the host without blocking the host: into
    pinned buffers, non_blocking, behind a CUDA event that `wait` waits
    on (the CPU copies at once). The commit of a step reads its tokens
    through this, so the host never waits on work it dispatched later."""

    def __init__(self, tensors):
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.clone() for t in tensors]
            self._event = None

    def wait(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class ContinuousBatcher:
    """Slot-pool decode server over the paged or the dense KV pool.

    Usage:
        srv = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024)
        rid = srv.submit(prompt_ids, max_new_tokens=32)  # needs a free slot
        srv.step()    # every active slot advances one token
        srv.drain()   # run to completion -> {rid: np.ndarray tokens}
    """

    # variants that commit more than one token a step (the speculative
    # batcher) set this False: a per-token grammar mask cannot gate a
    # verified chunk
    _constraints_ok = True

    def __init__(self, cfg, prepared, *, slots: int = 4,
                 max_len: Optional[int] = None,
                 prompt_pad: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 min_p: Optional[float] = None,
                 repetition_penalty: Optional[float] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 kv_dtype=None, kv: Optional[str] = "auto",
                 paged_blocks: int = 0, block_len: int = 16,
                 decode_buckets=False, family=None, compute_dtype=None,
                 prefix_cache: int = 0, logprobs_k: int = 0,
                 allow_logit_bias: bool = False,
                 prefill_chunk_tokens: int = 0, overlap: bool = False,
                 allow_constraints: bool = False,
                 constraint_rows: int = 1024,
                 lora_adapters=None, lora_alphas=None, ffn=None,
                 device=None):
        compute_dtype = check_compute_dtype(compute_dtype)
        if family is not None:
            # JAX's batcher (serving.py:300-326): the adapter owns the
            # model's hooks, so knobs beside it are refused, and the
            # model runs at the family's compute type
            if ffn is not None:
                raise ValueError(
                    "pass ffn on the family adapter, not alongside family=")
            fam_dtype = getattr(family, "compute_dtype", None)
            if compute_dtype is not None and fam_dtype != compute_dtype:
                raise ValueError(
                    f"compute_dtype mismatch: batcher={compute_dtype} vs "
                    f"family adapter={fam_dtype} — set it on the adapter")
            compute_dtype = fam_dtype
        self.family = family or default_family(cfg, compute_dtype, ffn)
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the JAX reference computes in f32: no TF32 on the served path
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if prepared["wte"]["embedding"].device.type != self.device.type:
            raise ValueError(
                f"prepared weights are on "
                f"{prepared['wte']['embedding'].device}, the server on "
                f"{self.device}")
        self.cfg = cfg
        self.prepared = for_compute(prepared, compute_dtype)
        self.slots = slots
        # multi-LoRA serving (JAX serving.py:263-282): `lora_adapters` is
        # a list of adapter trees against this prepared layout, stacked
        # behind an all-zero adapter 0 (the base model); a request picks
        # one by submit(adapter=i). The step forwards read the base
        # weights through lora views whose per-row one-hot selections
        # are PERSISTENT device buffers written in place at admission
        # (where JAX rebuilds its view): `_sel_d` (slots, N+1) for the
        # decode leg, `_row_sel_d` (1, N+1) for the prompt chunks that
        # fill the transient row (convoy prefill and the mixed step's
        # chunk), so a captured step reads each new assignment.
        self._lora = None
        self._n_adapters = 0
        if lora_adapters:
            from dnn_tpu_torch.lora import stack_loras, transpose_lora_stack

            stacked = transpose_lora_stack(
                stack_loras(list(lora_adapters), alphas=lora_alphas))
            self._lora = {p: {k: t.to(self.device, torch.float32)
                              for k, t in ab.items()}
                          for p, ab in stacked.items()}
            self._n_adapters = len(lora_adapters)
        self._aid = np.zeros((slots,), np.int32)  # 0 = the base model
        self._sel_d = self._row_sel_d = None
        self._decode_view = self._row_view = self.prepared
        if self._lora is not None:
            n = self._n_adapters + 1
            self._sel_d = torch.zeros((slots, n), device=self.device)
            self._sel_d[:, 0] = 1.0
            self._row_sel_d = torch.zeros((1, n), device=self.device)
            self._row_sel_d[:, 0] = 1.0
            self._decode_view = self._lora_view(self._sel_d)
            self._row_view = self._lora_view(self._row_sel_d)
        self.max_len = min(max_len or cfg.block_size, cfg.block_size)
        self.prompt_pad = prompt_pad or min(64, self.max_len)
        self.paged, paged_blocks = self._choose_layout(
            kv, paged_blocks, block_len, decode_buckets, prefix_cache)
        self.eos_id = eos_id
        self._seed = int(seed)
        self._default_temp = float(temperature)
        self._default_topk = int(top_k) if top_k else 0
        self._default_topp = float(top_p) if top_p else 0.0
        self._default_minp = float(min_p) if min_p else 0.0
        self._default_rep = (float(repetition_penalty)
                             if repetition_penalty else 1.0)
        # logprobs_k > 0: every step (and first-token finish) also yields
        # the chosen token's logprob and the top k — a construction-time
        # choice, as in JAX
        self._logprobs_k = int(logprobs_k)
        if self._logprobs_k < 0:
            raise ValueError(f"logprobs_k must be >= 0, got {logprobs_k}")
        self._cache_dtype = _cache_dtype(kv_dtype if kv_dtype is not None
                                         else compute_dtype)

        # decode bucketing (dense pool only): the pool starts at the
        # ladder's first rung and grows (_ensure_cache_len) before a
        # prompt's install and before each step that needs it
        self._buckets = None
        self._cache_len = self.max_len
        self.bucket_grows = 0
        if decode_buckets:
            self._buckets = (bucket_ladder(self.max_len)
                             if decode_buckets is True
                             else normalize_ladder(decode_buckets,
                                                   self.max_len))
            self._cache_len = self._buckets[0]
        self._block_len = block_len
        self.allocator = None
        # the family's band and cap (llama.LlamaFamilyRows; GPT-2 has
        # neither): a windowed paged pool reclaims rolled-out blocks
        window = getattr(self.family, "window", None)
        self._paged_window = window if self.paged else None
        if self.paged:
            self.allocator = BlockAllocator(paged_blocks)
            self.cache = init_paged_cache(
                cfg, slots, self.max_len, n_blocks=paged_blocks,
                block_len=block_len, dtype=self._cache_dtype,
                device=self.device)
            self._codec = PagedKV(block_len, window=window)
        else:
            self.cache = self.family.init_cache(
                slots, self._cache_len, self._cache_dtype, self.device)
            self._codec = codec_for_cache(
                self.cache, window=window,
                softcap=getattr(self.family, "softcap", None))

        # prefix cache (`prefix_cache` = capacity; 0 disables), by layout
        # as in JAX: a dense pool keeps the exact-prefix LRU (keys: the
        # int32 bytes of the adapter id 0 and of the prompt at each
        # completed full-chunk boundary; values: copies of the transient
        # row and of that chunk's last logit row); a paged pool the radix
        # store, whose capacity counts resident blocks
        self._prefix_cache: Optional[OrderedDict] = None
        self._prefix_store = None
        if prefix_cache < 0:
            raise ValueError(f"prefix_cache must be >= 0, got {prefix_cache}")
        if prefix_cache:
            if self.paged:
                from dnn_tpu_torch.kvtier import PrefixStore

                self._prefix_store = PrefixStore(self.allocator, block_len,
                                                 prefix_cache)
            else:
                self._prefix_cache = OrderedDict()
        self._prefix_cap = int(prefix_cache)
        self.prefix_hits = 0       # lookups that reused >= 1 chunk/block
        self.prefix_misses = 0     # lookups that reused nothing
        self.prefix_evictions = 0
        self._pool_exhausted_episode = False  # latch: one flight event
        # a shortage, not one a retry
        self.prefill_chunks_run = 0  # prompt chunks actually computed

        # interleaved admission (JAX serving.py:1006-1035): the mixed
        # step folds one `prefill_chunk_tokens` chunk of the queue head's
        # prompt into each step
        self._ilv = int(prefill_chunk_tokens or 0)
        if self._ilv < 0:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 0, got "
                f"{prefill_chunk_tokens}")
        if self._ilv:
            if self._ilv > self.max_len:
                raise ValueError(
                    f"prefill_chunk_tokens {self._ilv} exceeds max_len "
                    f"{self.max_len} — a chunk wider than the pool can "
                    "never install")
            if self.paged and self._ilv % block_len:
                raise ValueError(
                    f"prefill_chunk_tokens {self._ilv} must tile "
                    f"block_len {block_len} (prefill rows install whole "
                    "blocks)")
            if prefix_cache:
                raise ValueError(
                    "prefill_chunk_tokens does not compose with the "
                    "prefix cache (its lookup, copy-on-write and insert "
                    "live on the convoy admission path) — prefix-heavy "
                    "workloads keep convoy admission")
        self._overlap = bool(overlap)
        self._pending_q: List[int] = []  # slots awaiting interleaved
        # prefill, FIFO (one chunk folds per step)
        self._inflight = None  # overlap: (step index, _Readback) of the
        # dispatched, not yet committed step
        self._step_idx = 0  # counts dispatches; a slot's decode tokens
        # exist only in steps dispatched after its install

        # No donation in torch: where the JAX batcher donates the pool
        # cache, the transient row and the per-slot state to its jitted
        # programs and reassigns their outputs, the port updates them IN
        # PLACE. A bucket grow is the one exception: it replaces
        # self.cache with a longer copy.
        # The transient prefill row rounds max_len UP to whole chunks of
        # the admission width (prompt_pad, or prefill_chunk_tokens), so a
        # tail chunk's write never overhangs it. One buffer serves every
        # admission: positions a chunk attends were all written by the
        # same prompt, and later positions are never read.
        width = self._ilv or self.prompt_pad
        self._row_len = -(-self.max_len // width) * width
        self._row = self.family.init_cache(1, self._row_len,
                                           self._cache_dtype, self.device)
        # the KV handoff's row is JAX's: rounded to prompt_pad. An
        # interleaved server exports through a row of its own (_xrow,
        # allocated at first use); a convoy server's admission row is it
        self._handoff_len = -(-self.max_len // self.prompt_pad) * self.prompt_pad
        self._xrow = None

        dev, v = self.device, cfg.vocab_size
        # the step forwards' CUDA graphs (the CPU steps eagerly); their
        # static buffers ARE the slots' device state below
        self._graph_step = (CapturedDecode(
            slots, dev, chunk_tokens=self._ilv,
            names=({"decode": "constrained", "mixed": "constrained_mixed"}
                   if allow_constraints else None))
            if dev.type == "cuda" else None)
        g = self._graph_step
        # per-slot state on the device, updated there by every step (the
        # tokens a step samples feed the next without a trip through the
        # host), with host mirrors for the bookkeeping
        self._tok_d = g.tok if g else torch.zeros((slots,), dtype=torch.int64)
        self._pos_d = g.pos if g else torch.zeros((slots,), dtype=torch.int32)
        self._active_d = (g.active if g else
                          torch.zeros((slots,), dtype=torch.bool))
        self._chunk_d = g.chunk if g else (
            torch.zeros((1, self._ilv), dtype=torch.int64)
            if self._ilv else None)
        self._start_d = g.start if g else torch.zeros((1,), dtype=torch.int32)
        self._temp_d = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._topk_d = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self._topp_d = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._minp_d = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._rep_d = torch.ones((slots,), dtype=torch.float32, device=dev)
        self._slot_ids = torch.arange(slots, device=dev)
        # per-slot vocabulary seen-mask for the repetition penalty
        self._seen = torch.zeros((slots, v), dtype=torch.bool, device=dev)
        # per-slot additive logit bias: the (B, V) buffer exists only
        # when allowed (a construction-time capability, as in JAX)
        self._bias = (torch.zeros((slots, v), dtype=torch.float32, device=dev)
                      if allow_logit_bias else None)
        # constrained decoding (runtime/constrain.TokenConstraint) rides
        # two device pools, allocated once here and written in place (a
        # grammar's rows are copied in at its first submit; the tensors
        # are never replaced): `_ctable` (rows, V) bool, the mask each
        # slot's row gathers before sampling (row 0 all True: an
        # unconstrained slot adds nothing), and `_ctrans` (rows, V)
        # int32, each grammar's next-state rows in GLOBAL row indices
        # (row 0 all zeros: the unconstrained self-loop). `_crow_d` (B,)
        # is every slot's DFA row, walked on the device by the step that
        # sampled its token (`crow' = ctrans[crow, token]`); the host
        # walks a mirror at commit for finish detection only. Bytes:
        # rows x V x (1 + 4).
        self._allow_constraints = bool(allow_constraints)
        if self._allow_constraints and not self._constraints_ok:
            raise ValueError(
                f"{type(self).__name__} does not support allow_constraints=")
        self._ctab_rows = (int(constraint_rows) if self._allow_constraints
                           else 0)
        self._ctable = self._ctrans = None
        self._ctab_entries: "OrderedDict[int, dict]" = OrderedDict()
        if self._allow_constraints:
            if self._ctab_rows < 2:
                raise ValueError(
                    f"constraint_rows must be >= 2, got {constraint_rows}")
            self._ctable = torch.ones((self._ctab_rows, v), dtype=torch.bool,
                                      device=dev)
            self._ctrans = torch.zeros((self._ctab_rows, v),
                                       dtype=torch.int32, device=dev)
        self._crow_d = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.pos = np.zeros((slots,), np.int32)    # next write position
        self.tok = np.zeros((slots,), np.int64)    # last committed token
        self.active = np.zeros((slots,), bool)
        self._temp = np.zeros((slots,), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * slots

        self._next_rid = 0
        self._slot_req: List[Optional[dict]] = [None] * slots
        self.results: Dict[int, np.ndarray] = {}
        self.finish_reasons: Dict[int, str] = {}
        self.token_logprobs: Dict[int, dict] = {}
        self._init_obs(seed)

    def _init_obs(self, seed: int = 0):
        """Observability state (JAX serving.py:574-657), host mirrors
        only: nothing here reads the card. `goodput`
        (obs/goodput.GoodputTracker) and `step_clock`
        (obs/timeline.StepClock) are attached after construction (the LM
        daemon builds both when obs is on); each costs one attribute read
        a step when unset, and every feed sits behind the obs gate. Step
        counters and inter-token samples accumulate in plain fields and
        land in ONE registry update every _OBS_FLUSH_STEPS steps (and
        whenever the pool goes idle); the pool gauges are scrape-time
        callables, weakly bound (a collected pool reads 0)."""
        self._tps = Throughput()
        self.goodput = None
        self.step_clock = None
        self._n_constrained = 0
        self._bucket_keys: Dict[int, str] = {}
        self._kv_live_hw = 0
        self._active_hw = 0
        self._obs_acc_steps = 0
        self._obs_acc_tokens = 0
        self._obs_acc_bk: Optional[str] = None
        self._obs_acc_samples: list = []
        pool_ref = weakref.ref(self)

        def gauge(method):
            def read():
                pool = pool_ref()
                return getattr(pool, method)() if pool is not None else 0.0
            return read

        self._obs_gauges = {
            "serving.tokens_per_sec": gauge("_tps_read"),
            "serving.batch_occupancy": gauge("_occupancy_read"),
            "serving.kv_slot_utilization": gauge("_kv_util_read"),
            "serving.kv_live_positions_high_water": gauge("_kv_live_hw_read"),
            "serving.active_slots_high_water": gauge("_active_hw_read"),
            # the pool's bytes as allocated: an int4 pool's K/V are
            # already packed two values a byte, its f32 scales full width
            "serving.kv_cache_bytes": gauge("_kv_bytes_read"),
        }
        if self.paged:
            self._obs_gauges.update({
                "serving.paged_blocks_used": gauge("_paged_used_read"),
                "serving.paged_blocks_free": gauge("_paged_free_read"),
                "serving.paged_blocks_high_water": gauge("_paged_hw_read"),
            })
        # the memory-economy observatory (obs/kvlens.py, JAX
        # serving.py:722-752): reuse-distance sampling, the hit-ratio
        # curve and block-lifetime forensics over the radix store.
        # Attached only when the obs gate is on at construction (a
        # gate-off pool pays one `lens is not None` test a store hook);
        # the lens re-checks the gate on every call
        self._kvlens = None
        if self._prefix_store is not None and obs.enabled():
            from dnn_tpu_torch.obs.kvlens import KVLens

            n_blocks = self.allocator.n_blocks
            # the curve's axis is the EFFECTIVE pool: the allocator
            # (less its reserved null block) may hold fewer blocks than
            # the prefix_cache knob, and it is what bounds residency
            self._kvlens = KVLens(
                min(self._prefix_cap, n_blocks - 1), self._block_len,
                seed=seed,
                bytes_per_block=int(self._kv_bytes_read()) // max(
                    1, n_blocks))
            self._prefix_store.lens = self._kvlens
            self._obs_gauges.update(self._kvlens.prom_gauges())

    #: step-obs batching cadence (StepClock.FLUSH_EVERY, goodput's
    #: _FLUSH_STEPS: the same number)
    _OBS_FLUSH_STEPS = 32

    def _obs_commit(self, req, m, t_now, n_new: int = 1,
                    samples: Optional[list] = None):
        """After committing `n_new` tokens of `req`: the inter-token clock
        (a speculative chunk spreads its gap over the chunk) and the
        per-bucket decode span, one child of the request's trace per
        cache rung it decodes through (JAX serving.py:2509-2533)."""
        if m is not None:
            tl = req.get("t_last")
            if tl is not None and samples is not None:
                samples.append((t_now - tl) / max(n_new, 1))
            req["t_last"] = t_now
        else:
            # gate off: a runtime re-enable must not observe the whole
            # disabled gap as one sample
            req["t_last"] = None
        tr = req.get("trace")
        if tr and req.get("b_bucket") != self._cache_len:
            bs = req.get("b_span")
            if bs is not None:
                bs.end(tokens=len(req["emitted"]) - n_new)
            req["b_span"] = tr.child("decode", bucket=self._cache_len)
            req["b_bucket"] = self._cache_len

    def _bucket_key(self) -> str:
        key = self._bucket_keys.get(self._cache_len)
        if key is None:
            key = self._bucket_keys[self._cache_len] = labeled(
                "serving.decode_bucket_dispatch_total",
                bucket=self._cache_len)
        return key

    def _obs_step_end(self, m, n_adv: int, samples: Optional[list] = None):
        """Pool-level series for one committed step (`n_adv` tokens across
        the slots): the high-water marks, the batched registry feed, and
        the goodput tracker's numerators (JAX serving.py:2545-2591)."""
        if m is None:
            return
        live = 0
        n_act = 0
        for r in self._slot_req:
            if r is not None and "pending" not in r:
                live += r["prompt_len"] + len(r["emitted"])
                n_act += 1
        if live > self._kv_live_hw:
            self._kv_live_hw = live
        if n_act > self._active_hw:
            self._active_hw = n_act
        bk = self._bucket_key()
        if bk is not self._obs_acc_bk:
            self._obs_flush(m)
            self._obs_acc_bk = bk
        self._obs_acc_steps += 1
        self._obs_acc_tokens += n_adv
        if samples:
            self._obs_acc_samples.extend(samples)
        if self._obs_acc_steps >= self._OBS_FLUSH_STEPS or n_act == 0:
            self._obs_flush(m)
        if (g := self.goodput) is not None:
            g.on_decode_step(n_adv, live)
            if samples:
                g.on_inter_token(samples)

    def _obs_flush(self, m):
        """Land the accumulated step counters and inter-token samples in
        one bulk registry update (JAX serving.py:2599-2623)."""
        n = self._obs_acc_steps
        if not n:
            return
        if self._obs_acc_tokens:
            self._tps.add(self._obs_acc_tokens)
        samples = self._obs_acc_samples
        m.bulk(
            counters={"serving.decode_steps_total": n,
                      "serving.tokens_total": self._obs_acc_tokens,
                      self._obs_acc_bk: n},
            observations={"serving.inter_token_seconds": samples}
            if samples else None,
            gauge_fns=self._obs_gauges)
        self._obs_acc_steps = 0
        self._obs_acc_tokens = 0
        if samples:
            self._obs_acc_samples = []

    def _tps_read(self) -> float:
        return self._tps.per_sec

    def _occupancy_read(self) -> float:
        return self.n_active / self.slots

    def _kv_util_read(self) -> float:
        # live positions over the allocation, from host bookkeeping (a
        # transiently stale value is fine for a gauge)
        live = sum(r["prompt_len"] + len(r["emitted"])
                   for r in self._slot_req if r is not None)
        return live / (self.slots * self._cache_len)

    def _kv_live_hw_read(self) -> float:
        return float(self._kv_live_hw)

    def _active_hw_read(self) -> float:
        return float(self._active_hw)

    def _kv_bytes_read(self) -> float:
        # shapes and dtypes only: a scrape never touches the card
        return float(sum(t.numel() * t.element_size()
                         for t in self.cache.values()))

    def _paged_used_read(self) -> float:
        return float(self.allocator.n_used)

    def _paged_free_read(self) -> float:
        return float(self.allocator.n_free)

    def _paged_hw_read(self) -> float:
        return float(self.allocator.high_water)

    def _note_constrained(self, delta: int):
        """The live constrained-slot count, mirrored onto the step clock's
        gauge (one store a transition, nothing a step)."""
        self._n_constrained += delta
        if (sc := self.step_clock) is not None:
            sc.constrained_slots = self._n_constrained

    def _lora_view(self, sel):
        """The served weights with every adapted linear reading `sel`
        (B, N+1), a view: nothing is copied (lora.lora_view)."""
        from dnn_tpu_torch.lora import lora_view

        return lora_view(self.prepared, self._lora, sel, transposed=True)

    def _select_row_adapter(self, aid: int):
        """Points the transient row's view at adapter `aid` (0: the base
        model), writing its one-hot buffer in place; a no-op without
        LoRA."""
        if self._lora is not None:
            self._row_sel_d.zero_()
            self._row_sel_d[0, aid] = 1.0

    def _choose_layout(self, kv, paged_blocks: int, block_len: int,
                       decode_buckets, prefix_cache: int):
        """(paged?, pool block count) from `kv` as the JAX batcher decides
        it (serving.py:346-435). "auto" pages unless something blocks it,
        and then logs why."""
        if kv not in (None, "auto", "paged", "dense"):
            raise ValueError(f"kv must be 'paged', 'dense' or 'auto', got {kv!r}")
        if kv == "dense" and paged_blocks:
            raise ValueError(f"kv='dense' contradicts paged_blocks="
                             f"{paged_blocks}; drop one of them")
        paged = bool(paged_blocks)  # kv=None: paged iff blocks given
        # what the family refuses of a paged pool, in JAX's words: the kv
        # switch's blocker (:350-365), then kv=None's error (:419-435)
        family_blocker = None
        if (getattr(self.family, "softcap", None) is not None
                or getattr(self.family, "alt_window", False)):
            family_blocker = (
                "softcapped / alternating-window families have no paged "
                "channel",
                "softcapped / alternating-window families are not "
                "supported with the paged pool (PagedKV has no softcap or "
                "per-layer window channel; use the dense per-slot cache)")
        elif (getattr(self.family, "window", None) is not None
                and prefix_cache > 0):
            family_blocker = (
                "windowed paged pools do not compose with the prefix cache",
                "windowed paged pools do not compose with the prefix cache: "
                "rolled-out blocks are reclaimed mid-request, which would "
                "free blocks a prefix entry still shares — serve windowed "
                "families with prefix_cache=0")
        if kv in ("paged", "auto"):
            blocker = None
            if decode_buckets:
                blocker = ("decode_buckets is a dense-pool feature (the "
                           "paged pool is already length-proportional)")
            elif family_blocker is not None:
                blocker = family_blocker[0]
            elif self.max_len % block_len or self.prompt_pad % block_len:
                blocker = (f"max_len {self.max_len} / prompt_pad "
                           f"{self.prompt_pad} must tile block_len "
                           f"{block_len}")
            if blocker is None:
                paged = True
                if not paged_blocks:
                    # auto-size to the dense pool's capacity plus the junk
                    # block, so paging never shrinks admission capacity
                    paged_blocks = self.slots * (self.max_len // block_len) + 1
            elif kv == "paged" or paged_blocks:
                raise ValueError(
                    f"kv={kv!r}"
                    + (f" with paged_blocks={paged_blocks}" if paged_blocks
                       else "")
                    + f" is not available: {blocker}")
            else:
                log.warning("kv_fallback_dense: %s", blocker)
        if decode_buckets and paged:
            raise ValueError(
                "decode_buckets applies to the dense per-slot cache; the "
                "paged pool is already length-proportional")
        if paged and family_blocker is not None:  # kv=None, paged_blocks
            raise ValueError(family_blocker[1])
        return paged, (paged_blocks if paged else 0)

    def _ensure_cache_len(self, need: int):
        """Grow the bucketed dense pool to the smallest ladder rung
        covering `need` live positions (no-op when already covered, or on
        unbucketed pools). Grow-only, as in the JAX batcher."""
        if self._buckets is None or need <= self._cache_len:
            return
        target = bucket_for(self._buckets, need)
        self.cache = pad_cache_to(self.cache, target)
        self._cache_len = target
        self.bucket_grows += 1

    # ------------------------------------------------------------------

    def free_slots(self) -> int:
        return sum(r is None for r in self._slot_req)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _generator(self, rid: int, seed: Optional[int]) -> torch.Generator:
        """The request's private stream: (server seed, namespace, request
        seed) — independent of the rest of the pool. The namespace keeps
        auto-assigned rids and explicit seeds apart."""
        ns, val = (0, rid) if seed is None else (1, seed)
        state = np.random.SeedSequence(
            [self._seed % 2**32, ns, val % 2**63]).generate_state(2)
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
        return g

    def _upload(self, arr, dtype):
        """A host array on the device without waiting on queued device
        work: through pinned memory, non_blocking, on the card (an
        ordinary host-to-device copy waits for the stream, which under
        overlap holds the step just dispatched); a copy on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def submit(self, prompt, max_new_tokens: int,
               seed: Optional[int] = None, *,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               min_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               logit_bias: Optional[dict] = None,
               stop: Optional[list] = None, logprobs: bool = False,
               constraint=None, adapter: Optional[int] = None,
               prefilled: Optional[dict] = None, trace=None,
               **unknown) -> int:
        """Admit `prompt` (1-D int ids) into a free slot; returns the
        request id. The first token is sampled at the end of the prefill
        and counts toward max_new_tokens. `seed` names the request's rng
        stream (default: its request id). Per-request options default to
        the constructor's; `stop` is a list of token-id sequences that
        end generation (the match is not returned); `logit_bias`
        ({token_id: additive bias}, binding for greedy rows too) needs
        allow_logit_bias=True, `logprobs=True` logprobs_k > 0;
        `constraint` (a runtime/constrain.TokenConstraint) masks every
        generated token to the grammar, the first included, and retires
        the request with finish reason "constraint" once nothing can
        extend a complete match (needs allow_constraints=True);
        `adapter` indexes the constructor's `lora_adapters` (None: the
        base model) and applies to the prefill and every decode step.
        `prefilled` is a prefill replica's `export_prefill` payload for
        this prompt (control/handoff.unpack's dict): the row is adopted
        and no prompt chunk runs here (convoy admission and the base
        model only, as in JAX). `trace` (an obs.trace span: the daemon's
        request span) parents the request's spans: "admit" (the slot's
        install), under it "prefill" and a "prefill_chunk" a chunk, and
        a "decode" span a cache rung. Convoy admission prefills here;
        interleaved admission (prefill_chunk_tokens) only queues the
        prompt, whose chunks the following steps fold in. Its whole wall
        is the step clock's "admit" phase of the next step. Raises
        RuntimeError without a free slot
        and, on the paged pool, InsufficientBlocks while it lacks blocks
        for prompt + budget (after evicting what the prefix store can)."""
        if unknown:
            # JAX's batcher takes no more (the daemon resolves h= into
            # prefilled=; d= is refused before it gets here)
            raise TypeError(f"unexpected arguments {sorted(unknown)}")
        sc = self.step_clock
        t_sub = time.perf_counter() if sc is not None else 0.0
        try:
            return self._submit(prompt, max_new_tokens, seed, temperature,
                                top_k, top_p, min_p, repetition_penalty,
                                logit_bias, stop, logprobs, constraint,
                                adapter, prefilled, trace)
        finally:
            if sc is not None:
                sc.note_admit(t_sub)

    def _submit(self, prompt, max_new_tokens, seed, temperature, top_k,
                top_p, min_p, repetition_penalty, logit_bias, stop,
                logprobs, constraint, adapter, prefilled, trace) -> int:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds max_len {self.max_len}")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt ids must be in [0, {self.cfg.vocab_size})")
        temp = self._default_temp if temperature is None else float(temperature)
        tk = self._default_topk if top_k is None else int(top_k)
        tp = self._default_topp if top_p is None else float(top_p)
        mp = self._default_minp if min_p is None else float(min_p)
        rp = (self._default_rep if repetition_penalty is None
              else float(repetition_penalty))
        if temp < 0:
            raise ValueError(f"temperature must be >= 0, got {temp}")
        if tk < 0:
            raise ValueError(f"top_k must be >= 0, got {tk}")
        if not 0.0 <= tp <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {tp}")
        if not 0.0 <= mp <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {mp}")
        if rp <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {rp}")
        if logit_bias and self._bias is None:
            raise ValueError(
                "logit_bias requires allow_logit_bias=True at construction "
                "(the per-slot bias buffer is a construction-time choice)")
        b_np = logit_bias_array(logit_bias, self.cfg.vocab_size)
        if logprobs and not self._logprobs_k:
            raise ValueError(
                "logprobs requested but the server was constructed with "
                "logprobs_k=0")
        if constraint is not None:
            self._check_constraint(constraint)
        aid = 0
        if adapter is not None:
            if self._lora is None:
                raise ValueError(
                    "adapter= requires lora_adapters at construction")
            if not 0 <= int(adapter) < self._n_adapters:
                raise ValueError(
                    f"adapter {adapter} out of range "
                    f"[0, {self._n_adapters})")
            aid = int(adapter) + 1  # stack row 0 is the base model
        if prefilled is not None:
            # JAX serving.py:1384-1394
            if self._ilv:
                raise ValueError(
                    "prefilled= does not compose with prefill_chunk_tokens: "
                    "interleaved admission folds chunks into decode steps — "
                    "KV adoption rides the convoy install path")
            if adapter is not None:
                raise ValueError(
                    "prefilled= does not compose with adapter=: the "
                    "handed-off row was computed against the prefill "
                    "replica's base weights")
        tk = min(tk, TOP_P_PREFILTER_K)
        stop_seqs = []
        for s in (stop or []):
            s = np.asarray(s, np.int64).reshape(-1)
            if len(s) == 0:
                raise ValueError("empty stop sequence")
            stop_seqs.append(s.tolist())
        try:
            slot = self._slot_req.index(None)
        except ValueError:
            raise RuntimeError("no free slot; call step()/drain() first") from None
        # the grammar's rows in the device pools (a pool hit is free); the
        # reference drops if the admission fails below
        c_off = (self._ctab_register(constraint)
                 if constraint is not None else None)

        # the radix store's longest cached prefix (host lookup); its
        # entries are base-model K/V, so an adapted request bypasses it
        # (JAX serving.py:1403-1426: it runs uncached, counted neither
        # hit nor miss), as does an adopted row (no lookup runs)
        use_radix = (self._prefix_store is not None and aid == 0
                     and prefilled is None)
        kv_hit = self._prefix_store.lookup(prompt) if use_radix else None
        taken, n_shared, cow_tok, install_ids, req = [], 0, 0, None, None
        # "admit" covers the slot's install end to end
        adm = (trace.child("admit", slot=slot, prompt_len=len(prompt))
               if trace else obs.NULL_SPAN)
        try:
            if self.paged:
                taken, n_shared, cow_tok = self._alloc_blocks(
                    slot, prompt, max_new_tokens, kv_hit)
                inst = np.zeros((self.cache["tables"].shape[-1],), np.int32)
                inst[:len(taken)] = taken
                inst[:n_shared] = 0  # the shared prefix is not the request's
                install_ids = self._upload(inst, torch.int32)
            if self._buckets is not None:
                # the installed prompt must fit the pool AND the first
                # decode write (at position len(prompt)) must have a column
                self._ensure_cache_len(len(prompt) + 1)
            rid = self._next_rid
            self._next_rid += 1
            req = {"rid": rid, "emitted": [], "budget": max_new_tokens,
                   "stop": stop_seqs, "blocks": taken, "freed": 0,
                   "prompt_len": len(prompt), "aid": aid,
                   "logprobs": bool(logprobs and self._logprobs_k)}
            if req["logprobs"]:
                req["lp"], req["lp_top"] = [], []
            if trace:
                req["trace"] = trace  # the decode spans hang off it
            if constraint is not None:
                req.update(constraint=constraint, c_state=constraint.start,
                           c_off=c_off)
                self._note_constrained(1)
            par = {"gen": self._generator(rid, seed) if temp > 0 else None,
                   "t": temp, "k": tk, "p": tp, "mp": mp, "rp": rp,
                   "seen_row": self._seen_row(prompt),
                   "b_row": (None if b_np is None or self._bias is None
                             else self._upload(b_np, torch.float32)),
                   "install_ids": install_ids,
                   # the grammar's global start row: it masks the first
                   # token and seeds the slot's device DFA row (0: the
                   # unconstrained row)
                   "c_row": 0 if c_off is None else c_off + constraint.start}
            if self._ilv:
                # interleaved admission: no device work beyond the uploads
                # above; the chunks fold into the next steps (_ilv_next)
                p_c = self._ilv
                n_c = -(-len(prompt) // p_c)
                padded = np.zeros((1, n_c * p_c), np.int64)
                padded[0, :len(prompt)] = prompt
                par.update(padded=self._upload(padded, torch.int64),
                           n_chunks=n_c, next=0,
                           last_local=len(prompt) - 1 - (n_c - 1) * p_c)
                req["pending"] = par
                self._slot_req[slot] = req
                self._pending_q.append(slot)
                adm.end(interleaved=True)
                return rid
            self._admit(slot, req, prompt, par, kv_hit, n_shared, cow_tok,
                        prefilled, adm)
            adm.end()
            return rid
        except BaseException as e:
            adm.end(error=type(e).__name__)
            # a failure anywhere in the admission returns the blocks, the
            # grammar's reference and the slot, or the pools shrink on
            # every such failure
            if self.paged:
                # a windowed pool may already have reclaimed the rolled-out
                # prefix of this request's blocks (JAX serving.py:1863-1880)
                skip = (req["freed"] if req is not None
                        and self._slot_req[slot] is req else 0)
                self.allocator.free(taken[skip:])
                self.cache["tables"][slot] = 0
            if c_off is not None and not (req or {}).get("c_released"):
                self._ctab_release(constraint)
                self._crow_d[slot] = 0
                if req is not None and "constraint" in req:
                    self._note_constrained(-1)
            self._slot_req[slot] = None
            self.active[slot] = False
            self._active_d[slot] = False
            raise

    def _seen_row(self, prompt):
        """(V,) bool device row marking the prompt's tokens (the penalty
        applies to the first sample too)."""
        row = torch.zeros((self.cfg.vocab_size,), dtype=torch.bool,
                          device=self.device)
        row[self._upload(prompt, torch.int64)] = True
        return row

    def _alloc_blocks(self, slot, prompt, max_new_tokens, kv_hit):
        """The paged admission's blocks (JAX serving.py:1428-1542):
        ceil((prompt + budget) / block_len) of them, a radix hit's shared
        run by reference (refcounted), the rest fresh — evicting LRU
        prefix entries until they fit. The copy-on-write of the boundary
        block goes into the first fresh one. Writes the slot's table
        row. Returns (block ids, shared count, tokens agreed in the
        copied boundary block)."""
        bp = self._block_len
        n_need = -(-(len(prompt) + max_new_tokens) // bp)
        if n_need > self.allocator.n_blocks - 1:
            # permanent: this request can never fit the pool
            raise ValueError(
                f"request needs {n_need} blocks but the pool only has "
                f"{self.allocator.n_blocks - 1} allocatable")
        shared, cow_src, cow_tok = [], -1, 0
        if kv_hit is not None:
            shared = list(kv_hit.shared)[:n_need]
            if len(shared) == len(kv_hit.shared):
                cow_src, cow_tok = kv_hit.cow_src, kv_hit.cow_tokens
        n_shared = len(shared)
        # ref the shared prefix (and the COW source) BEFORE any eviction
        # below: the hit's own entry may be evicted while we hunt for tail
        # blocks, and without our reference its blocks could recycle into
        # this very allocation
        ref_ids = shared + ([cow_src] if cow_tok > 0 else [])
        if ref_ids:
            self.allocator.ref(ref_ids)
        try:
            owned = self._alloc_evicting(n_need - n_shared)
        except BaseException:
            if ref_ids:
                self.allocator.free(ref_ids)
            raise
        taken = shared + owned
        ids_row = np.zeros((self.cache["tables"].shape[-1],), np.int32)
        ids_row[:n_need] = taken
        self.cache["tables"][slot] = self._upload(ids_row, torch.int32)
        if cow_tok > 0:
            # the one cached block this prompt still partly agrees with,
            # copied into its first owned block (logical index n_shared);
            # the prefill resumes mid-block after the agreed tokens. The
            # temporary reference on the source drops once the copy is
            # queued (the stream runs it before any later write could
            # recycle the source)
            try:
                PagedKV.copy_block(self.cache, cow_src, owned[0])
            finally:
                self.allocator.free([cow_src])
        if kv_hit is not None and (n_shared or cow_tok):
            self._prefix_store.note_reuse(
                n_shared + (1 if cow_tok > 0 else 0),
                kv_hit.remote_used(n_shared, cow_tok > 0),
                cow=cow_tok > 0)
        return taken, n_shared, cow_tok

    @torch.no_grad()
    def _admit(self, slot, req, prompt, par, kv_hit, n_shared, cow_tok,
               prefilled=None, adm=obs.NULL_SPAN):
        """Convoy admission: the prompt's chunks (resumed after a prefix
        hit) or an adopted row, the first token and the slot's state,
        inline. `adm` parents the "prefill" span (host time: the chunks'
        launches, the finish, and the first token's readback)."""
        chunks_before = self.prefill_chunks_run
        t_pf = time.perf_counter()
        sp = adm.child("prefill", prompt_len=len(prompt))
        if prefilled is not None:
            last = self._adopt_prefilled(prefilled, prompt)
        elif kv_hit is not None:
            self._count_lookup(n_shared > 0 or cow_tok > 0)
            boundary: dict = {}
            last = self._radix_prefill(prompt, slot, kv_hit, n_shared,
                                       cow_tok, boundary, sp)
        else:
            last = self._prefill(prompt, req["aid"], sp)
        first, lp = self._finish(slot, req, last, par)
        if kv_hit is not None:
            # the prompt's full-block path, now that the install has
            # filled the owned blocks; the store refs every newly resident
            # block, the slot keeps its own references until it retires
            n_cover = len(prompt) // self._block_len
            borig = list(kv_hit.origins[:n_shared])
            if n_cover:
                self._prefix_store.insert(
                    prompt[:n_cover * self._block_len],
                    [int(x) for x in req["blocks"][:n_cover]],
                    logit_rows=boundary, origin=borig)
            req["ptoks"], req["borig"] = prompt, borig
        host = _Readback([first] + list(lp)).wait()
        first = int(host[0][0])  # the admission's one device -> host sync
        sp.end(chunks=self.prefill_chunks_run - chunks_before)
        if (m := obs.metrics()) is not None:
            req["t_last"] = time.perf_counter()  # the inter-token clock
            # the pool's scrape-time gauges (the kvlens curve among them)
            # register on admission too, as JAX's prefill bulk does: a
            # pool that has only prefilled still shows them on /metrics
            m.bulk(gauge_fns=self._obs_gauges)
            if (g := self.goodput) is not None:
                g.on_prefill(len(prompt))
            if self._kvlens is not None:
                # the thrash detector's price: what one prefill chunk
                # costs here now (an evict -> refetch bills this EMA per
                # re-run chunk)
                self._kvlens.note_prefill(
                    self.prefill_chunks_run - chunks_before,
                    time.perf_counter() - t_pf)
        self.tok[slot] = first
        req["emitted"].append(first)
        if req["logprobs"]:
            req["lp"].append(float(host[1][0]))
            req["lp_top"].append((host[3][0], host[2][0]))
        self._constraint_advance(req, first)
        if self._overlap and self._inflight is not None:
            # the uncommitted step in flight was dispatched while this
            # slot was free: its row of that step is garbage
            req["install_step"] = self._step_idx - 1
        self._slot_req[slot] = req
        # a prompt longer than the window rolls blocks out at install
        self._free_rolled_blocks(slot)
        self._retire_if_done(slot)

    def _count_lookup(self, hit: bool):
        if hit:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1

    def _chunk_ran(self):
        """One prompt chunk computed (every prefill path): the host
        counter and serving.prefill_chunks_total."""
        self.prefill_chunks_run += 1
        if (m := obs.metrics()) is not None:
            m.inc("serving.prefill_chunks_total")

    def _prefill(self, prompt, aid: int = 0, span=obs.NULL_SPAN):
        """The convoy chunk loop into the transient row — full prompt_pad
        chunks and one padded tail, each at its absolute start, through
        adapter `aid`'s weights; on a dense pool with the prefix LRU it
        resumes after the longest cached full-chunk prefix of the same
        adapter and caches each completed chunk boundary (scan-resistant:
        a new entry parks at the LRU end, only a hit promotes). Returns
        the logits row (V,) of the true last prompt token."""
        p_pad = self.prompt_pad
        n_chunks = -(-len(prompt) // p_pad)
        start_chunk, last = 0, None
        self._select_row_adapter(aid)
        # K/V depend on the weights that made them: the keys carry the
        # adapter id (JAX serving.py:1403-1406)
        key_ns = np.int32(aid).tobytes()
        key_of = (lambda c: key_ns
                  + prompt[:c * p_pad].astype(np.int32).tobytes())
        if self._prefix_cache is not None:
            for c in range(len(prompt) // p_pad, 0, -1):
                entry = self._prefix_cache.get(key_of(c))
                if entry is not None:
                    self._prefix_cache.move_to_end(key_of(c))
                    start_chunk = c
                    for kk, leaf in self._row.items():
                        leaf.copy_(entry[0][kk])
                    if c == n_chunks:  # the whole prompt was cached
                        last = entry[1]
                    break
            self._count_lookup(start_chunk > 0)
        padded = np.zeros((1, n_chunks * p_pad), np.int64)
        padded[0, :len(prompt)] = prompt
        padded_d = self._upload(padded, torch.int64)
        logits = None
        for c in range(start_chunk, n_chunks):
            c_sp = span.child("prefill_chunk", chunk=c)
            with _prof_annotation("serving.prefill_chunk"):
                logits = self.family.prefill(
                    self._row_view, padded_d[:, c * p_pad:(c + 1) * p_pad],
                    self._row, c * p_pad)
            c_sp.end()
            self._chunk_ran()
            if self._prefix_cache is not None \
                    and (c + 1) * p_pad <= len(prompt):
                while len(self._prefix_cache) >= self._prefix_cap:
                    self._evict_prefix_entry()
                key = key_of(c + 1)
                self._prefix_cache[key] = (
                    {kk: leaf.clone() for kk, leaf in self._row.items()},
                    logits[0, -1].clone())
                self._prefix_cache.move_to_end(key, last=False)
        if last is None:
            last = logits[0, len(prompt) - 1 - (n_chunks - 1) * p_pad]
        return last

    def _radix_prefill(self, prompt, slot, kv_hit, n_shared, cow_tok,
                       boundary, span=obs.NULL_SPAN):
        """The radix store's admission prefill (JAX serving.py:2311-2383):
        resume the chunk loop at the first uncached position. A full hit
        (the prompt is exactly the shared block run and its last node
        kept its logit row) runs zero chunks; otherwise the row is
        gathered from the slot's table (shared blocks and the copied
        boundary block) and full-width chunks run from the resume point,
        which may fall mid-block (K5 at an unaligned base) — backed off
        to its chunk boundary when the remaining chunks would overhang
        the row (recomputed shared positions install to the junk block).
        The logits after each completed block go to `boundary` for the
        store insert. Returns the logits row (V,) of the true last prompt
        token."""
        p_len, bp, p_pad = len(prompt), self._block_len, self.prompt_pad
        if kv_hit.logit_row is not None and p_len == n_shared * bp \
                and cow_tok == 0:
            return kv_hit.logit_row
        resume = min(n_shared * bp + cow_tok, p_len - 1)
        if resume + -(-(p_len - resume) // p_pad) * p_pad > self._row_len:
            resume = (resume // p_pad) * p_pad
        if resume:
            self._codec.gather_row(self.cache, self._row,
                                   self.cache["tables"][slot])
        n_k = -(-(p_len - resume) // p_pad)
        padded = np.zeros((1, n_k * p_pad), np.int64)
        padded[0, :p_len - resume] = prompt[resume:]
        padded_d = self._upload(padded, torch.int64)
        logits = None
        for i in range(n_k):
            start = resume + i * p_pad
            c_sp = span.child("prefill_chunk", chunk=start // p_pad)
            with _prof_annotation("serving.prefill_chunk"):
                logits = self.family.prefill(
                    self.prepared, padded_d[:, i * p_pad:(i + 1) * p_pad],
                    self._row, start)
            c_sp.end()
            self._chunk_ran()
            for b in range(start // bp, p_len // bp):
                pos = (b + 1) * bp - 1
                if pos >= start + p_pad:
                    break
                if pos >= start:
                    boundary[b] = logits[0, pos - start].clone()
        return logits[0, (p_len - resume - 1) - (n_k - 1) * p_pad]

    def _finish(self, slot, req, last, par):
        """The admission finish, all on the device (JAX's prefill_finish
        and the fused ilv_finish): the first token from the true last
        prompt row `last` (V,) — repetition penalty over the prompt, the
        request's bias, its own sampling parameters and stream —, the
        row installed into the slot's blocks or dense slot, and the
        slot's device state scattered. Returns (first token (1,) on the
        device, its logprob outputs or ())."""
        dev = self.device
        raw = last[None].float()
        lg = apply_repetition_penalty(
            raw, (par["rp"] != 1.0) & par["seen_row"][None], par["rp"])
        if par["b_row"] is not None:
            lg = lg + par["b_row"][None]
        if self._allow_constraints:
            lg = torch.where(self._ctable[par["c_row"]][None], lg, _NEG_BIG)
        first = _sample_rows(
            lg, [par["gen"]],
            temperature=torch.full((1,), par["t"], device=dev),
            top_k=torch.full((1,), par["k"], dtype=torch.int64, device=dev),
            top_p=torch.full((1,), par["p"], device=dev),
            min_p=torch.full((1,), par["mp"], device=dev),
            rows=[0] if par["t"] > 0 else [])
        if self.paged:
            self._codec.install_row(self.cache, self._row, par["install_ids"])
        else:
            install_dense_row(self.cache, self._row, slot)
        n = req["prompt_len"]
        self._pos_d[slot] = n
        self._tok_d[slot:slot + 1].copy_(first)
        self._active_d[slot] = True
        self._temp_d[slot] = par["t"]
        self._topk_d[slot] = par["k"]
        self._topp_d[slot] = par["p"]
        self._minp_d[slot] = par["mp"]
        self._rep_d[slot] = par["rp"]
        if self._lora is not None and self._aid[slot] != req["aid"]:
            # the slot's adapter, written into the decode view's one-hot
            # buffer in place (a captured step reads it at its next
            # replay)
            self._aid[slot] = req["aid"]
            self._sel_d[slot] = 0.0
            self._sel_d[slot, req["aid"]] = 1.0
        self._seen[slot] = par["seen_row"]
        self._seen[slot, first] = True
        if self._allow_constraints:
            # the slot's DFA row after its first token, walked on the
            # device (the convoy path's host mirror agrees at readback)
            self._crow_d[slot:slot + 1].copy_(
                self._ctrans[par["c_row"]][first])
        if self._bias is not None:
            if par["b_row"] is None:
                self._bias[slot] = 0.0
            else:
                self._bias[slot] = par["b_row"]
        self.pos[slot] = n
        self.active[slot] = True
        self._temp[slot] = par["t"]
        self._gens[slot] = par["gen"]
        lp = (logprob_outputs(raw, first, self._logprobs_k)
              if req["logprobs"] else ())
        return first, lp

    # ------------------------------------------------------------------
    # disaggregated prefill/decode: the row handoff (JAX
    # serving.py:1909-2038)

    def _row_spec(self):
        """[(leaf name, shape, numpy dtype name)] of the handoff row, in
        the JAX package's pytree order (sorted keys): the admission
        row's leaves at JAX's row length (prompt_pad-rounded). An int4
        row has no wire form, as in JAX: HandoffFormatError."""
        if self._cache_dtype == "int4":
            raise HandoffFormatError(
                "cache dtype int4 has no wire form (int4 caches cannot hand "
                "off; serve the prefill/decode split with f32/bf16/int8 KV)")
        out = []
        for kk in sorted(self._row):
            shape = list(self._row[kk].shape)
            shape[3] = self._handoff_len
            out.append((kk, shape, np_dtype_name(self._row[kk].dtype)))
        return out

    def handoff_fingerprint(self) -> dict:
        """The geometry both sides of a KV handoff must agree on (JAX's
        dict, equal to it for the same geometry); the daemon checks it
        at kvput, the adoption leaf by leaf."""
        return {"family": type(self.family).__name__,
                "vocab_size": int(self.cfg.vocab_size),
                "prompt_pad": int(self.prompt_pad),
                "row_len": int(self._handoff_len),
                "row_leaves": [[shape, dt] for _, shape, dt in
                               self._row_spec()]}

    def _export_row(self):
        """The row an export prefills into: the admission row on a convoy
        server (no admission is in flight between two calls), a row of
        its own on an interleaved one, whose admission row may hold a
        prompt across steps and is rounded to prefill_chunk_tokens."""
        if not self._ilv:
            return self._row
        if self._xrow is None:
            self._xrow = self.family.init_cache(
                1, self._handoff_len, self._cache_dtype, self.device)
        return self._xrow

    @torch.no_grad()
    def export_prefill(self, prompt, *, max_new_tokens: int = 1) -> dict:
        """The PREFILL replica's half of the handoff: the prompt's chunk
        loop only (K5; no slot, no install, no sampling), returning
        {"row": the row's leaves as CPU tensors in JAX's order,
        "logits_row": the true last prompt row's logits (V,),
        "prompt_len", "fingerprint"} — the payload control/handoff.pack
        ships and a decode replica adopts through submit(prefilled=).
        `max_new_tokens` only sizes the length check. Runs on the
        worker's thread (the daemon's `_BatcherWorker.call`)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("prompt must have at least one token")
        if len(prompt) + max(int(max_new_tokens), 1) > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds max_len {self.max_len}")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt ids must be in [0, {self.cfg.vocab_size})")
        p_pad = self.prompt_pad
        n_chunks = -(-len(prompt) // p_pad)
        padded = np.zeros((1, n_chunks * p_pad), np.int64)
        padded[0, :len(prompt)] = prompt
        padded_d = self._upload(padded, torch.int64)
        row = self._export_row()
        logits = None
        for c in range(n_chunks):
            with _prof_annotation("serving.prefill_chunk"):
                logits = self.family.prefill(
                    self.prepared, padded_d[:, c * p_pad:(c + 1) * p_pad],
                    row, c * p_pad)
            self._chunk_ran()
        end = n_chunks * p_pad
        for kk, leaf in row.items():
            # positions past the prompt's chunks as a fresh row has them
            leaf[:, :, :, end:] = 1 if kk in ("ks", "vs") else 0
        last = logits[0, len(prompt) - 1 - (n_chunks - 1) * p_pad]
        # a copy even on the CPU: the export row is reused by the next call
        return {"row": [row[kk][:, :, :, :self._handoff_len].to(
                            "cpu", copy=True) for kk in sorted(row)],
                "logits_row": last.cpu(), "prompt_len": len(prompt),
                "fingerprint": self.handoff_fingerprint()}

    def _adopt_prefilled(self, prefilled, prompt):
        """The DECODE replica's half: check the payload against this
        pool's row geometry (every mismatch a ValueError: adopting
        mis-shaped KV would generate plausible garbage), copy its leaves
        into the admission row IN PLACE, and return the shipped logits
        row on the device — the finish then samples the first token from
        it exactly as from a local prefill's last row."""
        got = prefilled.get("row") if isinstance(prefilled, dict) else None
        if not isinstance(got, (list, tuple)):
            raise ValueError("prefilled= expects an export_prefill payload "
                             "dict with a 'row' leaf list")
        spec = self._row_spec()
        if len(got) != len(spec):
            raise ValueError(
                f"handoff row has {len(got)} leaves but this pool's row "
                f"cache has {len(spec)} — prefill and decode replicas must "
                "share model config and kv dtype")
        leaves = [as_tensor(h) for h in got]
        for i, ((_, shape, dt), h) in enumerate(zip(spec, leaves)):
            if list(h.shape) != shape or np_dtype_name(h.dtype) != dt:
                raise ValueError(
                    f"handoff row leaf {i} is {np_dtype_name(h.dtype)}"
                    f"{tuple(h.shape)} but this pool expects {dt}"
                    f"{tuple(shape)} — prefill and decode replicas must "
                    "share model config, max_len, prompt_pad and kv dtype")
        plen = prefilled.get("prompt_len")
        if plen is not None and int(plen) != len(prompt):
            raise ValueError(
                f"handoff was exported for a {plen}-token prompt but this "
                f"request's prompt has {len(prompt)} tokens")
        lr = as_tensor(prefilled.get("logits_row"))
        if tuple(lr.shape) != (self.cfg.vocab_size,):
            raise ValueError(f"handoff logits_row has shape "
                             f"{tuple(lr.shape)}, expected "
                             f"({self.cfg.vocab_size},)")
        for (kk, _, _), h in zip(spec, leaves):
            self._row[kk].copy_(h)
        if (m := obs.metrics()) is not None:
            m.inc("serving.kv_adoptions_total")
        return lr.to(self.device)

    # ------------------------------------------------------------------
    # block migration over the radix store (JAX serving.py:2040-2276)

    def _require_store(self):
        if self._prefix_store is None:
            raise ValueError(
                "the KV tier needs the radix prefix store: construct with "
                "kv='paged' (or paged_blocks>0) and prefix_cache>0")

    def kvtier_fingerprint(self) -> dict:
        """The block geometry both sides of a migration must share (JAX's
        dict): one block's shape and dtype per pool leaf — an int4 pool's
        K/V as JAX reports them, (.., D) "int4" (blocks cross the host
        boundary as int8 values, and the wire nibble-packs them)."""
        self._require_store()
        leaves = {}
        for kk, leaf in self.cache.items():
            if kk == "tables":
                continue
            shape = [leaf.shape[0]] + list(leaf.shape[2:])
            if leaf.dtype == torch.uint8:
                leaves[kk] = [shape[:-1] + [head_dim_of(leaf)], "int4"]
            else:
                leaves[kk] = [shape, np_dtype_name(leaf.dtype)]
        return {"family": type(self.family).__name__,
                "vocab_size": int(self.cfg.vocab_size),
                "block_len": int(self._block_len),
                "leaves": leaves}

    def _read_block(self, block_id: int) -> dict:
        """One physical block's leaves, views of the pool; an int4 pool's
        K/V widened to their int8 values (JAX's _read_block)."""
        return {kk: unpack_nibbles(v) if v.dtype == torch.uint8 else v
                for kk, v in PagedKV.read_block(self.cache, block_id).items()}

    @torch.no_grad()
    def kvtier_export(self, tokens):
        """The donor's half of a migration: the longest resident run of
        full blocks matching `tokens`, copied off the pool — {"tokens",
        "block_len", "leaves": {name: (L, n, H, bp[, D]) CPU tensors},
        "logit_rows": {block index: (V,)}, "fingerprint"} for
        kvtier/migrate.pack_blocks — or None when nothing is resident.
        Worker thread only."""
        self._require_store()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        nodes = self._prefix_store.nodes_for(tokens)
        if not nodes:
            return None
        blocks = [self._read_block(n.block) for n in nodes]
        leaves = {kk: torch.stack([b[kk] for b in blocks], dim=1).cpu()
                  for kk in blocks[0]}
        return {"tokens": tokens[:len(nodes) * self._block_len],
                "block_len": self._block_len, "leaves": leaves,
                "logit_rows": {i: n.logit_row.float().cpu()
                               for i, n in enumerate(nodes)
                               if n.logit_row is not None},
                "fingerprint": self.kvtier_fingerprint()}

    def _alloc_evicting(self, n: int):
        """n fresh blocks, evicting the prefix entries in LRU order while
        the pool lacks them (entries must never starve admission; one
        whose blocks live slots still share frees nothing — keep
        evicting); InsufficientBlocks when eviction cannot make room."""
        owned = self.allocator.alloc(n)
        while owned is None and self._evictable_prefix():
            self._evict_prefix_entry()
            owned = self.allocator.alloc(n)
        if owned is None:
            # once an episode (until blocks come free): the held-back
            # request is retried every step
            if not self._pool_exhausted_episode:
                self._pool_exhausted_episode = True
                if (m := obs.metrics()) is not None:
                    m.inc("serving.pool_exhausted_total")
                obs.flight.record("pool_exhausted", need=n,
                                  free=self.allocator.n_free,
                                  high_water=self.allocator.high_water)
            raise InsufficientBlocks(
                f"insufficient free cache blocks: need {n}, have "
                f"{self.allocator.n_free} (pool {self.allocator.n_blocks}, "
                f"block {self._block_len} pos)")
        return owned

    @torch.no_grad()
    def kvtier_adopt(self, payload, *, origin: str = "adopted") -> int:
        """The adopter's half: check a sibling's block run against this
        pool's geometry, write its non-resident suffix into FRESH local
        blocks (in place: nothing of the donor's is mapped, so a dying
        donor cannot corrupt this pool), and insert the path into the
        radix store with `origin`. Returns the blocks migrated (0 when
        all were resident). Worker thread only."""
        self._require_store()
        mine = self.kvtier_fingerprint()
        theirs = payload.get("fingerprint") or {}
        if theirs and theirs != mine:
            diff = {k: (theirs.get(k), mine.get(k))
                    for k in set(theirs) | set(mine)
                    if theirs.get(k) != mine.get(k)}
            raise ValueError(
                f"kvtier geometry mismatch (theirs, mine): {diff} — donor "
                "and adopter must share model config, block_len and kv "
                "dtype")
        tokens = np.asarray(payload["tokens"], np.int32).reshape(-1)
        bp = self._block_len
        n_total = tokens.size // bp
        if n_total == 0:
            return 0
        have = self._prefix_store.nodes_for(tokens)
        n_have = len(have)
        if n_have >= n_total:
            return 0
        n_missing = n_total - n_have
        # ref the resident run BEFORE the eviction hunt, or it may evict
        # those very nodes and recycle their blocks into `owned` (two trie
        # paths over one block)
        have_ids = [n.block for n in have]
        if have_ids:
            self.allocator.ref(have_ids)
        owned = []
        try:
            owned = self._alloc_evicting(n_missing)
            vals = {kk: as_tensor(v)[:, n_have:n_total].to(self.device)
                    for kk, v in payload["leaves"].items()}
            # an int4 pool's blocks arrive as int8 values
            vals = {kk: pack_nibbles(v) if self.cache[kk].dtype == torch.uint8
                    else v for kk, v in vals.items()}
            for j, dst in enumerate(owned):
                PagedKV.write_block(self.cache,
                                    {kk: v[:, j] for kk, v in vals.items()},
                                    dst)
            lrs = {int(i): as_tensor(r).to(self.device)
                   for i, r in (payload.get("logit_rows") or {}).items()}
            self._prefix_store.insert(tokens[:n_total * bp],
                                      have_ids + owned, logit_rows=lrs,
                                      origin=origin)
        finally:
            # the store holds its own reference per inserted node; ours
            # go, freeing exactly the blocks that did not make it in
            self.allocator.free(owned + have_ids)
        if (m := obs.metrics()) is not None:
            m.inc("serving.kvtier_blocks_adopted_total", n_missing)
        if self._kvlens is not None:
            # migration forensics: blocks that crossed the wire, priced
            # in payload bytes when the transport recorded them
            self._kvlens.on_migrate(
                n_missing, int(payload.get("_wire_bytes") or 0))
        return n_missing

    @torch.no_grad()
    def stage_prefix(self, prompt) -> dict:
        """Prefill `prompt`'s full blocks STRAIGHT INTO the radix store
        (no slot, no sampling, no request's table): the prefill half of
        block migration, and a warm-up hook. Resumes at the first
        non-resident block like an admission; a wholly resident prompt
        runs nothing. Returns {"covered_blocks", "staged_blocks",
        "computed_chunks"}. Worker thread only."""
        self._require_store()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        bp, p_pad = self._block_len, self.prompt_pad
        n_cover = prompt.size // bp
        stats = {"covered_blocks": n_cover, "staged_blocks": 0,
                 "computed_chunks": 0}
        if n_cover == 0:
            return stats
        nodes = self._prefix_store.nodes_for(prompt[:n_cover * bp])
        n_shared = len(nodes)
        if n_shared >= n_cover:
            return stats
        shared_ids = [n.block for n in nodes]
        if shared_ids:
            self.allocator.ref(shared_ids)
        owned = []
        t_pf = time.perf_counter()
        try:
            owned = self._alloc_evicting(n_cover - n_shared)
            ids_row = np.zeros((self.cache["tables"].shape[-1],), np.int32)
            ids_row[:n_cover] = shared_ids + owned
            end, resume = n_cover * bp, n_shared * bp
            if resume + -(-(end - resume) // p_pad) * p_pad > self._row_len:
                resume = (resume // p_pad) * p_pad
            if resume:
                self._codec.gather_row(self.cache, self._row,
                                       self._upload(ids_row, torch.int32))
            n_k = -(-(end - resume) // p_pad)
            padded = np.zeros((1, n_k * p_pad), np.int64)
            padded[0, :end - resume] = prompt[resume:end]
            padded_d = self._upload(padded, torch.int64)
            boundary = {}
            for i in range(n_k):
                start = resume + i * p_pad
                with _prof_annotation("serving.prefill_chunk"):
                    logits = self.family.prefill(
                        self.prepared,
                        padded_d[:, i * p_pad:(i + 1) * p_pad], self._row,
                        start)
                self._chunk_ran()
                for b in range(start // bp, n_cover):
                    pos = (b + 1) * bp - 1
                    if pos >= start + p_pad:
                        break
                    if pos >= start:
                        boundary[b] = logits[0, pos - start].clone()
            inst = ids_row.copy()
            inst[:n_shared] = 0  # the resident blocks are not rewritten
            self._codec.install_row(self.cache, self._row,
                                    self._upload(inst, torch.int32))
            self._prefix_store.insert(prompt[:end],
                                      [int(x) for x in ids_row[:n_cover]],
                                      logit_rows=boundary)
            if self._kvlens is not None:
                self._kvlens.note_prefill(n_k, time.perf_counter() - t_pf)
            stats.update(staged_blocks=n_cover - n_shared,
                         computed_chunks=n_k)
            return stats
        finally:
            # transient references only: the store refs what it keeps
            self.allocator.free(shared_ids + owned)

    # ------------------------------------------------------------------
    # constrained decoding: the device pools' bookkeeping (JAX
    # serving.py:1309-1362, :2393-2502, :2768-2778)

    def _check_constraint(self, c):
        """submit's checks of a constraint, as the JAX batcher makes
        them: the capability, the vocabulary, an eos the grammar could
        consume in a token-reachable state (the eos override would ban a
        token it needs), and an empty language."""
        if not self._allow_constraints:
            raise ValueError(
                "constraint= requires allow_constraints=True at "
                "construction (the device mask pools are a "
                "construction-time choice)")
        if not self._constraints_ok:
            raise ValueError(
                "this batcher variant commits multiple tokens per step and "
                "cannot honor per-token constraints")
        if c.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"constraint compiled for vocab {c.vocab_size} != model "
                f"vocab {self.cfg.vocab_size}")
        if self.eos_id is not None \
                and c.allowed[c.reachable, self.eos_id].any():
            raise ValueError(
                f"eos_id {self.eos_id} maps to bytes this constraint's "
                "grammar can consume; serve constrained requests with a "
                "dedicated special token as eos")
        # a grammar matching only the empty string is legal when eos can
        # express it (the first sample is then forced to eos)
        if not (c.allowed[c.start].any()
                or (self.eos_id is not None and c.is_accepting(c.start))):
            raise ValueError("constraint permits no first token (empty "
                             "language over this vocab)")

    def _ctab_register(self, c) -> int:
        """Place a constraint's (S, V) tables in the device pools,
        returning its row offset. A pool hit bumps the refcount; a miss
        takes the first gap of S rows after row 0 (evicting unreferenced
        entries in LRU order while none fits) and copies the mask and
        the next-state rows, offset to global rows, IN PLACE: the pools
        are never replaced, so a captured step reads them where they
        were. Raises when the grammar cannot fit even an empty pool, or
        every row is held by live requests."""
        key = id(c)
        e = self._ctab_entries.get(key)
        if e is not None:
            e["refs"] += 1
            self._ctab_entries.move_to_end(key)
            return e["off"]
        n = c.table.shape[0]
        if n > self._ctab_rows - 1:
            raise ValueError(
                f"constraint has {n} DFA states but the device mask pool "
                f"holds {self._ctab_rows - 1} rows — construct the server "
                f"with constraint_rows >= {n + 1}")

        def free_gap():
            at = 1
            for lo, hi in sorted((v["off"], v["off"] + v["n"])
                                 for v in self._ctab_entries.values()):
                if lo - at >= n:
                    return at
                at = max(at, hi)
            return at if self._ctab_rows - at >= n else None

        off = free_gap()
        while off is None:
            victim = next((k for k, v in self._ctab_entries.items()
                           if v["refs"] == 0), None)
            if victim is None:
                raise ValueError(
                    f"constraint mask pool exhausted: {n} rows needed, all "
                    f"{self._ctab_rows - 1} allocatable rows occupied by "
                    "live requests — construct the server with a larger "
                    "constraint_rows")
            del self._ctab_entries[victim]
            off = free_gap()
        self._ctable[off:off + n].copy_(
            self._upload(c.mask_table(self.eos_id), torch.bool))
        self._ctrans[off:off + n].copy_(self._upload(
            c.trans_table(self.eos_id) + np.int32(off), torch.int32))
        self._ctab_entries[key] = {"off": off, "n": n, "refs": 1, "c": c}
        return off

    def _ctab_release(self, c):
        e = self._ctab_entries.get(id(c))
        if e is not None and e["refs"] > 0:
            e["refs"] -= 1  # the entry stays cached until evicted

    def _constraint_advance(self, req, token: int):
        """The host mirror of the device walk, for finish detection only:
        advances the request's DFA state over a committed `token` and
        sets `c_done` when nothing can extend the match and eos cannot
        express the stop (the request then retires as "constraint")."""
        c = req.get("constraint")
        if c is None or (self.eos_id is not None and token == self.eos_id):
            return
        ns = c.advance(req["c_state"], token)
        if ns < 0:
            req["c_done"] = True  # unreachable while the mask holds
            return
        req["c_state"] = ns
        if not c.has_continuation(ns) and (
                self.eos_id is None or not c.is_accepting(ns)):
            req["c_done"] = True

    # ------------------------------------------------------------------

    def _evictable_prefix(self) -> bool:
        if self._prefix_store is not None:
            return self._prefix_store.n_blocks > 0
        return bool(self._prefix_cache)

    def _evict_prefix_entry(self, cause: str = "capacity"):
        """Drop the LRU prefix entry: the dense LRU's head, or the radix
        store's LRU leaf (blocks live slots still share survive by their
        reference counts). `cause` labels the eviction ("capacity":
        admission pressure)."""
        if self._prefix_store is not None:
            if not self._prefix_store.evict_one(cause=cause):
                return
            left = self._prefix_store.n_blocks
        else:
            self._prefix_cache.popitem(last=False)
            left = len(self._prefix_cache)
        self.prefix_evictions += 1
        if (m := obs.metrics()) is not None:
            m.inc("serving.prefix_evictions_total")
            m.inc(labeled("serving.prefix_evictions_cause_total",
                          cause=cause))
        obs.flight.record("prefix_evict", entries_left=left, cause=cause)

    @staticmethod
    def _stop_match(emitted: list, stop_seqs: list) -> int:
        """Length of the stop sequence the emitted stream ends with, else 0."""
        for s in stop_seqs:
            n = len(s)
            if len(emitted) >= n and emitted[-n:] == s:
                return n
        return 0

    def _free_rolled_blocks(self, slot: int):
        """A windowed paged pool's reclamation (JAX serving.py:2453-2470):
        block j (positions [j bp, (j + 1) bp)) is dead once its last
        position is at or before limit - window, limit the slot's next
        attend limit — the band excludes it at this and every later step
        — so it returns to the allocator and its table entry points at
        the junk block 0, which K7 skips there. A long stream holds
        O(window) blocks. No-op for dense and unwindowed pools."""
        w = self._paged_window
        req = self._slot_req[slot]
        if w is None or req is None or not req["blocks"]:
            return
        bp = self._block_len
        limit = req["prompt_len"] + len(req["emitted"]) - 1
        n_dead = min(max(0, limit - w + 1) // bp, len(req["blocks"]))
        freed = req["freed"]
        if n_dead <= freed:
            return
        self.allocator.free(req["blocks"][freed:n_dead])
        self._pool_exhausted_episode = False  # blocks came free
        self.cache["tables"][slot, freed:n_dead] = 0
        req["freed"] = n_dead

    def _release(self, slot: int):
        req = self._slot_req[slot]
        if self.paged and req["blocks"]:
            # a windowed pool already reclaimed the rolled-out prefix
            self.allocator.free(req["blocks"][req["freed"]:])
            self._pool_exhausted_episode = False  # blocks came free
        if "constraint" in req and not req.get("c_released"):
            # the grammar's reference drops (its rows stay cached until
            # evicted) and the slot's device row returns to the
            # unconstrained row 0 -- on the stream after any step already
            # dispatched, so under overlap the reset lands before the
            # next dispatch reads it
            req["c_released"] = True
            self._ctab_release(req["constraint"])
            self._crow_d[slot] = 0
            self._note_constrained(-1)
        self._slot_req[slot] = None
        self.active[slot] = False
        self._active_d[slot] = False
        self._gens[slot] = None

    def _retire_if_done(self, slot: int):
        req = self._slot_req[slot]
        emitted = req["emitted"]
        reason = None
        if self.eos_id is not None and emitted[-1] == self.eos_id:
            reason = "eos"
        elif (n_stop := self._stop_match(emitted, req["stop"])):
            reason = "stop"
            emitted = emitted[:-n_stop]
        elif req.get("c_done"):
            reason = "constraint"
        elif len(emitted) >= req["budget"]:
            reason = "length"
        if reason is None:
            return
        rid = req["rid"]
        self.results[rid] = np.asarray(emitted, np.int32)
        self.finish_reasons[rid] = reason
        self._obs_retire(req, reason)
        if req["logprobs"]:
            n, k = len(emitted), self._logprobs_k
            self.token_logprobs[rid] = {
                "chosen": np.asarray(req["lp"][:n], np.float32),
                "top_ids": (np.stack([t[0] for t in req["lp_top"][:n]])
                            if n else np.zeros((0, k), np.int32)),
                "top_logprobs": (np.stack([t[1] for t in req["lp_top"][:n]])
                                 if n else np.zeros((0, k), np.float32)),
            }
        if self._prefix_store is not None and req.get("ptoks") is not None:
            # retire-time insertion (a chat follow-up's prompt is this
            # transcript plus a new message): the prompt and every FED
            # decode token (the last sampled one never was) keep their
            # full blocks resident
            fed = req["prompt_len"] + len(req["emitted"]) - 1
            n_cover = min(fed // self._block_len, len(req["blocks"]))
            if n_cover:
                toks = np.concatenate([
                    np.asarray(req["ptoks"], np.int64),
                    np.asarray(req["emitted"][:-1], np.int64)])
                self._prefix_store.insert(
                    toks[:n_cover * self._block_len],
                    req["blocks"][:n_cover], origin=req["borig"])
        self._release(slot)

    def _obs_retire(self, req, reason: str):
        """A leaving request's decode span, outcome counter, availability
        sample and flight event (host bookkeeping only), shared by
        retirement and cancel."""
        if (bs := req.get("b_span")) is not None:
            bs.end(tokens=len(req["emitted"]), reason=reason)
        if (m := obs.metrics()) is not None:
            m.inc(labeled("serving.requests_total", outcome=reason))
            if (g := self.goodput) is not None:
                # a natural retirement served its caller; a cancel
                # (client gone, deadline) counts against the budget
                g.on_outcome(ok=reason != "cancelled")
        tr = req.get("trace")
        obs.flight.record("retire", rid=req["rid"], reason=reason,
                          tokens=len(req["emitted"]),
                          trace_id=tr.trace_id if tr else None)

    def drop_inflight(self):
        """Forget a dispatched but uncommitted overlap step (the LM
        daemon's worker-death path, after cancelling the dead requests):
        its tokens belong to requests that no longer hold slots, and are
        never committed into a successor's requests."""
        self._inflight = None

    def claim(self, rid: int):
        """Pop a finished (or cancelled) request's whole record — (tokens
        or None, finish_reason, token_logprobs or None), as the JAX
        batcher's. KeyError for an unknown/unfinished rid."""
        tokens = self.results.pop(rid, None)
        reason = self.finish_reasons.pop(rid, None)
        lps = self.token_logprobs.pop(rid, None)
        if tokens is None and reason is None:
            raise KeyError(rid)
        return tokens, reason or "length", lps

    def first_token(self, rid: int):
        """The request's first token, or None for an unknown rid — and for
        an interleaved admission still prefilling or whose first token has
        not been committed yet (a later step() returns it)."""
        if rid in self.results:
            res = self.results[rid]
            return int(res[0]) if len(res) else None
        for req in self._slot_req:
            if req is not None and req["rid"] == rid:
                return int(req["emitted"][0]) if req["emitted"] else None
        return None

    def cancel(self, rid: int) -> bool:
        """Retire a request without a result; its slot and blocks return
        to the pool at once (a queued interleaved admission leaves the
        queue). True if it was live or finished-unclaimed."""
        for slot, req in enumerate(self._slot_req):
            if req is not None and req["rid"] == rid:
                if "pending" in req:
                    self._pending_q = [s for s in self._pending_q
                                       if s != slot]
                self._release(slot)
                self.finish_reasons[rid] = "cancelled"
                self._obs_retire(req, "cancelled")
                return True
        if rid in self.results:
            del self.results[rid]
            self.finish_reasons.pop(rid, None)
            self.token_logprobs.pop(rid, None)
            return True
        return False

    # ------------------------------------------------------------------

    def _ilv_next(self):
        """The queue head's next chunk, or None (JAX's _ilv_next)."""
        if not self._pending_q:
            return None
        slot = self._pending_q[0]
        req = self._slot_req[slot]
        p = req["pending"]
        c = p["next"]
        return {"slot": slot, "req": req, "p": p, "c": c,
                "last": c + 1 == p["n_chunks"]}

    def _ilv_after_chunk(self, ilv, pf_logits, s_idx):
        """After a mixed step's prefill leg: the next chunk, or — on the
        last — the fused finish, whose first token is read back at the
        first commit past this dispatch (install_step)."""
        req, p, slot = ilv["req"], ilv["p"], ilv["slot"]
        self._chunk_ran()
        if (tr := req.get("trace")) and (t0 := ilv.get("t0")) is not None:
            # the chunk rode this mixed step: its span is the step's
            # launch, on the host clock
            obs.record_span("prefill_chunk", t0, time.perf_counter() - t0,
                            parent=tr, chunk=ilv["c"], interleaved=True)
        if not ilv["last"]:
            p["next"] += 1
            return
        self._pending_q.pop(0)
        first, lp = self._finish(slot, req, pf_logits[0, p["last_local"]], p)
        req["first_dev"] = _Readback([first] + list(lp))
        req["install_step"] = s_idx
        del req["pending"]

    @torch.no_grad()
    def step(self) -> Dict[int, int]:
        """One step for every active slot. Returns {rid: token} for the
        slots whose tokens this call committed ({rid: [first, token]}
        when an interleaved admission's deferred first token commits with
        a decode token); finished requests move to .results. With
        overlap=True the call dispatches step N and commits step N-1, so
        tokens surface one call later (drain()/flush_overlap() commit the
        trailing step)."""
        if self.n_active == 0:
            return self.flush_overlap()
        # the step clock (obs/timeline.py): rec is None without a clock or
        # with obs off; its marks read the host's perf_counter only
        sc = self.step_clock
        rec = sc.begin() if sc is not None else None
        if self.active.any():
            # this step writes each active slot's next position (the host
            # mirror counts every dispatched step, committed or not)
            self._ensure_cache_len(int(self.pos[self.active].max()) + 1)
        ilv = self._ilv_next() if self._ilv else None
        state = (self.cache, self._tok_d, self._pos_d, self._active_d)
        g = self._graph_step
        pf_logits = None
        if rec is not None:
            rec.marks.append(("host", time.perf_counter()))
        if ilv is not None and ilv["req"].get("trace"):
            ilv["t0"] = time.perf_counter()
        # a capture (obs/profile.py) shows each pool step as a named
        # range on the worker's host track; a shared nullcontext while
        # no capture records
        with _prof_annotation("serving.decode_step"):
            if ilv is None:
                logits = (g(self._decode, *state) if g is not None
                          else self._decode(*state))
            else:
                n = self._ilv
                self._chunk_d.copy_(ilv["p"]["padded"][:, ilv["c"] * n:
                                                       (ilv["c"] + 1) * n])
                self._start_d.fill_(ilv["c"] * n)
                self._select_row_adapter(ilv["req"]["aid"])
                args = (self._row, self._chunk_d, self._start_d)
                logits, pf_logits = (
                    g.mixed(self._mixed, self.cache, self._row, *state[1:],
                            *args[1:])
                    if g is not None else self._mixed(*state, *args))
            nxt, lp = self._sample_step(logits)
        self.pos[self.active] += 1
        s_idx = self._step_idx
        self._step_idx += 1
        if ilv is not None:
            self._ilv_after_chunk(ilv, pf_logits, s_idx)
        readback = _Readback([nxt] + list(lp))
        if rec is not None:
            # the graph's replay (or the eager launches) and the
            # sampling's: handing the step to the card
            rec.marks.append(("dispatch", time.perf_counter()))
            rec.mixed = ilv is not None
        if self._overlap:
            if sc is not None:
                sc.overlap_depth = 1
            prev, self._inflight = self._inflight, (s_idx, readback)
            if prev is None:
                return self._pipeline_fill_end(rec, sc)
            host = prev[1].wait()
            if rec is not None:
                # with the pipeline live, the wait is what is left of
                # step N-1 after this dispatch
                rec.marks.append(("wait", time.perf_counter()))
            return self._commit_step(prev[0], host, rec, sc)
        host = readback.wait()
        if rec is not None:
            # the CUDA event's wait before the pinned readback: the
            # step's one device -> host sync
            rec.marks.append(("wait", time.perf_counter()))
        return self._commit_step(s_idx, host, rec, sc)

    def _pipeline_fill_end(self, rec, sc):
        """Close the record of a pipeline-filling dispatch (overlap's
        first call: a step went out, nothing commits), as JAX's."""
        if rec is not None:
            t = time.perf_counter()
            rec.marks.append(("wait", t))
            rec.marks.append(("commit", t))
        self._obs_step_end(obs.metrics(), 0, None)
        if rec is not None:
            rec.marks.append(("obs", time.perf_counter()))
            sc.end(rec, 0)
        return {}

    def _decode(self, cache, tok, pos, active):
        """The forward of one step over every slot: logits (B, V)."""
        return self.family.decode_rows(self._decode_view, cache, tok, pos,
                                       active, self._codec)

    def _mixed(self, cache, tok, pos, active, row, chunk, start):
        """The mixed step's forward (JAX's mixed_step): the decode leg over
        every slot, exactly as _decode, and one prompt chunk (1, N) at
        positions [start, start + N) into the transient row — the legs
        touch disjoint buffers. Returns (logits (B, V), the chunk's logits
        (1, N, V))."""
        logits = self._decode(cache, tok, pos, active)
        return logits, self.family.prefill(self._row_view, chunk, row, start)

    def _sample_step(self, logits):
        """The step's sampling, on the device (JAX's _decode_core after the
        forward): the repetition penalty, the bias, each active slot's own
        sampling parameters and stream (the host's temperatures say which
        rows sample, so a greedy pool reads nothing back), then the
        slots' next tokens, positions and seen-masks. Inactive rows keep
        their token. Returns (tokens (B,), logprob outputs or ())."""
        rep = self._rep_d
        lg = apply_repetition_penalty(
            logits, (rep != 1.0)[:, None] & self._seen, rep[:, None])
        if self._bias is not None:
            lg = lg + self._bias
        if self._allow_constraints:
            crow = self._crow_d.long()
            lg = torch.where(self._ctable[crow], lg, _NEG_BIG)
        rows = [i for i in range(self.slots)
                if self.active[i] and self._temp[i] > 0]
        nxt = _sample_rows(lg, self._gens, temperature=self._temp_d,
                           top_k=self._topk_d, top_p=self._topp_d,
                           min_p=self._minp_d, rows=rows)
        act = self._active_d
        nxt = torch.where(act, nxt, self._tok_d)
        ids = self._slot_ids
        self._seen[ids, nxt] = self._seen[ids, nxt] | act
        if self._allow_constraints:
            # the device DFA walk; trans_table's self-loops make it total
            # over masked-off tokens and eos, so a garbage overlap step
            # re-derives the same row
            self._crow_d.copy_(torch.where(act, self._ctrans[crow, nxt],
                                           self._crow_d))
        self._tok_d.copy_(nxt)
        self._pos_d += act.to(torch.int32)
        lp = (logprob_outputs(logits, nxt, self._logprobs_k)
              if self._logprobs_k else ())
        return nxt, lp

    def _commit_step(self, s_idx, host, rec=None, sc=None) -> Dict[int, int]:
        """Commit one completed step's tokens (host arrays: tokens, and the
        chosen logprobs, top logprobs and top ids when logprobs_k) to the
        host bookkeeping (JAX's _commit_step). A slot whose install
        happened at or after dispatch `s_idx` had no decode leg in it, so
        its row is skipped; the first commit past an interleaved install
        takes its deferred first token ahead of the step's own. `rec`
        and `sc`: the step clock's record, closed here (commit, obs)."""
        m = obs.metrics()
        t_now = time.perf_counter() if m is not None else 0.0
        samples: list = []
        n_adv = 0
        out = {}
        for slot, req in enumerate(self._slot_req):
            if req is None or "pending" in req:
                continue
            committed = []
            inst = req.get("install_step")
            if inst is not None:
                if s_idx <= inst:
                    continue  # dispatched before this slot's install
                del req["install_step"]
                fd = req.pop("first_dev", None)
                if fd is not None:
                    if m is not None and (g := self.goodput) is not None:
                        # prefill goodput is credited when its first
                        # token commits (the convoy path: at submit)
                        g.on_prefill(req["prompt_len"])
                    committed.append(self._commit_token(slot, req, fd.wait(),
                                                        0))
            if self._slot_req[slot] is req:
                committed.append(self._commit_token(slot, req, host, slot,
                                                    m, t_now, samples))
            if committed:
                n_adv += len(committed)
                out[req["rid"]] = (committed[0] if len(committed) == 1
                                   else committed)
        if rec is not None:
            rec.marks.append(("commit", time.perf_counter()))
        self._obs_step_end(m, n_adv, samples)
        if rec is not None:
            rec.marks.append(("obs", time.perf_counter()))
            sc.end(rec, n_adv)
        return out

    def _commit_token(self, slot, req, host, row, m=None, t_now=0.0,
                      samples=None) -> int:
        token = int(host[0][row])
        self.tok[slot] = token
        req["emitted"].append(token)
        if samples is not None:  # a decode token: its gap and span
            self._obs_commit(req, m, t_now, samples=samples)
        if req["logprobs"]:
            req["lp"].append(float(host[1][row]))
            req["lp_top"].append((host[3][row], host[2][row]))
        self._constraint_advance(req, token)
        self._free_rolled_blocks(slot)  # windowed pools reclaim
        self._retire_if_done(slot)
        return token

    def flush_overlap(self) -> Dict[int, int]:
        """Commit the trailing in-flight step (overlap mode); {} and a
        no-op otherwise. drain() calls it once the pool empties, and the
        LM daemon's idle worker too."""
        if self._inflight is None:
            return {}
        sc = self.step_clock
        rec = sc.begin() if sc is not None else None
        s_idx, readback = self._inflight
        self._inflight = None
        host = readback.wait()
        if rec is not None:
            rec.marks.append(("wait", time.perf_counter()))
        return self._commit_step(s_idx, host, rec, sc)

    def drain(self) -> Dict[int, np.ndarray]:
        """Run until every submitted request finishes; returns .results."""
        while self.n_active:
            self.step()
        self.flush_overlap()
        return self.results
