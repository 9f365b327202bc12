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
`kv_dtype` stores either layout as f32, bf16 or int8 (per-(position,
head) scales; the kernels' int8 variants).

`family` supplies the model's hooks, as in the JAX batcher; by default
it follows the config (`default_family`): GPT-2's `GPTFamilyRows`, or
`models/llama.LlamaFamilyRows` for the LLaMA family, which refuses the
switches that are not ported yet (`llama.check_ported`) and whose
decode steps fold each query group into the rows of its KV head (K6 /
K7 at G rows). Either pool is sized at the model's KV heads
(`kvcache.cache_shape`).

A request enters by `submit`: its prompt prefills in `prompt_pad`-sized
chunks (full chunks plus one right-padded tail) into a transient dense
row cache of the pool's dtype (K5), the first token is sampled from the
true last prompt row, and the row installs into the request's pool
blocks or dense slot. Every `step` then advances all active slots one
token; requests retire on eos, a stop sequence or their token budget,
independently of each other.

Against the JAX batcher:
  * the cache is updated IN PLACE (torch has no donation — where the
    JAX batcher donates its cache and per-slot state to each jitted
    program and reassigns the outputs, the port writes into the same
    tensors);
  * the layer loop and the slot bookkeeping are plain Python; the
    per-slot vectors live on the host and go to the device each step;
  * sampled requests draw from a per-request torch.Generator seeded from
    (server seed, request id or seed), so a sampled stream matches the
    JAX package's only in distribution; greedy streams are identical.
  * the prefix cache, interleaved prefill/overlap, constraints, LoRA,
    logprobs, logit bias and int4 KV raise NotImplementedError (ROADMAP,
    "PyTorch/CUDA port").

The server runs on CUDA unless constructed with device="cpu"; without a
card the default raises. TF32 is switched off for the matmuls: the JAX
reference computes in f32.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from dnn_tpu_torch import resolve_device
from dnn_tpu_torch.models.gpt import GPTConfig, head, layer_params
from dnn_tpu_torch.ops.attention import merge_heads
from dnn_tpu_torch.ops.nn import embedding, layer_norm, linear
from dnn_tpu_torch.runtime.decode_buckets import (
    bucket_for,
    bucket_ladder,
    normalize_ladder,
    pad_cache_to,
)
from dnn_tpu_torch.runtime.generate import (
    TOP_P_PREFILTER_K,
    _cache_dtype,
    _mlp,
    _qkv_heads,
    _sample_rows,
    apply_repetition_penalty,
    forward_with_cache,
    init_cache,
)
from dnn_tpu_torch.runtime.kvcache import codec_for_cache
from dnn_tpu_torch.runtime.paged_kvcache import (
    BlockAllocator,
    InsufficientBlocks,
    PagedKV,
    init_paged_cache,
)

log = logging.getLogger("dnn_tpu_torch.serving")

# JAX-batcher options this port leaves out, with the ROADMAP item each
# waits on. Passing one at its "off" value is accepted (it changes
# nothing); any other value raises NotImplementedError.
_UNPORTED = {
    "prefix_cache": "item 4 (prefix cache)",
    "prefill_chunk_tokens": "item 4 (interleaved prefill)",
    "overlap": "item 4 (overlap)",
    "allow_constraints": "item 4 (constraints)",
    "allow_logit_bias": "item 4 (logit bias)",
    "lora_adapters": "item 4 (LoRA)",
    "logprobs_k": "item 4 (logprobs)",
    "compute_dtype": "item 4 (bf16 compute)",
    "ffn": "item 7 (other model families)",
}
_UNPORTED_SUBMIT = {
    "logit_bias": "item 4 (logit bias)",
    "adapter": "item 4 (LoRA)",
    "constraint": "item 4 (constraints)",
    "logprobs": "item 4 (logprobs)",
    "prefilled": "item 4 (KV handoff)",
    "kv_handle": "item 4 (KV handoff)",
    "json_depth": "item 4 (constraints)",
}


def _reject_unported(table, given: dict, *, zero_is_off: bool):
    """Raise for any `given` option of `table` set to a live value. None
    and False are off; so are 0 and empty containers where
    `zero_is_off` (constructor sizes and lists — not a request's
    adapter index, where 0 names the first adapter)."""
    live = {k: v for k, v in given.items()
            if not (v is None or v is False or (zero_is_off and not v))}
    unknown = sorted(set(given) - set(table))
    if unknown:
        raise TypeError(f"unexpected arguments {unknown}")
    if live:
        raise NotImplementedError(
            "not ported to dnn_tpu_torch yet: " + ", ".join(
                f"{k} (ROADMAP PyTorch/CUDA port {table[k]})" for k in live))


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
    forward and the per-row decode forward."""

    def __init__(self, cfg: GPTConfig):
        self.cfg = cfg

    def init_cache(self, batch: int, max_len: int, dtype, device):
        return init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, prepared, padded, row_cache, start_pos: int):
        """One (1, P) prompt chunk at [start_pos, start_pos + P) ->
        logits (1, P, V); row_cache is written in place."""
        logits, _ = forward_with_cache(prepared, padded, row_cache,
                                       start_pos, cfg=self.cfg)
        return logits

    @torch.no_grad()
    def decode_rows(self, prepared, cache, tok, pos, active, codec):
        """One step of every slot: tok/pos/active (B,) device tensors ->
        logits (B, V). Inactive slots run too (their writes go to the
        paged pool's junk block, or re-write a dense row's own value);
        their rows are discarded by the caller. Per-layer views are taken
        here, each step: a bucket grow replaces the cache tensors."""
        cfg = self.cfg
        x = (embedding(prepared["wte"], tok)
             + embedding(prepared["wpe"], pos.long()))[:, None, :]
        for i in range(cfg.n_layer):
            bp = layer_params(prepared["blocks"], i)
            c = {kk: leaf if kk == "tables" else leaf[i]
                 for kk, leaf in cache.items()}
            h = layer_norm(bp["ln_1"], x, eps=cfg.ln_eps)
            q, k, v = _qkv_heads(bp, h, cfg=cfg)
            codec.write_rows(c, k, v, pos, active)
            y = codec.attend_rows(q, c, pos)
            x = x + linear(bp["attn"]["proj"], merge_heads(y.to(x.dtype)))
            h = layer_norm(bp["ln_2"], x, eps=cfg.ln_eps)
            x = x + _mlp(bp, h)
        return head(prepared, x.float(), cfg=cfg)[:, -1]


def default_family(cfg):
    """The family hooks a config is served with: LlamaFamilyRows for a
    LlamaConfig (it raises for a switch that is not ported yet), else
    GPTFamilyRows."""
    from dnn_tpu_torch.models.llama import LlamaConfig, LlamaFamilyRows

    if isinstance(cfg, LlamaConfig):
        return LlamaFamilyRows(cfg)
    return GPTFamilyRows(cfg)


class ContinuousBatcher:
    """Slot-pool decode server over the paged or the dense KV pool.

    Usage:
        srv = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024)
        rid = srv.submit(prompt_ids, max_new_tokens=32)  # needs a free slot
        srv.step()    # every active slot advances one token
        srv.drain()   # run to completion -> {rid: np.ndarray tokens}
    """

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
                 decode_buckets=False, family=None, device=None,
                 **unported):
        if family is not None:
            # JAX's batcher (serving.py:300-326): the adapter owns the
            # model's hooks, so knobs beside it are refused
            if unported.get("ffn") is not None:
                raise ValueError(
                    "pass ffn on the family adapter, not alongside family=")
            fam_dtype = getattr(family, "compute_dtype", None)
            if unported.get("compute_dtype") not in (None, fam_dtype):
                raise ValueError(
                    f"compute_dtype mismatch: batcher="
                    f"{unported['compute_dtype']} vs family adapter="
                    f"{fam_dtype} — set it on the adapter")
        _reject_unported(_UNPORTED, unported, zero_is_off=True)
        self.family = family or default_family(cfg)
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
        self.prepared = prepared
        self.slots = slots
        self.max_len = min(max_len or cfg.block_size, cfg.block_size)
        self.prompt_pad = prompt_pad or min(64, self.max_len)
        self.paged, paged_blocks = self._choose_layout(
            kv, paged_blocks, block_len, decode_buckets)
        self.eos_id = eos_id
        self._seed = int(seed)
        self._default_temp = float(temperature)
        self._default_topk = int(top_k) if top_k else 0
        self._default_topp = float(top_p) if top_p else 0.0
        self._default_minp = float(min_p) if min_p else 0.0
        self._default_rep = (float(repetition_penalty)
                             if repetition_penalty else 1.0)
        self._cache_dtype = _cache_dtype(kv_dtype)

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
        if self.paged:
            self.allocator = BlockAllocator(paged_blocks)
            self.cache = init_paged_cache(
                cfg, slots, self.max_len, n_blocks=paged_blocks,
                block_len=block_len, dtype=self._cache_dtype,
                device=self.device)
            self._codec = PagedKV(block_len)
        else:
            self.cache = self.family.init_cache(
                slots, self._cache_len, self._cache_dtype, self.device)
            self._codec = codec_for_cache(self.cache)
        # No donation in torch: where the JAX batcher donates the pool
        # cache, the transient row and the per-slot state to its jitted
        # programs and reassigns their outputs, the port updates
        # self.cache and self._row IN PLACE (write_rows, install_row,
        # install_dense_row, the codecs' write) and keeps the per-slot
        # vectors on the host. A bucket grow is the one exception: it
        # replaces self.cache with a longer copy.
        # The transient prefill row rounds max_len UP to whole chunks, so
        # a tail chunk's write never overhangs it. One buffer serves every
        # admission: positions a chunk attends were all written by the
        # same prompt, and later positions are never read.
        self._row_len = -(-self.max_len // self.prompt_pad) * self.prompt_pad
        self._row = self.family.init_cache(1, self._row_len,
                                           self._cache_dtype, self.device)

        # per-slot state, host side; uploaded to the device each step
        self.pos = np.zeros((slots,), np.int32)    # next write position
        self.tok = np.zeros((slots,), np.int64)    # last sampled token
        self.active = np.zeros((slots,), bool)
        self._temp = np.zeros((slots,), np.float32)
        self._topk = np.zeros((slots,), np.int64)
        self._topp = np.zeros((slots,), np.float32)
        self._minp = np.zeros((slots,), np.float32)
        self._rep = np.ones((slots,), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * slots
        # per-slot vocabulary seen-mask for the repetition penalty
        self._seen = torch.zeros((slots, cfg.vocab_size), dtype=torch.bool,
                                 device=self.device)

        self._next_rid = 0
        self._slot_req: List[Optional[dict]] = [None] * slots
        self.results: Dict[int, np.ndarray] = {}
        self.finish_reasons: Dict[int, str] = {}

    def _choose_layout(self, kv, paged_blocks: int, block_len: int,
                       decode_buckets):
        """(paged?, pool block count) from `kv` as the JAX batcher decides
        it (serving.py:346-417). "auto" pages unless something blocks it,
        and then logs why."""
        if kv not in (None, "auto", "paged", "dense"):
            raise ValueError(f"kv must be 'paged', 'dense' or 'auto', got {kv!r}")
        if kv == "dense" and paged_blocks:
            raise ValueError(f"kv='dense' contradicts paged_blocks="
                             f"{paged_blocks}; drop one of them")
        paged = bool(paged_blocks)  # kv=None: paged iff blocks given
        if kv in ("paged", "auto"):
            blocker = None
            if decode_buckets:
                blocker = ("decode_buckets is a dense-pool feature (the "
                           "paged pool is already length-proportional)")
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
        return torch.from_numpy(arr).to(device=self.device, dtype=dtype)

    def submit(self, prompt, max_new_tokens: int,
               seed: Optional[int] = None, *,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               min_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               stop: Optional[list] = None, **unported) -> int:
        """Prefill `prompt` (1-D int ids) into a free slot; returns the
        request id. The first token is sampled during prefill and counts
        toward max_new_tokens. `seed` names the request's rng stream
        (default: its request id). Per-request options default to the
        constructor's; `stop` is a list of token-id sequences that end
        generation (the match is not returned). Raises RuntimeError
        without a free slot and, on the paged pool, InsufficientBlocks
        while it lacks blocks for prompt + budget."""
        _reject_unported(_UNPORTED_SUBMIT, unported, zero_is_off=False)
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

        taken = []
        if self.paged:
            # admission by ACTUAL length: the request holds
            # ceil((prompt + budget) / block_len) blocks for its lifetime
            bp = self._block_len
            n_need = -(-(len(prompt) + max_new_tokens) // bp)
            if n_need > self.allocator.n_blocks - 1:
                raise ValueError(
                    f"request needs {n_need} blocks but the pool only has "
                    f"{self.allocator.n_blocks - 1} allocatable")
            taken = self.allocator.alloc(n_need)
            if taken is None:
                raise InsufficientBlocks(
                    f"insufficient free cache blocks: need {n_need}, have "
                    f"{self.allocator.n_free} (pool "
                    f"{self.allocator.n_blocks}, block {bp} pos)")
        try:
            return self._admit(slot, prompt, max_new_tokens, seed, taken,
                               temp, tk, tp, mp, rp, stop_seqs)
        except BaseException:
            # a failure anywhere in prefill returns the blocks and the
            # slot, or the pool shrinks on every such failure
            if self.paged:
                self.allocator.free(taken)
                self.cache["tables"][slot] = 0
            self._slot_req[slot] = None
            self.active[slot] = False
            raise

    @torch.no_grad()
    def _admit(self, slot, prompt, max_new_tokens, seed, taken, temp, tk,
               tp, mp, rp, stop_seqs) -> int:
        if self.paged:
            nb_max = self.cache["tables"].shape[-1]
            ids_row = np.zeros((nb_max,), np.int32)
            ids_row[:len(taken)] = taken
            install_ids = self._upload(ids_row, torch.int32)
            self.cache["tables"][slot] = install_ids
        else:
            # the installed prompt must fit the pool AND the first decode
            # write (at position len(prompt)) must have a column
            self._ensure_cache_len(len(prompt) + 1)

        rid = self._next_rid
        self._next_rid += 1
        gen = self._generator(rid, seed) if temp > 0 else None

        # chunked prefill: full prompt_pad chunks + one padded tail, each
        # at its absolute start position, into the transient row
        p_pad = self.prompt_pad
        n_chunks = -(-len(prompt) // p_pad)
        padded = np.zeros((1, n_chunks * p_pad), np.int64)
        padded[0, :len(prompt)] = prompt
        padded_d = self._upload(padded, torch.int64)
        logits = None
        for c in range(n_chunks):
            logits = self.family.prefill(
                self.prepared, padded_d[:, c * p_pad:(c + 1) * p_pad],
                self._row, c * p_pad)
        last_local = len(prompt) - 1 - (n_chunks - 1) * p_pad

        # first token from the true last prompt row; the penalty sees the
        # prompt's tokens
        seen_row = torch.zeros((self.cfg.vocab_size,), dtype=torch.bool,
                               device=self.device)
        seen_row[self._upload(prompt, torch.int64)] = True
        lg = logits[0, last_local][None]
        lg = apply_repetition_penalty(lg, (rp != 1.0) & seen_row[None],
                                      torch.tensor(rp, device=self.device))
        first = int(_sample_rows(
            lg, [gen], temperature=torch.tensor([temp], device=self.device),
            top_k=torch.tensor([tk], device=self.device),
            top_p=torch.tensor([tp], device=self.device),
            min_p=torch.tensor([mp], device=self.device))[0])
        if self.paged:
            self._codec.install_row(self.cache, self._row, install_ids)
        else:
            install_dense_row(self.cache, self._row, slot)

        self.pos[slot] = len(prompt)
        self.tok[slot] = first
        self.active[slot] = True
        self._temp[slot], self._topk[slot] = temp, tk
        self._topp[slot], self._minp[slot], self._rep[slot] = tp, mp, rp
        self._gens[slot] = gen
        seen_row[first] = True
        self._seen[slot] = seen_row
        self._slot_req[slot] = {
            "rid": rid, "emitted": [first], "budget": max_new_tokens,
            "stop": stop_seqs, "blocks": taken, "prompt_len": len(prompt)}
        self._retire_if_done(slot)
        return rid

    # ------------------------------------------------------------------

    @staticmethod
    def _stop_match(emitted: list, stop_seqs: list) -> int:
        """Length of the stop sequence the emitted stream ends with, else 0."""
        for s in stop_seqs:
            n = len(s)
            if len(emitted) >= n and emitted[-n:] == s:
                return n
        return 0

    def _release(self, slot: int):
        req = self._slot_req[slot]
        if self.paged:
            self.allocator.free(req["blocks"])
        self._slot_req[slot] = None
        self.active[slot] = False
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
        elif len(emitted) >= req["budget"]:
            reason = "length"
        if reason is None:
            return
        self.results[req["rid"]] = np.asarray(emitted, np.int32)
        self.finish_reasons[req["rid"]] = reason
        self._release(slot)

    def claim(self, rid: int):
        """Pop a finished (or cancelled) request's record — (tokens or
        None, finish_reason). KeyError for an unknown/unfinished rid."""
        tokens = self.results.pop(rid, None)
        reason = self.finish_reasons.pop(rid, None)
        if tokens is None and reason is None:
            raise KeyError(rid)
        return tokens, reason or "length"

    def first_token(self, rid: int):
        """The token sampled during a request's prefill, or None for an
        unknown rid."""
        if rid in self.results:
            res = self.results[rid]
            return int(res[0]) if len(res) else None
        for req in self._slot_req:
            if req is not None and req["rid"] == rid:
                return int(req["emitted"][0])
        return None

    def cancel(self, rid: int) -> bool:
        """Retire a request without a result; its slot and blocks return
        to the pool at once. True if it was live or finished-unclaimed."""
        for slot, req in enumerate(self._slot_req):
            if req is not None and req["rid"] == rid:
                self._release(slot)
                self.finish_reasons[rid] = "cancelled"
                return True
        if rid in self.results:
            del self.results[rid]
            self.finish_reasons.pop(rid, None)
            return True
        return False

    @torch.no_grad()
    def step(self) -> Dict[int, int]:
        """One decode step for every active slot. Returns {rid: token}
        for the slots that advanced; finished requests move to
        .results."""
        if self.n_active == 0:
            return {}
        # this step writes each active slot's next position
        self._ensure_cache_len(int(self.pos[self.active].max()) + 1)
        active_d = self._upload(self.active, torch.bool)
        pos_d = self._upload(self.pos, torch.int32)
        tok_d = self._upload(self.tok, torch.int64)
        logits = self.family.decode_rows(self.prepared, self.cache, tok_d,
                                         pos_d, active_d, self._codec)
        rep = self._upload(self._rep, torch.float32)
        lg = apply_repetition_penalty(
            logits, (rep != 1.0)[:, None] & self._seen, rep[:, None])
        # inactive slots sample greedy (their result is discarded): a
        # retired request's stale temperature must not keep the pool on
        # the sampling branch
        temp = np.where(self.active, self._temp, 0.0).astype(np.float32)
        nxt = _sample_rows(
            lg, self._gens, temperature=self._upload(temp, torch.float32),
            top_k=self._upload(self._topk, torch.int64),
            top_p=self._upload(self._topp, torch.float32),
            min_p=self._upload(self._minp, torch.float32))
        live = torch.nonzero(active_d).flatten()
        self._seen[live, nxt[live]] = True
        toks = nxt.cpu().numpy()  # the per-step device -> host sync
        out = {}
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            token = int(toks[slot])
            self.pos[slot] += 1
            self.tok[slot] = token
            req["emitted"].append(token)
            out[req["rid"]] = token
            self._retire_if_done(slot)
        return out

    def drain(self) -> Dict[int, np.ndarray]:
        """Run until every submitted request finishes; returns .results."""
        while self.n_active:
            self.step()
        return self.results
