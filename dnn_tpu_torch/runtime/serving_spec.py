"""Speculative continuous batching: draft-assisted decode inside the slot
pool (port of dnn_tpu/runtime/serving_spec.py).

`runtime/speculative.py` breaks decode's serial chain for one stream;
this batcher lifts the same construction into the slot pool, where the
variable acceptance exists only as a (B,) integer, never as a shape:
every step, ALL active slots propose k draft tokens, the target verifies
every slot's k+1 positions in one forward, and each slot commits its own
m+1 <= k+1 tokens. Rejected proposals roll back by not advancing that
slot's position (their stale cache rows lie past its attention limit).

A step (`_spec_core`) runs, all on the device:
  1. the draft sync: each slot's previous verify chunk re-fed to the
     draft at its old positions (family.verify_rows: K5);
  2. k draft decode steps (family.decode_rows: K6 on the dense pool),
     greedy, or sampled from the draft's filtered distribution with each
     slot's own torch.Generator;
  3. the target's verify of the (B, k+1) chunks [last, p1..pk] at the
     slots' own bases (verify_rows: K5 at B = slots, T = k+1);
  4. per-slot acceptance: greedy, the longest prefix where the draft
     matches the target's argmax (the committed tokens ARE the target's
     picks, so greedy streams equal the plain batcher's); sampled, the
     rejection sampling of Leviathan et al. 2023 (speculative._probs is
     the one transform both sides use);
  5. per-slot commit on the device: pos += m+1 (inactive slots 0), last
     = w[m], the sync chunk kept; the (B, k+1) tokens and the (B,) counts
     come back to the host, which appends each slot's tokens checking
     budget, stop and eos per token (a stop mid-chunk retires the slot
     and drops the rest).

On the card the greedy step is one captured CUDA graph (the batcher's
CapturedDecode, kind "spec"; "spec_mixed" with an interleaved chunk),
keyed by both caches and recaptured when a bucket grow replaces them; it
reads the slots' state from static buffers and updates it in place. A
sampled step runs eagerly: its draws come from each slot's
torch.Generator, one slot at a time.

Restrictions, checked at construction and submit as JAX checks them:
equal vocabularies and a draft block_size >= max_len; spec_k >= 1; the
dense pool (kv "auto" resolves to dense here, "paged" raises); float
caches (int8 raises: chunked re-feeds would re-quantize rows); the
server's temperature and top_k only (top_p, min_p, repetition_penalty,
logprobs_k, LoRA, allow_constraints and every per-request sampling
option raise); prompts of at least k+1 tokens, and len(prompt) +
max_new + k <= max_len (the verify writes up to k positions of scratch).
decode_buckets compose: the draft pool grows in lockstep with the
target's, and every grow covers the +k scratch (_ensure_cache_len).
Interleaved prefill and overlap compose: a pending admission's chunk
folds into the step for both models (into the two transient rows), and
the fused finish installs both rows and seeds the draft sync.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from dnn_tpu_torch import obs
from dnn_tpu_torch.models.gpt import GPTConfig, for_compute
from dnn_tpu_torch.runtime.decode_buckets import pad_cache_to
from dnn_tpu_torch.runtime.kvcache import codec_for_cache
from dnn_tpu_torch.runtime.serving import (
    ContinuousBatcher,
    GPTFamilyRows,
    _Readback,
    install_dense_row,
)
from dnn_tpu_torch.runtime.speculative import _first_false, _probs

__all__ = ["SpeculativeBatcher"]

log = logging.getLogger("dnn_tpu_torch.serving")

# options of the plain batcher the speculative one refuses (JAX
# serving_spec.py:131-149)
_REFUSED = ("ffn", "paged_blocks", "logprobs_k", "top_p", "min_p",
            "repetition_penalty", "lora_adapters", "allow_constraints")
_REFUSED_SUBMIT = ("temperature", "top_k", "top_p", "min_p",
                   "repetition_penalty", "logit_bias", "logprobs")


class SpeculativeBatcher(ContinuousBatcher):
    """ContinuousBatcher whose step() advances every active slot by up to
    k+1 tokens through draft speculation. Submit, retirement, stop and
    finish reasons are the plain batcher's; step() returns {rid:
    [tokens...]}."""

    _constraints_ok = False

    def __init__(self, cfg, prepared, draft_cfg, draft_prepared, *,
                 spec_k: int = 4, draft_family=None, **kw):
        if cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError(f"draft vocab {draft_cfg.vocab_size} != target "
                             f"vocab {cfg.vocab_size}")
        kv = kw.get("kv", "auto")
        if kv == "paged":
            raise ValueError(
                "SpeculativeBatcher pins the dense pool (the spec codecs "
                "attend dense; paged x speculative is not composed)")
        if kv in ("auto", None):
            log.warning("kv_fallback_dense: speculative serving pins the "
                        "dense pool")
            kw["kv"] = "dense"
        for bad in _REFUSED:
            if kw.get(bad):
                raise ValueError(f"SpeculativeBatcher does not support {bad}=")
        if kw.get("kv_dtype") == "int8":
            raise ValueError(
                "SpeculativeBatcher pins float caches (chunked re-feeds "
                "would re-quantize int8 rows differently from the oracle "
                "path — see runtime/speculative.py)")
        super().__init__(cfg, prepared, **kw)
        if draft_cfg.block_size < self.max_len:
            raise ValueError(
                f"draft block_size {draft_cfg.block_size} < max_len "
                f"{self.max_len}; shrink max_len or use a longer draft")
        self.spec_k = k = int(spec_k)
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if draft_family is None and type(draft_cfg) is not GPTConfig:
            raise ValueError(
                f"draft_cfg is {type(draft_cfg).__name__}, not GPTConfig — "
                "pass draft_family= (e.g. llama.LlamaFamilyRows(draft_cfg))"
                " for non-GPT drafts")
        self._d_family = draft_family or GPTFamilyRows(
            draft_cfg, compute_dtype=self.family.compute_dtype)
        for fam, which in ((self.family, "target"),
                           (self._d_family, "draft")):
            # paged_ok: "attends plain causal" (False for windowed or
            # softcapped LLaMA-family configs; GPT-2 has no attribute),
            # what the dense spec codecs need (JAX serving_spec.py:180)
            if not getattr(fam, "paged_ok", True):
                raise ValueError(
                    f"speculative serving supports dense-attention "
                    f"families only (the {which} family has a sliding "
                    "window or attention softcap)")
            if not hasattr(fam, "verify_rows"):
                raise ValueError(
                    f"the {which} family adapter has no verify_rows — "
                    "speculative serving needs the per-row block verify")
        if draft_prepared["wte"]["embedding"].device.type != self.device.type:
            raise ValueError(
                f"draft weights are on "
                f"{draft_prepared['wte']['embedding'].device}, the server "
                f"on {self.device}")
        self.draft_cfg = draft_cfg
        self.draft_prepared = for_compute(draft_prepared, self.compute_dtype)
        self._temperature = float(kw.get("temperature") or 0.0)
        self._top_k_opt = kw.get("top_k") or None
        self._greedy = self._temperature == 0.0

        # the draft pool starts at the target's rung and grows with it
        dev, dt = self.device, self.cache["k"].dtype
        self.d_cache = self._d_family.init_cache(self.slots, self._cache_len,
                                                 dt, dev)
        self._d_codec = codec_for_cache(self.d_cache)
        # the draft's transient prefill row (one serves every admission,
        # as the target's)
        self._d_row = self._d_family.init_cache(1, self._row_len, dt, dev)
        # each slot's draft-sync chunk: its previous verify block and base
        self._prev_chunk = torch.zeros((self.slots, k + 1), dtype=torch.int64,
                                       device=dev)
        self._prev_pos = torch.zeros((self.slots,), dtype=torch.int32,
                                     device=dev)
        # acceptance telemetry
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0

    # ------------------------------------------------------------------

    def _ensure_cache_len(self, need: int):
        """Bucketed growth with the verify block's scratch: every grow
        covers need + spec_k (at most max_len), and the draft pool grows
        in lockstep."""
        if self._buckets is None:
            return
        super()._ensure_cache_len(min(need + self.spec_k, self.max_len))
        if self.d_cache["k"].shape[3] < self._cache_len:
            self.d_cache = pad_cache_to(self.d_cache, self._cache_len)

    def _uncommitted_need(self, lag_per_step: int) -> int:
        """The furthest position count the next dispatch writes, tokens
        the host has not committed yet included: a deferred interleaved
        first token, and `lag_per_step` positions for a step in flight
        under overlap (JAX serving.py:2981). 0 when nothing decodes."""
        need = 0
        for req in self._slot_req:
            if req is None or "pending" in req:
                continue
            u = 1 if "first_dev" in req else 0
            need = max(need, req["prompt_len"] + len(req["emitted"]) + u)
        if need and self._inflight is not None:
            need += lag_per_step
        return need

    def submit(self, prompt, max_new_tokens: int,
               seed: Optional[int] = None, **opts) -> int:
        for bad in _REFUSED_SUBMIT:
            v = opts.get(bad)
            if v is None or v is False or (isinstance(v, dict) and not v):
                continue
            raise ValueError(
                "SpeculativeBatcher uses the server-level sampling "
                f"configuration; per-request {bad}= is the dense "
                "batcher's feature")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        k = self.spec_k
        if len(prompt) < k + 1:
            raise ValueError(
                f"prompt length {len(prompt)} < spec_k+1 ({k + 1}) — the "
                "first draft-sync chunk re-feeds the prompt tail")
        if len(prompt) + max_new_tokens + k > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} + spec_k "
                f"{k} exceeds max_len {self.max_len} (the verify chunk "
                "writes up to k scratch positions)")
        rid = super().submit(prompt, max_new_tokens, seed=seed, **opts)
        slot = next((i for i, r in enumerate(self._slot_req)
                     if r is not None and r["rid"] == rid), None)
        if slot is None:
            return rid  # a budget-1 request retired at submit
        tail = self._upload(prompt[-(k + 1):], torch.int64)
        req = self._slot_req[slot]
        if "pending" in req:
            # interleaved: the draft's chunks fold into the steps beside
            # the target's; the fused finish seeds the sync from the tail
            req["pending"]["tail"] = tail
            return rid
        with torch.no_grad():
            p_pad = self.prompt_pad
            n_chunks = -(-len(prompt) // p_pad)
            padded = np.zeros((1, n_chunks * p_pad), np.int64)
            padded[0, :len(prompt)] = prompt
            padded_d = self._upload(padded, torch.int64)
            for c in range(n_chunks):
                self._d_family.prefill(
                    self.draft_prepared,
                    padded_d[:, c * p_pad:(c + 1) * p_pad], self._d_row,
                    c * p_pad)
            self._seed_draft(slot, len(prompt), tail)
        return rid

    def _seed_draft(self, slot: int, prompt_len: int, tail):
        """The draft row installed into the slot, and its first sync
        chunk: the prompt's own tail at its own positions."""
        install_dense_row(self.d_cache, self._d_row, slot)
        self._prev_chunk[slot].copy_(tail)
        self._prev_pos[slot] = prompt_len - (self.spec_k + 1)

    def _ilv_after_chunk(self, ilv, pf_logits, s_idx):
        """The interleaved bookkeeping, with the draft's side: the fused
        finish (target install, first token, the slot's state) also
        installs the draft row and seeds the slot's sync chunk."""
        if ilv["last"]:
            slot, req = ilv["slot"], ilv["req"]
            tail = req["pending"]["tail"]
            super()._ilv_after_chunk(ilv, pf_logits, s_idx)
            self._seed_draft(slot, req["prompt_len"], tail)
        else:
            super()._ilv_after_chunk(ilv, pf_logits, s_idx)

    # ------------------------------------------------------------------

    def _spec_core(self):
        """One speculative step over every slot, on the device: reads and
        updates the slots' state in place (tok, pos, the sync chunks),
        writes both caches. Returns (w (B, k+1) the committed-token block,
        m (B,) the accepted counts). Greedy, it reads nothing from the
        host, so it can be captured; sampled, it draws from each active
        slot's generator."""
        k, dev = self.spec_k, self.device
        tok, pos, act = self._tok_d, self._pos_d, self._active_d
        self._d_family.verify_rows(self.draft_prepared, self.d_cache,
                                   self._prev_chunk, self._prev_pos, act,
                                   self._d_codec)
        rows = ([] if self._greedy else
                [i for i in range(self.slots) if self.active[i]])
        last, props, d_rows = tok, [], []
        for i in range(k):
            logits = self._d_family.decode_rows(
                self.draft_prepared, self.d_cache, last, pos + i, act,
                self._d_codec)
            if self._greedy:
                nxt = logits.argmax(dim=-1)
            else:
                dist = _probs(logits, temperature=self._temperature,
                              top_k=self._top_k_opt)
                d_rows.append(dist)
                nxt = logits.argmax(dim=-1)
                for r in rows:
                    nxt[r] = torch.multinomial(dist[r], 1,
                                               generator=self._gens[r])[0]
            last = torch.where(act, nxt, last)
            props.append(last)
        props = torch.stack(props, dim=1)  # (B, k)
        chunk = torch.cat([tok[:, None], props], dim=1)  # (B, k + 1)
        t_logits = self.family.verify_rows(self.prepared, self.cache, chunk,
                                           pos, act, self._codec)
        if self._greedy:
            w = t_logits.argmax(dim=-1)  # the committed tokens ARE these
            m = _first_false(props == w[:, :k])
        else:
            w, m = self._accept_sampled(t_logits, props, d_rows, rows)
        committed = torch.where(act, m + 1, 0).to(torch.int32)
        new_last = w.gather(1, m.long()[:, None])[:, 0]
        self._prev_chunk.copy_(torch.where(act[:, None], chunk,
                                           self._prev_chunk))
        self._prev_pos.copy_(torch.where(act, pos, self._prev_pos))
        tok.copy_(torch.where(act, new_last, tok))
        pos.add_(committed)
        return w, m

    def _accept_sampled(self, t_logits, props, d_rows, rows):
        """The rejection-sampling acceptance of every sampling slot (JAX
        serving_spec.py:262-293), each slot's draws from its own
        generator: u < min(1, p_t / p_d) accepts, the first rejection
        resamples from the normalized residual, all-accepted takes the
        bonus sample from p_t."""
        k, b = self.spec_k, props.shape[0]
        t_dist = _probs(t_logits, temperature=self._temperature,
                        top_k=self._top_k_opt)  # (B, k+1, V)
        d_dist = torch.stack(d_rows, dim=1)  # (B, k, V)
        t_p = t_dist[:, :k].gather(2, props[:, :, None])[..., 0]
        d_p = d_dist.gather(2, props[:, :, None])[..., 0]
        ratio = torch.clamp(t_p / torch.clamp(d_p, min=1e-30), max=1.0)
        m = torch.full((b,), k, dtype=torch.int64, device=self.device)
        w = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
        for r in rows:
            g = self._gens[r]
            u = torch.rand((k,), generator=g, device=self.device)
            m_r = int(_first_false(u < ratio[r]))
            t_row = t_dist[r, m_r]
            resid = torch.clamp(
                t_row - (d_dist[r, m_r] if m_r < k else 0.0), min=0.0)
            z = resid.sum()
            resid = torch.where(z > 0, resid / torch.clamp(z, min=1e-30),
                                t_row)
            w[r, m_r] = torch.multinomial(resid, 1, generator=g)[0]
            m[r] = m_r
        return w, m

    def _spec_mixed(self):
        """The spec step plus one prompt chunk of the queue head into BOTH
        transient rows (target and draft): the legs touch disjoint
        buffers. Returns (w, m, the target chunk's logits (1, N, V))."""
        w, m = self._spec_core()
        pf = self.family.prefill(self.prepared, self._chunk_d, self._row,
                                 self._start_d)
        self._d_family.prefill(self.draft_prepared, self._chunk_d,
                               self._d_row, self._start_d)
        return w, m, pf

    @torch.no_grad()
    def step(self):
        """One speculative step: every active slot advances by its own
        1..k+1 committed tokens. Returns {rid: [tokens...]}. Interleaved
        admission and overlap compose as in the plain step."""
        if self.n_active == 0:
            return self.flush_overlap()
        # the step clock's record (the plain step's phases; obs/timeline)
        sc = self.step_clock
        rec = sc.begin() if sc is not None else None
        if self._buckets is not None:
            # this step verifies pos .. pos + k of every active slot;
            # _ensure_cache_len adds the +k and grows the draft pool
            need = self._uncommitted_need(self.spec_k + 1)
            if need:
                self._ensure_cache_len(need)
        ilv = self._ilv_next() if self._ilv else None
        g = self._graph_step if self._greedy else None
        pf_logits = None
        if rec is not None:
            rec.marks.append(("host", time.perf_counter()))
        if ilv is not None and ilv["req"].get("trace"):
            ilv["t0"] = time.perf_counter()
        if ilv is None:
            w, m = (g.run("spec", self._spec_core, (self.cache, self.d_cache))
                    if g is not None else self._spec_core())
        else:
            n = self._ilv
            self._chunk_d.copy_(ilv["p"]["padded"][:, ilv["c"] * n:
                                                   (ilv["c"] + 1) * n])
            self._start_d.fill_(ilv["c"] * n)
            w, m, pf_logits = (
                g.run("spec_mixed", self._spec_mixed,
                      (self.cache, self.d_cache, self._row, self._d_row))
                if g is not None else self._spec_mixed())
        s_idx = self._step_idx
        self._step_idx += 1
        if ilv is not None:
            self._ilv_after_chunk(ilv, pf_logits, s_idx)
        readback = _Readback([w, m])
        if rec is not None:
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
                rec.marks.append(("wait", time.perf_counter()))
            return self._commit_spec(prev[0], host, rec, sc)
        host = readback.wait()
        if rec is not None:
            rec.marks.append(("wait", time.perf_counter()))
        return self._commit_spec(s_idx, host, rec, sc)

    def _commit_spec(self, s_idx, host, rec=None, sc=None):
        """Commit one completed step (host: the (B, k+1) token block and
        the (B,) accepted counts), with the plain commit's install
        gating: a slot installed at or after dispatch `s_idx` had no
        verify in it. `rec`/`sc`: the step clock's record, closed here."""
        w, m = host
        self.spec_steps += 1
        mt = obs.metrics()
        t_now = time.perf_counter() if mt is not None else 0.0
        samples: list = []
        n_adv = 0
        out = {}
        for slot, req in enumerate(self._slot_req):
            if req is None or "pending" in req:
                continue
            emitted = []
            inst = req.get("install_step")
            if inst is not None:
                if s_idx <= inst:
                    continue
                del req["install_step"]
                fd = req.pop("first_dev", None)
                if fd is not None:  # the deferred interleaved first token
                    if mt is not None and (gp := self.goodput) is not None:
                        gp.on_prefill(req["prompt_len"])
                    emitted.append(self._commit_token(slot, req, fd.wait(),
                                                      0))
            if self._slot_req[slot] is req:
                n_commit = int(m[slot]) + 1
                self.spec_proposed += self.spec_k
                self.spec_accepted += int(m[slot])
                # the chunk's gap spread over its tokens (JAX's)
                self._obs_commit(req, mt, t_now, n_new=n_commit,
                                 samples=samples)
                for t in w[slot, :n_commit].tolist():
                    self.tok[slot] = t
                    req["emitted"].append(t)
                    emitted.append(t)
                    self._retire_if_done(slot)
                    if self._slot_req[slot] is not req:
                        break  # budget, stop or eos mid-chunk: rest dropped
            if emitted:
                n_adv += len(emitted)
                out[req["rid"]] = emitted
        if rec is not None:
            rec.marks.append(("commit", time.perf_counter()))
        self._obs_step_end(mt, n_adv, samples)
        if rec is not None:
            rec.marks.append(("obs", time.perf_counter()))
            sc.end(rec, n_adv)
        return out

    def flush_overlap(self):
        if self._inflight is None:
            return {}
        sc = self.step_clock
        rec = sc.begin() if sc is not None else None
        s_idx, readback = self._inflight
        self._inflight = None
        host = readback.wait()
        if rec is not None:
            rec.marks.append(("wait", time.perf_counter()))
        return self._commit_spec(s_idx, host, rec, sc)
