"""LM serving daemon: the ContinuousBatcher behind the gRPC edge (port
of dnn_tpu/runtime/lm_server.py, the serving core).

SendTensor takes a prompt (1-D int token ids) and answers with the
generated tokens; GenerateStream answers one message per token as it
commits; HealthCheck reports the batcher worker alive. With a tokenizer
(io/tokenizer.py), SendMessage takes prompt text and answers with the
generated text; "!stats", or any text without a tokenizer, gets the
pool's stats. Options ride the request_id (SendMessage: the sender_id)
as "gen[:max_new[:seed]][:t=..][:k=..][:p=..][:m=..][:r=..]" — the
same wire, message layout and option grammar as the JAX daemon, so
either package's client drives either server.

The model is GPT-2's or, given a LlamaConfig, the LLaMA family's: the
batcher then serves it through `LlamaFamilyRows` (serving.default_family),
as JAX's node `_serve_lm` does, with the pool at the model's KV heads.

Threading: gRPC handlers are async and never touch the device. ONE
worker thread owns the batcher: it admits queued prompts whenever slots
free up, steps the pool while anything is active, and resolves a
concurrent.futures.Future per request. A request the paged pool cannot
take yet (InsufficientBlocks) is held back and retried ahead of the
queue once blocks free.

The batcher's serving features ride the same worker. Per-request logit
biases (b=) and grammar constraints need the batcher built with
allow_logit_bias / allow_constraints (3600 constraint rows unless told
otherwise): off by default, as in JAX's LMServer; `node --serve_lm`
turns both on, as JAX's node does. "j=DEPTH" serves JSON mode, a
depth-bounded JSON grammar compiled once per depth over the tokenizer's
`vocab_bytes` (`json_constraint`). "a=I" serves the request through
LoRA adapter I of `lora_adapters` (the batcher's multi-LoRA views).
`weights="int8"` quantizes the served tree once at construction
(quant.quantize_gpt; not with LoRA, as in JAX). The request id "embed"
or "embed:mean|last" answers with the pooled final hidden state of the
prompt (runtime/embeddings.make_embed over the served weights, the
prompt padded to a prompt_pad multiple): the call runs on the batcher's
worker thread between two steps, so it never meets a step's graph
capture or a step's buffers half written. `prefix_cache`,
`prefill_chunk_tokens` and `overlap` pass through. Given a draft model
(`draft_cfg`, `draft_prepared`, `spec_k`) the daemon serves through the
speculative batcher (runtime/serving_spec.SpeculativeBatcher), which
takes neither biases nor constraints. Under interleaved admission a request's first
token arrives with a later step's commit (a step may then commit two
tokens of one request); under overlap the worker commits the trailing
step when the pool empties (flush_overlap).

KV between replicas (JAX lm_server.py:1607-1885), on the same wire:
  * the prefill->decode row handoff: request id "prefill" answers with
    the prompt's packed KV row (batcher.export_prefill through
    control/handoff.pack); "kvput:KEY" stages such a payload on a decode
    replica, checked against its geometry at once and kept under KEY
    (single use, an LRU of `kv_handoff_cap` entries swept after
    `kv_handoff_ttl_s` seconds); the gen option "h=KEY" then admits the
    prompt with that row adopted (submit(prefilled=)), on the unary
    front and on GenerateStream. Speculative and interleaved servers
    refuse kvput, as in JAX;
  * block migration over the radix store (kv="paged", prefix_cache>0;
    kvtier/migrate.py): "kvstage" prefills a prompt's full blocks into
    the store, "kvlease" stages the resident run of a prefix under a
    lease (shm segment and nonce where the host has shm) and answers its
    meta, "kvfetch:LEASE" the staged bytes, "kvack:LEASE" releases it;
    "kvpull" (a JSON {"donor", "tokens"[, "rung": "grpc"]}) pulls the
    run from a donor and adopts it. A failed pull answers a
    "kvtier_fallback" status, not an error: the next generate prefills
    again (the reference's protocol, advisory by design).
The device work of these endpoints (export, stage, the export of a
lease, adopt) runs on the worker thread through `_BatcherWorker.call`;
the packing and parsing run off the event loop. Their payloads are not
token ids, so kvput/kvfetch/kvack/kvpull dispatch before the prompt's
validation. `role` ("prefill", "decode" or "both") is advisory, as in
JAX: every replica serves every endpoint. The worker's loop runs the
housekeeping tick (the kvput inbox's and the leases' TTL sweeps).

Resilience (JAX lm_server.py:1129-1262, :2108-2195), with the
observability it reports through (obs/, utils/metrics.py):
  * dedup: the gen option "d=KEY" joins a repeated key to the first
    request's future (a bounded table of 512 keys), so a client's retry
    after a drain or a requeue never generates twice; GenerateStream
    drops the key;
  * draining: `drain` / POST /drainz / SIGTERM close admission
    (preflight answers UNAVAILABLE "draining", retriable), let in-flight
    decodes finish within `drain_grace_s` and hand queued (and held-back)
    work back with the same status;
  * worker restart: a step that raises hands the survivors to
    `_on_worker_death`, which spawns a successor worker over the same
    batcher and requeues the idempotent ones (unary, unretried, inside
    their deadline; `max_request_retries`), at most `worker_restarts`
    times in 300 s — past that, every caller fails fast;
  * the watchdog (`watchdog`: True, a period in seconds or a Watchdog):
    a subprocess device probe on the daemon's own device and the
    worker's heartbeat -> ok|degraded|wedged; `on_wedged` "restart" or
    "drain" escalates a wedged episode, and serve_lm then returns
    EXIT_RESTART (43);
  * `metrics_port` serves GET /metrics /healthz /statusz /debugz
    /trace /trace.jsonl /traces /stepz and POST /drainz (obs/http.py);
    the chaos seams (chaos/inject.py) kv_exhaust, step_fault and
    kv_migrate are consulted at admission, before each pool step and in
    kvpull.
  * observability (JAX lm_server.py:418-462, :905-1045), with obs on:
    each request's root span continues a client's `tr=` trace
    (obs.continue_or_start), with queue_wait, admit, prefill,
    prefill_chunk and decode spans under it; the batcher carries a step
    clock (/stepz) and a goodput tracker (dnn_tpu_mfu, dnn_tpu_mbu,
    goodput tokens/sec and, with `slo`, SLO burn rates); /profilez
    captures the process on demand, and its auto trigger captures the
    pool step after one over a threshold (obs/profile.py, JAX
    lm_server.py:597-625); /kvz serves the radix store's KVLens.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import queue
import signal
import threading
import time
from typing import NamedTuple, Optional

import grpc
import numpy as np

from dnn_tpu_torch import native, obs
from dnn_tpu_torch.chaos import inject as _chaos_inject
from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.service import (
    GRPC_MSG_OPTIONS,
    MAX_MESSAGE_BYTES,
    _handlers,
    _tensor_arr,
    _tensor_msg,
)
from dnn_tpu_torch.comm.transport import (
    HELLO_SENDER,
    decline_hello,
    extract_deadline,
)
from dnn_tpu_torch.runtime.paged_kvcache import InsufficientBlocks
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

log = logging.getLogger("dnn_tpu_torch.lm_server")

__all__ = ["LMServer", "serve_lm", "start_lm_server_in_background",
           "start_lm_server_loop", "parse_gen_options", "DrainingError",
           "EXIT_RESTART"]

#: serve_lm's exit code when a wedged-policy escalation asks a supervisor
#: to restart the process (distinct from a crash and from a clean 0)
EXIT_RESTART = 43

# room left in a reply for its message framing beside the payload
_FRAME_SLACK = 4096


def parse_gen_options(request_id: str, default_max_new: int):
    """'gen[:max_new[:seed]][:t=TEMP][:k=TOPK][:p=TOPP][:m=MINP]
    [:r=REPPEN][:b=..][:a=..][:d=..][:h=..][:j=..]' -> (max_new, seed,
    opts). Only the literal 'gen' prefix carries options; any other id
    gets the server defaults. Positional segments are max_new then
    seed; unparseable segments fall back to defaults; unknown named
    segments (the JAX client's dl=/tr= tags) are skipped. b= is the
    logit bias ("tok~val,tok~val"), j= the JSON mode's depth (the
    daemon's preflight turns it into a constraint), a= the LoRA
    adapter's index, h= the key of a staged KV handoff (kvput:), d= the
    dedup key (a repeated key joins the first request's generation)."""
    max_new, seed, opts = default_max_new, None, {}
    parts = (request_id or "").split(":")
    if parts[0] != "gen":
        return max_new, seed, opts

    def _parse_bias(val: str) -> dict:
        out = {}
        for pair in val.split(","):
            tok, _, v = pair.partition("~")
            out[int(tok)] = float(v)
        return out

    named = {"t": ("temperature", float), "k": ("top_k", int),
             "p": ("top_p", float), "a": ("adapter", int),
             "m": ("min_p", float), "r": ("repetition_penalty", float),
             "b": ("logit_bias", _parse_bias), "d": ("dedup", str),
             "h": ("kv_handle", str), "j": ("json_depth", int)}
    pos = 0
    for seg in parts[1:]:
        if "=" in seg:
            key, _, val = seg.partition("=")
            if key in named:
                name, conv = named[key]
                try:
                    opts[name] = conv(val)
                except ValueError:
                    pass
            continue
        pos += 1
        try:
            if pos == 1:
                max_new = max(1, int(seg))
            elif pos == 2:
                seed = int(seg)
        except ValueError:
            pass
    return max_new, seed, opts


def _fail_future(fut, exc):
    """set_exception tolerant of a future its caller already cancelled."""
    if not fut.done():
        try:
            fut.set_exception(exc)
        except concurrent.futures.InvalidStateError:
            pass


class DrainingError(RuntimeError):
    """A request refused because the daemon is DRAINING: admission is
    closed, in-flight decodes are finishing, and the request should go to
    another replica. It maps to gRPC UNAVAILABLE, which clients retry, so
    queued work is handed back, never lost."""


class _QueuedRequest(NamedTuple):
    prompt: np.ndarray
    max_new: int
    seed: Optional[int]
    opts: dict
    on_token: object
    cancel_evt: threading.Event
    t_q: float  # perf_counter at enqueue: the queue-wait and TTFT clock
    fut: concurrent.futures.Future
    attempts: int = 0  # worker-death requeues consumed (the retry budget)
    trace: object = None  # the request's span (obs/trace.py), or None


class _BatcherWorker(threading.Thread):
    """The one thread that talks to the device. Owns the batcher; every
    other thread submits through `submit` (or hands it other device work
    through `call`), which returns a Future.

    Resilience (JAX lm_server.py:170-766): `begin_drain` closes admission
    and lets in-flight decodes finish while queued work is handed back
    with the retriable DrainingError; a step that raises hands the
    surviving work to `on_death` (LMServer._on_worker_death requeues it
    into a successor worker) or, without a hook, fails every caller fast.
    `heartbeat` and `step_done` feed the watchdog (one None check a loop
    iteration when off); `tick` is the owner's housekeeping."""

    def __init__(self, batcher: ContinuousBatcher):
        super().__init__(daemon=True, name="lm-batcher")
        self.batcher = batcher
        self.q: "queue.Queue[Optional[_QueuedRequest]]" = queue.Queue()
        self._stop_evt = threading.Event()
        self._abandon = False
        self._draining = False
        # a lock orders submit against the dead-marking of the exits: a
        # request enqueued after the final drain would never resolve
        self._lock = threading.Lock()
        self._dead: Optional[BaseException] = None
        self._held: Optional[_QueuedRequest] = None
        self._held_logged = None  # the held item already in the flight ring
        self._futures: dict = {}  # rid -> _QueuedRequest
        self._ttft_t0: dict = {}  # rid -> t_q, first token not yet committed
        self._calls: "queue.SimpleQueue" = queue.SimpleQueue()
        self.on_death = None
        self.heartbeat = None
        self.step_done = None
        self.goodput = None  # obs/goodput.GoodputTracker: the TTFT feed
        self.tick = None  # housekeeping, called once a loop (rate-limited
        # by itself)
        # the auto-profile arm (POST /profilez?auto=1): one None check a
        # step while disarmed
        self.auto_profile = None
        self._profile_hit = False

    def submit(self, prompt, max_new: int, seed, *, opts=None,
               on_token=None, cancel_evt=None,
               trace=None) -> concurrent.futures.Future:
        """Queue a request. `on_token(tok)` fires on this worker thread
        for every token as it commits; setting `cancel_evt` retires the
        request at the next step boundary (its future is cancelled);
        `trace` (a span) parents its queue_wait, admit and decode
        spans."""
        fut = concurrent.futures.Future()
        with self._lock:
            if self._draining and self._dead is None:
                _fail_future(fut, DrainingError(
                    "LM server draining: admission closed; retry against "
                    "another replica"))
                return fut
            if self._dead is not None:
                _fail_future(fut, self._dead)
                return fut
            self.q.put(_QueuedRequest(
                np.asarray(prompt), max_new, seed, dict(opts or {}),
                on_token, cancel_evt or threading.Event(),
                time.perf_counter(), fut, trace=trace))
            if (m := obs.metrics()) is not None:
                # callable: the exits drain the queue without a gauge
                # update, so the depth is read at scrape time
                m.set_fn("serving.queue_depth", self.q.qsize)
        return fut

    def call(self, fn) -> concurrent.futures.Future:
        """Run fn() on this thread between two steps; its result (or
        exception) resolves the returned Future. Device work other than
        the batcher's (the embedding endpoint, the KV endpoints) goes
        this way, so it never runs beside a step's graph capture."""
        fut = concurrent.futures.Future()
        with self._lock:
            if self._dead is not None:
                _fail_future(fut, self._dead)
                return fut
            self._calls.put((fn, fut))
            self.q.put(None)  # wakes an idle worker
        return fut

    def _run_calls(self):
        while True:
            try:
                fn, fut = self._calls.get_nowait()
            except queue.Empty:
                return
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 — the caller's error
                fut.set_exception(e)

    def _fail_calls(self, exc):
        """Fail every queued `call` (death, drain's end, shutdown): they
        mutate this replica's pool and are never requeued."""
        while True:
            try:
                _fail_future(self._calls.get_nowait()[1], exc)
            except queue.Empty:
                return

    def _resubmit(self, item: _QueuedRequest) -> bool:
        """Requeue a survivor of a dead predecessor worker, keeping its
        future, queue clock and attempt count. False when this worker is
        dead or draining (the caller then fails the item)."""
        with self._lock:
            if self._dead is not None or self._draining:
                return False
            self.q.put(item)
        return True

    def begin_drain(self):
        """Close admission now; the loop hands queued work back with the
        retriable DrainingError, steps the in-flight decodes to their
        end and exits."""
        with self._lock:
            self._draining = True
        self._stop_evt.set()
        obs.flight.record("drain_begin", queued=self.q.qsize(),
                          active=self.batcher.n_active)

    def _drain_handback(self):
        """Fail every queued (never admitted) item with the retriable
        DrainingError. A held-back item never prefilled, so it is handed
        back too."""
        exc = DrainingError(
            "LM server draining: request was queued but not admitted; "
            "retry against another replica")
        n = 0
        with self._lock:
            if self._held is not None:
                held, self._held = self._held, None
                _fail_future(held.fut, exc)
                n += 1
            while True:
                try:
                    item = self.q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    _fail_future(item.fut, exc)
                    n += 1
        if n:
            obs.flight.record("drain_handback", requests=n)

    def stop(self, *, drain: bool = True):
        """Signal shutdown. drain=True: the loop exits once the pool and
        the queue are empty. drain=False: abandon in-flight decodes too —
        queued futures are cancelled here, admitted ones by the loop at
        its next iteration."""
        with self._lock:
            if not drain:
                self._abandon = True
                if self._dead is None:
                    self._dead = RuntimeError("LM server shut down")
                while True:
                    try:
                        item = self.q.get_nowait()
                    except queue.Empty:
                        break
                    if item is not None:
                        item.fut.cancel()
            elif self._dead is None:
                # dead before the stop signal: a submit racing the loop's
                # last empty-queue check fails fast instead of hanging
                self._dead = RuntimeError("LM server shutting down")
        self._stop_evt.set()

    def _admit(self, item: Optional[_QueuedRequest]) -> bool:
        """Admit one request; False when it was HELD BACK (pool short of
        blocks, or an injected kv_exhaust) — the caller then stops
        pulling more work. A None item (a `call`'s wake-up) admits
        nothing."""
        if item is None:
            return True
        if item.cancel_evt.is_set():
            item.fut.cancel()
            return True
        wait = time.perf_counter() - item.t_q
        try:
            if _chaos_inject.kv_exhaust():
                raise InsufficientBlocks("chaos: injected KV pool exhaustion")
            rid = self.batcher.submit(item.prompt, item.max_new,
                                      seed=item.seed, trace=item.trace,
                                      **item.opts)
        except InsufficientBlocks:
            # once an item, not once a retry: the held item is retried
            # every step
            if item is not self._held_logged:
                obs.flight.record("held_back", queue_depth=self.q.qsize())
                self._held_logged = item
            self._held = item
            return False
        except Exception as e:  # noqa: BLE001 — the request's error, not
            # the loop's
            obs.flight.record("admit_rejected", error=str(e)[:200])
            _fail_future(item.fut, e)
            return True
        obs.flight.record("admit", rid=rid,
                          queue_wait_ms=round(wait * 1e3, 3),
                          prompt_len=int(item.prompt.size),
                          max_new=item.max_new,
                          trace_id=item.trace.trace_id if item.trace
                          else None)
        # the convoy path samples the first token during submit();
        # interleaved admission defers it to a later step's commit
        first = self.batcher.first_token(rid)
        if (m := obs.metrics()) is not None:
            m.observe("serving.queue_wait_seconds", wait)
            m.set_fn("serving.queue_depth", self.q.qsize)
            if first is not None:
                ttft = time.perf_counter() - item.t_q
                m.observe("serving.ttft_seconds", ttft)
                if (g := self.goodput) is not None:
                    g.on_ttft(ttft)  # the SLO burn-rate window
        if item.trace:
            obs.record_span("queue_wait", item.t_q, wait, parent=item.trace)
        if first is None:
            self._ttft_t0[rid] = item.t_q
        self._futures[rid] = item
        if first is not None:
            self._emit(rid, first)
        return True

    def _emit(self, rid: int, tok):
        """Stream a committed token — or a list of them: an interleaved
        admission's deferred first token commits with the step's own."""
        item = self._futures.get(rid)
        if item is None or item.on_token is None:
            return
        try:
            for t in (tok if isinstance(tok, list) else [tok]):
                item.on_token(int(t))
        except Exception:  # noqa: BLE001 — a dead stream consumer must
            log.exception("on_token callback failed for rid %d", rid)

    def _process_cancels(self):
        for rid, item in list(self._futures.items()):
            if item.cancel_evt.is_set():
                if self.batcher.cancel(rid):
                    self.batcher.claim(rid)
                del self._futures[rid]
                self._ttft_t0.pop(rid, None)
                item.fut.cancel()

    def _publish_done(self):
        b = self.batcher
        for rid in [r for r in self._futures if r in b.results]:
            tokens, _reason, _logprobs = b.claim(rid)
            fut = self._futures.pop(rid).fut
            self._ttft_t0.pop(rid, None)
            if not fut.done():
                try:
                    fut.set_result(tokens)
                except concurrent.futures.InvalidStateError:
                    pass  # the caller cancelled meanwhile

    def _shutdown_drain_queue(self):
        """The drain exit's last step: mark dead, and fail what slipped
        into the queue between the loop's last empty check and now."""
        with self._lock:
            if self._dead is None:
                self._dead = RuntimeError("LM server shutting down")
            if self._held is not None:
                held, self._held = self._held, None
                _fail_future(held.fut, self._dead)
            while True:
                try:
                    item = self.q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    _fail_future(item.fut, self._dead)
        self._fail_calls(self._dead)

    def _collect_for_requeue(self):
        """The death path's hand-over: mark this worker dead (racing
        submits fail fast) and return the surviving work — [(rid, item)]
        admitted but unfinished, [item] queued or held. Their futures stay
        unresolved: the on_death hook decides their fate."""
        with self._lock:
            if self._dead is None:
                self._dead = RuntimeError("LM batcher worker died")
        self._fail_calls(self._dead)
        with self._lock:
            inflight = list(self._futures.items())
            self._futures.clear()
            self._ttft_t0.clear()
            queued = []
            if self._held is not None:
                queued.append(self._held)
                self._held = None
            while True:
                try:
                    item = self.q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    queued.append(item)
        return inflight, queued

    def _fail_all(self, exc):
        self._fail_calls(exc)
        with self._lock:
            self._dead = exc  # submits from here on fail at once
            for item in self._futures.values():
                _fail_future(item.fut, exc)
            self._futures.clear()
            self._ttft_t0.clear()
            if self._held is not None:
                held, self._held = self._held, None
                _fail_future(held.fut, exc)
            while True:
                try:
                    item = self.q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    _fail_future(item.fut, exc)

    def _abandon_all(self):
        """stop(drain=False)'s exit: cancel every admitted and held
        future (queued ones were cancelled by stop)."""
        self._fail_calls(RuntimeError("LM server shut down"))
        with self._lock:
            for item in self._futures.values():
                item.fut.cancel()
            self._futures.clear()
            if self._held is not None:
                held, self._held = self._held, None
                held.fut.cancel()

    def _step_pool(self, b):
        """One pool step, with the auto-profile arm folded in (JAX
        lm_server.py:597-625): disarmed, one None check around b.step().
        Armed, each step is timed; the step after the first one over the
        threshold runs inside a profiler capture (obs/profile.py) and
        disarms. A breaching step that captured a new CUDA graph does not
        count: the capture waits for a step that replays its graphs, so
        the trace shows the served step and never a graph capture under
        CUPTI. The chaos seam fires first: before the step dispatches,
        so never inside a graph capture."""
        _chaos_inject.step_fault()
        ap = self.auto_profile
        if ap is None:
            self._profile_hit = False
            return b.step()
        if self._profile_hit:
            from dnn_tpu_torch.obs.profile import (
                CaptureFailed,
                ProfilerBusy,
                capture_step,
            )

            self.auto_profile = None
            self._profile_hit = False
            try:
                path, stepped = capture_step(
                    b.step, capture_root=ap.get("capture_root"),
                    keep=ap.get("keep", 8), extra_s=ap.get("extra_s", 0.0))
            except ProfilerBusy as e:
                # the arm is spent and the step runs uncaptured; the
                # miss is on /debugz and in the log
                obs.flight.record("profile_capture_busy", error=str(e))
                log.warning("auto-profile skipped: %s", e)
                return b.step()
            except CaptureFailed as e:
                log.error("auto-profile capture failed: %s", e)
                return e.result if e.ran else b.step()
            log.info("auto-profile captured slow-step follow-up to %s",
                     path)
            return stepped
        g = getattr(b, "_graph_step", None)
        n_cap = g.captures if g is not None else 0
        t0 = time.perf_counter()
        stepped = b.step()
        if (time.perf_counter() - t0 > ap["threshold_s"]
                and (g is None or g.captures == n_cap)):
            self._profile_hit = True
        return stepped

    def _died(self, e: Exception):
        """A step raised: hand the survivors to on_death, or fail every
        caller fast (HealthCheck then reports the worker dead)."""
        handler = self.on_death
        obs.flight.record("worker_died", error=str(e)[:500],
                          pending=len(self._futures),
                          requeue=handler is not None)
        if handler is None:
            log.exception("batcher worker died; failing %d pending "
                          "requests", len(self._futures))
            self._fail_all(RuntimeError(f"LM batcher worker died: {e}"))
            return
        log.exception("batcher worker died; handing %d in-flight and "
                      "queued requests to the requeue hook",
                      len(self._futures))
        inflight, queued = self._collect_for_requeue()
        try:
            handler(e, inflight, queued)
        except Exception:  # noqa: BLE001 — a broken hook must not strand
            # the collected futures
            log.exception("worker-death requeue hook failed; failing "
                          "survivors")
            exc = RuntimeError(f"LM batcher worker died: {e}")
            for _rid, item in inflight:
                _fail_future(item.fut, exc)
            for item in queued:
                _fail_future(item.fut, exc)

    def _commit(self, stepped: dict):
        """Stream a step's committed tokens and record the deferred TTFTs
        of interleaved admissions (their first committed token)."""
        for rid, tok in stepped.items():
            t0 = self._ttft_t0.pop(rid, None)
            if t0 is not None and (m := obs.metrics()) is not None:
                ttft = time.perf_counter() - t0
                m.observe("serving.ttft_seconds", ttft)
                if (g := self.goodput) is not None:
                    g.on_ttft(ttft)
            self._emit(rid, tok)

    def run(self):
        b = self.batcher
        try:
            self._loop(b)
        except Exception as e:  # noqa: BLE001 — outside a step (a flush,
            # a call's wake-up): fail every waiting caller fast
            log.exception("batcher worker died")
            self._fail_all(RuntimeError(f"LM batcher worker died: {e}"))

    def _loop(self, b):
        while True:
            if (hb := self.heartbeat) is not None:
                hb()
            if self.tick is not None:
                self.tick()
            self._run_calls()
            if self._abandon:
                self._abandon_all()
                return
            self._process_cancels()
            if self._draining:
                # queued work handed back, in-flight decodes stepped to
                # their end below, then a clean exit (submit refuses)
                self._drain_handback()
                if b.n_active == 0:
                    b.flush_overlap()
                    with self._lock:
                        if self._dead is None:
                            self._dead = DrainingError(
                                "LM server drained and exited")
                    self._fail_calls(self._dead)
                    obs.flight.record("drain_done")
                    return
            elif b.n_active == 0 and self._held is None and self.q.empty():
                # overlap: the pool emptied with one dispatched step
                # uncommitted (its rows are past every retirement);
                # commit it before waiting for work
                b.flush_overlap()
                if self._stop_evt.is_set():
                    self._shutdown_drain_queue()
                    return
                try:
                    item = self.q.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._admit(item)
            while not self._draining and b.free_slots():
                if self._held is not None:
                    item, self._held = self._held, None
                else:
                    try:
                        item = self.q.get_nowait()
                    except queue.Empty:
                        break
                if not self._admit(item):
                    break
            had_active = bool(b.n_active)
            try:
                stepped = self._step_pool(b) if had_active else {}
            except Exception as e:  # noqa: BLE001 — a device-side error
                # must not leave callers hanging for request_timeout
                self._died(e)
                return
            if had_active and (sd := self.step_done) is not None:
                sd()  # a real step completed: the watchdog is warmed
            self._commit(stepped)
            self._publish_done()


class LMServer:
    """NodeService servicer: SendTensor(prompt) -> generated tokens,
    GenerateStream, HealthCheck, SendMessage (declines the transport
    hello; with `tokenizer`, prompt text -> generated text; else, and for
    "!stats", the pool's stats). `draft_cfg` / `draft_prepared` /
    `spec_k` serve through the speculative batcher. Batcher keyword
    arguments pass through —
    the cache layout and storage (`kv` "paged"/"dense"/"auto", the
    default; `kv_dtype` f32/bf16/int8/int4; `decode_buckets`; `paged_blocks`,
    `block_len`), `compute_dtype` (torch.bfloat16: bf16 compute, the
    cache bf16 unless `kv_dtype` says otherwise), `prefix_cache`,
    `prefill_chunk_tokens`, `overlap`, `lora_adapters`/`lora_alphas`,
    `allow_logit_bias` and `allow_constraints` among them, each off
    unless given, as in JAX's LMServer (allow_constraints sizes
    constraint_rows at 3600 unless told otherwise: JSON mode's depth 3
    needs 3519 rows). `weights` is "f32" or "int8" (quantized once here;
    refused with lora_adapters, as in JAX). `role` (prefill, decode or
    both; advisory), `kv_handoff_cap` and `kv_handoff_ttl_s` (the kvput
    inbox; a ttl <= 0 keeps entries until the cap pushes them out) and
    `kv_lease_ttl_s` (a staged block export's lease, and a pull's
    timeout) are JAX's. `device`
    defaults to "cuda" and raises without a card. A LlamaConfig serves
    through LlamaFamilyRows(cfg) unless `family` is given
    (serving.default_family)."""

    _MAX_JSON_DEPTH = 3  # the regex grows with the depth; bound it

    def __init__(self, cfg, prepared, *, default_max_new: int = 32,
                 request_timeout: float = 120.0, tokenizer=None,
                 draft_cfg=None, draft_prepared=None, spec_k: int = 4,
                 weights: str = "f32", role: str = "both",
                 kv_handoff_cap: int = 64, kv_handoff_ttl_s: float = 120.0,
                 kv_lease_ttl_s: float = 30.0,
                 metrics_port: Optional[int] = None, watchdog=None,
                 on_wedged: str = "503", worker_restarts: int = 2,
                 max_request_retries: int = 1, drain_grace_s: float = 30.0,
                 goodput=None, slo=None, **batcher_kwargs):
        native.load()  # the checksum library, built before serving
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"role must be prefill|decode|both, got {role!r}")
        if on_wedged not in ("503", "restart", "drain"):
            raise ValueError(
                f"on_wedged must be 503|restart|drain, got {on_wedged!r}")
        self.role = role
        # resilience state, before anything can serve a request or a
        # scrape: the drain flag, the wedged policy's escalation latch,
        # the dedup table, the restart bookkeeping
        self.on_wedged = on_wedged
        self.worker_restarts = int(worker_restarts)
        self.max_request_retries = int(max_request_retries)
        self.drain_grace_s = float(drain_grace_s)
        self._draining = False
        self._drain_thread = None
        self._drain_lock = threading.Lock()
        self._escalated = threading.Event()
        self._escalate_reason: Optional[str] = None
        self._restart_lock = threading.Lock()
        self._restart_times: list = []
        self._restart_window_s = 300.0
        self._dedup_lock = threading.Lock()
        self._dedup: dict = {}  # key -> worker future, oldest first
        self._DEDUP_CAP = 512
        self.metrics_server = None
        self._watchdog = None
        if (m := obs.metrics()) is not None:
            from dnn_tpu_torch.ops.cuda import cached_attention as _k
            from dnn_tpu_torch.utils.metrics import labeled

            m.set(labeled("dnn_tpu_replica_role", role=self.role), 1.0)
            # the cache kernels' launch counters (host ints the wrappers
            # keep; a captured step's replay counts its launches), read
            # at scrape: a process serving the daemon is checked from
            # outside by them
            for name in ("cached_attention", "decode_attention",
                         "paged_decode_attention"):
                fn = getattr(_k, name)
                for dt in fn.launches_by_dtype:
                    m.set_fn(labeled("dnn_tpu_kernel_launches", kernel=name,
                                     kv_dtype=dt),
                             lambda fn=fn, dt=dt: fn.launches_by_dtype[dt])
        if obs.enabled():
            # an unhandled crash anywhere in the process dumps the ring
            obs.flight.install_crash_dump()
        # the kvput inbox: key -> (payload, staged at); single use (h=
        # consumes an entry), bounded by a cap and a TTL so an abandoned
        # handoff never pins its row-sized payload for good
        self._kv_handoff: dict = {}
        self._kv_lock = threading.Lock()
        self._kv_handoff_cap = int(kv_handoff_cap)
        self._kv_handoff_ttl_s = float(kv_handoff_ttl_s)
        self._kv_lease_ttl_s = float(kv_lease_ttl_s)
        self._kvtier_leases = None
        self._hk_last = 0.0
        if weights not in ("f32", "int8"):
            raise ValueError(
                f"weights must be 'f32' or 'int8', got {weights!r}")
        if weights == "int8":
            if batcher_kwargs.get("lora_adapters"):
                raise ValueError(
                    "weights='int8' does not compose with LoRA serving: "
                    "lora_view applies low-rank deltas to float kernels, "
                    "not quantized {q, scale} pairs")
            from dnn_tpu_torch.quant import quantize_gpt

            prepared = quantize_gpt(prepared, bits=8)
        self.weights = weights
        if (batcher_kwargs.get("allow_constraints")
                and "constraint_rows" not in batcher_kwargs):
            # the daemon's JSON mode goes up to depth 3, whose byte DFA
            # has 3519 states (JAX lm_server.py:1275-1283)
            batcher_kwargs["constraint_rows"] = 3600
        if draft_cfg is not None:
            # speculative serving: each step commits up to spec_k + 1
            # tokens a slot (runtime/serving_spec.py)
            from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher

            self.batcher = SpeculativeBatcher(
                cfg, prepared, draft_cfg, draft_prepared, spec_k=spec_k,
                **batcher_kwargs)
        else:
            self.batcher = ContinuousBatcher(cfg, prepared, **batcher_kwargs)
        self.default_max_new = default_max_new
        self.request_timeout = request_timeout
        self.tokenizer = tokenizer
        self._init_obs(cfg, prepared, goodput, slo)
        # JSON mode's constraints, one per depth, compiled at first use
        self._constraint_cache: dict = {}
        self._embed_fns: dict = {}  # pooling -> make_embed's function
        if getattr(self.batcher, "_prefix_store", None) is not None:
            # the KV tier is live on this replica: the donor's staging
            from dnn_tpu_torch.kvtier.migrate import LeaseTable

            self._kvtier_leases = LeaseTable(ttl_s=kv_lease_ttl_s)
        self.worker = self._spawn_worker()
        self.worker.start()
        try:
            if metrics_port is not None:
                from dnn_tpu_torch.obs.profile import Profiler

                # /healthz: the worker alive and not draining, then the
                # watchdog's ok|degraded|wedged through /statusz
                self.metrics_server = obs.serve_metrics(
                    metrics_port,
                    healthy=lambda: (self.worker.is_alive()
                                     and not self._draining),
                    status=self._statusz, drain=self._drainz,
                    device=self.batcher.device, stepclock=self.step_clock,
                    profiler=Profiler(arm_target=self),
                    kvlens=getattr(self.batcher, "_kvlens", None))
            if watchdog:
                self._start_watchdog(watchdog)
        except BaseException:
            # a failed construction (a port in use) must not leave the
            # worker or the endpoint running
            self.close()
            raise

    def _init_obs(self, cfg, prepared, goodput, slo):
        """The step clock and the goodput tracker (JAX lm_server.py:
        905-918, :1011-1045), built when obs is on and attached to the
        batcher: /stepz serves the clock, /metrics the tracker's
        dnn_tpu_mfu / dnn_tpu_mbu / dnn_tpu_goodput_tokens_per_sec and,
        with `slo` (an obs.goodput.SLOConfig), dnn_tpu_slo_burn_rate.
        `goodput`: None builds one from the model config when obs is on,
        False turns it off, a GoodputTracker is used as it is. The KV
        term is priced at the pool's type, the weights at the served
        tree's bytes."""
        self.step_clock = None
        self.goodput = None
        if not obs.enabled():
            return
        from dnn_tpu_torch.obs.goodput import GoodputTracker, model_cost
        from dnn_tpu_torch.obs.timeline import StepClock

        self.step_clock = StepClock().install()
        self.batcher.step_clock = self.step_clock
        if goodput is None:
            # the pool's resolved type: "int8", "int4" or a torch dtype
            goodput = GoodputTracker(
                model_cost(cfg, prepared,
                           kv_dtype=self.batcher._cache_dtype), slo=slo)
        if goodput:
            self.goodput = goodput.install()
            self.batcher.goodput = self.goodput

    @property
    def auto_profile(self):
        """POST /profilez?auto=1's arm state: the worker's (JAX
        lm_server.py:1047-1055)."""
        return self.worker.auto_profile

    @auto_profile.setter
    def auto_profile(self, value):
        self.worker.auto_profile = value

    def _spawn_worker(self) -> _BatcherWorker:
        """A batcher worker wired to this server: at construction and by
        the worker-death restart, so a successor never drifts from the
        first one's hooks."""
        worker = _BatcherWorker(self.batcher)
        worker.goodput = self.goodput
        worker.tick = self._housekeeping_tick
        if self.worker_restarts > 0:
            worker.on_death = self._on_worker_death
        return worker

    def _start_watchdog(self, watchdog):
        """The hung-device watchdog (obs/watchdog.py): `watchdog` is True
        (a 30 s period), a period in seconds, or a prebuilt Watchdog
        (tests stub its probe). It probes THIS daemon's device — a CPU
        daemon never touches the card, a CUDA one never the CPU — with
        JAX's deadline, min(10, max(6, period / 3)) seconds, on the
        probe's device work; the probe child's import of torch is bounded
        apart (PROBE_IMPORT_BUDGET_S, the join's slack)."""
        import functools

        from dnn_tpu_torch.obs.watchdog import (PROBE_DEADLINE_FLOOR_S,
                                                PROBE_IMPORT_BUDGET_S,
                                                Watchdog,
                                                subprocess_device_probe)

        if isinstance(watchdog, Watchdog):
            self._watchdog = watchdog
        else:
            period = 30.0 if watchdog is True else float(watchdog)
            self._watchdog = Watchdog(
                period_s=period,
                probe_deadline_s=min(10.0, max(PROBE_DEADLINE_FLOOR_S,
                                               period / 3)),
                device_probe=functools.partial(
                    subprocess_device_probe,
                    platform=str(self.batcher.device)),
                probe_slack_s=PROBE_IMPORT_BUDGET_S + 2.0)
        if self._watchdog.alive_check is None:
            # a lambda over self.worker: a restart swaps in a successor
            self._watchdog.alive_check = lambda: self.worker.is_alive()
        self.worker.heartbeat = self._watchdog.beat
        self.worker.step_done = self._watchdog.step_done
        if self.on_wedged != "503":
            self._watchdog.on_wedged = self._wedged_escalate
        if not self._watchdog._thread.is_alive():
            self._watchdog.start()

    def _statusz(self) -> dict:
        """/statusz: the watchdog's state when one runs, else the worker's
        liveness; the replica's role; the KV tier's residency when the
        radix store is on; a draining daemon reads `draining` (unless
        wedged)."""
        if self._watchdog is not None:
            s = dict(self._watchdog.status())
        else:
            alive = self.worker.is_alive()
            s = {"state": "ok" if alive else "wedged",
                 "components": {"worker": {
                     "state": "ok" if alive else "wedged",
                     "detail": "serving worker thread liveness"}}}
        s["role"] = self.role
        comps = dict(s.get("components") or {})
        if self.step_clock is not None and self.step_clock.steps_total:
            # slow-but-healthy vs wedged at a glance (informational)
            comps["step"] = self.step_clock.status_component()
        if self._kvtier_leases is not None:
            st = self.batcher._prefix_store
            comps["kvtier"] = {
                "state": "ok",
                "detail": (f"resident_blocks={st.n_blocks} "
                           f"block_hits={st.block_hits} "
                           f"remote_hits={st.remote_block_hits} "
                           f"leases={self._kvtier_leases.n_leases}"),
                "kvtier_blocks": st.n_blocks,
            }
        if self._draining:
            comps["drain"] = {"state": "draining",
                              "detail": "admission closed; finishing "
                                        "in-flight decodes"}
            if s.get("state") != "wedged":
                s["state"] = "draining"
        s["components"] = comps
        return s

    # -- resilience: drain, requeue, the wedged policy -------------------

    def _wedged_escalate(self, detail: str):
        """The watchdog's once-an-episode wedged hook: "restart" asks the
        process to exit at once (serve_lm returns EXIT_RESTART), "drain"
        finishes in-flight work first, within the drain grace."""
        obs.flight.record("wedged_policy", policy=self.on_wedged,
                          detail=str(detail)[:300])
        if self.on_wedged == "drain":
            self._drainz()  # the drain thread escalates when done
        else:
            self._escalate(f"wedged: {detail}")

    def _escalate(self, reason: str):
        self._escalate_reason = reason
        self._escalated.set()

    def drain(self, grace_s: Optional[float] = None) -> dict:
        """Connection draining, blocking: close admission, let in-flight
        decodes finish, hand queued work back, let the worker exit.
        Bounded by `grace_s` (default drain_grace_s): work still running
        then is abandoned (its futures cancel)."""
        grace = self.drain_grace_s if grace_s is None else float(grace_s)
        self._draining = True
        self.worker.begin_drain()
        self.worker.join(timeout=grace)
        clean = not self.worker.is_alive()
        if not clean:
            self.worker.stop(drain=False)
            self.worker.join(timeout=5)
        obs.flight.record("drain_exit", clean=clean, grace_s=round(grace, 3))
        return {"drained": True, "clean": clean}

    def _drainz(self) -> dict:
        """POST /drainz, SIGTERM and the drain policy: start one
        background drain (idempotent) and report its state."""
        with self._drain_lock:
            if self._drain_thread is None:
                def run():
                    self.drain()
                    self._escalate("drained")

                obs.flight.record("drainz", source="http_or_policy")
                self._drain_thread = threading.Thread(
                    target=run, daemon=True, name="lm-drain")
                self._draining = True  # refuse admissions at once
                self._drain_thread.start()
        return {"draining": True, "active": self.batcher.n_active,
                "queued": self.worker.q.qsize(),
                "worker_alive": self.worker.is_alive()}

    def _on_worker_death(self, exc, inflight, queued):
        """The worker died mid-step (a device fault, injected or real).
        Spawn a successor over the same batcher and requeue the
        idempotent survivors: unary requests (nothing streamed yet) with
        retries left and time before their deadline; the rest fail fast.
        At most `worker_restarts` restarts in 300 s: past that, a broken
        device fails every caller fast instead of looping. Runs on the
        dying worker's thread, which owns the batcher until it returns."""
        now = time.perf_counter()
        with self._restart_lock:
            self._restart_times = [t for t in self._restart_times
                                   if now - t <= self._restart_window_s]
            can_restart = (len(self._restart_times) < self.worker_restarts
                           and not self._draining)
            if can_restart:
                self._restart_times.append(now)
        items = [(rid, it) for rid, it in inflight] + [(None, it)
                                                       for it in queued]
        fail_exc = RuntimeError(f"LM batcher worker died: {exc}")
        if not can_restart:
            obs.flight.record("worker_restart_exhausted",
                              window_s=self._restart_window_s,
                              budget=self.worker_restarts, failed=len(items))
            for _rid, it in items:
                _fail_future(it.fut, fail_exc)
            return
        # retire the dead requests' slots (their static graph buffers go
        # inactive) and drop a dispatched but uncommitted overlap step:
        # the successor starts from a clean pool and never commits a
        # token of the dead step into a requeued request
        for rid, _it in inflight:
            try:
                if self.batcher.cancel(rid):
                    self.batcher.claim(rid)
            except Exception:  # noqa: BLE001 — the slot already retired
                pass
        self.batcher.drop_inflight()
        new_worker = self._spawn_worker()
        old = self.worker
        new_worker.heartbeat = old.heartbeat
        new_worker.step_done = old.step_done
        self.worker = new_worker
        new_worker.start()
        requeued = failed = 0
        for _rid, it in items:
            ok = (it.on_token is None and not it.cancel_evt.is_set()
                  and it.attempts < self.max_request_retries
                  and now - it.t_q < self.request_timeout)
            if ok:
                ok = new_worker._resubmit(
                    it._replace(attempts=it.attempts + 1))
            if ok:
                requeued += 1
            else:
                failed += 1
                _fail_future(it.fut, fail_exc)
        obs.flight.record("worker_restart", restarts=len(self._restart_times),
                          requeued=requeued, failed=failed,
                          error=str(exc)[:300])
        log.warning("batcher worker restarted after death (%s): %d requests "
                    "requeued, %d failed", exc, requeued, failed)

    def json_constraint(self, depth: int):
        """The TokenConstraint of a JSON value nested at most `depth`
        levels (the gen option "j=DEPTH"), compiled once per depth over
        the model's vocabulary through the tokenizer's `vocab_bytes`.
        None when the tokenizer has no token -> bytes map; ValueError
        for a depth outside [0, _MAX_JSON_DEPTH]."""
        depth = int(depth)
        if not 0 <= depth <= self._MAX_JSON_DEPTH:
            raise ValueError(f"json depth must be in [0, "
                             f"{self._MAX_JSON_DEPTH}], got {depth}")
        vb = getattr(self.tokenizer, "vocab_bytes", None)
        if vb is None:
            return None
        c = self._constraint_cache.get(depth)
        if c is None:
            from dnn_tpu_torch.runtime.constrain import (TokenConstraint,
                                                         json_regex)

            # over the MODEL's vocab: a padded embedding table's extra
            # ids map to b"" (banned)
            model_v = self.batcher.cfg.vocab_size
            try:
                vocab = list(vb(model_v))
            except TypeError:
                vocab = list(vb())
            vocab = (vocab + [b""] * (model_v - len(vocab)))[:model_v]
            c = TokenConstraint.from_regex(json_regex(depth), vocab)
            self._constraint_cache[depth] = c
        return c

    def _embed_prompt(self, prompt: np.ndarray, pooling: str) -> np.ndarray:
        """The pooled final hidden state (C,) f32 of one prompt
        (runtime/embeddings.make_embed over the served weights, at the
        batcher's compute type), the prompt padded to a prompt_pad
        multiple as JAX's daemon pads it (padding after the real tokens
        changes nothing). Runs on the worker thread (`_BatcherWorker.call`)."""
        cfg = self.batcher.cfg
        if (getattr(self.batcher.family, "ffn", None) is not None
                and getattr(cfg, "default_ffn", lambda: None)() is None):
            # the extractor resolves a config's own MLP override
            # (Mixtral's default_ffn); an ffn set only on the family
            # adapter (the GPT-MoE daemon) has no hook in it (JAX
            # lm_server.py:1561-1572)
            raise ValueError(
                "the embedding endpoint does not support ffn-overridden "
                "families whose config carries no default_ffn (the "
                "GPT-MoE daemon)")
        t = int(prompt.size)
        if t < 1:
            raise ValueError("embedding needs at least one token")
        if t > cfg.block_size:
            raise ValueError(
                f"prompt length {t} > block_size {cfg.block_size}")
        fn = self._embed_fns.get(pooling)
        if fn is None:
            from dnn_tpu_torch.runtime.embeddings import make_embed

            fn = self._embed_fns[pooling] = make_embed(
                cfg, pooling=pooling,
                compute_dtype=self.batcher.family.compute_dtype)
        p_pad = self.batcher.prompt_pad
        padded_len = min(-(-t // p_pad) * p_pad, cfg.block_size)
        ids = np.zeros((1, max(padded_len, t)), np.int64)
        ids[0, :t] = prompt.reshape(-1)
        out = fn(self.batcher.prepared, ids, np.asarray([t], np.int64))
        return out[0].float().cpu().numpy()

    async def _embed(self, prompt, rid_clean: str, context):
        """The embed[:mean|last] endpoint (JAX lm_server.py:1913-1932):
        the reply's status and tensor as JAX's daemon gives them."""
        pooling = (rid_clean.split(":", 1)[1] if ":" in rid_clean
                   else "mean")
        if pooling not in ("mean", "last"):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"embed pooling must be mean|last, got {pooling!r}")
        if not self.worker.is_alive():
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "LM batcher worker is not running (died or shut down)")
        fut = self.worker.call(
            lambda: self._embed_prompt(np.asarray(prompt), pooling))
        try:
            vec = await asyncio.wait_for(asyncio.wrap_future(fut),
                                         self.request_timeout)
        except asyncio.TimeoutError:
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                f"embedding exceeded {self.request_timeout}s")
        except ValueError as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except Exception as e:  # noqa: BLE001 — mapped to a status
            await self._abort_for(e, context)
        return wc.TensorResponse(
            status=f"[lm] ok: embedding dim {vec.shape[-1]}",
            result_tensor=_tensor_msg(vec))

    async def _abort_for(self, exc, context):
        if isinstance(exc, NotImplementedError):
            await context.abort(grpc.StatusCode.UNIMPLEMENTED, str(exc))
        if isinstance(exc, (ValueError, TypeError)):
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        await context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))

    async def _validated_prompt(self, request, context) -> np.ndarray:
        try:
            prompt = _tensor_arr(request.tensor)
        except wc.PayloadCorruptError as e:
            await context.abort(grpc.StatusCode.DATA_LOSS, str(e))
        except ValueError as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        if not np.issubdtype(prompt.dtype, np.integer):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"prompt must be integer token ids, got dtype {prompt.dtype}")
        vocab = self.batcher.cfg.vocab_size
        if prompt.size and (prompt.min() < 0 or prompt.max() >= vocab):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"prompt token ids must be in [0, {vocab}), got range "
                f"[{prompt.min()}, {prompt.max()}]")
        return prompt

    async def _preflight(self, request_id: str, context):
        """Both fronts' preflight: the drain gate (UNAVAILABLE, which
        clients retry elsewhere), the worker's liveness, the options."""
        if self._draining:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "draining: admission closed; retry against another replica")
        if not self.worker.is_alive():
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "LM batcher worker is not running (died or shut down)")
        max_new, seed, opts = parse_gen_options(request_id,
                                                self.default_max_new)
        if "kv_handle" in opts:
            opts["prefilled"] = await self._resolve_kv_handle(
                opts.pop("kv_handle"), context)
        if "json_depth" in opts:
            try:
                # a depth's first use compiles a vocab-sized token table:
                # host work that must not block the event loop
                c = await asyncio.to_thread(self.json_constraint,
                                            opts.pop("json_depth"))
            except ValueError as e:
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            if c is None:
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    "JSON mode (j=) needs a server tokenizer with a "
                    "token->bytes map (io/tokenizer.ByteTokenizer)")
            opts["constraint"] = c
        dl = extract_deadline(request_id)
        timeout = (self.request_timeout if dl is None
                   else max(min(self.request_timeout, dl), 0.001))
        return max_new, seed, opts, timeout

    async def _generate(self, prompt, request_id: str, context):
        """Generate for `prompt` (1-D ids) under `request_id`'s options;
        the tokens, or the RPC aborted with the request's status. A
        repeated dedup key (d=) joins the first request's future: its
        wait is shielded, so this caller's deadline or disconnect never
        cancels the original's generation."""
        max_new, seed, opts, timeout = await self._preflight(request_id,
                                                             context)
        # the request's root span: a client's tr= tag continues its trace
        root = obs.continue_or_start("lm.request", request_id,
                                     method="SendTensor",
                                     prompt_len=int(prompt.size))
        try:
            tokens = await self._generate_traced(prompt, max_new, seed, opts,
                                                 timeout, root, context)
        except BaseException as e:
            root.end(error=type(e).__name__)
            raise
        root.end(tokens=len(tokens))
        return tokens

    async def _generate_traced(self, prompt, max_new, seed, opts, timeout,
                               root, context):
        dkey = opts.pop("dedup", None)
        cancel_evt = threading.Event()
        fut = None
        if dkey is not None:
            # a failed or cancelled entry is replaced: retrying after a
            # real failure is the point of retrying
            with self._dedup_lock:
                cached = self._dedup.get(dkey)
                if cached is not None and not cached.cancelled() and not (
                        cached.done() and cached.exception() is not None):
                    fut = cached
        joined = fut is not None
        if joined:
            obs.flight.record("dedup_join", key=str(dkey)[:80],
                              trace_id=root.trace_id)
            root.set(dedup="join")
        else:
            fut = self.worker.submit(prompt, max_new, seed, opts=opts,
                                     cancel_evt=cancel_evt,
                                     trace=root if root else None)
            if dkey is not None:
                with self._dedup_lock:
                    self._dedup[dkey] = fut
                    while len(self._dedup) > self._DEDUP_CAP:
                        self._dedup.pop(next(iter(self._dedup)))
        wrapped = asyncio.wrap_future(fut)
        try:
            tokens = await asyncio.wait_for(
                asyncio.shield(wrapped) if joined else wrapped, timeout)
        except asyncio.TimeoutError:
            cancel_evt.set()
            if (m := obs.metrics()) is not None:
                m.inc("serving.deadline_exceeded_total")
            obs.flight.record("deadline_miss", method="SendTensor",
                              timeout_s=timeout, trace_id=root.trace_id)
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                f"generation exceeded {timeout}s")
        except asyncio.CancelledError:
            if fut.cancelled():  # the server abandoned it (shutdown)
                await context.abort(grpc.StatusCode.UNAVAILABLE,
                                    "LM server shut down")
            cancel_evt.set()  # the client went away: free the slot
            raise
        except Exception as e:  # noqa: BLE001 — mapped to a status
            await self._abort_for(e, context)
        return tokens

    async def SendTensor(self, request, context):
        rid_clean = ":".join(s for s in (request.request_id or "").split(":")
                             if not s.startswith(("dl=", "tr=")))
        # KV movement: these payloads are not token ids, so they dispatch
        # before the prompt's validation (kvstage and kvlease carry a
        # prompt and validate it themselves)
        head, _, arg = rid_clean.partition(":")
        if head == "kvput":
            return await self._kvput(arg, request, context)
        kvtier = {"kvstage": self._kvtier_stage, "kvlease": self._kvtier_lease,
                  "kvfetch": self._kvtier_fetch, "kvack": self._kvtier_ack,
                  "kvpull": self._kvtier_pull}.get(head)
        if kvtier is not None:
            await self._kvtier_require(context)
            return await kvtier(request, arg, context)
        prompt = await self._validated_prompt(request, context)
        if rid_clean == "embed" or rid_clean.startswith("embed:"):
            return await self._embed(prompt, rid_clean, context)
        if rid_clean == "prefill":
            return await self._prefill_export(prompt, context)
        tokens = await self._generate(prompt.reshape(-1), request.request_id,
                                      context)
        return wc.TensorResponse(
            status=f"[lm] ok: {len(tokens)} tokens",
            result_tensor=_tensor_msg(np.asarray(tokens, np.int32)))

    async def GenerateStream(self, request, context):
        """One TensorResponse per token as it commits; the stream ends
        when generation does. A client that goes away cancels the
        request at the next step boundary."""
        prompt = await self._validated_prompt(request, context)
        max_new, seed, opts, timeout = await self._preflight(
            request.request_id, context)
        # a stream cannot join another request (its tokens go to one
        # consumer): the dedup key is dropped
        opts.pop("dedup", None)
        root = obs.continue_or_start("lm.request", request.request_id,
                                     method="GenerateStream",
                                     prompt_len=int(prompt.size))
        loop = asyncio.get_running_loop()
        q: "asyncio.Queue" = asyncio.Queue()
        cancel_evt = threading.Event()

        def on_token(tok):
            loop.call_soon_threadsafe(q.put_nowait, ("tok", tok))

        fut = self.worker.submit(prompt.reshape(-1), max_new, seed,
                                 opts=opts, on_token=on_token,
                                 cancel_evt=cancel_evt,
                                 trace=root if root else None)
        # fires after the last on_token call for this request, so the
        # "done" sentinel always trails the last token in the queue
        fut.add_done_callback(
            lambda f: loop.call_soon_threadsafe(q.put_nowait, ("done", f)))
        deadline = loop.time() + timeout
        n = 0
        try:
            while True:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    cancel_evt.set()
                    if (m := obs.metrics()) is not None:
                        m.inc("serving.deadline_exceeded_total")
                    obs.flight.record("deadline_miss",
                                      method="GenerateStream",
                                      timeout_s=timeout, tokens=n,
                                      trace_id=root.trace_id)
                    await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                        f"generation exceeded {timeout}s")
                try:
                    kind, val = await asyncio.wait_for(q.get(), remaining)
                except asyncio.TimeoutError:
                    continue
                if kind == "tok":
                    n += 1
                    yield wc.TensorResponse(
                        status=f"[lm] token {n}",
                        result_tensor=_tensor_msg(np.asarray([val], np.int32)))
                    continue
                if val.cancelled():
                    await context.abort(grpc.StatusCode.UNAVAILABLE,
                                        "LM server shut down")
                if val.exception() is not None:
                    await self._abort_for(val.exception(), context)
                return
        except asyncio.CancelledError:
            cancel_evt.set()
            raise
        finally:
            root.end(tokens=n)

    # -- KV between replicas (JAX lm_server.py:1607-1885) --------------

    async def _on_worker(self, fn, context):
        """fn() on the batcher's worker thread between two steps (device
        work never meets a step's graph capture); its result. A ValueError
        aborts INVALID_ARGUMENT; anything else propagates."""
        if not self.worker.is_alive():
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "LM batcher worker is not running (died or shut down)")
        fut = self.worker.call(fn)
        try:
            return await asyncio.wait_for(asyncio.wrap_future(fut),
                                          self.request_timeout)
        except asyncio.TimeoutError:
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                f"exceeded {self.request_timeout}s")
        except ValueError as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    async def _reply(self, data: np.ndarray, status: str, context):
        """A reply carrying `data` (uint8), refused RESOURCE_EXHAUSTED when
        it would not fit the wire's message cap (a gRPC error at once,
        never a hung or truncated reply)."""
        if data.nbytes + _FRAME_SLACK > MAX_MESSAGE_BYTES:
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"{status}: {data.nbytes} bytes exceed the wire's "
                f"{MAX_MESSAGE_BYTES}-byte message cap (hand off bf16 or "
                "int8 KV, or serve a shorter max_len)")
        return wc.TensorResponse(status=f"[lm] ok: {status}",
                                 result_tensor=_tensor_msg(data))

    async def _prefill_export(self, prompt, context):
        """prefill: the prompt's chunk loop only, answered with the packed
        KV row (control/handoff.py) a decode replica stages by kvput."""
        from dnn_tpu_torch.control import handoff

        payload = await self._on_worker(
            lambda: self.batcher.export_prefill(np.asarray(prompt)), context)
        data = await asyncio.to_thread(handoff.pack, payload)
        return await self._reply(data, f"prefill kv {data.size} bytes",
                                 context)

    async def _kvput(self, key: str, request, context):
        """kvput:KEY: stage a prefill replica's packed row under KEY,
        parsed and checked against this pool's geometry now (a mismatch
        fails here with a readable diff, not at admission)."""
        key = key.strip()
        if not key:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "kvput needs a nonempty handle key (kvput:<key>)")
        if hasattr(self.batcher, "spec_k"):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "speculative servers cannot adopt handed-off KV (the draft "
                "cache needs its own prompt prefill)")
        if getattr(self.batcher, "_ilv", 0):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "interleaved-admission servers (prefill_chunk_tokens) cannot "
                "adopt handed-off KV — adoption rides the convoy install "
                "path")
        from dnn_tpu_torch.control import handoff

        try:
            raw = _tensor_arr(request.tensor)
        except wc.PayloadCorruptError as e:
            await context.abort(grpc.StatusCode.DATA_LOSS, str(e))
        except ValueError as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        try:
            payload = await asyncio.to_thread(handoff.unpack, raw)
        except ValueError as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        mine = self.batcher.handoff_fingerprint()
        theirs = payload.get("fingerprint") or {}
        if theirs and theirs != mine:
            diff = {k: (theirs.get(k), mine.get(k))
                    for k in set(theirs) | set(mine)
                    if theirs.get(k) != mine.get(k)}
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"handoff geometry mismatch (theirs, mine): {diff} — prefill "
                "and decode replicas must share model config, max_len, "
                "prompt_pad and kv dtype")
        self._sweep_kv_handoffs()
        with self._kv_lock:
            self._kv_handoff.pop(key, None)
            self._kv_handoff[key] = (payload, time.monotonic())
            while len(self._kv_handoff) > self._kv_handoff_cap:
                self._kv_handoff.pop(next(iter(self._kv_handoff)))
        return wc.TensorResponse(
            status=f"[lm] ok: kv handle {key!r} staged "
                   f"({payload['prompt_len']} prompt positions)")

    async def _resolve_kv_handle(self, key: str, context) -> dict:
        """h=KEY -> its staged payload, consumed (single use). An unknown
        or used handle is INVALID_ARGUMENT: generating without the
        adopted KV would prefill again and hide a broken handoff."""
        with self._kv_lock:
            entry = self._kv_handoff.pop(key, None)
        if entry is None:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"unknown or already-consumed kv handle {key!r} (kvput: it "
                "first; handles are single-use — an expired handle was "
                "TTL-swept, re-stage it)")
        return entry[0]

    def _sweep_kv_handoffs(self, now: Optional[float] = None) -> int:
        """Drop inbox entries older than kv_handoff_ttl_s (<= 0: never);
        returns how many. Run by the housekeeping tick and at every
        kvput."""
        ttl = self._kv_handoff_ttl_s
        if ttl <= 0:
            return 0
        now = time.monotonic() if now is None else now
        with self._kv_lock:
            old = [(k, payload.get("prompt_len"))
                   for k, (payload, t0) in self._kv_handoff.items()
                   if now - t0 > ttl]
            for k, _ in old:
                del self._kv_handoff[k]
        m = obs.metrics()
        for k, plen in old:
            if m is not None:
                m.inc("serving.kvput_expired_total")
            obs.flight.record("kvput_expired", key=str(k)[:80],
                              prompt_len=plen, ttl_s=ttl, cause="kvput_ttl")
        return len(old)

    def _housekeeping_tick(self):
        """The worker loop's housekeeping, at most once a second: the kvput
        inbox's and the leases' TTL sweeps."""
        now = time.monotonic()
        if now - self._hk_last < 1.0:
            return
        self._hk_last = now
        self._sweep_kv_handoffs(now)
        if self._kvtier_leases is not None:
            self._kvtier_leases.sweep(now)

    async def _kvtier_require(self, context):
        if self._kvtier_leases is None:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "the KV tier is off on this replica: serve with kv=paged (or "
                "paged_blocks>0) and prefix_cache>0")

    async def _kvtier_stage(self, request, _arg, context):
        """kvstage: the prompt's full blocks prefilled into the radix store
        (no slot, no sampling); the stats as JSON in the status."""
        prompt = await self._validated_prompt(request, context)
        try:
            stats = await self._on_worker(
                lambda: self.batcher.stage_prefix(np.asarray(prompt)),
                context)
        except grpc.aio.AbortError:
            raise
        except Exception as e:  # noqa: BLE001 — InsufficientBlocks and
            # the like: transient, the caller treats staging as advisory
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                f"{type(e).__name__}: {e}")
        return wc.TensorResponse(status="[lm] ok: kvstage "
                                 + json.dumps(stats))

    async def _kvtier_lease(self, request, _arg, context):
        """kvlease: the resident block run of these tokens, exported,
        packed (kvtier/migrate.py) and staged under a TTL'd lease; answers
        the offer's meta (lease, bytes, blocks, n_tokens, and shm + nonce
        where the host has shm) as a uint8 JSON tensor."""
        from dnn_tpu_torch.kvtier import migrate

        prompt = await self._validated_prompt(request, context)
        try:
            payload = await self._on_worker(
                lambda: self.batcher.kvtier_export(np.asarray(prompt)),
                context)
        except grpc.aio.AbortError:
            raise
        except Exception as e:  # noqa: BLE001 — the donor's failure,
            # reported readable
            await context.abort(grpc.StatusCode.INTERNAL,
                                f"{type(e).__name__}: {e}")
        if payload is None:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                "no resident prefix blocks for these tokens")
        wire = await asyncio.to_thread(migrate.pack_blocks, payload)
        if wire.nbytes + _FRAME_SLACK > MAX_MESSAGE_BYTES:
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"kvlease: {wire.nbytes} bytes exceed the wire's "
                f"{MAX_MESSAGE_BYTES}-byte message cap")
        meta = self._kvtier_leases.offer(wire.tobytes())
        n_tok = int(payload["tokens"].size)
        meta.update(n_tokens=n_tok, blocks=n_tok // payload["block_len"])
        return wc.TensorResponse(
            status=f"[lm] ok: lease {meta['lease']} offered "
                   f"({meta['bytes']} bytes)",
            result_tensor=_tensor_msg(np.frombuffer(
                json.dumps(meta).encode(), np.uint8)))

    async def _kvtier_fetch(self, _request, lease_id: str, context):
        """kvfetch:LEASE: the grpc rung, the staged bytes. An unknown or
        expired lease is NOT_FOUND (the adopter prefills again)."""
        try:
            data = self._kvtier_leases.fetch(lease_id)
        except KeyError:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"unknown or expired kvtier lease {lease_id!r}")
        return await self._reply(np.frombuffer(data, np.uint8),
                                 f"lease {lease_id} ({len(data)} bytes)",
                                 context)

    async def _kvtier_ack(self, _request, lease_id: str, _context):
        """kvack:LEASE: the adopter's ingest confirmed; the staging goes."""
        ok = self._kvtier_leases.ack(lease_id)
        return wc.TensorResponse(status=f"[lm] ok: lease {lease_id} "
                                 + ("released" if ok else "already gone"))

    async def _kvtier_pull(self, request, _arg, context):
        """kvpull: pull a prefix's blocks FROM a donor replica and adopt
        them here. Advisory, as in JAX: any failure (a dead donor, an
        expired lease, a geometry mismatch, a full pool) answers a
        "kvtier_fallback" status, and the next generate prefills again."""
        try:
            raw = _tensor_arr(request.tensor)
            spec = json.loads(np.asarray(raw, np.uint8).tobytes())
            donor = str(spec["donor"])
            tokens = np.asarray(spec["tokens"], np.int32).reshape(-1)
            force_grpc = spec.get("rung") == "grpc"
        except (wc.PayloadCorruptError, ValueError, KeyError, TypeError):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                'kvpull expects a uint8 JSON tensor {"donor": "host:port", '
                '"tokens": [...]}')

        def pull():
            from dnn_tpu_torch.comm.client import NodeClient
            from dnn_tpu_torch.kvtier import migrate

            client = NodeClient(donor)
            try:
                return migrate.pull_blocks(client, tokens,
                                           timeout=self._kv_lease_ttl_s,
                                           shm=not force_grpc)
            finally:
                client.close()

        m = obs.metrics()
        try:
            _chaos_inject.kv_migrate()  # the donor-death-mid-pull seam
            payload = await asyncio.to_thread(pull)
            n = await asyncio.wrap_future(self.worker.call(
                lambda: self.batcher.kvtier_adopt(payload)))
        except Exception as e:  # noqa: BLE001 — a failed pull fails the
            # optimization, never the request: the generate prefills
            if m is not None:
                m.inc("dnn_tpu_kvtier_fallback_total")
            obs.flight.record("kvtier_fallback", donor=donor,
                              error=f"{type(e).__name__}: {e}"[:200])
            return wc.TensorResponse(
                status=f"[lm] kvtier_fallback: {type(e).__name__}: {e}"[:240])
        nbytes = int(payload.get("_wire_bytes", 0))
        if m is not None and n:
            m.inc("dnn_tpu_kvtier_migrated_blocks_total", n)
            if nbytes:
                m.inc("dnn_tpu_kvtier_migrated_bytes_total", nbytes)
        obs.flight.record("kvtier_adopted", donor=donor, blocks=n,
                          bytes=nbytes)
        return wc.TensorResponse(
            status=f"[lm] ok: kvpull adopted {n} blocks "
                   f"({nbytes} bytes) from {donor} over "
                   f"{payload['_rung']}")

    async def HealthCheck(self, request, context):
        # a draining daemon reports unhealthy, so balancers stop routing
        return pb.HealthCheckResponse(
            is_healthy=self.worker.is_alive() and not self._draining)

    async def SendMessage(self, request, context):
        """The text front. The transport hello is declined first (a hello
        never reaches the tokenizer); "!stats", or any text without a
        tokenizer, answers with the pool's stats; otherwise the text is a
        prompt, the options ride the sender_id, and the reply is the
        decoded continuation. Text that tokenizes to nothing answers
        INVALID_ARGUMENT."""
        if request.sender_id.startswith(HELLO_SENDER):
            return pb.MessageReply(
                confirmation_text=decline_hello("LM daemon serves grpc only"))
        text = request.message_text
        if self.tokenizer is None or text == "!stats":
            b = self.batcher
            return pb.MessageReply(confirmation_text=(
                f"[lm] pool: {b.n_active}/{b.slots} slots active, "
                f"{len(b.results)} unclaimed results"))
        ids = self.tokenizer.encode(text)
        if not ids:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                "prompt text tokenized to nothing")
        tokens = await self._generate(np.asarray(ids, np.int32),
                                      request.sender_id, context)
        return pb.MessageReply(confirmation_text=self.tokenizer.decode(
            [int(t) for t in tokens]))

    def close(self):
        self.worker.stop(drain=False)
        self.worker.join(timeout=10)
        if self._watchdog is not None:
            self._watchdog.close()
            self._watchdog = None
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        if self._kvtier_leases is not None:
            self._kvtier_leases.close()  # frees staging and shm segments


async def _start(cfg, prepared, port: int, server_kwargs):
    servicer = LMServer(cfg, prepared, **server_kwargs)
    server = grpc.aio.server(options=GRPC_MSG_OPTIONS)
    server.add_generic_rpc_handlers((_handlers(servicer),))
    if server.add_insecure_port(f"[::]:{port}") == 0:
        servicer.close()
        raise RuntimeError(f"failed to bind gRPC server to [::]:{port}")
    await server.start()
    return servicer, server


async def serve_lm(cfg, prepared, *, port: int, **server_kwargs) -> int:
    """Start the LM daemon and block until termination. `server_kwargs`
    go to LMServer (tokenizer, default_max_new, metrics_port, watchdog,
    on_wedged, ...) and on to the batcher (kv, kv_dtype, compute_dtype,
    decode_buckets, paged_blocks, prefix_cache, prefill_chunk_tokens,
    overlap, ...).

    SIGTERM DRAINS (JAX lm_server.py:2108-2195): admission closes
    (UNAVAILABLE "draining", retriable), in-flight decodes finish within
    the drain grace, queued work is handed back, and the daemon returns
    0. A wedged-policy escalation (on_wedged "restart" or "drain")
    returns EXIT_RESTART (43), so a supervisor relaunches the process;
    so does a drain through POST /drainz."""
    servicer, server = await _start(cfg, prepared, port, server_kwargs)
    log.info("gRPC LM server listening on [::]:%d (%d slots, %s)", port,
             servicer.batcher.slots, servicer.batcher.device)
    loop = asyncio.get_running_loop()
    sigterm_drained = False

    def on_sigterm():
        nonlocal sigterm_drained
        sigterm_drained = True
        obs.flight.record("sigterm_drain")
        log.info("SIGTERM: draining (admission closed, finishing in-flight "
                 "decodes)")
        servicer._drainz()  # a background drain, which escalates

    try:
        loop.add_signal_handler(signal.SIGTERM, on_sigterm)
    except (NotImplementedError, ValueError, RuntimeError):
        pass  # not the main thread

    async def wait_escalated():
        # bounded waits: a cancelled task never strands a thread in wait()
        while not await asyncio.to_thread(servicer._escalated.wait, 1.0):
            pass

    esc_task = asyncio.ensure_future(wait_escalated())
    term_task = asyncio.ensure_future(server.wait_for_termination())
    try:
        await asyncio.wait({esc_task, term_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if servicer._escalated.is_set():
            reason = servicer._escalate_reason or "escalated"
            log.warning("serve_lm exiting on escalation: %s", reason)
            return 0 if sigterm_drained else EXIT_RESTART
        return 0
    finally:
        # the server stops FIRST (wait_for_termination then completes on
        # its own) and the watcher tasks are reaped after: cancelling
        # wait_for_termination while stop() runs makes grpc.aio raise
        # CancelledError out of this finally, and the exit code comes
        # back 1 instead of 0 or 43
        esc_task.cancel()
        try:
            await server.stop(grace=1)
        except asyncio.CancelledError:
            pass
        for t in (esc_task, term_task):
            if not t.done():
                t.cancel()
            try:
                await t
            except BaseException:  # noqa: BLE001 — reaped, not consulted
                pass
        servicer.close()


def start_lm_server_loop():
    """One event loop on a daemon thread for one or more LM daemons in this
    process (gRPC's asyncio poller floods its wake-up socket when many
    loops run in one process): returns (start, close). `start(cfg,
    prepared, port=, **server_kwargs)` serves a daemon on the loop and
    returns its `stop` (with `stop.servicer`), callable from any thread
    but the loop's; `close()` ends the loop once the daemons are stopped;
    `close.thread` is the loop's thread."""
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True,
                         name="lm-grpc-loop")
    t.start()

    def start(cfg, prepared, *, port: int, **server_kwargs):
        try:
            servicer, server = asyncio.run_coroutine_threadsafe(
                _start(cfg, prepared, port, server_kwargs), loop).result(
                    timeout=120)
        except Exception as e:
            raise RuntimeError(f"LM server failed to start: {e!r}") from e

        def stop():
            asyncio.run_coroutine_threadsafe(server.stop(grace=0.2),
                                             loop).result(timeout=10)
            servicer.close()

        stop.servicer = servicer
        return stop

    def close():
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=10)
        loop.close()

    close.thread = t
    return start, close


def start_lm_server_in_background(cfg, prepared, *, port: int,
                                  **server_kwargs):
    """serve_lm on a loop of its own (start_lm_server_loop); returns
    (thread, stop). `stop()` shuts the server down and ends the loop;
    `stop.servicer` is the LMServer."""
    start, close = start_lm_server_loop()
    try:
        stop_server = start(cfg, prepared, port=port, **server_kwargs)
    except BaseException:
        close()
        raise

    def stop():
        stop_server()
        close()

    stop.servicer = stop_server.servicer
    return close.thread, stop
