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

Left out of this slice (ROADMAP, "PyTorch/CUDA port" item 4): the
observability endpoints, chaos injection, dedup and connection
draining, the watchdog, KV handoff and the KV tier, and the embedding
endpoint. Their request ids answer UNIMPLEMENTED.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import queue
import threading
from typing import NamedTuple, Optional

import grpc
import numpy as np

from dnn_tpu_torch import native
from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.service import (
    GRPC_MSG_OPTIONS,
    serve_until_terminated,
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
           "parse_gen_options"]

# request ids of JAX-daemon endpoints this port does not serve yet
_UNPORTED_ENDPOINTS = ("embed", "prefill", "kvput:", "kvstage", "kvlease",
                       "kvfetch:", "kvack:", "kvpull")


def parse_gen_options(request_id: str, default_max_new: int):
    """'gen[:max_new[:seed]][:t=TEMP][:k=TOPK][:p=TOPP][:m=MINP]
    [:r=REPPEN][:b=..][:a=..][:d=..][:h=..][:j=..]' -> (max_new, seed,
    opts). Only the literal 'gen' prefix carries options; any other id
    gets the server defaults. Positional segments are max_new then
    seed; unparseable segments fall back to defaults; unknown named
    segments (the JAX client's dl=/tr= tags) are skipped. The b/a/d/h/j
    options parse as in the JAX daemon and are refused at admission
    (not ported)."""
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


class _QueuedRequest(NamedTuple):
    prompt: np.ndarray
    max_new: int
    seed: Optional[int]
    opts: dict
    on_token: object
    cancel_evt: threading.Event
    fut: concurrent.futures.Future


class _BatcherWorker(threading.Thread):
    """The one thread that talks to the device. Owns the batcher; every
    other thread submits through `submit`, which returns a Future."""

    def __init__(self, batcher: ContinuousBatcher):
        super().__init__(daemon=True, name="lm-batcher")
        self.batcher = batcher
        self.q: "queue.Queue[_QueuedRequest]" = queue.Queue()
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self._dead: Optional[BaseException] = None
        self._held: Optional[_QueuedRequest] = None
        self._futures: dict = {}  # rid -> _QueuedRequest

    def submit(self, prompt, max_new: int, seed, *, opts=None,
               on_token=None, cancel_evt=None) -> concurrent.futures.Future:
        """Queue a request. `on_token(tok)` fires on this worker thread
        for every token as it commits; setting `cancel_evt` retires the
        request at the next step boundary (its future is cancelled)."""
        fut = concurrent.futures.Future()
        with self._lock:
            if self._dead is not None:
                _fail_future(fut, self._dead)
                return fut
            self.q.put(_QueuedRequest(
                np.asarray(prompt), max_new, seed, dict(opts or {}),
                on_token, cancel_evt or threading.Event(), fut))
        return fut

    def stop(self):
        """Shut down: queued and in-flight requests fail with "LM server
        shut down" as the worker exits."""
        with self._lock:
            if self._dead is None:
                self._dead = RuntimeError("LM server shut down")
        self._stop_evt.set()

    def _admit(self, item: _QueuedRequest) -> bool:
        """Admit one request; False when it was HELD BACK (pool short of
        blocks) — the caller then stops pulling more work."""
        if item.cancel_evt.is_set():
            item.fut.cancel()
            return True
        try:
            rid = self.batcher.submit(item.prompt, item.max_new,
                                      seed=item.seed, **item.opts)
        except InsufficientBlocks:
            self._held = item
            return False
        except (ValueError, TypeError, NotImplementedError) as e:
            _fail_future(item.fut, e)  # the request's error, not the loop's
            return True
        self._futures[rid] = item
        first = self.batcher.first_token(rid)
        if first is not None:
            self._emit(rid, first)
        return True

    def _emit(self, rid: int, tok: int):
        item = self._futures.get(rid)
        if item is None or item.on_token is None:
            return
        try:
            item.on_token(int(tok))
        except Exception:  # noqa: BLE001 — a dead stream consumer must
            log.exception("on_token callback failed for rid %d", rid)

    def _process_cancels(self):
        for rid, item in list(self._futures.items()):
            if item.cancel_evt.is_set():
                if self.batcher.cancel(rid):
                    self.batcher.claim(rid)
                del self._futures[rid]
                item.fut.cancel()

    def _publish_done(self):
        b = self.batcher
        for rid in [r for r in self._futures if r in b.results]:
            tokens, _reason = b.claim(rid)
            fut = self._futures.pop(rid).fut
            if not fut.done():
                try:
                    fut.set_result(tokens)
                except concurrent.futures.InvalidStateError:
                    pass  # the caller cancelled meanwhile

    def _shutdown(self):
        exc = self._dead or RuntimeError("LM server shut down")
        with self._lock:
            pending = list(self._futures.values())
            self._futures.clear()
            if self._held is not None:
                pending.append(self._held)
                self._held = None
            while True:
                try:
                    pending.append(self.q.get_nowait())
                except queue.Empty:
                    break
        for item in pending:
            _fail_future(item.fut, exc)

    def run(self):
        b = self.batcher
        try:
            while not self._stop_evt.is_set():
                self._process_cancels()
                if b.n_active == 0 and self._held is None:
                    try:
                        item = self.q.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    self._admit(item)
                while b.free_slots():
                    if self._held is not None:
                        item, self._held = self._held, None
                    else:
                        try:
                            item = self.q.get_nowait()
                        except queue.Empty:
                            break
                    if not self._admit(item):
                        break
                for rid, tok in (b.step() if b.n_active else {}).items():
                    self._emit(rid, tok)
                self._publish_done()
        except Exception as e:  # noqa: BLE001 — a device error must fail
            # every waiting caller fast instead of hanging them
            log.exception("batcher worker died")
            with self._lock:
                self._dead = RuntimeError(f"LM batcher worker died: {e}")
        finally:
            self._shutdown()


class LMServer:
    """NodeService servicer: SendTensor(prompt) -> generated tokens,
    GenerateStream, HealthCheck, SendMessage (declines the transport
    hello; with `tokenizer`, prompt text -> generated text; else, and for
    "!stats", the pool's stats). Batcher keyword arguments pass through —
    the cache layout and storage (`kv` "paged"/"dense"/"auto", the
    default; `kv_dtype` f32/bf16/int8; `decode_buckets`; `paged_blocks`,
    `block_len`) among them; `device` defaults to "cuda" and raises
    without a card. A LlamaConfig serves through LlamaFamilyRows(cfg)
    unless `family` is given (serving.default_family)."""

    def __init__(self, cfg, prepared, *, default_max_new: int = 32,
                 request_timeout: float = 120.0, tokenizer=None,
                 **batcher_kwargs):
        native.load()  # the checksum library, built before serving
        self.batcher = ContinuousBatcher(cfg, prepared, **batcher_kwargs)
        self.default_max_new = default_max_new
        self.request_timeout = request_timeout
        self.tokenizer = tokenizer
        self.worker = _BatcherWorker(self.batcher)
        self.worker.start()

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
        if not self.worker.is_alive():
            await context.abort(grpc.StatusCode.UNAVAILABLE,
                                "LM batcher worker is not running")
        clean = ":".join(s for s in (request_id or "").split(":")
                         if not s.startswith(("dl=", "tr=")))
        if clean.startswith(_UNPORTED_ENDPOINTS):
            await context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                f"request id {clean.split(':')[0]!r}: endpoint not ported "
                "to dnn_tpu_torch yet (ROADMAP PyTorch/CUDA port item 4)")
        max_new, seed, opts = parse_gen_options(request_id,
                                                self.default_max_new)
        dl = extract_deadline(request_id)
        timeout = (self.request_timeout if dl is None
                   else max(min(self.request_timeout, dl), 0.001))
        return max_new, seed, opts, timeout

    async def _generate(self, prompt, request_id: str, context):
        """Generate for `prompt` (1-D ids) under `request_id`'s options;
        the tokens, or the RPC aborted with the request's status."""
        max_new, seed, opts, timeout = await self._preflight(request_id,
                                                             context)
        cancel_evt = threading.Event()
        fut = self.worker.submit(prompt, max_new, seed, opts=opts,
                                 cancel_evt=cancel_evt)
        try:
            tokens = await asyncio.wait_for(asyncio.wrap_future(fut), timeout)
        except asyncio.TimeoutError:
            cancel_evt.set()
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                                f"generation exceeded {timeout}s")
        except asyncio.CancelledError:
            cancel_evt.set()  # the client went away: free the slot
            raise
        except Exception as e:  # noqa: BLE001 — mapped to a status
            await self._abort_for(e, context)
        return tokens

    async def SendTensor(self, request, context):
        prompt = await self._validated_prompt(request, context)
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
        loop = asyncio.get_running_loop()
        q: "asyncio.Queue" = asyncio.Queue()
        cancel_evt = threading.Event()

        def on_token(tok):
            loop.call_soon_threadsafe(q.put_nowait, ("tok", tok))

        fut = self.worker.submit(prompt.reshape(-1), max_new, seed,
                                 opts=opts, on_token=on_token,
                                 cancel_evt=cancel_evt)
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

    async def HealthCheck(self, request, context):
        return pb.HealthCheckResponse(is_healthy=self.worker.is_alive())

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
        self.worker.stop()
        self.worker.join(timeout=10)


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
    """Start the LM daemon and block until termination (SIGTERM stops it
    cleanly, rc 0). `server_kwargs` go to LMServer (tokenizer,
    default_max_new, ...) and on to the batcher (kv, kv_dtype,
    decode_buckets, paged_blocks, ...)."""
    servicer, server = await _start(cfg, prepared, port, server_kwargs)
    log.info("gRPC LM server listening on [::]:%d (%d slots, %s)", port,
             servicer.batcher.slots, servicer.batcher.device)
    try:
        return await serve_until_terminated(server)
    finally:
        servicer.close()


def start_lm_server_in_background(cfg, prepared, *, port: int,
                                  **server_kwargs):
    """serve_lm on a daemon thread; returns (thread, stop). `stop()`
    shuts the server down and joins the thread; `stop.servicer` is the
    LMServer."""
    loop = asyncio.new_event_loop()
    started = threading.Event()
    state: dict = {}

    async def _run():
        try:
            state["servicer"], state["server"] = await _start(
                cfg, prepared, port, server_kwargs)
            state["done"] = asyncio.Event()
        except BaseException as e:
            state["error"] = e
            raise
        finally:
            started.set()
        await state["done"].wait()

    def _thread_main():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(_run())
        except BaseException:  # noqa: BLE001 — recorded in state["error"]
            if "error" not in state:
                raise
        finally:
            loop.close()

    t = threading.Thread(target=_thread_main, daemon=True, name="lm-grpc")
    t.start()
    if not started.wait(timeout=120):
        raise RuntimeError("LM server failed to start within 120 s")
    if "error" in state:
        t.join(timeout=5)
        raise RuntimeError(
            f"LM server failed to start: {state['error']}") from state["error"]

    def stop():
        async def _stop():
            await state["server"].stop(grace=0.2)
            state["done"].set()

        asyncio.run_coroutine_threadsafe(_stop(), loop).result(timeout=10)
        state["servicer"].close()
        t.join(timeout=10)

    stop.servicer = state["servicer"]
    return t, stop
