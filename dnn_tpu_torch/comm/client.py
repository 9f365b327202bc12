"""Synchronous client for a NodeService endpoint (the subset of
dnn_tpu/comm/client.NodeClient this port needs): health checks, the
transport hello (the device -> shm -> grpc ladder of comm/transport.py;
`transport=` as JAX's client takes it), `send_tensor` into a stage
pipeline and `send_tensors` over the streamed Relay RPC, both over the
negotiated rung (a ticket lives until its response or ack lands), unary and streaming generation from the LM
daemon over the same wire and the same request-id option grammar
("gen:max_new[:seed][:t=..][:k=..][:p=..][:m=..][:r=..]"), its text
front over SendMessage, and the daemon's KV movement between replicas:
the prefill->decode handoff (`prefill_kv`, `put_kv`, then a generate
with `kv_handle`) and block migration (`kv_stage`, `kv_lease`,
`kv_fetch`, `kv_ack`, `kv_pull_from`).

Resilience (JAX comm/client.py:63-157, :218-292): a per-client
`CircuitBreaker` sheds send_tensor calls fast (CircuitOpenError)
after consecutive failures, with one half-open probe
a cooldown; a channel that answered UNAVAILABLE `REBUILD_AFTER` times in
a row is replaced by a fresh one (a channel parked in gRPC's reconnect
backoff can miss a server that has since come up); `dedup=` makes a
generate exactly-once on the daemon (d=). send_tensor consults the chaos
seam perturb_rpc("client") before each attempt, runs under an
`rpc.SendTensor` span whose `tr=` tag the stage servers continue, and
observes `comm.rpc_latency_seconds`, `comm.hop_seconds` and
`comm.payload_bytes_total` as JAX's does."""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import List, Optional, Tuple

import grpc
import numpy as np
import torch

from dnn_tpu_torch import native, obs
from dnn_tpu_torch.chaos import inject as _chaos_inject
from dnn_tpu_torch.comm import transport as tx
from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.service import (
    GRPC_MSG_OPTIONS,
    PER_STAGE_BUDGET_S,
    RETRYABLE_CODES,
    SERVICE_NAME,
    _tensor_arr,
    _tensor_msg,
    full_jitter_delay,
)
from dnn_tpu_torch.comm.transport import tag_deadline
from dnn_tpu_torch.utils.metrics import labeled

log = logging.getLogger("dnn_tpu_torch.comm")


def pipeline_budget(num_parts: int, *, margin: float = 30.0) -> float:
    """The edge client's budget for one traversal of a gRPC pipeline: one
    per-stage slice per part plus a margin, so it outlasts the first
    stage's own forward budget and a downstream timeout comes back as
    that stage's status, not as the client's DEADLINE_EXCEEDED."""
    return PER_STAGE_BUDGET_S * num_parts + margin


class CircuitOpenError(RuntimeError):
    """Raised by a client whose breaker is OPEN: the target failed
    `threshold` calls in a row and the cooldown has not passed. Callers
    treat it like UNAVAILABLE without paying a connect timeout and a
    retry ladder per request."""


class CircuitBreaker:
    """Per-target circuit breaker (JAX comm/client.py:70-157): closed ->
    (threshold consecutive failures) -> open -> (cooldown) -> half-open
    (ONE probe call) -> closed on success, or open again with the
    cooldown doubled. Thread-safe; transitions land in the flight ring
    and the `comm.circuit_state{target=}` gauge (0 closed, 1 half-open,
    2 open)."""

    _STATE_VAL = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

    def __init__(self, target: str = "", *, threshold: int = 5,
                 cooldown_s: float = 1.0, max_cooldown_s: float = 30.0):
        self.target = target
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.max_cooldown_s = float(max_cooldown_s)
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._cooldown = self.cooldown_s
        if (m := obs.metrics()) is not None:
            m.set_fn(labeled("comm.circuit_state", target=target),
                     lambda: self._STATE_VAL[self._state])

    @property
    def state(self) -> str:
        return self._state

    def allow(self) -> bool:
        """True when a call may proceed. Open turns half-open (one probe)
        once the cooldown has passed."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if time.monotonic() - self._opened_at < self._cooldown:
                    return False
                self._state = "half_open"
                obs.flight.record("circuit_half_open", target=self.target)
                return True
            return False  # half-open: the one probe is in flight

    def record(self, ok: bool):
        with self._lock:
            if ok:
                if self._state != "closed":
                    obs.flight.record("circuit_close", target=self.target)
                self._state = "closed"
                self._failures = 0
                self._cooldown = self.cooldown_s
                return
            self._failures += 1
            if self._state == "half_open":
                # the probe failed: open again, for longer
                self._state = "open"
                self._opened_at = time.monotonic()
                self._cooldown = min(self._cooldown * 2,
                                     self.max_cooldown_s)
                obs.flight.record("circuit_reopen", target=self.target,
                                  cooldown_s=round(self._cooldown, 3))
            elif self._state == "closed" \
                    and self._failures >= self.threshold:
                self._state = "open"
                self._opened_at = time.monotonic()
                obs.flight.record("circuit_open", target=self.target,
                                  failures=self._failures,
                                  cooldown_s=round(self._cooldown, 3))


def gen_request_id(max_new_tokens: int, seed: Optional[int] = None,
                   temperature: Optional[float] = None,
                   top_k: Optional[int] = None,
                   top_p: Optional[float] = None,
                   min_p: Optional[float] = None,
                   repetition_penalty: Optional[float] = None,
                   logit_bias: Optional[dict] = None,
                   adapter: Optional[int] = None,
                   dedup: Optional[str] = None,
                   kv_handle: Optional[str] = None) -> str:
    """Encode generation options into the request_id the daemon parses
    (runtime/lm_server.parse_gen_options); `logit_bias` ({token id:
    additive bias}) as b=tok~val,tok~val, the JAX client's spelling;
    `adapter` (a LoRA adapter's index on a multi-adapter daemon) as a=;
    `dedup` (an opaque key: the daemon joins a repeated key to the first
    request's generation) as d=, after a= as the JAX client writes it;
    `kv_handle` (the key a handoff was staged under with put_kv) as h=,
    as the JAX router appends it."""
    rid = f"gen:{max_new_tokens}" + (f":{seed}" if seed is not None else "")
    for key, val in (("t", temperature), ("k", top_k), ("p", top_p),
                     ("m", min_p), ("r", repetition_penalty)):
        if val is not None:
            rid += f":{key}={val}"
    if logit_bias:
        rid += ":b=" + ",".join(f"{int(t)}~{float(v)}"
                                for t, v in logit_bias.items())
    if adapter is not None:
        rid += f":a={adapter}"
    if dedup is not None:
        rid += f":d={dedup}"
    if kv_handle is not None:
        rid += f":h={kv_handle}"
    return rid


class NodeClient:
    """Sync client for a NodeService endpoint of either package (or a
    reference node). The first `send_tensors` sends the transport hello,
    which tells whether the peer speaks Relay. Only send_tensor retries
    (generate and send_tensors raise grpc.RpcError at once).

    `breaker=True` (the default) runs a CircuitBreaker over send_tensor
    (send_tensors' unary fallback included); False disables it, a CircuitBreaker instance is
    used as given. After `rebuild_after` (default REBUILD_AFTER)
    consecutive UNAVAILABLE outcomes of send_tensor or health_check the
    channel is rebuilt; health probes bypass the breaker (they are the
    recovery probe)."""

    REBUILD_AFTER = 2  # consecutive UNAVAILABLEs before a fresh channel

    def __init__(self, address: str, *, transport: str = "auto",
                 breaker=True, rebuild_after: Optional[int] = None):
        native.load()  # the checksum library, built before the first call
        if transport not in tx.TRANSPORTS:
            raise ValueError(f"transport must be one of {tx.TRANSPORTS}, "
                             f"got {transport!r}")
        self.address = address
        self.transport = transport
        self._channel = grpc.insecure_channel(address,
                                              options=GRPC_MSG_OPTIONS)
        self._chan_lock = threading.Lock()
        self._conn_fail_streak = 0
        self._last_rebuild = 0.0
        self.rebuild_after = (self.REBUILD_AFTER if rebuild_after is None
                              else int(rebuild_after))
        self.channel_rebuilds = 0
        if breaker is True:
            self.breaker: Optional[CircuitBreaker] = CircuitBreaker(address)
        else:
            self.breaker = breaker or None
        self._negotiated: Optional[tx.Negotiated] = None
        self._neg_lock = threading.Lock()

    def _note_conn_result(self, code):
        """Count consecutive UNAVAILABLEs (a refused connect, or a channel
        in reconnect backoff); any other outcome proves the connection
        and resets the streak. At `rebuild_after` the channel is
        replaced."""
        if code != grpc.StatusCode.UNAVAILABLE:
            self._conn_fail_streak = 0
            return
        self._conn_fail_streak += 1
        if self._conn_fail_streak >= self.rebuild_after:
            self._rebuild_channel()

    def _rebuild_channel(self):
        with self._chan_lock:
            now = time.monotonic()
            if now - self._last_rebuild < 1.0:
                # concurrent failing calls cross the streak together in
                # an outage: one fresh channel a second, not a storm
                self._conn_fail_streak = 0
                return
            self._last_rebuild = now
            old, self._channel = self._channel, grpc.insecure_channel(
                self.address, options=GRPC_MSG_OPTIONS)
            self._conn_fail_streak = 0
            self.channel_rebuilds += 1
        try:
            old.close()  # its straggler calls were failing anyway
        except Exception:  # noqa: BLE001 — already closed
            pass
        if (m := obs.metrics()) is not None:
            m.inc(labeled("comm.channel_rebuilds_total", target=self.address))
        obs.flight.record("channel_rebuild", target=self.address,
                          rebuilds=self.channel_rebuilds)
        log.info("rebuilt gRPC channel to %s after %d consecutive connect "
                 "failures", self.address, self.rebuild_after)

    def health_check(self, timeout: float = 5.0) -> bool:
        call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/HealthCheck",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.HealthCheckResponse.FromString)
        try:
            healthy = bool(call(pb.Empty(), timeout=timeout).is_healthy)
        except grpc.RpcError as e:
            # a probe that cannot connect advances the rebuild streak, so
            # polling a late server heals out of gRPC's backoff
            self._note_conn_result(e.code())
            return False
        self._note_conn_result(None)
        return healthy

    def send_message(self, sender_id: str, text: str,
                     timeout: float = 5.0) -> str:
        """SendMessage: the reply's confirmation text."""
        call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/SendMessage",
            request_serializer=pb.MessageRequest.SerializeToString,
            response_deserializer=pb.MessageReply.FromString)
        return call(pb.MessageRequest(sender_id=sender_id, message_text=text),
                    timeout=timeout).confirmation_text

    def negotiated(self) -> tx.Negotiated:
        """The hop's handshake outcome, negotiated once. A failed hello
        (the peer not up yet) gives an uncached grpc verdict that leaves
        Relay to be tried; a peer without SendMessage a cached one
        without Relay."""
        with self._neg_lock:
            if self._negotiated is not None:
                return self._negotiated
            try:
                neg = tx.negotiate_over(
                    lambda sid, text: self.send_message(sid, text, 10.0),
                    transport=self.transport, target=self.address)
            except grpc.RpcError as e:
                if e.code() != grpc.StatusCode.UNIMPLEMENTED:
                    return tx.Negotiated("grpc", tx.GrpcSender(),
                                         reason=f"hello failed: {e.code()}")
                neg = tx.Negotiated("grpc", tx.GrpcSender(), relay_known=True,
                                    reason="no SendMessage")
            self._negotiated = neg
            return neg

    def wait_healthy(self, deadline: float = 30.0,
                     interval: float = 0.2) -> bool:
        """Poll HealthCheck until healthy or `deadline` seconds pass."""
        t_end = time.monotonic() + deadline
        while not self.health_check(timeout=min(5.0, interval * 4)):
            if time.monotonic() >= t_end:
                return False
            time.sleep(interval)
        return True

    def send_tensor(self, arr, *, request_id: str = "req",
                    timeout: float = 60.0, retries: int = 2,
                    backoff: float = 0.2
                    ) -> Tuple[str, Optional[torch.Tensor]]:
        """Submit an activation (numpy array or tensor) to a stage
        server; returns (status, final tensor or None) from the response
        chain. UNAVAILABLE, RESOURCE_EXHAUSTED and DATA_LOSS are retried
        up to `retries` times with full-jitter backoff; `timeout` is the
        budget of all attempts together, and each attempt carries what is
        left of it as the request's `dl=` deadline. An open breaker
        raises CircuitOpenError before any attempt."""
        if self.breaker is not None and not self.breaker.allow():
            raise CircuitOpenError(
                f"circuit open for {self.address}: shedding fast "
                f"(cooldown {self.breaker._cooldown:.1f}s)")
        neg = self.negotiated()
        sp = obs.start_span("rpc.SendTensor", parent=obs.trace.current_span(),
                            target=self.address, transport=neg.name)
        rid = obs.tag_request_id(request_id, sp)
        request = neg.sender.make_request(arr, tag_deadline(rid, timeout))
        m = obs.metrics()
        deadline = time.monotonic() + timeout
        attempt = 0
        completed = False
        try:
            while True:
                remaining = deadline - time.monotonic()
                request.request_id = tag_deadline(rid, remaining)
                if m is not None:
                    m.inc(labeled("comm.payload_bytes_total",
                                  direction="out"), request.ByteSize())
                # per attempt: a rebuild between attempts takes effect on
                # the next one
                call = self._channel.unary_unary(
                    f"/{SERVICE_NAME}/SendTensor",
                    request_serializer=wc.serialize_request,
                    response_deserializer=wc.parse_response)
                t_try = time.perf_counter()
                try:
                    _chaos_inject.perturb_rpc("client", self.address)
                    resp = call(request, timeout=max(remaining, 0.001))
                    dt = time.perf_counter() - t_try
                    if m is not None:
                        m.observe_hist(labeled(
                            "comm.rpc_latency_seconds", method="SendTensor",
                            role="client", transport=neg.name), dt)
                        m.observe(labeled("comm.hop_seconds",
                                          target=self.address,
                                          transport=neg.name, mode="nested"),
                                  dt)
                        m.inc(labeled("comm.payload_bytes_total",
                                      direction="in"), resp.ByteSize())
                    result = (wc.tensor_torch(resp.result_tensor)
                              if resp.HasField("result_tensor") else None)
                    sp.set(attempts=attempt + 1)
                    completed = True
                    self._note_conn_result(None)
                    return resp.status, result
                except (grpc.RpcError, wc.PayloadCorruptError) as e:
                    code = (e.code() if isinstance(e, grpc.RpcError)
                            else grpc.StatusCode.DATA_LOSS)
                    self._note_conn_result(code)
                    if m is not None and \
                            code == grpc.StatusCode.DEADLINE_EXCEEDED:
                        m.inc(labeled("comm.deadline_exceeded_total",
                                      target=self.address))
                    worst = backoff * (2 ** attempt)
                    if (code not in RETRYABLE_CODES or attempt >= retries
                            or deadline - time.monotonic() <= worst):
                        sp.set(error=str(code), attempts=attempt + 1)
                        raise
                    if m is not None:
                        m.inc(labeled("comm.retries_total",
                                      target=self.address,
                                      outcome=code.name.lower()))
                    time.sleep(full_jitter_delay(backoff, attempt))
                    attempt += 1
        finally:
            # a ticket (mailbox entry, shm slot) lives until the hop
            # resolves, so retries resend it
            if completed:
                neg.sender.sent_ok(request)
            else:
                neg.sender.cleanup(request)
            if self.breaker is not None:
                self.breaker.record(completed)
            sp.end()

    def send_tensors(self, arrs, *, request_id: str = "req",
                     timeout: float = 120.0,
                     ack_s: Optional[List[Optional[float]]] = None
                     ) -> List[Tuple[str, Optional[torch.Tensor]]]:
        """Submit microbatches over the streamed Relay RPC: the first
        stage acks each as soon as it accepts it and computes the next
        while the later stages work, and payloads above CHUNK_BYTES ride
        in chunks. Returns [(status, result or None)] in submission
        order. Never retried once the stream has begun (the acks released
        the items); a peer without Relay (its hello says so, or the call
        answers UNIMPLEMENTED) gets sequential unary send_tensor calls
        instead. `timeout` covers the whole stream. A list passed as
        `ack_s` is filled, as the acks come, with each item's seconds from
        its submission to its ack (None where no ack came)."""
        arrs = list(arrs)
        if ack_s is None:
            ack_s = []
        ack_s[:] = [None] * len(arrs)
        if not arrs:
            return []
        request_id = tag_deadline(request_id, timeout)
        neg = self.negotiated()
        if neg.relay_known and not neg.relay_ok:
            return self._send_each(arrs, request_id, timeout)
        sent_at, pending = {}, {}

        def frames():
            for seq, arr in enumerate(arrs):
                req = neg.sender.make_request(arr, request_id)
                pending[seq] = req
                sent_at[seq] = time.perf_counter()
                yield from tx.split_requests(req, seq)

        call = self._channel.stream_stream(
            f"/{SERVICE_NAME}/Relay",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        results: dict = {}
        stream = call(frames(), timeout=timeout)
        try:
            for resp in stream:
                seq = tx.parse_ack(resp.status)
                if seq is not None:
                    if 0 <= seq < len(arrs) and seq in sent_at:
                        ack_s[seq] = time.perf_counter() - sent_at[seq]
                    if seq in pending:  # the ack frees the ticket
                        neg.sender.sent_ok(pending.pop(seq))
                    continue
                seq, human = tx.parse_result(resp.status)
                if seq is None or seq < 0:
                    raise RuntimeError(f"relay stream error: {human}")
                results[seq] = (human, wc.tensor_torch(resp.result_tensor)
                                if resp.HasField("result_tensor") else None)
                if len(results) == len(arrs):
                    break
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.UNIMPLEMENTED:
                raise
            for req in pending.values():
                neg.sender.cleanup(req)
            pending.clear()
            return self._send_each(arrs, request_id, timeout)
        finally:
            stream.cancel()  # a no-op on a finished stream
            for req in pending.values():
                neg.sender.cleanup(req)
        missing = [i for i in range(len(arrs)) if i not in results]
        if missing:
            raise RuntimeError(
                f"relay stream ended without results for items {missing}")
        return [results[i] for i in range(len(arrs))]

    def _send_each(self, arrs, request_id, timeout):
        """The unary fallback of send_tensors, one item after another."""
        return [self.send_tensor(a, request_id=request_id, timeout=timeout)
                for a in arrs]

    def generate(self, prompt_ids, *, max_new_tokens: int = 32,
                 timeout: float = 120.0, trace=None,
                 **options) -> np.ndarray:
        """Prompt token ids -> generated tokens (SendTensor). `options`
        are gen_request_id's keywords (seed, temperature, top_k, ...).
        `trace` (an obs.trace span) rides the request id as its `tr=`
        tag: the daemon continues that trace (obs.tag_request_id)."""
        from dnn_tpu_torch.obs.trace import tag_request_id

        call = self._channel.unary_unary(
            f"/{SERVICE_NAME}/SendTensor",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        rid = gen_request_id(max_new_tokens, **options)
        req = wc.TensorRequest(
            request_id=tag_request_id(rid, trace) if trace else rid,
            tensor=_tensor_msg(np.asarray(prompt_ids, np.int32).reshape(-1)))
        resp = call(req, timeout=timeout)
        if not resp.HasField("result_tensor"):
            raise RuntimeError(f"LM server returned no tokens: {resp.status}")
        return np.asarray(_tensor_arr(resp.result_tensor), np.int32)

    def generate_stream(self, prompt_ids, *, max_new_tokens: int = 32,
                        timeout: float = 120.0, **options):
        """Yield each generated token as the server commits it
        (GenerateStream). Abandoning the iterator cancels the RPC, which
        frees the server's decode slot."""
        call = self._channel.unary_stream(
            f"/{SERVICE_NAME}/GenerateStream",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        stream = call(
            wc.TensorRequest(
                request_id=gen_request_id(max_new_tokens, **options),
                tensor=_tensor_msg(
                    np.asarray(prompt_ids, np.int32).reshape(-1))),
            timeout=timeout)
        try:
            for resp in stream:
                if resp.HasField("result_tensor"):
                    yield int(_tensor_arr(resp.result_tensor)[0])
        finally:
            stream.cancel()

    def generate_text(self, prompt: str, *, max_new_tokens: int = 32,
                      timeout: float = 120.0, **options) -> str:
        """Prompt text -> the generated text, from a daemon with a
        tokenizer: the prompt rides SendMessage's text, the options its
        sender_id (gen_request_id's grammar)."""
        return self.send_message(gen_request_id(max_new_tokens, **options),
                                 prompt, timeout=timeout)

    def generate_text_stream(self, prompt: str, tokenizer, *,
                             max_new_tokens: int = 32, timeout: float = 120.0,
                             **options):
        """Yield text chunks as tokens commit: the prompt encoded with
        `tokenizer` (the daemon's own) rides GenerateStream, and a
        character split across tokens is held until it is complete, so
        the chunks joined equal the one-shot decode of the stream."""
        from dnn_tpu_torch.io.tokenizer import stream_detokenizer

        det = stream_detokenizer(tokenizer)
        for tok in self.generate_stream(tokenizer.encode(prompt),
                                        max_new_tokens=max_new_tokens,
                                        timeout=timeout, **options):
            chunk = det.push(tok)
            if chunk:
                yield chunk
        tail = det.flush()
        if tail:
            yield tail

    # -- KV movement between LM daemons (JAX comm/client.py:734-822) ----

    def prefill_kv(self, prompt_ids, *, timeout: float = 60.0) -> np.ndarray:
        """A PREFILL replica runs the prompt's chunk loop and answers with
        the packed KV row (control/handoff.py): one uint8 array. Stage it
        on a decode replica with `put_kv` and generate there with
        kv_handle=<key>."""
        status, result = self.send_tensor(
            np.asarray(prompt_ids, np.int32).reshape(-1),
            request_id="prefill", timeout=timeout)
        if result is None:
            raise RuntimeError(f"LM server returned no KV payload: {status}")
        return result.numpy().astype(np.uint8, copy=False)

    def put_kv(self, key: str, payload, *, timeout: float = 60.0) -> str:
        """Stage a prefill replica's KV payload on THIS server under `key`
        (single use: a generate with kv_handle=key consumes it). Returns
        the status line; a geometry mismatch raises INVALID_ARGUMENT."""
        return self.send_tensor(
            np.asarray(payload, np.uint8).reshape(-1),
            request_id=f"kvput:{key}", timeout=timeout)[0]

    def kv_stage(self, prompt_ids, *, timeout: float = 60.0) -> str:
        """Prefill these tokens' full blocks straight into the replica's
        radix store (no decode slot held); the status line ends with the
        stage's stats as JSON."""
        return self.send_tensor(
            np.asarray(prompt_ids, np.int32).reshape(-1),
            request_id="kvstage", timeout=timeout)[0]

    def kv_lease(self, prompt_ids, *, timeout: float = 30.0) -> dict:
        """The donor's side of a block pull: lease the longest resident
        block run of these tokens. Returns the offer's meta {lease, bytes,
        blocks, n_tokens, shm?, nonce?} (kvtier/migrate.py)."""
        status, result = self.send_tensor(
            np.asarray(prompt_ids, np.int32).reshape(-1),
            request_id="kvlease", timeout=timeout)
        if result is None:
            raise RuntimeError(f"kvlease returned no meta: {status}")
        return json.loads(result.numpy().tobytes())

    def kv_fetch(self, lease_id: str, *, timeout: float = 30.0) -> np.ndarray:
        """The grpc rung of a block pull: a lease's staged bytes. An
        expired lease raises NOT_FOUND (the caller prefills again)."""
        status, result = self.send_tensor(
            np.zeros((1,), np.int32),
            request_id=f"kvfetch:{lease_id}", timeout=timeout)
        if result is None:
            raise RuntimeError(f"kvfetch returned no payload: {status}")
        return result.numpy().astype(np.uint8, copy=False)

    def kv_ack(self, lease_id: str, *, timeout: float = 10.0) -> str:
        """Confirm a pulled lease's ingest, so the donor releases its
        staging now rather than at the TTL."""
        return self.send_tensor(
            np.zeros((1,), np.int32),
            request_id=f"kvack:{lease_id}", timeout=timeout)[0]

    def kv_pull_from(self, donor_address: str, prompt_ids, *,
                     timeout: float = 60.0, rung: Optional[str] = None) -> str:
        """Tell THIS replica to pull the prefix's blocks from
        `donor_address` and adopt them. Advisory: a failed pull answers a
        kvtier_fallback status, not an error. `rung="grpc"` skips the shm
        rung (a JAX daemon ignores the key)."""
        spec = {"donor": donor_address,
                "tokens": [int(x) for x in
                           np.asarray(prompt_ids, np.int32).reshape(-1)]}
        if rung is not None:
            spec["rung"] = rung
        return self.send_tensor(
            np.frombuffer(json.dumps(spec).encode(), np.uint8),
            request_id="kvpull", timeout=timeout)[0]

    def close(self):
        neg, self._negotiated = self._negotiated, None
        if neg is not None:
            neg.sender.close()  # an shm ring's segments
        self._channel.close()
