"""gRPC service for the NodeService wire (port of
dnn_tpu/comm/service.py:90-967).

Methods are registered with explicit (de)serializer callables — the
hand-coded codec for the Tensor messages, the generated protobuf classes
for the rest — so a peer running either package, or real protobuf,
interoperates byte for byte.

`StageServer` serves one pipeline stage. An activation comes in inline,
or as a transport ticket (comm/transport.py: a device ticket resolves to
the parked CUDA tensor after its producer's event, an shm ticket's
payload is copied out of its ring slot), on unary SendTensor and on
Relay's ingress. The stage computes off the event loop and its output
stays on the card; the negotiated downstream sender decides whether host
bytes ever exist. The last stage answers "Processing complete.
Prediction: N"; the others forward over the hop they negotiated with the
next node (device, shm or grpc, per `transport`), with bounded retries
on transient codes inside a budget derived from the rung
(transport.hop_budget_s). The streamed `Relay` RPC acks each microbatch
as soon as it is accepted, computes the accepted ones in order, forwards
each over a downstream Relay stream when the next peer's hello
advertises it (else over the unary chain), and pumps the results back
upstream as `res:<seq>:` frames; a downstream ack frees the sent
ticket's slot or mailbox entry. SendMessage answers the transport hello
(TransportHost: the highest rung this process can prove, with Relay).

Observability, with JAX's names and labels: a `stage.request` root span
a request, continued from the sender's `tr=` tag, with `stage.compute`
and `rpc.forward` children (the forwarded request id tagged with the
forward's span, so the downstream stage's spans nest under it);
`comm.hop_seconds{stage,transport,mode}`, `comm.hop_ack_seconds`,
`comm.rpc_latency_seconds{method,role,stage,transport}`,
`comm.payload_bytes_total{direction,stage}`,
`comm.deadline_exceeded_total` and `comm.retries_total`. Chaos seams:
`perturb_rpc("stage", next_address)` before each downstream send,
`perturb_relay()` for every inbound Relay frame (transport.ChunkAssembler).
`serve_stage(..., metrics_port=)` serves /metrics, /healthz, /debugz and
/profilez beside the stage; kernel builds count themselves
(obs/compile_watch.py).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import signal
import threading
import time
from typing import Optional

import grpc
import numpy as np
import torch

from dnn_tpu_torch import native, obs
from dnn_tpu_torch.chaos import inject as _chaos_inject
from dnn_tpu_torch.comm import transport as tx
from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.transport import (
    HELLO_SENDER,
    PER_STAGE_BUDGET_S,
    extract_deadline,
    tag_deadline,
)
from dnn_tpu_torch.parallel.pipeline import sync
from dnn_tpu_torch.utils.metrics import labeled

log = logging.getLogger("dnn_tpu_torch.comm")

SERVICE_NAME = "node_service.NodeService"

# the wire's message cap, both directions (the JAX package's too)
MAX_MESSAGE_BYTES = 64 * 1024 * 1024
GRPC_MSG_OPTIONS = [
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
]

# Transient codes worth retrying (the JAX package's RETRYABLE_CODES);
# DEADLINE_EXCEEDED is not: a deadline spans the whole rest of the
# pipeline, so a resend could only duplicate downstream work.
RETRYABLE_CODES = frozenset({
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
    grpc.StatusCode.DATA_LOSS,
})

__all__ = ["PER_STAGE_BUDGET_S", "RETRYABLE_CODES", "SERVICE_NAME",
           "StageServer", "serve_stage", "start_stage_servers_in_background",
           "start_stage_server_in_background"]


def full_jitter_delay(backoff: float, attempt: int) -> float:
    """Backoff uniform in (0, backoff * 2^attempt], with a small floor."""
    return max(backoff * (2 ** attempt) * random.random(), backoff * 0.05)


def _tensor_msg(arr) -> wc.Tensor:
    """array -> wire Tensor (payload as a view of the array's buffer)."""
    return wc.make_tensor(arr)


def _tensor_arr(msg) -> np.ndarray:
    """wire Tensor -> read-only ndarray view; raises
    wc.PayloadCorruptError on a declared-checksum mismatch."""
    return wc.tensor_view(msg)


def _handlers(servicer):
    """Generic handler for SendTensor, HealthCheck, SendMessage and —
    when the servicer has them — the streaming GenerateStream and
    Relay."""
    handlers = {
        "SendTensor": grpc.unary_unary_rpc_method_handler(
            servicer.SendTensor,
            request_deserializer=wc.parse_request,
            response_serializer=wc.serialize_response,
        ),
        "HealthCheck": grpc.unary_unary_rpc_method_handler(
            servicer.HealthCheck,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.HealthCheckResponse.SerializeToString,
        ),
        "SendMessage": grpc.unary_unary_rpc_method_handler(
            servicer.SendMessage,
            request_deserializer=pb.MessageRequest.FromString,
            response_serializer=pb.MessageReply.SerializeToString,
        ),
    }
    if hasattr(servicer, "GenerateStream"):
        handlers["GenerateStream"] = grpc.unary_stream_rpc_method_handler(
            servicer.GenerateStream,
            request_deserializer=wc.parse_request,
            response_serializer=wc.serialize_response,
        )
    if hasattr(servicer, "Relay"):
        handlers["Relay"] = grpc.stream_stream_rpc_method_handler(
            servicer.Relay,
            request_deserializer=wc.parse_request,
            response_serializer=wc.serialize_response,
        )
    return grpc.method_handlers_generic_handler(SERVICE_NAME, handlers)


class StageServer:
    """Serves the stage of `node_id` (its part of the topology config)
    from `engine` (a PipelineEngine, usually role="stage").
    `transport` is the downstream hop's preference (auto | grpc | shm |
    device; None follows the engine's config): "auto" negotiates device
    -> shm -> grpc (and so learns whether the next peer speaks Relay),
    "grpc" skips the hello, an explicit "device" or "shm" that the next
    peer cannot grant raises TransportMisconfigError at the first
    forward."""

    #: how many accepted microbatches a Relay stream may hold acked but
    #: not yet computed; a full queue stalls the reads, so the acks, so
    #: the upstream sender (backpressure hop by hop)
    ACCEPT_WINDOW = 4

    def __init__(self, engine, node_id: str, transport: Optional[str] = None):
        transport = engine.transport if transport is None else transport
        if transport not in tx.TRANSPORTS:
            raise ValueError(f"transport must be one of {tx.TRANSPORTS}, "
                             f"got {transport!r}")
        native.load()  # build the checksum library before serving
        self.engine = engine
        self.config = engine.config
        self.node = self.config.node_by_id(node_id)
        self.part_index = self.node.part_index
        self.is_last = self.part_index == self.config.num_parts - 1
        nxt = self.config.next_node(self.node)
        self.next_address = nxt.address if nxt else None
        self.transport = transport
        self._thost = tx.TransportHost(stage=self.node.id)
        self._next_channel: Optional[grpc.aio.Channel] = None
        self._negotiated: Optional[tx.Negotiated] = None
        self._hop_warm = False  # one send on the downstream hop succeeded
        self._neg_lock = asyncio.Lock()

    def _ingress(self, tensor):
        """Inbound payload -> (activation, the rung it came by): tickets
        through the transport host (an shm payload copied out of its
        slot, a device ticket's tensor after its event), inline tensors
        decoded (checksum verified)."""
        if self._thost.is_ticket(tensor):
            rung = ("device" if tensor.dtype == tx.TICKET_DTYPE_DEV
                    else "shm")
            return self._thost.resolve(tensor), rung
        return wc.tensor_torch(tensor), "grpc"

    def _compute_stage(self, x):
        """This stage on its device, waited for (honest compute spans);
        the output stays on the device (runs on a worker thread)."""
        y = self.engine.run_stage(self.part_index, x)
        sync(y.device)
        return y

    def _result(self, y):
        """The last stage's (status, result Tensor) for output y (runs on
        a worker thread: the checksum of a large result takes a while)."""
        pred = int(torch.argmax(y.float().flatten()))
        log.info("final stage done (node %s), prediction=%d", self.node.id,
                 pred)
        return (f"[{self.node.id}] Processing complete. Prediction: {pred}",
                wc.make_tensor(y))

    def _next_device(self):
        """The downstream stage's device when this engine runs it too
        (lets the device sender start the copy before the control
        message)."""
        relay = getattr(self.engine, "_relay", None)
        nxt = self.part_index + 1
        if relay is not None and nxt < len(relay.devices):
            return relay.devices[nxt]
        return None

    def _channel(self) -> grpc.aio.Channel:
        """The one channel to the next node, opened on first use (on the
        event loop of this server)."""
        if self._next_channel is None:
            self._next_channel = grpc.aio.insecure_channel(
                self.next_address, options=GRPC_MSG_OPTIONS)
        return self._next_channel

    async def SendTensor(self, request, context):  # noqa: N802 — RPC name
        nid = self.node.id
        t_handler = time.perf_counter()
        inbound_dl = extract_deadline(request.request_id)
        m = obs.metrics()
        if m is not None:
            m.inc(labeled("comm.payload_bytes_total", direction="in",
                          stage=nid), request.ByteSize())
        root = obs.continue_or_start("stage.request", request.request_id,
                                     stage=nid, part=self.part_index)
        result_msg = None
        t_in = "grpc"
        try:
            try:
                x, t_in = self._ingress(request.tensor)
            except wc.PayloadCorruptError as e:
                # fail the RPC itself so the sender's retry sees DATA_LOSS
                log.warning("corrupt payload on %s: %s", nid, e)
                root.end(error="payload_corrupt")
                await context.abort(grpc.StatusCode.DATA_LOSS, str(e))
            except tx.TransportError as e:
                log.warning("transport ticket error on %s: %s", nid, e)
                root.end(error="transport_ticket")
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            root.set(transport=t_in)
            with root.child("stage.compute", part=self.part_index):
                y = await asyncio.to_thread(self._compute_stage, x)
            if self.is_last:
                status, result_msg = await asyncio.to_thread(self._result, y)
            else:
                budget = None
                if inbound_dl is not None:
                    budget = inbound_dl - (time.perf_counter() - t_handler)
                resp = await self._forward(request.request_id, y,
                                           parent=root,
                                           inbound_budget=budget)
                status = f"[{nid}] Forwarded. Next node status: {resp.status}"
                if resp.HasField("result_tensor"):
                    result_msg = resp.result_tensor
        except grpc.aio.AbortError:
            raise
        except grpc.aio.AioRpcError as e:
            log.error("forward from %s to %s failed: %s", nid,
                      self.next_address, e.details())
            status = f"[{nid}] Error forwarding: {e.details()}"
        except Exception as e:  # noqa: BLE001 — relayed as a status string
            log.exception("error processing tensor on %s", nid)
            status = f"[{nid}] Error: {e}"
        finally:
            root.end()
        if m is not None:
            m.observe_hist(labeled("comm.rpc_latency_seconds",
                                   method="SendTensor", role="server",
                                   stage=nid, transport=t_in),
                           time.perf_counter() - t_handler)
        resp_msg = wc.TensorResponse(status=status, result_tensor=result_msg)
        if m is not None:
            m.inc(labeled("comm.payload_bytes_total", direction="out",
                          stage=nid), resp_msg.ByteSize())
        return resp_msg

    async def HealthCheck(self, request, context):  # noqa: N802
        return pb.HealthCheckResponse(is_healthy=True)

    async def SendMessage(self, request, context):  # noqa: N802
        if request.sender_id.startswith(HELLO_SENDER):
            return pb.MessageReply(confirmation_text=self._thost.answer_hello(
                request.message_text))
        log.info("message for %s from %s", self.node.id, request.sender_id)
        return pb.MessageReply(confirmation_text=(
            f"[{self.node.id}] got msg '{request.message_text}'"))

    async def Relay(self, request_iterator, context):  # noqa: N802
        """The streamed relay. Each inbound microbatch (one frame, or the
        chunks of one payload; a ticket is one frame) is acked upstream as
        soon as it is accepted into a bounded queue (ACCEPT_WINDOW deep;
        an shm payload is copied out of its slot first: the ack licenses
        the sender to reuse it), and one loop computes the accepted
        microbatches in order off the event loop, so the upstream sender
        moves on while this stage computes. A computed microbatch goes
        downstream over a Relay stream when the next peer's hello
        advertised one, else over the unary chain; the results come back
        up as `res:<seq>:` frames, and a downstream ack releases the sent
        ticket (`comm.hop_ack_seconds`: submit to downstream accept). A
        microbatch that fails answers its own seq with an error status
        and the stream goes on; a frame that breaks the framing ends the
        stream with `res:-1:`. Never retried: the acks already released
        the sender.

        Backpressure: the downstream frames go through a writer queue of
        2 x ACCEPT_WINDOW, so a slow downstream stalls the compute loop,
        then the accept queue, then the acks; results and acks going
        upstream queue without bound, so the downstream pump never waits
        on this stream's consumer."""
        nid = self.node.id
        m = obs.metrics()
        out_q: asyncio.Queue = asyncio.Queue()
        accept_q: asyncio.Queue = asyncio.Queue(maxsize=self.ACCEPT_WINDOW)
        done = object()
        ds: dict = {"call": None, "wq": None, "writer": None, "pump": None,
                    "pending": {}, "sent_at": {}}

        async def write_downstream(call, wq):
            try:
                while (frame := await wq.get()) is not None:
                    await call.write(frame)
            except Exception as e:  # noqa: BLE001 — told upstream at once
                log.warning("relay downstream write failed on %s: %s", nid,
                            e)
                await out_q.put(wc.TensorResponse(status=tx.result_status(
                    -1, f"[{nid}] Error forwarding: {e}")))
                await out_q.put(done)
            finally:
                try:
                    await call.done_writing()
                except Exception:  # noqa: BLE001 — an already broken call
                    pass

        async def pump_downstream(call, neg):
            try:
                async for resp in call:
                    seq = tx.parse_ack(resp.status)
                    if seq is None:
                        await out_q.put(resp)
                        continue
                    req = ds["pending"].pop(seq, None)
                    if req is not None:
                        neg.sender.sent_ok(req)
                    t_sent = ds["sent_at"].pop(seq, None)
                    if m is not None and t_sent is not None:
                        dt = time.perf_counter() - t_sent
                        m.observe(labeled("comm.hop_ack_seconds", stage=nid,
                                          transport=neg.name), dt)
                        m.observe_hist(labeled(
                            "comm.rpc_latency_seconds", method="relay_hop",
                            role="client", stage=nid, transport=neg.name),
                            dt)
                    self._hop_warm = True
            except grpc.aio.AioRpcError as e:
                await out_q.put(wc.TensorResponse(status=tx.result_status(
                    -1, f"[{nid}] Error forwarding: {e.details()}")))
            finally:
                await out_q.put(done)

        def open_downstream(neg):
            call = self._channel().stream_stream(
                f"/{SERVICE_NAME}/Relay",
                request_serializer=wc.serialize_request,
                response_deserializer=wc.parse_response)()
            ds["call"] = call
            ds["wq"] = asyncio.Queue(maxsize=2 * self.ACCEPT_WINDOW)
            ds["writer"] = asyncio.ensure_future(
                write_downstream(call, ds["wq"]))
            ds["pump"] = asyncio.ensure_future(pump_downstream(call, neg))

        async def forward_one(base_rid, seq, y, root):
            neg = await self._ensure_negotiated()
            if neg.relay_ok:
                if ds["call"] is None:
                    open_downstream(neg)
                sp = obs.start_span("rpc.forward", parent=root,
                                    target=self.next_address,
                                    transport=neg.name, streamed=True)
                t0 = time.perf_counter()
                rid_out = obs.tag_request_id(base_rid, sp)
                req = neg.sender.make_request_nowait(y, rid_out)
                if req is None:  # a full shm ring: wait off the loop
                    req = await asyncio.to_thread(neg.sender.make_request,
                                                  y, rid_out)
                ds["pending"][seq] = req
                ds["sent_at"][seq] = t0
                for frame in tx.split_requests(req, seq):
                    await ds["wq"].put(frame)
                if m is not None:
                    m.observe(labeled("comm.hop_seconds", stage=nid,
                                      transport=neg.name, mode="streamed"),
                              time.perf_counter() - t0)
                sp.end()
                return
            resp = await self._forward(base_rid, y, parent=root)
            await out_q.put(wc.TensorResponse(
                status=tx.result_status(
                    seq, f"[{nid}] Forwarded. Next node status: "
                         f"{resp.status}"),
                result_tensor=resp.result_tensor
                if resp.HasField("result_tensor") else None))

        async def read_inputs():
            asm = tx.ChunkAssembler()
            try:
                async for frame in request_iterator:
                    whole = asm.add(frame)
                    if whole is None:
                        continue
                    base_rid, seq, tensor = whole
                    t0 = time.perf_counter()
                    try:
                        x, t_in = self._ingress(tensor)
                    except ValueError as e:  # PayloadCorruptError included
                        x, t_in = e, "grpc"
                    await accept_q.put((base_rid, seq, x, t_in, t0))
                    await out_q.put(wc.TensorResponse(
                        status=tx.ack_status(seq)))
            except (tx.TransportError, wc.PayloadCorruptError) as e:
                log.warning("relay framing error on %s: %s", nid, e)
                await out_q.put(wc.TensorResponse(status=tx.result_status(
                    -1, f"[{nid}] Error: {e}")))
            finally:
                await accept_q.put(None)

        async def compute_loop():
            while (item := await accept_q.get()) is not None:
                base_rid, seq, x, t_in, t0 = item
                root = obs.continue_or_start(
                    "stage.request", base_rid, stage=nid,
                    part=self.part_index, transport=t_in, seq=seq)
                try:
                    if isinstance(x, Exception):
                        raise x
                    with root.child("stage.compute", part=self.part_index):
                        y = await asyncio.to_thread(self._compute_stage, x)
                    if self.is_last:
                        status, msg = await asyncio.to_thread(self._result, y)
                        await out_q.put(wc.TensorResponse(
                            status=tx.result_status(seq, status),
                            result_tensor=msg))
                    else:
                        await forward_one(base_rid, seq, y, root)
                except Exception as e:  # noqa: BLE001 — this item's error
                    log.warning("relay item %s failed on %s: %s", seq, nid,
                                e)
                    root.set(error=str(e))
                    await out_q.put(wc.TensorResponse(status=tx.result_status(
                        seq, f"[{nid}] Error: {e}")))
                finally:
                    root.end()
                if m is not None:
                    m.observe_hist(labeled(
                        "comm.rpc_latency_seconds", method="Relay",
                        role="server", stage=nid, transport=t_in),
                        time.perf_counter() - t0)
            if ds["writer"] is None:
                await out_q.put(done)
            else:
                # the writer closes the downstream send side; the pump ends
                # the stream once the downstream has answered every item
                await ds["wq"].put(None)
                await ds["writer"]

        reader = asyncio.ensure_future(read_inputs())
        consumer = asyncio.ensure_future(compute_loop())
        try:
            while (item := await out_q.get()) is not done:
                yield item
        finally:
            for task in (reader, consumer, ds["writer"], ds["pump"]):
                if task is not None:
                    task.cancel()
            if ds["call"] is not None:
                ds["call"].cancel()
            neg = self._negotiated
            if neg is not None:
                for req in ds["pending"].values():
                    neg.sender.cleanup(req)
            ds["pending"].clear()

    async def _ensure_negotiated(self) -> tx.Negotiated:
        """The downstream hop's handshake, once. A hello that fails
        (the next node not up yet) gives an uncached grpc verdict without
        Relay, so the next forward asks again; an explicit rung the peer
        refuses raises TransportMisconfigError."""
        async with self._neg_lock:
            if self._negotiated is not None:
                return self._negotiated
            if self.transport == "grpc":
                self._negotiated = tx.Negotiated("grpc", tx.GrpcSender(),
                                                 reason="explicit")
                return self._negotiated
            call = self._channel().unary_unary(
                f"/{SERVICE_NAME}/SendMessage",
                request_serializer=pb.MessageRequest.SerializeToString,
                response_deserializer=pb.MessageReply.FromString)
            offer, probe = tx.build_offer(self.transport)
            try:
                try:
                    reply = await call(pb.MessageRequest(
                        sender_id=HELLO_SENDER,
                        message_text=json.dumps(offer)), timeout=10.0)
                except grpc.aio.AioRpcError as e:
                    return tx.Negotiated("grpc", tx.GrpcSender(),
                                         reason=f"hello failed: {e.code()}")
                self._negotiated = tx.conclude(
                    offer, reply.confirmation_text, transport=self.transport,
                    target=self.next_address, device=self._next_device())
                return self._negotiated
            finally:
                tx.close_probe(probe)

    async def _forward(self, request_id: str, y, *, retries: int = 2,
                       backoff: float = 0.2, parent=None,
                       inbound_budget: Optional[float] = None):
        """Send y downstream over the negotiated rung, under an
        `rpc.forward` span whose id tags the forwarded request. One budget
        covers every attempt and backoff sleep: transport.hop_budget_s
        for the remaining stages (a warm device or shm hop budgets
        seconds), capped by what the sender still had; each attempt's
        deadline (and its dl= tag) is what is left of it. A ticket lives
        until the response lands, so a retry resends it; it is released
        in every outcome, a cancellation included."""
        neg = await self._ensure_negotiated()
        nid = self.node.id
        sp = obs.start_span("rpc.forward", parent=parent,
                            target=self.next_address, transport=neg.name)
        downstream = max(self.config.num_parts - self.part_index - 1, 1)
        timeout = tx.hop_budget_s(neg.name, downstream, warm=self._hop_warm)
        if inbound_budget is not None:
            timeout = max(min(timeout, inbound_budget), 0.001)
        rid_out = tag_deadline(obs.tag_request_id(request_id, sp), timeout)
        request = neg.sender.make_request_nowait(y, rid_out)
        if request is None:
            request = await asyncio.to_thread(neg.sender.make_request, y,
                                              rid_out)
        call = self._channel().unary_unary(
            f"/{SERVICE_NAME}/SendTensor",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        m = obs.metrics()
        deadline = time.monotonic() + timeout
        attempt = 0
        completed = False
        try:
            while True:
                remaining = deadline - time.monotonic()
                request.request_id = tag_deadline(rid_out,
                                                  max(remaining, 0.001))
                t_try = time.perf_counter()
                if m is not None:
                    m.inc(labeled("comm.payload_bytes_total",
                                  direction="out", stage=nid),
                          request.ByteSize())
                try:
                    _chaos_inject.perturb_rpc("stage", self.next_address)
                    resp = await call(request, timeout=max(remaining, 0.001))
                    dt = time.perf_counter() - t_try
                    if m is not None:
                        m.observe_hist(labeled(
                            "comm.rpc_latency_seconds", method="forward",
                            role="client", stage=nid, transport=neg.name),
                            dt)
                        m.observe(labeled("comm.hop_seconds", stage=nid,
                                          transport=neg.name, mode="nested"),
                                  dt)
                    sp.set(attempts=attempt + 1)
                    completed = True
                    self._hop_warm = True
                    return resp
                except (grpc.RpcError, wc.PayloadCorruptError) as e:
                    code = (e.code() if isinstance(e, grpc.RpcError)
                            else grpc.StatusCode.DATA_LOSS)
                    if m is not None and \
                            code == grpc.StatusCode.DEADLINE_EXCEEDED:
                        m.inc(labeled("comm.deadline_exceeded_total",
                                      stage=nid))
                    worst = backoff * (2 ** attempt)
                    if (code not in RETRYABLE_CODES or attempt >= retries
                            or deadline - time.monotonic() <= worst):
                        sp.set(error=str(code), attempts=attempt + 1)
                        raise
                    delay = full_jitter_delay(backoff, attempt)
                    if m is not None:
                        m.inc(labeled("comm.retries_total", stage=nid,
                                      outcome=code.name.lower()))
                    log.warning("forward %s -> %s failed (%s), retry %d/%d "
                                "in %.2fs [trace=%s]", nid,
                                self.next_address, code, attempt + 1,
                                retries, delay, sp.trace_id or "-")
                    await asyncio.sleep(delay)
                    attempt += 1
        finally:
            if completed:
                neg.sender.sent_ok(request)
            else:
                neg.sender.cleanup(request)
            sp.end()

    async def close(self):
        if self._next_channel is not None:
            await self._next_channel.close()
            self._next_channel = None
        neg, self._negotiated = self._negotiated, None
        if neg is not None:
            neg.sender.close()
        self._thost.close()


async def _start_stage(engine, node_id, port, transport):
    servicer = StageServer(engine, node_id, transport=transport)
    bind_port = port if port is not None else servicer.node.port
    if bind_port is None:
        raise ValueError(f"node '{node_id}' has no address in the config; "
                         "serving a stage needs nodes[].address IP:Port")
    server = grpc.aio.server(options=GRPC_MSG_OPTIONS)
    server.add_generic_rpc_handlers((_handlers(servicer),))
    if server.add_insecure_port(f"[::]:{bind_port}") == 0:
        raise RuntimeError(f"failed to bind gRPC server to [::]:{bind_port}")
    await server.start()
    log.info("gRPC stage server %s listening on [::]:%d (part %d, "
             "transport=%s)", node_id, bind_port, servicer.part_index,
             servicer.transport)
    return servicer, server


async def serve_until_terminated(server) -> int:
    """Block until `server` terminates or this process gets SIGTERM, then
    stop it (1 s grace). Returns 0, the exit code of a clean stop."""
    loop = asyncio.get_running_loop()
    stopping = asyncio.Event()
    try:
        loop.add_signal_handler(signal.SIGTERM, stopping.set)
    except (NotImplementedError, RuntimeError, ValueError):
        pass  # not the main thread
    term = asyncio.ensure_future(server.wait_for_termination())
    stop = asyncio.ensure_future(stopping.wait())
    try:
        await asyncio.wait({term, stop}, return_when=asyncio.FIRST_COMPLETED)
        return 0
    finally:
        await server.stop(grace=1)
        for t in (term, stop):
            if not t.done():
                t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass


async def serve_stage(engine, node_id: str, *, port: Optional[int] = None,
                      transport: Optional[str] = None,
                      metrics_port: Optional[int] = None) -> int:
    """Serve this node's stage until termination; SIGTERM stops it
    cleanly (rc 0). `metrics_port` (None = off, 0 = ephemeral) also
    serves the observability endpoint (JAX :517-563): /metrics (the
    per-stage RPC latencies by rung, payload bytes, retries, deadlines,
    negotiations, kernel builds, the card's memory gauges), /healthz,
    /trace, /debugz (the flight ring: chaos_inject, transport_fallback)
    and /profilez."""
    servicer, server = await _start_stage(engine, node_id, port, transport)
    metrics_srv = None
    if metrics_port is not None:
        metrics_srv = obs.serve_metrics(metrics_port,
                                        device=engine.devices[0])
        log.info("stage %s observability on http://127.0.0.1:%d/metrics",
                 node_id, metrics_srv.port)
    try:
        return await serve_until_terminated(server)
    finally:
        await servicer.close()
        if metrics_srv is not None:
            metrics_srv.close()


def start_stage_servers_in_background(stages, *,
                                      transport: Optional[str] = None):
    """Serve several stages, `stages` = [(engine, node_id, port or
    None)], on one event loop on a daemon thread (one loop for all: gRPC's
    asyncio poller floods its wake-up socket when many loops run in one
    process). Returns (thread, stop); `stop.servicers` lists the
    StageServers."""
    loop = asyncio.new_event_loop()
    started = threading.Event()
    state: dict = {"started": []}

    async def _run():
        try:
            for engine, node_id, port in stages:
                state["started"].append(await _start_stage(
                    engine, node_id, port, transport))
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

    names = ",".join(node_id for _, node_id, _ in stages)
    t = threading.Thread(target=_thread_main, daemon=True,
                         name=f"stage-{names}")
    t.start()
    if not started.wait(timeout=60):
        raise RuntimeError(f"stage servers {names} failed to start")
    if "error" in state:
        t.join(timeout=5)
        raise RuntimeError(f"stage servers {names} failed to start: "
                           f"{state['error']}") from state["error"]

    def stop():
        async def _stop():
            for servicer, server in state["started"]:
                await servicer.close()
                await server.stop(grace=0.2)
            state["done"].set()

        asyncio.run_coroutine_threadsafe(_stop(), loop).result(timeout=30)
        t.join(timeout=10)

    stop.servicers = [servicer for servicer, _ in state["started"]]
    return t, stop


def start_stage_server_in_background(engine, node_id: str, *,
                                     port: Optional[int] = None,
                                     transport: Optional[str] = None):
    """One stage server on a daemon thread with its own event loop;
    returns (thread, stop). `stop.servicer` is the StageServer."""
    t, stop = start_stage_servers_in_background([(engine, node_id, port)],
                                                transport=transport)
    stop.servicer = stop.servicers[0]
    return t, stop
