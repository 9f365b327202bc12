"""gRPC service for the NodeService wire (port of
dnn_tpu/comm/service.py:90-967, the grpc rung).

Methods are registered with explicit (de)serializer callables — the
hand-coded codec for the Tensor messages, the generated protobuf classes
for the rest — so a peer running either package, or real protobuf,
interoperates byte for byte.

`StageServer` serves one pipeline stage. Unary SendTensor decodes the
activation, computes the stage off the event loop, and either answers
with the last stage's result ("Processing complete. Prediction: N") or
forwards to the next node over one shared channel, with bounded retries
on transient codes inside a deadline that covers the rest of the
pipeline. The streamed `Relay` RPC acks each microbatch as soon as it is
accepted, computes the accepted ones in order, forwards each over a
downstream Relay stream when the next peer's hello advertises it (else
over the unary chain), and pumps the results back upstream as
`res:<seq>:` frames (framing in comm/transport.py). SendMessage answers
the transport hello by declining every rung beyond grpc while
advertising Relay.

Left out of the Relay port: the JAX package's spans and metrics
(`comm.hop_seconds`, `comm.hop_ack_seconds`, ...; ROADMAP Queue 1 item
12), the chaos hook in the chunk assembler (Queue 1 item 11), and shm
ticket copies (no shm rung; Queue 1 item 7's remainder).
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

from dnn_tpu_torch import native
from dnn_tpu_torch.comm import transport as tx
from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.transport import (
    HELLO_SENDER,
    extract_deadline,
    tag_deadline,
)
from dnn_tpu_torch.parallel.pipeline import sync

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

# One stage's slice of a pipeline deadline: compute (first calls
# included) plus the wire margin, as the JAX package's gRPC budget.
PER_STAGE_BUDGET_S = 30.0


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
    `transport` is the downstream hop's: "auto" negotiates (and so learns
    whether the next peer speaks Relay), "grpc" skips the hello and
    forwards over the unary chain."""

    #: how many accepted microbatches a Relay stream may hold acked but
    #: not yet computed; a full queue stalls the reads, so the acks, so
    #: the upstream sender (backpressure hop by hop)
    ACCEPT_WINDOW = 4

    def __init__(self, engine, node_id: str, transport: Optional[str] = None):
        transport = engine.transport if transport is None else transport
        if transport not in tx.TRANSPORTS:
            raise NotImplementedError(
                f"transport {transport!r}: the shm and device transports are "
                "not ported to dnn_tpu_torch yet (ROADMAP Queue 1 item 7's "
                "remainder); use grpc or auto")
        native.load()  # build the checksum library before serving
        self.engine = engine
        self.config = engine.config
        self.node = self.config.node_by_id(node_id)
        self.part_index = self.node.part_index
        self.is_last = self.part_index == self.config.num_parts - 1
        nxt = self.config.next_node(self.node)
        self.next_address = nxt.address if nxt else None
        self.transport = transport
        self._next_channel: Optional[grpc.aio.Channel] = None
        self._negotiated: Optional[tx.Negotiated] = None
        self._neg_lock = asyncio.Lock()

    def _compute_stage(self, x):
        """This stage on its device, then the result on the host (runs
        on a worker thread)."""
        y = self.engine.run_stage(self.part_index, x)
        sync(y.device)
        return y.cpu()

    def _result(self, y):
        """The last stage's (status, result Tensor) for output y (runs on
        a worker thread: the checksum of a large result takes a while)."""
        pred = int(torch.argmax(y.float().flatten()))
        log.info("final stage done (node %s), prediction=%d", self.node.id,
                 pred)
        return (f"[{self.node.id}] Processing complete. Prediction: {pred}",
                wc.make_tensor(y))

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
        result_msg = None
        try:
            try:
                x = wc.tensor_torch(request.tensor)
            except wc.PayloadCorruptError as e:
                # fail the RPC itself so the sender's retry sees DATA_LOSS
                log.warning("corrupt payload on %s: %s", nid, e)
                await context.abort(grpc.StatusCode.DATA_LOSS, str(e))
            y = await asyncio.to_thread(self._compute_stage, x)
            if self.is_last:
                status, result_msg = await asyncio.to_thread(self._result, y)
            else:
                budget = None
                if inbound_dl is not None:
                    budget = inbound_dl - (time.perf_counter() - t_handler)
                resp = await self._forward(request.request_id, y,
                                           inbound_budget=budget)
                status = f"[{nid}] Forwarded. Next node status: {resp.status}"
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
        return wc.TensorResponse(status=status, result_tensor=result_msg)

    async def HealthCheck(self, request, context):  # noqa: N802
        return pb.HealthCheckResponse(is_healthy=True)

    async def SendMessage(self, request, context):  # noqa: N802
        if request.sender_id.startswith(HELLO_SENDER):
            return pb.MessageReply(
                confirmation_text=tx.answer_hello(request.message_text))
        log.info("message for %s from %s", self.node.id, request.sender_id)
        return pb.MessageReply(confirmation_text=(
            f"[{self.node.id}] got msg '{request.message_text}'"))

    async def Relay(self, request_iterator, context):  # noqa: N802
        """The streamed relay. Each inbound microbatch (one frame, or the
        chunks of one payload) is acked upstream as soon as it is
        accepted into a bounded queue (ACCEPT_WINDOW deep), and one loop
        computes the accepted microbatches in order off the event loop,
        so the upstream sender moves on while this stage computes. A
        computed microbatch goes downstream over a Relay stream when the
        next peer's hello advertised one, else over the unary chain; the
        results come back up as `res:<seq>:` frames. A microbatch that
        fails (a corrupt payload, a compute error, a failed unary
        forward) answers its own seq with an error status and the stream
        goes on; a frame that breaks the framing ends the stream with
        `res:-1:`. Never retried: the acks already released the sender.

        Backpressure: the downstream frames go through a writer queue of
        2 x ACCEPT_WINDOW, so a slow downstream stalls the compute loop,
        then the accept queue, then the acks; results and acks going
        upstream queue without bound, so the downstream pump never waits
        on this stream's consumer."""
        nid = self.node.id
        out_q: asyncio.Queue = asyncio.Queue()
        accept_q: asyncio.Queue = asyncio.Queue(maxsize=self.ACCEPT_WINDOW)
        done = object()
        ds: dict = {"call": None, "wq": None, "writer": None, "pump": None}

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

        async def pump_downstream(call):
            try:
                async for resp in call:
                    if tx.parse_ack(resp.status) is None:
                        await out_q.put(resp)
            except grpc.aio.AioRpcError as e:
                await out_q.put(wc.TensorResponse(status=tx.result_status(
                    -1, f"[{nid}] Error forwarding: {e.details()}")))
            finally:
                await out_q.put(done)

        def open_downstream():
            call = self._channel().stream_stream(
                f"/{SERVICE_NAME}/Relay",
                request_serializer=wc.serialize_request,
                response_deserializer=wc.parse_response)()
            ds["call"] = call
            ds["wq"] = asyncio.Queue(maxsize=2 * self.ACCEPT_WINDOW)
            ds["writer"] = asyncio.ensure_future(
                write_downstream(call, ds["wq"]))
            ds["pump"] = asyncio.ensure_future(pump_downstream(call))

        async def forward_one(base_rid, seq, y):
            neg = await self._ensure_negotiated()
            if neg.relay_ok:
                if ds["call"] is None:
                    open_downstream()
                req = neg.sender.make_request(y, base_rid)
                for frame in tx.split_requests(req, seq):
                    await ds["wq"].put(frame)
                return
            resp = await self._forward(base_rid, y)
            await out_q.put(wc.TensorResponse(
                status=tx.result_status(
                    seq, f"[{nid}] Forwarded. Next node status: "
                         f"{resp.status}"),
                result_tensor=resp.result_tensor))

        async def read_inputs():
            asm = tx.ChunkAssembler()
            try:
                async for frame in request_iterator:
                    whole = asm.add(frame)
                    if whole is None:
                        continue
                    base_rid, seq, tensor = whole
                    try:
                        x = wc.tensor_torch(tensor)
                    except ValueError as e:  # PayloadCorruptError included
                        x = e
                    await accept_q.put((base_rid, seq, x))
                    await out_q.put(wc.TensorResponse(
                        status=tx.ack_status(seq)))
            except tx.TransportError as e:
                log.warning("relay framing error on %s: %s", nid, e)
                await out_q.put(wc.TensorResponse(status=tx.result_status(
                    -1, f"[{nid}] Error: {e}")))
            finally:
                await accept_q.put(None)

        async def compute_loop():
            while (item := await accept_q.get()) is not None:
                base_rid, seq, x = item
                try:
                    if isinstance(x, Exception):
                        raise x
                    y = await asyncio.to_thread(self._compute_stage, x)
                    if self.is_last:
                        status, msg = await asyncio.to_thread(self._result, y)
                        await out_q.put(wc.TensorResponse(
                            status=tx.result_status(seq, status),
                            result_tensor=msg))
                    else:
                        await forward_one(base_rid, seq, y)
                except Exception as e:  # noqa: BLE001 — this item's error
                    log.warning("relay item %s failed on %s: %s", seq, nid,
                                e)
                    await out_q.put(wc.TensorResponse(status=tx.result_status(
                        seq, f"[{nid}] Error: {e}")))
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

    async def _ensure_negotiated(self) -> tx.Negotiated:
        """The downstream hop's handshake, once. A hello that fails
        (the next node not up yet) gives an uncached grpc verdict without
        Relay, so the next forward asks again."""
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
            offer = tx.build_offer()
            try:
                reply = await call(pb.MessageRequest(
                    sender_id=HELLO_SENDER, message_text=json.dumps(offer)),
                    timeout=10.0)
            except grpc.aio.AioRpcError as e:
                return tx.Negotiated("grpc", tx.GrpcSender(),
                                     reason=f"hello failed: {e.code()}")
            self._negotiated = tx.conclude(offer, reply.confirmation_text)
            return self._negotiated

    async def _forward(self, request_id: str, y, *, retries: int = 2,
                       backoff: float = 0.2,
                       inbound_budget: Optional[float] = None):
        """Send y downstream. One budget covers every attempt and backoff
        sleep: PER_STAGE_BUDGET_S per remaining stage, capped by what the
        sender still had; each attempt's deadline (and its dl= tag) is
        what is left of it."""
        timeout = PER_STAGE_BUDGET_S * max(
            self.config.num_parts - self.part_index - 1, 1)
        if inbound_budget is not None:
            timeout = max(min(timeout, inbound_budget), 0.001)
        call = self._channel().unary_unary(
            f"/{SERVICE_NAME}/SendTensor",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        request = wc.TensorRequest(request_id=request_id,
                                   tensor=wc.make_tensor(y))
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            request.request_id = tag_deadline(request_id, remaining)
            try:
                return await call(request, timeout=max(remaining, 0.001))
            except grpc.RpcError as e:
                worst = backoff * (2 ** attempt)
                if (e.code() not in RETRYABLE_CODES or attempt >= retries
                        or deadline - time.monotonic() <= worst):
                    raise
                delay = full_jitter_delay(backoff, attempt)
                log.warning("forward %s -> %s failed (%s), retry %d/%d in "
                            "%.2fs", self.node.id, self.next_address,
                            e.code(), attempt + 1, retries, delay)
                await asyncio.sleep(delay)
                attempt += 1

    async def close(self):
        if self._next_channel is not None:
            await self._next_channel.close()
            self._next_channel = None


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
    log.info("gRPC stage server %s listening on [::]:%d (part %d)", node_id,
             bind_port, servicer.part_index)
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
                      transport: Optional[str] = None) -> int:
    """Serve this node's stage until termination; SIGTERM stops it
    cleanly (rc 0)."""
    servicer, server = await _start_stage(engine, node_id, port, transport)
    try:
        return await serve_until_terminated(server)
    finally:
        await servicer.close()


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
