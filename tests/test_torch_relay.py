"""The streamed Relay RPC and its framing, the port against the JAX
package: chunked frames byte-identical to JAX's and reassembled across
packages, `send_tensors` through 3-stage chains of either package's
stages (payloads above CHUNK_BYTES, crc32c verified at every hop), the
unary fallback for a peer without Relay, and a corrupt frame answered as
that item's error.

Results are compared bit for bit with per-item unary `send_tensor`
through the same chain (the same stages on the same CPU)."""

import concurrent.futures
import contextlib
import json
import socket
import threading

import grpc
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dnn_tpu.native as jnative
from dnn_tpu.comm import transport as jtx
from dnn_tpu.comm import wirecodec as jwc
from dnn_tpu.comm.client import NodeClient as JaxClient
from dnn_tpu.comm.service import (
    start_stage_server_in_background as jax_start_stage,
)
from dnn_tpu.config import TopologyConfig as JaxConfig
from dnn_tpu.runtime.engine import PipelineEngine as JaxEngine
from dnn_tpu_torch.comm import service
from dnn_tpu_torch.comm import transport as tx
from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.config import TopologyConfig
from dnn_tpu_torch.registry import get_model
from dnn_tpu_torch.runtime.engine import PipelineEngine

# mlp (784 -> 512 -> 256 -> 10) in 3 stages at B=2048: the hops carry
# 6.4, 4.2 and 2.1 MB, all above CHUNK_BYTES; the results are 80 kB
BATCH = 2048
HOP_BYTES = (BATCH * 784 * 4, BATCH * 512 * 4, BATCH * 256 * 4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raw(n=3):
    return {"nodes": [{"id": f"node{i + 1}", "part_index": i,
                       "address": f"127.0.0.1:{_free_port()}"}
                      for i in range(n)],
            "model": "mlp", "num_parts": n, "device_type": "cpu",
            "runtime": "relay"}


@pytest.fixture(scope="module")
def params():
    return get_model("mlp").init(5)


def _inputs(n=3):
    return [np.random.default_rng(i).standard_normal(
        (BATCH, 784)).astype(np.float32) for i in range(n)]


@contextlib.contextmanager
def _chain(raw, params, kinds):
    """One stage server per part, "torch" or "jax"; yields the servicers
    of the torch stages by node id."""
    stops, servicers = [], {}
    try:
        for i, kind in enumerate(kinds):
            node = f"node{i + 1}"
            if kind == "torch":
                eng = PipelineEngine(TopologyConfig.from_dict(raw),
                                     params=params, role="stage")
                _, stop = service.start_stage_server_in_background(eng, node)
                servicers[node] = stop.servicer
            else:
                eng = JaxEngine(JaxConfig.from_dict(raw), role="stage",
                                params=jax.tree.map(jnp.asarray, params))
                _, stop = jax_start_stage(eng, node)
            stops.append(stop)
        yield servicers
    finally:
        for stop in stops:
            stop()


def _frames_bytes(frames, serialize):
    return [serialize(f) for f in frames]


def test_split_requests_serialize_like_jax():
    """A 3.5 MB checksummed payload splits into the same frames, byte for
    byte, in both packages."""
    x = np.random.default_rng(0).standard_normal((896, 1024)).astype(
        np.float32)  # 3.5 MiB
    mine = tx.split_requests(wc.TensorRequest("r7", wc.make_tensor(x)), 3)
    theirs = jtx.split_requests(jwc.TensorRequest("r7", jwc.make_tensor(x)),
                                3)
    assert len(mine) == len(theirs) == 4
    assert mine[0].tensor.crc32c == theirs[0].tensor.crc32c is not None
    assert (_frames_bytes(mine, wc.serialize_request)
            == _frames_bytes(theirs, jwc.serialize_request))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_chunk_assembler_takes_the_other_packages_frames(writer):
    """Each side's ChunkAssembler reassembles the other's frames (over a
    wire round trip each) into the payload, and its checksum verifies
    after reassembly."""
    x = np.random.default_rng(1).standard_normal((600, 1024)).astype(
        np.float32)
    if writer == "torch":
        frames = tx.split_requests(wc.TensorRequest("r", wc.make_tensor(x)),
                                   5)
        wire = [jwc.parse_request(wc.serialize_request(f)) for f in frames]
        asm, view = jtx.ChunkAssembler(), jwc.tensor_view
    else:
        frames = jtx.split_requests(
            jwc.TensorRequest("r", jwc.make_tensor(x)), 5)
        wire = [wc.parse_request(jwc.serialize_request(f)) for f in frames]
        asm, view = tx.ChunkAssembler(), wc.tensor_view
    assert len(frames) == 3
    done = [asm.add(f) for f in wire]
    assert done[:2] == [None, None]
    base, seq, tensor = done[2]
    assert (base, seq) == ("r", 5) and tensor.crc32c is not None
    np.testing.assert_array_equal(view(tensor), x)


def test_out_of_order_chunk_fails_loud():
    frames = tx.split_requests(wc.TensorRequest(
        "r", wc.make_tensor(np.zeros(900 * 1024, np.float32))), 0)
    assert len(frames) >= 3
    asm = tx.ChunkAssembler()
    assert asm.add(frames[0]) is None
    with pytest.raises(tx.TransportError, match="out of order"):
        asm.add(frames[2])
    with pytest.raises(tx.TransportError):
        tx.ChunkAssembler().add(frames[1])  # no chunk 0


def test_framing_helpers_agree_with_jax():
    for rid in ("req:s=3", "gen:4:dl=1.500", "a:s=2:c=1/4:dl=3.000", ""):
        assert tx.parse_seq(rid) == jtx.parse_seq(rid)
        assert tx.extract_deadline(rid) == jtx.extract_deadline(rid)
        assert tx.strip_deadline(rid) == jtx.strip_deadline(rid)
        assert tx.tag_deadline(rid, 2.5) == jtx.tag_deadline(rid, 2.5)
    assert tx.tag_seq("r", 4, (1, 3)) == jtx.tag_seq("r", 4, (1, 3))
    for status in (tx.ack_status(7), tx.result_status(3, "[n2] ok: 1"),
                   "[n1] plain", "res:x:y", "ack:z"):
        assert tx.parse_ack(status) == jtx.parse_ack(status)
        assert tx.parse_result(status) == jtx.parse_result(status)
    assert tx.CHUNK_BYTES == jtx.CHUNK_BYTES


def test_hello_keeps_relay_on_the_grpc_rung_both_ways():
    """A port stage declines every rung with "relay": true, so a JAX
    client concludes grpc + Relay; the port's offer wants no rung, a JAX
    server declines it with Relay; a non-JSON reply leaves Relay off."""
    offer, probe = jtx.build_offer("auto")
    try:
        neg = jtx.conclude(offer, tx.answer_hello(json.dumps(offer)),
                           transport="auto")
    finally:
        jtx.close_probe(probe)
    assert (neg.name, neg.relay_ok, neg.relay_known) == ("grpc", True, True)
    mine = tx.build_offer()
    neg = tx.conclude(mine, jtx.answer_hello(json.dumps(mine)))
    assert (neg.name, neg.relay_ok, neg.relay_known) == ("grpc", True, True)
    neg = tx.conclude(mine, "[node2] got msg 'hello'")
    assert (neg.relay_ok, neg.relay_known) == (False, True)
    assert "not transport-aware" in neg.reason
    assert json.loads(tx.answer_hello("not json")) == {
        "v": 1, "ok": False, "reason": "bad offer"}


@pytest.fixture
def crc_sizes(monkeypatch):
    """The payload sizes each package checksums while the test runs."""
    seen = {"torch": [], "jax": []}
    lock = threading.Lock()

    def spy(fn, key):
        def wrapped(data, *a, **k):
            with lock:
                seen[key].append(memoryview(data).nbytes)
            return fn(data, *a, **k)
        return wrapped

    monkeypatch.setattr(wc, "crc32c", spy(wc.crc32c, "torch"))
    monkeypatch.setattr(jnative, "crc32c", spy(jnative.crc32c, "jax"))
    return seen


@pytest.mark.parametrize("client,kinds", [
    ("torch", ("torch", "torch", "torch")),
    ("jax", ("torch", "torch", "torch")),
    ("torch", ("jax", "jax", "jax")),
    ("torch", ("jax", "torch", "jax")),
], ids=["torch->torch", "jax_client->torch", "torch_client->jax",
        "jax->torch->jax"])
def test_send_tensors_equals_send_tensor_across_packages(params, client,
                                                         kinds, crc_sizes):
    """send_tensors of 3 microbatches over Relay equals per-item unary
    send_tensor through the same chain bit for bit; every hop's chunked,
    checksummed payload is verified by the receiving package."""
    raw = _raw()
    xs = _inputs()
    with _chain(raw, params, kinds) as servicers:
        addr = raw["nodes"][0]["address"]
        if client == "jax":
            c = JaxClient(addr)
            streamed = [(s, np.asarray(y)) for s, y in
                        c.send_tensors(xs, timeout=60)]
            unary = [np.asarray(c.send_tensor(x, timeout=60)[1]) for x in xs]
            relay_ok = c._ensure_negotiated().relay_ok
        else:
            c = NodeClient(addr)
            assert c.wait_healthy(deadline=30)
            acks = []
            streamed = [(s, y.numpy()) for s, y in
                        c.send_tensors(xs, timeout=60, ack_s=acks)]
            unary = [c.send_tensor(x, timeout=60)[1].numpy() for x in xs]
            relay_ok = c.negotiated().relay_ok
            assert len(acks) == len(xs)
            assert all(a is not None and a >= 0 for a in acks)
        c.close()
        for s in servicers.values():
            if s.next_address is not None:
                assert s._negotiated is not None and s._negotiated.relay_ok
    assert relay_ok
    for (status, y), want in zip(streamed, unary):
        assert "Processing complete" in status, status
        assert y.shape == (BATCH, 10)
        np.testing.assert_array_equal(y, want)
    # every hop on the wire is checked by its receiver: a payload written
    # by one package and checksummed by the other proves the verification
    # (two JAX stages in one process hand activations over on the device
    # rung, with no payload on the wire)
    for i, (sender, receiver) in enumerate(zip((client,) + kinds[:-1],
                                               kinds)):
        if sender != receiver or receiver == "torch":
            assert HOP_BYTES[i] in crc_sizes[receiver], (i, crc_sizes)


class _ReferencePeer:
    """A peer that knows no transport: SendMessage answers plain text,
    and it has no Relay (the reference's own servicer)."""

    def __init__(self, engine, part_index, node_id):
        self.engine, self.part, self.node_id = engine, part_index, node_id

    def SendTensor(self, request, context):  # noqa: N802
        y = self.engine.run_stage(self.part, wc.tensor_torch(request.tensor))
        pred = int(torch.argmax(y.flatten()))
        return wc.TensorResponse(
            status=f"[{self.node_id}] Processing complete. Prediction: "
                   f"{pred}", result_tensor=wc.make_tensor(y))

    def HealthCheck(self, request, context):  # noqa: N802
        return pb.HealthCheckResponse(is_healthy=True)

    def SendMessage(self, request, context):  # noqa: N802
        return pb.MessageReply(
            confirmation_text=f"[{self.node_id}] got msg "
                              f"'{request.message_text}'")


@contextlib.contextmanager
def _reference_peer(raw, params, node_index, kind=_ReferencePeer):
    node = raw["nodes"][node_index]
    eng = PipelineEngine(TopologyConfig.from_dict(raw), params=params,
                         role="stage")
    server = grpc.server(concurrent.futures.ThreadPoolExecutor(4),
                         options=service.GRPC_MSG_OPTIONS)
    server.add_generic_rpc_handlers((service._handlers(
        kind(eng, node_index, node["id"])),))
    server.add_insecure_port(node["address"])
    server.start()
    try:
        yield
    finally:
        server.stop(grace=0.2).wait()


class _BusyReferencePeer(_ReferencePeer):
    """A reference peer whose SendMessage answers UNAVAILABLE: the hello
    fails, so a client learns of Relay only by trying it."""

    def SendMessage(self, request, context):  # noqa: N802
        context.abort(grpc.StatusCode.UNAVAILABLE, "busy")


def test_peer_without_relay_gets_the_unary_fallback(params):
    """Stage 1 (the port) forwards to a reference peer whose hello reply
    is not JSON: it concludes no Relay and forwards each item over unary
    SendTensor. A client facing the peer directly falls back to unary
    send_tensor: from the hello's reply, and, when the hello fails, from
    the Relay call's UNIMPLEMENTED."""
    raw = _raw(2)
    xs = _inputs(2)
    with _reference_peer(raw, params, 1), \
            _chain(raw, params, ("torch",)) as servicers:
        c = NodeClient(raw["nodes"][0]["address"])
        assert c.wait_healthy(deadline=30)
        streamed = c.send_tensors(xs, timeout=60)
        unary = [c.send_tensor(x, timeout=60)[1] for x in xs]
        c.close()
        neg = servicers["node1"]._negotiated
        assert (neg.relay_ok, neg.relay_known) == (False, True)
        for (status, y), want in zip(streamed, unary):
            assert status.startswith("[node1] Forwarded. Next node status: "
                                     "[node2] Processing complete"), status
            assert torch.equal(y, want)
        peer = raw["nodes"][1]["address"]
        acts = [PipelineEngine(TopologyConfig.from_dict(raw), params=params,
                               role="stage").run_stage(0, torch.from_numpy(x))
                for x in xs]
        direct = NodeClient(peer)
        acks = []
        direct_out = direct.send_tensors(acts, timeout=60, ack_s=acks)
        assert direct.negotiated().relay_ok is False
        assert acks == [None, None]
        direct.close()
    busy_raw = _raw(2)
    with _reference_peer(busy_raw, params, 1, _BusyReferencePeer):
        blind = NodeClient(busy_raw["nodes"][1]["address"])
        blind_out = blind.send_tensors(acts, timeout=60)
        assert blind.negotiated().relay_known is False
        blind.close()
    for (s1, y1), (s2, y2), (_, want) in zip(direct_out, blind_out, streamed):
        assert "Processing complete" in s1 and "Processing complete" in s2
        assert torch.equal(y1, want) and torch.equal(y2, want)


def test_corrupt_frame_is_that_items_error(params):
    """Three microbatches into the last stage over a raw Relay stream,
    the second with a wrong crc32c: every item is acked, the second
    answers with its own error status, the others with their results."""
    raw = _raw(1)
    with _chain(raw, params, ("torch",)):
        channel = grpc.insecure_channel(raw["nodes"][0]["address"],
                                        options=service.GRPC_MSG_OPTIONS)
        call = channel.stream_stream(
            f"/{service.SERVICE_NAME}/Relay",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)
        frames = []
        for seq, x in enumerate(_inputs()):
            req = wc.TensorRequest("r", wc.make_tensor(x))
            if seq == 1:
                req.tensor.crc32c ^= 1
            frames += tx.split_requests(req, seq)
        resps = list(call(iter(frames), timeout=60))
        channel.close()
    acks = sorted(tx.parse_ack(r.status) for r in resps
                  if tx.parse_ack(r.status) is not None)
    results = {tx.parse_result(r.status)[0]: r for r in resps
               if tx.parse_ack(r.status) is None}
    assert acks == [0, 1, 2] and sorted(results) == [0, 1, 2]
    assert "payload corrupt" in results[1].status
    assert not results[1].HasField("result_tensor")
    for seq in (0, 2):
        assert "Processing complete" in results[seq].status
        assert wc.tensor_torch(results[seq].result_tensor).shape == (
            BATCH, 10)


def test_relay_stream_ends_with_the_client_and_frees_the_stage(params):
    """A client that abandons its stream mid-way leaves the stage
    serving: the next send_tensors through it completes."""
    raw = _raw(2)
    xs = _inputs(2)
    with _chain(raw, params, ("torch", "torch")):
        channel = grpc.insecure_channel(raw["nodes"][0]["address"],
                                        options=service.GRPC_MSG_OPTIONS)
        call = channel.stream_stream(
            f"/{service.SERVICE_NAME}/Relay",
            request_serializer=wc.serialize_request,
            response_deserializer=wc.parse_response)

        def endless():
            seq = 0
            while True:
                yield from tx.split_requests(
                    wc.TensorRequest("r", wc.make_tensor(xs[0])), seq)
                seq += 1

        stream = call(endless(), timeout=60)
        assert tx.parse_ack(next(stream).status) == 0
        stream.cancel()
        channel.close()
        c = NodeClient(raw["nodes"][0]["address"])
        out = c.send_tensors(xs, timeout=60)
        c.close()
    assert [o[1].shape for o in out] == [(BATCH, 10)] * 2


def test_event_loop_is_not_blocked_by_a_full_accept_window(params):
    """Backpressure is the accept window, not the loop: with a stage's
    compute held, a stream fills ACCEPT_WINDOW acks and the server still
    answers HealthCheck on the same loop."""
    raw = _raw(1)
    gate = threading.Event()
    with _chain(raw, params, ("torch",)) as servicers:
        servicer = servicers["node1"]
        compute = servicer._compute_stage

        def held(x):
            gate.wait(timeout=30)
            return compute(x)

        servicer._compute_stage = held
        c = NodeClient(raw["nodes"][0]["address"])
        assert c.wait_healthy(deadline=30)
        out, acks = {}, []
        t = threading.Thread(target=lambda: out.setdefault(
            "r", c.send_tensors(_inputs(6), timeout=60, ack_s=acks)))
        t.start()
        try:
            for _ in range(100):
                if sum(a is not None for a in acks) >= \
                        servicer.ACCEPT_WINDOW:
                    break
                threading.Event().wait(0.05)
            assert c.health_check(timeout=5)
        finally:
            gate.set()
            t.join(timeout=60)
        assert not t.is_alive()
        c.close()
    assert len(out["r"]) == 6


def test_a_downstream_that_is_down_fails_each_item_not_the_stream(params):
    """Stage 1 of 2 with nothing listening at stage 2: the hello fails
    (no Relay verdict is kept), the unary forward fails after its
    retries, and each item comes back with stage 1's error status."""
    raw = _raw(2)
    with _chain(raw, params, ("torch",)) as servicers:
        c = NodeClient(raw["nodes"][0]["address"])
        assert c.wait_healthy(deadline=30)
        out = c.send_tensors(_inputs(2), timeout=60)
        c.close()
        assert servicers["node1"]._negotiated is None
    for status, y in out:
        assert status.startswith("[node1] Error: "), status
        assert y is None
