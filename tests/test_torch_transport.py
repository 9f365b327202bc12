"""The transport ladder of the port (comm/transport.py) against the JAX
package's on the CPU, and the stage server's spans, metrics and chaos
seams against JAX's for the same request.

- the ladder: two port peers of one process settle on device (the
  mailbox ticket resolves to the sender's own tensor); a JAX peer and a
  port peer of one process settle on shm both ways (each package has its
  own PROC_TOKEN) and read each other's shm tickets (f32 and bf16
  payloads, the ticket meta JSON keyed as JAX's); a reference peer's
  reply concludes grpc with a `transport_fallback` flight event; an
  explicit rung the peer does not grant raises TransportMisconfigError
  with JAX's message; the shm probe's nonce is verified (a mismatch and
  an unreachable probe answer JAX's declines); hop_budget_s is JAX's
  arithmetic;
- one real two-process shm hop (a child interpreter answers the hello and
  resolves the ticket), with a timeout of its own;
- a tr= request through two port stage servers and through two JAX stage
  servers: the same span tree (rpc.SendTensor -> stage.request ->
  stage.compute, rpc.forward -> stage.request -> ...), the same metric
  families, and the stage seam's chaos delay recorded as a chaos_inject
  event by both; the Relay seam's corruption raises in both assemblers.

Payload equality is exact (the rungs move bytes)."""

import json
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_tpu import obs as jobs
from dnn_tpu.chaos import inject as jinject
from dnn_tpu.chaos.plan import FaultPlan as JaxPlan
from dnn_tpu.comm import transport as jtx
from dnn_tpu.comm import wirecodec as jwc
from dnn_tpu.comm.client import NodeClient as JaxClient
from dnn_tpu.comm.service import (
    start_stage_server_in_background as jax_start_stage,
)
from dnn_tpu.config import TopologyConfig as JaxConfig
from dnn_tpu.runtime.engine import PipelineEngine as JaxEngine
from dnn_tpu_torch import obs
from dnn_tpu_torch.chaos import inject
from dnn_tpu_torch.chaos.plan import FaultPlan
from dnn_tpu_torch.comm import transport as tx
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.comm.service import start_stage_servers_in_background
from dnn_tpu_torch.config import TopologyConfig
from dnn_tpu_torch.registry import get_model
from dnn_tpu_torch.runtime.engine import PipelineEngine
from dnn_tpu_torch.utils.metrics import default_metrics

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse
from test_torch_stage_server import ROOT, _free_port, _raw  # noqa: E402


def _hello(offer, answer):
    return answer(json.dumps(offer))


def test_ladder_same_process_settles_on_device():
    """Port to port in one process: device; the ticket resolves to the
    sender's own tensor (no copy), and sent_ok drops the mailbox entry."""
    offer, probe = tx.build_offer("auto")
    try:
        neg = tx.conclude(offer, _hello(offer, tx.answer_hello),
                          transport="auto", target="peer")
    finally:
        tx.close_probe(probe)
    assert (neg.name, neg.relay_ok) == ("device", True)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    before = len(tx.MAILBOX)
    req = neg.sender.make_request(x, "r1")
    assert req.tensor.dtype == tx.TICKET_DTYPE_DEV
    assert tx.split_requests(req, 0)[0].tensor is req.tensor  # never chunked
    got = tx.TransportHost().resolve(req.tensor)
    assert got is x or got.data_ptr() == x.data_ptr()
    neg.sender.sent_ok(req)
    assert len(tx.MAILBOX) == before
    with pytest.raises(tx.TransportError, match="not in this process"):
        tx.TransportHost().resolve(req.tensor)
    hop = tx.make_hop_program(["cpu", "cpu"])
    assert torch.equal(hop(0, x), x)


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_cross_package_in_one_process_settles_on_shm(direction):
    """A JAX peer and a port peer of one process: shm both ways (the
    device rung never crosses packages), and each package reads the
    other's shm tickets, whose meta is keyed as JAX's."""
    if direction == "jax->torch":
        offer, probe = jtx.build_offer("auto")
        reply = tx.answer_hello(json.dumps(offer))
        conclude, host = jtx.conclude, tx.TransportHost()
    else:
        offer, probe = tx.build_offer("auto")
        reply = jtx.answer_hello(json.dumps(offer))
        conclude, host = tx.conclude, jtx.TransportHost()
    try:
        neg = conclude(offer, reply, transport="auto", target="peer")
    finally:
        tx.close_probe(probe)
    assert (neg.name, neg.relay_ok) == ("shm", True)
    x = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    payloads = [x, jnp.asarray(x, jnp.bfloat16)] if direction == \
        "jax->torch" else [torch.from_numpy(x),
                           torch.from_numpy(x).to(torch.bfloat16)]
    try:
        for arr in payloads:
            req = neg.sender.make_request(arr, "r")
            meta = json.loads(bytes(req.tensor.tensor_data))
            assert sorted(meta) == ["dtype", "nbytes", "seg", "shape",
                                    "slot"]
            got = host.resolve(req.tensor)
            bf16 = meta["dtype"] == "bfloat16"
            if direction == "jax->torch":
                want = torch.from_numpy(x)
                assert torch.equal(got, want.to(torch.bfloat16)
                                   if bf16 else want)
            else:
                got = np.asarray(got).astype(np.float32)
                want = torch.from_numpy(x)
                want = (want.to(torch.bfloat16) if bf16 else want).float()
                np.testing.assert_array_equal(got, want.numpy())
            neg.sender.sent_ok(req)
    finally:
        neg.sender.close()
        host.close()


def test_reference_reply_falls_back_to_grpc_with_a_flight_event():
    """A reply that is not JSON (a reference peer) concludes grpc without
    Relay and records transport_fallback, as JAX does; an explicit rung
    raises TransportMisconfigError with JAX's message."""
    t0 = time.time()
    for mod, flight in ((tx, obs.flight), (jtx, jobs.flight)):
        offer, probe = mod.build_offer("auto")
        try:
            neg = mod.conclude(offer, "[node2] got msg 'hi'",
                               transport="auto", target="peer:1")
        finally:
            mod.close_probe(probe)
        assert (neg.name, neg.relay_ok, neg.relay_known) == \
            ("grpc", False, True)
        events = [e for e in flight.recorder().events(
            kind="transport_fallback") if e["ts"] >= t0 - 1]
        assert events and events[-1]["target"] == "peer:1"
    msgs = []
    for mod in (tx, jtx):
        for rung in ("device", "shm"):
            offer, probe = mod.build_offer(rung)
            try:
                with pytest.raises(mod.TransportMisconfigError) as err:
                    mod.conclude(offer, json.dumps(
                        {"v": 1, "ok": False, "relay": True,
                         "reason": "no common transport"}),
                        transport=rung, target="peer:1")
            finally:
                mod.close_probe(probe)
            msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]
    assert "transport='device' to peer:1 refused" in msgs[0]
    with pytest.raises(ValueError, match="transport must be one of"):
        tx.negotiate_over(lambda s, t: "", transport="carrier-pigeon")


def test_shm_probe_nonce_is_verified_as_in_jax():
    """The server reads the nonce out of the client's probe segment: a
    probe holding another nonce, and a probe that does not exist, are
    declined with JAX's replies; bad JSON is a bad offer."""
    offer, probe = tx.build_offer("shm")
    try:
        assert offer["want"] == ["shm"] and offer["shm_probe"] == probe.name
        forged = dict(offer, nonce="f" * 32)
        for o in (forged, dict(offer, shm_probe="dnn_tpu_probe_gone")):
            assert json.loads(tx.answer_hello(json.dumps(o))) == \
                json.loads(jtx.answer_hello(json.dumps(o)))
        assert "nonce mismatch" in tx.answer_hello(json.dumps(forged))
        ok = json.loads(tx.answer_hello(json.dumps(offer)))
        assert (ok["ok"], ok["chosen"], ok["nonce"]) == \
            (True, "shm", offer["nonce"])
        assert json.loads(tx.answer_hello(json.dumps(offer), allow=())) \
            == {"v": 1, "ok": False, "relay": True,
                "reason": "no common transport"}
    finally:
        tx.close_probe(probe)
    assert tx.answer_hello("{") == jtx.answer_hello("{")


def test_hop_budget_is_jax_arithmetic():
    for rung in ("grpc", "shm", "device", "carrier-pigeon"):
        for n in (0, 1, 3, 7):
            for warm in (False, True):
                assert tx.hop_budget_s(rung, n, warm=warm) == \
                    jtx.hop_budget_s(rung, n, warm=warm)
    assert tx.PER_STAGE_BUDGET_S == jtx.PER_STAGE_BUDGET_S == 30.0
    assert tx.TRANSPORTS == jtx.TRANSPORTS


CHILD = textwrap.dedent("""
    import json, sys
    from dnn_tpu_torch.comm import transport as tx
    from dnn_tpu_torch.comm import wirecodec as wc
    print(tx.answer_hello(sys.stdin.readline()), flush=True)
    host = tx.TransportHost()
    meta = sys.stdin.readline().strip()
    t = host.resolve(wc.Tensor(tensor_data=meta.encode(), shape=(),
                               dtype=tx.TICKET_DTYPE_SHM))
    print(json.dumps({"shape": list(t.shape), "dtype": str(t.dtype),
                      "values": t.float().flatten().tolist()}), flush=True)
    host.close()
""")


def test_two_process_shm_hop():
    """A child interpreter proves the shm rung (it attaches the probe and
    echoes the nonce), then resolves the parent's shm ticket: the payload
    it read equals the parent's tensor."""
    offer, probe = tx.build_offer("shm")
    child = subprocess.Popen([sys.executable, "-c", CHILD], cwd=ROOT,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        child.stdin.write(json.dumps(offer) + "\n")
        child.stdin.flush()
        reply = child.stdout.readline()
        neg = tx.conclude(offer, reply, transport="shm", target="child")
        assert neg.name == "shm"
        x = torch.linspace(-2, 2, 24).reshape(2, 3, 4).to(torch.bfloat16)
        req = neg.sender.make_request(x, "r")
        child.stdin.write(bytes(req.tensor.tensor_data).decode() + "\n")
        child.stdin.flush()
        out, err = child.communicate(timeout=60)
        got = json.loads(out.strip().splitlines()[-1])
        assert got["shape"] == [2, 3, 4] and got["dtype"] == "torch.bfloat16"
        assert got["values"] == x.float().flatten().tolist()
        neg.sender.close()
    finally:
        tx.close_probe(probe)
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)


DELAY_PLAN = {"seed": 0, "faults": [{"kind": "rpc_delay", "seam": "stage",
                                     "p": 1.0, "count": 1,
                                     "delay_s": 0.01}]}


def _tree(collector_spans, trace_id):
    """{span name: parent span's name} of one trace (roots map to None)."""
    spans = [s if isinstance(s, dict) else s.to_dict()
             for s in collector_spans]
    spans = [s for s in spans if s["trace_id"] == trace_id]
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s.get("parent_id"))) for s in spans)


@pytest.fixture(scope="module")
def cifar_chain():
    params = get_model("cifar_cnn").init(2)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    return params, x


def test_stage_spans_metrics_and_stage_seam_match_jax(cifar_chain):
    """One tr= request through two port stage servers of one process (the
    device rung between them) and through two JAX stage servers: the
    same span tree per trace, one stage.request per stage, the metric
    families JAX's servers and clients observe (by method and mode), and
    the stage seam's delay as a chaos_inject event in both flight
    rings."""
    params, x = cifar_chain
    raw = _raw("cifar_cnn", 2)
    trees, families = {}, {}
    for kind in ("torch", "jax"):
        r = {**raw, "nodes": [dict(n, address=f"127.0.0.1:{_free_port()}")
                              for n in raw["nodes"]]}
        if kind == "torch":
            inject.install(FaultPlan.from_dict(DELAY_PLAN))
            _, stop = start_stage_servers_in_background([
                (PipelineEngine(TopologyConfig.from_dict(r), params=params,
                                role="stage"), n["id"], None)
                for n in r["nodes"]])
            stops, client = [stop], NodeClient(r["nodes"][0]["address"])
            span_mod, collect, reg, flight = (
                obs, obs.trace.collector(), default_metrics, obs.flight)
        else:
            jinject.install(JaxPlan.from_dict(DELAY_PLAN))
            jp = jax.tree.map(jnp.asarray, params)
            stops = [jax_start_stage(JaxEngine(
                JaxConfig.from_dict(r), params=jp, role="stage"),
                n["id"])[1] for n in reversed(r["nodes"])]
            client = JaxClient(r["nodes"][0]["address"])
            from dnn_tpu.utils.metrics import default_metrics as jreg

            span_mod, collect, reg, flight = (
                jobs, jobs.trace.collector(), jreg, jobs.flight)
        t0 = time.time()
        try:
            with span_mod.span("test.request") as root:
                status, y = client.send_tensor(x, timeout=60)
            assert "Processing complete" in status, status
        finally:
            client.close()
            for stop in stops:
                stop()
            (inject if kind == "torch" else jinject).uninstall()
        trees[kind] = _tree(collect.spans(), root.trace_id)
        snap = reg.snapshot()
        keys = [k for part in ("histogram", "latency", "counters")
                for k in snap.get(part, {})]
        families[kind] = {k.split("{")[0] + (
            "{" + ",".join(p for p in k.split("{", 1)[1].rstrip("}")
                           .split(",") if p.startswith(("method=", "mode=",
                                                        "direction=")))
            + "}" if "{" in k else "")
            for k in keys if k.startswith("comm.")}
        fired = [e for e in flight.recorder().events(kind="chaos_inject")
                 if e["ts"] >= t0 and e.get("fault") == "rpc_delay"]
        assert [e["seam"] for e in fired] == ["stage"], (kind, fired)
    assert trees["torch"] == trees["jax"], trees
    assert [n for n, _ in trees["torch"]].count("stage.request") == 2
    want = {"comm.rpc_latency_seconds{method=SendTensor}",
            "comm.rpc_latency_seconds{method=forward}",
            "comm.hop_seconds{mode=nested}",
            "comm.payload_bytes_total{direction=in}",
            "comm.payload_bytes_total{direction=out}"}
    for kind in ("torch", "jax"):
        got = {f.replace('"', "") for f in families[kind]}
        assert want <= got, (kind, sorted(got))


def test_relay_seam_fires_in_both_assemblers():
    """perturb_relay() runs for every Relay frame: a relay_corrupt plan
    makes both packages' assemblers raise on the first frame, a
    relay_drop plan makes them drop it."""
    frame = wc.TensorRequest(request_id="r:s=0",
                             tensor=wc.make_tensor(np.zeros(4, np.float32)))
    jframe = jwc.TensorRequest(request_id="r:s=0",
                               tensor=jwc.make_tensor(np.zeros(4,
                                                               np.float32)))
    for kind in ("relay_corrupt", "relay_drop"):
        plan = {"seed": 0, "faults": [{"kind": kind, "p": 1.0, "count": 1}]}
        inject.install(FaultPlan.from_dict(plan))
        jinject.install(JaxPlan.from_dict(plan))
        try:
            if kind == "relay_corrupt":
                with pytest.raises(wc.PayloadCorruptError):
                    tx.ChunkAssembler().add(frame)
                with pytest.raises(ValueError):
                    jtx.ChunkAssembler().add(jframe)
            else:
                assert tx.ChunkAssembler().add(frame) is None
                assert jtx.ChunkAssembler().add(jframe) is None
            assert tx.ChunkAssembler().add(frame) is not None  # count 1
        finally:
            inject.uninstall()
            jinject.uninstall()
