"""The port's gRPC stage servers on the CPU: a torch pipeline, mixed
JAX <-> torch pipelines over the shared wire, the bf16 wire payload, a
corrupt payload, the transport hello, and the node CLI as processes.

Tolerances: cifar probabilities within 1e-5 of the JAX engine's (two
frameworks' f32 convolutions); gpt2-test logits through a bf16 hop
within 2e-2 x max |logit| (bf16 compute in both packages). Predictions
and greedy tokens must be identical."""

import contextlib
import json
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time

import grpc
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.comm import wirecodec as jwc
from dnn_tpu.comm.client import NodeClient as JaxClient
from dnn_tpu.comm.service import (
    start_stage_server_in_background as jax_start_stage,
)
from dnn_tpu.config import TopologyConfig as JaxConfig
from dnn_tpu.runtime.engine import PipelineEngine as JaxEngine
from dnn_tpu_torch.comm import wire_pb2 as pb
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.comm.client import NodeClient, pipeline_budget
from dnn_tpu_torch.comm.service import (
    HELLO_SENDER,
    SERVICE_NAME,
    start_stage_server_in_background,
)
from dnn_tpu_torch.config import TopologyConfig
from dnn_tpu_torch.io import checkpoint as ckpt
from dnn_tpu_torch.io.preprocess import dummy_image
from dnn_tpu_torch.registry import get_model
from dnn_tpu_torch.runtime.engine import PipelineEngine

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_TOL = 1e-5
BF16_REL = 2e-2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raw(model, n, **kw):
    return {"nodes": [{"id": f"node{i + 1}", "part_index": i,
                       "address": f"127.0.0.1:{_free_port()}"}
                      for i in range(n)],
            "model": model, "num_parts": n, "device_type": "cpu",
            "runtime": "relay", **kw}


@pytest.fixture(scope="module")
def cifar():
    params = get_model("cifar_cnn").init(11)
    x = dummy_image()
    jeng = JaxEngine(JaxConfig.from_dict(_raw("cifar_cnn", 2)),
                     params=jax.tree.map(jnp.asarray, params))
    probs = np.asarray(jeng.run(jnp.asarray(x)))
    return params, x, probs, jeng.predict(jnp.asarray(x))


@contextlib.contextmanager
def _pipeline(raw, params, kinds):
    """Stage servers of `raw`, one per part: "torch" or "jax"."""
    stops = []
    try:
        for i, kind in enumerate(kinds):
            node = f"node{i + 1}"
            if kind == "torch":
                eng = PipelineEngine(TopologyConfig.from_dict(raw),
                                     params=params, role="stage")
                _, stop = start_stage_server_in_background(eng, node)
            else:
                eng = JaxEngine(JaxConfig.from_dict(raw), role="stage",
                                params=jax.tree.map(jnp.asarray, params))
                _, stop = jax_start_stage(eng, node)
            stops.append(stop)
        yield raw["nodes"][0]["address"]
    finally:
        for stop in stops:
            stop()


def _prediction(status):
    return int(re.search(r"Prediction: (\d+)", status).group(1))


@pytest.mark.parametrize("kinds", [("torch", "torch"), ("jax", "torch"),
                                   ("torch", "jax")],
                         ids=lambda k: "->".join(k))
def test_cifar_relay_over_grpc_matches_jax(cifar, kinds):
    """Two stages on localhost, any mix of packages: the prediction in
    the status and the returned probabilities equal the JAX engine's."""
    params, x, probs, pred = cifar
    raw = _raw("cifar_cnn", 2)
    with _pipeline(raw, params, kinds) as addr:
        if kinds[0] == "jax":
            client = JaxClient(addr)
            status, out = client.send_tensor(x, timeout=60)
            out = np.asarray(out)
        else:
            client = NodeClient(addr)
            assert client.wait_healthy(deadline=30)
            status, out = client.send_tensor(
                x, timeout=pipeline_budget(2))
            out = out.numpy()
        client.close()
    assert "Processing complete" in status, status
    assert _prediction(status) == pred == int(out.argmax())
    np.testing.assert_allclose(out, probs, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("kinds", [("jax", "torch"), ("torch", "jax")],
                         ids=lambda k: "->".join(k))
def test_gpt_bf16_hop_between_packages(kinds):
    """gpt2-test in 2 stages with bf16 compute: the hop carries a
    "bfloat16" tensor from one package to the other; the logits agree
    with the JAX engine's."""
    from dnn_tpu.models import gpt as jgpt

    params = jax.tree.map(np.asarray, jgpt.init(
        jax.random.PRNGKey(2), jgpt.PRESETS["gpt2-test"]))
    raw = _raw("gpt2-test", 2, dtype="bfloat16")
    ids = np.random.default_rng(0).integers(0, 256, (1, 12)).astype(np.int32)
    want = np.asarray(JaxEngine(JaxConfig.from_dict(raw), params=jax.tree.map(
        jnp.asarray, params)).run(jnp.asarray(ids)))
    with _pipeline(raw, params, kinds) as addr:
        client = NodeClient(addr)
        assert client.wait_healthy(deadline=30)
        status, out = client.send_tensor(ids, timeout=60)
        client.close()
    assert "Processing complete" in status, status
    assert out.dtype == torch.float32 and out.shape == want.shape
    err = np.abs(out.numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


def test_bf16_wire_payload_byte_identical_to_jax():
    """A bf16 tensor encodes to the JAX codec's bytes (ml_dtypes there,
    raw 16-bit words here; both with the payload's crc32c), and each side
    decodes the other's."""
    x = torch.randn(2, 3, 5).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    mine = wc.TensorRequest("r", wc.make_tensor(x))
    theirs = jwc.TensorRequest("r", jwc.make_tensor(np.asarray(jx)))
    assert theirs.tensor.crc32c is not None
    assert wc.serialize_request(mine) == jwc.serialize_request(theirs)
    back = wc.tensor_torch(wc.parse_request(
        jwc.serialize_request(theirs)).tensor)
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)
    jback = jwc.tensor_view(jwc.parse_request(
        wc.serialize_request(mine)).tensor)
    np.testing.assert_array_equal(np.asarray(jback, np.float32),
                                  x.float().numpy())
    from dnn_tpu.io.serialization import encode_tensor as jenc
    from dnn_tpu_torch.io.serialization import decode_tensor, encode_tensor

    assert encode_tensor(x) == jenc(np.asarray(jx))
    assert torch.equal(decode_tensor(*jenc(np.asarray(jx))), x)
    with pytest.raises(ValueError, match="needs"):
        decode_tensor(b"\0" * 4, (3,), "bfloat16")


@pytest.fixture(scope="module")
def lone_stage(cifar):
    params = cifar[0]
    raw = _raw("cifar_cnn", 2)
    eng = PipelineEngine(TopologyConfig.from_dict(raw), params=params,
                         role="stage")
    _, stop = start_stage_server_in_background(eng, "node2")
    channel = grpc.insecure_channel(raw["nodes"][1]["address"])
    try:
        yield channel
    finally:
        channel.close()
        stop()


def test_corrupt_payload_aborts_with_data_loss(lone_stage):
    call = lone_stage.unary_unary(
        f"/{SERVICE_NAME}/SendTensor",
        request_serializer=wc.serialize_request,
        response_deserializer=wc.parse_response)
    t = wc.make_tensor(np.ones((1, 4096), np.float32))
    t.crc32c = (wc.crc32c(t.tensor_data) + 1) & 0xFFFFFFFF
    with pytest.raises(grpc.RpcError) as err:
        call(wc.TensorRequest("r", t), timeout=30)
    assert err.value.code() == grpc.StatusCode.DATA_LOSS
    # the same payload, honestly checksummed, is computed
    t.crc32c = wc.crc32c(t.tensor_data)
    resp = call(wc.TensorRequest("r", t), timeout=30)
    assert "Processing complete" in resp.status
    assert list(resp.result_tensor.shape) == [1, 10]


def test_transport_hello_declined_and_messages_answered(lone_stage):
    call = lone_stage.unary_unary(
        f"/{SERVICE_NAME}/SendMessage",
        request_serializer=pb.MessageRequest.SerializeToString,
        response_deserializer=pb.MessageReply.FromString)
    hello = json.loads(call(pb.MessageRequest(
        sender_id=HELLO_SENDER, message_text="{}"), timeout=10)
        .confirmation_text)
    assert hello["ok"] is False
    reply = call(pb.MessageRequest(sender_id="me", message_text="hi"),
                 timeout=10)
    assert reply.confirmation_text == "[node2] got msg 'hi'"
    health = lone_stage.unary_unary(
        f"/{SERVICE_NAME}/HealthCheck",
        request_serializer=pb.Empty.SerializeToString,
        response_deserializer=pb.HealthCheckResponse.FromString)
    assert health(pb.Empty(), timeout=10).is_healthy


def _node(*args):
    return [sys.executable, "-m", "dnn_tpu_torch.node", *args]


def test_cli_serve_pair_prints_the_jax_prediction(cifar, tmp_path):
    """Two `node --serve` processes on a model_weights .npz; node1 with
    --input_image of a missing file sends the dummy image through and
    prints the JAX engine's prediction; SIGTERM stops both with rc 0."""
    params, _, _, pred = cifar
    weights = tmp_path / "cifar.npz"
    ckpt.save_npz(str(weights), ckpt.params_to_flat(params))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(_raw("cifar_cnn", 2, model_weights=str(weights))))
    out1 = tmp_path / "node1.out"
    procs = []
    try:
        procs.append(subprocess.Popen(
            _node("--node_id", "node2", "--config", str(cfg), "--serve"),
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        with open(out1, "w") as f:
            procs.append(subprocess.Popen(
                _node("--node_id", "node1", "--config", str(cfg), "--serve",
                      "--input_image", str(tmp_path / "missing.png")),
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
        t_end = time.monotonic() + 120
        while "FINAL PREDICTION" not in out1.read_text():
            assert time.monotonic() < t_end, out1.read_text()[-2000:]
            assert procs[1].poll() is None, out1.read_text()[-2000:]
            time.sleep(0.2)
        text = out1.read_text()
        assert f"***** FINAL PREDICTION (Index): {pred} *****" in text, text
        assert "device cpu" in text
        for p in procs:
            p.send_signal(signal.SIGTERM)
        assert [p.wait(timeout=30) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_cli_generate_equals_the_jax_cli(tmp_path, capsys):
    """`node --generate` on a model_weights .npz prints the tokens of
    `python -m dnn_tpu.node --generate` on the same file (weights x15:
    decisive argmaxes)."""
    from dnn_tpu import node as jnode
    from dnn_tpu.models import gpt as jgpt

    params = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(5), jgpt.PRESETS["gpt2-test"]))
    weights = tmp_path / "gpt.npz"
    ckpt.save_npz(str(weights), ckpt.params_to_flat(params))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(_raw("gpt2-test", 2,
                                   model_weights=str(weights))))
    args = ["--node_id", "node1", "--config", str(cfg), "--generate", "10",
            "--prompt_ids", "5,17,200,3"]
    proc = subprocess.run(_node(*args), cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert jnode.main(args) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if "GENERATED TOKENS" in ln]
    got = [ln for ln in proc.stdout.splitlines() if "GENERATED TOKENS" in ln]
    assert got == want and len(want) == 1
    assert len(set(want[0].split(":")[1].strip(" *").split(","))) > 1


@pytest.mark.parametrize("flags,rc", [
    # --transport shm|device, --chaos and --metrics_port with --serve are
    # ported: their positive cases are the test_cli_serve_* tests below
    # --beam and --lora (once these places) are ported now: their
    # positive cases are tests/test_torch_beam.py::
    # test_node_generate_beam_equals_the_jax_cli
    (["--supervise"], 2),
    # the fleet front door (item 11) and multi-host (item 10)
    (["--route"], 2),
    (["--route_targets", "127.0.0.1:1"], 2),
    (["--route_signals", "http://127.0.0.1:1"], 2),
    (["--policy", "round_robin"], 2),
    (["--kvtier", "pull"], 2),
    (["--process_id", "0"], 2),
    # the fleet collector's flags are ported: JAX's validation errors
    # (node.py:575-603), rc 1 — no targets and no --metrics_port to
    # derive them from, and --fleet_targets/--fleet_interval without
    # --fleet_port
    (["--fleet_port", "0", "--serve"], 1),
    (["--fleet_targets", "http://127.0.0.1:1"], 1),
    (["--fleet_interval", "1"], 1),
    (["--transport", "grpc"], 1),
])
def test_cli_unported_flags_exit(tmp_path, flags, rc):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(_raw("cifar_cnn", 2)))
    from dnn_tpu_torch.node import main

    assert main(["--node_id", "node1", "--config", str(cfg), *flags]) == rc


def _get(url, timeout=5.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


# the stage seam's plan: one 50 ms delay before node1's first forward
STAGE_DELAY_PLAN = {"seed": 0, "faults": [
    {"kind": "rpc_delay", "seam": "stage", "p": 1.0, "count": 1,
     "delay_s": 0.05}]}


@pytest.fixture(scope="module")
def served_pair(cifar, tmp_path_factory):
    """Two `node --serve --transport shm --metrics_port P` processes,
    node1 with a --chaos plan on the stage seam and --input_image (a
    missing file: the dummy image). Once node1 printed its prediction, a
    client's send_tensor goes through node1's server (which forwards to
    node2 over shm, the chaos delay first); then the endpoints are read,
    node3 (--transport device, towards node2 in another process) is run
    to its exit, and SIGTERM stops the pair. Returns what the tests
    check."""
    tmp = tmp_path_factory.mktemp("served_pair")
    params, x, _, _ = cifar
    weights = tmp / "cifar.npz"
    ckpt.save_npz(str(weights), ckpt.params_to_flat(params))
    raw = _raw("cifar_cnn", 2, model_weights=str(weights))
    cfg = tmp / "cfg.json"
    cfg.write_text(json.dumps(raw))
    plan = tmp / "plan.json"
    plan.write_text(json.dumps(STAGE_DELAY_PLAN))
    mports = [_free_port(), _free_port()]
    outs = [tmp / "node1.out", tmp / "node2.out"]
    got, procs = {}, []
    try:
        for node, out, mport, extra in (
                ("node2", outs[1], mports[1], []),
                ("node1", outs[0], mports[0],
                 ["--chaos", str(plan), "--input_image",
                  str(tmp / "missing.png")])):
            with open(out, "w") as f:
                procs.append(subprocess.Popen(
                    _node("--node_id", node, "--config", str(cfg), "--serve",
                          "--transport", "shm", "--metrics_port",
                          str(mport), *extra),
                    cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
        t_end = time.monotonic() + 120
        while "FINAL PREDICTION" not in outs[0].read_text():
            assert time.monotonic() < t_end, outs[0].read_text()[-2000:]
            assert procs[1].poll() is None, outs[0].read_text()[-2000:]
            time.sleep(0.2)
        got["node1_out"] = outs[0].read_text()
        client = NodeClient(raw["nodes"][0]["address"], transport="grpc")
        got["relayed"] = client.send_tensor(x, timeout=60)
        client.close()
        base = [f"http://127.0.0.1:{p}" for p in mports]
        got["metrics"] = [_get(b + "/metrics") for b in base]
        got["healthz"] = [_get(b + "/healthz") for b in base]
        got["debugz"] = [json.loads(_get(b + "/debugz?format=json")[1])
                         for b in base]
        dev_raw = {**raw, "nodes": [raw["nodes"][0] | {
            "address": f"127.0.0.1:{_free_port()}"}, raw["nodes"][1]]}
        dev_cfg = tmp / "dev.json"
        dev_cfg.write_text(json.dumps(dev_raw))
        got["device"] = subprocess.run(
            _node("--node_id", "node1", "--config", str(dev_cfg), "--serve",
                  "--transport", "device", "--input_image",
                  str(tmp / "missing.png")),
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        for p in procs:
            p.send_signal(signal.SIGTERM)
        got["rcs"] = [p.wait(timeout=30) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return got


def _negotiations(metrics_text, **labels):
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return [ln for ln in metrics_text.splitlines()
            if "transport_negotiations_total{" in ln
            and all(w in ln for w in want)]


def test_cli_transport_shm_process_serves(served_pair, cifar):
    """`node --serve --transport shm` as two processes: node1 prints the
    JAX engine's prediction, and SIGTERM stops both with rc 0."""
    pred = cifar[3]
    assert (f"***** FINAL PREDICTION (Index): {pred} *****"
            in served_pair["node1_out"]), served_pair["node1_out"][-2000:]
    assert served_pair["rcs"] == [0, 0]


def test_cli_serve_transport_shm_negotiates_shm(served_pair, cifar):
    """Both hops out of node1 (its edge client and its stage server's
    forward) settle on shm, which node2 granted: the counters of both
    sides say so, and the relayed answer is the JAX prediction."""
    m1, m2 = (t for _, t in served_pair["metrics"])
    assert len(_negotiations(m1, chosen="shm", role="client")) >= 1, m1
    assert _negotiations(m2, chosen="shm", role="server", stage="node2"), m2
    assert not _negotiations(m1, chosen="grpc")
    status, y = served_pair["relayed"]
    assert status.startswith("[node1] Forwarded. Next node status: [node2] "
                             f"Processing complete. Prediction: {cifar[3]}")
    np.testing.assert_allclose(y.numpy(), cifar[2], rtol=0, atol=F32_TOL)


def test_cli_serve_transport_device_across_processes_fails_loud(served_pair):
    """--transport device towards a stage in another process cannot be
    satisfied: the hop raises TransportMisconfigError and the node exits
    1, never downgrading to a slower rung."""
    proc = served_pair["device"]
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "transport='device'" in proc.stderr and "refused" in proc.stderr


def test_cli_serve_metrics_port_serves_the_stage(served_pair):
    """--metrics_port with --serve: /healthz answers, /metrics holds the
    stage server's RPC latency and payload series."""
    assert [c for c, _ in served_pair["healthz"]] == [200, 200]
    m1, m2 = (t for _, t in served_pair["metrics"])
    assert 'comm_rpc_latency_seconds_bucket{' in m2 and 'stage="node2"' in m2
    assert 'method="SendTensor"' in m2 and 'transport="shm"' in m2
    assert 'method="forward"' in m1 and "comm_payload_bytes_total" in m1


def test_cli_serve_chaos_fires_on_the_stage_seam(served_pair):
    """--chaos with --serve: the plan's stage-seam delay fires once, before
    node1's forward, shows as a chaos_inject event in /debugz, and the
    request still completes."""
    events = [e for e in served_pair["debugz"][0]
              if e.get("kind") == "chaos_inject"
              and e.get("fault") != "install"]
    assert len(events) == 1, served_pair["debugz"][0]
    assert (events[0]["fault"], events[0]["seam"]) == ("rpc_delay", "stage")
    assert not [e for e in served_pair["debugz"][1]
                if e.get("kind") == "chaos_inject"]
    assert "Processing complete" in served_pair["relayed"][0]


def test_cli_distributed_config_exits_2(tmp_path):
    from dnn_tpu_torch.node import main

    assert main(["--node_id", "hostA", "--config",
                 str(ROOT / "configs/cifar_2host_distributed.json")]) == 2
