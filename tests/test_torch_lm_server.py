"""The port's LM daemon on the CPU, driven over gRPC by the JAX
package's own client (dnn_tpu.comm.client.NodeClient): the tokens must
equal the JAX batcher's on the same weights — which also proves the two
packages speak the same wire (message layout, option grammar, the
client's transport hello). Greedy tokens must be IDENTICAL."""

import socket
import threading

import grpc
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dnn_tpu.comm.client import NodeClient as JaxClient
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.runtime.lm_server import (
    parse_gen_options,
    start_lm_server_in_background,
)

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)
PROMPTS = [np.random.default_rng(i).integers(0, 256, n).astype(np.int32)
           for i, n in enumerate((6, 19, 40))]
N_NEW = 10


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def served():
    """(address, JAX batcher's greedy tokens per prompt)."""
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(1), CFG_J))
    jb = JaxBatcher(CFG_J, jgpt.prepare_stacked(
        jax.tree.map(jnp.asarray, tree), CFG_J), kv="paged", **POOL)
    rids = [jb.submit(p, N_NEW) for p in PROMPTS]
    res = jb.drain()
    want = [np.asarray(res[r]) for r in rids]
    port = _free_port()
    thread, stop = start_lm_server_in_background(
        CFG_T, from_jax_params(tree, CFG_T, "cpu"), port=port,
        device="cpu", **POOL)
    try:
        yield f"127.0.0.1:{port}", want
    finally:
        stop()
        assert not thread.is_alive()


def test_jax_client_three_threads_match_jax_batcher(served):
    addr, want = served
    client = JaxClient(addr)
    assert client.wait_healthy(deadline=30)
    got, errors = {}, []

    def call(i):
        try:
            got[i] = client.generate(PROMPTS[i], max_new_tokens=N_NEW,
                                     timeout=60)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])
    client.close()


def test_generate_stream_matches(served):
    """GenerateStream through the JAX client, and the port's own client
    (unary and streaming) — all the same tokens."""
    addr, want = served
    jc = JaxClient(addr)
    assert list(jc.generate_stream(PROMPTS[2], max_new_tokens=N_NEW,
                                   timeout=60)) == want[2].tolist()
    jc.close()
    pc = NodeClient(addr)
    assert pc.wait_healthy(deadline=30)
    assert list(pc.generate_stream(PROMPTS[1], max_new_tokens=N_NEW)) == \
        want[1].tolist()
    np.testing.assert_array_equal(
        pc.generate(PROMPTS[0], max_new_tokens=N_NEW), want[0])
    pc.close()


def test_bad_requests_get_grpc_errors(served):
    """Out-of-vocab prompt -> INVALID_ARGUMENT; an option this slice
    does not serve (logit bias) -> UNIMPLEMENTED; the server lives on."""
    addr, want = served
    jc = JaxClient(addr, breaker=False)
    with pytest.raises(grpc.RpcError) as e:
        jc.generate(np.array([1, 999], np.int32), max_new_tokens=2,
                    timeout=30)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as e:
        jc.generate(PROMPTS[0], max_new_tokens=2, logit_bias={3: 1.0},
                    timeout=30)
    assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
    np.testing.assert_array_equal(
        jc.generate(PROMPTS[0], max_new_tokens=N_NEW, timeout=60), want[0])
    jc.close()


def test_dense_int8_daemon_matches_jax_batcher():
    """A daemon on the dense int8 pool (kv="dense", kv_dtype="int8":
    K5 int8 prefill, K6 int8 decode), driven concurrently by the JAX
    client: the same tokens as the JAX batcher on that configuration."""
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(2), CFG_J))
    layout = dict(kv="dense", kv_dtype="int8", **POOL)
    jb = JaxBatcher(CFG_J, jgpt.prepare_stacked(
        jax.tree.map(jnp.asarray, tree), CFG_J), **layout)
    rids = [jb.submit(p, N_NEW) for p in PROMPTS]
    res = jb.drain()
    port = _free_port()
    thread, stop = start_lm_server_in_background(
        CFG_T, from_jax_params(tree, CFG_T, "cpu"), port=port,
        device="cpu", **layout)
    try:
        assert not stop.servicer.batcher.paged
        client = JaxClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=30)
        got, errors = {}, []

        def call(i):
            try:
                got[i] = client.generate(PROMPTS[i], max_new_tokens=N_NEW,
                                         timeout=60)
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads)
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(got[i], res[rid])
        client.close()
    finally:
        stop()
    assert not thread.is_alive()


def test_parse_gen_options_grammar():
    assert parse_gen_options("gen:7:3:t=0.5:k=4:dl=2.000", 32) == \
        (7, 3, {"temperature": 0.5, "top_k": 4})
    assert parse_gen_options("req:1234", 32) == (32, None, {})
    assert parse_gen_options("gen:x:p=0.9:tr=abc", 5) == \
        (5, None, {"top_p": 0.9})


def test_wirecodec_bytes_match_protobuf():
    """The hand-coded Tensor messages serialize byte-for-byte like the
    generated protobuf classes, the payload's crc32c included, and parse
    what protobuf writes; a payload whose declared crc32c does not match
    is refused."""
    from dnn_tpu_torch.comm import wire_pb2 as pb
    from dnn_tpu_torch.comm import wirecodec as wc

    arr = np.arange(7, dtype=np.int32)
    ours = wc.serialize_request(wc.TensorRequest(
        request_id="gen:4", tensor=wc.make_tensor(arr)))
    ref = pb.TensorRequest(request_id="gen:4", tensor=pb.Tensor(
        tensor_data=arr.tobytes(), shape=[7], dtype="int32",
        crc32c=wc.crc32c(arr.tobytes())))
    assert ours == ref.SerializeToString()
    parsed = wc.parse_request(ref.SerializeToString())
    np.testing.assert_array_equal(wc.tensor_view(parsed.tensor), arr)
    ref.tensor.crc32c ^= 1
    with pytest.raises(wc.PayloadCorruptError):
        wc.tensor_view(wc.parse_request(ref.SerializeToString()).tensor)
    resp = wc.serialize_response(wc.TensorResponse(
        status="ok", result_tensor=wc.make_tensor(arr[:2])))
    back = pb.TensorResponse.FromString(resp)
    assert back.status == "ok" and list(back.result_tensor.shape) == [2]


def test_node_cli_daemon_serves_and_drains_on_sigterm(tmp_path):
    """`python -m dnn_tpu_torch.node --serve_lm --device cpu` as a real
    process: it answers the same tokens as an in-process batcher on the
    same seeded weights, and SIGTERM stops it with rc 0."""
    import json
    import pathlib
    import signal
    import subprocess
    import sys

    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    port = _free_port()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0, "address": f"127.0.0.1:{port}"}]}))
    pool = ["--slots", "2", "--max_len", "64", "--prompt_pad", "16",
            "--block_len", "8", "--seed", "3"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", str(cfg), "--serve_lm", "--device", "cpu", *pool],
        cwd=pathlib.Path(__file__).resolve().parents[1],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=90)
        got = client.generate(PROMPTS[1], max_new_tokens=6)
        client.close()
        b = ContinuousBatcher(CFG_T, from_jax_params(tgpt.init(3, CFG_T),
                                                      CFG_T, "cpu"),
                              device="cpu", slots=2, max_len=64,
                              prompt_pad=16, block_len=8)
        rid = b.submit(PROMPTS[1], 6)
        np.testing.assert_array_equal(got, b.drain()[rid])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_node_cli_kv_flags(tmp_path, caplog):
    """The JAX daemon's cache flags parse with its spellings; --kv_dtype
    int4 exits with the ROADMAP item-2 message instead of serving."""
    import json

    from dnn_tpu_torch.node import build_parser, main

    args = build_parser().parse_args(
        ["--node_id", "n", "--config", "c", "--serve_lm", "--kv", "dense",
         "--kv_dtype", "int8", "--decode_buckets", "--paged_blocks", "0"])
    assert (args.kv, args.kv_dtype, args.decode_buckets,
            args.paged_blocks) == ("dense", "int8", True, 0)
    assert build_parser().parse_args(
        ["--node_id", "n", "--config", "c"]).kv == "auto"
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0,
         "address": f"127.0.0.1:{_free_port()}"}]}))
    with caplog.at_level("ERROR", logger="dnn_tpu_torch.node"):
        assert main(["--node_id", "node1", "--config", str(cfg),
                     "--serve_lm", "--device", "cpu", "--kv_dtype",
                     "int4"]) == 2
    assert "item 2" in caplog.text
