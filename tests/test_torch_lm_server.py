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
import torch

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

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

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
    """Out-of-vocab prompt -> INVALID_ARGUMENT; the JAX client's dedup key
    (d=) joins: a repeated key answers the first request's tokens without
    generating again (tests/test_torch_resilience.py holds the join
    over concurrent calls); the server lives on."""
    addr, want = served
    jc = JaxClient(addr, breaker=False)
    with pytest.raises(grpc.RpcError) as e:
        jc.generate(np.array([1, 999], np.int32), max_new_tokens=2,
                    timeout=30)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    first = jc.generate(PROMPTS[0], max_new_tokens=N_NEW, dedup="k1",
                        timeout=60)
    np.testing.assert_array_equal(first, want[0])
    # the same key with another prompt still answers the first request's
    # generation: it joined, it did not generate
    np.testing.assert_array_equal(
        jc.generate(PROMPTS[1], max_new_tokens=N_NEW, dedup="k1",
                    timeout=60), want[0])
    np.testing.assert_array_equal(
        jc.generate(PROMPTS[0], max_new_tokens=N_NEW, timeout=60), want[0])
    jc.close()


def test_node_serve_lm_passes_min_p_and_repetition_penalty(tmp_path,
                                                           monkeypatch):
    """`node --serve_lm --min_p 0.05 --repetition_penalty 1.1` reaches the
    batcher as its defaults (JAX node.py:108-111, :1018-1019); with
    another mode the flags exit 1, as JAX's node does."""
    import asyncio
    import json

    from dnn_tpu_torch import node
    from dnn_tpu_torch.runtime import lm_server

    seen = {}

    async def fake_serve_lm(cfg, prepared, *, port, **kw):
        srv = lm_server.LMServer(cfg, prepared, **kw)
        seen.update(minp=srv.batcher._default_minp,
                    rep=srv.batcher._default_rep)
        srv.close()
        return 0

    monkeypatch.setattr(lm_server, "serve_lm", fake_serve_lm)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0, "address": "127.0.0.1:1"}]}))
    base = ["--node_id", "node1", "--config", str(cfg)]
    assert node.main(base + ["--serve_lm", "--device", "cpu", "--slots", "1",
                             "--max_len", "32", "--prompt_pad", "16",
                             "--min_p", "0.05",
                             "--repetition_penalty", "1.1"]) == 0
    assert seen == {"minp": 0.05, "rep": 1.1}
    assert node.main(base + ["--generate", "2", "--min_p", "0.05"]) == 1
    assert asyncio.iscoroutinefunction(lm_server.serve_lm)


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
    same seeded weights, and a SIGTERM during a GenerateStream drains it
    (JAX lm_server.py:2108-2195): the stream completes with the same
    tokens and the process exits with rc 0."""
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
        b = ContinuousBatcher(CFG_T, from_jax_params(tgpt.init(3, CFG_T),
                                                      CFG_T, "cpu"),
                              device="cpu", slots=2, max_len=64,
                              prompt_pad=16, block_len=8)
        rid = b.submit(PROMPTS[1], 6)
        rid_long = b.submit(PROMPTS[0], 48)
        res = b.drain()
        np.testing.assert_array_equal(got, res[rid])
        stream = client.generate_stream(PROMPTS[0], max_new_tokens=48,
                                        timeout=60)
        streamed = [next(stream)]
        proc.send_signal(signal.SIGTERM)
        streamed += list(stream)
        client.close()
        assert streamed == res[rid_long].tolist()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_node_cli_kv_flags(tmp_path, monkeypatch):
    """The JAX daemon's cache flags parse with its spellings; --kv_dtype
    int4 reaches the daemon's batcher as an int4 paged pool (uint8 K/V
    blocks of D / 2 bytes a row; serve_lm stood in for by the LMServer it
    builds)."""
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
    from dnn_tpu_torch.runtime import lm_server

    built = {}

    async def fake_serve_lm(cfg_, prepared, *, port, **kw):
        servicer = lm_server.LMServer(cfg_, prepared, **kw)
        built["cache"] = dict(servicer.batcher.cache)
        built["paged"] = servicer.batcher.paged
        servicer.close()
        return 0

    monkeypatch.setattr(lm_server, "serve_lm", fake_serve_lm)
    assert main(["--node_id", "node1", "--config", str(cfg), "--serve_lm",
                 "--device", "cpu", "--kv_dtype", "int4", "--max_len", "64",
                 "--prompt_pad", "16", "--slots", "2"]) == 0
    k = built["cache"]["k"]
    assert built["paged"] and k.dtype == torch.uint8
    assert k.shape[-1] == CFG_T.n_embd // CFG_T.n_head // 2
    assert built["cache"]["ks"].dtype == torch.float32


def test_lmserver_defaults_match_jax_and_node_turns_them_on(monkeypatch,
                                                            tmp_path):
    """One LMServer(cfg, prepared) call on both packages builds batchers
    with the same allow_logit_bias, allow_constraints and
    constraint_rows: off by default, 3600 rows once constraints are on
    (the port once turned both on by default). `node --serve_lm` turns
    both on, as JAX's node does, and its daemon serves a b= bias and a
    JSON-mode (j=) constraint."""
    import json

    from dnn_tpu.runtime.lm_server import LMServer as JaxLMServer
    from dnn_tpu_torch import node
    from dnn_tpu_torch.runtime import lm_server
    from dnn_tpu_torch.runtime.lm_server import LMServer

    tree = jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(3), CFG_J))
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)

    def flags(b, jax_side):
        bias = b._allow_user_bias if jax_side else b._bias is not None
        return bias, b._allow_constraints, b._ctab_rows

    for kw in ({}, {"allow_constraints": True, "allow_logit_bias": True}):
        js = JaxLMServer(CFG_J, jprep, **POOL, **kw)
        ts = LMServer(CFG_T, from_jax_params(tree, CFG_T, "cpu"),
                      device="cpu", **POOL, **kw)
        try:
            assert flags(ts.batcher, False) == flags(js.batcher, True)
            assert flags(ts.batcher, False) == (
                (True, True, 3600) if kw else (False, False, 0))
        finally:
            ts.close()
            js.close()
    npz = tmp_path / "w.npz"
    flat = {}

    def flatten(n, prefix):
        for k, v in n.items():
            if isinstance(v, dict):
                flatten(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v
    flatten(tree, "")
    np.savez(npz, **flat)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0,
         "address": f"127.0.0.1:{_free_port()}"}]}))
    seen = {}

    async def fake_serve_lm(cfg, prepared, *, port, **kwargs):
        srv = LMServer(cfg, prepared, **kwargs)
        try:
            b = srv.batcher
            seen["flags"] = flags(b, False)
            c = seen["grammar"] = srv.json_constraint(0)
            fut = srv.worker.submit(PROMPTS[0], 6, None,
                                    opts={"logit_bias": {7: 1e9}})
            seen["biased"] = fut.result(timeout=120).tolist()
            fut = srv.worker.submit(PROMPTS[1], 20, None,
                                    opts={"constraint": c})
            seen["json"] = bytes(int(t) for t in fut.result(timeout=120))
        finally:
            srv.close()
        return 0

    monkeypatch.setattr(lm_server, "serve_lm", fake_serve_lm)
    assert node.main(["--node_id", "node1", "--config", str(cfg),
                      "--serve_lm", "--device", "cpu", "--tokenizer",
                      "bytes", "--weights_npz", str(npz),
                      *[f"--{k}={v}" for k, v in POOL.items()]]) == 0
    assert seen["flags"] == (True, True, 3600)
    assert seen["biased"] == [7] * 6
    c, state = seen["grammar"], seen["grammar"].start
    for t in seen["json"]:  # every token a step of the JSON grammar
        state = c.advance(state, t)
        assert state >= 0, seen["json"]
