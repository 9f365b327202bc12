"""The LM daemon's text front (SendMessage with a tokenizer), the port
against the JAX daemon on the same small gpt (2 layers, 32 wide, vocab
300) with the same parameters (convert.from_jax_params): the same text
and options give the same reply. Also: "!stats", the declined hello,
text that tokenizes to nothing, the streamed text client, and
`node --tokenizer`. Greedy replies must be IDENTICAL."""

import json
import pathlib
import re
import signal
import socket
import subprocess
import sys

import grpc
import numpy as np
import pytest

import jax

from dnn_tpu.comm.client import NodeClient as JaxClient
from dnn_tpu.io.tokenizer import ByteTokenizer as JaxByteTokenizer
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime.lm_server import (
    start_lm_server_in_background as jax_start_lm,
)
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.comm.transport import HELLO_SENDER
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.io.tokenizer import ByteTokenizer
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = dict(block_size=64, vocab_size=300, n_layer=2, n_head=2, n_embd=32)
CFG_J, CFG_T = jgpt.GPTConfig(**SHAPE), tgpt.GPTConfig(**SHAPE)
POOL = dict(slots=2, max_len=64, prompt_pad=16, block_len=8,
            default_max_new=6)
CASES = [("héllo wörld 🙂", "gen:8"), ("∑ naïve", "gen:5:7"),
         ("a", "gen"), ("plain sender", "client-1"),
         ("dl tag ok", "gen:4:dl=30.000")]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def daemons():
    """(port daemon address, JAX daemon address), same weights, byte
    tokenizers over the model's vocab."""
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(4), CFG_J))
    pj, pt = _free_port(), _free_port()
    _, stop_j = jax_start_lm(CFG_J, jgpt.prepare_stacked(tree, CFG_J),
                             port=pj, tokenizer=JaxByteTokenizer(300),
                             **POOL)
    try:
        _, stop_t = start_lm_server_in_background(
            CFG_T, from_jax_params(tree, CFG_T, "cpu"), port=pt,
            device="cpu", tokenizer=ByteTokenizer(300), **POOL)
        try:
            yield f"127.0.0.1:{pt}", f"127.0.0.1:{pj}"
        finally:
            stop_t()
    finally:
        stop_j()


@pytest.mark.parametrize("text,sender", CASES,
                         ids=[s for _, s in CASES])
def test_text_reply_equals_the_jax_daemons(daemons, text, sender):
    mine, theirs = NodeClient(daemons[0]), JaxClient(daemons[1])
    try:
        got = mine.send_message(sender, text, timeout=60)
        assert got == theirs.send_message(sender, text, timeout=60)
    finally:
        mine.close()
        theirs.close()
    assert got and "pool" not in got


def test_generate_text_is_the_decode_of_the_id_endpoint(daemons):
    """generate_text's reply equals ByteTokenizer.decode of the tokens
    SendTensor returns for the same ids, and the streamed text client's
    chunks join to the same reply (a JAX client's too)."""
    tok = ByteTokenizer(300)
    c = NodeClient(daemons[0])
    text = "streamed ∑ text 🙂"
    try:
        reply = c.generate_text(text, max_new_tokens=8, timeout=60)
        ids = c.generate(tok.encode(text), max_new_tokens=8, timeout=60)
        chunks = list(c.generate_text_stream(text, tok, max_new_tokens=8,
                                             timeout=60))
    finally:
        c.close()
    assert reply == tok.decode(ids.tolist())
    assert "".join(chunks) == reply and len(chunks) >= 1
    j = JaxClient(daemons[0])
    try:
        assert "".join(j.generate_text_stream(
            text, JaxByteTokenizer(300), max_new_tokens=8)) == reply
    finally:
        j.close()


def test_stats_hello_and_empty_text(daemons):
    c = NodeClient(daemons[0])
    try:
        assert c.send_message("gen:4", "!stats").startswith("[lm] pool: ")
        hello = json.loads(c.send_message(HELLO_SENDER, "{}"))
        assert hello["ok"] is False and "relay" not in hello
        with pytest.raises(grpc.RpcError) as err:
            c.send_message("gen:4", "", timeout=30)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert c.negotiated().relay_ok is False  # the daemon has no Relay
    finally:
        c.close()


def test_without_a_tokenizer_any_text_gets_the_stats():
    port = _free_port()
    _, stop = start_lm_server_in_background(
        CFG_T, from_jax_params(tgpt.init(2, CFG_T), CFG_T, "cpu"),
        port=port, device="cpu", **POOL)
    try:
        c = NodeClient(f"127.0.0.1:{port}")
        assert c.send_message("gen:4", "some prompt").startswith(
            "[lm] pool: 0/2 slots active")
        c.close()
    finally:
        stop()


def _bpe_dir(path, vocab_size):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, \
        trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(["the quick brown fox"] * 20, trainers.BpeTrainer(
        vocab_size=vocab_size,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    PreTrainedTokenizerFast(tokenizer_object=tok).save_pretrained(path)
    return str(path)


def _config(tmp_path, port):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0, "address": f"127.0.0.1:{port}"}]}))
    return str(cfg)


def test_node_tokenizer_too_large_a_vocab_exits_1(tmp_path, caplog):
    from dnn_tpu_torch.node import main

    tok_dir = _bpe_dir(tmp_path / "bpe", 300)  # gpt2-test's vocab is 256
    cfg = _config(tmp_path, _free_port())
    with caplog.at_level("ERROR", logger="dnn_tpu_torch.node"):
        rc = main(["--node_id", "node1", "--config", cfg, "--serve_lm",
                   "--device", "cpu", "--tokenizer", tok_dir])
    assert rc == 1
    assert re.search(r"tokenizer setup failed: tokenizer vocab 2[6-9]\d "
                     r"exceeds the model's vocab_size 256", caplog.text)
    with caplog.at_level("ERROR", logger="dnn_tpu_torch.node"):
        rc = main(["--node_id", "node1", "--config", cfg, "--serve_lm",
                   "--device", "cpu", "--tokenizer",
                   str(tmp_path / "missing")])
    assert rc == 1


def test_node_tokenizer_bytes_serves_text(tmp_path):
    """`node --serve_lm --tokenizer bytes` as a process answers text with
    the decode of the tokens its id endpoint gives, and stops on
    SIGTERM with rc 0."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", _config(tmp_path, port), "--serve_lm", "--device",
         "cpu", "--slots", "2", "--max_len", "64", "--prompt_pad", "16",
         "--tokenizer", "bytes"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        c = NodeClient(f"127.0.0.1:{port}")
        assert c.wait_healthy(deadline=90)
        tok = ByteTokenizer(256)
        reply = c.generate_text("héllo", max_new_tokens=5, timeout=60)
        ids = c.generate(tok.encode("héllo"), max_new_tokens=5, timeout=60)
        c.close()
        assert reply == tok.decode(ids.tolist())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
