"""The prefill->decode KV row handoff of the port (control/handoff.py,
ContinuousBatcher.export_prefill / submit(prefilled=), the daemon's
prefill, kvput: and h=) on the CPU against the JAX package's: the wire
format byte for byte both ways, the exported row within 1e-5 of JAX's
(f32, relative to the row's scale; int8 scales the same, int8 values
equal; a bf16 cache within one bf16 step, the two packages' bf16
attention rounding differently), equal fingerprints, and greedy streams IDENTICAL
to JAX's local stream when either package adopts the other's payload.

Weights: gpt2-test with every matrix scaled by 15 (varied greedy
tokens), as in test_torch_serving."""

import socket

import grpc
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.control import handoff as jh
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.control import handoff as th
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

from test_torch_llama import one_torch_thread  # noqa: F401 — autouse

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)
JKV = {"f32": None, "bf16": jnp.bfloat16, "int8": "int8"}
N_NEW = 10


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(0), CFG_J))
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)
    return jprep, from_jax_params(tree, CFG_T, "cpu")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG_T.vocab_size, n)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leaves(kv_dtype):
    """A row's leaves {k, [ks,] v, [vs]} of the given cache type, seeded."""
    g = torch.Generator().manual_seed(0)
    shape = (2, 1, 3, 8, 4)
    if kv_dtype == "int8":
        return [torch.randint(-127, 128, shape, generator=g,
                              dtype=torch.int8),
                torch.rand(shape[:-1], generator=g),
                torch.randint(-127, 128, shape, generator=g,
                              dtype=torch.int8),
                torch.rand(shape[:-1], generator=g)]
    dt = torch.bfloat16 if kv_dtype == "bf16" else torch.float32
    return [torch.randn(shape, generator=g).to(dt) for _ in range(2)]


def _payload(kv_dtype):
    return {"row": _leaves(kv_dtype), "logits_row": torch.randn(11),
            "prompt_len": 5, "fingerprint": {"row_len": 8, "family": "x"}}


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_codec_round_trip_and_cross_package(kv_dtype):
    """pack/unpack round-trips every leaf bit for bit; JAX's unpack reads
    the port's pack and packs it back to the same bytes; the port's
    unpack reads JAX's."""
    pl = _payload(kv_dtype)
    wire = th.pack(pl)
    back = th.unpack(wire)
    assert back["prompt_len"] == 5 and back["fingerprint"] == pl["fingerprint"]
    for got, want in zip(back["row"] + [back["logits_row"]],
                         pl["row"] + [pl["logits_row"]]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    jax_side = jh.unpack(wire)
    assert [str(x.dtype) for x in jax_side["row"]] == [
        th.np_dtype_name(x.dtype) for x in pl["row"]]
    assert bytes(jh.pack(jax_side)) == bytes(wire)
    again = th.unpack(jh.pack(jax_side))
    for got, want in zip(again["row"], pl["row"]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["magic", "truncated", "header", "int4"])
def test_malformed_payloads_raise(case):
    """Bad magic, a truncated payload, a header that is not JSON and a
    leaf with no wire form each raise HandoffFormatError (a ValueError),
    as JAX's codec does (tests/test_control.py)."""
    wire = th.pack(_payload("f32"))
    with pytest.raises(th.HandoffFormatError):
        if case == "magic":
            th.unpack(np.frombuffer(b"not a payload at all", np.uint8))
        elif case == "truncated":
            th.unpack(wire[:-7])
        elif case == "header":
            bad = bytearray(wire.tobytes())
            bad[11] = ord("x")  # the JSON header's opening brace
            th.unpack(np.frombuffer(bytes(bad), np.uint8))
        else:
            th.pack({"row": [np.zeros((2,), np.uint32)],
                     "logits_row": np.zeros((3,), np.float32),
                     "prompt_len": 1})
    assert issubclass(th.HandoffFormatError, ValueError)


def _stream(b, prompt, **kw):
    rid = b.submit(prompt, N_NEW, **kw)
    return np.asarray(b.drain()[rid])


@pytest.mark.parametrize("kv_dtype", ["f32", "int8", "bf16"])
def test_export_and_adoption_match_jax(weights, kv_dtype):
    """The same prompt exported by both packages' batchers: equal
    fingerprints, rows and logits rows within tolerance. JAX's payload
    (through JAX's pack and the port's unpack) adopted by the port, and
    the port's adopted by JAX, each give JAX's local greedy stream, and
    the adopter runs no prompt chunk."""
    jprep, tprep = weights
    jb = JaxBatcher(CFG_J, jprep, kv="paged", kv_dtype=JKV[kv_dtype], **POOL)
    tb = ContinuousBatcher(CFG_T, tprep, device="cpu",
                           kv_dtype=None if kv_dtype == "f32" else kv_dtype,
                           **POOL)
    p = _prompt(1, 37)
    je, te = jb.export_prefill(p), tb.export_prefill(p)
    assert te["fingerprint"] == je["fingerprint"] == jb.handoff_fingerprint()
    assert te["prompt_len"] == je["prompt_len"] == 37
    for want, got in zip(je["row"] + [je["logits_row"]],
                         te["row"] + [te["logits_row"]]):
        want = th.as_tensor(np.asarray(want))
        assert want.dtype == got.dtype and want.shape == got.shape
        if got.dtype == torch.int8:
            assert torch.equal(got, want)
            continue
        scale = want.float().abs().max()
        # a bf16 cache: JAX's attention rounds its probabilities to bf16
        # (ROADMAP Queue 3's known differences), which reaches the logits
        tol = 2 ** -7 if kv_dtype == "bf16" else 1e-5
        assert (got.float() - want.float()).abs().max() <= tol * scale
    want = _stream(jb, p)
    chunks = tb.prefill_chunks_run
    got = _stream(tb, p, prefilled=th.unpack(jh.pack(je)))
    assert tb.prefill_chunks_run == chunks
    np.testing.assert_array_equal(got, want)
    back = jh.unpack(th.pack(te))
    np.testing.assert_array_equal(_stream(jb, p, prefilled=back), want)
    np.testing.assert_array_equal(_stream(tb, p), want)


@pytest.mark.parametrize("pool", [
    {"kv": "dense"}, {"kv": "dense", "decode_buckets": (16, 32, 64)},
    {"kv": "paged", "prefix_cache": 8}], ids=["dense", "buckets", "radix"])
def test_every_pool_adopts_the_same_row(weights, pool):
    """A paged replica's export adopted by a dense, a bucketed and a
    radix-store replica: each stream equals that replica's own local
    prefill, and the adoption runs no chunk and no prefix lookup."""
    _, tprep = weights
    src = ContinuousBatcher(CFG_T, tprep, device="cpu", kv="paged", **POOL)
    p = _prompt(2, 45)
    payload = th.unpack(th.pack(src.export_prefill(p)))
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **{**POOL, **pool})
    chunks = b.prefill_chunks_run
    got = _stream(b, p, prefilled=payload)
    assert b.prefill_chunks_run == chunks
    assert b.prefix_hits == b.prefix_misses == 0
    np.testing.assert_array_equal(got, _stream(b, p))


def test_sampled_adoption_draws_as_a_local_prefill(weights):
    """A sampled request on an adopted row draws, draw for draw, what the
    same request (same seed) draws after the port's own prefill."""
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    p = _prompt(3, 29)
    payload = b.export_prefill(p)
    kw = dict(seed=11, temperature=0.9, top_k=20)
    np.testing.assert_array_equal(_stream(b, p, prefilled=payload, **kw),
                                  _stream(b, p, **kw))


def test_an_export_outlives_the_next_one(weights):
    """Two exports in a row from one batcher (no pack between them, as a
    library caller may): the first payload still holds its own row, so
    each adopts to the stream of a local prefill of its prompt."""
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    ps = [_prompt(12, 21), _prompt(13, 40)]
    payloads = [b.export_prefill(p) for p in ps]
    for p, payload in zip(ps, payloads):
        np.testing.assert_array_equal(_stream(b, p, prefilled=payload),
                                      _stream(b, p))


def test_int4_row_handoff_is_refused_as_in_jax(weights):
    """An int4 pool serves, but its row has no handoff wire form: the
    port's export_prefill raises HandoffFormatError with the message of
    JAX's codec (dnn_tpu/control/handoff.py:74-79). That JAX check tests
    np.dtype("int4"), which ml_dtypes registers with numpy, so JAX's own
    pack lets the row through at a byte a value; the port refuses as the
    message says."""
    _, tprep = weights
    p = _prompt(14, 21)
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", kv_dtype="int4",
                          **POOL)
    with pytest.raises(th.HandoffFormatError, match="int4"):
        b.export_prefill(p)
    assert len(_stream(b, p)) > 0  # the pool itself serves


@pytest.mark.parametrize("case", ["geometry", "leaves", "prompt_len",
                                  "logits", "interleaved", "adapter"])
def test_adoption_rejections(weights, case):
    """Every mismatch is a ValueError that leaves the pool as it was:
    another max_len (the row length), a missing leaf, another prompt
    length, a logits row of the wrong width, an interleaved server and
    an adapted request (JAX serving.py:1384-1394)."""
    from dnn_tpu_torch.lora import init_lora

    _, tprep = weights
    p = _prompt(4, 20)
    src = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    payload = src.export_prefill(p)
    kw, prompt, match = {}, p, "handoff|prefilled"
    if case == "geometry":
        kw = {"max_len": 48}
    elif case == "leaves":
        payload = {**payload, "row": payload["row"][:1]}
    elif case == "prompt_len":
        prompt = p[:-1]
    elif case == "logits":
        payload = {**payload, "logits_row": payload["logits_row"][:-1]}
    elif case == "interleaved":
        kw = {"prefill_chunk_tokens": 16}
    b = ContinuousBatcher(CFG_T, tprep, device="cpu",
                          **{**POOL, **kw}, **(
                              {"lora_adapters": [init_lora(
                                  0, tprep, rank=2, device="cpu")]}
                              if case == "adapter" else {}))
    sub = {"adapter": 0} if case == "adapter" else {}
    with pytest.raises(ValueError, match=match):
        b.submit(prompt, 4, prefilled=payload, **sub)
    assert b.free_slots() == 3 and b.allocator.n_used == 0


def test_export_beside_an_inflight_interleaved_admission(weights):
    """An interleaved server exports while an admission is mid-prompt: the
    export has the convoy server's fingerprint (JAX's row length) and
    row, and the in-flight request's stream equals the convoy server's."""
    _, tprep = weights
    convoy = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    ilv = ContinuousBatcher(CFG_T, tprep, device="cpu",
                            prefill_chunk_tokens=8, **POOL)
    a, p = _prompt(5, 30), _prompt(6, 21)
    rid = ilv.submit(a, N_NEW)
    ilv.step()  # one 8-token chunk of a's 30 folded: a is in flight
    assert ilv._pending_q
    got = ilv.export_prefill(p)
    want = convoy.export_prefill(p)
    assert got["fingerprint"] == want["fingerprint"]
    assert ilv.handoff_fingerprint() == convoy.handoff_fingerprint()
    for g, w in zip(got["row"] + [got["logits_row"]],
                    want["row"] + [want["logits_row"]]):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(np.asarray(ilv.drain()[rid]),
                                  _stream(convoy, a))


@pytest.fixture(scope="module")
def pair(weights):
    """(prefill daemon, decode daemon) as (address, servicer) pairs; the
    decode daemon's kvput inbox holds at most 2 handoffs."""
    _, tprep = weights
    out, stops = [], []
    try:
        for role, cap in (("prefill", 64), ("decode", 2)):
            port = _free_port()
            _, stop = start_lm_server_in_background(
                CFG_T, tprep, port=port, device="cpu", role=role,
                kv_handoff_cap=cap, **POOL)
            stops.append(stop)
            out.append((f"127.0.0.1:{port}", stop.servicer))
        yield out
    finally:
        for stop in stops:
            stop()


def test_daemon_handoff_unary_and_stream(pair):
    """prefill on the prefill replica, kvput: on the decode replica, then
    a generate with h= — unary and GenerateStream — each equal to the
    decode replica's own plain stream; the decode replica runs no prompt
    chunk for either."""
    (pa, ps), (da, ds) = pair
    assert (ps.role, ds.role) == ("prefill", "decode")
    pc, dc = NodeClient(pa), NodeClient(da)
    p = _prompt(7, 33)
    want = dc.generate(p, max_new_tokens=N_NEW).tolist()
    chunks = ds.batcher.prefill_chunks_run
    for key, stream in (("u1", False), ("s1", True)):
        payload = pc.prefill_kv(p)
        assert payload.dtype == np.uint8
        assert "staged" in dc.put_kv(key, payload)
        got = (list(dc.generate_stream(p, max_new_tokens=N_NEW,
                                       kv_handle=key)) if stream else
               dc.generate(p, max_new_tokens=N_NEW, kv_handle=key).tolist())
        assert got == want
    assert ds.batcher.prefill_chunks_run == chunks
    pc.close()
    dc.close()


@pytest.mark.parametrize("case", ["unknown", "used", "garbage", "geometry",
                                  "empty_key"])
def test_daemon_handoff_errors(pair, weights, case):
    """An unknown or already-used handle, a payload that is no handoff, a
    payload of another geometry and an empty key each answer
    INVALID_ARGUMENT; the daemon lives on."""
    (pa, _), (da, _) = pair
    pc, dc = NodeClient(pa), NodeClient(da)
    p = _prompt(8, 12)
    with pytest.raises(grpc.RpcError) as e:
        if case in ("unknown", "used"):
            if case == "used":
                dc.put_kv("once", pc.prefill_kv(p))
                dc.generate(p, max_new_tokens=2, kv_handle="once")
            dc.generate(p, max_new_tokens=2,
                        kv_handle="once" if case == "used" else "nope")
        elif case == "garbage":
            dc.put_kv("g", np.arange(40, dtype=np.uint8))
        elif case == "geometry":
            _, tprep = weights
            other = ContinuousBatcher(CFG_T, tprep, device="cpu",
                                      **{**POOL, "prompt_pad": 8})
            dc.put_kv("geo", th.pack(other.export_prefill(p)))
        else:
            dc.put_kv("", pc.prefill_kv(p))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert len(dc.generate(p, max_new_tokens=2)) == 2
    pc.close()
    dc.close()


def test_kvput_inbox_ttl_and_cap(pair):
    """The inbox's TTL sweep drops a stale handoff (and the housekeeping
    tick runs it); the cap keeps the newest entries."""
    (pa, _), (da, ds) = pair
    pc, dc = NodeClient(pa), NodeClient(da)
    payload = pc.prefill_kv(_prompt(9, 10))
    dc.put_kv("old", payload)
    assert "old" in ds._kv_handoff
    assert ds._sweep_kv_handoffs(now=1e18) == 1 and not ds._kv_handoff
    try:
        for key in ("a", "b", "c"):
            dc.put_kv(key, payload)
        assert list(ds._kv_handoff) == ["b", "c"]
    finally:
        ds._kv_handoff.clear()
    ds._hk_last = 0.0
    ds._kv_handoff["stale"] = ({}, -1e18)
    ds._housekeeping_tick()
    assert "stale" not in ds._kv_handoff
    pc.close()
    dc.close()


@pytest.mark.parametrize("kind", ["speculative", "interleaved"])
def test_kvput_refused_where_adoption_cannot_ride(weights, pair, kind):
    """kvput on a speculative server and on an interleaved one answers
    INVALID_ARGUMENT (JAX lm_server.py:1636-1647)."""
    _, tprep = weights
    (pa, _), _ = pair
    kw = ({"draft_cfg": CFG_T, "draft_prepared": tprep, "spec_k": 2}
          if kind == "speculative" else {"prefill_chunk_tokens": 16})
    port = _free_port()
    _, stop = start_lm_server_in_background(CFG_T, tprep, port=port,
                                            device="cpu", **POOL, **kw)
    pc, c = NodeClient(pa), NodeClient(f"127.0.0.1:{port}")
    try:
        with pytest.raises(grpc.RpcError) as e:
            c.put_kv("k", pc.prefill_kv(_prompt(10, 9)))
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert kind in e.value.details()
    finally:
        pc.close()
        c.close()
        stop()


def test_node_role_flags(tmp_path, caplog):
    """--role, --kv_handoff_ttl_s and --kv_lease_ttl_s parse with JAX's
    spellings and defaults; --role without --serve_lm exits 1 (JAX
    node.py:470-472); the role and TTLs reach the daemon."""
    import json

    from dnn_tpu_torch import node
    from dnn_tpu_torch.runtime import lm_server

    args = node.build_parser().parse_args(
        ["--node_id", "n", "--config", "c", "--serve_lm", "--role",
         "decode", "--kv_handoff_ttl_s", "5", "--kv_lease_ttl_s", "7"])
    assert (args.role, args.kv_handoff_ttl_s, args.kv_lease_ttl_s) == \
        ("decode", 5.0, 7.0)
    dflt = node.build_parser().parse_args(["--node_id", "n", "--config", "c"])
    assert (dflt.role, dflt.kv_handoff_ttl_s, dflt.kv_lease_ttl_s) == \
        ("both", 120.0, 30.0)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0,
         "address": f"127.0.0.1:{_free_port()}"}]}))
    with caplog.at_level("ERROR", logger="dnn_tpu_torch.node"):
        assert node.main(["--node_id", "node1", "--config", str(cfg),
                          "--role", "prefill"]) == 1
    assert "--role applies to --serve_lm" in caplog.text
    seen = {}

    async def fake_serve_lm(cfg, prepared, *, port, **kw):
        seen.update(kw)
        return 0

    orig = lm_server.serve_lm
    lm_server.serve_lm = fake_serve_lm
    try:
        assert node.main(["--node_id", "node1", "--config", str(cfg),
                          "--serve_lm", "--device", "cpu", "--role",
                          "prefill", "--kv_lease_ttl_s", "9"]) == 0
    finally:
        lm_server.serve_lm = orig
    assert (seen["role"], seen["kv_lease_ttl_s"],
            seen["kv_handoff_ttl_s"]) == ("prefill", 9.0, 120.0)
    with pytest.raises(ValueError, match="role"):
        lm_server.LMServer(CFG_T, None, role="router")
