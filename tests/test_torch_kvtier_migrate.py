"""Block migration of the port (kvtier/migrate.py, the batcher's
kvtier_export / kvtier_adopt / stage_prefix, the daemon's kvstage,
kvlease, kvfetch:, kvack: and kvpull) on the CPU against the JAX
package's: pack_blocks BYTE-EQUAL to JAX's in f32, bf16, int8 and int4,
each package's unpack reading the other's payloads, the lease table's
transitions equal to JAX's protocol table, and — on the same weights
and the same script — equal fingerprints, exported blocks, block
accounting, prompt chunks and follow-up greedy streams, both ways."""

import socket

import grpc
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.kvtier import migrate as jm
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.kvtier import migrate as tm
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

from test_torch_llama import one_torch_thread  # noqa: F401 — autouse

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
BP = 8
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=BP,
            prefix_cache=16)
N_NEW = 8


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


def _stream(b, prompt, **kw):
    rid = b.submit(prompt, N_NEW, **kw)
    return np.asarray(b.drain()[rid])


def _leaf(name, rng):
    shape = (2, 2, 3, BP, 5)
    if name == "float32":
        return rng.standard_normal(shape).astype(np.float32)
    if name == "bfloat16":
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    lo, hi = (-8, 8) if name == "int4" else (-127, 128)
    return rng.integers(lo, hi, shape).astype(np.int8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_pack_blocks_byte_equal_to_jax(dtype):
    """The same numpy leaves, tokens and logits rows packed by both
    packages give the same bytes (int4 nibble-packed, under a byte an
    element); each package's unpack reads the other's payload back to
    the leaves."""
    rng = np.random.default_rng(0)
    k, v = _leaf(dtype, rng), _leaf(dtype, rng)
    pl = {"tokens": np.arange(2 * BP, dtype=np.int32), "block_len": BP,
          "leaves": {"k": k, "v": v},
          "logit_rows": {0: np.arange(7.0, dtype=np.float32),
                         1: -np.arange(7.0, dtype=np.float32)},
          "fingerprint": {"leaves": {"k": [list(k.shape), dtype],
                                     "v": [list(v.shape), dtype]}}}
    wire = tm.pack_blocks(pl)
    assert bytes(wire) == bytes(jm.pack_blocks(pl))
    if dtype == "int4":
        # half the leaf bytes of the same values sent as int8
        fp8 = {"leaves": {n: [list(k.shape), "int8"] for n in "kv"}}
        wire8 = tm.pack_blocks({**pl, "fingerprint": fp8})
        assert wire8.size - wire.size >= (k.size + v.size) // 2 - 16
    ours, theirs = tm.unpack_blocks(jm.pack_blocks(pl)), jm.unpack_blocks(wire)
    for name, want in (("k", k), ("v", v)):
        got = ours["leaves"][name]
        if dtype == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(theirs["leaves"][name]).view(np.uint8),
            want.view(np.uint8))
    np.testing.assert_array_equal(ours["tokens"], pl["tokens"])
    np.testing.assert_array_equal(ours["logit_rows"][1].numpy(),
                                  pl["logit_rows"][1])
    assert ours["fingerprint"] == pl["fingerprint"] and ours["block_len"] == BP


@pytest.mark.parametrize("case", ["magic", "truncated", "header"])
def test_unpack_blocks_rejects_garbage_and_truncation(case):
    pl = {"tokens": np.arange(BP, dtype=np.int32), "block_len": BP,
          "leaves": {"k": np.zeros((1, 1, 1, BP, 2), np.float32)},
          "logit_rows": {}, "fingerprint": {}}
    wire = tm.pack_blocks(pl)
    with pytest.raises(tm.MigrateFormatError,
                       match={"magic": "bad magic", "truncated": "truncated",
                              "header": "JSON"}[case]):
        if case == "magic":
            tm.unpack_blocks(np.frombuffer(b"nonsense bytes!!", np.uint8))
        elif case == "truncated":
            tm.unpack_blocks(wire[:wire.size - 8])
        else:
            bad = bytearray(wire.tobytes())
            bad[12] = ord("x")  # the JSON header's opening brace
            tm.unpack_blocks(np.frombuffer(bytes(bad), np.uint8))
    assert issubclass(tm.MigrateFormatError, ValueError)


def test_lease_lifecycle_ttl_and_protocol_table():
    """offer -> fetch (pulling) -> ack (released); a second ack finds
    nothing; an abandoned offer (offered or pulling) expires at the TTL
    and is reclaimed; the transition table equals JAX's KVLEASE."""
    from dnn_tpu.analysis.protocol import KVLEASE

    assert set(tm.TRANSITIONS) == {(e.src, e.event, e.dst)
                                   for e in KVLEASE.edges}
    lt = tm.LeaseTable(ttl_s=30.0, use_shm=False)
    meta = lt.offer(b"payload-bytes")
    assert lt.state(meta["lease"]) == "offered"
    assert lt.fetch(meta["lease"]) == b"payload-bytes"
    assert lt.state(meta["lease"]) == "pulling"
    assert lt.ack(meta["lease"]) and lt.n_leases == 0
    assert not lt.ack(meta["lease"])
    m2, m3 = lt.offer(b"x" * 64), lt.offer(b"y")
    lt.fetch(m2["lease"])
    assert lt.sweep(now=1e18) == 2 and lt.n_leases == 0
    with pytest.raises(KeyError):
        lt.fetch(m3["lease"])
    lease = tm.Lease("L", b"", 1.0)
    with pytest.raises(ValueError, match="no 'lease_release' edge"):
        lease.move("lease_release")


def test_lease_shm_rung_nonce_proof():
    pub = tm.publish_shm(b"block-bytes")
    if pub is None:
        pytest.skip("no POSIX shm on this platform")
    name, nonce, seg = pub
    try:
        assert tm.attach_shm(name, nonce, 11) == b"block-bytes"
        with pytest.raises(ValueError, match="nonce"):
            tm.attach_shm(name, "00" * 16, 11)
    finally:
        seg.close()
        seg.unlink()


def _accounting(b, jax_side):
    alloc = b._allocator if jax_side else b.allocator
    return (alloc.n_used, alloc.high_water, b._prefix_store.n_blocks,
            b.prefill_chunks_run, b.prefix_hits, b.prefix_misses,
            b._prefix_store.remote_block_hits)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8", "int4"])
def test_stage_export_adopt_match_jax(weights, kv_dtype):
    """stage_prefix on a donor of each package (equal stats and
    fingerprints, exported blocks within 1e-5 of the row's scale, int8
    values equal; an int4 pool's blocks leave as their int8 values and
    cross the wire nibble-packed, the fingerprint saying "int4"), each package's export adopted by the OTHER's adopter
    through the wire codec: equal adopted counts, a second adoption 0,
    and after a follow-up generate of the prompt equal block accounting
    (blocks used, high water, resident, chunks, hits, remote hits) and
    greedy streams equal to the donor's local stream."""
    jprep, tprep = weights
    jkv = {"f32": None, "int8": "int8", "int4": "int4"}[kv_dtype]
    tkv = None if kv_dtype == "f32" else kv_dtype

    def jax_b():
        return JaxBatcher(CFG_J, jprep, kv="paged", kv_dtype=jkv, **POOL)

    def port_b():
        return ContinuousBatcher(CFG_T, tprep, device="cpu", kv_dtype=tkv,
                                 **POOL)

    p = _prompt(1, 37)
    jd, td = jax_b(), port_b()
    assert td.kvtier_fingerprint() == jd.kvtier_fingerprint()
    assert td.stage_prefix(p) == jd.stage_prefix(p) == {
        "covered_blocks": 4, "staged_blocks": 4, "computed_chunks": 2}
    assert td.stage_prefix(p)["staged_blocks"] == 0
    je, te = jd.kvtier_export(p), td.kvtier_export(p)
    assert set(te["leaves"]) == set(je["leaves"])
    for name, got in te["leaves"].items():
        want = torch.from_numpy(np.asarray(je["leaves"][name]))
        assert got.shape == want.shape and got.dtype == want.dtype
        if got.dtype == torch.int8:
            assert torch.equal(got, want)
        else:
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert sorted(te["logit_rows"]) == sorted(je["logit_rows"])
    ja, ta = jax_b(), port_b()
    assert ta.kvtier_adopt(tm.unpack_blocks(jm.pack_blocks(je))) == 4
    assert ja.kvtier_adopt(jm.unpack_blocks(tm.pack_blocks(te))) == 4
    assert ta.kvtier_adopt(tm.unpack_blocks(jm.pack_blocks(je))) == 0
    assert _accounting(ta, False) == _accounting(ja, True)
    want = _stream(jd, p)
    for b in (ta, ja):
        np.testing.assert_array_equal(_stream(b, p), want)
    assert _accounting(ta, False) == _accounting(ja, True)
    assert ta.prefix_hits == 1 and ta._prefix_store.remote_block_hits == 4


def test_adopted_block_aligned_prompt_is_a_full_hit(weights):
    """A block-aligned prompt staged on a donor and adopted: the follow-up
    on either runs zero chunks (the staged or adopted logits row), the
    streams equal; a geometry mismatch (an int8 adopter) is refused."""
    _, tprep = weights
    donor = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    ado = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    p = _prompt(2, 24)
    assert donor.stage_prefix(p)["staged_blocks"] == 3
    payload = tm.unpack_blocks(tm.pack_blocks(donor.kvtier_export(p)))
    assert ado.kvtier_adopt(payload) == 3
    chunks = ado.prefill_chunks_run, donor.prefill_chunks_run
    np.testing.assert_array_equal(_stream(ado, p, seed=3, temperature=0.8),
                                  _stream(donor, p, seed=3, temperature=0.8))
    assert (ado.prefill_chunks_run, donor.prefill_chunks_run) == chunks
    other = ContinuousBatcher(CFG_T, tprep, device="cpu", kv_dtype="int8",
                              **POOL)
    with pytest.raises(ValueError, match="geometry mismatch"):
        other.kvtier_adopt(payload)
    assert other.allocator.n_used == 0


def test_donor_death_mid_migration_zero_leaks(weights):
    """The donor's lease expires between kvlease and the fetch: the pull
    raises, the adopter's accounting is untouched, and its follow-up
    prefills again with the donor's stream."""
    _, tprep = weights
    donor = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    ado = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    p = _prompt(3, 16)
    want = _stream(donor, p)
    lt = tm.LeaseTable(ttl_s=30.0, use_shm=False)
    meta = lt.offer(tm.pack_blocks(donor.kvtier_export(p)).tobytes())
    lt.sweep(now=1e18)

    class DeadDonor:
        def kv_lease(self, tokens, timeout=None):
            return dict(meta)

        def kv_fetch(self, lease_id, timeout=None):
            return np.frombuffer(lt.fetch(lease_id), np.uint8)

        def kv_ack(self, lease_id, timeout=None):
            raise ConnectionError("donor dead")

    before = (ado.allocator.n_used, ado.allocator.high_water,
              ado._prefix_store.n_blocks)
    with pytest.raises(KeyError):
        tm.pull_blocks(DeadDonor(), p)
    assert (ado.allocator.n_used, ado.allocator.high_water,
            ado._prefix_store.n_blocks) == before == (0, 0, 0)
    np.testing.assert_array_equal(_stream(ado, p), want)


@pytest.fixture(scope="module")
def replicas(weights):
    """(donor, adopter) port daemons with the radix store, as (address,
    servicer) pairs."""
    _, tprep = weights
    out, stops = [], []
    try:
        for _ in range(2):
            port = _free_port()
            _, stop = start_lm_server_in_background(
                CFG_T, tprep, port=port, device="cpu", kv="paged", **POOL)
            stops.append(stop)
            out.append((f"127.0.0.1:{port}", stop.servicer))
        yield out
    finally:
        for stop in stops:
            stop()


@pytest.mark.parametrize("rung", ["shm", "grpc"])
def test_daemon_stage_pull_generate(replicas, rung):
    """kvstage on the donor, kvpull on the adopter (over shm, or the grpc
    rung forced), then a generate on the adopter that runs only the tail
    chunk and equals the donor's stream; the donor's lease is released
    by the ack; a second pull adopts nothing."""
    (da, ds), (aa, as_) = replicas
    dc, ac = NodeClient(da), NodeClient(aa)
    p = _prompt(10 if rung == "shm" else 11, 37)
    assert '"staged_blocks": 4' in dc.kv_stage(p)
    status = ac.kv_pull_from(da, p, rung=None if rung == "shm" else "grpc")
    assert status.startswith("[lm] ok: kvpull adopted 4 blocks")
    assert status.endswith(f"over {rung}")
    assert ds._kvtier_leases.n_leases == 0
    chunks = as_.batcher.prefill_chunks_run
    np.testing.assert_array_equal(ac.generate(p, max_new_tokens=N_NEW),
                                  dc.generate(p, max_new_tokens=N_NEW))
    assert as_.batcher.prefill_chunks_run - chunks == 1
    assert "adopted 0 blocks" in ac.kv_pull_from(da, p)
    dc.close()
    ac.close()


def test_daemon_lease_fetch_ack_and_errors(replicas):
    """kvlease's meta, kvfetch:'s bytes (a payload the codec reads),
    kvack: releasing the lease; NOT_FOUND for an unknown lease and for a
    prefix with nothing resident; a pull from a dead donor answers
    kvtier_fallback and leaves the adopter's pool untouched; the KV tier
    refused where the radix store is off."""
    (da, ds), (aa, as_) = replicas
    dc, ac = NodeClient(da), NodeClient(aa)
    p = _prompt(12, 20)
    dc.kv_stage(p)
    meta = dc.kv_lease(p)
    assert (meta["blocks"], meta["n_tokens"]) == (2, 16)
    payload = tm.unpack_blocks(dc.kv_fetch(meta["lease"]))
    assert ds._kvtier_leases.state(meta["lease"]) == "pulling"
    assert payload["leaves"]["k"].shape[1] == 2 and payload["block_len"] == BP
    assert "released" in dc.kv_ack(meta["lease"])
    assert "already gone" in dc.kv_ack(meta["lease"])
    for call in (lambda: dc.kv_fetch("nope"),
                 lambda: dc.kv_lease(_prompt(13, 20))):
        with pytest.raises(grpc.RpcError) as e:
            call()
        assert e.value.code() == grpc.StatusCode.NOT_FOUND
    alloc = as_.batcher.allocator
    before = (alloc.n_used, alloc.high_water)
    status = ac.kv_pull_from(f"127.0.0.1:{_free_port()}", p, timeout=30)
    assert status.startswith("[lm] kvtier_fallback")
    assert (alloc.n_used, alloc.high_water) == before
    with pytest.raises(grpc.RpcError) as e:
        ac.send_tensor(np.zeros((1,), np.int32), request_id="kvpull")
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    dc.close()
    ac.close()


def test_kvtier_refused_without_the_radix_store(weights):
    _, tprep = weights
    port = _free_port()
    _, stop = start_lm_server_in_background(
        CFG_T, tprep, port=port, device="cpu",
        **{**POOL, "prefix_cache": 0})
    c = NodeClient(f"127.0.0.1:{port}")
    try:
        for rid in ("kvstage", "kvlease", "kvfetch:L1", "kvack:L1",
                    "kvpull"):
            with pytest.raises(grpc.RpcError) as e:
                c.send_tensor(_prompt(14, 9), request_id=rid)
            assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            assert "KV tier is off" in e.value.details()
    finally:
        c.close()
        stop()


def test_jax_donor_port_adopter_over_kvpull(weights, replicas):
    """One cross-package daemon case: a JAX daemon stages a prompt, the
    port's daemon pulls it (kvpull over the wire through the JAX donor's
    kvlease/kvfetch/kvack) and adopts it, and its follow-up stream equals
    the JAX daemon's."""
    from dnn_tpu.comm.client import NodeClient as JaxClient
    from dnn_tpu.runtime.lm_server import (
        start_lm_server_in_background as jax_start_lm,
    )

    jprep, _ = weights
    _, (aa, as_) = replicas
    pj = _free_port()
    _, stop_j = jax_start_lm(CFG_J, jprep, port=pj, kv="paged", **POOL)
    jc, ac = JaxClient(f"127.0.0.1:{pj}", breaker=False), NodeClient(aa)
    try:
        assert jc.wait_healthy(deadline=60)
        p = _prompt(15, 29)
        jc.kv_stage(p)
        status = ac.kv_pull_from(f"127.0.0.1:{pj}", p)
        assert status.startswith("[lm] ok: kvpull adopted 3 blocks"), status
        chunks = as_.batcher.prefill_chunks_run
        np.testing.assert_array_equal(
            ac.generate(p, max_new_tokens=N_NEW),
            jc.generate(p, max_new_tokens=N_NEW, timeout=60))
        assert as_.batcher.prefill_chunks_run - chunks == 1
    finally:
        jc.close()
        ac.close()
        stop_j()
