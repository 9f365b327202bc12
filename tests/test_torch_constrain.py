"""Constrained decoding in the port (dnn_tpu_torch/runtime/constrain.py and
the batcher's device pools) against the JAX package on the CPU; mirrors
tests/test_constrain.py.

  * the regex engine against Python's `re` (the shared cases and a
    randomized sweep), and the compiled tables -- the token table, the
    allowed mask, the device mask and transition tables, the start,
    accepting and reachable states -- bit-equal to JAX's for every
    pattern tested, JSON mode and choice included;
  * the batcher (llama-test, a byte vocabulary of 256): greedy
    constrained streams and finish reasons identical to the JAX
    batcher's; sampled ones full-match their grammar (the draws come
    from torch.Generators, not threefry: parity is in distribution
    only); the submit checks (capability, vocabulary, a grammar-relevant
    eos, an empty language), the bias composing within the grammar, the
    pool's hit, refcount, LRU eviction and exhaustion, the device row
    mirroring the host walk;
  * the daemon's JSON mode: j= parsed, compiled once per depth over the
    tokenizer's vocab_bytes, served over gRPC; a tokenizer without a
    byte map refused;
  * the speculative batcher refusing constraints.
"""

import json
import re as pyre

import numpy as np
import pytest
import torch

import jax

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama as jllama
from dnn_tpu.runtime import constrain as jcon
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.runtime import constrain
from dnn_tpu_torch.runtime.constrain import (
    TokenConstraint,
    byte_vocab,
    choice_regex,
    compile_regex,
    json_regex,
    match,
    regex_escape,
)
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)

# ----------------------------------------------------------------------
# the engine against Python re, and the tables against JAX's
# ----------------------------------------------------------------------

CASES = [
    (r"abc", ["abc"], ["ab", "abcd", ""]),
    (r"a*b+c?", ["b", "aab", "aabbc"], ["a", "c", "bcc"]),
    (r"[a-f0-9]{2,4}", ["ab", "12ef", "0f0"], ["a", "abcde", "gh"]),
    (r"(ab|cd)*", ["", "ab", "abcdab"], ["a", "abc"]),
    (r"-?(0|[1-9][0-9]*)(\.[0-9]+)?", ["0", "-42", "3.14"],
     ["00", "1.", "-", "+1"]),
    (r"[^xyz]+", ["abc", "123"], ["", "axb"]),
    (r"\d{3}-\d{4}", ["555-1234"], ["5551234", "55-1234"]),
    (r"\w+@\w+\.(com|org)", ["a_1@b.com", "x@y.org"], ["a@b.net", "@b.com"]),
    (r"a.c", ["abc", "a0c"], ["ac", "a\nc"]),
    (r"(x|y){2}z?", ["xy", "yxz"], ["x", "xyzz"]),
    (r"\{\"k\": [0-9]+\}", ['{"k": 7}', '{"k": 42}'], ['{"k": }', "{k: 1}"]),
    (r"a{2,}", ["aa", "aaaa"], ["a", ""]),
    (r"colou?r", ["color", "colour"], ["colouur"]),
]


@pytest.mark.parametrize("pattern,good,bad", CASES)
def test_engine_matches_python_re(pattern, good, bad):
    dfa = compile_regex(pattern)
    for s in good:
        assert pyre.fullmatch(pattern, s), f"test premise: {s!r}"
        assert match(dfa, s.encode()), f"{pattern!r} should accept {s!r}"
    for s in bad:
        assert not pyre.fullmatch(pattern, s), f"test premise: {s!r}"
        assert not match(dfa, s.encode()), f"{pattern!r} should reject {s!r}"


def test_engine_randomized_against_re():
    rs = np.random.RandomState(0)
    for pattern in [r"a*b|c", r"(ab?)+", r"[ab]{1,3}c*", r"a(b|c){2}d?"]:
        dfa = compile_regex(pattern)
        for _ in range(300):
            n = rs.randint(0, 6)
            s = "".join(rs.choice(list("abcd")) for _ in range(n))
            assert bool(pyre.fullmatch(pattern, s)) == match(
                dfa, s.encode()), (pattern, s)


# a vocabulary with multi-byte tokens (BPE-like) and empty specials
MULTI = [b"a", b"b", b"ab", b"abc", b"c", b"", b"{\"", b"\"}", b"12", b"3"]

TABLE_PATTERNS = ([p for p, _, _ in CASES]
                  + [json_regex(d) for d in (0, 1, 2)]
                  + [choice_regex(["positive", "negative", "neutral(ish)"]),
                     r"", r"ab*c", r"[0-9]+", r"[02468]{3}"])


@pytest.mark.parametrize("vocab", ["bytes256", "multi"])
@pytest.mark.parametrize("pattern", TABLE_PATTERNS,
                         ids=[f"p{i}" for i in range(len(TABLE_PATTERNS))])
def test_tables_bit_equal_to_jax(pattern, vocab):
    """TokenConstraint's tables for the same pattern and vocabulary are
    JAX's bit for bit: the DFA, the token table, the allowed mask, the
    device mask and transition tables with and without an eos override,
    the start, accepting and reachable states."""
    vb = byte_vocab(256) if vocab == "bytes256" else MULTI
    got = TokenConstraint.from_regex(pattern, vb)
    want = jcon.TokenConstraint.from_regex(pattern, vb)
    np.testing.assert_array_equal(got.dfa.trans, want.dfa.trans)
    np.testing.assert_array_equal(got.table, want.table)
    assert got.table.dtype == want.table.dtype == np.int32
    np.testing.assert_array_equal(got.allowed, want.allowed)
    np.testing.assert_array_equal(got.accepting, want.accepting)
    np.testing.assert_array_equal(got.reachable, want.reachable)
    assert got.start == want.start and got.vocab_size == want.vocab_size
    for eos in (None, 5):
        np.testing.assert_array_equal(got.mask_table(eos),
                                      want.mask_table(eos))
        t = got.trans_table(eos)
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, want.trans_table(eos))
        np.testing.assert_array_equal(got.mask_row(got.start, eos),
                                      want.mask_row(want.start, eos))


def test_token_table_multibyte_tokens():
    vocab = [b"a", b"b", b"ab", b"abc", b"c", b""]
    c = TokenConstraint.from_regex(r"ab*c", vocab)
    s = c.start
    allowed = c.allowed[s]
    assert allowed[0] and allowed[2] and allowed[3]
    assert not allowed[1] and not allowed[4]
    assert not allowed[5], "empty-byte tokens are always banned"
    s_a = c.advance(s, 0)
    assert c.advance(s_a, 1) >= 0
    s_abc = c.advance(s, 3)
    assert c.is_accepting(s_abc)
    assert not c.has_continuation(s_abc)


def test_json_regex_accepts_real_json():
    assert json_regex(2) == jcon.json_regex(2)
    dfa = compile_regex(json_regex(max_depth=2))
    for obj in [42, -3.5, True, None, "hi there", [1, 2, 3],
                {"a": 1, "b": "x"}, {"outer": [1, "two", None]}, [], {}]:
        s = json.dumps(obj)
        assert match(dfa, s.encode()), s
    for s in ['{"a": }', "[1,, 2]", "tru", '"unterminated', "01"]:
        assert not match(dfa, s.encode()), s
    assert not match(dfa, json.dumps([[[1]]]).encode())


def test_choice_and_escape_match_jax():
    opts = ["positive", "negative", "neutral(ish)"]
    assert choice_regex(opts) == jcon.choice_regex(opts)
    assert regex_escape("a.b{c") == jcon.regex_escape("a.b{c")
    dfa = compile_regex(choice_regex(opts))
    for o in opts:
        assert match(dfa, o.encode())
    assert not match(dfa, b"positiv")
    assert not match(dfa, b"neutralXishX"), "metachars match literally"
    assert match(compile_regex(regex_escape("a.b{c")), b"a.b{c")
    with pytest.raises(ValueError):
        choice_regex([])
    assert byte_vocab(300) == jcon.byte_vocab(300)
    assert constrain.NEG_BIG == jcon.NEG_BIG


# ----------------------------------------------------------------------
# the batcher (llama-test: V = 256, a byte vocabulary)
# ----------------------------------------------------------------------

CFG_T, CFG_J = tllama.PRESETS["llama-test"], jllama.PRESETS["llama-test"]
_W: dict = {}


def _weights():
    if not _W:
        tree = jax.tree.map(np.asarray,
                            jllama.init(jax.random.PRNGKey(0), CFG_J))
        _W["jax"] = jgpt.prepare_stacked(jax.tree.map(jax.numpy.asarray,
                                                      tree), CFG_J)
        _W["torch"] = from_jax_params(tree, CFG_T, "cpu")
    return _W


def _batcher(**kw):
    kw.setdefault("slots", 2)
    return ContinuousBatcher(CFG_T, _weights()["torch"],
                             max_len=CFG_T.block_size, prompt_pad=8,
                             allow_constraints=True, device="cpu", **kw)


def _jax_batcher(**kw):
    kw.setdefault("slots", 2)
    return JaxBatcher(CFG_J, _weights()["jax"], max_len=CFG_J.block_size,
                      prompt_pad=8, family=jllama.LlamaFamilyRows(CFG_J),
                      allow_constraints=True, **kw)


def _both(pattern, submits, vocab=None, **kw):
    """The same constrained submits through the port's and JAX's
    batchers (the JAX grammar compiled by the JAX module); returns
    ([(tokens, reason)] port, JAX)."""
    vb = vocab or byte_vocab(CFG_T.vocab_size)
    out = []
    for make, mod in ((_batcher, constrain), (_jax_batcher, jcon)):
        srv = make(**kw)
        c = mod.TokenConstraint.from_regex(pattern, vb)
        rids = [srv.submit(np.asarray(p), max_new_tokens=n, constraint=c,
                           **opts) for p, n, opts in submits]
        srv.drain()
        out.append([([int(t) for t in srv.results[r]],
                     srv.finish_reasons[r]) for r in rids])
    return out


@pytest.mark.parametrize("pattern", [r"[ab]{5}", r"[qz]+", r"[xy]{2,6}",
                                     r"\{\"k\": (true|false|0|[1-9][0-9]{0,2})\}",
                                     json_regex(1)],
                         ids=["ab5", "qz", "xy", "k-object", "json1"])
def test_greedy_constrained_streams_match_jax(pattern):
    """Greedy constrained requests -- the JSON-mode grammar among them --
    give the JAX batcher's tokens and finish reasons, and every
    completed output full-matches its grammar."""
    got, want = _both(pattern, [([65, 66, 67], 24, {}), ([1, 2, 3, 4], 12, {}),
                                ([10, 20], 30, {})], slots=3)
    assert got == want
    dfa = compile_regex(pattern)
    for toks, reason in got:
        if reason == "constraint":
            assert match(dfa, bytes(toks)), toks


def test_constrained_output_matches_grammar_sampled():
    srv = _batcher(temperature=1.0, slots=3)
    pattern = r"[ab]{5}"
    c = TokenConstraint.from_regex(pattern, byte_vocab(CFG_T.vocab_size))
    rids = [srv.submit(np.asarray([65, 66, 67]), max_new_tokens=32,
                       seed=s, constraint=c) for s in (1, 2, 3)]
    srv.drain()
    for rid in rids:
        text = bytes(int(t) for t in srv.results[rid])
        assert pyre.fullmatch(pattern.encode(), text), text
        assert srv.finish_reasons[rid] == "constraint"


def test_constrained_greedy_is_argmax_over_allowed():
    """Greedy + constraint == restrict-then-argmax of the unconstrained
    distribution: the first constrained token is the higher-logprob of
    {q, z} in the unconstrained logprobs record."""
    srv = _batcher()
    c = TokenConstraint.from_regex(r"[qz]+", byte_vocab(CFG_T.vocab_size))
    prompt = np.asarray([1, 2, 3, 4])
    rid = srv.submit(prompt, max_new_tokens=4, constraint=c)
    srv2 = _batcher(logprobs_k=CFG_T.vocab_size)
    rid2 = srv2.submit(prompt, max_new_tokens=4, logprobs=True)
    srv.drain()
    srv2.drain()
    got = srv.results[rid]
    assert all(int(t) in (ord("q"), ord("z")) for t in got)
    ids0 = list(srv2.token_logprobs[rid2]["top_ids"][0])
    want = (ord("q") if ids0.index(ord("q")) < ids0.index(ord("z"))
            else ord("z"))
    assert int(got[0]) == want


def test_json_mode_end_to_end():
    srv = _batcher(temperature=1.0)
    pattern = r"\{\"k\": (true|false|0|[1-9][0-9]{0,2})\}"
    c = TokenConstraint.from_regex(pattern, byte_vocab(CFG_T.vocab_size))
    rid = srv.submit(np.asarray([10, 20]), max_new_tokens=24, seed=7,
                     constraint=c)
    srv.drain()
    obj = json.loads(bytes(int(t) for t in srv.results[rid]).decode())
    assert set(obj) == {"k"}
    assert srv.finish_reasons[rid] == "constraint"


def test_eos_only_in_accepting_states():
    """With an eos configured, sampled streams stop through a real eos
    only where the grammar accepts; greedy ones equal JAX's."""
    eos, pattern = 0, r"[xy]{2,6}"
    srv = _batcher(temperature=1.0, eos_id=eos, slots=4)
    c = TokenConstraint.from_regex(pattern, byte_vocab(CFG_T.vocab_size))
    rids = [srv.submit(np.asarray([5, 6]), max_new_tokens=10, seed=s,
                       constraint=c) for s in range(4)]
    srv.drain()
    for rid in rids:
        toks = [int(t) for t in srv.results[rid]]
        body = bytes(t for t in toks if t != eos)
        assert pyre.fullmatch(pattern.encode(), body), body
        assert srv.finish_reasons[rid] in ("eos", "constraint")
    got, want = _both(pattern, [([5, 6], 10, {})], eos_id=eos)
    assert got == want


def test_constraint_requires_capability_and_matching_vocab():
    srv = ContinuousBatcher(CFG_T, _weights()["torch"], slots=1, max_len=64,
                            prompt_pad=8, device="cpu")
    c = TokenConstraint.from_regex(r"a+", byte_vocab(CFG_T.vocab_size))
    with pytest.raises(ValueError, match="allow_constraints"):
        srv.submit(np.asarray([1]), max_new_tokens=4, constraint=c)
    bad = TokenConstraint.from_regex(r"a+", byte_vocab(128))
    srv2 = _batcher()
    with pytest.raises(ValueError, match="vocab"):
        srv2.submit(np.asarray([1]), max_new_tokens=4, constraint=bad)
    assert srv2.free_slots() == 2 and not srv2._ctab_entries


def test_constraint_rejects_grammar_relevant_eos():
    srv = _batcher(eos_id=ord("x"))
    c = TokenConstraint.from_regex(r"[xy]{3}", byte_vocab(CFG_T.vocab_size))
    with pytest.raises(ValueError, match="eos"):
        srv.submit(np.asarray([1, 2]), max_new_tokens=5, constraint=c)


def test_constraint_accepts_eos_aliased_only_in_unreachable_states():
    vocab = [b"ab", b"b"] + [b""] * (CFG_T.vocab_size - 2)
    c = TokenConstraint.from_regex(r"ab", vocab)
    assert c.allowed[~c.reachable, 1].any()
    assert not c.allowed[c.reachable, 1].any()
    srv = _batcher(eos_id=1)
    rid = srv.submit(np.asarray([3, 4]), max_new_tokens=4, constraint=c)
    srv.drain()
    toks = [int(t) for t in srv.results[rid]]
    assert [t for t in toks if t != 1] == [0]
    assert srv.finish_reasons[rid] in ("eos", "constraint")
    got, want = _both(r"ab", [([3, 4], 4, {})], vocab=vocab, eos_id=1)
    assert got == want


def test_constraint_composes_with_user_logit_bias():
    """The bias steers within the grammar: banning 'a' under [ab]{3}
    gives bbb, greedy and sampled, as JAX's does."""
    srv = _batcher(allow_logit_bias=True, temperature=1.0)
    c = TokenConstraint.from_regex(r"[ab]{3}", byte_vocab(CFG_T.vocab_size))
    rid = srv.submit(np.asarray([9]), max_new_tokens=8, seed=1,
                     constraint=c, logit_bias={ord("a"): -100.0})
    srv.drain()
    assert bytes(int(t) for t in srv.results[rid]) == b"bbb"
    got, want = _both(r"[ab]{3}", [([9], 8, {"logit_bias": {ord("a"): -3.0}})],
                      allow_logit_bias=True)
    assert got == want


def test_empty_string_grammar_serves_empty_match():
    c = TokenConstraint.from_regex(r"", byte_vocab(CFG_T.vocab_size))
    assert not c.allowed[c.start].any() and c.is_accepting(c.start)
    srv = _batcher(eos_id=0)
    rid = srv.submit(np.asarray([5]), max_new_tokens=4, constraint=c)
    srv.drain()
    assert [t for t in srv.results[rid] if t != 0] == []
    assert srv.finish_reasons[rid] == "eos"
    srv2 = _batcher(eos_id=None)
    with pytest.raises(ValueError, match="no first token"):
        srv2.submit(np.asarray([5]), max_new_tokens=4, constraint=c)
    assert srv2.free_slots() == 2


def test_constraint_table_pool_hit_refcount_eviction():
    srv = _batcher(constraint_rows=12)
    v = byte_vocab(CFG_T.vocab_size)
    c1 = TokenConstraint.from_regex(r"[ab]{3}", v)
    n1 = c1.table.shape[0]
    rid = srv.submit(np.asarray([1]), max_new_tokens=8, constraint=c1)
    assert len(srv._ctab_entries) == 1
    e1 = srv._ctab_entries[id(c1)]
    assert e1["refs"] == 1 and e1["n"] == n1 and e1["off"] >= 1
    srv.drain()
    assert e1["refs"] == 0
    assert srv.finish_reasons[rid] == "constraint"
    srv.submit(np.asarray([1]), max_new_tokens=8, constraint=c1)
    assert len(srv._ctab_entries) == 1 and e1["refs"] == 1  # a pool hit
    srv.drain()
    for f in [TokenConstraint.from_regex(r"[cd]{%d}" % k, v) for k in (3, 4)]:
        srv.submit(np.asarray([1]), max_new_tokens=10, constraint=f)
        srv.drain()
    assert id(c1) not in srv._ctab_entries, "the LRU entry should evict"


def test_constraint_pool_rejects_oversized_and_exhausted():
    srv = _batcher(constraint_rows=8)
    v = byte_vocab(CFG_T.vocab_size)
    big = TokenConstraint.from_regex(r"[ab]{20}", v)
    with pytest.raises(ValueError, match="constraint_rows"):
        srv.submit(np.asarray([1]), max_new_tokens=4, constraint=big)
    assert srv.free_slots() == 2
    c1 = TokenConstraint.from_regex(r"[ab]{4}", v)
    c2 = TokenConstraint.from_regex(r"[cd]{4}", v)
    srv.submit(np.asarray([1]), max_new_tokens=8, constraint=c1)
    with pytest.raises(ValueError, match="exhausted"):
        srv.submit(np.asarray([2]), max_new_tokens=8, constraint=c2)
    assert srv.free_slots() == 1  # the failed admission returned its slot
    srv.drain()
    with pytest.raises(ValueError, match="constraint_rows must be >= 2"):
        _batcher(constraint_rows=1)


def test_device_row_mirrors_the_host_walk():
    """Without a bias buffer the constrained path still works (the
    pools are separate), and each slot's device DFA row is its grammar's
    offset plus the host mirror's state; a retired slot's row is 0."""
    srv = _batcher(slots=2)
    assert srv._bias is None
    c = TokenConstraint.from_regex(r"[ab]{4}", byte_vocab(CFG_T.vocab_size))
    srv.submit(np.asarray([1]), max_new_tokens=2, constraint=c)
    srv.step()
    off = srv._ctab_entries[id(c)]["off"]
    req = srv._slot_req[0]
    if req is not None:
        assert int(srv._crow_d[0]) == off + req["c_state"]
    srv.drain()
    assert int(srv._crow_d[0]) == 0


def test_choice_constraint_picks_exactly_one_label():
    options = ["positive", "negative", "neutral(ish)"]
    c = TokenConstraint.from_regex(choice_regex(options),
                                   byte_vocab(CFG_T.vocab_size))
    srv = _batcher(temperature=1.0, slots=3)
    rids = [srv.submit(np.asarray([11, 12]), max_new_tokens=32, seed=s,
                       constraint=c) for s in (1, 2, 3)]
    srv.drain()
    for rid in rids:
        assert bytes(int(t) for t in srv.results[rid]).decode() in options
        assert srv.finish_reasons[rid] == "constraint"
    got, want = _both(choice_regex(options), [([11, 12], 32, {})])
    assert got == want and got[0][1] == "constraint"


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_constructs_and_serves_on_both_pools(kv):
    """allow_constraints on the paged and the dense pool: the pools'
    shapes and reserved rows, and a greedy constrained stream equal to
    JAX's dense batcher's."""
    srv = ContinuousBatcher(CFG_T, _weights()["torch"], slots=2, max_len=64,
                            prompt_pad=16, block_len=8, kv=kv,
                            allow_constraints=True, constraint_rows=40,
                            device="cpu")
    assert srv.paged == (kv == "paged")
    assert srv._ctable.shape == srv._ctrans.shape == (40, CFG_T.vocab_size)
    assert srv._ctable[0].all() and not srv._ctrans[0].any()
    c = TokenConstraint.from_regex(r"[a-m]{4,9}",
                                   byte_vocab(CFG_T.vocab_size))
    rid = srv.submit(np.asarray([7, 8, 9]), max_new_tokens=12, constraint=c)
    got = srv.drain()[rid].tolist()
    j = _jax_batcher(slots=2)
    jc = jcon.TokenConstraint.from_regex(r"[a-m]{4,9}",
                                         jcon.byte_vocab(CFG_J.vocab_size))
    jr = j.submit(np.asarray([7, 8, 9]), max_new_tokens=12, constraint=jc)
    assert got == j.drain()[jr].tolist()
    assert srv.finish_reasons[rid] == j.finish_reasons[jr]


# ----------------------------------------------------------------------
# the daemon's JSON mode
# ----------------------------------------------------------------------

def test_lm_server_json_mode_wiring():
    """':j=DEPTH': parsed; compiled once per depth over the tokenizer's
    byte map (bit-equal to JAX's json_constraint); a constrained submit
    through the worker; the output json.loads; a depth out of range
    refused; a tokenizer without a byte map gives None."""
    from dnn_tpu_torch.io.tokenizer import ByteTokenizer
    from dnn_tpu_torch.runtime.lm_server import LMServer, parse_gen_options

    assert parse_gen_options("gen:40:7:j=1", 32) == (40, 7, {"json_depth": 1})
    srv = LMServer(CFG_T, _weights()["torch"],
                   tokenizer=ByteTokenizer(CFG_T.vocab_size), slots=2,
                   max_len=CFG_T.block_size, prompt_pad=8, temperature=1.0,
                   allow_constraints=True, device="cpu")
    try:
        b = srv.batcher
        assert b._allow_constraints and b._ctab_rows == 3600
        assert srv.json_constraint(0) is srv.json_constraint(0), "cached"
        want = jcon.TokenConstraint.from_regex(
            jcon.json_regex(1), ByteTokenizer(CFG_T.vocab_size).vocab_bytes())
        np.testing.assert_array_equal(srv.json_constraint(1).table,
                                      want.table)
        with pytest.raises(ValueError, match="depth"):
            srv.json_constraint(9)
        fut = srv.worker.submit(np.asarray([3, 4, 5], np.int32), 40, 7,
                                opts={"constraint": srv.json_constraint(0)})
        json.loads(bytes(int(t) for t in fut.result(timeout=120)).decode())
    finally:
        srv.close()
    srv2 = LMServer(CFG_T, _weights()["torch"], tokenizer=None, slots=1,
                    max_len=32, prompt_pad=8, device="cpu")
    try:
        assert srv2.json_constraint(1) is None
    finally:
        srv2.close()


def test_daemon_serves_json_mode_over_grpc():
    """The daemon over gRPC: a j=1 request (JSON mode) gives JAX's
    batcher's greedy tokens under the same grammar, a complete one
    json.loads; an unconstrained request beside it is unchanged; j=9
    answers INVALID_ARGUMENT; a daemon without a tokenizer refuses j=."""
    import grpc

    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.io.tokenizer import ByteTokenizer
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
    from test_torch_lm_server import _free_port

    prompt = np.asarray([12, 13, 14, 15], np.int32)
    port = _free_port()
    _, stop = start_lm_server_in_background(
        CFG_T, _weights()["torch"], port=port, slots=2, max_len=64,
        prompt_pad=8, tokenizer=ByteTokenizer(CFG_T.vocab_size),
        allow_constraints=True, device="cpu")
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        # the client has no j= keyword (as JAX's): the option rides the
        # request id of SendTensor
        got = client.send_tensor(prompt, request_id="gen:40:j=1",
                                 timeout=120)[1].tolist()
        plain = client.generate(prompt, max_new_tokens=6).tolist()
        with pytest.raises(grpc.RpcError) as e:
            client.send_tensor(prompt, request_id="gen:4:j=9")
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        client.close()
    finally:
        stop()
    j = _jax_batcher(slots=2)
    jc = jcon.TokenConstraint.from_regex(
        jcon.json_regex(1), jcon.byte_vocab(CFG_J.vocab_size))
    jr = j.submit(prompt, max_new_tokens=40, constraint=jc)
    jp = JaxBatcher(CFG_J, _weights()["jax"], slots=1, max_len=64,
                    prompt_pad=8, family=jllama.LlamaFamilyRows(CFG_J))
    jq = jp.submit(prompt, max_new_tokens=6)
    assert got == j.drain()[jr].tolist()
    assert plain == jp.drain()[jq].tolist()
    if j.finish_reasons[jr] == "constraint":
        json.loads(bytes(got).decode())

    port = _free_port()
    _, stop = start_lm_server_in_background(
        CFG_T, _weights()["torch"], port=port, slots=1, max_len=64,
        prompt_pad=8, device="cpu")
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError) as e:
            client.send_tensor(prompt, request_id="gen:4:j=1")
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert "tokenizer" in e.value.details()
        client.close()
    finally:
        stop()


def test_hf_vocab_bytes_real_bpe_constrained_decode():
    """Constrained decoding over a real byte-level BPE vocabulary
    (multi-byte tokens), the tables equal to JAX's and the greedy stream
    equal to JAX's batcher's."""
    import dataclasses

    tokenizers = pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    from dnn_tpu_torch.io.tokenizer import hf_vocab_bytes

    bpe = tokenizers.implementations.ByteLevelBPETokenizer()
    corpus = (['{"name": "value", "count": 123, "flag": true}'] * 40
              + ["hello world, plain text with spaces"] * 40)
    bpe.train_from_iterator(corpus, vocab_size=300, min_frequency=1)
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=bpe._tokenizer)
    vb = hf_vocab_bytes(fast)
    for text in ['{"count": 42}', "hello world", '{"flag": true}']:
        assert b"".join(vb[i] for i in fast.encode(text)) == text.encode()
    n = len(vb)
    cfg_t = dataclasses.replace(CFG_T, vocab_size=n)
    cfg_j = dataclasses.replace(CFG_J, vocab_size=n)
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(3), cfg_j))
    pattern = r"\{\"count\": [0-9]{1,3}\}"
    c = TokenConstraint.from_regex(pattern, vb)
    jc = jcon.TokenConstraint.from_regex(pattern, vb)
    np.testing.assert_array_equal(c.table, jc.table)
    assert any(len(vb[t]) > 1 and c.allowed[:, t].any() for t in range(n))
    prompt = np.asarray(fast.encode("hello world"))
    srv = ContinuousBatcher(cfg_t, from_jax_params(tree, cfg_t, "cpu"),
                            slots=1, max_len=64, prompt_pad=8,
                            allow_constraints=True, device="cpu")
    rid = srv.submit(prompt, max_new_tokens=32, constraint=c)
    srv.drain()
    j = JaxBatcher(cfg_j, jgpt.prepare_stacked(
        jax.tree.map(jax.numpy.asarray, tree), cfg_j), slots=1, max_len=64,
        prompt_pad=8, family=jllama.LlamaFamilyRows(cfg_j),
        allow_constraints=True)
    jr = j.submit(prompt, max_new_tokens=32, constraint=jc)
    j.drain()
    assert srv.results[rid].tolist() == j.results[jr].tolist()
    text = b"".join(vb[int(t)] for t in srv.results[rid]).decode()
    assert set(json.loads(text)) == {"count"}
    assert srv.finish_reasons[rid] == "constraint"


def test_speculative_batcher_rejects_constraints():
    from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher

    cfg = tgpt.PRESETS["gpt2-test"]
    prepared = from_jax_params(
        jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0),
                                           jgpt.PRESETS["gpt2-test"])),
        cfg, "cpu")
    with pytest.raises(ValueError, match="allow_constraints"):
        SpeculativeBatcher(cfg, prepared, cfg, prepared, spec_k=2, slots=1,
                           max_len=32, prompt_pad=8, allow_constraints=True,
                           device="cpu")
    srv = SpeculativeBatcher(cfg, prepared, cfg, prepared, spec_k=2, slots=1,
                             max_len=32, prompt_pad=8, device="cpu")
    c = TokenConstraint.from_regex(r"a+", byte_vocab(cfg.vocab_size))
    with pytest.raises(ValueError, match="constraint"):
        srv.submit(np.asarray([1, 2, 3]), max_new_tokens=4, constraint=c)
    assert torch.equal(srv._crow_d, torch.zeros_like(srv._crow_d))
