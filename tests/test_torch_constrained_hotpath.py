"""Constrained decoding on the port's hot path, on the CPU; mirrors
tests/test_constrained_hotpath.py against the JAX batcher on the same
weights and submit/step script.

  * greedy constrained streams through the convoy path, the mixed step
    (prefill_chunk_tokens) and the mixed step with overlap, on the dense,
    paged and bucketed pools, with two grammars resident and an
    unconstrained rider, are the JAX batcher's token for token; sampled
    ones are the port's convoy streams draw for draw (torch.Generator
    streams, so not JAX's);
  * a decode crossing bucket rungs keeps the walk; eos lands only in
    accepting states, the same on the hot path as on convoy;
  * overlap: step N's tokens surface at call N+1, and a retired slot's
    device row returns to 0;
  * a prefix-cache hit leaves the device row at the post-first-token
    state;
  * the pools: row 0 the unconstrained self-loop, rows in global
    coordinates, LRU eviction of unreferenced entries, never of live
    ones;
  * the pools are written in place: a grammar registered after the step
    was captured (a stand-in capture, as test_torch_cuda_graph) is
    honoured by the next replay;
  * the speculative batcher refuses constraints at construction.
"""

import re as pyre

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime import constrain as jcon
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.ops.cuda import cached_attention as tca
from dnn_tpu_torch.runtime.constrain import TokenConstraint, byte_vocab
from dnn_tpu_torch.runtime.serving import CapturedDecode, ContinuousBatcher
from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher

from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)

CFG_J = jgpt.GPTConfig(block_size=64, vocab_size=64, n_layer=2, n_head=2,
                       n_embd=32)
CFG_T = tgpt.GPTConfig(block_size=64, vocab_size=64, n_layer=2, n_head=2,
                       n_embd=32)
VOCAB = byte_vocab(64)
# the grammars over single-byte tokens of the tiny vocabulary (digits are
# bytes 48-57); compiled once each side: the pools key by id()
PATTERNS = {"DIGITS": r"[0-9]+", "EVENS": r"[02468]{3}",
            "ODDS": r"[13579]+"}
T_C = {k: TokenConstraint.from_regex(p, VOCAB) for k, p in PATTERNS.items()}
J_C = {k: jcon.TokenConstraint.from_regex(p, jcon.byte_vocab(64))
       for k, p in PATTERNS.items()}


@pytest.fixture(scope="module")
def model():
    """The JAX init with every matrix x15, so that greedy argmaxes are
    decisive (as test_torch_serving)."""
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(0), CFG_J))
    return (jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J),
            from_jax_params(tree, CFG_T, "cpu"))


def _schedule(c, sampled):
    """Greedy (or sampled) constrained requests, one admitted mid-decode
    under a second grammar that retires by "constraint" under its
    budget, and an unconstrained rider admitted once slots free."""
    def opts(**kw):
        return {k: v for k, v in kw.items()
                if sampled or k not in ("temperature", "top_k")}
    return [
        (range(1, 10), 8, {"seed": 0, "constraint": c["DIGITS"]}, 0),
        (range(2, 8), 8, opts(seed=1, temperature=0.9, top_k=5,
                              constraint=c["DIGITS"]), 0),
        (range(1, 6), 6, opts(seed=2, temperature=1.1,
                              constraint=c["EVENS"]), 3),
        (range(3, 12), 6, {"seed": 3}, 20),
    ]


def _serve(make, schedule, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("constraint_rows", 16)
    srv = make(max_len=64, prompt_pad=8, allow_constraints=True, **kw)
    rids = []
    for prompt, max_new, opts, steps_before in schedule:
        for _ in range(steps_before):
            srv.step()
        rids.append(srv.submit(np.asarray(prompt, np.int32), max_new,
                               **opts))
    srv.drain()
    return [(srv.results[r].tolist(), srv.finish_reasons[r])
            for r in rids], srv


def _port(prep):
    return lambda **kw: ContinuousBatcher(CFG_T, prep, device="cpu", **kw)


def _jax(prep):
    return lambda **kw: JaxBatcher(CFG_J, prep, **kw)


POOLS = {"dense": {"kv": "dense"}, "paged": {"kv": "paged", "block_len": 8},
         "buckets": {"kv": "dense", "decode_buckets": (16, 32)}}


@pytest.mark.parametrize("pool", list(POOLS))
def test_constrained_mixed_parity(model, pool):
    """Greedy: convoy, mixed and mixed + overlap streams all equal the
    JAX batcher's convoy streams. Sampled: the port's mixed and mixed + overlap streams equal
    its convoy ones draw for draw. Every constrained stream full-matches
    its grammar."""
    jprep, tprep = model
    jkw = {"kv": None} if pool != "paged" else {"kv": "paged",
                                                "block_len": 8}
    if pool == "buckets":
        jkw = {"decode_buckets": (16, 32)}
    want, _ = _serve(_jax(jprep), _schedule(J_C, False), **jkw)
    for sampled in (False, True):
        base, _ = _serve(_port(tprep), _schedule(T_C, sampled),
                         **POOLS[pool])
        if not sampled:
            assert base == want
        for extra in ({"prefill_chunk_tokens": 8},
                      {"prefill_chunk_tokens": 8, "overlap": True}):
            got, srv = _serve(_port(tprep), _schedule(T_C, sampled),
                              **POOLS[pool], **extra)
            assert got == base, (sampled, extra)
            assert srv._ilv == 8
        for (toks, _), pat in zip(base[:3], (r"[0-9]+", r"[0-9]+",
                                             r"[02468]{1,3}")):
            assert pyre.fullmatch(pat.encode(), bytes(toks)), toks
    assert base[2][1] == "constraint"


def test_constrained_bucket_rung_crossing(model):
    jprep, tprep = model
    sched = lambda c, t: [  # noqa: E731
        (range(1, 9), 40, {"seed": 7, "constraint": c["DIGITS"], **t}, 0),
        (range(2, 7), 12, {"seed": 8, "constraint": c["DIGITS"]}, 2)]
    ladder = (16, 32)  # the default ladder of max_len 64 is one rung
    base, srv = _serve(_port(tprep), sched(T_C, {}), kv="dense",
                       decode_buckets=ladder)
    assert srv.bucket_grows == 2
    want, _ = _serve(_jax(jprep), sched(J_C, {}), decode_buckets=ladder)
    assert base == want
    both, _ = _serve(_port(tprep), sched(T_C, {}), kv="dense",
                     decode_buckets=ladder, prefill_chunk_tokens=8,
                     overlap=True)
    assert both == base
    hot = {"temperature": 1.0}
    s_base, _ = _serve(_port(tprep), sched(T_C, hot), kv="dense",
                       decode_buckets=ladder)
    s_both, _ = _serve(_port(tprep), sched(T_C, hot), kv="dense",
                       decode_buckets=ladder, prefill_chunk_tokens=8,
                       overlap=True)
    assert s_both == s_base
    assert pyre.fullmatch(rb"[0-9]+", bytes(s_base[0][0]))


def test_eos_at_accept_state_on_device(model):
    _, tprep = model
    grammar = r"[0-9]{2,6}"
    c = TokenConstraint.from_regex(grammar, VOCAB)
    sched = [(range(1, 8), 10,
              {"seed": s, "temperature": 1.0, "constraint": c}, 0)
             for s in range(3)]
    base, bsrv = _serve(_port(tprep), sched, eos_id=0)
    both, hsrv = _serve(_port(tprep), sched, eos_id=0,
                        prefill_chunk_tokens=8, overlap=True)
    assert both == base
    for toks, reason in base:
        body = bytes(t for t in toks if t != 0)
        assert pyre.fullmatch(grammar.encode(), body), body
        assert reason in ("eos", "constraint", "length")


def test_overlap_ordering_with_constraint_live(model):
    jprep, tprep = model
    kw = dict(slots=2, max_len=64, prompt_pad=8, allow_constraints=True,
              constraint_rows=16)
    srv = ContinuousBatcher(CFG_T, tprep, overlap=True, device="cpu", **kw)
    ref = ContinuousBatcher(CFG_T, tprep, device="cpu", **kw)
    jref = JaxBatcher(CFG_J, jprep, **kw)
    r = srv.submit(np.arange(1, 10), 6, seed=0, constraint=T_C["DIGITS"])
    ref.submit(np.arange(1, 10), 6, seed=0, constraint=T_C["DIGITS"])
    jref.submit(np.arange(1, 10), 6, seed=0, constraint=J_C["DIGITS"])
    assert srv.step() == {} and srv._inflight is not None
    out2 = srv.step()
    assert out2 == ref.step() == jref.step()
    srv.drain()
    ref.drain()
    jref.drain()
    assert srv._inflight is None
    assert srv.results[r].tolist() == ref.results[0].tolist() \
        == jref.results[0].tolist()
    assert srv.finish_reasons[r] == jref.finish_reasons[0]
    assert int(srv._crow_d[0]) == 0
    assert srv._ctab_entries[id(T_C["DIGITS"])]["refs"] == 0


def test_constraint_retires_exactly_once_under_overlap(model):
    """A grammar that completes (EVENS: three tokens) under overlap
    retires with "constraint" once; the garbage step dispatched past it
    commits nothing for it, and the next request in its slot starts at
    the unconstrained row."""
    _, tprep = model
    srv = ContinuousBatcher(CFG_T, tprep, slots=1, max_len=64, prompt_pad=8,
                            allow_constraints=True, constraint_rows=16,
                            overlap=True, device="cpu")
    r0 = srv.submit(np.arange(1, 6), 20, constraint=T_C["EVENS"])
    committed = []
    while srv.n_active:
        committed.append(srv.step())
    srv.flush_overlap()
    assert srv.finish_reasons[r0] == "constraint"
    assert len(srv.results[r0]) == 3
    assert sum(len(v) if isinstance(v, list) else 1
               for out in committed for k, v in out.items() if k == r0) == 2
    assert int(srv._crow_d[0]) == 0
    r1 = srv.submit(np.arange(2, 9), 4)
    srv.drain()
    plain = ContinuousBatcher(CFG_T, tprep, slots=1, max_len=64,
                              prompt_pad=8, device="cpu")
    p1 = plain.submit(np.arange(2, 9), 4)
    assert srv.results[r1].tolist() == plain.drain()[p1].tolist()


def test_prefix_cache_adoption_installs_dfa_state(model):
    _, tprep = model
    srv = ContinuousBatcher(CFG_T, tprep, slots=2, max_len=64, prompt_pad=8,
                            allow_constraints=True, constraint_rows=16,
                            prefix_cache=4, device="cpu")
    prompt = np.arange(1, 17)
    r0 = srv.submit(prompt, 6, seed=5, constraint=T_C["DIGITS"])
    srv.drain()
    hits0 = srv.prefix_hits
    r1 = srv.submit(prompt, 6, seed=5, constraint=T_C["DIGITS"])
    assert srv.prefix_hits == hits0 + 1
    slot = next(i for i, q in enumerate(srv._slot_req)
                if q is not None and q["rid"] == r1)
    off = srv._ctab_entries[id(T_C["DIGITS"])]["off"]
    assert int(srv._crow_d[slot]) == off + srv._slot_req[slot]["c_state"]
    srv.drain()
    assert srv.results[r1].tolist() == srv.results[r0].tolist()


def test_speculative_rejection_still_loud(model):
    _, tprep = model
    with pytest.raises(ValueError, match="constraint"):
        SpeculativeBatcher(CFG_T, tprep, CFG_T, tprep, spec_k=2, slots=2,
                           max_len=64, prompt_pad=8, allow_constraints=True,
                           device="cpu")


def test_transition_pool_lru_eviction_golden(model):
    _, tprep = model
    srv = ContinuousBatcher(CFG_T, tprep, slots=2, max_len=64, prompt_pad=8,
                            allow_constraints=True, constraint_rows=8,
                            device="cpu")
    assert not srv._ctrans[0].any(), "row 0 = self-loop"
    assert srv._ctable.dtype == torch.bool and srv._ctrans.dtype == torch.int32
    ptrs = (srv._ctable.data_ptr(), srv._ctrans.data_ptr())
    off_d = srv._ctab_register(T_C["DIGITS"])
    off_e = srv._ctab_register(T_C["EVENS"])
    want = T_C["DIGITS"].trans_table(srv.eos_id) + np.int32(off_d)
    np.testing.assert_array_equal(
        srv._ctrans[off_d:off_d + want.shape[0]].numpy(), want)
    np.testing.assert_array_equal(
        srv._ctable[off_e:off_e + T_C["EVENS"].table.shape[0]].numpy(),
        T_C["EVENS"].mask_table(srv.eos_id))
    srv._ctab_release(T_C["DIGITS"])
    assert srv._ctab_entries[id(T_C["DIGITS"])]["refs"] == 0
    off_p = srv._ctab_register(T_C["ODDS"])
    assert id(T_C["DIGITS"]) not in srv._ctab_entries
    assert id(T_C["EVENS"]) in srv._ctab_entries
    want_p = T_C["ODDS"].trans_table(srv.eos_id) + np.int32(off_p)
    np.testing.assert_array_equal(
        srv._ctrans[off_p:off_p + want_p.shape[0]].numpy(), want_p)
    big = TokenConstraint.from_regex(r"[0-9]{1,5}", VOCAB)
    assert big.table.shape[0] <= srv._ctab_rows - 1
    with pytest.raises(ValueError, match="exhausted"):
        srv._ctab_register(big)
    # the pools were written in place, never replaced
    assert (srv._ctable.data_ptr(), srv._ctrans.data_ptr()) == ptrs


class _Graph:
    """A stand-in CUDA graph: a replay recomputes the captured function
    into its static outputs (as test_torch_cuda_graph's)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


def _capture(fn):
    out = fn()
    return _Graph(fn, out), out, tca.LaunchLog()


def test_grammar_registered_after_capture_is_honoured(model):
    """The step is captured while no grammar is resident; a grammar
    registered afterwards (its rows copied into the pools in place) is
    honoured by the replayed steps: the stream equals the eager
    batcher's and JAX's."""
    jprep, tprep = model
    kw = dict(slots=2, max_len=64, prompt_pad=8, allow_constraints=True,
              constraint_rows=16)
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **kw)
    g = b._graph_step = CapturedDecode(2, "cpu", capture=_capture)
    r0 = b.submit(np.arange(3, 12), 6)
    b.step()
    b.step()
    assert g.captures == 1 and g.replays == 1
    r1 = b.submit(np.arange(1, 10), 8, constraint=T_C["DIGITS"])
    b.drain()
    assert g.captures == 1 and g.replays > 1
    j = JaxBatcher(CFG_J, jprep, **kw)
    j0 = j.submit(np.arange(3, 12), 6)
    j.step()
    j.step()
    j1 = j.submit(np.arange(1, 10), 8, constraint=J_C["DIGITS"])
    j.drain()
    assert b.results[r0].tolist() == j.results[j0].tolist()
    assert b.results[r1].tolist() == j.results[j1].tolist()
    assert pyre.fullmatch(rb"[0-9]+", bytes(b.results[r1].tolist()))
