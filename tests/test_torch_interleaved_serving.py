"""Interleaved chunked prefill, the overlapped dispatch, the logit bias
and logprobs of the port's batcher on the CPU, against the JAX batcher
on the same weights and the same submit/step script.

  * mixed == convoy: admission through the mixed step
    (prefill_chunk_tokens — one chunk of the queue head's prompt folded
    into each step, the fused finish, the first token read back at the
    next commit) gives the convoy path's greedy streams, on dense, paged
    and bucketed pools, with and without overlap, and every step()
    returns what the JAX batcher's returns;
  * the edges: a multi-chunk prompt, eos on the deferred first token, a
    pending request cancelled, the constructor's checks, an idempotent
    flush_overlap, the daemon streaming interleaved and overlapped
    tokens;
  * bias and logprobs: biased greedy streams equal JAX's; logprobs within
    1e-5 of JAX's token_logprobs, first token included; claim's 3-tuple;
  * the mixed step's CUDA-graph bookkeeping with a stand-in capture, as
    test_torch_cuda_graph does for the decode step.

Weights: the JAX init with every matrix scaled by 15 (as
test_torch_serving)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama as jllama
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.ops.cuda import cached_attention as tca
from dnn_tpu_torch.runtime.generate import _sample_rows
from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
from dnn_tpu_torch.runtime.serving import CapturedDecode, ContinuousBatcher

from test_torch_llama import (  # one_torch_thread: the autouse fixture
    drawn_tree,
    jax_prepared,
    one_torch_thread,  # noqa: F401
)

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)
LAYOUTS = {"paged": {"kv": "paged"}, "dense": {"kv": "dense"},
           "buckets": {"kv": "dense", "decode_buckets": (16, 32)}}


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(0), CFG_J))
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)
    return jprep, from_jax_params(tree, CFG_T, "cpu")


def _prompt(seed, n, vocab=CFG_T.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, n)


def _script(b, vocab=CFG_T.vocab_size, **opts):
    """Requests of 5, 20 and 37 tokens (one chunk of 8, three, five with
    a padded tail), the third admitted mid-decode, and a fourth once the
    pool has drained. Returns (each request's tokens, every step()'s
    return)."""
    steps = []
    r0 = b.submit(_prompt(0, 5, vocab), 10, **opts)
    r1 = b.submit(_prompt(1, 20, vocab), 12, **opts)
    for _ in range(3):
        steps.append(b.step())
    r2 = b.submit(_prompt(2, 37, vocab), 9, **opts)
    while b.n_active:
        steps.append(b.step())
    steps.append(b.flush_overlap())
    r3 = b.submit(_prompt(3, 13, vocab), 4, **opts)
    while b.n_active:
        steps.append(b.step())
    steps.append(b.flush_overlap())
    return [np.asarray(b.results[r]).tolist() for r in (r0, r1, r2, r3)], \
        steps


_CONVOY = {}  # layout -> the port's convoy streams of _script


@pytest.mark.parametrize("ilv,overlap", [(8, False), (16, False), (8, True),
                                         (16, True), (0, True)],
                         ids=["ilv8", "ilv16", "ilv8-overlap",
                              "ilv16-overlap", "convoy-overlap"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_and_overlap_match_jax(weights, layout, ilv, overlap):
    jprep, tprep = weights
    kw = dict(prefill_chunk_tokens=ilv, overlap=overlap, **POOL,
              **LAYOUTS[layout])
    want, want_steps = _script(JaxBatcher(CFG_J, jprep, **kw))
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **kw)
    got, got_steps = _script(b)
    assert got == want
    assert got_steps == want_steps
    if layout not in _CONVOY:  # greedy: one convoy run a layout serves all
        _CONVOY[layout] = _script(ContinuousBatcher(
            CFG_T, tprep, device="cpu", **POOL, **LAYOUTS[layout]))[0]
    assert _CONVOY[layout] == got  # mixed == convoy
    if ilv:
        assert b.prefill_chunks_run == sum(-(-n // ilv)
                                           for n in (5, 20, 37, 13))


def test_llama_mixed_and_overlap_match_jax():
    """llama-test through the mixed step (RoPE at the chunk's start held
    in a device buffer) with overlap: streams and step returns equal the
    JAX batcher's with LlamaFamilyRows."""
    name = "llama-test"
    cfg_j, cfg_t = jllama.PRESETS[name], tllama.PRESETS[name]
    tree = drawn_tree(name, 1, 0.3)
    kw = dict(prefill_chunk_tokens=8, overlap=True, kv="paged", **POOL)
    want = _script(JaxBatcher(cfg_j, jax_prepared(name, tree),
                              family=jllama.LlamaFamilyRows(cfg_j), **kw),
                   cfg_t.vocab_size)
    got = _script(ContinuousBatcher(cfg_t, from_jax_params(tree, cfg_t,
                                                           "cpu"),
                                    device="cpu", **kw), cfg_t.vocab_size)
    assert got == want


def test_multi_chunk_prompt_and_first_token_timing(weights):
    """A 37-token prompt in 8-token chunks: five mixed steps, nothing
    committed for it before its fused finish; its first token arrives
    with the next commit, together with its first decode token."""
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu",
                          prefill_chunk_tokens=8, **POOL)
    rid = b.submit(_prompt(2, 37), 6)
    assert b.first_token(rid) is None and b.n_active == 1
    outs = [b.step() for _ in range(5)]
    assert outs == [{}] * 5 and b.prefill_chunks_run == 5
    assert b.first_token(rid) is None  # finished, not yet committed
    first = b.step()[rid]
    assert isinstance(first, list) and len(first) == 2
    assert b.first_token(rid) == first[0]
    b.drain()
    convoy = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    r = convoy.submit(_prompt(2, 37), 6)
    np.testing.assert_array_equal(b.results[rid], convoy.drain()[r])


@pytest.mark.parametrize("overlap", [False, True])
def test_eos_on_the_deferred_first_token(weights, overlap):
    """eos as the first token of an interleaved admission: the request
    retires at the commit that reads it back, with [eos] and reason
    "eos", and its slot's decode token of that step is discarded — as
    in JAX."""
    jprep, tprep = weights
    probe = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    rid = probe.submit(_prompt(5, 11), 1)
    eos = int(probe.drain()[rid][0])

    def run(b):
        r0 = b.submit(_prompt(6, 9), 6)
        r1 = b.submit(_prompt(5, 11), 6)
        b.drain()
        return [(b.results[r].tolist(), b.finish_reasons[r])
                for r in (r0, r1)]

    kw = dict(prefill_chunk_tokens=8, overlap=overlap, eos_id=eos, **POOL)
    want = run(JaxBatcher(CFG_J, jprep, **kw))
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **kw)
    got = run(b)
    assert got == want and got[1] == ([eos], "eos")
    assert b.allocator.n_used == 0 and b.free_slots() == 3


def test_cancel_a_pending_request(weights):
    """A queued interleaved admission cancelled before its finish leaves
    the queue; its slot and blocks return at once; the next admission
    is served as if it had never been there."""
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu",
                          prefill_chunk_tokens=8, overlap=True, **POOL)
    keep = b.submit(_prompt(0, 5), 6)
    victim = b.submit(_prompt(2, 37), 6)
    b.step()
    b.step()
    assert b.cancel(victim) and b._pending_q == []
    assert b.claim(victim) == (None, "cancelled", None)
    after = b.submit(_prompt(3, 13), 5)
    b.drain()
    assert b.allocator.n_used == 0
    convoy = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    r0, r1 = convoy.submit(_prompt(0, 5), 6), convoy.submit(_prompt(3, 13), 5)
    convoy.drain()
    assert b.results[keep].tolist() == convoy.results[r0].tolist()
    assert b.results[after].tolist() == convoy.results[r1].tolist()


@pytest.mark.parametrize("kwargs,exc,match", [
    ({"prefill_chunk_tokens": -1}, ValueError, ">= 0"),
    ({"prefill_chunk_tokens": 128}, ValueError, "exceeds max_len"),
    ({"prefill_chunk_tokens": 12, "kv": "paged"}, ValueError,
     "must tile block_len"),
    ({"prefill_chunk_tokens": 16, "prefix_cache": 4}, ValueError,
     "does not compose with the prefix cache"),
    ({"prefill_chunk_tokens": 16, "kv": "dense", "prefix_cache": 4},
     ValueError, "does not compose with the prefix cache"),
    # constraints compose with interleaved admission now
    # (tests/test_torch_constrained_hotpath.py); their pool size is
    # still checked
    ({"prefill_chunk_tokens": 16, "allow_constraints": True,
      "constraint_rows": 1}, ValueError, "constraint_rows must be >= 2"),
    ({"logprobs_k": -1}, ValueError, "logprobs_k"),
])
def test_constructor_checks(weights, kwargs, exc, match):
    _, tprep = weights
    with pytest.raises(exc, match=match):
        ContinuousBatcher(CFG_T, tprep, device="cpu", **{**POOL, **kwargs})


def test_flush_overlap_is_idempotent(weights):
    _, tprep = weights
    for overlap in (False, True):
        b = ContinuousBatcher(CFG_T, tprep, device="cpu", overlap=overlap,
                              **POOL)
        rid = b.submit(_prompt(0, 5), 4)
        first = b.step()
        assert first == ({} if overlap else {rid: first[rid]})
        b.drain()
        assert b.flush_overlap() == {} and b.flush_overlap() == {}
        assert len(b.results[rid]) == 4 and b._inflight is None


def _bias_script(b, **opts):
    forced, banned = 5, int(_prompt(9, 1)[0])
    r0 = b.submit(_prompt(3, 9), 7, logit_bias={forced: 100.0}, **opts)
    r1 = b.submit(_prompt(4, 20), 8, repetition_penalty=1.3, **opts)
    for _ in range(2):
        b.step()
    r2 = b.submit(_prompt(5, 13), 6, logit_bias={banned: -100.0, 7: 2.5},
                  **opts)
    b.drain()
    return [b.claim(r) for r in (r0, r1, r2)]


@pytest.mark.parametrize("kw", [
    {"kv": "paged"}, {"kv": "dense", "prefill_chunk_tokens": 8,
                      "overlap": True},
    {"kv": "paged", "prefill_chunk_tokens": 8},
    {"kv": "paged", "prefix_cache": 4}],
    ids=["paged", "dense-ilv-overlap", "paged-ilv", "paged-radix"])
def test_bias_and_logprobs_match_jax(weights, kw):
    """A forced token, a banned one and a mild bias beside an unbiased
    penalized request, every request asking for logprobs: the streams
    and finish reasons equal JAX's, the chosen logprobs and the top-3
    within 1e-5 of JAX's with the same top ids, first token included;
    claim returns JAX's (tokens, reason, token_logprobs)."""
    jprep, tprep = weights
    common = dict(logprobs_k=3, allow_logit_bias=True, **POOL, **kw)
    want = _bias_script(JaxBatcher(CFG_J, jprep, **common), logprobs=True)
    got = _bias_script(ContinuousBatcher(CFG_T, tprep, device="cpu",
                                         **common), logprobs=True)
    assert got[0][0].tolist() == [5] * 7
    for (wt, wr, wl), (gt, gr, gl) in zip(want, got):
        assert (gt.tolist(), gr) == (wt.tolist(), wr)
        assert len(gl["chosen"]) == len(gt)
        np.testing.assert_allclose(gl["chosen"], wl["chosen"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(gl["top_logprobs"], wl["top_logprobs"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(gl["top_ids"], wl["top_ids"])


def test_bias_and_logprobs_options_are_checked(weights):
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    with pytest.raises(ValueError, match="allow_logit_bias"):
        b.submit(_prompt(0, 5), 3, logit_bias={1: 2.0})
    with pytest.raises(ValueError, match="logprobs_k=0"):
        b.submit(_prompt(0, 5), 3, logprobs=True)
    b2 = ContinuousBatcher(CFG_T, tprep, device="cpu",
                           allow_logit_bias=True, **POOL)
    with pytest.raises(ValueError, match="outside"):
        b2.submit(_prompt(0, 5), 3, logit_bias={CFG_T.vocab_size: 1.0})
    assert b.free_slots() == b2.free_slots() == 3
    rid = b2.submit(_prompt(0, 5), 3)
    b2.drain()
    tokens, reason, lps = b2.claim(rid)
    assert len(tokens) == 3 and reason == "length" and lps is None


def test_sample_rows_reads_the_host_rows():
    """_sample_rows samples only the rows the host names: with none it
    is the argmax whatever the device temperatures say (so a greedy pool
    reads nothing back), and a named row draws from its generator."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 50, generator=g)
    temps = torch.tensor([0.9, 0.0, 0.7])
    args = dict(temperature=temps, top_k=torch.tensor([0, 0, 5]),
                top_p=torch.zeros(3), min_p=torch.zeros(3))
    greedy = _sample_rows(logits, [None] * 3, rows=[], **args)
    assert torch.equal(greedy, logits.argmax(-1))
    gens = [torch.Generator().manual_seed(1), None,
            torch.Generator().manual_seed(2)]
    out = _sample_rows(logits, gens, rows=[2], **args)
    assert out[0] == greedy[0] and out[1] == greedy[1]
    assert out[2] in torch.topk(logits[2], 5).indices


class FakeGraph:
    """A replay recomputes the captured function into its static output
    (a tensor, or the mixed step's pair)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        for o, n in (zip(self.out, new) if isinstance(self.out, tuple)
                     else [(self.out, new)]):
            o.copy_(n)


def fake_capture(fn):
    out = fn()
    return FakeGraph(fn, out), out, tca.LaunchLog()


@pytest.mark.parametrize("layout", ["paged", "buckets"])
def test_captured_mixed_steps_keep_the_streams(weights, layout):
    """With a stand-in capture the batcher runs its mixed steps through
    CapturedDecode.mixed: captured once per cache (the bucketed pool
    again at each grow, dropping the graphs over the old cache),
    replayed after, reading the chunk and its start from the static
    buffers; the streams equal the eager batcher's. A failed capture
    raises out of step() with nothing committed."""
    _, tprep = weights
    kw = dict(prefill_chunk_tokens=8, overlap=True, **POOL, **LAYOUTS[layout])
    want = _script(ContinuousBatcher(CFG_T, tprep, device="cpu", **kw))
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **kw)
    step = b._graph_step = CapturedDecode(3, "cpu", capture=fake_capture,
                                          chunk_tokens=8)
    seen = []
    mixed = b._mixed

    def watched(cache, tok, pos, active, row, chunk, start):
        assert (chunk, start) == (step.chunk, step.start)
        seen.append(int(start[0]))
        return mixed(cache, tok, pos, active, row, chunk, start)

    b._mixed = watched
    assert _script(b) == want
    grows = 2 if layout == "buckets" else 0
    assert b.bucket_grows == grows
    assert step.counts["mixed"][0] == 1 + (1 if grows else 0)
    assert sum(step.counts["mixed"]) == b.prefill_chunks_run
    # the 5-token prompt's chunk eagerly and in the capture, then the
    # 20-token prompt's three chunks by replay
    assert seen[:5] == [0, 0, 0, 8, 16]
    assert set(step._graphs) <= {"decode", "mixed"}
    assert all(g[3][0] is b.cache for g in step._graphs.values())

    def broken(fn):
        raise RuntimeError("capture failed")

    b2 = ContinuousBatcher(CFG_T, tprep, device="cpu", **kw)
    b2._graph_step = CapturedDecode(3, "cpu", capture=broken)
    rid = b2.submit(_prompt(0, 5), 4)
    with pytest.raises(RuntimeError, match="capture failed"):
        b2.step()
    assert b2.first_token(rid) is None and b2._graph_step.captures == 0


def test_daemon_streams_interleaved_and_overlapped_tokens(weights):
    """The LM daemon with prefill_chunk_tokens and overlap over gRPC:
    concurrent generate and generate_stream calls return the convoy
    batcher's tokens (a streamed request's first token arrives with a
    later commit, with its first decode token), and b= biases a request."""
    import concurrent.futures
    import socket

    _, tprep = weights
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    prompts = [_prompt(0, 5), _prompt(1, 20), _prompt(2, 37)]
    convoy = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    rids = [convoy.submit(p, 8) for p in prompts]
    convoy.drain()
    want = [convoy.results[r].tolist() for r in rids]
    _thread, stop = start_lm_server_in_background(
        CFG_T, tprep, port=port, device="cpu", prefill_chunk_tokens=8,
        overlap=True, allow_logit_bias=True, **POOL)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=30)
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            futs = [ex.submit(lambda p=p: client.generate(
                        p, max_new_tokens=8, timeout=60).tolist())
                    for p in prompts[:2]]
            futs.append(ex.submit(lambda: [int(t) for t in
                                           client.generate_stream(
                                               prompts[2], max_new_tokens=8,
                                               timeout=60)]))
            got = [f.result() for f in futs]
        forced = client.generate(prompts[0], max_new_tokens=4,
                                 logit_bias={9: 1e9}, timeout=60).tolist()
        client.close()
    finally:
        stop()
    assert got == want
    assert forced == [9] * 4
