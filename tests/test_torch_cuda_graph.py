"""The bookkeeping of the batcher's captured decode step, on the CPU.

On the card `ContinuousBatcher.step` replays one CUDA graph of the
family's decode forward (serving.CapturedDecode); the CPU steps eagerly.
What the CPU can check runs here with a stand-in for the capture that
keeps CapturedDecode's contract — (graph, static output, LaunchLog),
where a replay recomputes the captured function into the static output:
the static device buffers are refilled in place every step, the step is
captured once and replayed after, captured again when a bucket grow
replaces the cache, the tokens equal the eager batcher's, a failed
capture raises without a step taken eagerly in its place, and a replay
adds the captured launches to the kernel wrappers' counters. The card
tests (test_torch_cuda_kernels.py) hold one replayed step to the eager
one bit for bit."""

import numpy as np
import pytest
import torch

from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models.gpt import GPTConfig, init
from dnn_tpu_torch.ops.cuda import cached_attention as tca
from dnn_tpu_torch.runtime.serving import CapturedDecode, ContinuousBatcher

CFG = GPTConfig(block_size=64, vocab_size=256, n_layer=2, n_head=4,
                n_embd=64)
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(node):
    """Matrices x8, so that greedy decoding on a random 2-layer model
    gives varied tokens."""
    if isinstance(node, dict):
        return {k: _scaled(v) for k, v in node.items()}
    return node * np.float32(8.0 if node.ndim >= 2 else 1.0)


@pytest.fixture(scope="module")
def prepared():
    return from_jax_params(_scaled(init(5, CFG)), CFG, "cpu")


class FakeGraph:
    """A replay recomputes the captured function into its static output."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


def fake_capture(fn):
    out = fn()
    return FakeGraph(fn, out), out, tca.LaunchLog()


def _requests(b):
    rids = [b.submit(np.arange(1, 12) * 7 % CFG.vocab_size, 20),
            b.submit(np.arange(3, 8), 30)]
    return rids


@pytest.mark.parametrize("layout", [
    {"kv": "paged"}, {"kv": "dense"}, {"kv": "paged", "kv_dtype": "int8"},
    {"kv": "paged", "compute_dtype": torch.bfloat16}],
    ids=["paged", "dense", "paged-int8", "paged-bf16"])
def test_captured_steps_refill_static_buffers(prepared, layout):
    """The graph path gives the eager batcher's tokens; the step is
    captured once and replayed every later step; its static tok / pos /
    active buffers keep their storage and hold each step's host values
    when the step runs."""
    eager = ContinuousBatcher(CFG, prepared, device="cpu",
                              **{**POOL, **layout})
    assert eager._graph_step is None  # the CPU steps eagerly
    rids = _requests(eager)
    want = eager.drain()

    b = ContinuousBatcher(CFG, prepared, device="cpu", **{**POOL, **layout})
    step = b._graph_step = CapturedDecode(POOL["slots"], "cpu",
                                          capture=fake_capture)
    ptrs = (step.tok.data_ptr(), step.pos.data_ptr(),
            step.active.data_ptr())
    seen = []
    decode = b._decode

    def watched(cache, tok, pos, active):
        assert (tok, pos, active) == (step.tok, step.pos, step.active)
        seen.append((tok.clone(), pos.clone(), active.clone()))
        return decode(cache, tok, pos, active)

    b._decode = watched
    rids2 = _requests(b)
    n_steps = 0
    while b.n_active:
        host = (b.tok.copy(), b.pos.copy(), b.active.copy())
        b.step()
        n_steps += 1
        np.testing.assert_array_equal(seen[-1][0].numpy(), host[0])
        np.testing.assert_array_equal(seen[-1][1].numpy(), host[1])
        np.testing.assert_array_equal(seen[-1][2].numpy(), host[2])
    assert (step.tok.data_ptr(), step.pos.data_ptr(),
            step.active.data_ptr()) == ptrs
    assert (step.captures, step.replays) == (1, n_steps - 1)
    for r, r2 in zip(rids, rids2):
        np.testing.assert_array_equal(b.results[r2], want[r])


def test_recapture_on_every_bucket_grow(prepared):
    """A bucketed dense pool replaces its cache on each grow: the next
    step runs eagerly and captures again, over the new cache; the tokens
    equal the eager batcher's."""
    kw = {**POOL, "kv": "dense", "decode_buckets": (16, 32)}
    eager = ContinuousBatcher(CFG, prepared, device="cpu", **kw)
    rids = _requests(eager)
    want = eager.drain()
    b = ContinuousBatcher(CFG, prepared, device="cpu", **kw)
    step = b._graph_step = CapturedDecode(POOL["slots"], "cpu",
                                          capture=fake_capture)
    rids2 = _requests(b)
    caches = []  # each step's cache dict, kept alive so ids stay unique
    while b.n_active:
        b.step()
        caches.append(b.cache)
        assert step._cache is b.cache
    assert b.bucket_grows == eager.bucket_grows == 2
    assert step.captures == len({id(c) for c in caches}) == 3
    for r, r2 in zip(rids, rids2):
        np.testing.assert_array_equal(b.results[r2], want[r])


def test_a_failed_capture_raises(prepared):
    """A capture that fails raises out of step(); the batcher does not
    take the step eagerly instead: no token is emitted, and no graph is
    kept."""
    def broken(fn):
        raise RuntimeError("capture failed")

    b = ContinuousBatcher(CFG, prepared, device="cpu", **POOL)
    step = b._graph_step = CapturedDecode(POOL["slots"], "cpu",
                                          capture=broken)
    b.submit(np.arange(1, 6), 8)
    emitted = list(b._slot_req[0]["emitted"])
    with pytest.raises(RuntimeError, match="capture failed"):
        b.step()
    assert b._slot_req[0]["emitted"] == emitted
    assert step._graph is None and step.captures == 0


def test_replays_count_the_captured_launches():
    """A kernel call while a graph is captured launches nothing and is
    not counted; with a LaunchLog recording, each replay counts every
    recorded call once (in total, by cache type, and as a bf16-q call);
    without one, a captured call is not counted at all."""
    fn = tca.paged_decode_attention
    before = (fn.launches, dict(fn.launches_by_dtype),
              dict(fn.launches_bf16_q))
    log = tca.LaunchLog()
    with tca.recording_launches(log):
        tca._record(fn, "bf16", True, capturing=True)
        tca._record(fn, "int8", False, capturing=True)
    tca._record(fn, "bf16", True, capturing=True)  # no log: dropped
    assert (fn.launches, fn.launches_by_dtype, fn.launches_bf16_q) == before
    assert len(log.calls) == 2
    for _ in range(3):
        log.replayed()
    assert fn.launches == before[0] + 6
    assert fn.launches_by_dtype["bf16"] == before[1]["bf16"] + 3
    assert fn.launches_by_dtype["int8"] == before[1]["int8"] + 3
    assert fn.launches_bf16_q["bf16"] == before[2]["bf16"] + 3
    assert fn.launches_bf16_q["int8"] == before[2]["int8"]
    tca._record(fn, "f32", False, capturing=False)  # an eager launch
    assert fn.launches == before[0] + 7
