"""chip_smoke.py's independent cache-type reference loop on the CPU,
against the port's serving paths on the same weights. On the card the
smoke holds serving runs C (int8 KV) and D (bf16 KV) and the solo
decoder's int8 and bf16 passes to `reference_greedy_cache`; here the
kernels' plain versions run on both sides, so the loop and the batcher
(paged and dense pools) and make_generate must agree: greedy tokens
equal, except from a top-2 near-tie of the reference (gap < 1e-4) on.

Weights: the port's numpy init of gpt2-test with every matrix scaled by
15, so that greedy decoding produces varied tokens instead of one
repeated id."""

import numpy as np
import pytest

import chip_smoke
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.runtime.generate import make_generate
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

CFG = tgpt.PRESETS["gpt2-test"]
N_NEW = 9


@pytest.fixture(scope="module")
def prepared():
    tree = tgpt.init(0, CFG)

    def scaled(t):
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        return t * np.float32(15.0) if t.ndim >= 2 else t
    return from_jax_params(scaled(tree), CFG, "cpu")


def _prompts():
    """Lengths 5 / 20 / 37: one prefill chunk of 16, two, three with a
    padded tail."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, n).tolist() for n in (5, 20, 37)]


def _agree(got, want, gaps):
    assert len(got) == len(want)
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            assert gaps[j] < 1e-4, (j, got, want, gaps[j])
            return


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_cache_reference_matches_the_batcher(prepared, kv, kv_dtype):
    prompts = _prompts()
    b = ContinuousBatcher(CFG, prepared, slots=3, max_len=64, prompt_pad=16,
                          block_len=8, device="cpu", kv=kv, kv_dtype=kv_dtype)
    assert b.paged == (kv == "paged")
    rids = [b.submit(p, N_NEW) for p in prompts]
    res = b.drain()
    for rid, p in zip(rids, prompts):
        want, gaps = chip_smoke.reference_greedy_cache(
            prepared, CFG, p, N_NEW, "cpu", kv_dtype)
        assert len(set(want)) > 1  # varied tokens: the check means something
        _agree(np.asarray(res[rid]).tolist(), want, gaps)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cache_reference_matches_make_generate(prepared, kv_dtype):
    prompt = _prompts()[2]
    gen = make_generate(CFG, max_new_tokens=N_NEW, kv_dtype=kv_dtype,
                        device="cpu")
    got = gen(prepared, [prompt])[0].tolist()
    want, gaps = chip_smoke.reference_greedy_cache(prepared, CFG, prompt,
                                                   N_NEW, "cpu", kv_dtype)
    _agree(got, want, gaps)


def test_cache_reference_refuses_other_types(prepared):
    with pytest.raises(ValueError, match="bf16 or int8"):
        chip_smoke.reference_greedy_cache(prepared, CFG, [1, 2], 2, "cpu",
                                          "f32")
