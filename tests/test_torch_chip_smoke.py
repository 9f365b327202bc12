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


@pytest.fixture(scope="module")
def cache_refs(prepared):
    """reference_greedy_cache of each prompt and cache type, computed once
    for the module: the paged and dense batchers and make_generate are
    held to the same loops."""
    return {(dt, i): chip_smoke.reference_greedy_cache(prepared, CFG, p,
                                                       N_NEW, "cpu", dt)
            for dt in ("bf16", "int8") for i, p in enumerate(_prompts())}


def _agree(got, want, gaps):
    assert len(got) == len(want)
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            assert gaps[j] < 1e-4, (j, got, want, gaps[j])
            return


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_cache_reference_matches_the_batcher(prepared, cache_refs, kv,
                                            kv_dtype):
    prompts = _prompts()
    b = ContinuousBatcher(CFG, prepared, slots=3, max_len=64, prompt_pad=16,
                          block_len=8, device="cpu", kv=kv, kv_dtype=kv_dtype)
    assert b.paged == (kv == "paged")
    rids = [b.submit(p, N_NEW) for p in prompts]
    res = b.drain()
    for i, rid in enumerate(rids):
        want, gaps = cache_refs[kv_dtype, i]
        assert len(set(want)) > 1  # varied tokens: the check means something
        _agree(np.asarray(res[rid]).tolist(), want, gaps)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cache_reference_matches_make_generate(prepared, cache_refs,
                                               kv_dtype):
    prompt = _prompts()[2]
    gen = make_generate(CFG, max_new_tokens=N_NEW, kv_dtype=kv_dtype,
                        device="cpu")
    got = gen(prepared, [prompt])[0].tolist()
    _agree(got, *cache_refs[kv_dtype, 2])


def test_cache_reference_refuses_other_types(prepared):
    with pytest.raises(ValueError, match="bf16 or int8"):
        chip_smoke.reference_greedy_cache(prepared, CFG, [1, 2], 2, "cpu",
                                          "f32")


# K3 (dQ) and K4 (dK, dV) at the training shape, B=8 H=12 T=S=512 D=64
# causal: 131328 live (query, key) pairs per (batch, head).
@pytest.mark.parametrize("kernel,tensors,products", [
    ("flash_bwd_dq", 5, 3), ("flash_bwd_dkv", 6, 4)])
def test_flash_bwd_bound_in_f32_is_the_functions_work(kernel, tensors,
                                                      products):
    """In f32 the bound is the larger of the bytes (63.3 MB for K3, 75.9
    MB for K4) and the backward's own products (3 for K3, 4 for K4) at
    the TF32 tensor cores' 494.7 TFLOP/s: the bytes, 0.0189 / 0.0227 ms.
    What the split design issues (each product as three: the score
    product on TF32, the others on bf16; 0.0196 / 0.0245 ms) is kept
    beside it and does not move it."""
    b = chip_smoke.flash_bwd_bound(kernel, True, 96, 512, 512, 64)
    assert chip_smoke.live_pairs(512, 512) == 131328
    product = 2 * 64 * 96 * 131328  # 1.61 GFLOP
    assert b["nbytes"] == tensors * 96 * 512 * 64 * 4 + 2 * 96 * 512 * 4
    assert round(b["nbytes"] / 1e6, 1) == {5: 63.3, 6: 75.9}[tensors]
    assert b["flops"] == products * product
    assert b["ops_ms"] == pytest.approx(products * product / 494.7e12 * 1e3)
    assert b["bytes_ms"] == pytest.approx(b["nbytes"] / 3.35e12 * 1e3)
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"]) == b["bytes_ms"]
    assert round(b["bound_ms"], 4) == {5: 0.0189, 6: 0.0227}[tensors]
    assert b["bound_by"] == "bytes"
    assert b["issued"] == dict(tf32=3 * product,
                               bf16=3 * (products - 1) * product)
    issued_ms = (3 * product / 494.7e12
                 + 3 * (products - 1) * product / 989e12) * 1e3
    assert round(issued_ms, 4) == {3: 0.0196, 4: 0.0245}[products]
    assert b["f32_cuda_core_ms"] == pytest.approx(
        products * product / 67e12 * 1e3)


@pytest.mark.parametrize("kernel,tensors,products", [
    ("flash_bwd_dq", 5, 3), ("flash_bwd_dkv", 6, 4)])
def test_flash_bwd_bound_in_bf16_is_bytes(kernel, tensors, products):
    """In bf16 the products run once, on bf16 at 989 TFLOP/s: the bound
    is the bytes, as before."""
    b = chip_smoke.flash_bwd_bound(kernel, False, 96, 512, 512, 64)
    product = 2 * 64 * 96 * 131328
    assert b["nbytes"] == tensors * 96 * 512 * 64 * 2 + 2 * 96 * 512 * 4
    assert b["flops"] == products * product
    assert "issued" not in b
    assert b["ops_ms"] == pytest.approx(products * product / 989e12 * 1e3)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["nbytes"] / 3.35e12 * 1e3)


def test_flash_bwd_bound_counts_ragged_and_bottom_right_shapes():
    """T=128 against S=512, bottom-right: q and dO have T rows, k, v and
    K4's dK, dV have S rows; the pairs are those the mask leaves."""
    t, s, d = 128, 512, 64
    pairs = sum(min(s, r + 1 + s - t) for r in range(t))
    dq = chip_smoke.flash_bwd_bound("flash_bwd_dq", True, 2, t, s, d)
    dkv = chip_smoke.flash_bwd_bound("flash_bwd_dkv", True, 2, t, s, d)
    assert dq["nbytes"] == (3 * t + 2 * s) * 2 * d * 4 + 2 * 2 * t * 4
    assert dkv["nbytes"] == (2 * t + 4 * s) * 2 * d * 4 + 2 * 2 * t * 4
    assert dq["flops"] == 3 * 2 * d * 2 * pairs
    assert dkv["flops"] == 4 * 2 * d * 2 * pairs
    product = 2 * d * 2 * pairs
    assert dq["issued"]["tf32"] == dkv["issued"]["tf32"] == 3 * product


@pytest.mark.parametrize("f32,with_lse", [(True, False), (True, True),
                                          (False, False), (False, True)],
                         ids=["K1-f32", "K2-f32", "K1-bf16", "K2-bf16"])
def test_flash_fwd_bound_counts_the_forward(f32, with_lse):
    """K1/K2 at the training shape: q, k, v read and out written (50.3 MB
    in f32), K2's lse beside them; the two products at the fastest rate
    for the type, so the bytes bind (0.0150 / 0.0151 ms in f32). In f32
    what the split design issues (S as three TF32 products, P.V as three
    bf16 products: 0.0147 ms) is kept beside it."""
    b = chip_smoke.flash_fwd_bound(f32, 96, 512, 512, 64, with_lse)
    el = 4 if f32 else 2
    product = 2 * 64 * 96 * 131328
    assert b["nbytes"] == (4 * 96 * 512 * 64 * el
                           + (96 * 512 * 4 if with_lse else 0))
    assert b["flops"] == 2 * product
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["nbytes"] / 3.35e12 * 1e3)
    if f32:
        assert round(b["bound_ms"], 4) == (0.0151 if with_lse else 0.0150)
        assert b["issued"] == dict(tf32=3 * product, bf16=3 * product)
        issued_ms = (3 * product / 494.7e12 + 3 * product / 989e12) * 1e3
        assert round(issued_ms, 4) == 0.0147
    else:
        assert "issued" not in b


def test_flash_fwd_bound_counts_ragged_and_bottom_right_shapes():
    """T=128 against S=512, bottom-right: q and out have T rows, k and v
    S rows; the pairs are those the mask leaves."""
    t, s, d = 128, 512, 64
    pairs = sum(min(s, r + 1 + s - t) for r in range(t))
    b = chip_smoke.flash_fwd_bound(True, 2, t, s, d, True)
    assert b["nbytes"] == (2 * t + 2 * s) * 2 * d * 4 + 2 * t * 4
    assert b["flops"] == 2 * 2 * d * 2 * pairs
    assert b["issued"]["tf32"] == b["issued"]["bf16"] == 3 * 2 * d * 2 * pairs


@pytest.mark.parametrize("f32,peak", [(True, 494.7e12), (False, 989e12)])
def test_flash_bound_prices_the_products_at_the_types_fastest_rate(f32,
                                                                    peak):
    """The bound is the larger of bytes and products; f32 products are
    priced at the TF32 tensor cores' rate, bf16 at 989 TFLOP/s, and the
    f32 CUDA-core figure (67 TFLOP/s) rides beside it."""
    small = chip_smoke.flash_bound(3.35e9, 1e9, f32)  # 1 ms of bytes
    assert small["bound_ms"] == pytest.approx(1.0)
    assert small["bound_by"] == "bytes"
    big = chip_smoke.flash_bound(3.35e6, 1e12, f32)
    assert big["bound_ms"] == pytest.approx(1e12 / peak * 1e3)
    assert big["bound_by"] == "operations"
    assert big["f32_cuda_core_ms"] == pytest.approx(1e12 / 67e12 * 1e3)


@pytest.mark.parametrize("kernel,f32,units", [
    ("flash_bwd_dq", True, "issued on the tensor cores as split products"),
    ("flash_bwd_dkv", False, "products on the tensor cores"),
    ("flash_attention_lse", True,
     "issued on the tensor cores as split products")])
def test_flash_report_prints_the_bound_and_the_units(capsys, kernel, f32,
                                                     units):
    """One line per flash kernel: time, bound, what bounds, and the
    products on the units the kernel uses."""
    b = (chip_smoke.flash_fwd_bound(f32, 96, 512, 512, 64, True)
         if kernel == "flash_attention_lse"
         else chip_smoke.flash_bwd_bound(kernel, f32, 96, 512, 512, 64))
    row = dict(ms=0.05, plain_ms=0.8, library_ms=None,
               bound_ms=b["bound_ms"], bound_by=b["bound_by"],
               max_abs_err=1e-5)
    chip_smoke.flash_report("K3", "f32", row, b)
    line = capsys.readouterr().out
    assert line.startswith("[K3] f32: err 1.000e-05 kernel_ms 0.0500")
    assert f"bound_ms {b['bound_ms']:.5f} (bytes;" in line
    assert units in line and "library_ms none" in line
    assert f"kernel / bound {0.05 / b['bound_ms']:.1f}" in line


def test_pipe_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke's [pipe] phase on the CPU at a small size: P-a as on the
    card (two `node --serve` processes), P-b on an 8-layer gpt2-test-wide
    model (8 stages need 8 layers), 16 tokens, P-c on gpt2-test, 6 tokens;
    every check of the phase applies, except the launch counts (a CPU call
    launches no kernel)."""
    import torch

    from dnn_tpu_torch import registry

    cfg8 = tgpt.GPTConfig(block_size=64, vocab_size=256, n_layer=8,
                          n_head=4, n_embd=64)
    monkeypatch.setitem(tgpt.PRESETS, "gpt2-test8", cfg8)
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    tgpt._register("gpt2-test8", cfg8)
    dev = torch.device("cpu")
    prompt = _prompts()[2]
    chip_smoke.pipe_cifar(dev, "cpu")
    chip_smoke.pipe_gpt_stages(dev, "cpu", model="gpt2-test8", n_tokens=16)
    counts = chip_smoke.pipe_generate(dev, "cpu", prompt, model="gpt2-test",
                                      n_new=6)
    out = capsys.readouterr().out
    for tag in ("P-a node1: node node1: part 0/1, runtime stage",
                "P-a node2: node node2: part 1/1, runtime stage",
                "equal the relay engine's bit for bit",
                "P-c 6 tokens after a 37-token prompt"):
        assert tag in out, out
    assert set(counts) >= set(chip_smoke.CACHE_KERNELS)


def test_wire_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke's [wire] phase at small buffers: the native crc32c
    equals the per-byte version on every listed length and seed, and the
    phase times a checksummed payload and refuses a flipped byte."""
    monkeypatch.setattr(chip_smoke, "WIRE_RATE_BYTES", 1 << 20)
    monkeypatch.setattr(chip_smoke, "WIRE_LOGITS", (1, 16, 300))
    got = chip_smoke.phase_wire("cpu")
    out = capsys.readouterr().out
    assert "and its slice-by-8 route equal the per-byte version on 7 " \
        "lengths x 2 seeds" in out, out
    assert "a flipped byte raises PayloadCorruptError" in out
    assert got["crc32c_gb_s"] > 0 and got["crc32c_sliced_gb_s"] > 0
    assert got["tensor_view_ms"] >= 0


def test_text_phase_rehearsed_on_the_cpu(capsys):
    """chip_smoke's [text] phase on the CPU with a 2-layer model of
    block_size 1024 (run A's pool: 4 slots, max_len 1024, prompt_pad 64)
    and vocab 512: every check applies except the launch counts (a CPU
    call launches no kernel)."""
    import torch

    cfg = tgpt.GPTConfig(block_size=1024, vocab_size=512, n_layer=2,
                         n_head=2, n_embd=32)
    prepared = from_jax_params(tgpt.init(1, cfg), cfg, "cpu")
    counts = chip_smoke.phase_text(cfg, prepared, torch.device("cpu"), "cpu")
    out = capsys.readouterr().out
    assert "[text] IdMarkedTokenizer(512): a 192-character, 282-byte " \
        "prompt -> 16 tokens; the reply's ids" in out, out
    assert "equal SendTensor's tokens" in out
    for label in ("SendMessage", "GenerateStream", "SendTensor"):
        assert f"[main] [text] 282-byte prompt, {label}: " in out
    assert set(counts) >= set(chip_smoke.CACHE_KERNELS)


def test_relay_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke's P-d on the CPU: P-b's 8 stage servers on an 8-layer
    gpt2-test-wide model, 4 microbatches of 12 tokens over Relay, each
    equal to the relay engine's run bit for bit."""
    import torch

    from dnn_tpu_torch import registry

    cfg8 = tgpt.GPTConfig(block_size=64, vocab_size=256, n_layer=8,
                          n_head=4, n_embd=64)
    monkeypatch.setitem(tgpt.PRESETS, "gpt2-test8", cfg8)
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    tgpt._register("gpt2-test8", cfg8)
    chip_smoke.pipe_gpt_stages(torch.device("cpu"), "cpu", model="gpt2-test8",
                               n_tokens=12)
    out = capsys.readouterr().out
    assert "[pipe] P-d 4 microbatches of (1, 12) ids over Relay" in out, out
    assert "each result equals the relay engine's bit for bit" in out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Every test of this module on one intra-op thread: the models are
    tiny, and under the suite's parallel workers torch's default threads
    made them several times slower."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_phase_rehearsed_on_the_cpu(monkeypatch, capsys,
                                        one_torch_thread):
    """chip_smoke's [bf16] phase on the CPU with a 4-layer model of
    block_size 1024 (run E's pool: 4 slots, max_len 1024, prompt_pad 64)
    and vocab 512: E, F, B-bf16, solo-bf16 and P-c-bf16 in bf16 compute,
    each stream equal to its plain bf16-compute loop up to BF16_TIE;
    every check applies except the launch counts and the profiles (a CPU
    call launches no kernel). One torch thread: under the suite's
    parallel workers torch's default threads slow this tiny model
    tenfold."""
    import torch

    from dnn_tpu_torch import registry

    cfg = tgpt.GPTConfig(block_size=1024, vocab_size=512, n_layer=4,
                         n_head=2, n_embd=32)
    monkeypatch.setitem(tgpt.PRESETS, "gpt2-test1k", cfg)
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    tgpt._register("gpt2-test1k", cfg)
    counts = chip_smoke.phase_bf16(torch.device("cpu"), "cpu",
                                   model="gpt2-test1k")
    out = capsys.readouterr().out
    for run, pool in (("E", "paged pool, bf16 compute, kv_dtype bf16"),
                      ("F", "paged pool, bf16 compute, kv_dtype int8"),
                      ("B-bf16", "dense pool, bf16 compute, kv_dtype bf16")):
        assert f"[main] run {run} ({pool}" in out, out
        for i, n in enumerate((5, 70, 130, 300)):
            assert f"[main] run {run} request {i} (prompt {n}): " in out
    assert "[main] solo-bf16 make_generate: " in out
    assert "[main] P-c-bf16 engine.generate (gpt2-test1k, 4 parts): " in out
    assert "an f32 product of the rounded operands" in out
    assert set(counts) == set(chip_smoke.CACHE_KERNELS)


def test_serve_phase_rehearsed_on_the_cpu(capsys, one_torch_thread):
    """chip_smoke's [serve] phase on the CPU with a 2-layer model of
    block_size 1024 (run A's pool: 4 slots, max_len 1024, prompt_pad 64)
    and vocab 512, after run A: the bias and logprobs run over gRPC and
    on the batcher, G (radix) and G-dense (LRU) with fewer chunks than
    without the cache, a copy-on-write hit and a zero-chunk full hit,
    and H (64-token chunks, overlap) whose streams equal A's; every check
    applies except the launch counts and the profile (a CPU call
    launches no kernel)."""
    import torch

    cfg = tgpt.GPTConfig(block_size=1024, vocab_size=512, n_layer=2,
                         n_head=2, n_embd=32)

    def scaled(t):
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        return t * np.float32(8.0) if t.ndim >= 2 else t
    prepared = from_jax_params(scaled(tgpt.init(1, cfg)), cfg, "cpu")
    dev = torch.device("cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    refs = [chip_smoke.reference_greedy(prepared, cfg, p, 16, dev)
            for p in prompts]
    a_info = {}
    chip_smoke.serve_run("A", cfg, prepared, prompts, 16, refs, [], dev,
                         "cpu", info=a_info, kv="paged")
    counts = chip_smoke.phase_serve(cfg, prepared, prompts, refs, a_info,
                                    dev, "cpu")
    out = capsys.readouterr().out
    assert "[serve] bias over gRPC (b=): banned token" in out, out
    for tag, store in (("G", "radix store"), ("G-dense", "dense LRU")):
        assert f"[serve] {tag} ({store}, prefix_cache=256): 10 prompts" \
            in out, out
        assert f"[serve] {tag}: time to first token" in out
    assert "9 hits, 1 misses" in out
    assert "[main] run H: every stream equals run A's token for token" \
        in out
    for i, n in enumerate((5, 70, 130, 300)):
        assert f"[main] run H request {i} (prompt {n}): " in out
    assert set(counts) == set(chip_smoke.CACHE_KERNELS)


def test_constrain_phase_rehearsed_on_the_cpu(capsys, one_torch_thread):
    """chip_smoke's [constrain] phase on the CPU with a 2-layer model of
    block_size 1024 (run A's pool) and vocab 512, after run A: J (four
    j=1 requests over gRPC, two choice requests through the worker, two
    unconstrained) and J-ilv (64-token chunks, overlap), every
    constrained stream equal to the masked no-cache loop, every
    completed output matching its grammar, the unconstrained streams
    equal to A's, J-ilv's equal to J's; every check applies except the
    launch counts and the replay (a CPU call launches no kernel)."""
    import torch

    cfg = tgpt.GPTConfig(block_size=1024, vocab_size=512, n_layer=2,
                         n_head=2, n_embd=32)

    def scaled(t):
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        return t * np.float32(8.0) if t.ndim >= 2 else t
    prepared = from_jax_params(scaled(tgpt.init(1, cfg)), cfg, "cpu")
    dev = torch.device("cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    refs = [chip_smoke.reference_greedy(prepared, cfg, p, 16, dev)
            for p in prompts]
    a_info = {}
    chip_smoke.serve_run("A", cfg, prepared, prompts, 16, refs, [], dev,
                         "cpu", info=a_info, kv="paged")
    counts = chip_smoke.phase_constrain(cfg, prepared, prompts, a_info, dev,
                                        "cpu")
    out = capsys.readouterr().out
    for run in ("J", "J-ilv"):
        assert f"[constrain] run {run}: 8 concurrent requests (4 j=1 over " \
            "gRPC, 2 choice, 2 unconstrained)" in out, out
        assert "every completed output matches it" in out
    assert "[constrain] run J-ilv: every stream equals run J's" in out
    assert "constraint pools 3600 rows x 512: 0.009 GB" in out
    assert set(counts) == set(chip_smoke.CACHE_KERNELS)


def test_spec_phase_rehearsed_on_the_cpu(monkeypatch, capsys,
                                        one_torch_thread):
    """chip_smoke's [spec] phase on the CPU with a 2-layer target drafted
    by a 1-layer model (block_size 1024, vocab 512) in place of gpt2-xl
    and gpt2: S over gRPC, S-ilv equal to S, S-solo equal to
    make_generate, S-self accepting every proposal with k+1 tokens a
    step, S-bf16 against the plain bf16 loop; every check applies except
    the launch counts and the replays (a CPU call launches no kernel)."""
    import torch

    init = tgpt.init

    def scaled(seed, cfg):  # decisive greedy argmaxes on a tiny model
        def x8(t):
            if isinstance(t, dict):
                return {k: x8(v) for k, v in t.items()}
            return t * np.float32(8.0) if t.ndim >= 2 else t
        return x8(init(seed, cfg))

    monkeypatch.setattr(tgpt, "init", scaled)
    monkeypatch.setitem(tgpt.PRESETS, "spec-t", tgpt.GPTConfig(
        block_size=1024, vocab_size=512, n_layer=2, n_head=2, n_embd=32))
    monkeypatch.setitem(tgpt.PRESETS, "spec-d", tgpt.GPTConfig(
        block_size=1024, vocab_size=512, n_layer=1, n_head=2, n_embd=32))
    counts, verify = chip_smoke.phase_spec(torch.device("cpu"), "cpu",
                                           target="spec-t", draft="spec-d")
    out = capsys.readouterr().out
    for run in ("S", "S-ilv", "S-bf16"):
        assert f"[main] run {run}: speculative, spec_k 4" in out, out
        for i, n in enumerate((5, 70, 130, 300)):
            assert f"[main] run {run} request {i} (prompt {n}): " in out
    assert "[main] run S-ilv: every stream equals run S's" in out
    assert "[spec] S-solo: 16 tokens after a 300-token prompt" in out
    assert "every one committing 5 tokens a slot" in out
    assert set(counts) == {"f32", "bf16"} and set(verify) == {"f32", "bf16"}


def test_item_4d_phases_rehearsed_on_the_cpu(capsys, one_torch_thread):
    """chip_smoke's [quant], [lora], [beam] and [embed] phases on the CPU
    with a 2-layer model of block_size 1024 (run A's pool) and vocab 512:
    Q8 (weights="int8") and Q4 over gRPC and Q4's make_generate against
    the no-cache loops over the quantized trees; the two LoRA waves
    against the loops over the merged trees, the dense pool's prefix hit
    keyed by adapter; the beam search against reference_beam and
    beam_size 1 against make_generate; make_embed against the plain
    forward and the daemon's embed replies bit-equal to the library's.
    Every check applies except the launch counts, the captured-step
    checks and the profiles (a CPU call launches no kernel), and the
    node process."""
    import torch

    cfg = tgpt.GPTConfig(block_size=1024, vocab_size=512, n_layer=2,
                         n_head=2, n_embd=64)

    def scaled(t):
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        return t * np.float32(8.0) if t.ndim >= 2 else t
    prepared = from_jax_params(scaled(tgpt.init(1, cfg)), cfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    counts = chip_smoke.phase_item_4d(cfg, prepared, prompts,
                                      torch.device("cpu"), "cpu", model=None)
    out = capsys.readouterr().out
    for run in ("Q8", "Q4"):
        for i, n in enumerate((5, 70, 130, 300)):
            assert f"[main] run {run} request {i} (prompt {n}): " in out, out
    assert "[main] [quant] Q4 make_generate: " in out
    assert "matches the reference" in out
    assert "[lora] dense pool, prefix LRU: " in out
    assert "hits/misses (1, 2)" in out
    assert "[beam] beam_size 1 equals make_generate's greedy tokens" in out
    assert ("[beam] every beam's tokens equal the reference's" in out
            or "at a near-tie of its selection" in out), out
    for pooling in ("mean", "last", "none"):
        assert f"[embed] make_embed {pooling} B=4 T=320" in out
    assert "each bit-equal to the library's" in out
    for tag in ("quant", "lora", "beam", "embed"):
        assert f"[{tag}] phase wall" in out
    assert set(chip_smoke.CACHE_KERNELS) <= set(counts)


def test_item_4e_phases_rehearsed_on_the_cpu(capsys, one_torch_thread):
    """chip_smoke's [handoff] and [kvtier] phases on the CPU with a 2-layer
    model of block_size 1024 (run A's pool) and vocab 512: every handoff
    leg's adopted streams against the references and equal to the decode
    daemon's own prefill, no prompt chunk on the decode daemon; the
    adopted prefix's follow-up running one chunk, equal to the donor's
    stream, the grpc rung forced, a donor stopped mid-pull answering
    kvtier_fallback with the adopter's blocks unchanged. Every check
    applies except the launch counts (a CPU call launches no kernel) and
    the f32 row's refusal (this model's row fits the wire)."""
    import torch

    cfg = tgpt.GPTConfig(block_size=1024, vocab_size=512, n_layer=2,
                         n_head=2, n_embd=32)

    def scaled(t):
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        return t * np.float32(8.0) if t.ndim >= 2 else t
    prepared = from_jax_params(scaled(tgpt.init(1, cfg)), cfg, "cpu")
    dev = torch.device("cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    refs = {"f32": [chip_smoke.reference_greedy(prepared, cfg, p, 16, dev)
                    for p in prompts]}
    for dt in ("bf16", "int8"):
        refs[dt] = [chip_smoke.reference_greedy_cache(prepared, cfg, p, 16,
                                                      dev, dt, chunk=64)
                    for p in prompts]
    counts = chip_smoke.phase_item_4e(cfg, prepared, prompts, refs, dev,
                                      "cpu")
    out = capsys.readouterr().out
    for label, _, _, _, _ in chip_smoke.HANDOFF_LEGS:
        assert f"[handoff] {label} (" in out, out
        for i, n in enumerate((5, 70, 130, 300)):
            assert f"[handoff] {label} request {i} (prompt {n}): " in out
    assert "every adopted stream equal to the reference" in out
    assert "[handoff] library: pack" in out
    assert "kvstage" in out and "the stream equals the donor's" in out
    assert "[kvtier] adopted over grpc, prompt 130" in out
    assert "[kvtier] donor stopped between kvlease and the fetch: " \
        "[lm] kvtier_fallback" in out
    for tag in ("handoff", "kvtier"):
        assert f"[{tag}] phase wall" in out
    assert set(counts) == set(chip_smoke.CACHE_KERNELS)


def test_window_phases_rehearsed_on_the_cpu(monkeypatch, capsys,
                                            one_torch_thread):
    """chip_smoke's [mistral], [gemma2] and [gemma] phases on the CPU at
    the *-test presets (windows of 16, gemma2-test's softcaps and
    alternating layers; gemma-test widened to block_size 1024 for the
    main path's prompts): slots of 64 positions in 16-token chunks and
    blocks of 8, prompts past the window, 8 new tokens. Every served
    stream agrees with the plain banded recompute by teacher forcing, the
    windowed paged pools reclaim floor((limit - window + 1) / 8) blocks a
    request, kv="auto" serves gemma2-test dense, W-f32's logprobs sit
    within FORCED_F32_TOL of the banded recompute and its unbanded
    control 10x that away, G1-logprobs within FORCED_F32_TOL of the
    no-cache loop, and the kernels line's band and D = 256 entries are
    built from rows (the card's timings stubbed) with each phase's
    launches by q type."""
    import dataclasses

    import torch

    from dnn_tpu_torch.models import llama as tllama

    for name, value in (("WIN_MAX_LEN", 64), ("WIN_PAD", 16), ("WIN_BP", 8),
                        ("WIN_PROMPTS", (20, 30)), ("G2_PROMPTS", (24, 10)),
                        ("WIN_NEW", 8), ("G1_NEW", 4), ("G1_SOLO_NEW", 6)):
        monkeypatch.setattr(chip_smoke, name, value)
    cpu = torch.device("cpu")
    m_counts, _ = chip_smoke.phase_mistral(
        cpu, "cpu", tllama.PRESETS["mistral-test"])
    g2_counts, _ = chip_smoke.phase_gemma2(cpu, "cpu",
                                           tllama.PRESETS["gemma2-test"])
    g1_counts, _ = chip_smoke.phase_gemma(cpu, "cpu", dataclasses.replace(
        tllama.PRESETS["gemma-test"], block_size=1024))
    out = capsys.readouterr().out
    for run in ("W-paged", "W-int8", "W-dense"):
        for n in (20, 30):
            assert f"[mistral] {run} (prompt {n}, 8 tokens): " in out, out
        assert f"[mistral] run {run}: " in out
    assert "[mistral] W-solo (prompt 30, 8 tokens): " in out, out
    for run in ("W-paged", "W-int8"):
        assert (f"[mistral] run {run}: blocks reclaimed while running "
                "(prompt, limit, freed of held): [") in out, out
    assert "blocks reclaimed" not in out.split("run W-dense")[1].split(
        "[mistral] W-solo")[0]
    assert "[gemma2] run G2-dense: dense pool" in out, out
    for n in (24, 10):
        assert f"[gemma2] G2-dense (prompt {n}, 8 tokens): " in out, out
    assert "[main] [gemma] G1-solo make_generate f32: " in out, out
    for i, n in enumerate(chip_smoke.LLAMA_PROMPTS):
        assert f"[main] run G1-paged request {i} (prompt {n}): " in out, out
    for n in (20, 30):
        assert f"[mistral] W-f32 (prompt {n}, 8 tokens): served logprobs " \
            in out, out
    for i, n in enumerate(chip_smoke.LLAMA_PROMPTS):
        assert f"[gemma] G1-logprobs (prompt {n}, 4 tokens): served " \
            "logprobs " in out, out
    assert set(m_counts) == {"bf16", "f32"}
    assert set(g2_counts) == {"bf16"} and set(g1_counts) == {"f32"}
    for by_q in (m_counts, g2_counts, g1_counts):
        for counts in by_q.values():
            assert set(chip_smoke.CACHE_KERNELS) <= set(counts)
    row = dict(ms=1.0, plain_ms=2.0, library_ms=None, bound_ms=0.5,
               bound_by="bytes", max_abs_err=0.0)
    rows = {key: {q: {dt: row for dt in ("f32", "bf16", "int8")}
                  for q in chip_smoke.WIN_Q}
            for key, *_ in chip_smoke.WIN_ROWS}
    band = {"bf16": {"cached_attention band": {"f32": 0, "bf16": 7,
                                               "int8": 2}},
            "f32": {"cached_attention band": {"f32": 3, "bf16": 0,
                                              "int8": 0}}}
    entries = chip_smoke.window_records(rows, {"mistral": band})
    assert len(entries) == 6
    assert entries[0]["launches"] == 12  # K5's band: both q types
    assert entries[0]["by_dtype"]["bf16"]["launches"] == 7
    assert entries[0]["k5_band_f32_q_shape"]["by_dtype"]["f32"][
        "launches"] == 3
    for e in entries:
        assert {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(e)
