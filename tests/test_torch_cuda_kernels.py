"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc; on other hosts they skip. They
import no JAX, so the card machine runs them without the repo's JAX
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Shapes here are deliberately ragged (T not a multiple of the 64-row
query tile, S not a multiple of the 64-key tile or the 8-key chunk,
block_len 8, two query rows per KV head); K5 also runs at the serving
shape, at bases beside its split edges, under each split plan, and
twice for bit-equality — the serving path itself is covered by
chip_smoke.py. Tolerance: atol 1e-4 for f32, bf16 and int8
caches alike (both sides read the same rounded or quantized values and
accumulate in f32; only the summation order differs)."""

import pytest
import torch

from dnn_tpu_torch.ops.cuda import cached_attention as tca
from dnn_tpu_torch.ops.cuda import flash_attention as tfa

pytestmark = pytest.mark.cuda
ATOL = 1e-4
KV_DTYPES = ["f32", "bf16", "int8"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cache(g, shape, kind, dev):
    """(k, v, ks, vs) of `shape` in cache type `kind` (int8 with random
    positive per-row scales, the float kinds with none)."""
    k = torch.randn(*shape, generator=g, device=dev)
    v = torch.randn(*shape, generator=g, device=dev)
    if kind == "int8":
        def q8():
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)

        def sc():
            return torch.rand(*shape[:-1], generator=g, device=dev) * 0.05 + 1e-3
        return q8(), q8(), sc(), sc()
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    return k.to(dt), v.to(dt), None, None


def _k5_check(q, k, v, pos, ks, vs, kind):
    """One K5 call against the plain version; counts one launch."""
    before = tca.cached_attention.launches_by_dtype[kind]
    got = tca.cached_attention(q, k, v, pos, ks=ks, vs=vs)
    want = tca.reference_cached_attention(q, k, v, pos, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert tca.cached_attention.launches_by_dtype[kind] == before + 1
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= ATOL, err
    return got


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [40, 1, 65])
def test_cached_attention_kernel(dev, kind, d, t):
    """B=2 rows at different base positions, S=200 (not a multiple of
    the 64-key tile), T of one row, of 40 and of 65 (a second query tile
    with one row)."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 3, t, d, generator=g, device=dev)
    k, v, ks, vs = _cache(g, (2, 3, 200, d), kind, dev)
    for base in ([0, 160], [7, 100], [199, 0]):
        pos = torch.tensor(base, dtype=torch.int32, device=dev)
        _k5_check(q, k, v, pos, ks, vs, kind)


# the serving shape (one 64-row prompt chunk against a 1024-position row,
# 8 splits of two 64-key tiles). The last row's limit, base + 63, falls
# on the cache's last column (base 960), on a split's last column (base
# 448: 511), and one column either side of that edge (447: 510, 449: 512,
# the next split's first column).
@pytest.mark.parametrize("kind", KV_DTYPES)
def test_cached_attention_serving_shape(dev, kind):
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(1, 12, 64, 64, generator=g, device=dev)
    k, v, ks, vs = _cache(g, (1, 12, 1024, 64), kind, dev)
    assert tca.k5_split(12, 64, 1024) == (2, 8)
    for base in (0, 447, 448, 449, 960):
        pos = torch.tensor([base], dtype=torch.int32, device=dev)
        _k5_check(q, k, v, pos, ks, vs, kind)


# (B, H, T, S): the split plans the wrapper picks for these shapes are
# single-split (B=8 H=12 T=256: 384 query tiles, the kernel normalises
# and writes the output itself, its ring wrapping over 5 tiles) and
# six tiles a split (B=2 H=12 T=128 S=1024: 3 splits, the last of four
# tiles); `target` then forces one split, and one split per tile, on the
# same inputs.
@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("b,h,t,s", [(8, 12, 256, 300), (2, 12, 128, 1024)],
                         ids=["B=8-T=256-S=300", "B=2-T=128-S=1024"])
@pytest.mark.parametrize("target", [None, 1, 10**6],
                         ids=["auto", "one-split", "split-per-tile"])
def test_cached_attention_split_plans(dev, monkeypatch, kind, b, h, t, s,
                                      target):
    if target is not None:
        monkeypatch.setattr(tca, "K5_TARGET_BLOCKS", target)
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(b, h, t, 64, generator=g, device=dev)
    k, v, ks, vs = _cache(g, (b, h, s, 64), kind, dev)
    pos = torch.tensor(([0, s - t, 17, 40, 3, 9, 30, 1] * 2)[:b],
                       dtype=torch.int32, device=dev)
    _k5_check(q, k, v, pos, ks, vs, kind)


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("b,h,t,s,d", [(1, 12, 64, 1024, 64),
                                       (2, 3, 65, 200, 128)],
                         ids=["serving-shape", "ragged-D=128"])
def test_cached_attention_is_deterministic(dev, kind, b, h, t, s, d):
    """K5 twice on the same inputs gives the same output bit for bit: the
    splits' partials are merged in a fixed order, with no atomics."""
    g = torch.Generator(device=dev).manual_seed(10)
    q = torch.randn(b, h, t, d, generator=g, device=dev)
    k, v, ks, vs = _cache(g, (b, h, s, d), kind, dev)
    pos = torch.tensor([s - t, 0][:b], dtype=torch.int32, device=dev)
    first = tca.cached_attention(q, k, v, pos, ks=ks, vs=vs)
    second = tca.cached_attention(q, k, v, pos, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all() and torch.equal(first, second)


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rows", [1, 2])
def test_decode_kernel(dev, kind, d, rows):
    """K6 at a ragged S, with a slot whose stale pos equals S (it attends
    the whole cache and reads nothing past it)."""
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(4, 3, rows, d, generator=g, device=dev)
    k, v, ks, vs = _cache(g, (4, 3, 77, d), kind, dev)
    pos = torch.tensor([0, 9, 76, 77], dtype=torch.int32, device=dev)
    before = tca.decode_attention.launches_by_dtype[kind]
    got = tca.decode_attention(q, k, v, pos, ks=ks, vs=vs)
    want = tca.reference_decode_attention(q, k, v, pos, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert tca.decode_attention.launches_by_dtype[kind] == before + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_decode_kernel(dev, kind, d):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(3, 2, 2, d, generator=g, device=dev)
    kp, vp, ks, vs = _cache(g, (40, 2, 8, d), kind, dev)
    perm = torch.randperm(39, generator=torch.Generator().manual_seed(2)) + 1
    tables = perm[:36].reshape(3, 12).to(torch.int32).to(dev)
    pos = torch.tensor([0, 57, 95], dtype=torch.int32, device=dev)
    before = tca.paged_decode_attention.launches_by_dtype[kind]
    got = tca.paged_decode_attention(q, kp, vp, tables, pos, ks=ks, vs=vs)
    want = tca.reference_paged_decode_attention(q, kp, vp, tables, pos,
                                                 ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert tca.paged_decode_attention.launches_by_dtype[kind] == before + 1
    assert (got - want).abs().max().item() <= ATOL


def test_kernels_refuse_what_they_do_not_take(dev):
    """A non-contiguous or unsupported-dim CUDA tensor, or an int8 cache
    without its scales, raises; it never falls back to the plain
    version."""
    q = torch.randn(1, 2, 8, 64, device=dev).transpose(2, 3).contiguous()
    k = torch.randn(1, 2, 64, 64, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tca.cached_attention(q.transpose(2, 3), k, k, pos)
    q16 = torch.randn(1, 2, 8, 16, device=dev)
    k16 = torch.randn(1, 2, 64, 16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tca.cached_attention(q16, k16, k16, pos)
    with pytest.raises(ValueError, match="head dim"):
        tca.decode_attention(q16[:, :, :1].contiguous(), k16, k16, pos)
    k8 = torch.zeros(1, 2, 64, 64, dtype=torch.int8, device=dev)
    with pytest.raises(TypeError, match="scale"):
        tca.decode_attention(torch.randn(1, 2, 1, 64, device=dev), k8, k8,
                             pos)


# --- flash attention (K1-K4) ------------------------------------------
# Ragged T/S, S > T (bottom-right mask), full attention, every head dim
# and both input types. K1 and K2 against the plain forward with the
# logsumexp on the same inputs (K1's output also equals K2's bit for
# bit: one kernel per type); K3/K4 against the plain backward on the
# same (q, k, v, dO, lse, D). Tolerances: f32 outputs 1e-4 absolute, f32
# gradients 1e-4 x the tensor's max |value| (sums of up to S products
# in another order); bf16 2e-2 (the outputs are rounded to bf16 on both
# sides, and a rounding step of bf16 near 1 is 2^-8).

# T=S=1 (one row, one key); T=65 S=1000 (a ragged last key tile, the
# ring of K/V stages wrapped, bottom-right mask); T=S=1024 (the ring
# wraps many times); T=64 S=65 full (one live key in the last tile).
FLASH_SHAPES = [(True, 100, 100), (True, 37, 150), (False, 64, 90),
                (True, 128, 128), (True, 1, 1), (True, 65, 1000),
                (True, 1024, 1024), (False, 64, 65)]


def _flash_inputs(g, dev, t, s, d, dtype):
    q, k, v, do = (torch.randn(2, 3, n, d, generator=g, device=dev).to(dtype)
                   for n in (t, s, s, t))
    return q, k, v, do


def _tol(dtype, ref):
    scale = max(ref.abs().max().item(), 1.0)
    return 1e-4 * scale if dtype == torch.float32 else 2e-2 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,t,s", FLASH_SHAPES)
def test_flash_kernels(dev, dtype, d, causal, t, s):
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = _flash_inputs(g, dev, t, s, d, dtype)
    name = "f32" if dtype == torch.float32 else "bf16"
    wrappers = (tfa.flash_attention, tfa.flash_attention_lse,
                tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    before = [w.launches_by_dtype[name] for w in wrappers]
    out1 = tfa.flash_attention(q, k, v, causal=causal)
    out2, lse = tfa.flash_attention_lse(q, k, v, causal=causal)
    ref, ref_lse = tfa.reference_attention_lse(q, k, v, causal=causal)
    di = (do.float() * out2.float()).sum(-1)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, di, causal=causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, di, causal=causal)
    rdq = tfa.reference_flash_bwd_dq(q, k, v, do, lse, di, causal=causal)
    rdk, rdv = tfa.reference_flash_bwd_dkv(q, k, v, do, lse, di,
                                           causal=causal)
    torch.cuda.synchronize()
    assert [w.launches_by_dtype[name] for w in wrappers] == \
        [b + 1 for b in before]
    assert out1.dtype == dtype and dq.dtype == dtype and dk.dtype == dtype
    assert torch.equal(out1, out2)  # K1 and K2 are one kernel
    for got, want in ((out1, ref), (out2, ref), (lse, ref_lse), (dq, rdq),
                      (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _tol(dtype, want.float()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_autograd_on_the_card(dev, dtype):
    """The Function: K2 forward, K3/K4 backward, against autograd through
    the plain reference_attention (in f32 on the same values for bf16)."""
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, w = _flash_inputs(g, dev, 200, 200, 64, dtype)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(
        (tfa.flash_attention(q, k, v) * w).sum(), (q, k, v))
    qf, kf, vf = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(
        (tfa.reference_attention(qf, kf, vf) * w.float()).sum(),
        (qf, kf, vf))
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert (a.float() - b).abs().max().item() <= _tol(dtype, b)


# (B, H, T, S): the training shape, and a ragged one whose K/V ring wraps
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s", [(8, 12, 512, 512), (2, 3, 65, 1000)],
                         ids=["B=8-H=12-T=S=512", "T=65-S=1000"])
def test_flash_backward_bf16_is_deterministic(dev, dtype, b, h, t, s):
    """K3 and K4 (causal, D=64), in bf16 and in f32, run twice on the
    same inputs give dQ, dK and dV equal bit for bit: no atomics, a fixed
    summation order, so a resumed training run can reproduce an
    uninterrupted one."""
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(b, h, n, 64, generator=g, device=dev)
                   .to(dtype) for n in (t, s, s, t))
    out, lse = tfa.flash_attention_lse(q, k, v)
    di = (do.float() * out.float()).sum(-1)

    def grads():
        return (tfa.flash_bwd_dq(q, k, v, do, lse, di),
                *tfa.flash_bwd_dkv(q, k, v, do, lse, di))
    first, second = grads(), grads()
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b_)


@pytest.mark.parametrize("seed", [8, 9, 10, 11])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t,s", [(512, 512), (65, 1000)],
                         ids=["T=S=512", "T=65-S=1000"])
def test_flash_backward_f32_large_scores(dev, d, causal, t, s, seed):
    """K3 and K4 in f32 with q and k x 4, so that scores reach tens (as a
    trained model's do): an error in the score product goes through exp,
    so this is where a split of q.k^T too coarse for f32 shows. Held
    against the plain backward at 1e-4 x each gradient's max |value|.
    Prints each gradient's error / max against the plain backward and,
    beside it, against the plain backward in f64 on the same values (run
    with -s to read the margin)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = _flash_inputs(g, dev, t, s, d, torch.float32)
    q, k = 4 * q, 4 * k
    out, lse = tfa.flash_attention_lse(q, k, v, causal=causal)
    di = (do * out).sum(-1)
    got = (tfa.flash_bwd_dq(q, k, v, do, lse, di, causal=causal),
           *tfa.flash_bwd_dkv(q, k, v, do, lse, di, causal=causal))
    args = (q, k, v, do, lse, di)
    want, exact = (
        (tfa.reference_flash_bwd_dq(*xs, causal=causal),
         *tfa.reference_flash_bwd_dkv(*xs, causal=causal))
        for xs in (args, [x.double() for x in args]))
    torch.cuda.synchronize()
    line = []
    for name, a, b_, x in zip(("dq", "dk", "dv"), got, want, exact):
        assert torch.isfinite(a).all()
        err = (a - b_).abs().max().item()
        top = b_.abs().max().item()
        line.append(f"{name} {err / top:.2e} (f64 "
                    f"{(a.double() - x).abs().max().item() / top:.2e})")
        assert err <= 1e-4 * top, (name, err)
    print(f"\n[x4] D={d} {'causal' if causal else 'full'} T={t} S={s} "
          f"seed {seed}: err / max " + ", ".join(line))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s", [(8, 12, 512, 512), (2, 3, 65, 1000)],
                         ids=["B=8-H=12-T=S=512", "T=65-S=1000"])
def test_flash_forward_is_deterministic(dev, dtype, b, h, t, s):
    """K2 (causal, D=64) run twice on the same inputs gives out and lse
    equal bit for bit, in f32 and in bf16: the lse K3/K4 read, and so a
    resumed training run, do not depend on the launch."""
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn(b, h, n, 64, generator=g, device=dev).to(dtype)
               for n in (t, s, s))
    first = tfa.flash_attention_lse(q, k, v)
    second = tfa.flash_attention_lse(q, k, v)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b_)


@pytest.mark.parametrize("seed", [8, 9, 10, 11])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t,s", [(512, 512), (65, 1000)],
                         ids=["T=S=512", "T=65-S=1000"])
def test_flash_forward_f32_large_scores(dev, d, causal, t, s, seed):
    """K1 and K2 in f32 with q and k x 4, so that scores reach tens (as a
    trained model's do): an error in the score product goes through exp
    into out and into the lse. Held against the plain f32 forward at 1e-4
    absolute, out and lse; K1's out equals K2's bit for bit. Prints the
    error against the plain forward and, beside it, against the plain
    forward in f64 on the same values, and the plain f32 forward's own
    error against f64 (run with -s to read the margin)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, _ = _flash_inputs(g, dev, t, s, d, torch.float32)
    q, k = 4 * q, 4 * k
    out1 = tfa.flash_attention(q, k, v, causal=causal)
    out, lse = tfa.flash_attention_lse(q, k, v, causal=causal)
    want, exact = (tfa.reference_attention_lse(*xs, causal=causal)
                   for xs in ((q, k, v), [x.double() for x in (q, k, v)]))
    torch.cuda.synchronize()
    assert torch.equal(out1, out)
    line = []
    for name, a, b_, x in zip(("out", "lse"), (out, lse), want, exact):
        assert torch.isfinite(a).all()
        err = (a - b_).abs().max().item()
        f64, own = ((y.double() - x).abs().max().item() for y in (a, b_))
        line.append(f"{name} {err:.2e} (f64 {f64:.2e}; the plain f32 "
                    f"forward's own {own:.2e})")
        assert err <= 1e-4, (name, err)
    print(f"\n[x4 fwd] D={d} {'causal' if causal else 'full'} T={t} S={s} "
          f"seed {seed}: max abs err " + ", ".join(line))


def test_flash_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)
    q = torch.randn(1, 2, 64, 8, device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q, q, q, causal=False)
    q = torch.randn(1, 2, 16, 64, device=dev)
    with pytest.raises(ValueError, match="S=8 < T=16"):
        tfa.flash_attention(q, q[:, :, :8], q[:, :, :8])
