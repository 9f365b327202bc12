"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc; on other hosts they skip. They
import no JAX, so the card machine runs them without the repo's JAX
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Shapes here are deliberately ragged (T not a multiple of the 64-row
query tile, S not a multiple of the 64-key tile or of a decode tile,
block_len 8, two and four query rows per KV head); K5 also runs at the
serving shape, at bases beside its split edges, under each split plan,
and twice for bit-equality; K6/K7 at S=1024 with positions beside their
split edges, twice for bit-equality, and replayed from a CUDA graph
after the positions changed on the device — the serving path itself is
covered by chip_smoke.py. Tolerance: atol 1e-4 for f32, bf16 and int8
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
@pytest.mark.parametrize("rows", [1, 2, 4])
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
@pytest.mark.parametrize("rows", [2, 4])
def test_paged_decode_kernel(dev, kind, d, rows):
    """K7 at block_len 8 through a permuted table (one split)."""
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(3, 2, rows, d, generator=g, device=dev)
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


def _decode_check(paged, q, k, v, pos, ks, vs, kind, tables=None):
    """One K6 (or K7) call against its plain version; counts one
    launch."""
    fn = tca.paged_decode_attention if paged else tca.decode_attention
    ref = (tca.reference_paged_decode_attention if paged
           else tca.reference_decode_attention)
    args = (q, k, v, tables, pos) if paged else (q, k, v, pos)
    before = fn.launches_by_dtype[kind]
    got = fn(*args, ks=ks, vs=vs)
    want = ref(*args, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert fn.launches_by_dtype[kind] == before + 1
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= ATOL, err
    return got


def _decode_inputs(dev, paged, kind, d, rows, seed, b=6, hk=2):
    """q (b, hk, rows, d) and a 1024-column cache: dense (b, hk, 1024,
    d), or a pool of 16-row blocks behind a permuted table (b, 64) whose
    last slot is inactive: every entry the junk block 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, hk, rows, d, generator=g, device=dev)
    if not paged:
        return (q, *_cache(g, (b, hk, 1024, d), kind, dev), None)
    n_blocks = b * 64 + 1
    kp, vp, ks, vs = _cache(g, (n_blocks, hk, 16, d), kind, dev)
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    tables = perm[:b * 64].reshape(b, 64).to(torch.int32)
    tables[-1] = 0
    return q, kp, vp, ks, vs, tables.to(dev)


def _edge_positions(paged, b, hk):
    """Positions beside the split edges of the wrapper's plan: the last
    column of split 0, the first and second of split 1, the last column
    of the row; then a stale dense slot at pos = S (K6), or the inactive
    paged slot at 0 (K7)."""
    split_keys, n_split = tca.decode_split(b * hk, 1024, 16 if paged else 1)
    assert n_split > 2
    return [split_keys - 1, split_keys, split_keys + 1, 1023, 517,
            0 if paged else 1024]


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["K6", "K7"])
def test_decode_kernels_at_split_edges(dev, paged, kind, d, rows):
    """K6 and K7 over S=1024 columns (16 splits of 64 keys at B=6 Hk=2):
    slots whose live columns end on a split's last column, on the next
    split's first and second, on the row's last column, mid-split; a
    stale dense slot (pos = S) and an inactive paged slot (pos 0 on the
    junk block)."""
    q, k, v, ks, vs, tables = _decode_inputs(dev, paged, kind, d, rows,
                                             seed=11)
    pos = torch.tensor(_edge_positions(paged, 6, 2), dtype=torch.int32,
                       device=dev)
    _decode_check(paged, q, k, v, pos, ks, vs, kind, tables)


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("paged", [False, True], ids=["K6", "K7"])
def test_decode_kernels_are_deterministic(dev, paged, kind):
    """K6 / K7 twice on the same inputs give the same output bit for bit:
    the groups of a block and the splits merge in a fixed order, with no
    atomics."""
    q, k, v, ks, vs, tables = _decode_inputs(dev, paged, kind, 64, 2,
                                             seed=12)
    pos = torch.tensor(_edge_positions(paged, 6, 2), dtype=torch.int32,
                       device=dev)
    first = _decode_check(paged, q, k, v, pos, ks, vs, kind, tables)
    second = _decode_check(paged, q, k, v, pos, ks, vs, kind, tables)
    assert torch.equal(first, second)


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("paged", [False, True], ids=["K6", "K7"])
def test_decode_kernels_replay_in_a_cuda_graph(dev, paged, kind):
    """A K6 / K7 call captured in a CUDA graph, then the positions
    changed on the device and the graph replayed: the output follows the
    new positions (the launch reads no position on the host)."""
    q, k, v, ks, vs, tables = _decode_inputs(dev, paged, kind, 64, 1,
                                             seed=13)
    fn = tca.paged_decode_attention if paged else tca.decode_attention
    args = (q, k, v, tables) if paged else (q, k, v)
    pos = torch.tensor([3, 140, 700, 1023, 128, 0], dtype=torch.int32,
                       device=dev)
    fn(*args, pos, ks=ks, vs=vs)  # builds the library, sets its attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args, pos, ks=ks, vs=vs)
    for new in ([1023, 0, 127, 129, 640, 0], [5, 900, 255, 256, 17, 0]):
        pos.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = (tca.reference_paged_decode_attention if paged
               else tca.reference_decode_attention)
        want = ref(*args, pos, ks=ks, vs=vs)
        assert (out - want).abs().max().item() <= ATOL


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
    with pytest.raises(ValueError, match="query rows"):
        tca.decode_attention(torch.randn(1, 2, 9, 64, device=dev), k, k,
                             pos)


def test_paged_decode_refuses_a_misaligned_pool(dev):
    """K7 reads the pool with 16-byte copies: a pool that starts 4 bytes
    past a 16-byte boundary raises; so do more than 8 query rows."""
    pool = torch.randn(5 * 2 * 16 * 64 + 1, device=dev)[1:].view(5, 2, 16, 64)
    assert pool.is_contiguous() and pool.data_ptr() % 16 == 4
    q = torch.randn(1, 2, 1, 64, device=dev)
    tables = torch.arange(1, 5, dtype=torch.int32, device=dev).reshape(1, 4)
    pos = torch.tensor([20], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        tca.paged_decode_attention(q, pool, pool, tables, pos)
    good = pool.clone()
    with pytest.raises(ValueError, match="query rows"):
        tca.paged_decode_attention(torch.randn(1, 2, 9, 64, device=dev),
                                   good, good, tables, pos)
    got = tca.paged_decode_attention(q, good, good, tables, pos)
    want = tca.reference_paged_decode_attention(q, good, good, tables, pos)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= ATOL


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


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 7, 8])
def test_cached_attention_grouped_heads_kernel(dev, kind, d, group):
    """K5 with grouped query heads: q of 2 * G heads against a cache of
    2 KV heads (query head h reads KV head h / G; G = 4 is llama3-8b's,
    7 Qwen2-7B's, 8 TinyLlama's), B=2 at different bases, S=200, T of
    40 and 65 rows."""
    g = torch.Generator(device=dev).manual_seed(21)
    k, v, ks, vs = _cache(g, (2, 2, 200, d), kind, dev)
    for t in (40, 65):
        q = torch.randn(2, 2 * group, t, d, generator=g, device=dev)
        for base in ([0, 135], [99, 7]):
            pos = torch.tensor(base, dtype=torch.int32, device=dev)
            _k5_check(q, k, v, pos, ks, vs, kind)


@pytest.mark.parametrize("kind", KV_DTYPES)
def test_cached_attention_grouped_serving_shape(dev, kind):
    """K5 at llama3-8b's prefill chunk (B=1, 32 query heads over 8 KV
    heads, T=64, S=1024, D=128) at bases beside the split edges and at
    960; the same result twice, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(22)
    q = torch.randn(1, 32, 64, 128, generator=g, device=dev)
    k, v, ks, vs = _cache(g, (1, 8, 1024, 128), kind, dev)
    split_tiles, n_split = tca.k5_split(32, 64, 1024)
    assert n_split > 1
    edge = split_tiles * tca.K5_TILE
    for base in (0, edge - 64, edge - 1, edge, 960):
        pos = torch.tensor([base], dtype=torch.int32, device=dev)
        first = _k5_check(q, k, v, pos, ks, vs, kind)
        second = tca.cached_attention(q, k, v, pos, ks=ks, vs=vs)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rows", [7, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["K6", "K7"])
def test_decode_kernels_at_seven_and_eight_rows(dev, paged, kind, d, rows):
    """K6 and K7 at R = 7 (Qwen2-7B's query group) and R = 8 (the widest
    the kernels take; TinyLlama's group), over S=1024 at the split edges,
    as test_decode_kernels_at_split_edges does at R <= 4."""
    q, k, v, ks, vs, tables = _decode_inputs(dev, paged, kind, d, rows,
                                             seed=23)
    pos = torch.tensor(_edge_positions(paged, 6, 2), dtype=torch.int32,
                       device=dev)
    _decode_check(paged, q, k, v, pos, ks, vs, kind, tables)


# --- bf16 queries (bf16 compute) and the captured decode step ---------
# K5, K6 and K7 read a bf16 q as it is and write a bf16 output. The plain
# version computes in f32 on the same bf16 q and rounds its output to
# bf16 once; the kernels round their f32 result once too, so the two
# differ by the summation order and, at most, one bf16 rounding step of
# the output (2^-8 of it, 2^-7 below a power of two): BF16_Q_TOL 2e-2 of
# the output's scale, its largest |value| (at least 1). An int8 cache
# here holds values up to 127 x 0.051, outputs up to about 6.5, where
# one step is 0.03125 (seen on an H100).
BF16_Q_TOL = 2e-2


def _bf16_q_check(fn, ref, args, kind, **scales):
    """One call with a bf16 q against the plain version on the same
    inputs: a bf16 output, one launch counted under the cache type and
    under launches_bf16_q."""
    before = (fn.launches_by_dtype[kind], fn.launches_bf16_q[kind])
    got = fn(*args, **scales)
    want = ref(*args, **scales)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert (fn.launches_by_dtype[kind], fn.launches_bf16_q[kind]) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= BF16_Q_TOL * scale, (err, scale)
    return got


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
def test_cached_attention_bf16_q(dev, kind, d, group):
    """K5 with a bf16 q over f32, bf16 and int8 caches, G = 1 and 4 (2
    KV heads), T of 40 and 65 rows, bases beside the split edges of
    S=1024 and at 960; the same output twice, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(31)
    k, v, ks, vs = _cache(g, (2, 2, 1024, d), kind, dev)
    split_tiles, _ = tca.k5_split(2 * 2 * group, 40, 1024)
    edge = split_tiles * tca.K5_TILE
    for t in (40, 65):
        q = torch.randn(2, 2 * group, t, d, generator=g,
                        device=dev).to(torch.bfloat16)
        for base in ([0, edge - 1], [edge, 960]):
            pos = torch.tensor(base, dtype=torch.int32, device=dev)
            first = _bf16_q_check(tca.cached_attention,
                                  tca.reference_cached_attention,
                                  (q, k, v, pos), kind, ks=ks, vs=vs)
            assert torch.equal(
                first, tca.cached_attention(q, k, v, pos, ks=ks, vs=vs))


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["K6", "K7"])
def test_decode_kernels_bf16_q(dev, paged, kind, d, rows):
    """K6 and K7 with a bf16 q over f32, bf16 and int8 caches, R = 1 and
    4, at S=1024 with positions beside the split edges (a stale dense
    slot, an inactive paged one)."""
    q, k, v, ks, vs, tables = _decode_inputs(dev, paged, kind, d, rows,
                                             seed=32)
    q = q.to(torch.bfloat16)
    pos = torch.tensor(_edge_positions(paged, 6, 2), dtype=torch.int32,
                       device=dev)
    fn = tca.paged_decode_attention if paged else tca.decode_attention
    ref = (tca.reference_paged_decode_attention if paged
           else tca.reference_decode_attention)
    args = (q, k, v, tables, pos) if paged else (q, k, v, pos)
    _bf16_q_check(fn, ref, args, kind, ks=ks, vs=vs)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("layout", [{"kv": "paged"}, {"kv": "dense"},
                                    {"kv": "paged", "kv_dtype": "int8"}],
                         ids=["paged", "dense", "paged-int8"])
def test_captured_decode_step_equals_eager(dev, compute, layout):
    """The batcher's decode step on the card is a replayed CUDA graph:
    after two admissions and two steps (one eager step and its capture,
    then one replay), one more replay of the graph gives the eager
    step's logits on the same static inputs bit for bit, and the
    replays counted the captured launches (one K7 or K6 per layer a
    step)."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import GPTConfig, init
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    cfg = GPTConfig(block_size=128, vocab_size=512, n_layer=3, n_head=4,
                    n_embd=256)
    cdt = torch.bfloat16 if compute == "bf16" else None
    prep = from_jax_params(init(5, cfg), cfg, dev, compute_dtype=cdt)
    b = ContinuousBatcher(cfg, prep, slots=3, max_len=128, prompt_pad=32,
                          block_len=16, device=dev, compute_dtype=cdt,
                          **layout)
    b.submit(list(range(1, 40)), 8)
    b.submit(list(range(7, 12)), 8)
    fn = (tca.paged_decode_attention if b.paged
          else tca.decode_attention)
    before = fn.launches
    b.step()
    b.step()
    step = b._graph_step
    assert (step.captures, step.replays) == (1, 1)
    assert fn.launches == before + 2 * cfg.n_layer
    step._graph.replay()
    step._log.replayed()
    torch.cuda.synchronize()
    replayed = step._logits.clone()
    eager = b._decode(b.cache, step.tok, step.pos, step.active)
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    assert fn.launches == before + 4 * cfg.n_layer


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("base", [37, 301, 1000])
def test_cached_attention_at_unaligned_bases(dev, kind, base):
    """K5 at the serving chunk (B=1 H=12 T=64 S=1024 D=64) from bases off
    the 16-position block grid, where the radix prefix cache resumes a
    prefill mid-block, against its plain version."""
    g = torch.Generator(device=dev).manual_seed(base)
    q = torch.randn(1, 12, 64, 64, generator=g, device=dev)
    k, v, ks, vs = _cache(g, (1, 12, 1024, 64), kind, dev)
    pos = torch.tensor([base], dtype=torch.int32, device=dev)
    _k5_check(q, k, v, pos, ks, vs, kind)


def _mixed_batcher(dev, compute, layout, **kw):
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import GPTConfig, init
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    cfg = GPTConfig(block_size=128, vocab_size=512, n_layer=3, n_head=4,
                    n_embd=256)
    cdt = torch.bfloat16 if compute == "bf16" else None
    prep = from_jax_params(init(5, cfg), cfg, dev, compute_dtype=cdt)
    return ContinuousBatcher(cfg, prep, slots=3, max_len=128, prompt_pad=32,
                             block_len=16, device=dev, compute_dtype=cdt,
                             **layout, **kw)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("layout", [{"kv": "paged"}, {"kv": "dense"},
                                    {"kv": "paged", "kv_dtype": "int8"}],
                         ids=["paged", "dense", "paged-int8"])
def test_captured_mixed_step_equals_eager(dev, compute, layout):
    """The mixed step on the card is a replayed CUDA graph (the decode leg
    and one 32-token chunk at a start position held in a device buffer):
    with one slot decoding while a 70-token prompt folds in three chunks
    (one eager mixed step and its capture, then replays), one more
    replay gives the eager mixed step's decode and chunk logits on the
    same static inputs bit for bit, and the replays counted the captured
    launches (K5 and the decode kernel once a layer a step)."""
    b = _mixed_batcher(dev, compute, layout, prefill_chunk_tokens=32)
    b.submit(list(range(1, 40)), 12)
    while b._pending_q:
        b.step()
    b.submit(list(range(7, 77)), 8)
    k5 = tca.cached_attention
    dec = tca.paged_decode_attention if b.paged else tca.decode_attention
    k5_0, dec_0 = k5.launches, dec.launches
    while b._pending_q:
        b.step()
    step = b._graph_step
    assert step.counts["mixed"] == [1, 4]  # 2 + 3 chunks: 1 capture
    assert k5.launches == k5_0 + 3 * 3 and dec.launches == dec_0 + 3 * 3
    graph, static, log, _ = step._graphs["mixed"]
    graph.replay()
    log.replayed()
    torch.cuda.synchronize()
    replayed = [t.clone() for t in static]
    eager = b._mixed(b.cache, step.tok, step.pos, step.active, b._row,
                     step.chunk, step.start)
    torch.cuda.synchronize()
    for r, e in zip(replayed, eager):
        assert torch.equal(r, e)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("layout", [{"kv": "paged"}, {"kv": "dense"},
                                    {"kv": "dense", "decode_buckets": True}],
                         ids=["paged", "dense", "dense-buckets"])
def test_interleaved_and_overlapped_streams_equal_convoy(dev, compute,
                                                         layout):
    """On the card, interleaved admission (32-token chunks in captured
    mixed steps) with and without the overlapped dispatch gives the
    convoy batcher's greedy streams token for token, for prompts of one,
    two and three chunks admitted while others decode."""
    def run(**kw):
        b = _mixed_batcher(dev, compute, layout, **kw)
        rids = [b.submit(list(range(3, 8)), 20),
                b.submit(list(range(1, 40)), 14)]
        for _ in range(3):
            b.step()
        rids.append(b.submit(list(range(11, 81)), 9))
        b.drain()
        return [b.results[r].tolist() for r in rids]

    want = run()
    assert run(prefill_chunk_tokens=32) == want
    assert run(prefill_chunk_tokens=32, overlap=True) == want
    assert run(overlap=True) == want


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16-q"])
@pytest.mark.parametrize("shape", [(4, 25, 25, 64), (4, 32, 8, 128)],
                         ids=["gpt2-xl", "llama3-8b"])
@pytest.mark.parametrize("bases", [(4, 69, 129, 299), (0, 511, 512, 960),
                                   (1019, 1020, 1022, 1023),
                                   (1023, 2000, 0, 1021)],
                         ids=["prompts", "split-edges", "end", "past-end"])
def test_cached_attention_at_the_verify_shapes(dev, shape, q_dtype, bases):
    """K5 at the speculative verify's call pattern: a (B=4, T=5) block of
    each slot at its own base over S=1024 (gpt2-xl's 25 heads at D=64,
    llama3-8b's 32 over 8 KV heads at D=128), f32 q over an f32 cache and
    bf16 q over a bf16 one; bases at the prompts' ends, beside the split
    edges, with rows reaching the cache's end, and past it (an inactive
    slot's stale base): against the plain version, and bit-equal run to
    run."""
    b, h, hk, d = shape
    g = torch.Generator(device=dev).manual_seed(sum(bases) + d)
    kind = "f32" if q_dtype == torch.float32 else "bf16"
    k, v, _, _ = _cache(g, (b, hk, 1024, d), kind, dev)
    q = torch.randn(b, h, 5, d, generator=g, device=dev).to(q_dtype)
    pos = torch.tensor(bases, dtype=torch.int32, device=dev)
    if q_dtype == torch.float32:
        got = _k5_check(q, k, v, pos, None, None, kind)
    else:
        got = _bf16_q_check(tca.cached_attention,
                            tca.reference_cached_attention, (q, k, v, pos),
                            kind)
    assert torch.equal(got, tca.cached_attention(q, k, v, pos))


def _spec_batcher(dev, compute, **kw):
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import GPTConfig, init
    from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher

    cfg = GPTConfig(block_size=256, vocab_size=512, n_layer=3, n_head=4,
                    n_embd=256)
    d_cfg = GPTConfig(block_size=256, vocab_size=512, n_layer=2, n_head=4,
                      n_embd=128)
    cdt = torch.bfloat16 if compute == "bf16" else None
    prep = from_jax_params(init(5, cfg), cfg, dev, compute_dtype=cdt)
    d_prep = from_jax_params(init(6, d_cfg), d_cfg, dev, compute_dtype=cdt)
    return SpeculativeBatcher(cfg, prep, d_cfg, d_prep, spec_k=4, slots=3,
                              max_len=256, prompt_pad=32, device=dev,
                              compute_dtype=cdt, **kw)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("kw", [{}, {"decode_buckets": True}],
                         ids=["dense", "dense-buckets"])
def test_captured_spec_step_equals_eager(dev, compute, kw):
    """The greedy speculative step on the card is one replayed CUDA graph
    (draft sync, 4 draft steps, the verify, acceptance, the slots' state
    updated in place): after two steps (one eager step and its capture,
    then one replay), one more replay from a saved state gives the eager
    step's block, accepted counts and the slots' state after it bit for
    bit, and the replays counted the captured launches (K5 once a draft
    and a target layer, K6 four times a draft layer)."""
    b = _spec_batcher(dev, compute, **kw)
    b.submit(list(range(1, 40)), 60)
    b.submit(list(range(7, 12)), 60)
    k5, k6 = tca.cached_attention, tca.decode_attention
    b.step()
    k5_0, k6_0 = k5.launches, k6.launches
    b.step()
    g = b._graph_step
    assert g.counts["spec"] == [1, 1]
    assert k5.launches == k5_0 + 5 and k6.launches == k6_0 + 4 * 2
    graph, static, log, _ = g._graphs["spec"]
    state = [b._tok_d, b._pos_d, b._prev_chunk, b._prev_pos]
    saved = [t.clone() for t in state]
    graph.replay()
    log.replayed()
    replayed = [t.clone() for t in (*static, *state)]
    for t, s in zip(state, saved):
        t.copy_(s)
    eager = [t.clone() for t in (*b._spec_core(), *state)]
    torch.cuda.synchronize()
    for r, e in zip(replayed, eager):
        assert torch.equal(r, e)
    assert k5.launches == k5_0 + 3 * 5 and k6.launches == k6_0 + 3 * 8


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_spec_streams_equal_the_plain_batcher(dev, compute):
    """On the card the speculative batcher's greedy streams (captured
    steps; interleaved and overlapped; through bucket rungs) equal the
    plain dense batcher's token for token."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b0 = _spec_batcher(dev, compute)
    plain = ContinuousBatcher(b0.cfg, b0.prepared, slots=3, max_len=256,
                              prompt_pad=32, device=dev, kv="dense",
                              compute_dtype=b0.compute_dtype)

    def run(b):
        rids = [b.submit(list(range(3, 8)), 60),
                b.submit(list(range(1, 40)), 44)]
        for _ in range(3):
            b.step()
        rids.append(b.submit(list(range(11, 81)), 29))
        b.drain()
        return [b.results[r].tolist() for r in rids]

    want = run(plain)
    assert run(b0) == want
    assert run(_spec_batcher(dev, compute, prefill_chunk_tokens=32,
                             overlap=True)) == want
    assert run(_spec_batcher(dev, compute, decode_buckets=True)) == want


def test_grammar_registered_after_capture_is_honoured(dev):
    """The constraint pools are allocated once and written in place: a
    grammar registered after the decode step was captured is honoured by
    the replayed steps (its stream equals the same request's on a
    batcher that never captured before it arrived), and the pools keep
    their storage."""
    from dnn_tpu_torch.runtime.constrain import TokenConstraint, byte_vocab

    c = TokenConstraint.from_regex(r"[0-9]{3,12}", byte_vocab(512))

    def run(early):
        b = _mixed_batcher(dev, "f32", {"kv": "paged"},
                           allow_constraints=True, constraint_rows=64)
        ptrs = (b._ctable.data_ptr(), b._ctrans.data_ptr())
        r0 = b.submit(list(range(1, 20)), 30)
        if early:
            b.step()
            b.step()
            assert b._graph_step.captures == 1
        r1 = b.submit(list(range(5, 30)), 16, constraint=c)
        b.drain()
        assert (b._ctable.data_ptr(), b._ctrans.data_ptr()) == ptrs
        return b.results[r0].tolist(), b.results[r1].tolist()

    late, fresh = run(True), run(False)
    assert late[1] == fresh[1]
    assert all(48 <= t <= 57 for t in late[1])


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16q"])
@pytest.mark.parametrize("s", [162, 1024])
def test_decode_attention_at_the_beam_shape(dev, q_dtype, s):
    """K6 at beam search's decode rows (B*K = 8 beams, Hk = 12, R = 1,
    D = 64), every beam at the same position (the last column, and one
    beside the first split edge), an f32 q over an f32 cache and a bf16
    q over a bf16 cache, against its plain version."""
    g = torch.Generator(device=dev).manual_seed(41)
    kind = "f32" if q_dtype == torch.float32 else "bf16"
    k, v, _, _ = _cache(g, (8, 12, s, 64), kind, dev)
    q = torch.randn(8, 12, 1, 64, generator=g, device=dev).to(q_dtype)
    split_keys, _ = tca.decode_split(8 * 12, s)
    for p in (s - 1, split_keys - 1, split_keys):
        pos = torch.full((8,), p, dtype=torch.int32, device=dev)
        if q_dtype == torch.bfloat16:
            _bf16_q_check(tca.decode_attention,
                          tca.reference_decode_attention, (q, k, v, pos),
                          kind)
        else:
            _decode_check(False, q, k, v, pos, None, None, kind)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_forward_at_the_embed_shape(dev, dtype):
    """K1 at the embedding endpoint's shape (B=4 H=12 T=S=320 D=64,
    causal) against its plain version (bf16 against the plain version in
    f32 on the same values), one launch counted."""
    g = torch.Generator(device=dev).manual_seed(42)
    q, k, v = (torch.randn(4, 12, 320, 64, generator=g, device=dev).to(dtype)
               for _ in range(3))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v).float()
    want = tfa.reference_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert (got - want).abs().max().item() <= _tol(dtype, want)


def _lora_batcher(dev, compute, **kw):
    """_mixed_batcher's model and pool serving three rank-4 adapters with
    nonzero b (a drawn from seeds on the card)."""
    from dnn_tpu_torch.lora import init_lora

    b0 = _mixed_batcher(dev, compute, {"kv": "paged"})
    ads = []
    for s in range(3):
        ad = init_lora(s, b0.prepared, rank=4)
        gen = torch.Generator(device=dev).manual_seed(10 + s)
        for ab in ad.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen,
                                  device=dev) * 0.05
        ads.append(ad)
    return _mixed_batcher(dev, compute, {"kv": "paged"}, lora_adapters=ads,
                          **kw)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_captured_lora_step_equals_eager_across_adapter_changes(dev,
                                                                compute):
    """Multi-LoRA serving on the card: the decode step is captured once
    over views that read a persistent one-hot buffer; after the slots'
    adapters are reassigned in place (a request cancelled, another
    admitted under another adapter) a replay still gives the eager
    step's logits bit for bit, no second capture is taken, and the
    interleaved mixed step's chunk runs under its request's adapter: the
    streams equal the convoy batcher's."""
    b = _lora_batcher(dev, compute)
    step = b._graph_step
    rids = [b.submit(list(range(1, 40)), 30, adapter=0),
            b.submit(list(range(7, 12)), 30, adapter=1),
            b.submit(list(range(20, 33)), 30)]

    def bit_check():
        step._graph.replay()
        step._log.replayed()
        torch.cuda.synchronize()
        replayed = step._logits.clone()
        eager = b._decode(b.cache, step.tok, step.pos, step.active)
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)

    for _ in range(3):
        b.step()
    bit_check()
    b.cancel(rids[0])
    b.submit(list(range(40, 60)), 10, adapter=2)
    b.cancel(rids[2])
    b.submit(list(range(60, 70)), 10, adapter=0)
    b.step()
    bit_check()
    assert step.captures == 1

    def run(**kw):
        bb = _lora_batcher(dev, compute, **kw)
        r = [bb.submit(list(range(3, 8)), 12, adapter=2),
             bb.submit(list(range(1, 40)), 10, adapter=0)]
        for _ in range(3):
            bb.step()
        r.append(bb.submit(list(range(11, 81)), 9, adapter=1))
        bb.drain()
        r.append(bb.submit(list(range(11, 81)), 9))
        bb.drain()
        return [bb.results[i].tolist() for i in r]

    want = run()
    assert want[2] != want[3], "the adapter changes the stream"
    assert run(prefill_chunk_tokens=32, overlap=True) == want


def test_embed_during_a_capture(dev):
    """The daemon's embed endpoint runs on the batcher's worker thread
    between two steps: embed requests sent while generate requests are
    being admitted and their decode step captured (on a fresh daemon)
    neither break the capture nor read a half-written buffer -- every
    embed reply equals the library's call bit for bit, every stream
    equals the same requests' on a daemon that served no embed, and the
    step was captured once."""
    import socket
    import threading

    import numpy as np

    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.runtime.embeddings import make_embed
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    b0 = _mixed_batcher(dev, "f32", {"kv": "paged"})
    cfg, prep = b0.cfg, b0.prepared
    prompts = [list(range(1 + i, 30 + 7 * i)) for i in range(3)]

    def serve(with_embeds):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        _, stop = start_lm_server_in_background(
            cfg, prep, port=port, slots=3, max_len=128, prompt_pad=32,
            block_len=16, device=dev, kv="paged")
        out, embeds, errors = {}, [], []
        try:
            client = NodeClient(f"127.0.0.1:{port}")
            assert client.wait_healthy(deadline=60)

            def gen(i):
                try:
                    out[i] = client.generate(prompts[i], max_new_tokens=20,
                                             timeout=120).tolist()
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)

            def emb():
                try:
                    for i in range(12):
                        p = prompts[i % 3]
                        rid = "embed:last" if i % 2 else "embed"
                        embeds.append((p, rid, client.send_tensor(
                            np.asarray(p, np.int32), request_id=rid,
                            timeout=120)[1]))
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)

            threads = [threading.Thread(target=gen, args=(i,))
                       for i in range(3)]
            if with_embeds:
                threads.insert(1, threading.Thread(target=emb))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            captures = stop.servicer.batcher._graph_step.captures
            client.close()
        finally:
            stop()
        assert not errors, errors
        return [out[i] for i in range(3)], embeds, captures

    streams, embeds, captures = serve(True)
    plain, _, _ = serve(False)
    assert streams == plain and captures == 1 and len(embeds) == 12
    for p, rid, vec in embeds:
        ids = torch.zeros((1, 32 * -(-len(p) // 32)), dtype=torch.int64,
                          device=dev)
        ids[0, :len(p)] = torch.tensor(p, device=dev)
        lib = make_embed(cfg, pooling="last" if rid.endswith("last")
                         else "mean")(prep, ids, [len(p)])[0].cpu()
        assert torch.equal(vec.float(), lib)


# ----------------------------------------------------------------------
# the sliding-window band, the softcap and head dim 256 (Mistral, Gemma)
# ----------------------------------------------------------------------

def _variant_check(fn, ref, args, kind, tol=ATOL, variants=(), **kw):
    """One wrapper call against its plain version with the same band /
    softcap arguments; one launch, counted under each of `variants`."""
    before = fn.launches_by_dtype[kind]
    var0 = {name: dict(by) for name, by in fn.launches_by_variant.items()}
    got = fn(*args, **kw)
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches_by_dtype[kind] == before + 1
    for name, by in fn.launches_by_variant.items():
        for dt, n in by.items():
            assert n == var0[name][dt] + (name in variants and dt == kind), \
                (name, dt)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err
    return got


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("group,t", [(1, 65), (8, 40), (2, 1)])
def test_cached_attention_head_dim_256(dev, kind, group, t):
    """K5 at D = 256 (Gemma): grouped heads (gemma-2b's G = 8 over one KV
    head), a ragged chunk, bases beside the split edges; the f32 cache's
    tiles converted straight from global memory."""
    g = torch.Generator(device=dev).manual_seed(21)
    hk = 2 if group < 8 else 1
    q = torch.randn(3, hk * group, t, 256, generator=g, device=dev)
    k, v, ks, vs = _cache(g, (3, hk, 700, 256), kind, dev)
    pos = torch.tensor([0, 383, 700 - t], dtype=torch.int32, device=dev)
    _variant_check(tca.cached_attention, tca.reference_cached_attention,
                   (q, k, v, pos), kind, variants=("d256",), ks=ks, vs=vs)


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["K6", "K7"])
def test_decode_kernels_head_dim_256(dev, paged, kind, rows):
    """K6 / K7 at D = 256 (8 head dims a lane, a key row a warp), over
    1024 columns split beside their edges."""
    q, k, v, ks, vs, tables = _decode_inputs(dev, False, kind, 256, rows,
                                             seed=22)
    if paged:
        q, k, v, ks, vs, tables = _decode_inputs(dev, True, kind, 256, rows,
                                                 seed=22)
    pos = torch.tensor(_edge_positions(paged, 6, 2), dtype=torch.int32,
                       device=dev)
    fn = tca.paged_decode_attention if paged else tca.decode_attention
    ref = (tca.reference_paged_decode_attention if paged
           else tca.reference_decode_attention)
    args = (q, k, v, tables, pos) if paged else (q, k, v, pos)
    _variant_check(fn, ref, args, kind, variants=("d256",), ks=ks, vs=vs)


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("window,softcap", [(100, None), (1, None),
                                            (300, 2.0), (None, 1.5)])
def test_cached_attention_band_and_softcap(dev, kind, d, window, softcap):
    """K5 with a window (rows whose band starts mid-split, in an earlier
    split, or at the row itself: window 1, where a row's first tiles hold
    no live column of it) and / or a softcap (small caps, so that unit
    scores bend), grouped heads, a chunk at bases beside the split edges
    of S = 1024 (several splits, so the merge reads only the splits
    inside each row's band)."""
    g = torch.Generator(device=dev).manual_seed(23)
    q = torch.randn(4, 4, 70, d, generator=g, device=dev)
    k, v, ks, vs = _cache(g, (4, 2, 1024, d), kind, dev)
    pos = torch.tensor([0, 191, 500, 954], dtype=torch.int32, device=dev)
    variants = (("band",) if window else ()) + (
        ("softcap",) if softcap else ()) + (("d256",) if d == 256 else ())
    _variant_check(tca.cached_attention, tca.reference_cached_attention,
                   (q, k, v, pos), kind, variants=variants, ks=ks, vs=vs,
                   window=window, softcap=softcap)


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["K6", "K7"])
def test_decode_kernels_band(dev, paged, kind, d, rows):
    """K6 / K7 with a window at positions beside the split edges: bands
    that start in an earlier split, mid-split and on a split's first
    column; K6 also with the softcap."""
    q, k, v, ks, vs, tables = _decode_inputs(dev, paged, kind, d, rows,
                                             seed=24)
    split_keys, _ = tca.decode_split(12, 1024, 16 if paged else 1)
    pos = torch.tensor([split_keys - 1, split_keys, 3 * split_keys + 5,
                        1023, 517, 2 if paged else 1024], dtype=torch.int32,
                       device=dev)
    fn = tca.paged_decode_attention if paged else tca.decode_attention
    ref = (tca.reference_paged_decode_attention if paged
           else tca.reference_decode_attention)
    args = (q * 3, k, v, tables, pos) if paged else (q * 3, k, v, pos)
    d256 = ("d256",) if d == 256 else ()
    for window in (split_keys + 1, 2 * split_keys, 40):
        _variant_check(fn, ref, args, kind, variants=("band",) + d256,
                       ks=ks, vs=vs, window=window)
    if not paged:
        _variant_check(fn, ref, args, kind,
                       variants=("band", "softcap") + d256, ks=ks, vs=vs,
                       window=300, softcap=50.0)


@pytest.mark.parametrize("kind", KV_DTYPES)
def test_paged_band_never_reads_reclaimed_blocks(dev, kind):
    """A windowed pool points the table entries of its rolled-out blocks
    at the junk block 0. K7 skips the blocks before the band rather than
    reading and masking them: with NaN in block 0 the output is finite
    and equals the plain version on a table whose dead entries point at
    real blocks."""
    q, kp, vp, ks, vs, tables = _decode_inputs(dev, True, kind, 128, 4,
                                               seed=25)
    tables[-1] = tables[0].flip(0)  # every slot live
    pos = torch.tensor([700, 1023, 64, 300, 999, 0], dtype=torch.int32,
                       device=dev)
    window = 200
    dead = tables.clone()
    for b, p in enumerate(pos.tolist()):
        dead[b, :max(0, p - window + 1) // 16] = 0
    for leaf in (kp, vp) if kind != "int8" else (ks, vs):
        leaf[0] = float("nan")
    got = tca.paged_decode_attention(q, kp, vp, dead, pos, ks=ks, vs=vs,
                                     window=window)
    want = tca.reference_paged_decode_attention(q, kp, vp, tables, pos,
                                                ks=ks, vs=vs, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.parametrize("paged", [False, True], ids=["K6", "K7"])
def test_decode_band_replays_in_a_cuda_graph(dev, paged):
    """A banded K6 / K7 call captured in a CUDA graph (the window baked
    into the launch), the positions moved on the device, the graph
    replayed: the output follows the new positions' bands."""
    q, k, v, ks, vs, tables = _decode_inputs(dev, paged, "bf16", 128, 4,
                                             seed=26)
    pos = torch.tensor([5, 300, 700, 1000, 64, 129], dtype=torch.int32,
                       device=dev)
    fn = tca.paged_decode_attention if paged else tca.decode_attention
    ref = (tca.reference_paged_decode_attention if paged
           else tca.reference_decode_attention)
    args = (q, k, v, tables, pos) if paged else (q, k, v, pos)
    fn(*args, window=256)  # loads the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args, window=256)
    pos.copy_(torch.tensor([1023, 17, 512, 256, 900, 3], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    want = ref(*args, window=256)
    assert (out - want).abs().max().item() <= ATOL


# --- the band, the softcap and D = 256 with a bf16 q (bf16 compute) -----
# [mistral] and [gemma2] serve in bf16 compute, so every banded, softcapped
# or D = 256 launch of theirs takes a bf16 q. Held as _bf16_q_check holds
# a bf16 q, but within BF16_Q_TOL of the output's own largest |value| (no
# floor at 1: a banded row's output can be far below 1), and with a
# control: the plain version without the band / the cap must miss the
# kernel by more than that tolerance, so a kernel that skipped either
# would fail here.

def _bf16_q_variant_check(fn, ref, args, kind, variants, **kw):
    """One call with a bf16 q against the plain version with the same
    band / cap: a bf16 output within BF16_Q_TOL of the output's scale,
    one launch counted under the cache type, launches_bf16_q and each of
    `variants`; the plain version without each of the band and the cap
    that the call has misses by more than the tolerance."""
    before = (fn.launches_by_dtype[kind], fn.launches_bf16_q[kind],
              {name: dict(by) for name, by in fn.launches_by_variant.items()})
    got = fn(*args, **kw)
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert (fn.launches_by_dtype[kind], fn.launches_bf16_q[kind]) == (
        before[0] + 1, before[1] + 1)
    for name, by in fn.launches_by_variant.items():
        for dt, n in by.items():
            assert n == before[2][name][dt] + (name in variants
                                               and dt == kind), (name, dt)
    assert torch.isfinite(got.float()).all()
    tol = BF16_Q_TOL * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)
    for arg in ("window", "softcap"):
        if kw.get(arg) is not None:
            miss = (got.float() - ref(*args, **{**kw, arg: None}).float())
            assert miss.abs().max().item() > tol, (arg, miss, tol)
    return got


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d,window,softcap", [
    (128, 100, None), (128, 300, 2.0), (128, None, 1.5), (256, 100, None),
    (256, 300, 2.0), (256, None, 1.5), (256, None, None)])
def test_cached_attention_bf16_q_band_softcap(dev, kind, d, window, softcap):
    """K5 with a bf16 q, the band and / or the softcap, at D = 128
    (mistral-7b) and 256 (gemma2-9b; gemma-2b without either): grouped
    heads, a chunk at bases beside the split edges of S = 1024."""
    g = torch.Generator(device=dev).manual_seed(33)
    q = torch.randn(4, 4, 70, d, generator=g, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(g, (4, 2, 1024, d), kind, dev)
    pos = torch.tensor([0, 191, 500, 954], dtype=torch.int32, device=dev)
    variants = (("band",) if window else ()) + (
        ("softcap",) if softcap else ()) + (("d256",) if d == 256 else ())
    _bf16_q_variant_check(tca.cached_attention,
                          tca.reference_cached_attention, (q, k, v, pos),
                          kind, variants, ks=ks, vs=vs, window=window,
                          softcap=softcap)


@pytest.mark.parametrize("kind", KV_DTYPES)
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["K6", "K7"])
def test_decode_kernels_bf16_q_band_softcap(dev, paged, kind, d, rows):
    """K6 / K7 with a bf16 q and a window at positions beside the split
    edges (bands that start in an earlier split, mid-split, on a split's
    first column); K6 also with the softcap; D = 256 without either."""
    q, k, v, ks, vs, tables = _decode_inputs(dev, paged, kind, d, rows,
                                             seed=34)
    q = (q * 3).to(torch.bfloat16)
    split_keys, _ = tca.decode_split(12, 1024, 16 if paged else 1)
    pos = torch.tensor([split_keys - 1, split_keys, 3 * split_keys + 5,
                        1023, 517, 2 if paged else 1024], dtype=torch.int32,
                       device=dev)
    fn = tca.paged_decode_attention if paged else tca.decode_attention
    ref = (tca.reference_paged_decode_attention if paged
           else tca.reference_decode_attention)
    args = (q, k, v, tables, pos) if paged else (q, k, v, pos)
    d256 = ("d256",) if d == 256 else ()
    for window in (split_keys + 1, 40):
        _bf16_q_variant_check(fn, ref, args, kind, ("band",) + d256, ks=ks,
                              vs=vs, window=window)
    if not paged:
        _bf16_q_variant_check(fn, ref, args, kind,
                              ("band", "softcap") + d256, ks=ks, vs=vs,
                              window=300, softcap=2.0)
    if d == 256:
        _bf16_q_variant_check(fn, ref, args, kind, d256, ks=ks, vs=vs)
