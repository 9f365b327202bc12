"""The port's flash attention on the CPU against the JAX package: the
plain twins of K1/K2 (forward, with and without the logsumexp) against
JAX's reference_attention and its Pallas kernel in interpret mode, and
the port's autograd Function (the plain twins of K2/K3/K4) against
jax.grad through the interpret-mode kernels. Inputs are drawn with numpy
from a seed and handed to both packages.

The forward and the gradients run in f32 and in bf16 (the same draws,
cast to bf16 on both sides). Tolerances are JAX's own
(tests/test_flash_attention.py) in f32: 2e-5 on the forward, atol 2e-4 /
rtol 1e-4 on gradients; in bf16 2e-2 on outputs, 1e-4 on the logsumexp
and 2e-2 x each gradient's max |value|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_tpu.ops.pallas.flash_attention import flash_attention as jflash
from dnn_tpu.ops.pallas.flash_attention import reference_attention as jref_attn
from dnn_tpu_torch.ops.cuda import flash_attention as tfa

FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-4


def _qkv(seed, t, s, b=1, h=2, d=32, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, d)).astype(dtype)
    k = rng.standard_normal((b, h, s, d)).astype(dtype)
    v = rng.standard_normal((b, h, s, d)).astype(dtype)
    return q, k, v


CASES = [(True, 128, 128), (False, 128, 128), (True, 128, 256)]


# (numpy/JAX/torch dtype, output tolerance, lse tolerance). bf16: both
# sides round the output to bf16 (a step of 2^-8 near 1) and JAX's
# reference also rounds the scores and p to bf16, so 2e-2; the lse is
# f32 from the same bf16 values, so 1e-4.
DTYPES = {"f32": (jnp.float32, torch.float32, FWD_TOL, FWD_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 1e-4)}


# f32 cases keep the ids of the cases before bf16 joined them
FWD_CASES = [pytest.param(*c, dt, id="-".join(map(str, c))
                          + ("" if dt == "f32" else f"-{dt}"))
             for dt in DTYPES for c in CASES]


@pytest.mark.parametrize("causal,t,s,dtype", FWD_CASES)
def test_plain_forward_matches_jax_reference_and_interpret_kernel(causal, t,
                                                                  s, dtype):
    jdt, tdt, tol, lse_tol = DTYPES[dtype]
    q, k, v = _qkv(0, t, s)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jref = np.asarray(jref_attn(jq, jk, jv, causal=causal), np.float32)
    jker = np.asarray(jflash(jq, jk, jv, causal=causal, block_q=64,
                             block_k=64, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    plain = tfa.reference_attention(tq, tk, tv, causal=causal)
    with_lse, lse = tfa.flash_attention_lse(tq, tk, tv, causal=causal)
    no_grad = tfa.flash_attention(tq, tk, tv, causal=causal)
    for got in (plain, with_lse, no_grad):
        assert got.dtype == tdt
        got = got.float().numpy()
        np.testing.assert_allclose(got, jref, atol=tol, rtol=tol)
        np.testing.assert_allclose(got, jker, atol=tol, rtol=tol)
    # the logsumexp against the f64 formula on the same (rounded) values,
    # bottom-right mask
    s64 = np.einsum("bhtd,bhsd->bhts", tq.double().numpy(),
                    tk.double().numpy()) / np.sqrt(q.shape[-1])
    if causal:
        s64 = np.where(np.tril(np.ones((t, s), bool), s - t), s64, -1e30)
    want = np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1)) \
        + s64.max(-1)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, t)
    np.testing.assert_allclose(lse.numpy(), want, atol=lse_tol, rtol=0)


@pytest.mark.parametrize("causal,t,s,dtype", FWD_CASES)
def test_gradients_match_jax_grad_through_interpret_kernels(causal, t, s,
                                                            dtype):
    """f32: JAX's own gradient tolerances. bf16 (the same draws cast to
    bf16 on both sides, the weights w in f32): both sides round the
    output, dO and the gradients to bf16, so the loss is held at 2e-2
    relative and each gradient at 2e-2 x its max |value|."""
    jdt, tdt, tol, _ = DTYPES[dtype]
    q, k, v = _qkv(1, t, s)
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jflash(q, k, v, causal=causal, block_q=64, block_k=64,
                     interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (q, k, v))
    tl = (tfa.flash_attention(tq, tk, tv, causal=causal)
          * torch.from_numpy(w)).sum()
    tg = torch.autograd.grad(tl, (tq, tk, tv))
    f32 = dtype == "f32"
    np.testing.assert_allclose(tl.item(), float(jl),
                               rtol=GRAD_RTOL if f32 else tol)
    for name, a, b in zip("qkv", tg, jg):
        assert a.dtype == tdt
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        np.testing.assert_allclose(
            a, b, atol=GRAD_ATOL if f32 else tol * np.abs(b).max(),
            rtol=GRAD_RTOL if f32 else 0, err_msg=f"d{name}")


@pytest.mark.parametrize("causal,t,s", [(True, 5, 5), (False, 4, 6),
                                        (True, 3, 7)])
def test_plain_backward_gradcheck_float64(causal, t, s):
    """The autograd Function over the plain twins of K2/K3/K4 in
    float64: analytic gradients against finite differences."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(3, t, s, h=2, d=4, dtype=np.float64))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal),
        (q, k, v))


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_against_plain_formula(causal):
    """T = S = 100 (not a multiple of any tile): forward and gradients
    against autograd through the plain formula."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(4, 100, 100, b=2, h=3))
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        q.shape).astype(np.float32))
    out = tfa.flash_attention(q, k, v, causal=causal)
    ref = tfa.reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=FWD_TOL, rtol=FWD_TOL)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    want = torch.autograd.grad((ref * w).sum(), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_grad_mode_selects_the_forward_kernel():
    """With no gradient needed the entry takes K1's path (plain
    reference_attention here); with one, the Function (K2's twin)."""
    q, k, v = map(torch.from_numpy, _qkv(6, 8, 8))
    assert tfa.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = tfa.flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert tfa.flash_attention(qg, k, v).grad_fn is None


def test_refusals():
    q, k, v = map(torch.from_numpy, _qkv(7, 16, 8))
    with pytest.raises(ValueError, match="S=8 < T=16"):
        tfa.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="S=8 < T=16"):
        tfa.flash_attention_lse(q, k, v, causal=True)
    tfa.flash_attention(q, k, v, causal=False)  # full attention is fine
    q, k, v = map(torch.from_numpy, _qkv(7, 8, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention(q, k.bfloat16(), v)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(TypeError, match="float32"):
        tfa.flash_bwd_dq(q, k, v, q, lse.double(), lse)
    with pytest.raises(ValueError, match="must be"):
        tfa.flash_bwd_dkv(q, k, v, q, lse[..., :4], lse)
