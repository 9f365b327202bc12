"""The port's MoE FFN (dnn_tpu_torch/parallel/moe.py) and the int8 expert
stacks of its quantizer, on the CPU against the JAX package's
(dnn_tpu/parallel/moe.py, dnn_tpu/quant.py) on the same numpy inputs.

Tolerances: routing dispatch bit-equal (a 0/1 tensor: the same slots),
combine weights and aux within 1e-6 (f32 softmax and a renormalising
division in a different summation order), the FFN's output within 2e-5
of its scale in f32 (the expert products sum in another order); the
quantizer's int8 values and scales bit-equal. The expert-parallel
builders are not ported: each raises naming ROADMAP Queue 1 item 10."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu import quant as jquant
from dnn_tpu.parallel import moe as jmoe
from dnn_tpu_torch import quant as tquant
from dnn_tpu_torch.parallel import moe as tmoe
from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)

D, F, E = 32, 48, 4


def _logits(s, e, seed, skew):
    """(S, E) gate logits; `skew` adds a column ramp, so the first experts
    take most selections and a tight capacity drops some."""
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((s, e)).astype(np.float32)
    return lg + np.float32(skew) * np.linspace(1, 0, e, dtype=np.float32)


@pytest.mark.parametrize("s,e,k,cf,normalize,skew", [
    (16, 4, 2, 1.25, True, 2.0),    # drops
    (16, 4, 2, 1.25, False, 2.0),
    (16, 4, 2, 4.0, True, 0.0),     # no drop possible (cf >= E)
    (16, 4, 3, 1.0, False, 3.0),    # three rounds, heavy drops
])
def test_route_topk_matches_jax(s, e, k, cf, normalize, skew):
    lg = _logits(s, e, 0, skew)
    cap = jmoe.moe_capacity(s, e, k, cf)
    assert tmoe.moe_capacity(s, e, k, cf) == cap
    jd, jc, ja = jax.jit(functools.partial(
        jmoe.route_topk, top_k=k, capacity=cap, normalize=normalize))(
            jnp.asarray(lg))
    td, tc, ta = tmoe.route_topk(torch.from_numpy(lg), top_k=k,
                                 capacity=cap, normalize=normalize)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    for key in ("load", "importance"):
        np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]),
                                   rtol=0, atol=1e-6)
    if skew >= 2.0:  # the drop cases do drop
        assert td.sum() < s * k


def test_route_topk_ties_take_the_first_maximum():
    """Equal logits: argmax takes the first expert, as jnp.argmax; and a
    batch of groups routes as each group alone."""
    lg = np.zeros((16, 4), np.float32)
    lg[:, 2] = lg[:, 3] = 1.0
    jd, _, _ = jax.jit(functools.partial(jmoe.route_topk, top_k=2,
                                         capacity=16))(jnp.asarray(lg))
    td, _, _ = tmoe.route_topk(torch.from_numpy(lg), top_k=2, capacity=16)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td[:, 2].sum() == 16 and td[:, 3].sum() == 16
    groups = np.stack([_logits(16, 4, s, 2.0) for s in range(3)])
    cap = tmoe.moe_capacity(16, 4, 2, 1.25)
    bd, bc, _ = tmoe.route_topk(torch.from_numpy(groups), top_k=2,
                                capacity=cap)
    for g in range(3):
        d1, c1, _ = tmoe.route_topk(torch.from_numpy(groups[g]), top_k=2,
                                    capacity=cap)
        assert torch.equal(bd[g], d1) and torch.equal(bc[g], c1)


def _moe_params(gated, seed):
    """JAX's init_moe / init_moe_gated tree with every leaf redrawn from
    a numpy seed (biases too): numpy leaves."""
    key = jax.random.PRNGKey(seed)
    tree = jax.eval_shape(lambda: (jmoe.init_moe_gated(key, D, E, F)
                                   if gated else jmoe.init_moe(key, D, E, F)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.2).astype(np.float32),
        tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("gated,groups,weights,cf", [
    (False, 1, "f32", 1.25), (False, 2, "int8", 1.25),
    (False, 1, "int8", 4.0), (True, 2, "f32", 1.25),
    (True, 1, "int8", 1.25), (True, 2, "int8", 4.0)])
def test_moe_ffn_matches_jax(gated, groups, weights, cf):
    p = _moe_params(gated, seed=1)
    if weights == "int8":
        p = jax.tree.map(np.asarray, jax.jit(jquant.quantize_tree)(
            jax.tree.map(jnp.asarray, p)))
    x = np.random.default_rng(2).standard_normal((2, 12, D)).astype(
        np.float32) * np.linspace(0.5, 2.0, D, dtype=np.float32)
    kw = dict(top_k=2, capacity_factor=cf, groups=groups, return_aux=True,
              normalize=not gated)
    jy, ja = jax.jit(functools.partial(jmoe.moe_ffn, **kw))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    ty, ta = tmoe.moe_ffn(_torch(p), torch.from_numpy(x), **kw)
    jy = np.asarray(jy)
    scale = np.abs(jy).max()
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=2e-5 * scale)
    for key in ("load", "importance"):
        np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        float(tmoe.load_balance_loss(ta)),
        float(jmoe.load_balance_loss(ja)), rtol=1e-6)


def test_moe_ffn_bf16_compute_matches_jax():
    """Operands in bf16, f32 accumulators: JAX's bf16 einsum with an f32
    accumulator. Held at 1e-2 of the output's scale: silu/gelu round
    differently in bf16 on JAX's CPU (ROADMAP "Known differences")."""
    for gated in (False, True):
        p = _moe_params(gated, seed=3)
        x = np.random.default_rng(4).standard_normal((1, 10, D)).astype(
            np.float32)
        jy = np.asarray(jax.jit(functools.partial(
            jmoe.moe_ffn, compute_dtype=jnp.bfloat16, capacity_factor=2.0))(
                jax.tree.map(jnp.asarray, p), jnp.asarray(x, jnp.bfloat16)),
            np.float32)
        ty = tmoe.moe_ffn(_torch(p), torch.from_numpy(x).bfloat16(),
                          compute_dtype=torch.bfloat16,
                          capacity_factor=2.0).float().numpy()
        np.testing.assert_allclose(ty, jy, rtol=0,
                                   atol=1e-2 * np.abs(jy).max())


def test_quantize_tree_expert_stacks_bit_equal_and_idempotent():
    """JAX's structural rule: raw 3-D (and stacked 4-D) wi/wo and
    wg/wu/wd stacks become int8 with per-(expert, channel) scales,
    bit-equal to JAX's; int4 leaves the stacks at int8; the router stays
    f32; re-quantizing changes nothing."""
    p = {"a": _moe_params(False, 5), "b": _moe_params(True, 6),
         "proj": {"kernel": np.random.default_rng(7).standard_normal(
             (64, 64)).astype(np.float32)}}
    stacked = {"moe": jax.tree.map(lambda a: np.stack([a, 2 * a]),
                                   _moe_params(True, 8))}
    for tree in (p, stacked):
        # eager, as the JAX package quantizes (under jit XLA may
        # rewrite the division and round differently)
        jq = jax.tree.map(np.asarray, jquant.quantize_tree(
            jax.tree.map(jnp.asarray, tree)))
        tq = tquant.quantize_tree(_torch(tree))
        tq2 = tquant.quantize_tree(tq)
        jflat = jax.tree_util.tree_leaves_with_path(jq)
        tflat = jax.tree_util.tree_leaves_with_path(tq)
        assert [k for k, _ in jflat] == [k for k, _ in tflat]
        for (path, j), (_, t) in zip(jflat, tflat):
            name = jax.tree_util.keystr(path)
            if j.dtype == np.int8:
                assert t.dtype == torch.int8, name
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
        for a, b in zip(jax.tree.leaves(tq), jax.tree.leaves(tq2)):
            assert a is b
    # int4 (JAX's rule: the stacks keep int8, only 2-D kernels pack):
    # every expert leaf as at 8 bits, held to JAX's just above
    q4, q8 = tquant.quantize_tree(_torch(p), bits=4), tquant.quantize_tree(
        _torch(p))
    for part in ("a", "b"):
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(q4[part]),
                jax.tree_util.tree_leaves_with_path(q8[part])):
            assert a.dtype == b.dtype and torch.equal(a, b), path
    assert q4["proj"]["q"].dtype == torch.uint8  # packed int4
    q = q8
    assert q["b"]["router"]["kernel"].dtype == torch.float32
    assert q["b"]["wg"].dtype == torch.int8 and q["b"]["wg_scale"].shape \
        == (E, 1, F)


@pytest.mark.parametrize("builder", [
    "parallel.moe.moe_ffn_local", "parallel.moe.make_moe_ffn_ep",
    "models.gpt_moe.make_apply_ep", "models.llama_moe.make_apply_ep",
    "models.llama_moe.make_generate_ep",
    "models.llama_moe.make_pipeline_generate_ep",
    "runtime.generate_moe.make_generate_moe_ep",
    "runtime.generate_moe.make_pipeline_generate_moe",
    "runtime.generate_moe.make_pipeline_generate_moe_ep"])
def test_expert_parallel_builders_name_their_item(builder):
    import importlib

    mod, name = builder.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"dnn_tpu_torch.{mod}"), name)
    if name == "make_pipeline_generate_moe":
        # PP x dense MoE needs no expert parallelism and is ported with
        # the pipeline decoders: it builds on a CPU stage mesh (its tokens
        # are held against JAX's in test_torch_pipeline_generate.py)
        from dnn_tpu_torch.models.gpt_moe import PRESETS

        assert callable(fn(PRESETS["gpt2-moe-test"], ["cpu"] * 2,
                           max_new_tokens=2))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        fn(None, None)
