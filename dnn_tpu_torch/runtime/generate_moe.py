"""KV-cache generation for the MoE GPT family (port of
dnn_tpu/runtime/generate_moe.py:64-103).

The dense family's cached machinery (runtime/generate.py) with the block
MLP swapped for the routed MoE FFN (parallel/moe.py) through the `ffn`
hook. A forward routes the tokens it sees: the prompt as one group (the
stateless forward's routing at batch 1), then the B current tokens of
each decode step. Without drops (capacity_factor >= n_experts) top-k
routing is per token, so decode equals the full-sequence forward; with
drops the result depends on the tokens routed together, as in JAX.

`make_pipeline_generate_moe` is PP x dense MoE: the pipeline-parallel
decoder (runtime/generate.make_pipeline_generate) with the routed FFN
plugged into GPTPipelineFamily, each stage keeping its layers' full
expert sets. The expert-parallel decoders (`make_generate_moe_ep`,
`make_pipeline_generate_moe_ep`) shard experts across ranks and need
torch.distributed (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Optional

from dnn_tpu_torch.models.gpt_moe import GPTMoEConfig
from dnn_tpu_torch.parallel.moe import moe_ffn, unported_ep
from dnn_tpu_torch.runtime.generate import forward_with_cache, make_generate

__all__ = [
    "moe_cache_ffn",
    "forward_with_cache_moe",
    "make_generate_moe",
    "make_generate_moe_ep",
    "make_pipeline_generate_moe",
    "make_pipeline_generate_moe_ep",
]


def moe_cache_ffn(cfg: GPTMoEConfig, *, groups: int = 1, compute_dtype=None):
    """The `ffn(bp, h)` hook that turns a dense cached decoder
    (forward_with_cache, make_generate, ContinuousBatcher) into its MoE
    counterpart: h's tokens route through bp["moe"] in `groups` groups."""

    def ffn(bp, h):
        return moe_ffn(bp["moe"], h, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor, groups=groups,
                       compute_dtype=compute_dtype)

    return ffn


def forward_with_cache_moe(prepared, ids, cache, start_pos, *,
                           cfg: GPTMoEConfig, compute_dtype=None,
                           groups: int = 1):
    """generate.forward_with_cache with the routed FFN: ids (B, T) at
    [start_pos, start_pos + T), routed in `groups` groups a layer."""
    return forward_with_cache(
        prepared, ids, cache, start_pos, cfg=cfg,
        compute_dtype=compute_dtype,
        ffn=moe_cache_ffn(cfg, groups=groups, compute_dtype=compute_dtype))


def make_generate_moe(cfg: GPTMoEConfig, *, max_new_tokens: int,
                      temperature: float = 0.0,
                      sample_top_k: Optional[int] = None,
                      sample_top_p: Optional[float] = None,
                      compute_dtype=None, groups: int = 1, device=None):
    """generate(prepared, ids, seed=0) for the MoE family: the dense
    family's make_generate with the routed FFN plugged in. `sample_top_k`
    is the sampling truncation (cfg.top_k is the routing fan-out)."""
    return make_generate(
        cfg, max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=sample_top_k, top_p=sample_top_p, compute_dtype=compute_dtype,
        ffn=moe_cache_ffn(cfg, groups=groups, compute_dtype=compute_dtype),
        device=device)


make_generate_moe_ep = unported_ep("make_generate_moe_ep",
                                   "runtime/generate_moe.py:312")
def make_pipeline_generate_moe(cfg: GPTMoEConfig, mesh, *,
                               max_new_tokens: int,
                               temperature: float = 0.0,
                               sample_top_k: Optional[int] = None,
                               compute_dtype=None, groups: int = 1,
                               axis_name=None, kv_dtype=None):
    """Pipeline-parallel MoE decode over the stage mesh (JAX :106):
    generate(stage_blocks, aux, ids, seed=0) over
    generate.prepare_pipeline_stacked's layout. Experts are not sharded
    (each stage holds its layers' experts); tokens equal
    make_generate_moe's on the same grouping."""
    from dnn_tpu_torch.runtime.generate import (
        GPTPipelineFamily,
        make_pipeline_generate,
    )

    fam = GPTPipelineFamily(
        cfg, compute_dtype=compute_dtype, kv_dtype=kv_dtype,
        ffn=moe_cache_ffn(cfg, groups=groups, compute_dtype=compute_dtype))
    return make_pipeline_generate(
        cfg, mesh, max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=sample_top_k, axis_name=axis_name, family=fam)


make_pipeline_generate_moe_ep = unported_ep("make_pipeline_generate_moe_ep",
                                            "runtime/generate_moe.py:132")
