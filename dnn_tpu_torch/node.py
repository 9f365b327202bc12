"""Command-line entry point of the port: the LM daemon.

    python -m dnn_tpu_torch.node --node_id node1 --config cfg.json \\
        --serve_lm [--slots 4] [--max_len 1024] [--prompt_pad 64] \\
        [--kv {paged,dense,auto}] [--kv_dtype {f32,bf16,int8}] \\
        [--decode_buckets] [--paged_blocks 0] [--block_len 16] \\
        [--seed 0] [--weights_npz params.npz] [--device cuda]

The config is the JAX daemon's schema: `nodes[].{id, address,
part_index}` and a top-level `model` naming a GPT preset
(models/gpt.PRESETS). This node binds the port of its own `address`.
Weights come from --weights_npz (the JAX param tree, "/"-joined keys —
convert.load_npz) or, without it, are drawn from --seed. The daemon
runs on the card; --device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys

from dnn_tpu_torch import resolve_device
from dnn_tpu_torch.convert import from_jax_params, load_npz
from dnn_tpu_torch.models.gpt import PRESETS, init

log = logging.getLogger("dnn_tpu_torch.node")


def load_node(config_path: str, node_id: str):
    """(model name, port) for `node_id` from a topology config."""
    with open(config_path) as f:
        cfg = json.load(f)
    model = cfg.get("model", "gpt2")
    for node in cfg.get("nodes", []):
        if node.get("id") == node_id:
            address = node.get("address")
            if not address:
                raise ValueError(f"node '{node_id}' has no address; the LM "
                                 "daemon needs IP:Port to bind")
            try:
                port = int(address.rsplit(":", 1)[-1])
            except ValueError:
                raise ValueError(f"invalid address '{address}' for node "
                                 f"'{node_id}'; expected IP:Port") from None
            return model, port
    raise ValueError(f"node '{node_id}' not in {config_path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dnn_tpu_torch.node")
    p.add_argument("--node_id", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--serve_lm", action="store_true",
                   help="run the LM daemon (the only mode of this port)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max_len", type=int, default=None)
    p.add_argument("--prompt_pad", type=int, default=None)
    p.add_argument("--kv", choices=["paged", "dense", "auto"],
                   default="auto",
                   help="KV cache layout: 'auto' serves the paged block "
                        "pool whenever this configuration can page and "
                        "falls back to the dense per-slot pool otherwise "
                        "(logged); 'dense' opts out; 'paged' fails loud "
                        "when paging is impossible")
    p.add_argument("--kv_dtype", choices=["f32", "bf16", "int8", "int4"],
                   default=None,
                   help="KV cache storage (default f32). int8 quantizes "
                        "with per-(position, head) scales: 4x less cache "
                        "traffic than f32. int4 is not ported yet")
    p.add_argument("--decode_buckets", action="store_true",
                   help="length-aware bucketed decode: the dense pool "
                        "grows bucket by bucket with the live context "
                        "(dense pools only)")
    p.add_argument("--paged_blocks", type=int, default=0,
                   help="paged pool size in blocks (0 with --kv paged/"
                        "auto sizes it to the dense pool's capacity)")
    p.add_argument("--block_len", type=int, default=16,
                   help="positions per paged-pool block")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights_npz", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--log_level", default="INFO")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)
    if not args.serve_lm:
        log.error("this port serves --serve_lm only (ROADMAP PyTorch/CUDA "
                  "port: pipeline stages and training come later)")
        return 2
    from dnn_tpu_torch.runtime.lm_server import serve_lm

    try:
        model, port = load_node(args.config, args.node_id)
        if model not in PRESETS:
            raise ValueError(f"model '{model}' is not a GPT preset "
                             f"({sorted(PRESETS)})")
        cfg = PRESETS[model]
        device = resolve_device(args.device)
        tree = (load_npz(args.weights_npz) if args.weights_npz
                else init(args.seed, cfg))
        prepared = from_jax_params(tree, cfg, device)
    except (OSError, ValueError, RuntimeError) as e:
        log.error("%s", e)
        return 1
    try:
        return asyncio.run(serve_lm(
            cfg, prepared, port=port, slots=args.slots,
            max_len=args.max_len, prompt_pad=args.prompt_pad,
            kv=args.kv, kv_dtype=args.kv_dtype,
            decode_buckets=args.decode_buckets,
            paged_blocks=args.paged_blocks, block_len=args.block_len,
            seed=args.seed, device=device))
    except (NotImplementedError, ValueError) as e:
        log.error("%s", e)  # e.g. --kv_dtype int4 (ROADMAP item 2)
        return 2


if __name__ == "__main__":
    sys.exit(main())
