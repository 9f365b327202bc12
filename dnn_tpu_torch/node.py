"""Command-line entry point of the port (port of dnn_tpu/node.py).

    # a pipeline stage behind gRPC; part 0 with --input_image also sends
    # the image through the pipeline and prints the prediction
    python -m dnn_tpu_torch.node --node_id node1 --config cfg.json --serve \\
        [--input_image img.png] [--transport {auto,grpc}]
    # the whole pipeline in this process (the single-controller default)
    python -m dnn_tpu_torch.node --node_id node1 --config cfg.json \\
        [--input_image img.png]
    # GPT and LLaMA families: decode N tokens in this process
    python -m dnn_tpu_torch.node --node_id node1 --config cfg.json \\
        --generate N [--prompt_ids 1,2,3] [--temperature T] [--top_k K] \\
        [--top_p P] [--seed S]
    # the LM daemon
    python -m dnn_tpu_torch.node --node_id node1 --config cfg.json \\
        --serve_lm [--slots 4] [--max_len 1024] [--prompt_pad 64] \\
        [--kv {paged,dense,auto}] [--kv_dtype {f32,bf16,int8}] \\
        [--decode_buckets] [--paged_blocks 0] [--block_len 16] \\
        [--seed 0] [--weights_npz params.npz] [--tokenizer bytes|DIR]

The config is the JAX package's topology schema (config.TopologyConfig).
Weights come from its `model_weights` (.pth, .safetensors or .npz) or,
when that is null, from a seeded random init (seed 0; the LM daemon
draws from --seed, and --weights_npz overrides both with a JAX param
tree). Everything runs on the CUDA card unless the config's
`device_type` is "cpu" or --device cpu is given; without a card the
default raises.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

import numpy as np
import torch

from dnn_tpu_torch import resolve_device
from dnn_tpu_torch.config import TopologyConfig, config_device

log = logging.getLogger("dnn_tpu_torch.node")

# flags of the JAX CLI whose subsystems are not ported: each exits 2
_UNPORTED = (
    ("beam", "--beam: beam search", "ROADMAP PyTorch/CUDA port item 4"),
    ("lora", "--lora: LoRA merge", "ROADMAP Queue 1 item 8"),
    ("metrics_port", "--metrics_port: the observability endpoint",
     "ROADMAP Queue 1 item 12"),
    ("supervise", "--supervise: the supervisor", "ROADMAP Queue 1 item 11"),
    ("chaos", "--chaos: fault plans", "ROADMAP Queue 1 item 11"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dnn_tpu_torch.node")
    p.add_argument("--node_id", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--input_image",
                   help="image path (part_index 0 initiates inference; a "
                        "missing file means the dummy image)")
    p.add_argument("--generate", type=int, metavar="N", default=None,
                   help="GPT and LLaMA families: decode N new tokens and "
                   "print them")
    p.add_argument("--prompt_ids", default=None,
                   help="comma-separated prompt token ids for --generate "
                        "(default: the single token 0)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--serve", action="store_true",
                   help="host this node's stage behind gRPC")
    p.add_argument("--transport", choices=["auto", "grpc", "shm", "device"],
                   default=None,
                   help="--serve: the hop transport; this port speaks grpc "
                        "(auto resolves to it)")
    p.add_argument("--serve_lm", action="store_true",
                   help="run the LM daemon")
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
    p.add_argument("--seed", type=int, default=0,
                   help="--generate: the sampling seed; --serve_lm: also "
                        "the seed of random weights")
    p.add_argument("--tokenizer", default=None,
                   help="--serve_lm: the text front's tokenizer, 'bytes' "
                        "(UTF-8 bytes as ids; any vocab >= 256) or a local "
                        "HF tokenizer directory; SendMessage then serves "
                        "prompt text -> generated text")
    p.add_argument("--weights_npz", default=None,
                   help="--serve_lm: a JAX GPT or LLaMA param tree (.npz, "
                   "'/'-joined "
                        "keys) in place of the config's model_weights")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="override the config's device_type")
    p.add_argument("--beam", type=int, default=None)
    p.add_argument("--lora", default=None)
    p.add_argument("--metrics_port", type=int, default=None)
    p.add_argument("--supervise", action="store_true")
    p.add_argument("--chaos", default=None)
    p.add_argument("--log_level", default="INFO")
    return p


def _initiate_local(engine, image_path) -> int:
    """The whole pipeline in this process on the image (or the dummy
    image); prints the prediction."""
    from dnn_tpu_torch.io.preprocess import load_image_or_dummy

    x, used_dummy = load_image_or_dummy(image_path)
    if used_dummy and image_path:
        log.warning("input image unavailable; using dummy data")
    pred = engine.predict(x)
    print(f"***** FINAL PREDICTION (Index): {pred} *****", flush=True)
    return pred


async def _initiate_edge(engine, node_id: str, image_path: str,
                         health_deadline: float = 60.0):
    """Stage 0 here, then the activation down the gRPC pipeline once the
    next node answers its health check; prints the prediction from the
    response chain. Blocking work runs on worker threads, so this
    node's own server stays responsive."""
    from dnn_tpu_torch.comm.client import NodeClient, pipeline_budget
    from dnn_tpu_torch.io.preprocess import load_image_or_dummy
    from dnn_tpu_torch.parallel.pipeline import sync

    cfg = engine.config
    me = cfg.node_by_id(node_id)
    nxt = cfg.next_node(me)
    x, used_dummy = load_image_or_dummy(image_path)
    if used_dummy:
        log.warning("input image unavailable; using dummy data")

    def stage0():
        y = engine.run_stage(me.part_index, x)
        sync(y.device)
        return y.cpu()

    y = await asyncio.to_thread(stage0)
    if nxt is None:
        pred = int(torch.argmax(y.float().flatten()))
        print(f"***** FINAL PREDICTION (Index): {pred} *****", flush=True)
        return
    client = NodeClient(nxt.address)
    try:
        if not await asyncio.to_thread(client.wait_healthy,
                                       deadline=health_deadline):
            log.error("next node %s not healthy after %.0fs", nxt.address,
                      health_deadline)
            return
        status, result = await asyncio.to_thread(
            client.send_tensor, y, request_id="dnn_tpu_pipe_001",
            timeout=pipeline_budget(cfg.num_parts))
    finally:
        client.close()
    log.info("pipeline status: %s", status)
    if result is not None:
        pred = int(torch.argmax(result.float().flatten()))
        print(f"***** FINAL PREDICTION (Index): {pred} *****", flush=True)
    else:
        log.error("no result tensor in response chain")


def _generate_local(engine, args) -> int:
    """prompt ids -> --generate N tokens on this process's engine."""
    if args.prompt_ids:
        try:
            ids = [int(s) for s in args.prompt_ids.split(",") if s.strip()]
        except ValueError:
            log.error("--prompt_ids must be comma-separated integers, got %r",
                      args.prompt_ids)
            return 1
        if not ids:
            log.error("--prompt_ids contained no token ids: %r",
                      args.prompt_ids)
            return 1
    else:
        ids = [0]
    try:
        toks = engine.generate(np.asarray([ids], np.int32),
                               max_new_tokens=args.generate,
                               temperature=args.temperature, top_k=args.top_k,
                               top_p=args.top_p, seed=args.seed)
    except NotImplementedError as e:
        log.error("generation failed: %s", e)
        return 2
    except (ValueError, RuntimeError) as e:
        log.error("generation failed: %s", e)
        return 1
    out = ",".join(str(int(t)) for t in toks[0].tolist())
    print(f"***** GENERATED TOKENS: {out} *****", flush=True)
    return 0


def _tokenizer(spec: str, vocab_size: int):
    """--tokenizer: "bytes" or a local HF tokenizer directory, refused
    when its vocab exceeds the model's (its ids would index past the
    embedding table)."""
    from dnn_tpu_torch.io.tokenizer import ByteTokenizer, load_hf_tokenizer

    tok = (ByteTokenizer(vocab_size) if spec == "bytes"
           else load_hf_tokenizer(spec))
    if tok.vocab_size > vocab_size:
        raise ValueError(f"tokenizer vocab {tok.vocab_size} exceeds the "
                         f"model's vocab_size {vocab_size}")
    return tok


def _serve_lm(config: TopologyConfig, me, args) -> int:
    """The LM daemon on this node's port, with the config's weights."""
    from dnn_tpu_torch.convert import from_jax_params, load_npz
    from dnn_tpu_torch.models.gpt import GPTConfig
    from dnn_tpu_torch.models.llama import LlamaConfig
    from dnn_tpu_torch.registry import get_model
    from dnn_tpu_torch.runtime.engine import load_params
    from dnn_tpu_torch.runtime.lm_server import serve_lm

    try:
        spec = get_model(config.model)
        if type(spec.config) not in (GPTConfig, LlamaConfig):
            raise ValueError(f"--serve_lm requires a GPT-family or "
                             f"LLaMA-family model; '{config.model}' is not "
                             "one")
        if me.port is None:
            raise ValueError(f"node '{me.id}' has no IP:Port address in the "
                             "config; the LM daemon needs one to bind")
        cfg = spec.config
        device = (resolve_device(args.device) if args.device
                  else config_device(config.device_type))
        tree = (load_npz(args.weights_npz) if args.weights_npz
                else load_params(config, spec, args.seed))
        prepared = from_jax_params(tree, cfg, device)
    except (OSError, KeyError, ValueError, RuntimeError) as e:
        log.error("%s", e)
        return 1
    tokenizer = None
    if args.tokenizer:
        try:
            tokenizer = _tokenizer(args.tokenizer, cfg.vocab_size)
        except Exception as e:  # noqa: BLE001 — CLI boundary: one line
            log.error("tokenizer setup failed: %s", e)
            return 1
    log.info("node %s: LM daemon, model %s, device %s", me.id, config.model,
             device)
    try:
        return asyncio.run(serve_lm(
            cfg, prepared, port=me.port, slots=args.slots,
            max_len=args.max_len, prompt_pad=args.prompt_pad,
            kv=args.kv, kv_dtype=args.kv_dtype,
            decode_buckets=args.decode_buckets,
            paged_blocks=args.paged_blocks, block_len=args.block_len,
            seed=args.seed, device=device, tokenizer=tokenizer))
    except (NotImplementedError, ValueError) as e:
        # e.g. --kv_dtype int4, or a sliding-window preset (ROADMAP item 2)
        log.error("%s", e)
        return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)
    for attr, what, tag in _UNPORTED:
        if getattr(args, attr) is not None and getattr(args, attr) is not False:
            log.error("%s is not ported to dnn_tpu_torch yet (%s)", what, tag)
            return 2
    if args.transport in ("shm", "device"):
        log.error("--transport %s is not ported to dnn_tpu_torch yet (ROADMAP "
                  "Queue 1 item 7's remainder); this port speaks grpc",
                  args.transport)
        return 2
    if args.transport is not None and not args.serve:
        log.error("--transport applies to --serve (the gRPC edge "
                  "deployment's inter-stage hops)")
        return 1
    try:
        config = TopologyConfig.from_json(args.config)
        me = config.node_by_id(args.node_id)
    except FileNotFoundError:
        log.error("Config file not found at '%s'", args.config)
        return 1
    except NotImplementedError as e:
        log.error("%s", e)
        return 2
    except (ValueError, KeyError) as e:
        log.error("Invalid config '%s': %s", args.config, e)
        return 1
    if args.serve_lm:
        return _serve_lm(config, me, args)

    from dnn_tpu_torch.runtime.engine import PipelineEngine

    try:
        engine = PipelineEngine(
            config, role="stage" if args.serve else "full",
            devices=[resolve_device(args.device)] if args.device else None)
    except NotImplementedError as e:
        log.error("%s", e)
        return 2
    except Exception as e:  # noqa: BLE001 — CLI boundary: a clean one-liner
        log.error("engine construction failed: %s", e)
        return 1
    log.info("node %s: part %d/%d, runtime %s, model %s, device %s", me.id,
             me.part_index, config.num_parts - 1, engine.runtime,
             config.model, engine.devices[0])

    if args.serve:
        from dnn_tpu_torch.comm.service import serve_stage

        async def _run():
            tasks = [asyncio.create_task(serve_stage(
                engine, args.node_id, transport=args.transport))]
            if me.part_index == 0 and args.input_image:
                tasks.append(asyncio.create_task(
                    _initiate_edge(engine, args.node_id, args.input_image)))
            await asyncio.gather(*tasks)

        try:
            asyncio.run(_run())
        except KeyboardInterrupt:
            log.info("shutting down")
        except Exception as e:  # noqa: BLE001 — CLI boundary
            log.error("serve failed: %s", e)
            return 1
        return 0

    if args.generate is not None:
        return _generate_local(engine, args)
    if args.input_image or me.part_index == 0:
        _initiate_local(engine, args.input_image)
    else:
        log.info("nothing to do for a non-initiator node in single-controller "
                 "mode (use --serve for the gRPC pipeline)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
