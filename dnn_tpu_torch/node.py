"""Command-line entry point of the port (port of dnn_tpu/node.py).

    # a pipeline stage behind gRPC; part 0 with --input_image also sends
    # the image through the pipeline and prints the prediction
    python -m dnn_tpu_torch.node --node_id node1 --config cfg.json --serve \\
        [--input_image img.png] [--transport {auto,grpc,shm,device}] \\
        [--metrics_port PORT] [--chaos PLAN]
    # the whole pipeline in this process (the single-controller default)
    python -m dnn_tpu_torch.node --node_id node1 --config cfg.json \\
        [--input_image img.png]
    # GPT and LLaMA families: decode N tokens in this process
    python -m dnn_tpu_torch.node --node_id node1 --config cfg.json \\
        --generate N [--prompt_ids 1,2,3] [--temperature T] [--top_k K] \\
        [--top_p P] [--seed S] [--beam K [--eos_id E] \\
        [--length_penalty A]] [--lora adapter.npz]
    # the LM daemon
    python -m dnn_tpu_torch.node --node_id node1 --config cfg.json \\
        --serve_lm [--slots 4] [--max_len 1024] [--prompt_pad 64] \\
        [--kv {paged,dense,auto}] [--kv_dtype {f32,bf16,int8,int4}] \\
        [--decode_buckets] [--paged_blocks 0] [--block_len 16] \\
        [--prefix_cache N] [--prefill_chunk_tokens N] [--overlap] \\
        [--seed 0] [--weights_npz params.npz] [--tokenizer bytes|DIR] \\
        [--draft_model NAME [--draft_weights CKPT] [--spec_k 4]] \\
        [--weights {f32,int8}] [--lora adapter.npz] \\
        [--serve_adapter a.npz [--serve_adapter b.npz ...]] \\
        [--role {prefill,decode,both}] [--kv_handoff_ttl_s 120] \\
        [--kv_lease_ttl_s 30] [--min_p P] [--repetition_penalty R] \\
        [--metrics_port PORT] [--watchdog_s S \\
        [--on_wedged {503,restart,drain}]] [--chaos PLAN] \\
        [--slo_ttft_ms MS] [--slo_itl_ms MS] [--slo_avail F] \\
        [--slo_target F] [--fleet_port PORT [--fleet_targets URLS] \\
        [--fleet_interval S]]

The config is the JAX package's topology schema (config.TopologyConfig).
Weights come from its `model_weights` (.pth, .safetensors or .npz) or,
when that is null, from a seeded random init (seed 0; the LM daemon
draws from --seed, and --weights_npz overrides both with a JAX param
tree; --lora merges an adapter artifact into them at load). Everything
runs on the CUDA card unless the config's
`device_type` is "cpu" or --device cpu is given; without a card the
default raises. The LM daemon drains on SIGTERM (exit 0) and exits 43
when its watchdog's wedged policy escalates; --metrics_port serves GET
/metrics /healthz /statusz /debugz /stepz /kvz and GET/POST /profilez,
and POST /drainz; with --serve, /metrics /healthz /debugz /trace and
/profilez of the stage server. --chaos installs a fault plan in either
serving mode (the stage server's seams: perturb_rpc("stage") before
each forward, perturb_relay() on Relay frames). --fleet_port (with --serve_lm or --serve) runs the
fleet collector beside the mode and serves the merged /fleetz.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys
from typing import Optional

import numpy as np
import torch

from dnn_tpu_torch import resolve_device
from dnn_tpu_torch.config import TopologyConfig, config_device
from dnn_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("dnn_tpu_torch.node")

# flags of the JAX CLI whose subsystems are not ported: each exits 2 when
# given a value other than its default
_UNPORTED = (
    ("supervise", "--supervise: the supervisor", "ROADMAP Queue 1 item 11"),
    ("route", "--route: the fleet front door", "ROADMAP Queue 1 item 11"),
    ("route_targets", "--route_targets: the fleet front door",
     "ROADMAP Queue 1 item 11"),
    ("route_signals", "--route_signals: the fleet front door",
     "ROADMAP Queue 1 item 11"),
    ("policy", "--policy: the fleet front door's routing policies",
     "ROADMAP Queue 1 item 11"),
    ("kvtier", "--kvtier: the fleet front door's prefix-aware placement",
     "ROADMAP Queue 1 item 11"),
    ("process_id", "--process_id: multi-host runs",
     "ROADMAP Queue 1 item 10"),
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
    p.add_argument("--min_p", type=float, default=None,
                   help="--serve_lm: drop tokens below min_p x the top "
                        "token's probability (per-request m= overrides)")
    p.add_argument("--repetition_penalty", type=float, default=None,
                   help="--serve_lm: HF-style repetition penalty over each "
                        "request's tokens (per-request r= overrides)")
    p.add_argument("--beam", type=int, default=None, metavar="K",
                   help="--generate: deterministic beam search with K beams "
                        "instead of sampling (dense GPT family; "
                        "runtime/beam.py)")
    p.add_argument("--eos_id", type=int, default=None,
                   help="--beam: end-of-sequence token id (finished beams "
                        "freeze; the output pads with it)")
    p.add_argument("--length_penalty", type=float, default=0.0,
                   help="--beam: GNMT length-penalty alpha (0 = off)")
    p.add_argument("--lora", default=None, metavar="NPZ",
                   help="a LoRA adapter artifact (lora.save_lora) merged "
                        "into the model weights at load: every mode then "
                        "serves the adapted model")
    p.add_argument("--serve_adapter", action="append", default=None,
                   metavar="NPZ",
                   help="--serve_lm: serve this LoRA adapter per request "
                        "beside the base model (repeatable; a request "
                        "picks one with the a=IDX request-id option, "
                        "0-based in flag order)")
    p.add_argument("--serve", action="store_true",
                   help="host this node's stage behind gRPC")
    p.add_argument("--transport", choices=["auto", "grpc", "shm", "device"],
                   default=None,
                   help="--serve: the inter-stage hop transport "
                        "(comm/transport.py). 'auto' (default, or the "
                        "config's `transport` key) negotiates device -> "
                        "shm -> grpc per hop; an explicit device or shm "
                        "that the next node cannot grant fails loud")
    p.add_argument("--serve_lm", action="store_true",
                   help="run the LM daemon")
    p.add_argument("--role", choices=["prefill", "decode", "both"],
                   default="both",
                   help="--serve_lm: this replica's fleet role in a "
                        "disaggregated prefill/decode split; advisory "
                        "(every endpoint still serves)")
    p.add_argument("--kv_handoff_ttl_s", type=float, default=120.0,
                   help="--serve_lm: a staged prefill handoff (kvput:) "
                        "nobody consumes is swept after this many seconds "
                        "(<= 0 disables)")
    p.add_argument("--kv_lease_ttl_s", type=float, default=30.0,
                   help="--serve_lm: a staged block export (kvlease) an "
                        "adopter never pulls or acks is reclaimed after "
                        "this many seconds")
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
                        "traffic than f32; int4 at 7 levels, two values "
                        "a byte: 8x less")
    p.add_argument("--decode_buckets", action="store_true",
                   help="length-aware bucketed decode: the dense pool "
                        "grows bucket by bucket with the live context "
                        "(dense pools only)")
    p.add_argument("--paged_blocks", type=int, default=0,
                   help="paged pool size in blocks (0 with --kv paged/"
                        "auto sizes it to the dense pool's capacity)")
    p.add_argument("--block_len", type=int, default=16,
                   help="positions per paged-pool block")
    p.add_argument("--prefix_cache", type=int, default=0,
                   help="--serve_lm: prefix-cache capacity (dense pools: "
                        "LRU entries, each one transient row; paged "
                        "pools: resident blocks of the radix store); "
                        "requests sharing a prompt prefix skip its "
                        "chunks. 0 disables (default)")
    p.add_argument("--prefill_chunk_tokens", type=int, default=0,
                   metavar="N",
                   help="--serve_lm: interleaved chunked prefill — fold "
                        "one N-token chunk of an admitting prompt into "
                        "each decode step (the mixed step) instead of "
                        "prefilling the whole prompt at admission. 0 "
                        "(default) keeps the convoy path")
    p.add_argument("--overlap", action="store_true",
                   help="--serve_lm: dispatch step N+1 before committing "
                        "step N's tokens, so the host's bookkeeping runs "
                        "under the device step (tokens surface one step "
                        "later)")
    p.add_argument("--draft_model", default=None,
                   help="--serve_lm: model-zoo name of a dense GPT-family "
                        "DRAFT model — enables speculative continuous "
                        "batching (each step commits up to spec_k+1 tokens "
                        "a slot; runtime/serving_spec.py)")
    p.add_argument("--draft_weights", default=None,
                   help="--serve_lm: checkpoint of the draft model "
                        "(.pth/npz/safetensors; random init if omitted)")
    p.add_argument("--spec_k", type=int, default=4,
                   help="--serve_lm: draft proposals per speculative step")
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
    p.add_argument("--weights", choices=["f32", "int8"], default="f32",
                   help="--serve_lm: served weight precision; int8 "
                        "quantizes the model once at startup (symmetric "
                        "per output channel, quant.py)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="override the config's device_type")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="--serve_lm / --serve: also serve the "
                        "observability endpoint on this port over plain "
                        "HTTP: GET /metrics "
                        "(Prometheus text), /healthz, /statusz (the "
                        "watchdog's per-component state), /debugz (the "
                        "flight recorder's ring), POST /drainz (0 = an "
                        "ephemeral port)")
    p.add_argument("--watchdog_s", type=float, default=None, metavar="S",
                   help="--serve_lm: run the hung-device watchdog with this "
                        "probe period in seconds (a subprocess-bounded probe "
                        "of the daemon's device and the decode heartbeat; "
                        "/healthz degrades ok|degraded|wedged). Off unless "
                        "given")
    p.add_argument("--on_wedged", choices=["503", "restart", "drain"],
                   default="503",
                   help="--serve_lm: the policy when the watchdog declares "
                        "wedged. '503' (default): /healthz answers 503. "
                        "'restart': exit 43 at once, so a supervisor "
                        "relaunches the process. 'drain': finish in-flight "
                        "decodes within the drain grace, hand queued work "
                        "back retriable, then exit 43. Needs --watchdog_s")
    p.add_argument("--supervise", action="store_true")
    # the JAX CLI's router and multi-host flags, with its types and
    # choices; refused (_UNPORTED)
    p.add_argument("--route", action="store_true")
    p.add_argument("--route_targets", default=None)
    p.add_argument("--route_signals", default=None)
    p.add_argument("--policy",
                   choices=["round_robin", "least_queue", "slo_burn"],
                   default="least_queue")
    p.add_argument("--kvtier", choices=["auto", "pull", "off"],
                   default="auto")
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--fleet_port", type=int, default=None, metavar="PORT",
                   help="--serve/--serve_lm: also run the fleet collector "
                        "in this process and serve the merged /fleetz view "
                        "on this port (obs/fleet.py; 0 = ephemeral). Its "
                        "targets come from --fleet_targets, or with "
                        "--serve_lm from the config's node hosts + "
                        "--metrics_port")
    p.add_argument("--fleet_targets", default=None,
                   help="comma-separated obs endpoint base URLs "
                        "(http://host:port) for --fleet_port, one a stage")
    p.add_argument("--fleet_interval", type=float, default=None,
                   help="--fleet_port: poll period in seconds (default 5)")
    p.add_argument("--chaos", default=None, metavar="PLAN",
                   help="--serve_lm / --serve: install a fault-injection "
                        "plan in this "
                        "process (dnn_tpu_torch/chaos; a JSON file path or "
                        "inline JSON); each injection is a chaos_inject "
                        "flight event")
    p.add_argument("--slo_ttft_ms", type=float, default=None,
                   help="--serve_lm: TTFT objective in ms -- 99%% of "
                        "requests (see --slo_target) must see their "
                        "first token within it; exported as the "
                        "dnn_tpu_slo_burn_rate{slo=\"ttft\"} "
                        "error-budget gauge with a flight event on "
                        "breach (dnn_tpu_torch/obs/goodput.py)")
    p.add_argument("--slo_itl_ms", type=float, default=None,
                   help="--serve_lm: inter-token latency objective in "
                        "ms (slo=\"inter_token\" burn-rate gauge)")
    p.add_argument("--slo_avail", type=float, default=None,
                   help="--serve_lm: availability objective as a "
                        "success fraction, e.g. 0.999 "
                        "(slo=\"availability\" burn-rate gauge)")
    p.add_argument("--slo_target", type=float, default=None,
                   help="--serve_lm: fraction of requests that must "
                        "meet each latency objective (default 0.99; "
                        "needs at least one --slo_* objective)")
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
                         health_deadline: float = 60.0,
                         transport: Optional[str] = None):
    """Stage 0 here, then the activation down the pipeline once the next
    node answers its health check, over the hop `transport` (None: the
    config's, "auto" by default) negotiates; prints the prediction from
    the response chain. Blocking work runs on worker threads, so this
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
    client = NodeClient(nxt.address,
                        transport=transport or cfg.transport)
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
        if args.beam is not None:
            # any explicit --beam takes the deterministic path (beam 1 is
            # greedy; a bad K surfaces beam.py's own check)
            toks = engine.generate_beam(
                np.asarray([ids], np.int32), max_new_tokens=args.generate,
                beam_size=args.beam, eos_id=args.eos_id,
                length_penalty=args.length_penalty)
        else:
            toks = engine.generate(np.asarray([ids], np.int32),
                                   max_new_tokens=args.generate,
                                   temperature=args.temperature,
                                   top_k=args.top_k, top_p=args.top_p,
                                   seed=args.seed)
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


def _draft(args, cfg, device, compute_dtype) -> dict:
    """--draft_model's speculative-serving arguments (JAX node.py:925-967):
    a dense GPT-family zoo entry of the target's vocabulary, its weights
    from --draft_weights (through io/checkpoint.py and the model's
    converter) or, without them, a random init (seed 0, logged)."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import GPTConfig
    from dnn_tpu_torch.registry import get_model
    from dnn_tpu_torch.runtime.engine import checkpoint_params

    d_spec = get_model(args.draft_model)
    d_cfg = d_spec.config
    if type(d_cfg) is not GPTConfig:
        raise ValueError(f"--draft_model must name a dense GPT-family zoo "
                         f"entry, got '{args.draft_model}'")
    if d_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(f"draft vocab {d_cfg.vocab_size} != target vocab "
                         f"{cfg.vocab_size}")
    if args.draft_weights:
        tree = checkpoint_params(args.draft_weights, d_spec)
    else:
        log.warning("no --draft_weights; the draft uses a random init "
                    "(wiring and testing only: a random draft accepts "
                    "almost nothing)")
        tree = d_spec.init(0)
    return {"draft_cfg": d_cfg, "spec_k": args.spec_k,
            "draft_prepared": from_jax_params(tree, d_cfg, device,
                                              compute_dtype)}


def _serve_adapters(args, cfg) -> dict:
    """--serve_adapter's batcher arguments: each artifact loaded
    (lora.load_lora), a per-layer one restacked to the served layout,
    its alpha beside it."""
    from dnn_tpu_torch.lora import adapters_to_stacked, load_lora

    ads, alphas = [], []
    for path in args.serve_adapter:
        ad, alpha = load_lora(path)
        if any(p.split("/")[0].startswith("h_") for p in ad):
            ad = adapters_to_stacked(ad, cfg.n_layer)
        ads.append(ad)
        alphas.append(alpha)
    return {"lora_adapters": ads, "lora_alphas": alphas}


def _resilience_kwargs(args) -> dict:
    """LMServer's resilience arguments the flags set (the rest keep
    LMServer's defaults: no endpoint, no watchdog, a passive 503)."""
    out = {k: v for k, v in (("metrics_port", args.metrics_port),
                             ("watchdog", args.watchdog_s)) if v is not None}
    if args.on_wedged != "503":
        out["on_wedged"] = args.on_wedged
    if any(v is not None for v in (args.slo_ttft_ms, args.slo_itl_ms,
                                   args.slo_avail)):
        # the SLOs the goodput tracker turns into burn rates (JAX
        # node.py:969-981)
        from dnn_tpu_torch.obs.goodput import SLOConfig

        out["slo"] = SLOConfig(
            ttft_s=(args.slo_ttft_ms / 1e3 if args.slo_ttft_ms is not None
                    else None),
            inter_token_s=(args.slo_itl_ms / 1e3
                           if args.slo_itl_ms is not None else None),
            availability=args.slo_avail,
            target=args.slo_target if args.slo_target is not None else 0.99)
    return out


def _serve_lm(config: TopologyConfig, me, args) -> int:
    """The LM daemon on this node's port, with the config's weights (a
    --lora artifact merged in), at the config's compute type (`"dtype":
    "bfloat16"` serves in bf16 compute, as JAX's daemon does:
    dnn_tpu/node.py passes the engine's compute_dtype); --weights int8
    quantizes the f32 tree before the cast. With --draft_model it
    serves speculatively, without logit biases or constraints (the
    speculative batcher takes neither); otherwise both are on, as JAX's
    node turns them on. --serve_adapter serves LoRA adapters per
    request (a=). Returns serve_lm's code: 0 after a SIGTERM drain, 43
    (lm_server.EXIT_RESTART) after a wedged-policy escalation."""
    from dnn_tpu_torch.models.gpt import GPTConfig
    from dnn_tpu_torch.models.gpt_moe import GPTMoEConfig
    from dnn_tpu_torch.models.llama import LlamaConfig
    from dnn_tpu_torch.registry import get_model
    from dnn_tpu_torch.runtime.engine import _DTYPES, served_params
    from dnn_tpu_torch.runtime.lm_server import serve_lm

    try:
        spec = get_model(config.model)
        if not (isinstance(spec.config, (GPTMoEConfig, LlamaConfig))
                or type(spec.config) is GPTConfig):
            raise ValueError(f"--serve_lm requires a GPT-family or "
                             f"LLaMA-family model; '{config.model}' is not "
                             "one")
        if me.port is None:
            raise ValueError(f"node '{me.id}' has no IP:Port address in the "
                             "config; the LM daemon needs one to bind")
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{config.dtype}")
        compute_dtype = _DTYPES[config.dtype]
        cfg = spec.config
        device = (resolve_device(args.device) if args.device
                  else config_device(config.device_type))
        # int8 weights stay f32 here (the server quantizes them); a MoE
        # model's random weights are drawn on the card block by block
        prepared = served_params(config, spec, args.seed, device,
                                 weights=args.weights,
                                 compute_dtype=compute_dtype,
                                 weights_npz=args.weights_npz, lora=args.lora)
    except (OSError, KeyError, ValueError, RuntimeError) as e:
        log.error("%s", e)
        return 1
    moe_kwargs = {}
    if isinstance(cfg, GPTMoEConfig):
        # the GPT-MoE family serves as GPT blocks with the routed FFN
        # plugged in (JAX node.py:850-868); a Mixtral config's family
        # adapter resolves its experts from the config
        from dnn_tpu_torch.runtime.generate_moe import moe_cache_ffn

        moe_kwargs["ffn"] = moe_cache_ffn(cfg, compute_dtype=compute_dtype)
    lora_kwargs = {}
    if args.serve_adapter:
        try:
            lora_kwargs = _serve_adapters(args, cfg)
        except Exception as e:  # noqa: BLE001 — CLI boundary: one line
            log.error("--serve_adapter setup failed: %s", e)
            return 1
    spec_kwargs = {}
    if args.draft_model:
        try:
            spec_kwargs = _draft(args, cfg, device, compute_dtype)
        except (OSError, KeyError, ValueError, RuntimeError) as e:
            log.error("draft model setup failed: %s", e)
            return 1
    tokenizer = None
    if args.tokenizer:
        try:
            tokenizer = _tokenizer(args.tokenizer, cfg.vocab_size)
        except Exception as e:  # noqa: BLE001 — CLI boundary: one line
            log.error("tokenizer setup failed: %s", e)
            return 1
    log.info("node %s: LM daemon, model %s, device %s, dtype %s", me.id,
             config.model, device, config.dtype)
    try:
        return asyncio.run(serve_lm(
            cfg, prepared, port=me.port, slots=args.slots,
            max_len=args.max_len, prompt_pad=args.prompt_pad,
            kv=args.kv, kv_dtype=args.kv_dtype,
            decode_buckets=args.decode_buckets,
            paged_blocks=args.paged_blocks, block_len=args.block_len,
            prefix_cache=args.prefix_cache,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            overlap=args.overlap,
            compute_dtype=compute_dtype, seed=args.seed, device=device,
            tokenizer=tokenizer, role=args.role,
            kv_handoff_ttl_s=args.kv_handoff_ttl_s,
            kv_lease_ttl_s=args.kv_lease_ttl_s,
            min_p=args.min_p, repetition_penalty=args.repetition_penalty,
            **_resilience_kwargs(args),
            **({"weights": "int8"} if args.weights == "int8" else {}),
            allow_logit_bias=not spec_kwargs,
            allow_constraints=not spec_kwargs,
            **spec_kwargs, **lora_kwargs, **moe_kwargs)) or 0
    except (NotImplementedError, ValueError) as e:
        # e.g. --kv paged for a softcapped / alternating-window preset
        # (Gemma-2)
        log.error("%s", e)
        return 2
    except KeyboardInterrupt:
        log.info("shutting down")
        return 0
    except Exception as e:  # noqa: BLE001 — CLI boundary (a bind failure)
        log.error("LM serve failed: %s", e)
        return 1


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging(args.log_level, node_id=args.node_id)
    for attr, what, tag in _UNPORTED:
        if getattr(args, attr) != parser.get_default(attr):
            log.error("%s is not ported to dnn_tpu_torch yet (%s)", what, tag)
            return 2
    if args.watchdog_s is not None and not args.serve_lm:
        log.error("--watchdog_s applies to --serve_lm only (the watchdog "
                  "monitors the LM daemon's decode loop)")
        return 1
    slo_objectives = any(v is not None for v in (
        args.slo_ttft_ms, args.slo_itl_ms, args.slo_avail))
    if (slo_objectives or args.slo_target is not None) \
            and not args.serve_lm:
        log.error("--slo_* flags apply to --serve_lm only (SLO tracking "
                  "lives on the LM daemon's request stream)")
        return 1
    if args.slo_target is not None and not slo_objectives:
        log.error("--slo_target needs at least one objective "
                  "(--slo_ttft_ms / --slo_itl_ms / --slo_avail)")
        return 1
    # JAX node.py:575-586
    if args.fleet_port is not None and not (args.serve or args.serve_lm):
        log.error("--fleet_port applies to the serving modes; for a "
                  "standalone collector use `python -m dnn_tpu_torch.obs "
                  "fleet --serve PORT`")
        return 1
    if (args.fleet_targets or args.fleet_interval is not None) \
            and args.fleet_port is None:
        # a silent no-op would read as "the fleet view is live"
        log.error("--fleet_targets/--fleet_interval apply only with "
                  "--fleet_port")
        return 1
    if (args.fleet_port is not None and not args.fleet_targets
            and not args.metrics_port):
        log.error("fleet collector setup failed: --fleet_port needs "
                  "--fleet_targets, or a nonzero --metrics_port to derive "
                  "them from the config")
        return 1
    if (args.min_p is not None or args.repetition_penalty is not None) \
            and not args.serve_lm:
        log.error("--min_p/--repetition_penalty apply to --serve_lm only")
        return 1
    if args.on_wedged != "503" and not args.serve_lm:
        log.error("--on_wedged applies to --serve_lm (the watchdog's "
                  "escalation policy)")
        return 1
    if args.on_wedged != "503" and args.watchdog_s is None:
        log.error("--on_wedged %s needs --watchdog_s (the watchdog is what "
                  "declares wedged)", args.on_wedged)
        return 1
    if args.chaos is not None:
        if not (args.serve or args.serve_lm):
            log.error("--chaos applies to the serving modes (--serve / "
                      "--serve_lm)")
            return 1
        from dnn_tpu_torch import chaos

        try:
            chaos.install(chaos.FaultPlan.from_cli(args.chaos))
        except (ValueError, OSError) as e:
            log.error("--chaos plan invalid: %s", e)
            return 1
        log.warning("chaos fault plan INSTALLED (%s): injected faults are "
                    "recorded as chaos_inject flight events",
                    args.chaos[:120])
    if args.transport is not None and not args.serve:
        log.error("--transport applies to --serve (the gRPC edge "
                  "deployment's inter-stage hops)")
        return 1
    # JAX node.py:547-558, :615-620
    if args.generate is None and (args.beam is not None
                                  or args.eos_id is not None
                                  or args.length_penalty != 0.0):
        log.error("--beam/--eos_id/--length_penalty only apply to "
                  "--generate; pass --generate N")
        return 1
    if args.generate is not None and args.beam is None and (
            args.eos_id is not None or args.length_penalty != 0.0):
        log.error("--eos_id/--length_penalty apply to beam search only; "
                  "pass --beam K alongside --generate")
        return 1
    if args.serve_adapter and args.weights == "int8":
        # JAX's LMServer refuses the pair (lm_server.py:831-836); its
        # node exits 1
        log.error("LM serve failed: weights='int8' does not compose with "
                  "LoRA serving (--serve_adapter)")
        return 1
    if args.role != "both" and not args.serve_lm:
        # JAX node.py:470-472
        log.error("--role applies to --serve_lm (the replica's fleet "
                  "role; the router's own role is implicit)")
        return 1
    if args.serve_adapter and not args.serve_lm:
        log.error("--serve_adapter applies to --serve_lm only; to serve a "
                  "single merged fine-tune in other modes use --lora")
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
    fleet = None
    if args.fleet_port is not None:
        try:
            fleet = _start_fleet(config, args)
        except Exception as e:  # noqa: BLE001 — CLI boundary
            log.error("fleet collector setup failed: %s", e)
            return 1
    try:
        return _serve(config, me, args)
    finally:
        if fleet is not None:
            fleet[0].close()
            fleet[1].close()


def _start_fleet(config, args):
    """The fleet collector riding this serving process (JAX
    node.py:587-615): polls every stage's obs endpoint, serves the
    merged /fleetz. Returns (endpoint, collector)."""
    from dnn_tpu_torch import obs
    from dnn_tpu_torch.obs.fleet import FleetCollector, targets_from_config

    if args.fleet_targets:
        targets = [u.strip() for u in args.fleet_targets.split(",")
                   if u.strip()]
    else:
        targets = targets_from_config(config, args.metrics_port)
    col = FleetCollector(
        targets, interval_s=args.fleet_interval
        if args.fleet_interval is not None else 5.0).start()
    try:
        srv = obs.serve_metrics(args.fleet_port, fleet=col)
    except BaseException:
        col.close()
        raise
    log.info("fleet collector on http://127.0.0.1:%d/fleetz (%d stages)",
             srv.port, len(col.targets))
    return srv, col


def _serve(config, me, args) -> int:
    """The mode the flags pick, after the config loaded."""
    if args.serve_lm:
        return _serve_lm(config, me, args)

    from dnn_tpu_torch.runtime.engine import PipelineEngine

    try:
        engine = PipelineEngine(
            config, role="stage" if args.serve else "full",
            devices=[resolve_device(args.device)] if args.device else None,
            lora_path=args.lora)
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
                engine, args.node_id, transport=args.transport,
                metrics_port=args.metrics_port))]
            if me.part_index == 0 and args.input_image:
                tasks.append(asyncio.create_task(
                    _initiate_edge(engine, args.node_id, args.input_image,
                                   transport=args.transport)))
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
