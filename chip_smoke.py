#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port: builds the CUDA kernels,
holds each against its plain PyTorch version on the card, then serves
GPT-2 at full width through the LM daemon over gRPC in four cache
configurations and in bf16 compute, runs the solo decoder, checks every
greedy stream against an independent reference, trains full-width GPT-2
through the flash-attention kernels, and serves llama3-8b at full width
and depth over the paged pool (K5 with grouped heads, K6/K7 at four rows
a KV head) in f32 and in bf16 compute. The batcher's decode steps are
captured CUDA graphs throughout, and so are the mixed steps of the
interleaved runs (H, H-bf16, L-B-ilv), which also overlap each step's
dispatch with the previous step's commit; the prefix cache (G, G-dense),
the logit bias and logprobs run on gpt2, and so do grammar-constrained
requests (JSON mode); gpt2-xl is served speculatively, drafted by gpt2;
gpt2 serves int8 and int4 weights and three LoRA adapters per request,
runs beam search and the embedding endpoint, and llama3-8b serves int8
weights in bf16 compute; prefill daemons hand gpt2's KV rows to decode
daemons over the wire, and daemons pull a shared prefix's KV blocks from
each other (llama3-8b too); the daemon survives a worker death (a
requeue), drains on /drainz and SIGTERM, joins dedup keys, exits 43 on
a wedged watchdog and reports through /metrics; and the kernels' sliding
-window band, softcap and head dim 256 serve mistral-7b (streams past
its 4096 window, the windowed paged pool reclaiming blocks, the solo
rolling ring), gemma2-9b and gemma-2b at full width and depth.

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card
    python3 chip_smoke.py --decode-turns PARENT
        # K6/K7 of this tree against those of the tree unpacked at PARENT
        # (e.g. a `git archive` of the parent commit), in turns: parent,
        # this tree, this tree, parent -- each turn one process that
        # builds the two libraries and runs that tree's phases 3 and 4

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi); TF32 off; kernel build
  1b. [wire] the native CRC-32C on the host, on the crc32 instruction
     and on slice-by-8: each equal to the per-byte version on
     0/1/7/8/9/4095/65537-byte buffers with two seeds, each one's rate
     on 64 MiB, make_tensor and tensor_view of P-b's 51.5 MB f32
     logits timed, a flipped byte refused
  2. K5 cached_attention at the prefill shape (B=1 H=12 T=64 S=1024 D=64),
     bases {0, 64, 448, 960}, f32, bf16 and int8 caches, and checked
     only at the unaligned bases 37 and 301 (a radix prefix hit resumes
     mid-block); its split-KV plan (splits, kernel launches a call), and
     at base 960 its time against SDPA's
  2b. [K5 verify] K5 at the speculative verify's call pattern: q (B=4,
     H, T=5, D) at per-slot bases {4, 69, 129, 299} over S=1024, gpt2-xl
     (H = Hk = 25, D=64) and llama3-8b (H=32 over Hk=8, D=128), an f32 q
     over an f32 cache and a bf16 q over a bf16 cache, each against its
     plain version and timed against SDPA with the per-row mask; and,
     checked only, bases {1019, 1020, 1022, 1023}, whose rows reach past
     the cache's end (an inactive slot's stale base)
  3. K6 decode_attention at the dense decode shape (B=4 Hk=12 R=1 D=64
     S=1024), pos {0,15,16,1023}, f32/bf16/int8; also a stale slot at
     pos = S and an R=2 case (checked only); its split-KV plan; and at
     the solo decoder's shape (B=1 Hk=12 R=1 S=316, pos 315), timed
     against SDPA for the float types
  4. K7 paged_decode_attention at the decode shape (B=4 Hk=12 R=1 D=64,
     bp=16, nb_max=64, 257 pool blocks), permuted table, pos
     {0,15,16,1023}, f32/bf16/int8 pools; its split-KV plan
  4a. information: K6 at both shapes and K7 timed (and checked) under
     splits of 64, 128 and 256 keys
  4b. K1 flash_attention and K2 flash_attention_lse, then K3
     flash_bwd_dq and K4 flash_bwd_dkv, at the training shape (B=8 H=12
     T=S=512 D=64, causal), f32 and bf16; also T=S=500 and a T=128 S=512
     bottom-right case (checked only). K1/K2 against the plain forward
     (and logsumexp), K3/K4 against torch.autograd.grad through the plain
     reference_attention; bf16 against the plain version in f32 on the
     same bf16 values. Library yardsticks: scaled_dot_product_attention
     for K1; for K2 a call that also returns the logsumexp (bf16: the
     flash backend, aten._scaled_dot_product_flash_attention; f32: the
     efficient-attention backend); for K3/K4 SDPA's whole backward: in
     bf16 the flash backend's backward
     (aten._scaled_dot_product_flash_attention_backward on the residuals
     of its forward), timed like the kernels; in f32, which the flash
     backend does not take, the profiler's device time of autograd.grad
     of SDPA minus that of its forward (in bf16 printed beside the other);
     and, checked only, K1/K2 and K3/K4 f32 at T=S=512 with q and k x 4
     (scores of tens), out and lse at 1e-4, gradients at 1e-4 x each
     one's max
  5. the main path (gpt2, random weights from seed 0, 4 slots, max_len
     1024, prompt_pad 64; prompts of 5/70/130/300 tokens, 16 new tokens,
     greedy, 4 concurrent gRPC clients), each run with the launch counts
     zeroed just before and read just after:
       A. kv="paged", f32 — against a no-cache greedy loop (K5, K7)
       B. kv="dense", decode_buckets, f32 — the same reference (K5, K6)
       C. kv="paged", kv_dtype="int8" — against an independent int8
          greedy loop: plain attention over a dense int8 cache quantized
          with the port's _quantize_rows, no batcher, no kernel (K5, K7
          int8)
       D. kv="paged", kv_dtype="bf16" — against the same loop over a
          dense bf16 cache (K/V rounded to bf16, the attention's output
          cast to bf16 as the port's FloatKV does) (K5, K7 bf16)
       solo make_generate on the 300-token prompt, f32, bf16 and int8
          caches, against the matching reference (K5, K6)
  5a. [serve] ROADMAP item 4 b-c on the same weights, each run with the
     launch counts zeroed just before and read just after:
       bias and logprobs: A's daemon over gRPC with b= -- the greedy
          stream's first token banned (-1e9) never appears, a forced one
          (+1e9) is every token; a batcher at A's pool with logprobs_k=5,
          each chosen logprob within 1e-4 of the no-cache loop's
          log_softmax (K5, K7)
       G  A's pool with prefix_cache=256 (the radix store): 8 prompts
          sharing a 300-token prefix (5-40-token suffixes), a 320-token
          prompt leaving the cached text mid-block (a copy-on-write) and
          its repeat (a zero-chunk full hit), against the same schedule
          uncached: fewer prompt chunks, every stream against the
          no-cache loop, hits/misses/evictions and TTFTs printed (K5, K7)
       G-dense the same on B's dense pool without buckets (the LRU; K5,
          K6)
       H  A's daemon with prefill_chunk_tokens=64 and overlap: the four
          concurrent clients, every stream equal to A's token for token,
          K5 (inside the captured mixed step) and K7 exactly; then the
          mixed step's captured and eager walls, one replay bit-equal to
          the eager mixed step
  5c. [constrain] ROADMAP item 4 d's constraints on the same weights,
     each run with the launch counts zeroed just before and read just
     after: J, A's daemon with ByteTokenizer's byte map and the default
     constraint pools (allow_constraints: 3600 rows), 8 concurrent
     requests -- 4 in JSON
     mode (j=1) over gRPC, 2 under choice_regex through the daemon's
     worker, 2 unconstrained -- each constrained stream against the
     masked no-cache greedy loop (the grammar's allowed tokens at the
     host-walked DFA state), its finish reason the loop's, every
     completed output matching its grammar, the unconstrained streams
     equal to A's, K5 and K7 exactly; J-ilv, J on H's daemon (64-token
     chunks, overlap), every stream equal to J's; the pools' bytes; a
     decode step's wall with and without grammars; one replayed
     constrained step (the captured forward, then the masked sampling
     and the device walk) bit-equal to the eager one
  5b. [text] the daemon at run A's configuration with a tokenizer that
     encodes as ByteTokenizer does and decodes each id to a character of
     its own: on a 282-byte UTF-8 prompt, the ids behind generate_text's
     reply (SendMessage), GenerateStream's ids and SendTensor's tokens
     each equal the no-cache greedy loop; the reply equals the decode of
     SendTensor's tokens; generate_text_stream's chunks join to the
     reply; "!stats"; launches counted (K5, K7)
  5d. ROADMAP item 4 d's second half on the same weights, each run with
     the launch counts zeroed just before and read just after, exact
     counts, each phase's wall printed:
       [quant] Q8 A's daemon with weights="int8", Q4 the int4 tree
          (quantize_gpt(bits=4)) through the daemon and make_generate,
          each stream against the no-cache loop over the same quantized
          tree; param_bytes at f32/int8/int4 and each tree's decode step
          (captured and eager, device busy)
       [lora] three rank-8 adapters (nonzero b) on A's daemon, two waves
          of four gRPC requests mixing a=0/1/2 and the base model, each
          stream against the no-cache loop over merge_lora(base, adapter),
          the step captured once across the reassignment and a replay
          bit-equal to the eager step before and after it; the dense
          pool's prefix LRU hitting only under the same adapter
       [beam] make_beam_generate K=4 over two 130-token rows, 32 tokens,
          an eos the beams reach, length penalty 0.6, every beam against
          an independent search over no-cache forwards (scores within
          1e-4); beam_size 1 against make_generate; `node --generate 16
          --beam 4` as a process against the library
       [embed] make_embed mean/last/none on the four prompts padded to
          320 tokens against the plain forward (1e-4 of the scale), K1
          once a layer a call; the daemon's embed and embed:last replies
          bit-equal to the library's call
  5e. ROADMAP item 4 e's first half on the same weights, the daemons in
     this process on one event loop, the launch counts zeroed just
     before and read just after each step of the call pattern, exact:
       [handoff] prefill daemons (role="prefill", paged) and decode
          daemons (role="decode"): HO-f32 paged f32 and HO-dense dense
          f32 at max_len 512 (the f32 row at 1024, 75.5 MB, is over the
          64 MiB wire cap), HO-bf16 and HO-int8 paged at 1024; the four
          prompts exported (prefill: K5 12 x 11 chunks, no decode
          kernel), staged (kvput:KEY) and generated concurrently with
          h=KEY (no K5 on the decode daemon, K7 -- K6 dense -- 12 a
          step), each stream against the pool's reference ([main]'s A,
          C or D loop) and equal to the decode daemon's own prefill of
          the prompt; the decode graph never captured again across the
          adoptions and an export on the decode daemon; payload bytes,
          the export, kvput, pack and unpack walls, an adopted request's
          TTFT beside a local one; the f32 row at max_len 1024 refused
          with RESOURCE_EXHAUSTED
       [kvtier] a donor and an adopter at G's settings: kvstage of the
          300-token prompt (18 blocks, K5 12 x 5), kvpull over the shm
          rung (no kernel; the donor's lease released by the ack), the
          follow-up generate running the tail chunk only (K5 12, K7 12 a
          step) against the reference and equal to the donor's stream;
          the 130-token prompt over the grpc rung, forced; a donor
          stopped between kvlease and the fetch: kvtier_fallback, the
          adopter's blocks in use, high water, resident blocks and pool
          unchanged, its own prefill against the reference
  5f. [resilience] ROADMAP item 4 e's second half on the same weights at
     run A's settings (paged f32, 4 slots, max_len 1024, prompt_pad 64),
     the daemons with their observability endpoint, every leg's K5
     exactly 12 x the prompt chunks it ran and K7 12 x its decode steps,
     no recapture, every stream against the reference:
       (h) the watchdog's device probe (a child process: import torch,
          then a 64x64 matmul on the card and a synchronize under the
          deadline) answers ok, its wall
       obs on/off: a replayed decode step's launches and captures equal
          with DNN_TPU_OBS on and off, its wall printed for both
       (a) a step fault mid-decode (a chaos plan): /debugz shows
          worker_died then worker_restart, the four unary streams equal
          run A's, K5 counts every requeued prompt's chunks twice, the
          successor's first replay bit-equal to its eager step; the
          restart's wall
       (c) on the successor: two concurrent SendTensors sharing a d= key
          get identical replies from one admission; a dl=0.2 request
          answers DEADLINE_EXCEEDED and its slot is cancelled
       (b) worker_restarts=0: every caller fails fast with "worker died"
       (d) kv_exhaust at admission over a 30-block pool with an 8-block
          radix store: held_back, pool_exhausted and prefix_evict
          events, the streams equal to the reference
       (e) 2 slots, 4 requests, POST /drainz: the 2 in flight finish,
          the 2 queued get UNAVAILABLE "draining"; meanwhile /statusz
          says draining, /healthz answers 503 and a new request is
          refused at preflight
       (i) a kvpull between two daemons at G's settings adopts 18
          blocks; the kv_migrate seam severs the next: kvtier_fallback,
          dnn_tpu_kvtier_fallback_total +1, the next generate prefills
       (j) a daemon at max_len 512: a handoff swept by its TTL
          (kvput_expired) and one adopted; GET /metrics holds every
          series of RES_METRICS (JAX's names), and the card's memory gauges
       (f) SIGTERM to a `node --serve_lm` process during a
          GenerateStream: the stream completes, exit code 0
       (g) a `node --serve_lm --watchdog_s 30 --on_wedged restart
          --chaos <wedge_device plan>` process: /statusz reads ok, then
          wedged with the plan's detail (not a probe's timeout), and the
          exit code is 43
     (the two processes' launches on one 300-token request exact, read
     from their /metrics)
  6. information: a torch.profiler view of a decode step and of one
     prompt's admission on each pool A-D (wall, device busy, top
     kernels, K6/K7's share of the step's device busy, K5's share of the
     admission's), the step captured (the default on the card) and
     eager (the graph taken away)
  6-bf16. [bf16] K5/K6/K7 with a bf16 q over f32, bf16 and int8 caches
     against their plain versions (within 2e-2 of the output's scale) at
     the gpt2 shapes of phases 2-4 and llama3-8b's of [llama], timed
     against SDPA on bf16 q/k/v; then gpt2 in bf16 compute (matmul
     weights held in bf16), each run with the launch counts zeroed just
     before and read just after, every launch with a bf16 q, exact
     counts: E paged bf16 KV (K5, K7), H-bf16 E under H's settings
     (streams equal to E's; its mixed step replayed bit-equal to the
     eager one), F paged int8 (K5, K7 int8),
     B-bf16 dense + buckets (K5, K6, a recapture at each grow),
     solo-bf16 make_generate, P-c-bf16 engine.generate in 4 parts; each
     stream against the plain bf16-compute loop (bf16 or int8 cache,
     64-token chunks) at BF16_TIE; the decode step captured and eager,
     and one replayed step's logits bit-equal to the eager step's (E)
  6a. [pipe] the staged pipeline: P-a cifar_cnn as two `node --serve`
     processes; P-b gpt2-medium (configs/gpt2_8stage.json, bf16) as 8
     in-process stage servers, one B=1 T=256 request whose logits equal
     the relay engine's bit for bit; P-d the same servers, 4 microbatches
     over the streamed Relay RPC (send_tensors), each equal to the relay
     engine's run bit for bit, beside 4 sequential unary requests; P-c
     engine.generate gpt2 in 4 parts against the greedy loop (K5, K6)
  6a'. [spec] ROADMAP item 4 d's speculative decoding: gpt2-xl (48
     layers, 1600 wide, 25 heads) drafted by gpt2, both full width with
     seed-0 weights, the dense f32 pool (4 slots, max_len 1024,
     prompt_pad 64), spec_k 4, the main path's prompts, 16 greedy tokens
     each, each run with the launch counts zeroed just before and read
     just after and exactly K5 = (48 + 12) x (steps + prompt chunks), K6
     = 4 x 12 x steps: S over gRPC (serve_lm with draft_cfg), against
     gpt2-xl's no-cache greedy loop, acceptance and tokens/s printed;
     S-ilv (64-token chunks, overlap), streams equal to S's; S-solo
     make_speculative_generate, equal to make_generate's; S-self gpt2
     drafting itself, every proposal accepted and k+1 tokens a slot
     every step; S-bf16 both in bf16 compute against the plain
     bf16-compute loop at BF16_TIE. After S, S-ilv, S-self and S-bf16
     one replayed speculative (or speculative mixed) step bit-equal to
     the eager one, and a step's captured and eager walls beside the
     plain batcher's gpt2-xl step. Random weights make the two models
     agree almost never: S's acceptance is near zero, S-self is the
     full-acceptance run
  6b. the training main path (gpt2 at full width, seed-0 weights, B=8
     T=512, make_apply_stacked(use_flash=True), next_token_loss, the
     port's adamw(1e-4), batches from a seeded token file through
     TokenDataset), each run with the launch counts zeroed just before
     and read just after, and the exact flash launches required
     (per step: K2 = K3 = K4 = 12, K1 = 0; K2 = 24 under remat):
       T-a loss and per-leaf gradients of one step, kernels against the
           einsum formula (loss within 1e-5 relative, every leaf's
           max|dg| <= 1e-4 x its max|g|)
       T-b 8 fit steps on one batch: the loss falls at every step
       remat 2 steps: K2 twice per layer; losses and params within 1e-6
           of T-b's first two steps
       T-c 6 fit steps, checkpoints every 3; resume_or_init from step 3
           and 3 more steps equal the uninterrupted params bit for bit
       T-d evaluate on 2 held-out batches: K1 = 12 per batch, no K2-K4
       T-e bf16 compute, 3 steps + evaluate: first loss within 2e-2 of
           the f32 one, finite gradients, K1-K4 launched in bf16
     plus information: step wall (f32: T-b's warm steps; bf16: 6 more
     steps), tokens/s, peak memory, MFU, and a torch.profiler view of
     one f32 and one bf16 step (flash share of device time)
  6c. [llama] llama3-8b (32 layers, 4096 wide, 32 heads over 8 KV
     heads, D=128, vocab 128256, rope theta 500000), f32:
       kernel rows at its shapes, each against its plain version, f32,
       bf16 and int8, timed against SDPA with enable_gqa for the float
       types: K5 with grouped heads (B=1 H=32 Hk=8 T=64 S=1024, base
       960), K7 (B=4 Hk=8 R=4, 16-row blocks), K6 solo (B=1 Hk=8 R=4
       S=332, L-solo's cache);
       weights drawn on the card in the JAX tree layout from a seeded
       torch.Generator and passed through convert.from_jax_params; then,
       each run with the launch counts zeroed just before and read just
       after, and the exact counts of the call pattern required:
       L-A the LM daemon (paged f32 pool, 257 blocks of 16), the four
           prompts, 16 greedy tokens each, against the no-cache loop on
           the llama forward (K5, K7)
       L-C the same with int8 KV, against the plain int8 cache loop
           prefilled in 64-token chunks as served (K5, K7 int8); a
           divergence is accepted where the loop's top-2 gap is below
           5e-3 (QUANT_TIE): int8 rounding flips of values at a
           quantization boundary; the whole-prompt int8 loop's parting
           from the chunked one is printed
       L-solo llama.make_generate on the 300-token prompt, 32 tokens,
           dense f32 cache, against the no-cache loop (K5, K6)
       L-B llama3-8b in bf16 compute (16.06 GB of bf16 matmul weights,
           drawn after the f32 weights are freed), the daemon over the
           paged bf16 pool, against the plain bf16-compute loop at
           BF16_TIE (K5 grouped, K7 at R=4, bf16 q, exactly); one
           replayed step bit-equal to the eager step
       L-B-ilv L-B under H's settings, its streams equal to L-B's
       LH the row handoff on L-B's pool through the library (the 134 MB
          bf16 row is over the wire's cap): the four prompts exported by
          one batcher (K5 32 x 11, bf16 q), packed, unpacked and adopted
          by another (no K5, K7 32 a step, no recapture), each stream
          against L-B's loop at BF16_TIE
       LK the 300-token prompt's 18 bf16 blocks (47 MB) pulled between
          two L-B daemons and its follow-up (one tail chunk), against
          L-B's loop at BF16_TIE
       Q8-L ([quant]) the f32 weights of L-A quantized to int8 on the
           card (the f32 copy freed), bf16 compute, L-B's pool, held by
           teacher forcing: the served path fed the plain bf16-compute
           loop's tokens (the same int8 tree), its logprobs within
           FORCED_RATIO times L-B's error against its own loop,
           measured the same way (the control); one replayed step
           bit-equal to the eager step
     plus information: a decode step's (captured and eager) and the
     300-token admission's wall, device busy and top kernels; L-B's step
     against the byte bound of its weights
  6d. sliding windows, softcaps and head dim 256: [K5 band], [K6 band],
     [K7 band] and [D256] hold each variant (WIN_ROWS: mistral-7b's last
     prefill chunk and decode step, gemma2-9b's even layer with its
     softcap, gemma-2b's chunk and steps at D = 256; K7 over a table whose
     entries before the band point at the junk block) against its plain
     version, an f32 q and a bf16 q over f32, bf16 and int8 caches
     (softcapped rows with q drawn 2x / 4x wider so that the cap bends), the
     plain version without the band / the cap as a control that must
     miss by more than the tolerance, timed beside its bound (bytes
     inside the band) and SDPA on q's own type with the band as a mask;
     then, each model drawn on the card and freed before the next, each
     run with the launch counts (by type and by variant) zeroed just
     before and read just after, exact:
       [mistral] mistral-7b in bf16 compute, the daemon at 2 slots x 4608
          positions, 512-token chunks, prompts of 4150 and 4290 tokens, 32
          greedy tokens each (every row from 4096 bands): W-paged (the
          windowed paged pool, bf16 KV; each request's reclaimed blocks =
          floor((limit - 4096 + 1) / 16)), W-int8, W-dense, W-solo
          (make_generate on the rolling ring: K5 banded over the prompt,
          K6 over the 4096-slot ring); each stream held by teacher forcing
          against the plain banded recompute (window_ref_logits) at
          BF16_TIE, near-ties parting at most a quarter of the steps, the
          unbanded recompute (the control) missing the served tokens by
          more than 4x as much; the decode step's walls and
          device busy; W-f32 (the model again in f32 on the windowed
          paged pool, logprobs on: within FORCED_F32_TOL of the f32
          banded recompute, and the unbanded recompute, the control, at
          least 10x that away)
       [gemma2] gemma2-9b in bf16 compute (D = 256, softcaps 50 / 30, the
          window on its 21 even layers), kv="auto" -> the dense pool,
          prompts of 4200 and 1000 tokens; K5 / K6 with the softcap, at D
          = 256, banded on the even layers; teacher forcing as [mistral]
       [gemma] gemma-2b in f32 (D = 256, 8 query heads over one KV head):
          G1-paged (serve_run, the main path's prompts, K5 G=8, K7 R=8)
          and G1-solo (K6 R=8) against the no-cache loop; G1-logprobs
          (the paged pool with logprobs on, within FORCED_F32_TOL of the
          no-cache loop's: the streams repeat one token)
  6e. slice 21, inside the main path after [resilience]: [int4] C-int4
     (A's daemon over a paged int4 pool: K5 on the packed row, K7 on the
     packed pool) and B-int4 (dense + buckets: K6), each stream against
     the plain int4 cache loop (reference_greedy_cache "int4") with C's
     near-tie rule; make_generate and make_bucketed_generate (ladder
     INT4_BUCKETS) at int4 on the 300-token prompt, exact launches, equal
     tokens, the grows counted; C's and C-int4's captured decode step in
     turns (information). [obs]: A's daemon with its endpoint and the four
     SLOs (OBS_SLO), the four prompts each under a client span of its own
     (tr=): /trace?id= holds each request's lm.request (a child of the
     client's span), queue_wait, admit, prefill, one prefill_chunk a
     64-token chunk and decode; /traces lists them; every step's phases
     on the step clock cover >= OBS_COVERAGE of its wall timed around
     step(); dnn_tpu_mbu and dnn_tpu_mfu in (0, 1]; three burn rates;
     cuda_graph_captures_total's rise = the batcher's captures; then a
     replayed step with obs on and off, OBS_STEPS interleaved steps each,
     the same launches, the median at most OBS_OVERHEAD apart. [llama]
     adds L-C-int4 (llama3-8b over a paged int4 pool against the plain
     int4 loop, exact launches), L-B reads its daemon's MBU/MFU (in (0,
     1]); every serve_run prints its daemon's goodput gauges over the run
     (fresh_goodput). The kernel phases hold int4 caches beside f32, bf16
     and int8 (KV_CASES; the window rows WIN_INT4 only).
  7. one JSON line describing the kernels (the bf16-q rows as entries
     of their own; K6 at [beam]'s decode shape, B*K=8 S=162, and K1 at
     [embed]'s, B=4 T=S=320, as extra shapes of their entries, each
     checked against its plain version and timed beside its bound and
     SDPA), then the result line.

Tolerances against the plain versions: 1e-4 for f32, int8 and int4 caches
(both sides read the same values; only the summation order differs),
2e-2 for bf16, and for a bf16 q 2e-2 of the output's largest |value|
(at least 1); 6d's rows: 1e-4 for every cache type with an f32 q, 2e-2
of the output's largest |value| (no floor) with a bf16 q. A served
token may differ from its reference only where the reference's top-2
logit gap is below 1e-4 (a near-tie); 5e-3 for
llama3-8b over an int8 cache (QUANT_TIE); BF16_TIE in bf16 compute.
llama3-8b's int8 weights in bf16 compute are held by teacher forcing
instead (FORCED_RATIO).
Timings: warm-up, then the calls are captured in a CUDA graph and the
graph is replayed between CUDA events (device time, no host overhead).
Kernel timings cycle over the 12 layers' slices of a full-model cache,
so each launch reads K/V the previous launches did not leave in the
50 MB L2 — as on the serving path.
Bounds: bytes moved (each input read once, each output written once,
live columns only, int8 scales included; int4 at half a byte an element
plus its scales) at 3.35 TB/s, or the work at
the inputs' type's peak. K6 and K7: f32 FMAs at 67 TFLOP/s. The flash
kernels (K1-K4): the function's own products at the card's fastest rate
for the inputs' type, bf16 on the tensor cores at 989 TFLOP/s and f32
on the TF32 tensor cores at 494.7, so that a design's way of reaching
f32 accuracy does not move its bound. Each flash line also prints the
products on the units its kernel runs them on: the tensor cores for the
bf16 kernels, and for K1-K4 in f32 the split products they issue on the
tensor cores (the score product as three TF32 products, every other as
three bf16 products) beside the f32 CUDA-core figure. K5 likewise
(k5_bound): its function's products over the live columns at the
fastest tensor-core rate for its cache's type (TF32 for f32, bf16 for
bf16 and int8), with the products it issues and the f32 CUDA-core
figure printed beside it.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM TF32 tensor cores, dense
F32_TOL, BF16_TOL = 1e-4, 2e-2
LAYERS = 12


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 24, reps: int = 10) -> float:
    """Mean device time of one fn() call. `iters` calls are captured in
    a CUDA graph after a warm-up on a side stream, and the graph is
    replayed `reps` times between CUDA events — so the wrapper's host
    overhead never shows in the device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def cycling(fn, n: int):
    """A no-argument callable that calls fn(0), fn(1), ... fn(n-1), fn(0)..."""
    state = {"i": 0}

    def call():
        i = state["i"]
        state["i"] = (i + 1) % n
        return fn(i)
    return call


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS_PER_S):
    """(bound ms, "bytes" | "operations", bytes ms, operations ms), the
    operations priced at `peak` FLOP/s (the inputs' type's peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def kernel_label(mangled: str) -> str:
    """`flash_fwd_tc_kernel<64>` from a mangled kernel name: the
    length-prefixed identifier that ends in "kernel", then its template
    arguments (the element type, then the ints)."""
    # a length prefix may follow digits of a hash: try every tail of a run;
    # a hash's digits can also prefix a longer run that ends in "kernel",
    # so the identifier is the shortest such word
    starts = [i for m in re.finditer(r"\d+", mangled)
              for i in range(m.start(), m.end())]
    words = []
    for i in starts:
        end = re.match(r"\d+", mangled[i:]).end() + i
        word = mangled[end:end + int(mangled[i:end])]
        if word.endswith("kernel"):
            words.append((len(word), end, word))
    if not words:
        return mangled
    _, end, word = min(words)
    targs = mangled[end + len(word):].split("EE")[0]
    if not targs.startswith("I"):
        return word
    types = {"If": "f32", "I13__nv_bfloat16": "bf16", "Ia": "int8"}
    names = [t for pre, t in types.items() if targs.startswith(pre)]
    if "4Int4" in targs.split("L", 1)[0]:  # the anonymous namespace's Int4
        names.append("int4")
    names += re.findall(r"L[ib](-?\d+)", targs)
    return f"{word}<{', '.join(names)}>"


def phase_build():
    from dnn_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {len(logs)} kernel libraries built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:
                kernel = kernel_label(entry.group(1))
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line):
                print(f"[build] {name}: {kernel}: {line.strip()}",
                      flush=True)


WIRE_LENGTHS = (0, 1, 7, 8, 9, 4095, 65537)
WIRE_RATE_BYTES = 64 << 20
WIRE_LOGITS = (1, 256, 50257)  # P-b's f32 logits, 51.5 MB


def phase_wire(card):
    """[wire] the native CRC-32C on the host: its route (the SSE4.2
    crc32 instruction or slice-by-8) and the slice-by-8 route both equal
    to the per-byte version on buffers of WIRE_LENGTHS bytes, seed 0 and
    a nonzero seed; both routes' rates on a 64 MiB buffer; make_tensor
    and tensor_view of P-b's checksummed f32 logits timed; a flipped
    payload byte refused."""
    from dnn_tpu_torch import native
    from dnn_tpu_torch.comm import wirecodec as wc

    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    for n in WIRE_LENGTHS:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 0x1234ABCD):
            want = native.crc32c_plain(data, seed)
            for fn in (native.crc32c, native.crc32c_sliced):
                got = fn(data, seed)
                if got != want:
                    fail(f"[wire] {fn.__name__} of {n} bytes (seed "
                         f"{seed:#x}): {got:#010x} != per-byte {want:#010x}")
    big = rng.integers(0, 256, WIRE_RATE_BYTES, dtype=np.uint8)
    best_s = {}
    for fn in (native.crc32c, native.crc32c_sliced):
        fn(big)
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            fn(big)
            times.append(time.perf_counter() - t1)
        best_s[fn.__name__] = min(times)
    rate = WIRE_RATE_BYTES / best_s["crc32c"] / 1e9
    rate_sliced = WIRE_RATE_BYTES / best_s["crc32c_sliced"] / 1e9
    route = "the SSE4.2 crc32 instruction" if native.hardware() else \
        "slice-by-8"
    logits = rng.standard_normal(WIRE_LOGITS, dtype=np.float32)
    t1 = time.perf_counter()
    raw = wc.serialize_response(wc.TensorResponse(
        status="ok", result_tensor=wc.make_tensor(logits)))
    encode_s = time.perf_counter() - t1
    msg = wc.parse_response(raw).result_tensor
    t1 = time.perf_counter()
    view = wc.tensor_view(msg)
    verify_s = time.perf_counter() - t1
    if not np.array_equal(view, logits):
        fail("[wire] the logits did not survive the wire")
    bad = bytearray(raw)
    bad[len(bad) // 2] ^= 0x01
    try:
        wc.tensor_view(wc.parse_response(bytes(bad)).result_tensor)
        fail("[wire] a flipped payload byte was not refused")
    except wc.PayloadCorruptError:
        pass
    print(f"[wire] native crc32c on {route} (g++ build/load "
          f"{build_s:.2f} s) and its slice-by-8 route equal the per-byte "
          f"version on {len(WIRE_LENGTHS)} lengths x 2 seeds; on "
          f"{WIRE_RATE_BYTES >> 20} MiB (best of 5) crc32c {rate:.2f} GB/s "
          f"({best_s['crc32c'] * 1e3:.2f} ms), slice-by-8 "
          f"{rate_sliced:.2f} GB/s ({best_s['crc32c_sliced'] * 1e3:.2f} ms)"
          f"; the {logits.nbytes / 1e6:.1f} MB "
          f"logits: make_tensor + serialize {encode_s * 1e3:.2f} ms, "
          f"tensor_view (crc verify) {verify_s * 1e3:.2f} ms; a flipped "
          f"byte raises PayloadCorruptError; on the host of {card}",
          flush=True)
    return {"crc32c_gb_s": rate, "crc32c_sliced_gb_s": rate_sliced,
            "tensor_view_ms": verify_s * 1e3}


KV_CASES = (("f32", F32_TOL), ("bf16", BF16_TOL), ("int8", F32_TOL),
            ("int4", F32_TOL))
DTYPES = tuple(name for name, _ in KV_CASES)  # the cache kernels' types
QUANT = ("int8", "int4")  # the quantized types: no one-call library
# counterpart, scales beside the payload


def kv_cache(gen, shape, name, dev):
    """(k, v, ks, vs) of `shape` for cache type `name`: f32 draws, cast
    to bf16, or quantized to int8 or int4 (packed two values a byte) with
    the port's own quantizers (then ks/vs are its per-row scales; None
    for the float types)."""
    from dnn_tpu_torch.runtime.kvcache import (_quantize_rows,
                                               _quantize_rows_int4)

    k = torch.randn(*shape, generator=gen, device=dev)
    v = torch.randn(*shape, generator=gen, device=dev)
    if name in QUANT:
        quant = _quantize_rows if name == "int8" else _quantize_rows_int4
        (kq, ks), (vq, vs) = quant(k), quant(v)
        return kq, vq, ks, vs
    dt = torch.float32 if name == "f32" else torch.bfloat16
    return k.to(dt), v.to(dt), None, None


def scales_at(ks, vs, i):
    """The ks/vs keyword arguments for layer i of stacked int8 scales;
    none for a float cache."""
    return {} if ks is None else {"ks": ks[i], "vs": vs[i]}


def kv_bytes(name: str, positions: int, d: int) -> int:
    """Bytes of K plus V at `positions` (position, head) rows of width d,
    quantized scales included (int4: half a byte an element)."""
    el = {"f32": 4, "bf16": 2, "int8": 1, "int4": 0.5}[name]
    return int(2 * positions * (d * el + (4 if name in QUANT else 0)))


def check(label: str, got, want, tol: float) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    err = (got - want).abs().max().item()
    if not math.isfinite(err) or err > tol:
        fail(f"{label}: max abs err {err} > {tol}")
    return err


def report(tag, label, row, nbytes, byte_ms, op_ms, ops="f32 ops"):
    lib = row["library_ms"]
    print(f"[{tag}] {label}: err {row['max_abs_err']:.3e} kernel_ms "
          f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
          f"{'none' if lib is None else f'{lib:.4f}'} bound_ms "
          f"{row['bound_ms']:.5f} ({row['bound_by']}; bytes {byte_ms:.5f} "
          f"for {nbytes / 1e6:.3f} MB at 3.35 TB/s, {ops} {op_ms:.5f})",
          flush=True)


def k5_bound(name, B, H, HK, T, S, base, D, q_bytes=4):
    """K5's bound at one chunk of q (B, H, T, D) at positions base + t
    against a cache (B, HK, S, D) of type `name`: the bytes (q read and
    the output written in q's type, `q_bytes` an element: 4 for f32, 2
    for bf16; the HK heads' live K/V once, int8 scales included, pos) at
    3.35 TB/s, or the function's own products (one Q.K^T and one P.V
    over each row's live columns, 4 D FLOPs a live score) at the fastest
    tensor-core rate for the cache's type: TF32 for f32, bf16 for bf16
    and for int8 (the softmax's P is not int8, so the int8 rate does not
    apply). `base` is one base for every batch row, or a list of B (the
    speculative verify's per-row bases). Returns (nbytes, live scores,
    ops label, bound(...))."""
    bases = list(base) if isinstance(base, (list, tuple)) else [base] * B
    nbytes = (2 * B * H * T * D * q_bytes + B * 4 + HK * sum(
        kv_bytes(name, min(S, b + T), D) for b in bases))
    scores = H * sum(min(S, b + t + 1) for b in bases for t in range(T))
    peak, label = ((TF32_FLOPS_PER_S, "TF32 ops at 494.7 TFLOP/s")
                   if name == "f32" else
                   (BF16_FLOPS_PER_S, "bf16 ops at 989 TFLOP/s"))
    return nbytes, scores, label, bound(nbytes, 4 * D * scores, peak)


K5_UNALIGNED = (37, 301)  # bases off the 16-position block grid


def phase_k5(dev, gen):
    """K5 against its plain version at the prefill-chunk shape, f32,
    bf16 and int8 caches, at bases {0, 64, 448, 960} and, checked only,
    at the unaligned K5_UNALIGNED (the radix prefix cache resumes a
    prefill mid-block). Returns {(dtype, base): row}. The bound is
    k5_bound's. Printed beside it, as information: the products the
    kernel issues on the tensor cores (over every 64-key tile up to each
    query tile's last live column, two bf16 products a tile for Q.K^T and
    two for P.V, three each for an f32 cache) at 989 TFLOP/s, and the f32
    CUDA-core time of the live scores, the bound of the earlier CUDA-core
    design."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        K5_TILE, cached_attention, k5_split, reference_cached_attention)

    B, H, T, S, D = 1, 12, 64, 1024, 64
    split_tiles, n_split = k5_split(B * H, T, S)
    q_tiles = -(-T // K5_TILE)
    print(f"[K5] B={B} H={H} T={T} S={S} D={D}: {n_split} splits of "
          f"{split_tiles * K5_TILE} keys, grid ({n_split}, {q_tiles}, "
          f"{B * H}), {2 if n_split > 1 else 1} kernel launches a call "
          f"(split{' + merge' if n_split > 1 else ''})", flush=True)
    rows = {}
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, H, T, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, H, S, D), name, dev)
        for base in (0, 64, 448, 960):
            pos = torch.full((B,), base, dtype=torch.int32, device=dev)
            sc = scales_at(ks, vs, 0)
            err = check(f"K5 {name} base {base}",
                        cached_attention(q[0], k[0], v[0], pos, **sc),
                        reference_cached_attention(q[0], k[0], v[0], pos, **sc),
                        tol)
            nbytes, scores, ops, (b_ms, b_by, byte_ms, op_ms) = k5_bound(
                name, B, H, H, T, S, base, D)
            tiles = B * H * sum(
                min(S - 1, base + min(T, K5_TILE * (i + 1)) - 1) // K5_TILE + 1
                for i in range(q_tiles))
            products = 3 if name == "f32" else 2
            tc_flops = tiles * 2 * products * 2 * K5_TILE * K5_TILE * D
            ms = time_ms(cycling(lambda i: cached_attention(
                q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
            plain = time_ms(cycling(lambda i: reference_cached_attention(
                q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
            lib = None
            if name not in QUANT:  # no one-call library counterpart
                cols = torch.arange(S, device=dev)
                mask = cols[None, :] <= (base + torch.arange(T, device=dev))[:, None]
                qd = q.to(k.dtype)
                lib = time_ms(cycling(
                    lambda i: torch.nn.functional.scaled_dot_product_attention(
                        qd[i], k[i], v[i], attn_mask=mask), LAYERS))
            row = rows[(name, base)] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)
            print(f"[K5] {name:4s} base {base:4d}: err {err:.3e} kernel_ms "
                  f"{ms:.4f} plain_ms {plain:.4f} library_ms "
                  f"{'none' if lib is None else f'{lib:.4f}'} bound_ms "
                  f"{b_ms:.5f} ({b_by}; bytes {byte_ms:.5f} for "
                  f"{nbytes / 1e6:.3f} MB at 3.35 TB/s, {ops} {op_ms:.5f}; "
                  f"issued: {tiles} tiles x {2 * products} bf16 products "
                  f"{tc_flops / BF16_FLOPS_PER_S * 1e3:.5f} at 989 TFLOP/s, "
                  f"f32 CUDA-core ops of the live scores "
                  f"{4 * D * scores / F32_FLOPS_PER_S * 1e3:.5f}); kernel / "
                  f"bound {ms / b_ms:.1f}", flush=True)
        for base in K5_UNALIGNED:
            pos = torch.full((B,), base, dtype=torch.int32, device=dev)
            sc = scales_at(ks, vs, 0)
            err = check(f"K5 {name} base {base}",
                        cached_attention(q[0], k[0], v[0], pos, **sc),
                        reference_cached_attention(q[0], k[0], v[0], pos, **sc),
                        tol)
            print(f"[K5] {name:4s} base {base:4d} (unaligned, a radix "
                  f"resume mid-block): err {err:.3e}", flush=True)
        if lib is not None:
            at = rows[(name, 960)]
            print(f"[K5] {name} base 960: kernel {at['ms']:.4f} ms, SDPA "
                  f"({name} q, k, v) {at['library_ms']:.4f} ms: kernel / "
                  f"library {at['ms'] / at['library_ms']:.2f}", flush=True)
    return rows


# the speculative verify's call pattern (ROADMAP item 4 d): the target's
# (B, k+1) block at every slot's own base; the bases of the [spec] runs'
# first verify (the prompts' last positions) and, checked only, bases
# whose last rows reach the cache's end (an inactive slot's stale base)
VERIFY_BASES = (4, 69, 129, 299)
VERIFY_END_BASES = (1019, 1020, 1022, 1023)
VERIFY_SHAPES = (("gpt2-xl", 4, 25, 25, 64), ("llama3-8b", 4, 32, 8, 128))


def phase_k5_verify(dev, gen):
    """K5 at the speculative verify's shapes: q (B=4, H, T=5, D) at the
    per-slot bases VERIFY_BASES against a cache (4, Hk, S=1024, D) --
    gpt2-xl's target (H = Hk = 25, D = 64) and llama3-8b's (H = 32 over
    Hk = 8, D = 128) -- with an f32 q over an f32 cache and a bf16 q over
    a bf16 cache (bf16 compute), each against its plain version (1e-4;
    bf16 q 2e-2 of the output's scale), timed against SDPA with the
    per-row mask (enable_gqa for llama3-8b); and, checked only, at
    VERIFY_END_BASES, where rows reach past the cache's end. Returns
    {(model, "f32" | "bf16 q"): row}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        cached_attention, k5_split, reference_cached_attention)

    T, S = 5, 1024
    rows = {}
    for model, B, H, HK, D in VERIFY_SHAPES:
        split_tiles, n_split = k5_split(B * H, T, S)
        print(f"[K5 verify] {model}: B={B} H={H} Hk={HK} T={T} S={S} D={D}, "
              f"bases {list(VERIFY_BASES)}: {n_split} splits of "
              f"{split_tiles * 64} keys", flush=True)
        cols = torch.arange(S, device=dev)
        for label, qdt, cache in (("f32", torch.float32, "f32"),
                                  ("bf16 q", torch.bfloat16, "bf16")):
            q = torch.randn(LAYERS, B, H, T, D, generator=gen,
                            device=dev).to(qdt)
            k, v, _, _ = kv_cache(gen, (LAYERS, B, HK, S, D), cache, dev)
            for bases in (VERIFY_END_BASES, VERIFY_BASES):
                pos = torch.tensor(bases, dtype=torch.int32, device=dev)
                got = cached_attention(q[0], k[0], v[0], pos)
                want = reference_cached_attention(q[0], k[0], v[0], pos)
                if qdt == torch.float32:
                    err = check(f"K5 verify {model} {label} bases {bases}",
                                got, want, F32_TOL)
                else:
                    err = check_scaled(f"K5 verify {model} {label} bases "
                                       f"{bases}", got, want, BF16_TOL)
            print(f"[K5 verify] {model} {label}: bases "
                  f"{list(VERIFY_END_BASES)} (rows past the cache's end) "
                  f"checked", flush=True)
            nbytes, scores, ops, (b_ms, b_by, byte_ms, op_ms) = k5_bound(
                cache, B, H, HK, T, S, list(VERIFY_BASES), D,
                q_bytes=4 if qdt == torch.float32 else 2)
            ms = time_ms(cycling(lambda i: cached_attention(
                q[i], k[i], v[i], pos), LAYERS))
            plain = time_ms(cycling(lambda i: reference_cached_attention(
                q[i], k[i], v[i], pos), LAYERS))
            mask = (cols[None, None, None, :] <= (
                pos[:, None, None, None]
                + torch.arange(T, device=dev)[None, None, :, None]))
            qd = q.to(k.dtype)
            lib = time_ms(cycling(lambda i: sdpa_gqa(qd[i], k[i], v[i],
                                                     mask), LAYERS))
            row = rows[(model, label)] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)
            report("K5 verify", f"{model} {label} ({cache} cache)", row,
                   nbytes, byte_ms, op_ms, ops)
            print(f"[K5 verify] {model} {label}: kernel / SDPA "
                  f"{ms / lib:.2f}, kernel / bound {ms / b_ms:.1f}",
                  flush=True)
    return rows


def check_scaled(label: str, got, want, tol: float) -> float:
    """check() for a bf16 output: the error against the plain version
    within `tol` of the output's scale (its largest |value|, at least 1:
    one bf16 rounding step is 2^-8 of a value); returns the error."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not math.isfinite(err) or err > tol * scale:
        fail(f"{label}: max abs err {err} > {tol} x {scale:.3f}")
    return err


def phase_bf16_q_kernels(dev, gen):
    """[bf16] K5, K6 and K7 with a bf16 q (bf16 compute) against their
    plain versions (f32 math on the same bf16 q, the output rounded to
    bf16 once) within BF16_TOL of the output's scale, over f32, bf16 and
    int8 caches, at the gpt2 shapes of phases 2-4 (K5 at the prefill
    chunk, checked at bases {0, 64, 448, 960} and timed at 960; K6 at
    the decode step and at the solo decoder's cache; K7 at the decode
    step) and at llama3-8b's of [llama] (K5 with grouped heads, K7 and
    K6 solo at R = 4). Bounds: the bytes with q and the output at 2
    bytes an element, K5's products by k5_bound, K6/K7's f32 FMAs at 67
    TFLOP/s. The library time is SDPA on q cast to the cache's float
    type (bf16 q/k/v for a bf16 cache; enable_gqa for llama's grouped
    heads), none for int8 and for paged. Returns {shape: {dtype: row}}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        cached_attention, decode_attention, paged_decode_attention,
        reference_cached_attention, reference_decode_attention,
        reference_paged_decode_attention)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}

    def rows_for(shape, kernel, plain, make, lib, nbytes_of, flops, k5=None,
                 checks=None):
        out[shape] = {}
        for name, _ in KV_CASES:
            q, cache, ks, vs, extra = make(name)
            err = 0.0
            for label, args in (checks(q, cache, extra) if checks
                                else [("", (q[0], *cache(0), *extra))]):
                sc = scales_at(ks, vs, 0)
                err = max(err, check_scaled(
                    f"[bf16] {shape} {name}{label}", kernel(*args, **sc),
                    plain(*args, **sc), BF16_TOL))

            def call(fn, i):
                return fn(q[i], *cache(i), *extra, **scales_at(ks, vs, i))
            ms = time_ms(cycling(lambda i: call(kernel, i), LAYERS))
            plain_ms = time_ms(cycling(lambda i: call(plain, i), LAYERS))
            lib_ms = None
            if lib is not None and name not in QUANT:
                lib_ms = time_ms(cycling(lambda i: lib(q[i], *cache(i)),
                                         LAYERS))
            if k5 is not None:
                nbytes, _, ops, (b_ms, b_by, byte_ms, op_ms) = k5_bound(
                    name, *k5, q_bytes=2)
            else:
                nbytes = nbytes_of(name)
                ops = "f32 ops"
                b_ms, b_by, byte_ms, op_ms = bound(nbytes, flops)
            row = out[shape][name] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)
            report("bf16", f"{shape} {name:4s} bf16 q", row, nbytes, byte_ms,
                   op_ms, ops)

    def dense_maker(b, heads, t, hk, s, d):
        def make(name):
            q = torch.randn(LAYERS, b, heads, t, d, generator=gen,
                            device=dev).to(torch.bfloat16)
            k, v, ks, vs = kv_cache(gen, (LAYERS, b, hk, s, d), name, dev)
            return q, lambda i: (k[i], v[i]), ks, vs, ()
        return make

    # gpt2's prefill chunk (K5), bases checked, timed at 960
    B, H, T, S, D = 1, 12, 64, 1024, 64
    p960 = torch.full((B,), 960, dtype=torch.int32, device=dev)
    cols = torch.arange(S, device=dev)

    def k5_make(b, h, t, hk, s, d):
        base = dense_maker(b, h, t, hk, s, d)

        def make(name):
            q, cache, ks, vs, _ = base(name)
            return q, cache, ks, vs, (p960,)
        return make

    def k5_checks(q, cache, extra):
        return [(f" base {b0}", (q[0], *cache(0), torch.full(
            (1,), b0, dtype=torch.int32, device=dev)))
            for b0 in (0, 64, 448, 960)]

    mask = cols[None, :] <= (960 + torch.arange(T, device=dev))[:, None]
    rows_for("K5", cached_attention, reference_cached_attention,
             k5_make(B, H, T, H, S, D),
             lambda q, k, v: sdpa(q.to(k.dtype), k, v, attn_mask=mask),
             None, None, k5=(B, H, H, T, S, 960, D), checks=k5_checks)
    # gpt2's decode step (K6 dense, K7 paged) and the solo cache (K6)
    B, Hk, D, S = 4, 12, 64, 1024
    pos_list = [0, 15, 16, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    live = sum(p + 1 for p in pos_list)
    step_mask = cols[None, None, None, :] <= pos[:, None, None, None]

    def with_pos(make, p):
        def wrapped(name):
            q, cache, ks, vs, _ = make(name)
            return q, cache, ks, vs, (p,)
        return wrapped

    rows_for("K6", decode_attention, reference_decode_attention,
             with_pos(dense_maker(B, Hk, 1, Hk, S, D), pos),
             lambda q, k, v: sdpa(q.to(k.dtype), k, v, attn_mask=step_mask),
             lambda name: (2 * B * Hk * D * 2 + Hk * kv_bytes(name, live, D)
                           + B * 4), 4 * D * Hk * live)
    solo = torch.tensor([SOLO_S - 1], dtype=torch.int32, device=dev)
    rows_for("K6 solo", decode_attention, reference_decode_attention,
             with_pos(dense_maker(SOLO_B, SOLO_HK, 1, SOLO_HK, SOLO_S, D),
                      solo),
             lambda q, k, v: sdpa(q.to(k.dtype), k, v),
             lambda name: (2 * SOLO_HK * D * 2
                           + SOLO_HK * kv_bytes(name, SOLO_S, D) + 4),
             4 * D * SOLO_HK * SOLO_S)

    def paged_maker(b, hk, r, d, bp, nb_max, n_blocks, p):
        perm = torch.randperm(n_blocks - 1,
                              generator=torch.Generator().manual_seed(0))
        tables = (perm[:b * nb_max] + 1).reshape(b, nb_max).to(
            torch.int32).to(dev)

        def make(name):
            q = torch.randn(LAYERS, b, hk, r, d, generator=gen,
                            device=dev).to(torch.bfloat16)
            kp, vp, ks, vs = kv_cache(gen, (LAYERS, n_blocks, hk, bp, d),
                                      name, dev)
            return q, lambda i: (kp[i], vp[i]), ks, vs, (tables, p)
        return make

    def paged_bytes(hk, r, d, bp):
        return lambda name: (2 * B * hk * r * d * 2
                             + hk * kv_bytes(name, live, d)
                             + sum(p // bp + 1 for p in pos_list) * 4 + B * 4)

    rows_for("K7", paged_decode_attention, reference_paged_decode_attention,
             paged_maker(B, Hk, 1, D, 16, 64, 257, pos), None,
             paged_bytes(Hk, 1, D, 16), 4 * D * Hk * live)
    # llama3-8b: K5 grouped, K7 and K6 solo at R = 4
    H, HK, D, G = 32, 8, 128, 4
    lmask = cols[None, :] <= (960 + torch.arange(64, device=dev))[:, None]
    rows_for("llama K5", cached_attention, reference_cached_attention,
             k5_make(1, H, 64, HK, 1024, D),
             lambda q, k, v: sdpa_gqa(q.to(k.dtype), k, v, lmask),
             None, None, k5=(1, H, HK, 64, 1024, 960, D))
    rows_for("llama K7", paged_decode_attention,
             reference_paged_decode_attention,
             paged_maker(B, HK, G, D, 16, 64, 257, pos), None,
             paged_bytes(HK, G, D, 16), 4 * D * HK * G * live)
    last = LLAMA_SOLO_S - 2
    lpos = torch.tensor([last], dtype=torch.int32, device=dev)
    llive = torch.arange(LLAMA_SOLO_S, device=dev)[None, :] <= last
    rows_for("llama K6 solo", decode_attention, reference_decode_attention,
             with_pos(dense_maker(1, HK, G, HK, LLAMA_SOLO_S, D), lpos),
             lambda q, k, v: sdpa_gqa(
                 q.reshape(1, H, 1, D).to(k.dtype), k, v, llive),
             lambda name: (2 * HK * G * D * 2
                           + HK * kv_bytes(name, last + 1, D) + 4),
             4 * D * HK * G * (last + 1))
    return out


def decode_plan(tag, bh, s, unit=1):
    """Prints K6/K7's split-KV plan for `bh` (slot, KV head) pairs over
    `s` logical columns (in whole `unit`s: K7's blocks)."""
    from dnn_tpu_torch.ops.cuda.cached_attention import decode_split

    split_keys, n_split = decode_split(bh, s, unit)
    print(f"[{tag}] plan for {bh} (slot, head) pairs over {s} columns: "
          f"{n_split} splits of {split_keys} keys, grid ({n_split}, {bh}), "
          f"{2 if n_split > 1 else 1} kernel launches a call (split"
          f"{' + merge' if n_split > 1 else ''})", flush=True)


def phase_k6(dev, gen):
    """K6 against its plain version at the dense decode-step shape
    (B=4 Hk=12 R=1 D=64 S=1024, pos {0, 15, 16, 1023}), f32, bf16 and
    int8 caches; plus, checked only, a stale inactive slot at pos = S and
    an R=2 case. Returns {dtype: row}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        decode_attention, reference_decode_attention)

    B, Hk, R, D, S = 4, 12, 1, 64, 1024
    decode_plan("K6", B * Hk, S)
    pos_list = [0, 15, 16, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    stale = torch.tensor([0, 15, S, 1023], dtype=torch.int32, device=dev)
    cols = torch.arange(S, device=dev)
    mask = cols[None, None, None, :] <= pos[:, None, None, None]
    rows = {}
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, Hk, R, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, Hk, S, D), name, dev)
        q2 = torch.randn(B, Hk, 2, D, generator=gen, device=dev)
        err = 0.0
        for label, i, qq, pp in (("", 0, q[0], pos),
                                 (" stale pos = S", 1, q[1], stale),
                                 (" R=2", 2, q2, pos)):
            sc = scales_at(ks, vs, i)
            err = max(err, check(
                f"K6 {name}{label}",
                decode_attention(qq, k[i], v[i], pp, **sc),
                reference_decode_attention(qq, k[i], v[i], pp, **sc), tol))
        live = sum(p + 1 for p in pos_list)
        nbytes = 2 * B * Hk * R * D * 4 + Hk * kv_bytes(name, live, D) + B * 4
        flops = 4 * D * Hk * R * live
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, flops)
        ms = time_ms(cycling(lambda i: decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        plain = time_ms(cycling(lambda i: reference_decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        lib = None
        if name not in QUANT:  # no one-call library counterpart
            qd = q.to(k.dtype)
            lib = time_ms(cycling(
                lambda i: torch.nn.functional.scaled_dot_product_attention(
                    qd[i], k[i], v[i], attn_mask=mask), LAYERS))
        row = rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("K6", f"{name:4s} pos {pos_list}", row, nbytes, byte_ms, op_ms)
    return rows


def phase_k7(dev, gen):
    """K7 against its plain version at the paged decode-step shape, f32,
    bf16 and int8 pools. Returns {dtype: row}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        paged_decode_attention, reference_paged_decode_attention)

    B, Hk, R, D, bp, nb_max, n_blocks = 4, 12, 1, 64, 16, 64, 257
    decode_plan("K7", B * Hk, nb_max * bp, bp)
    pos_list = [0, 15, 16, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(0))
    tables = (perm[:B * nb_max] + 1).reshape(B, nb_max).to(torch.int32).to(dev)
    rows = {}
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, Hk, R, D, generator=gen, device=dev)
        kp, vp, ks, vs = kv_cache(gen, (LAYERS, n_blocks, Hk, bp, D), name,
                                  dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"K7 {name}",
                    paged_decode_attention(q[0], kp[0], vp[0], tables, pos,
                                           **sc),
                    reference_paged_decode_attention(q[0], kp[0], vp[0],
                                                     tables, pos, **sc), tol)
        live = sum(p + 1 for p in pos_list)
        nbytes = (2 * B * Hk * R * D * 4 + Hk * kv_bytes(name, live, D)
                  + sum(p // bp + 1 for p in pos_list) * 4 + B * 4)
        flops = 4 * D * Hk * R * live
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, flops)
        ms = time_ms(cycling(lambda i: paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos, **scales_at(ks, vs, i)),
            LAYERS))
        plain = time_ms(cycling(lambda i: reference_paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos, **scales_at(ks, vs, i)),
            LAYERS))
        row = rows[name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("K7", f"{name:4s} pos {pos_list} (no one-call library "
               "equivalent)", row, nbytes, byte_ms, op_ms)
    return rows


SOLO_B, SOLO_HK, SOLO_S = 1, 12, 316  # make_generate: 300 + 16 rows


def phase_k6_solo(dev, gen):
    """K6 at the solo decoder's shape (B=1 Hk=12 R=1 D=64, a 316-row
    cache, pos 315: the last step of a 300-token prompt's 16 new
    tokens), f32, bf16 and int8, against its plain version, timed
    against SDPA for the float types. Returns {dtype: row}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        decode_attention, reference_decode_attention)

    B, Hk, R, D, S = SOLO_B, SOLO_HK, 1, 64, SOLO_S
    decode_plan("K6 solo", B * Hk, S)
    pos = torch.tensor([S - 1], dtype=torch.int32, device=dev)
    rows = {}
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, Hk, R, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, Hk, S, D), name, dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"K6 solo {name}",
                    decode_attention(q[0], k[0], v[0], pos, **sc),
                    reference_decode_attention(q[0], k[0], v[0], pos, **sc),
                    tol)
        nbytes = 2 * B * Hk * R * D * 4 + Hk * kv_bytes(name, S, D) + B * 4
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, 4 * D * Hk * R * S)
        ms = time_ms(cycling(lambda i: decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        plain = time_ms(cycling(lambda i: reference_decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        lib = None
        if name not in QUANT:  # every column is live: SDPA without a mask
            qd = q.to(k.dtype)
            lib = time_ms(cycling(
                lambda i: torch.nn.functional.scaled_dot_product_attention(
                    qd[i], k[i], v[i]), LAYERS))
        row = rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("K6 solo", f"{name:4s} B={B} S={S} pos {S - 1}", row, nbytes,
               byte_ms, op_ms)
        if lib is not None:
            print(f"[K6 solo] {name}: kernel / SDPA {ms / lib:.2f}",
                  flush=True)
    return rows


DECODE_SWEEP = (32, 64, 128, 256)  # keys a split


def phase_decode_splits(dev, gen):
    """Information: K6 at the timing and solo shapes and K7 at the timing
    shape under splits of DECODE_SWEEP keys (in place of the wrapper's
    plan, `decode_split`), each checked against its plain version and
    timed."""
    from dnn_tpu_torch.ops.cuda import cached_attention as tca

    def fixed(keys):
        def plan(bh, s, unit=1):
            split_keys = -(-keys // unit) * unit
            return split_keys, -(-s // split_keys)
        return plan

    shapes = (("K6", 4, 1024, [0, 15, 16, 1023]),
              ("K6 solo", SOLO_B, SOLO_S, [SOLO_S - 1]),
              ("K7", 4, 1024, [0, 15, 16, 1023]))
    keep = tca.decode_split
    try:
        for tag, B, S, pos_list in shapes:
            paged = tag == "K7"
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            bp = 16
            tables = torch.arange(1, B * S // bp + 1, dtype=torch.int32,
                                  device=dev).reshape(B, S // bp)
            for name, tol in KV_CASES[:3]:  # int4: the plan is int8's
                q = torch.randn(LAYERS, B, 12, 1, 64, generator=gen,
                                device=dev)
                shape = ((LAYERS, B * S // bp + 1, 12, bp, 64) if paged
                         else (LAYERS, B, 12, S, 64))
                k, v, ks, vs = kv_cache(gen, shape, name, dev)

                def call(f, i):
                    sc = scales_at(ks, vs, i)
                    if paged:
                        return f(q[i], k[i], v[i], tables, pos, **sc)
                    return f(q[i], k[i], v[i], pos, **sc)
                fn, ref = ((tca.paged_decode_attention,
                            tca.reference_paged_decode_attention) if paged
                           else (tca.decode_attention,
                                 tca.reference_decode_attention))
                times = []
                for keys in DECODE_SWEEP:
                    tca.decode_split = fixed(keys)
                    check(f"{tag} {name} split {keys}", call(fn, 0),
                          call(ref, 0), tol)
                    times.append(time_ms(cycling(
                        lambda i: call(fn, i), LAYERS)))
                print(f"[splits] {tag} {name:4s} B={B} S={S}: "
                      + ", ".join(f"{keys} keys {t:.4f} ms" for keys, t
                                  in zip(DECODE_SWEEP, times)), flush=True)
    finally:
        tca.decode_split = keep


FLASH_B, FLASH_H, FLASH_T, FLASH_D = 8, 12, 512, 64
FLASH_TYPES = (("f32", torch.float32, F32_TOL), ("bf16", torch.bfloat16,
                                                 BF16_TOL))
# (T, S, label): the training shape, then two shapes checked only
FLASH_SHAPES = ((FLASH_T, FLASH_T, ""), (500, 500, " ragged T=S=500"),
                (128, FLASH_T, " bottom-right T=128 S=512"))


def flash_tensors(gen, dev, dtype, *lengths):
    """(B, H, n, D) normal draws, one per length, in `dtype`."""
    return [torch.randn(FLASH_B, FLASH_H, n, FLASH_D, generator=gen,
                        device=dev).to(dtype) for n in lengths]


def live_pairs(t: int, s: int) -> int:
    """(query, key) pairs a causal (bottom-right) call computes, per
    (batch, head)."""
    return sum(min(s, r + 1 + s - t) for r in range(t))


def flash_bound(nbytes: float, flops: float, f32: bool) -> dict:
    """The bound of a flash kernel (K1-K4): the larger of its bytes at
    3.35 TB/s and its function's own products (`flops`) at the card's
    fastest rate for the inputs' type -- bf16 on the tensor cores at 989
    TFLOP/s, f32 on the TF32 tensor cores at 494.7 (a kernel that keeps
    f32 accuracy issues more than that; what it issues does not move the
    bound). Also the same products as f32 FMAs on the CUDA cores at 67,
    the bound of the f32 CUDA-core designs."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / (TF32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S) * 1e3
    return dict(nbytes=nbytes, flops=flops, f32=f32, bytes_ms=bytes_ms,
                ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                f32_cuda_core_ms=flops / F32_FLOPS_PER_S * 1e3)


def flash_report(tag, label, row, b):
    """One flash kernel's line: its time beside the plain version, the
    library yardstick and the bound `b` (flash_bound), and the products
    on the units the kernel runs them on: issued on the tensor cores as
    split f32 products where `b` has "issued" (f32), else on the tensor
    cores in bf16."""
    lib = row["library_ms"]
    if "issued" in b:
        tf32, bf16 = b["issued"]["tf32"], b["issued"]["bf16"]
        issued_ms = (tf32 / TF32_FLOPS_PER_S + bf16 / BF16_FLOPS_PER_S) * 1e3
        units = (f"issued on the tensor cores as split products: TF32 "
                 f"{tf32 / 1e9:.2f} GFLOP at 494.7 + bf16 {bf16 / 1e9:.2f} "
                 f"GFLOP at 989, {issued_ms:.5f}; as f32 FMAs on the CUDA "
                 f"cores {b['f32_cuda_core_ms']:.5f} at 67")
    else:
        units = "products on the tensor cores"
    print(f"[{tag}] {label}: err {row['max_abs_err']:.3e} kernel_ms "
          f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
          f"{'none' if lib is None else f'{lib:.4f}'} bound_ms "
          f"{row['bound_ms']:.5f} ({row['bound_by']}; bytes "
          f"{b['bytes_ms']:.5f} for {b['nbytes'] / 1e6:.1f} MB at 3.35 TB/s, "
          f"ops {b['ops_ms']:.5f} for {b['flops'] / 1e9:.2f} GFLOP at "
          f"{'TF32 494.7' if b['f32'] else 'bf16 989'} TFLOP/s; {units}); "
          f"kernel / bound {row['ms'] / row['bound_ms']:.1f}", flush=True)


def flash_fwd_bound(f32: bool, bh: int, t: int, s: int, d: int,
                    with_lse: bool) -> dict:
    """flash_bound of K1 (with_lse False) or K2 at (bh, t, s, d), causal.
    Bytes: q (t rows), k and v (s rows) read, out (t) written, in the
    inputs' type, plus K2's lse (f32). Products: S and P.V, 2 d flops per
    live pair each. In f32, "issued" also gives what the split design
    issues (information, not the bound): S as three TF32 products, P.V as
    three bf16 products."""
    nbytes = (2 * t + 2 * s) * bh * d * (4 if f32 else 2)
    if with_lse:
        nbytes += bh * t * 4
    product = 2 * d * bh * live_pairs(t, s)
    b = flash_bound(nbytes, 2 * product, f32)
    if f32:
        b["issued"] = dict(tf32=3 * product, bf16=3 * product)
    return b


def flash_bwd_bound(kernel: str, f32: bool, bh: int, t: int, s: int,
                    d: int) -> dict:
    """flash_bound of K3 (kernel "flash_bwd_dq") or K4 ("flash_bwd_dkv")
    at (bh, t, s, d), causal. Bytes: q and dO (t rows), k and v (s rows)
    read, dQ (t) or dK and dV (s) written, in the inputs' type, plus lse
    and D (f32). Products: the backward's own (K3: S, dP, dQ; K4: S, dP,
    dV, dK), 2 d flops per live pair each. In f32, "issued" also gives
    what the split design issues (information, not the bound): each
    product as three, the score product on TF32 and the others on bf16."""
    el = 4 if f32 else 2
    rows_out = t if kernel == "flash_bwd_dq" else 2 * s
    nbytes = (2 * t + 2 * s + rows_out) * bh * d * el + 2 * bh * t * 4
    product = 2 * d * bh * live_pairs(t, s)
    n_products = 3 if kernel == "flash_bwd_dq" else 4
    b = flash_bound(nbytes, n_products * product, f32)
    if f32:
        b["issued"] = dict(tf32=3 * product,
                           bf16=3 * (n_products - 1) * product)
    return b


def yardstick_ms(label, fn):
    """time_ms of a library call used only as a yardstick; None (and a
    note) where this torch build does not run it."""
    try:
        return time_ms(fn)
    except Exception as e:  # noqa: BLE001 — a yardstick, not the port
        print(f"[yardstick] {label}: not timed ({type(e).__name__}: "
              f"{str(e)[:120]})", flush=True)
        return None


def phase_flash_fwd(dev, gen):
    """K1 (flash_attention without a gradient) and K2 (with the
    logsumexp) against the plain versions at the training shape (B=8
    H=12 T=S=512 D=64, causal), f32 and bf16, plus the ragged and the
    bottom-right shape (checked only). bf16 is held against the plain
    version run in f32 on the same bf16 values. Returns {kernel: {dtype:
    row}}."""
    from dnn_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_lse, reference_attention,
        reference_attention_lse)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"flash_attention": {}, "flash_attention_lse": {}}
    for name, dt, tol in FLASH_TYPES:
        err1 = err2 = 0.0
        for t, s, label in FLASH_SHAPES:
            q, k, v = flash_tensors(gen, dev, dt, t, s, s)
            qf, kf, vf = q.float(), k.float(), v.float()
            want2, want_lse = reference_attention_lse(qf, kf, vf)
            err1 = max(err1, check(f"K1 {name}{label}",
                                   flash_attention(q, k, v).float(),
                                   reference_attention(qf, kf, vf), tol))
            out, lse = flash_attention_lse(q, k, v)
            err2 = max(err2, check(f"K2 {name}{label} out", out.float(),
                                   want2, tol),
                       check(f"K2 {name}{label} lse", lse, want_lse,
                             F32_TOL))
            if (t, s) == (FLASH_T, FLASH_T):
                main = (q, k, v)
        q, k, v = main
        bh = FLASH_B * FLASH_H
        lib1 = time_ms(lambda: sdpa(q, k, v, is_causal=True))
        # K2's yardstick: a call that also returns the logsumexp. In bf16
        # the flash backend (the backend of K1's SDPA yardstick); the
        # efficient-attention backend, which takes f32 too, beside it.
        lib2 = eff2 = yardstick_ms(
            "SDPA with logsumexp (aten efficient attention)",
            lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                q, k, v, None, True, is_causal=True))
        if dt == torch.bfloat16:
            lib2 = yardstick_ms(
                "SDPA with logsumexp (aten flash attention)",
                lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    q, k, v, 0.0, True))
            print(f"[K2] {name} yardsticks with the logsumexp (ms): flash "
                  f"backend {lib2} (library_ms), efficient attention "
                  f"{eff2}", flush=True)
        for kname, fn, plain, err, lib in (
                ("flash_attention", lambda: flash_attention(q, k, v),
                 lambda: reference_attention(q, k, v), err1, lib1),
                ("flash_attention_lse", lambda: flash_attention_lse(q, k, v),
                 lambda: reference_attention_lse(q, k, v), err2, lib2)):
            b = flash_fwd_bound(dt == torch.float32, bh, FLASH_T, FLASH_T,
                                FLASH_D, kname == "flash_attention_lse")
            row = rows[kname][name] = dict(
                ms=time_ms(fn), plain_ms=time_ms(plain), library_ms=lib,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=err)
            flash_report("K1" if kname == "flash_attention" else "K2",
                         f"{name:4s} B=8 H=12 T=S=512 D=64 causal", row, b)
    flash_fwd_large_scores(dev, gen)
    return rows


def flash_fwd_large_scores(dev, gen):
    """Checked only: K1 and K2 in f32 at T=S=512 with q and k x 4, so that
    scores reach tens, as a trained model's do; an error in the score
    product goes through exp into out and the lse. Limit 1e-4 absolute;
    K1's out equals K2's bit for bit."""
    from dnn_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_lse, reference_attention_lse)

    q, k, v = flash_tensors(gen, dev, torch.float32, FLASH_T, FLASH_T,
                            FLASH_T)
    q, k = 4 * q, 4 * k
    out1 = flash_attention(q, k, v)
    out, lse = flash_attention_lse(q, k, v)
    want, want_lse = reference_attention_lse(q, k, v)
    e1 = check("K1 f32 q, k x 4", out1, want, F32_TOL)
    e2 = check("K2 f32 q, k x 4 out", out, want, F32_TOL)
    el = check("K2 f32 q, k x 4 lse", lse, want_lse, F32_TOL)
    if not torch.equal(out1, out):
        fail("K1 f32 q, k x 4: out differs from K2's")
    print(f"[K1/K2] f32 T=S=512 q, k x 4 (checked only) max abs err (limit "
          f"{F32_TOL:g}): K1 out {e1:.3e}, K2 out {e2:.3e}, lse {el:.3e} "
          f"(lse up to {want_lse.abs().max().item():.1f})", flush=True)


def phase_flash_bwd(dev, gen):
    """K3 (dQ) and K4 (dK, dV) at the same shapes, held against
    torch.autograd.grad through the plain reference_attention (in f32 on
    the same values for bf16). Tolerance relative to each gradient's max
    |value|: 1e-4 for f32 (sums of up to 512 products in another order),
    2e-2 for bf16 (outputs rounded to bf16). Returns {kernel: {dtype:
    row}}."""
    from dnn_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_lse, flash_bwd_dkv, flash_bwd_dq, reference_attention,
        reference_flash_bwd_dkv, reference_flash_bwd_dq)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for name, dt, tol in FLASH_TYPES:
        err3 = err4 = 0.0
        for t, s, label in FLASH_SHAPES:
            q, k, v, do = flash_tensors(gen, dev, dt, t, s, s, t)
            qf, kf, vf = (x.float().requires_grad_(True) for x in (q, k, v))
            gq, gk, gv = torch.autograd.grad(reference_attention(qf, kf, vf),
                                             (qf, kf, vf), do.float())
            out, lse = flash_attention_lse(q, k, v)
            di = (do.float() * out.float()).sum(-1)
            dq = flash_bwd_dq(q, k, v, do, lse, di)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, di)
            errs = {}
            for g, got, want in (("dq", dq, gq), ("dk", dk, gk),
                                 ("dv", dv, gv)):
                top = want.abs().max().item()
                errs[g] = check(f"K{3 if g == 'dq' else 4} {name}{label} "
                                f"{g}", got.float(), want, tol * top), top
            print(f"[K3/K4] {name}{label or ' T=S=512'} max abs err / the "
                  "gradient's max |value| (limit "
                  f"{tol:g}): " + ", ".join(
                      f"{g} {e:.3e} / {top:.3f} = {e / top:.2e}"
                      for g, (e, top) in errs.items()), flush=True)
            err3 = max(err3, errs["dq"][0])
            err4 = max(err4, errs["dk"][0], errs["dv"][0])
            if (t, s) == (FLASH_T, FLASH_T):
                main = (q, k, v, do, lse, di)
        q, k, v, do, lse, di = main
        bh = FLASH_B * FLASH_H
        qg, kg, vg = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        # SDPA's backward: the device time of autograd.grad of SDPA
        # minus that of its forward (a backward is not captured into a
        # graph here; eager event timing would count host overhead)
        lib = (device_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do))
            - device_ms(lambda: sdpa(q, k, v, is_causal=True)))
        if dt == torch.bfloat16:
            # bf16: the flash backend's backward alone, on the residuals
            # of its forward, replayed from a CUDA graph as the kernels
            # are (the difference above spreads from run to run)
            res = []

            def sdpa_backward():
                if not res:  # the forward's residuals, once, in the warm-up
                    res.extend(torch.ops.aten
                               ._scaled_dot_product_flash_attention(
                                   q, k, v, 0.0, True))
                o, l, cq, ck, mq, mk, seed, offset, _ = res
                return (torch.ops.aten
                        ._scaled_dot_product_flash_attention_backward(
                            do, q, k, v, o, l, cq, ck, mq, mk, 0.0, True,
                            seed, offset))
            graphed = yardstick_ms(
                "SDPA's backward (aten flash attention backward)",
                sdpa_backward)
            print(f"[K3/K4] {name} SDPA's whole backward (ms): flash "
                  f"backend's backward, graph-timed, {graphed} "
                  f"(library_ms); autograd.grad minus forward, profiled, "
                  f"{lib}", flush=True)
            if graphed is not None:
                lib = graphed
        for kname, fn, plain, err in (
                ("flash_bwd_dq", lambda: flash_bwd_dq(q, k, v, do, lse, di),
                 lambda: reference_flash_bwd_dq(q, k, v, do, lse, di), err3),
                ("flash_bwd_dkv", lambda: flash_bwd_dkv(q, k, v, do, lse, di),
                 lambda: reference_flash_bwd_dkv(q, k, v, do, lse, di),
                 err4)):
            b = flash_bwd_bound(kname, dt == torch.float32, bh, FLASH_T,
                                FLASH_T, FLASH_D)
            row = rows[kname][name] = dict(
                ms=time_ms(fn), plain_ms=time_ms(plain), library_ms=lib,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=err)
            flash_report("K3" if kname == "flash_bwd_dq" else "K4",
                         f"{name:4s} B=8 H=12 T=S=512 D=64 causal (library: "
                         "SDPA's whole backward, dQ dK dV)", row, b)
    flash_bwd_large_scores(dev, gen)
    return rows


def flash_bwd_large_scores(dev, gen):
    """Checked only: K3 and K4 in f32 at T=S=512 with q and k x 4, so that
    scores reach tens, as a trained model's do; an error in the score
    product goes through exp. Limit 1e-4 x each gradient's max |value|."""
    from dnn_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_lse, flash_bwd_dkv, flash_bwd_dq,
        reference_flash_bwd_dkv, reference_flash_bwd_dq)

    q, k, v, do = flash_tensors(gen, dev, torch.float32, FLASH_T, FLASH_T,
                                FLASH_T, FLASH_T)
    q, k = 4 * q, 4 * k
    out, lse = flash_attention_lse(q, k, v)
    di = (do * out).sum(-1)
    got = (flash_bwd_dq(q, k, v, do, lse, di),
           *flash_bwd_dkv(q, k, v, do, lse, di))
    want = (reference_flash_bwd_dq(q, k, v, do, lse, di),
            *reference_flash_bwd_dkv(q, k, v, do, lse, di))
    errs = []
    for g, a, b in zip(("dq", "dk", "dv"), got, want):
        top = b.abs().max().item()
        e = check(f"K{3 if g == 'dq' else 4} f32 q, k x 4 {g}", a, b,
                  F32_TOL * top)
        errs.append(f"{g} {e:.3e} / {top:.3f} = {e / top:.2e}")
    print("[K3/K4] f32 T=S=512 q, k x 4 (checked only) max abs err / the "
          f"gradient's max |value| (limit {F32_TOL:g}): " + ", ".join(errs),
          flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reference_greedy(prepared, cfg, prompt, n_new, dev, logits_out=None):
    """Independent greedy loop: the plain no-cache forward recomputed
    over the whole sequence for every token; `logits_out`, a list,
    receives each step's f32 logits row. Returns (tokens, top-2 logit gap
    at each step)."""
    from dnn_tpu_torch.runtime.generate import forward_no_cache

    ids = torch.tensor(prompt, dtype=torch.int64, device=dev)[None]
    toks, gaps = [], []
    for _ in range(n_new):
        logits = forward_no_cache(prepared, ids, cfg=cfg)[0, -1]
        if logits_out is not None:
            logits_out.append(logits.float())
        top2 = torch.topk(logits, 2).values
        gaps.append((top2[0] - top2[1]).item())
        nxt = int(logits.argmax())
        toks.append(nxt)
        ids = torch.cat([ids, torch.tensor([[nxt]], device=dev)], dim=1)
    return toks, gaps


def reference_greedy_cache(prepared, cfg, prompt, n_new, dev, kv_dtype,
                           chunk=None, compute_dtype=None, step_rows=1,
                           forced=None, logits_out=None, ffn=None):
    """Independent greedy loop over a dense cache of type `kv_dtype`
    ("f32", "bf16", "int8" or "int4"): no batcher and no kernel. A cache
    of prompt + n_new positions (at KV heads for a LlamaConfig); bf16
    stores K/V rounded to bf16, int8 quantizes them with the port's
    _quantize_rows and keeps the scales, int4 with _quantize_rows_int4
    (packed two values a byte, unpacked by the plain attention); attention is the plain version (grouped heads
    for llama), its output cast to the cache's type for a bf16 cache, as
    the port's FloatKV.attend does. The blocks around the attention are
    the family's own (gpt2's, or models/llama.py's), at `compute_dtype`
    (torch.bfloat16: bf16 compute over weights prepared in bf16 -- the
    residual stream and the block products in bf16, norms in f32, f32
    logits; the plain attention then takes a bf16 q and returns bf16).
    The prompt prefills in one piece or, with `chunk`, in chunk-token
    pieces, the last one right-padded with id 0, as the batcher prefills
    (the padded rows' K/V lie past every later query's limit). A decode
    step runs `step_rows` copies of its token (the batcher's slot count),
    so that every product and norm of the step has the batcher's row
    count and cuBLAS picks the batcher's kernels, which sum in their
    order; the cache and the attention see the first copy only.
    `forced`, where given, is fed in place of each step's argmax (teacher
    forcing), and `logits_out`, a list, receives each step's f32 logits
    row. The MLP is the family's: a MoE config's routed experts (a llama
    MoE config's default_ffn; `ffn` for gpt2-moe, as the batcher takes
    it), the step's copies routed together (a no-drop capacity routes
    each row alone). Returns (tokens, top-2 logit gap at each step)."""
    from dnn_tpu_torch.models.gpt import head, layer_params
    from dnn_tpu_torch.ops.attention import merge_heads
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        reference_cached_attention)
    from dnn_tpu_torch.ops.nn import embedding, layer_norm, linear
    from dnn_tpu_torch.runtime.generate import _ffn_out, _qkv_heads
    from dnn_tpu_torch.runtime.kvcache import (_quantize_rows,
                                               _quantize_rows_int4)

    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.runtime.kvcache import cache_shape

    if kv_dtype not in ("f32", "bf16", "int8", "int4"):
        raise ValueError(f"kv_dtype must be f32, bf16, int8 or int4, got "
                         f"{kv_dtype!r}")
    quant = kv_dtype in ("int8", "int4")
    quantize = _quantize_rows_int4 if kv_dtype == "int4" else _quantize_rows
    store = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8, "int4": torch.uint8}[kv_dtype]
    is_llama = isinstance(cfg, llama.LlamaConfig)
    padded = len(prompt) if chunk is None else -(-len(prompt) // chunk) * chunk
    shape = cache_shape(cfg, 1, max(padded, len(prompt) + n_new),
                        packed=kv_dtype == "int4")
    kv = {"k": torch.zeros(shape, dtype=store, device=dev),
          "v": torch.zeros(shape, dtype=store, device=dev)}
    if quant:
        kv["ks"] = torch.ones(shape[:-1], device=dev)
        kv["vs"] = torch.ones(shape[:-1], device=dev)

    def attend(i, q, k, v, start, pos):
        """Writes this layer's k/v at [start, start + T) of the cache,
        then attends it in the plain version (grouped heads for llama);
        of `step_rows` copies of a row, the first, its output copied."""
        copies = q.shape[0]
        q, k, v = q[:1], k[:1], v[:1]
        t = k.shape[2]
        for name, new in (("k", k), ("v", v)):
            if quant:
                payload, scale = quantize(new)
                kv[name + "s"][i, :, :, start:start + t] = scale
            else:
                payload = new.to(store)
            kv[name][i, :, :, start:start + t] = payload
        scales = {"ks": kv["ks"][i], "vs": kv["vs"][i]} if quant else {}
        y = reference_cached_attention(q, kv["k"][i], kv["v"][i], pos,
                                       **scales)
        y = y if quant else y.to(store)
        return y.expand(copies, *y.shape[1:])

    cdt = compute_dtype
    lffn = cfg.default_ffn(cdt) if is_llama else None

    def last_logits(ids, start):
        t = ids.shape[1]
        pos = torch.full((1,), start, dtype=torch.int32, device=dev)
        rows = torch.arange(start, start + t, device=dev)
        if is_llama:  # the LLaMA block, its attention the plain version
            x = llama._scaled_embed(prepared, ids, cfg)
            x = x if cdt is None else x.to(cdt)
            cos, sin = llama._rope_tables(cfg, rows)
            for i in range(cfg.n_layer):
                bp = layer_params(prepared["blocks"], i)
                h = llama._pre_normed(bp, x, cfg)
                q, k, v = llama._qkv(bp, h, cfg, cdt)
                q, k = llama._rotated(q, k, cos, sin, cfg)
                y = attend(i, q, k, v, start, pos)
                o = linear(bp["attn"]["o"], merge_heads(y.to(x.dtype)),
                           compute_dtype=cdt)
                x = llama._branches_residual(bp, x, o, h, cfg=cfg,
                                             compute_dtype=cdt, ffn=lffn)
            return llama.head(prepared, x.float(), cfg=cfg,
                              compute_dtype=cdt)[0]
        x = (embedding(prepared["wte"], ids)
             + embedding(prepared["wpe"], rows))
        x = x if cdt is None else x.to(cdt)
        for i in range(cfg.n_layer):
            bp = layer_params(prepared["blocks"], i)
            q, k, v = _qkv_heads(bp, layer_norm(bp["ln_1"], x, eps=cfg.ln_eps),
                                 cfg=cfg, compute_dtype=cdt)
            y = attend(i, q, k, v, start, pos)
            x = x + linear(bp["attn"]["proj"], merge_heads(y.to(x.dtype)),
                           compute_dtype=cdt)
            x = x + _ffn_out(bp, layer_norm(bp["ln_2"], x, eps=cfg.ln_eps),
                             x, cdt, ffn)
        return head(prepared, x.float(), cfg=cfg, compute_dtype=cdt)[0]

    with torch.no_grad():
        ids = torch.zeros((1, padded), dtype=torch.int64, device=dev)
        ids[0, :len(prompt)] = torch.tensor(prompt, device=dev)
        step = chunk or padded
        for c0 in range(0, padded, step):
            logits = last_logits(ids[:, c0:c0 + step], c0)
        logits = logits[len(prompt) - 1 - c0]
        start, toks, gaps = len(prompt), [], []
        for j in range(n_new):
            top2 = torch.topk(logits, 2).values
            gaps.append((top2[0] - top2[1]).item())
            if logits_out is not None:
                logits_out.append(logits.float())
            toks.append(int(logits.argmax()) if forced is None
                        else forced[j])
            logits = last_logits(torch.tensor(
                [[toks[-1]]] * step_rows, device=dev), start)[-1]
            start += 1
    return toks, gaps


NEAR_TIE = 1e-4
# llama3-8b over an int8 cache: a K/V value within f32 rounding noise of
# a quantization boundary rounds either way, and 32 layers carry the flip
# to the logits. L-C's served streams are held to the plain int8 loop
# prefilled in the served 64-token chunks; on an H100 they parted from it
# only at a top-2 gap of 1.967e-3, so the tie is that with 2.5x headroom
# (the [llama] lines print this run's gaps)
QUANT_TIE = 5e-3
# int4 KV on gpt2 (C-int4, B-int4) is held at QUANT_TIE too: a level is
# 1/7 of a row's largest value (int8's 1/127), so the kernels' f32 noise
# (about 1e-6 against the plain version) flips roundings 18x as often,
# each 18x as large. On an H100 C-int4's 300-token stream parted from the
# plain int4 loop (prefilled in the served chunks, stepping the pool's 4
# rows) at a top-2 gap of 2.4e-4, where both plain loops agree.
# llama3-8b over an int4 cache (L-C-int4), 32 layers of such flips: its
# served stream parted from the plain int4 loop at a top-2 gap of 1.0e-2
# on an H100 (every launch exact, K5/K7 int4 at llama3-8b's shapes within
# 1e-4 of their plain versions). A 7-level value is coarser than a bf16
# one (8 mantissa bits), so the tie is BF16_TIE's (the [llama] lines
# print where two plain int4 loops part).
# bf16 compute: the served streams are held to the plain loop in bf16
# compute over a bf16 (or int8) cache, prefilled in the served 64-token
# chunks, its decode steps at the pool's 4 rows (reference_greedy_cache's
# step_rows), so that its products and norms have the served shapes. The
# attention still differs (the kernels against the plain version, each
# rounding an f32 result to bf16 after summing in its own order), and a
# bf16 rounding that flips moves the logits: a stream may part from the
# loop where the loop's top-2 gap is below BF16_TIE. On an H100 the
# served streams parted at gaps of 9.3e-3 (gpt2, E and B-bf16) and
# 2.0e-2 to 8.4e-2 (llama3-8b, L-B, all four streams), and two plain
# llama3-8b loops that differ only in the prompt's chunking parted from
# each other at 5.9e-2: the same noise without a kernel. The tie is 2.4x
# the largest parting; the lines print every parting's step and gap, and
# PERF.md section 2 keeps them
BF16_TIE = 0.2
INT4_TIE = BF16_TIE  # llama3-8b over an int4 cache: see QUANT_TIE's note


def loop_partings(label, prompts, chunked, whole):
    """Prints, per prompt, where two plain loops that differ only in the
    prompt's chunking (and so in the order their attention sums) part:
    the step and the chunked loop's top-2 gap there, the measure of the
    noise a tie allows for."""
    for p, (toks, gaps), (other, _) in zip(prompts, chunked, whole):
        j = next((j for j, (a, b) in enumerate(zip(toks, other)) if a != b),
                 None)
        print(f"{label}, prompt {len(p)}: chunked and whole "
              + ("agree on every token" if j is None else
                 f"part at step {j}, top-2 gap {gaps[j]:.3e}")
              + f" (smallest gap {min(gaps):.3e})", flush=True)


def compare_tokens(label, got, want, gaps, tie=NEAR_TIE):
    """Served tokens against a reference's; a divergence is accepted only
    at a near-tie of the reference (top-2 gap < `tie`), and the rest of
    the stream is then not compared. `tie=None`: the first parting is
    printed, not judged (a run held by teacher forcing instead,
    forced_check)."""
    if len(got) != len(want):
        fail(f"{label}: {len(got)} tokens, expected {len(want)}")
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            if tie is None or gaps[j] < tie:
                kind = "parts" if tie is None else "near-tie"
                print(f"[main] {label}: {kind} at step {j} (top-2 gap "
                      f"{gaps[j]:.2e}), served {a} vs reference {b}; rest "
                      "not compared", flush=True)
                return
            fail(f"{label} step {j}: served {a} != reference {b} (top-2 gap "
                 f"{gaps[j]:.3e})\nserved    {got}\nreference {want}")
    print(f"[main] {label}: {got[:8]}... matches the reference", flush=True)


# teacher forcing: each token id spelled as a distinct three-letter word
# (62 ** 3 = 238328 words, more than the vocabularies forced here), so that a
# grammar spelling a token sequence allows exactly one token a step
FORCE_ALPHABET = ("abcdefghijklmnopqrstuvwxyz" "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                  "0123456789")
FORCED_TOPK = 8
# Q8-L's teacher-forced logprob error may be at most this multiple of
# L-B's (the bf16-compute control over the f32 weights, the same prompts
# and pool, measured in the same run). An int8 linear rounds to bf16
# twice (the product, then the product times the scale) where a bf16
# linear rounds once, so its noise could be up to sqrt(2) times the
# control's. On an H100 Q8-L's error was 0.83x L-B's (largest), 1.02x
# (rms), and each served path's about that of a second plain loop that
# differs only in the prefill's chunking; the lines print all three
FORCED_RATIO = 1.5


def forcing_constraint(tokens, vocab_size):
    """A TokenConstraint whose only sentence is `tokens`: a batcher given
    it is fed that stream through its own grammar mask (teacher forcing);
    the mask acts at sampling, so the forward is the served one."""
    from dnn_tpu_torch.runtime.constrain import TokenConstraint

    n = len(FORCE_ALPHABET)

    def word(t):
        return (FORCE_ALPHABET[t // (n * n)] + FORCE_ALPHABET[t // n % n]
                + FORCE_ALPHABET[t % n])

    vocab = [word(t).encode() for t in range(vocab_size)]
    return TokenConstraint.from_regex("".join(word(t) for t in tokens), vocab)


def forced_errors(want_rows, tokens, top_ids, top_lp, chosen_lp):
    """Per step, the largest |logprob| difference between a forced run
    (its top-k ids and logprobs (n, k), the forced tokens' logprobs
    (n,)) and the log_softmax of the reference's f32 logits rows, over
    the run's top k and the forced token. Returns an (n,) tensor."""
    lsm = torch.log_softmax(torch.stack(want_rows), dim=-1)
    dev = lsm.device
    ids = torch.as_tensor(np.asarray(top_ids), device=dev).long()
    toks = torch.as_tensor(tokens, device=dev)[:, None]
    err = torch.cat([
        (torch.as_tensor(np.asarray(top_lp), device=dev)
         - lsm.gather(1, ids)).abs(),
        (torch.as_tensor(np.asarray(chosen_lp), device=dev)[:, None]
         - lsm.gather(1, toks)).abs()], dim=1)
    return err.max(dim=1).values


def loop_forced_errors(tree, cfg, prompts, refs, ref_rows, dev, kv_dtype,
                       compute_dtype=None):
    """Teacher forcing of a plain loop (reference_greedy_cache over a
    `kv_dtype` cache, each prompt prefilled whole) on each prompt's
    reference tokens (`refs`): per prompt, forced_errors against the
    reference's logits rows `ref_rows`."""
    out = []
    for p, (toks, _), rows in zip(prompts, refs, ref_rows):
        got = []
        reference_greedy_cache(tree, cfg, p, len(toks), dev, kv_dtype,
                               compute_dtype=compute_dtype, step_rows=4,
                               forced=toks, logits_out=got)
        lsm = torch.log_softmax(torch.stack(got), dim=-1)
        top_lp, top_ids = torch.topk(lsm, FORCED_TOPK, dim=-1)
        chosen = lsm.gather(1, torch.tensor(toks, device=dev)[:, None])[:, 0]
        out.append(forced_errors(rows, toks, top_ids.cpu(), top_lp.cpu(),
                                 chosen.cpu()))
    return out


def forced_check(tag, label, cfg, tree, prompts, refs, ref_rows, dev,
                 loop_kv="bf16", **kw):
    """Teacher forcing: each prompt's chunked plain loop (`refs`, its
    logits rows `ref_rows`) fed, step by step, to (1) the served path --
    a ContinuousBatcher as the daemon builds it (4 slots, max_len 1024,
    prompt_pad 64, blocks of 16, the options `kw`), each request held
    to the loop's tokens by forcing_constraint, its logprobs on -- and
    (2) a second plain loop that prefills each prompt whole (a `loop_kv`
    cache, loop_forced_errors). Prints, per
    prompt, the largest logprob error of each against the loop and its
    step, over the forced token and the top FORCED_TOPK; fails if the
    batcher does not emit the forced stream. Returns the largest errors
    {"served": e, "loop": e}."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    n_new = len(refs[0][0])
    t0 = time.perf_counter()
    loop = loop_forced_errors(tree, cfg, prompts, refs, ref_rows, dev,
                              loop_kv, kw.get("compute_dtype"))
    b = ContinuousBatcher(
        cfg, tree, slots=4, max_len=1024, prompt_pad=64, block_len=16,
        seed=0, device=dev, allow_constraints=True,
        constraint_rows=len(prompts) * (3 * n_new + 1) + 1,
        logprobs_k=FORCED_TOPK, **kw)
    rids = [b.submit(p, n_new, logprobs=True,
                     constraint=forcing_constraint(toks, cfg.vocab_size))
            for p, (toks, _) in zip(prompts, refs)]
    b.drain()
    served = []
    for i, rid in enumerate(rids):
        toks, _, lps = b.claim(rid)
        if [int(t) for t in toks] != refs[i][0]:
            fail(f"[{tag}] {label} forced run, prompt {len(prompts[i])}: emitted "
                 f"{[int(t) for t in toks]}, not the forced "
                 f"{refs[i][0]}")
        served.append(forced_errors(ref_rows[i], refs[i][0], lps["top_ids"],
                                    lps["top_logprobs"], lps["chosen"]))
    for p, s_err, l_err in zip(prompts, served, loop):
        print(f"[{tag}] {label} teacher-forced, prompt {len(p)}: served path "
              f"{s_err.max().item():.3e} (step {int(s_err.argmax())}), "
              f"whole-prompt loop {l_err.max().item():.3e} (step "
              f"{int(l_err.argmax())}) from the chunked loop's logprobs; "
              f"step 0 {s_err[0].item():.3e} / {l_err[0].item():.3e}",
              flush=True)
    out = {name: max(e.max().item() for e in errs)
           for name, errs in (("served", served), ("loop", loop))}
    rms = {name: torch.cat(errs).square().mean().sqrt().item()
           for name, errs in (("served", served), ("loop", loop))}
    print(f"[{tag}] {label} teacher-forced logprob error over {len(prompts)} x "
          f"{n_new} steps: served {out['served']:.3e} (rms of the steps' "
          f"maxima {rms['served']:.3e}), whole-prompt loop "
          f"{out['loop']:.3e} ({rms['loop']:.3e}); in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def hold_forced(q8l, lb):
    """Q8-L's teacher-forced error against its control's, L-B's."""
    said = (f"[quant] Q8-L: teacher-forced logprob error {q8l['served']:.3e}"
            f" against L-B's {lb['served']:.3e}")
    if q8l["served"] > FORCED_RATIO * lb["served"]:
        fail(f"{said}: above {FORCED_RATIO}x")
    print(f"{said}, at most {FORCED_RATIO}x (whole-prompt loops "
          f"{q8l['loop']:.3e} and {lb['loop']:.3e})", flush=True)


CACHE_KERNELS = ("cached_attention", "decode_attention",
                 "paged_decode_attention")
FLASH_KERNELS = ("flash_attention", "flash_attention_lse", "flash_bwd_dq",
                 "flash_bwd_dkv")


def _wrappers():
    from dnn_tpu_torch.ops.cuda import cached_attention as tca
    from dnn_tpu_torch.ops.cuda import flash_attention as tfa

    out = {name: getattr(tca, name) for name in CACHE_KERNELS}
    out.update({name: getattr(tfa, name) for name in FLASH_KERNELS})
    return out


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        for dt in fn.launches_by_dtype:
            fn.launches_by_dtype[dt] = 0
        for dt in getattr(fn, "launches_bf16_q", ()):
            fn.launches_bf16_q[dt] = 0
        for by in getattr(fn, "launches_by_variant", {}).values():
            for dt in by:
                by[dt] = 0


def read_variants():
    """{cache kernel: {"band" | "softcap" | "d256": {cache dtype:
    launches}}} since the last reset."""
    return {name: {v: dict(by) for v, by in
                   _wrappers()[name].launches_by_variant.items()}
            for name in CACHE_KERNELS}


def read_counts(bf16_q=False):
    """{kernel: {cache dtype: launches}} since the last reset; with
    `bf16_q`, the cache kernels' launches with a bf16 q only."""
    if bf16_q:
        return {name: dict(_wrappers()[name].launches_bf16_q)
                for name in CACHE_KERNELS}
    return {name: dict(fn.launches_by_dtype)
            for name, fn in _wrappers().items()}


def require(label, counts, needed):
    print(f"[main] {label} launches: {counts}", flush=True)
    for name, dt in needed:
        if counts[name][dt] <= 0:
            fail(f"{label}: {name} ({dt}) was never launched")


def serve_run(label, cfg, prepared, prompts, n_new, refs, needed, dev,
              card, exact=None, tie=NEAR_TIE, info=None, same_as=None,
              **kv):
    """One main-path run: the LM daemon in-process (4 slots, max_len
    1024, prompt_pad 64) with the cache options `kv`, 4 concurrent gRPC
    generate calls, greedy; tokens checked against `refs` (tokens, gaps)
    per prompt, and every (kernel, dtype) of `needed` launched in the
    run. `exact(steps)`, where given, returns {(kernel, dtype): launches}
    that the run must show exactly, from the number of decode steps the
    batcher took in it (counted). `tie` is compare_tokens'. Under bf16
    compute (`compute_dtype` among `kv`) every cache-kernel launch of the
    run must have taken a bf16 q. The decode steps are the batcher's
    captured graph on the card: the exact counts hold only if each
    replay counted its captured launches. `info`, where given, receives
    the run's streams, tokens/s and TTFT; `same_as`, another run's
    `info`, makes every stream equal that run's token for token (an
    interleaved run against its convoy run). Returns the run's launch
    counts (under bf16 compute, those with a bf16 q)."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    gc.collect()  # earlier graphs go now, not during this daemon's capture
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, **kv)
    batcher = stop.servicer.batcher
    step, n_steps = batcher.step, [0]

    def counted_step():  # the worker steps only while a slot is active
        n_steps[0] += 1
        return step()

    batcher.step = counted_step
    results, errors = {}, []
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail(f"{label}: LM daemon never became healthy")
        client.generate(prompts[0], max_new_tokens=2, timeout=300)  # warm-up
        sync(dev)
        grows0 = batcher.bucket_grows
        graph = batcher._graph_step
        caps0 = graph.captures if graph is not None else 0
        # a speculative batcher's mixed steps are its "spec_mixed" graph
        mixed_kind = "spec_mixed" if hasattr(batcher, "spec_k") else "mixed"
        mixed0 = (list(graph.counts.get(mixed_kind, [0, 0]))
                  if graph is not None else [0, 0])
        chunks0 = batcher.prefill_chunks_run
        # the daemon's goodput gauges over this run alone (a fresh
        # tracker: its window starts here)
        good = fresh_goodput(stop.servicer)
        spec = hasattr(batcher, "spec_steps")
        spec0 = ((batcher.spec_steps, batcher.spec_proposed,
                  batcher.spec_accepted) if spec else None)
        reset_counts()
        n_steps[0] = 0

        def call(i):
            try:
                results[i] = client.generate(prompts[i], max_new_tokens=n_new,
                                             timeout=300).tolist()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = read_counts()
        counts_bf16_q = read_counts(bf16_q=True)
        goodput = None if good is None else (good.mbu(), good.mfu(),
                                             good.tokens_per_sec())
        steps = n_steps[0]
        grows = batcher.bucket_grows - grows0
        captures = (graph.captures if graph is not None else 0) - caps0
        chunks = batcher.prefill_chunks_run - chunks0
        mixed = ([a - b for a, b in zip(graph.counts.get(mixed_kind, [0, 0]),
                                        mixed0)]
                 if graph is not None else [0, 0])
        if spec:
            spec0 = [a - b for a, b in zip(
                (batcher.spec_steps, batcher.spec_proposed,
                 batcher.spec_accepted), spec0)]
        if errors or len(results) != len(prompts):
            fail(f"{label}: generate calls failed: {errors or 'timed out'}")
        # TTFT, as information: one streamed request on the idle daemon
        t1 = time.perf_counter()
        stream = client.generate_stream(prompts[3], max_new_tokens=n_new,
                                        timeout=300)
        next(stream)
        ttft = time.perf_counter() - t1
        rest = list(stream)
        client.close()
    finally:
        stop()
    if len(rest) != n_new - 1:
        fail(f"{label}: stream returned {len(rest) + 1} tokens, expected {n_new}")
    layout = "paged" if batcher.paged else "dense"
    compute = "bf16" if kv.get("compute_dtype") is not None else "f32"
    print(f"[main] run {label} ({layout} pool, {compute} compute, kv_dtype "
          f"{kv.get('kv_dtype') or compute}"
          + (f", {grows} bucket grows, final bucket "
             f"{batcher.cache['k'].shape[3]}"
             if kv.get("decode_buckets") else "")
          + (f"; decode step a CUDA graph: {captures} captures and "
             f"{steps - captures} replays in the run's {steps} steps"
             if graph is not None else f"; {steps} eager decode steps")
          + (f", of them {sum(mixed)} mixed steps ({mixed[0]} captures, "
             f"{mixed[1]} replays) folding {chunks} prompt chunks of "
             f"{kv['prefill_chunk_tokens']} tokens"
             + (", overlapped" if kv.get("overlap") else "")
             if kv.get("prefill_chunk_tokens") else "")
          + ")", flush=True)
    if dev.type == "cuda":
        require(f"run {label}", counts, needed)
        if compute == "bf16":
            cache_counts = {n: counts[n] for n in CACHE_KERNELS}
            if counts_bf16_q != cache_counts:
                fail(f"run {label}: launches with a bf16 q "
                     f"{counts_bf16_q} are not all of the run's "
                     f"{cache_counts}")
        if exact is not None:
            want = exact(steps)
            for (name, dt), n in want.items():
                if counts[name][dt] != n:
                    fail(f"run {label}: {name} ({dt}) launched "
                         f"{counts[name][dt]} times, expected {n} from the "
                         f"call pattern ({steps} decode steps)")
            print(f"[main] run {label}: launches equal the call pattern's "
                  f"({steps} decode steps): " + ", ".join(
                      f"{name} {dt} {n}" for (name, dt), n in want.items()),
                  flush=True)
    n_tokens = sum(len(r) for r in results.values())
    if spec:
        print(f"[main] run {label}: speculative, spec_k "
              f"{batcher.spec_k}, draft {batcher.draft_cfg.n_layer} layers "
              f"x {batcher.draft_cfg.n_embd}: {steps} steps, "
              f"{spec0[2]} of {spec0[1]} proposals accepted (acceptance "
              f"{spec0[2] / max(spec0[1], 1):.3f}), "
              f"{(n_tokens - len(results)) / max(steps, 1):.2f} decode "
              f"tokens a step", flush=True)
    print(f"[main] run {label}: 4 concurrent requests, {n_tokens} tokens in "
          f"{wall:.3f} s = {n_tokens / wall:.1f} tokens/s; TTFT (300-token "
          f"prompt, idle daemon) {ttft * 1e3:.1f} ms; on {card}", flush=True)
    if goodput is not None:
        print(f"[main] run {label}: the daemon's goodput gauges over the "
              f"run: dnn_tpu_mbu {goodput[0]:.4f}, dnn_tpu_mfu "
              f"{goodput[1]:.5f} (bf16 peak), goodput "
              f"{goodput[2]:.1f} tokens/s; on {card}", flush=True)
    if same_as is not None:
        for i, prompt in enumerate(prompts):
            if results[i] != same_as["streams"][i]:
                fail(f"run {label} request {i} (prompt {len(prompt)}): "
                     f"{results[i]} differs from the convoy run's "
                     f"{same_as['streams'][i]}")
        print(f"[main] run {label}: every stream equals run "
              f"{same_as['label']}'s token for token; {n_tokens / wall:.1f} "
              f"tokens/s against {same_as['tokens_per_s']:.1f}, TTFT "
              f"{ttft * 1e3:.1f} ms against {same_as['ttft_ms']:.1f} ms; on "
              f"{card}", flush=True)
    if info is not None:
        info.update(label=label, streams=[results[i]
                                          for i in range(len(prompts))],
                    tokens_per_s=n_tokens / wall, ttft_ms=ttft * 1e3,
                    steps=steps, spec=spec0, goodput=goodput)
    for i, prompt in enumerate(prompts):
        compare_tokens(f"run {label} request {i} (prompt {len(prompt)})",
                       results[i], *refs[i], tie=tie)
    return counts_bf16_q if compute == "bf16" else counts


def fresh_goodput(srv):
    """A fresh GoodputTracker (the daemon's cost model and SLOs) in place
    of the daemon's, so that its gauges' window starts now; None when obs
    is off. The MBU and MFU it reads are over the run that follows:
    bytes and FLOPs the runs' steps priced by the cost model, over the
    wall since, against the card's peaks."""
    from dnn_tpu_torch.obs.goodput import GoodputTracker

    old = srv.goodput
    if old is None:
        return None
    g = GoodputTracker(old.cost, slo=old.slo).install()
    srv.goodput = srv.batcher.goodput = srv.worker.goodput = g
    return g


def phase_solo(cfg, prepared, prompt, n_new, refs, dev):
    """Solo make_generate on the card, f32, bf16 and int8 caches, greedy,
    against the no-cache reference and the bf16 and int8 cache loops.
    Returns launches."""
    from dnn_tpu_torch.runtime.generate import make_generate

    total = {}
    for kv_dtype, ref in refs.items():
        gen = make_generate(cfg, max_new_tokens=n_new, kv_dtype=kv_dtype,
                            device=dev)
        gen(prepared, [prompt[:8]])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = gen(prepared, [prompt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        require(f"make_generate {kv_dtype}", counts,
                [("cached_attention", kv_dtype),
                 ("decode_attention", kv_dtype)])
        print(f"[main] make_generate {kv_dtype}: {n_new} tokens after a "
              f"{len(prompt)}-token prompt in {wall * 1e3:.1f} ms", flush=True)
        compare_tokens(f"make_generate {kv_dtype}", out[0].tolist(), *ref)
        for name, by in counts.items():
            for dt, n in by.items():
                total.setdefault(name, {}).setdefault(dt, 0)
                total[name][dt] += n
    return total


G_PREFIX, G_SUFFIXES, G_NEW = 300, (5, 12, 19, 26, 33, 40, 9, 23), 16


def g_prompts(vocab: int):
    """[serve] G's schedule: 8 prompts that share a 300-token prefix, each
    with its own 5-40-token suffix; then a 320-token prompt whose last 20
    tokens leave the cached text in the middle of block 18 (positions
    288-303: a copy-on-write of the boundary block), and the same
    320-token prompt again (block-aligned and wholly cached: a full hit,
    zero chunks)."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, vocab, G_PREFIX).tolist()
    out = [base + rng.integers(0, vocab, n).tolist() for n in G_SUFFIXES]
    cow = base + rng.integers(0, vocab, 320 - G_PREFIX).tolist()
    return out + [cow, cow]


def run_schedule(b, prompts, n_new, dev):
    """Drive a batcher directly as the daemon's worker does: each prompt
    admitted as a slot frees, in order, steps while anything is active.
    Returns (streams, each admission's wall in ms: for convoy admission
    the time to the first token)."""
    from dnn_tpu_torch.parallel.pipeline import sync

    rids, walls, todo = {}, {}, list(enumerate(prompts))
    while todo or b.n_active:
        while todo and b.free_slots():
            i, p = todo.pop(0)
            sync(dev)
            t0 = time.perf_counter()
            rids[i] = b.submit(p, n_new)
            sync(dev)
            walls[i] = (time.perf_counter() - t0) * 1e3
        if b.n_active:
            b.step()
    b.flush_overlap()
    return [b.results[rids[i]].tolist() for i in range(len(prompts))], walls


def phase_prefix(tag, cfg, prepared, dev, card, needed, **kv):
    """G (kv="paged": the radix store) or G-dense (kv="dense": the exact-
    prefix LRU): g_prompts' schedule through a batcher at run A's size
    (4 slots, max_len 1024, prompt_pad 64), greedy, 16 tokens each, with
    prefix_cache=256 and without; every stream of both against the
    no-cache greedy loop (near-tie rule); with the cache the schedule
    must run fewer prompt chunks, the copy-on-write prompt must hit, and
    its repeat must run zero chunks. Launch counts zeroed just before the
    cached run and read just after. Returns them."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    prompts = g_prompts(cfg.vocab_size)
    refs = [reference_greedy(prepared, cfg, p, G_NEW, dev) for p in prompts]
    pool = dict(slots=4, max_len=1024, prompt_pad=64, block_len=16,
                device=dev, **kv)
    plain = ContinuousBatcher(cfg, prepared, **pool)
    run_schedule(plain, prompts[:1], 2, dev)  # warm-up: kernels, graph
    chunks0 = plain.prefill_chunks_run
    got_plain, walls_plain = run_schedule(plain, prompts, G_NEW, dev)
    chunks_plain = plain.prefill_chunks_run - chunks0
    del plain
    b = ContinuousBatcher(cfg, prepared, prefix_cache=256, **pool)
    run_schedule(b, [prompts[0][:8]], 2, dev)  # warm-up, nothing to share
    b.prefix_hits = b.prefix_misses = b.prefill_chunks_run = 0
    reset_counts()
    got, walls = run_schedule(b, prompts[:-1], G_NEW, dev)
    chunks_cow = b.prefill_chunks_run
    hit = run_schedule(b, prompts[-1:], G_NEW, dev)
    got.append(hit[0][0])
    walls[len(prompts) - 1] = hit[1][0]
    counts = read_counts()
    chunks = b.prefill_chunks_run
    if dev.type == "cuda":
        require(f"[serve] {tag}", counts, needed)
    for i, p in enumerate(prompts):
        for run, stream in (("cached", got[i]), ("uncached", got_plain[i])):
            compare_tokens(f"[serve] {tag} {run} request {i} (prompt "
                           f"{len(p)})", stream, *refs[i])
    if chunks >= chunks_plain:
        fail(f"[serve] {tag}: {chunks} prompt chunks with the prefix cache, "
             f"{chunks_plain} without")
    if chunks != chunks_cow:
        fail(f"[serve] {tag}: the repeated {len(prompts[-1])}-token prompt "
             f"ran {chunks - chunks_cow} chunks, expected a full hit")
    if b.prefix_misses != 1 or b.prefix_hits != len(prompts) - 1:
        fail(f"[serve] {tag}: {b.prefix_hits} hits and {b.prefix_misses} "
             f"misses, expected {len(prompts) - 1} and 1")
    store = b._prefix_store
    print(f"[serve] {tag} ({'radix store' if store else 'dense LRU'}, "
          f"prefix_cache=256): {len(prompts)} prompts of "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens "
          f"sharing a {G_PREFIX}-token prefix, {G_NEW} tokens each: "
          f"{chunks} prompt chunks with the cache ({chunks_plain} without), "
          f"{b.prefix_hits} hits, {b.prefix_misses} misses, "
          f"{b.prefix_evictions} evictions"
          + (f", {store.n_blocks} resident blocks, {store.block_hits} "
             f"blocks reused" if store else
             f", {len(b._prefix_cache)} entries")
          + f"; every stream of both runs matches the reference", flush=True)
    print(f"[serve] {tag}: time to first token (admission wall, idle "
          f"pool): a miss {walls[0]:.1f} ms, a hit {walls[1]:.1f} ms, the "
          f"copy-on-write hit {walls[len(prompts) - 2]:.1f} ms, the full "
          f"hit {walls[len(prompts) - 1]:.1f} ms; without the cache "
          f"{walls_plain[0]:.1f} / {walls_plain[1]:.1f} ms; launches "
          f"{ {n: counts[n] for n in CACHE_KERNELS} }; on {card}",
          flush=True)
    return counts


def phase_bias_logprobs(cfg, prepared, prompts, refs, dev, card):
    """[serve] bias and logprobs: run A's daemon (paged f32) over gRPC
    with b= (the per-request logit bias): the greedy stream's first token
    banned (-1e9) never appears, and a token forced (+1e9) is every
    token; then a batcher at A's pool with logprobs_k=5: each chosen
    token's logprob within 1e-4 of the log_softmax of the no-cache
    loop's logits at that step, first token included, the stream equal
    to the reference. Launch counts zeroed before and read after.
    Returns them."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.runtime.generate import forward_no_cache
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    reset_counts()
    n_new = len(refs[0][0])
    banned, forced = refs[0][0][0], (refs[0][0][0] + 1) % cfg.vocab_size
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, kv="paged", allow_logit_bias=True)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail("[serve] bias: LM daemon never became healthy")
        no_ban = client.generate(prompts[0], max_new_tokens=n_new,
                                 logit_bias={banned: -1e9},
                                 timeout=300).tolist()
        all_forced = client.generate(prompts[1], max_new_tokens=n_new,
                                     logit_bias={forced: 1e9},
                                     timeout=300).tolist()
        client.close()
    finally:
        stop()
    if banned in no_ban:
        fail(f"[serve] bias: banned token {banned} appears in {no_ban}")
    if set(all_forced) != {forced}:
        fail(f"[serve] bias: forced token {forced}, served {all_forced}")
    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, block_len=16, device=dev,
                          kv="paged", logprobs_k=5)
    rid = b.submit(prompts[1], n_new, logprobs=True)
    b.drain()
    tokens, _reason, lps = b.claim(rid)
    tokens = tokens.tolist()
    compare_tokens("[serve] logprobs_k=5 stream", tokens, *refs[1])
    ids = torch.tensor(prompts[1], dtype=torch.int64, device=dev)[None]
    want = []
    for t in tokens:
        lsm = torch.log_softmax(forward_no_cache(prepared, ids, cfg=cfg)
                                [0, -1].float(), dim=-1)
        want.append(float(lsm[t]))
        ids = torch.cat([ids, torch.tensor([[t]], device=dev)], dim=1)
    err = float(np.abs(np.asarray(want) - lps["chosen"]).max())
    if err > 1e-4:
        fail(f"[serve] logprobs: chosen logprobs {lps['chosen']} differ "
             f"from the plain loop's {want} by {err:.3e}")
    counts = read_counts()
    if dev.type == "cuda":
        require("[serve] bias/logprobs", counts,
                [("cached_attention", "f32"),
                 ("paged_decode_attention", "f32")])
    print(f"[serve] bias over gRPC (b=): banned token {banned} (the greedy "
          f"stream's first) never served in {n_new} tokens, forced token "
          f"{forced} served {len(all_forced)} of {len(all_forced)} times; "
          f"logprobs_k=5: {len(tokens)} chosen logprobs (first token "
          f"included) within {err:.2e} of the plain loop's log_softmax, "
          f"top-5 ids {lps['top_ids'].shape}; on {card}", flush=True)
    return counts


def mixed_profile(tag, label, cfg, prepared, prompts, dev, **kv):
    """Information, and one check: the mixed step of a batcher at run A's
    size with prefill_chunk_tokens=64 and overlap, 3 slots decoding while
    the 300-token prompt folds in 5 chunks: its wall a step as the
    captured graph and eagerly (the graph taken away), device busy under
    the profiler; then one replay of the mixed graph must give the eager
    mixed step's decode and chunk logits on the same static inputs bit
    for bit."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, block_len=16, device=dev,
                          prefill_chunk_tokens=64, overlap=True, **kv)
    for p in prompts[:3]:
        b.submit(p, 200)
    while b._pending_q:
        b.step()
    b.step()
    torch.cuda.synchronize()
    graph, walls = b._graph_step, {}

    def admit():
        rid = b.submit(prompts[3], 2)
        n = 0
        while b._pending_q:
            b.step()
            n += 1
        while rid not in b.results:
            b.step()
        return n

    for mode in ("captured", "eager"):
        b._graph_step = graph if mode == "captured" else None
        t0 = time.perf_counter()
        n = admit()
        torch.cuda.synchronize()
        walls[mode] = (time.perf_counter() - t0) * 1e3
        wall, dev_ms, n_kern, _, k5_ms, dec_ms = _profiled(admit)
        print(f"[{tag}] {label}: admission of a {len(prompts[3])}-token "
              f"prompt as {n} mixed steps (3 slots decoding, {mode}) "
              f"{walls[mode]:.3f} ms wall to its 2nd token; under the "
              f"profiler {wall:.3f} ms wall, {dev_ms:.3f} ms device busy "
              f"({100 * dev_ms / wall:.1f}%), {n_kern} kernel launches, "
              f"K5 {k5_ms:.3f} ms, K6/K7 {dec_ms:.3f} ms", flush=True)
    b._graph_step = graph
    print(f"[{tag}] {label}: mixed graph {graph.counts['mixed'][0]} "
          f"captures, {graph.counts['mixed'][1]} replays; captured / eager "
          f"admission wall {walls['captured'] / walls['eager']:.2f}",
          flush=True)
    g_mixed, static, log, _ = graph._graphs["mixed"]
    g_mixed.replay()
    log.replayed()
    torch.cuda.synchronize()
    replayed = [t.clone() for t in static]
    eager = b._mixed(b.cache, graph.tok, graph.pos, graph.active, b._row,
                     graph.chunk, graph.start)
    torch.cuda.synchronize()
    for what, r, e in zip(("decode", "chunk"), replayed, eager):
        if not torch.equal(r, e):
            fail(f"[{tag}] {label}: a replayed mixed step's {what} logits "
                 f"differ from the eager step's by "
                 f"{(r - e).abs().max().item():.3e}")
    print(f"[{tag}] {label}: one replayed mixed step's decode and chunk "
          f"logits equal the eager mixed step's on the same inputs bit for "
          f"bit", flush=True)
    b.drain()


def phase_serve(cfg, prepared, prompts, refs, a_info, dev, card):
    """[serve] ROADMAP item 4 b-c on the main path's gpt2 (seed 0): the
    bias and logprobs run; G the radix prefix store over A's pool and
    G-dense the dense LRU over B's pool without buckets; H the LM daemon
    at A's configuration with prefill_chunk_tokens=64 and overlap=True,
    the four concurrent clients of A, every stream equal to A's convoy
    stream token for token and to the reference, K5 once a layer a
    chunk (inside the mixed graph) and K7 once a layer a step, exactly;
    then (on the card) mixed_profile. Returns the launches."""
    L = cfg.n_layer
    chunks = sum(-(-len(p) // 64) for p in prompts)
    runs = [
        phase_bias_logprobs(cfg, prepared, prompts, refs, dev, card),
        phase_prefix("G", cfg, prepared, dev, card,
                     [("cached_attention", "f32"),
                      ("paged_decode_attention", "f32")], kv="paged"),
        phase_prefix("G-dense", cfg, prepared, dev, card,
                     [("cached_attention", "f32"),
                      ("decode_attention", "f32")], kv="dense"),
        serve_run("H", cfg, prepared, prompts, len(refs[0][0]), refs,
                  [("cached_attention", "f32"),
                   ("paged_decode_attention", "f32")], dev, card,
                  exact=lambda steps: {
                      ("cached_attention", "f32"): L * chunks,
                      ("paged_decode_attention", "f32"): L * steps},
                  same_as=a_info, kv="paged", prefill_chunk_tokens=64,
                  overlap=True),
    ]
    if dev.type == "cuda":
        mixed_profile("serve", "H paged f32", cfg, prepared, prompts, dev,
                      kv="paged")
    return {name: {dt: sum(r[name][dt] for r in runs)
                   for dt in DTYPES}
            for name in CACHE_KERNELS}


# ----------------------------------------------------------------------
# ROADMAP item 4 e's first half: [handoff] (the prefill->decode row
# handoff between two daemons) and [kvtier] (block migration)

HANDOFF_NEW = 16
# (label, the decode replica's pool, max_len, reference, decode kernel);
# the prefill replica of a leg is a paged pool of the same KV type and
# max_len (the row's geometry), shared by the legs that agree on both
HANDOFF_LEGS = (
    ("HO-f32", {"kv": "paged"}, 512, "f32", "paged_decode_attention"),
    ("HO-dense", {"kv": "dense"}, 512, "f32", "decode_attention"),
    ("HO-bf16", {"kv": "paged", "kv_dtype": "bf16"}, 1024, "bf16",
     "paged_decode_attention"),
    ("HO-int8", {"kv": "paged", "kv_dtype": "int8"}, 1024, "int8",
     "paged_decode_attention"),
)


def daemon(start, cfg, prepared, dev, max_len=1024, **kv):
    """An LM daemon in this process at run A's size (4 slots, prompt_pad
    64, block_len 16), served by `start` (lm_server.start_lm_server_loop's:
    the phase's daemons share one event loop, as several loops in one
    process flood gRPC's poller): (address, client, servicer, stop)."""
    from dnn_tpu_torch.comm.client import NodeClient

    port = free_port()
    stop = start(cfg, prepared, port=port, slots=4, max_len=max_len,
                 prompt_pad=64, block_len=16, seed=0, device=dev, **kv)
    client = NodeClient(f"127.0.0.1:{port}")
    if not client.wait_healthy(deadline=60):
        fail("[handoff] an LM daemon never became healthy")
    return f"127.0.0.1:{port}", client, stop.servicer, stop


def counting_steps(batcher):
    """Wraps batcher.step to count the decode steps it takes; returns the
    one-element counter."""
    step, n = batcher.step, [0]

    def counted():
        n[0] += 1
        return step()

    batcher.step = counted
    return n


def require_launches(tag, dev, counts, want):
    """Exact launch counts {(kernel, dtype): n} on the card (a CPU call
    launches none)."""
    if dev.type != "cuda":
        return
    for (name, dt), n in want.items():
        if counts[name][dt] != n:
            fail(f"{tag}: {name} ({dt}) launched {counts[name][dt]} times, "
                 f"expected {n}")
    print(f"{tag}: launches exactly " + ", ".join(
        f"{name} {dt} {n}" for (name, dt), n in want.items()), flush=True)


def add_into(total, counts):
    for name in CACHE_KERNELS:
        for dt, n in counts[name].items():
            total[name][dt] += n


def follow_up(tag, client, batcher, prompt, chunks, L, dt, dev, total,
              bf16_q=False):
    """A generate of `prompt` on the paged daemon of `client` (`batcher`
    its batcher) that must run exactly `chunks` prompt chunks: K5 once a
    layer a chunk and K7 once a layer a decode step, exactly. Adds the
    launches into `total`; returns the tokens."""
    chunks0 = batcher.prefill_chunks_run
    steps = counting_steps(batcher)
    reset_counts()
    toks = client.generate(prompt, max_new_tokens=HANDOFF_NEW,
                           timeout=300).tolist()
    counts = read_counts(bf16_q=bf16_q)
    if batcher.prefill_chunks_run - chunks0 != chunks:
        fail(f"{tag}: {batcher.prefill_chunks_run - chunks0} prompt chunks "
             f"ran, expected {chunks}")
    require_launches(tag, dev, counts,
                     {("cached_attention", dt): L * chunks,
                      ("paged_decode_attention", dt): L * steps[0]})
    add_into(total, counts)
    return toks


def handoff_leg(start, label, cfg, prepared, prompts, refs, dev, card, pre,
                kv, max_len, decode_kernel, total):
    """One [handoff] leg: the four prompts exported by the prefill daemon
    `pre` (its K5 exactly, no decode kernel), staged on a decode daemon
    with `kv` by kvput:, and generated there concurrently with h= (no
    K5, the decode kernel once a layer a step, exactly); every stream
    against `refs` and equal to the decode daemon's own prefill of the
    same prompt; the decode graph captured once across the adoptions
    and an export on the decode daemon. Returns its walls."""
    _, pc, _, _ = pre
    _, dc, ds, stop = daemon(start, cfg, prepared, dev, max_len=max_len,
                             role="decode", **kv)
    b = ds.batcher
    L, dt = cfg.n_layer, kv.get("kv_dtype", "f32")
    try:
        dc.generate(prompts[0], max_new_tokens=2, timeout=300)  # warm-up
        reset_counts()
        t0 = time.perf_counter()
        payloads = [pc.prefill_kv(p, timeout=300) for p in prompts]
        export_s = time.perf_counter() - t0
        chunks = sum(-(-len(p) // 64) for p in prompts)
        require_launches(f"[handoff] {label} exports", dev, read_counts(),
                         {("cached_attention", dt): L * chunks,
                          ("paged_decode_attention", dt): 0,
                          ("decode_attention", dt): 0})
        add_into(total, read_counts())
        t0 = time.perf_counter()
        for i, payload in enumerate(payloads):
            if "staged" not in dc.put_kv(f"{label}-{i}", payload, timeout=300):
                fail(f"[handoff] {label}: kvput {i} not staged")
        kvput_s = time.perf_counter() - t0
        graph = b._graph_step
        caps0 = graph.captures if graph is not None else 0
        chunks0 = b.prefill_chunks_run
        steps = counting_steps(b)
        results, errors = {}, []

        def call(i):
            try:
                results[i] = dc.generate(prompts[i], max_new_tokens=HANDOFF_NEW,
                                         timeout=300,
                                         kv_handle=f"{label}-{i}").tolist()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")

        reset_counts()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or len(results) != len(prompts):
            fail(f"[handoff] {label}: adopted generates failed: "
                 f"{errors or 'timed out'}")
        counts = read_counts()
        if b.prefill_chunks_run != chunks0:
            fail(f"[handoff] {label}: the decode daemon ran "
                 f"{b.prefill_chunks_run - chunks0} prompt chunks for "
                 "adopted requests")
        require_launches(f"[handoff] {label} adopted decode", dev, counts,
                         {("cached_attention", dt): 0,
                          (decode_kernel, dt): L * steps[0]})
        add_into(total, counts)
        for i, p in enumerate(prompts):
            compare_tokens(f"[handoff] {label} request {i} (prompt {len(p)})",
                           results[i], *refs[i])
        # the decode daemon's own prefill of each prompt, and an export on
        # it: the same streams, the decode graph never captured again
        dc.prefill_kv(prompts[1], timeout=300)
        for i, p in enumerate(prompts):
            local = dc.generate(p, max_new_tokens=HANDOFF_NEW,
                                timeout=300).tolist()
            if local != results[i]:
                fail(f"[handoff] {label} request {i}: adopted {results[i]} "
                     f"!= the decode daemon's own prefill {local}")
        caps = (graph.captures if graph is not None else 0) - caps0
        if caps:
            fail(f"[handoff] {label}: the decode graph was captured {caps} "
                 "more times across the adoptions and an export")
        # TTFT: an adopted request (its row staged before) beside a local
        # one, each streamed on the idle daemon; the disaggregated wall
        # adds the export and the kvput
        t0 = time.perf_counter()
        payload = pc.prefill_kv(prompts[3], timeout=300)
        t1 = time.perf_counter()
        dc.put_kv(f"{label}-ttft", payload, timeout=300)
        t2 = time.perf_counter()
        stream = dc.generate_stream(prompts[3], max_new_tokens=2, timeout=300,
                                    kv_handle=f"{label}-ttft")
        next(stream)
        t3 = time.perf_counter()
        list(stream)
        stream = dc.generate_stream(prompts[3], max_new_tokens=2, timeout=300)
        t4 = time.perf_counter()
        next(stream)
        ttft_local = time.perf_counter() - t4
        list(stream)
    finally:
        dc.close()
        stop()
    walls = {"export_ms": (t1 - t0) * 1e3, "kvput_ms": (t2 - t1) * 1e3,
             "ttft_adopted_ms": (t3 - t2) * 1e3,
             "ttft_local_ms": ttft_local * 1e3,
             "disaggregated_ms": (t3 - t0) * 1e3,
             "bytes": int(payload.size)}
    print(f"[handoff] {label} ({', '.join(f'{k}={v}' for k, v in kv.items())}"
          f", max_len {max_len}): the four prompts exported in "
          f"{export_s * 1e3:.1f} ms, staged in {kvput_s * 1e3:.1f} ms, every "
          f"adopted stream equal to the reference and to the daemon's own "
          f"prefill, {steps[0]} decode steps, {caps} captures; 300-token "
          f"prompt: payload {payload.size} bytes, export (prefill call) "
          f"{walls['export_ms']:.1f} ms, kvput {walls['kvput_ms']:.1f} ms, "
          f"TTFT adopted {walls['ttft_adopted_ms']:.1f} ms against local "
          f"{walls['ttft_local_ms']:.1f} ms, disaggregated (export + kvput + "
          f"first token) {walls['disaggregated_ms']:.1f} ms; on {card}",
          flush=True)
    return walls


def phase_handoff(start, cfg, prepared, prompts, refs, dev, card):
    """[handoff] ROADMAP item 4 e's row handoff on the main path's gpt2:
    prefill daemons (role="prefill") and decode daemons (role="decode")
    in this process, each prompt through prefill -> kvput: -> gen:..:h=
    over the wire (handoff_leg), on HANDOFF_LEGS' decode pools; the
    library's pack/unpack walls; an f32 row at max_len 1024 (75.5 MB for
    gpt2, over the 64 MiB wire cap) refused with a gRPC error. Returns
    the launches."""
    import grpc

    from dnn_tpu_torch.comm.service import MAX_MESSAGE_BYTES
    from dnn_tpu_torch.control import handoff
    from dnn_tpu_torch.runtime.kvcache import cache_shape

    total = {name: {dt: 0 for dt in DTYPES}
             for name in CACHE_KERNELS}
    pres = {}
    try:
        for label, kv, max_len, ref, kernel in HANDOFF_LEGS:
            key = (kv.get("kv_dtype"), max_len)
            if key not in pres:
                pkv = {k: v for k, v in kv.items() if k == "kv_dtype"}
                pres[key] = daemon(start, cfg, prepared, dev,
                                   max_len=max_len, role="prefill",
                                   kv="paged", **pkv)
                pres[key][1].prefill_kv(prompts[0], timeout=300)  # warm-up
            handoff_leg(start, label, cfg, prepared, prompts, refs[ref], dev,
                        card, pres[key], kv, max_len, kernel, total)
        # the library's walls on the f32 leg's prefill daemon
        _, _, ps, _ = pres[(None, 512)]
        payload = ps.worker.call(
            lambda: ps.batcher.export_prefill(prompts[3])).result(timeout=300)
        t0 = time.perf_counter()
        wire = handoff.pack(payload)
        t1 = time.perf_counter()
        handoff.unpack(wire)
        t2 = time.perf_counter()
        print(f"[handoff] library: pack {(t1 - t0) * 1e3:.1f} ms, unpack "
              f"{(t2 - t1) * 1e3:.1f} ms of a {wire.size}-byte f32 row "
              f"(max_len 512); on {card}", flush=True)
    finally:
        for _, c, _, stop in pres.values():
            c.close()
            stop()
    # an f32 row at max_len 1024: refused when it exceeds the wire's cap
    row = 2 * math.prod(cache_shape(cfg, 1, 1024)) * 4
    _, pc, _, stop = daemon(start, cfg, prepared, dev, max_len=1024,
                            role="prefill", kv="paged")
    try:
        try:
            got = pc.prefill_kv(prompts[3], timeout=300)
            err = None
        except grpc.RpcError as e:
            got, err = None, e
    finally:
        pc.close()
        stop()
    if row > MAX_MESSAGE_BYTES:
        if err is None or err.code() != grpc.StatusCode.RESOURCE_EXHAUSTED:
            fail(f"[handoff] the {row}-byte f32 row at max_len 1024 was not "
                 f"refused: {err or got.size}")
        print(f"[handoff] f32 row at max_len 1024 ({row} bytes) refused: "
              f"{err.code()} {err.details()[:120]}", flush=True)
    elif err is not None:
        fail(f"[handoff] the {row}-byte f32 row at max_len 1024 failed: {err}")
    return total


def phase_kvtier(start, cfg, prepared, prompts, refs, dev, card):
    """[kvtier] ROADMAP item 4 e's block migration on the main path's gpt2:
    a donor and an adopter daemon at G's settings (paged f32, 4 slots,
    max_len 1024, prompt_pad 64, prefix_cache=256, blocks of 16).
    kvstage of the 300-token prompt puts 18 blocks on the donor (K5 once
    a layer a chunk, exactly); kvpull on the adopter adopts them over
    the shm rung (no kernel); the follow-up generate runs the tail chunk
    only (K5 once a layer, K7 once a layer a step, exactly), its stream
    against the reference and equal to the donor's; the donor's lease is
    released by the ack; the 130-token prompt the same over the grpc
    rung, forced (no kernel in the pull; the follow-up one tail chunk,
    its launches exact); a donor stopped between kvlease and the fetch:
    the pull answers kvtier_fallback with no kernel launched, the
    adopter's blocks in use, high water and resident blocks unchanged,
    its full prefill of the prompt (two chunks, launches exact) against
    the reference. Returns the launches."""
    from dnn_tpu_torch.kvtier import migrate

    L = cfg.n_layer
    total = {name: {dt: 0 for dt in DTYPES}
             for name in CACHE_KERNELS}
    kv = dict(kv="paged", prefix_cache=256)
    da, dc, ds, stop_d = daemon(start, cfg, prepared, dev, **kv)
    aa, ac, as_, stop_a = daemon(start, cfg, prepared, dev, **kv)
    b = as_.batcher
    try:
        for c in (dc, ac):
            c.generate(prompts[0], max_new_tokens=2, timeout=300)  # warm-up
        fresh = np.random.default_rng(99).integers(
            0, cfg.vocab_size, len(prompts[3])).tolist()
        stream = ac.generate_stream(fresh, max_new_tokens=2, timeout=300)
        t0 = time.perf_counter()
        next(stream)
        ttft_local = time.perf_counter() - t0
        list(stream)
        p = prompts[3]
        n_blocks = len(p) // 16
        reset_counts()
        t0 = time.perf_counter()
        status = dc.kv_stage(p, timeout=300)
        stage_s = time.perf_counter() - t0
        if f'"staged_blocks": {n_blocks}' not in status:
            fail(f"[kvtier] kvstage: {status}")
        require_launches("[kvtier] kvstage", dev, read_counts(),
                         {("cached_attention", "f32"):
                          L * -(-n_blocks * 16 // 64)})
        add_into(total, read_counts())
        t0 = time.perf_counter()
        meta = dc.kv_lease(p)
        t1 = time.perf_counter()
        data = dc.kv_fetch(meta["lease"])
        t2 = time.perf_counter()
        if "released" not in dc.kv_ack(meta["lease"]):
            fail("[kvtier] the lease was not released by its ack")
        if data.size != meta["bytes"] or meta["blocks"] != n_blocks:
            fail(f"[kvtier] lease meta {meta} against {data.size} bytes")
        reset_counts()
        t3 = time.perf_counter()
        status = ac.kv_pull_from(da, p, timeout=300)
        pull_s = time.perf_counter() - t3
        if not status.startswith(f"[lm] ok: kvpull adopted {n_blocks} blocks") \
                or not status.endswith("over shm"):
            fail(f"[kvtier] kvpull: {status}")
        if ds._kvtier_leases.n_leases:
            fail("[kvtier] the donor still holds a lease after the pull")
        require_launches("[kvtier] kvpull", dev, read_counts(),
                         {(name, "f32"): 0 for name in CACHE_KERNELS})
        chunks0 = b.prefill_chunks_run
        steps = counting_steps(b)
        reset_counts()
        stream = ac.generate_stream(p, max_new_tokens=HANDOFF_NEW,
                                    timeout=300)
        t4 = time.perf_counter()
        toks = [next(stream)]
        ttft_adopted = time.perf_counter() - t4
        toks += list(stream)
        counts = read_counts()
        if b.prefill_chunks_run - chunks0 != 1:
            fail(f"[kvtier] the follow-up ran {b.prefill_chunks_run - chunks0} "
                 "prompt chunks, expected the tail's one")
        require_launches("[kvtier] follow-up", dev, counts,
                         {("cached_attention", "f32"): L,
                          ("paged_decode_attention", "f32"): L * steps[0]})
        add_into(total, counts)
        compare_tokens(f"[kvtier] adopted prefix, prompt {len(p)}", toks,
                       *refs[3])
        donor_toks = dc.generate(p, max_new_tokens=HANDOFF_NEW,
                                 timeout=300).tolist()
        if donor_toks != toks:
            fail(f"[kvtier] the adopter's stream {toks} != the donor's "
                 f"{donor_toks}")
        print(f"[kvtier] 300-token prompt: kvstage {stage_s * 1e3:.1f} ms "
              f"({n_blocks} blocks), payload {meta['bytes']} bytes, kvlease "
              f"{(t1 - t0) * 1e3:.1f} ms + kvfetch {(t2 - t1) * 1e3:.1f} ms "
              f"(grpc), kvpull (lease, shm, adopt) {pull_s * 1e3:.1f} ms; "
              f"TTFT with the adopted prefix {ttft_adopted * 1e3:.1f} ms "
              f"(one tail chunk) against a local 300-token prefill "
              f"{ttft_local * 1e3:.1f} ms; the stream equals the donor's; "
              f"on {card}", flush=True)
        # the grpc rung, forced, on the 130-token prompt
        p2 = prompts[2]
        dc.kv_stage(p2, timeout=300)
        reset_counts()
        status = ac.kv_pull_from(da, p2, timeout=300, rung="grpc")
        if not status.startswith(f"[lm] ok: kvpull adopted {len(p2) // 16} "
                                 "blocks") or not status.endswith("over grpc"):
            fail(f"[kvtier] kvpull over grpc: {status}")
        require_launches("[kvtier] kvpull over grpc", dev, read_counts(),
                         {(name, "f32"): 0 for name in CACHE_KERNELS})
        toks2 = follow_up("[kvtier] grpc follow-up", ac, b, p2, 1, L, "f32",
                          dev, total)
        compare_tokens(f"[kvtier] adopted over grpc, prompt {len(p2)}", toks2,
                       *refs[2])
        # the donor dies between kvlease and the fetch
        xa, xc, _, stop_x = daemon(start, cfg, prepared, dev, **kv)
        p1 = prompts[1]
        xc.kv_stage(p1, timeout=300)
        xc.close()
        orig = migrate.pull_blocks

        class DiesAfterLease:
            def __init__(self, client):
                self.client = client

            def kv_lease(self, tokens, timeout=30.0):
                meta = self.client.kv_lease(tokens, timeout=timeout)
                stop_x()
                return meta

            def __getattr__(self, name):
                return getattr(self.client, name)

        migrate.pull_blocks = lambda client, tokens, **kw: orig(
            DiesAfterLease(client), tokens, **kw)
        alloc = b.allocator
        before = (alloc.n_used, alloc.high_water, b._prefix_store.n_blocks,
                  alloc.n_blocks)
        reset_counts()
        try:
            status = ac.kv_pull_from(xa, p1, timeout=300)
        finally:
            migrate.pull_blocks = orig
        after = (alloc.n_used, alloc.high_water, b._prefix_store.n_blocks,
                 alloc.n_blocks)
        if not status.startswith("[lm] kvtier_fallback"):
            fail(f"[kvtier] the pull from a dead donor answered {status}")
        if after != before:
            fail(f"[kvtier] the failed pull moved the adopter's blocks: "
                 f"{before} -> {after}")
        require_launches("[kvtier] the failed pull", dev, read_counts(),
                         {(name, "f32"): 0 for name in CACHE_KERNELS})
        toks1 = follow_up("[kvtier] follow-up after the donor's death", ac, b,
                          p1, -(-len(p1) // 64), L, "f32", dev, total)
        compare_tokens(f"[kvtier] after the donor's death, prompt {len(p1)}",
                       toks1, *refs[1])
        print(f"[kvtier] donor stopped between kvlease and the fetch: "
              f"{status.splitlines()[0][:100]}; the adopter's (blocks used, high water, "
              f"resident, pool) {after} unchanged; its own prefill matches "
              f"the reference; on {card}", flush=True)
    finally:
        for c, stop in ((dc, stop_d), (ac, stop_a)):
            c.close()
            stop()
    return total


def phase_llama_4e(cfg, prepared, prompts, refs, dev, card):
    """[handoff] and [kvtier] on llama3-8b in bf16 compute over L-B's paged
    bf16 pool (its row at max_len 1024 is 134 MB, over the wire's cap, so
    the row handoff goes through the library): LH, the four prompts
    exported by one batcher (K5 with a bf16 q once a layer a chunk,
    exactly), packed, unpacked and adopted by another (no K5, K7 once a
    layer a step, exactly; its decode graph captured once), every adopted
    stream equal to the adopter's own prefill of the prompt (launches
    exact); LK, a kvpull of the 300-token prompt's 18 blocks between two
    daemons and its follow-up (one tail chunk, launches exact), its
    stream equal to the donor's. Every stream also against L-B's
    references at BF16_TIE. Returns the runs' bf16-q launches."""
    from dnn_tpu_torch.control import handoff
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_loop
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    L, bf16 = cfg.n_layer, torch.bfloat16
    total = {name: {dt: 0 for dt in DTYPES}
             for name in CACHE_KERNELS}
    pool = dict(slots=4, max_len=1024, prompt_pad=64, block_len=16,
                kv="paged", compute_dtype=bf16, device=dev)
    src = ContinuousBatcher(cfg, prepared, **pool)
    dst = ContinuousBatcher(cfg, prepared, **pool)
    run_schedule(dst, prompts[:1], 2, dev)  # warm-up: kernels, the graph
    src.export_prefill(prompts[0])
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    payloads = [src.export_prefill(p) for p in prompts]
    sync(dev)
    export_s = time.perf_counter() - t0
    chunks = sum(-(-len(p) // 64) for p in prompts)
    counts = read_counts(bf16_q=True)
    require_launches("[handoff] LH exports", dev, counts,
                     {("cached_attention", "bf16"): L * chunks})
    add_into(total, counts)
    t0 = time.perf_counter()
    wires = [handoff.pack(pl) for pl in payloads]
    t1 = time.perf_counter()
    adopted = [handoff.unpack(w) for w in wires]
    t2 = time.perf_counter()
    graph = dst._graph_step
    caps0 = graph.captures if graph is not None else 0
    steps = counting_steps(dst)
    reset_counts()
    t3 = time.perf_counter()
    rids = [dst.submit(p, LLAMA_NEW, prefilled=pl)
            for p, pl in zip(prompts, adopted)]
    sync(dev)
    adopt_s = time.perf_counter() - t3
    res = dst.drain()
    counts = read_counts(bf16_q=True)
    require_launches("[handoff] LH adopted decode", dev, counts,
                     {("cached_attention", "bf16"): 0,
                      ("paged_decode_attention", "bf16"): L * steps[0]})
    add_into(total, counts)
    for i, p in enumerate(prompts):
        compare_tokens(f"[handoff] LH request {i} (prompt {len(p)})",
                       res[rids[i]].tolist(), *refs[i], tie=BF16_TIE)
    # dst's own prefill of the four prompts: the same streams, exactly
    chunks0 = dst.prefill_chunks_run
    steps_local = counting_steps(dst)
    reset_counts()
    lids = [dst.submit(p, LLAMA_NEW) for p in prompts]
    local = dst.drain()
    counts = read_counts(bf16_q=True)
    if dst.prefill_chunks_run - chunks0 != chunks:
        fail(f"[handoff] LH local prefill: {dst.prefill_chunks_run - chunks0} "
             f"prompt chunks ran, expected {chunks}")
    require_launches("[handoff] LH local prefill", dev, counts,
                     {("cached_attention", "bf16"): L * chunks,
                      ("paged_decode_attention", "bf16"):
                      L * steps_local[0]})
    add_into(total, counts)
    for i in range(len(prompts)):
        if res[rids[i]].tolist() != local[lids[i]].tolist():
            fail(f"[handoff] LH request {i}: adopted {res[rids[i]].tolist()} "
                 f"!= dst's own prefill {local[lids[i]].tolist()}")
    caps = (graph.captures if graph is not None else 0) - caps0
    if caps:
        fail(f"[handoff] LH: the decode graph was captured {caps} more times")
    print(f"[handoff] LH llama3-8b bf16 compute, paged bf16 pool: the four "
          f"prompts exported in {export_s * 1e3:.1f} ms, packed in "
          f"{(t1 - t0) * 1e3:.1f} ms and unpacked in {(t2 - t1) * 1e3:.1f} "
          f"ms ({sum(w.size for w in wires)} bytes; the 300-token prompt's "
          f"{wires[3].size}), admitted on the adopted rows in "
          f"{adopt_s * 1e3:.1f} ms, {steps[0]} decode steps, every adopted "
          f"stream equal to dst's own prefill, {caps} captures; on {card}",
          flush=True)
    del src, dst, payloads, wires, adopted
    gc.collect()
    kv = dict(kv="paged", prefix_cache=256, compute_dtype=bf16)
    start, close = start_lm_server_loop()
    da, dc, _, stop_d = daemon(start, cfg, prepared, dev, **kv)
    _, ac, as_, stop_a = daemon(start, cfg, prepared, dev, **kv)
    try:
        ac.generate(prompts[0], max_new_tokens=2, timeout=300)  # warm-up
        p = prompts[3]
        reset_counts()
        t0 = time.perf_counter()
        status = dc.kv_stage(p, timeout=300)
        t1 = time.perf_counter()
        if f'"staged_blocks": {len(p) // 16}' not in status:
            fail(f"[kvtier] LK kvstage: {status}")
        status = ac.kv_pull_from(da, p, timeout=300)
        t2 = time.perf_counter()
        if not status.startswith(f"[lm] ok: kvpull adopted {len(p) // 16} "
                                 "blocks"):
            fail(f"[kvtier] LK kvpull: {status}")
        counts = read_counts(bf16_q=True)
        require_launches("[kvtier] LK kvstage + kvpull", dev, counts,
                         {("cached_attention", "bf16"):
                          L * -(-(len(p) // 16 * 16) // 64),
                          ("paged_decode_attention", "bf16"): 0})
        add_into(total, counts)
        b = as_.batcher
        chunks0 = b.prefill_chunks_run
        steps = counting_steps(b)
        reset_counts()
        stream = ac.generate_stream(p, max_new_tokens=LLAMA_NEW, timeout=300)
        t3 = time.perf_counter()
        toks = [next(stream)]
        ttft = time.perf_counter() - t3
        toks += list(stream)
        counts = read_counts(bf16_q=True)
        if b.prefill_chunks_run - chunks0 != 1:
            fail(f"[kvtier] LK: the follow-up ran "
                 f"{b.prefill_chunks_run - chunks0} prompt chunks")
        require_launches("[kvtier] LK follow-up", dev, counts,
                         {("cached_attention", "bf16"): L,
                          ("paged_decode_attention", "bf16"): L * steps[0]})
        add_into(total, counts)
        compare_tokens(f"[kvtier] LK adopted prefix, prompt {len(p)}", toks,
                       *refs[3], tie=BF16_TIE)
        donor = dc.generate(p, max_new_tokens=LLAMA_NEW, timeout=300).tolist()
        if donor != toks:
            fail(f"[kvtier] LK: the adopter's stream {toks} != the donor's "
                 f"{donor}")
        print(f"[kvtier] LK llama3-8b bf16: kvstage {(t1 - t0) * 1e3:.1f} ms, "
              f"kvpull {(t2 - t1) * 1e3:.1f} ms ({status.split('(')[1]}, "
              f"TTFT with the adopted prefix {ttft * 1e3:.1f} ms; on {card}",
              flush=True)
    finally:
        for c, stop in ((dc, stop_d), (ac, stop_a)):
            c.close()
            stop()
        close()
    return total


def phase_item_4e(cfg, prepared, prompts, refs, dev, card):
    """[handoff] and [kvtier] on the main path's gpt2; each phase's wall
    printed. `refs` maps a KV type to the per-prompt references of its
    pool. Returns the launches of both."""
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_loop

    runs = []
    start, close = start_lm_server_loop()
    try:
        for tag, fn in (("handoff", phase_handoff),
                        ("kvtier", phase_kvtier)):
            t0 = time.perf_counter()
            runs.append(fn(start, cfg, prepared, prompts,
                           refs if tag == "handoff" else refs["f32"], dev,
                           card))
            print(f"[{tag}] phase wall {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        close()
    return {name: {dt: sum(r[name][dt] for r in runs)
                   for dt in DTYPES}
            for name in CACHE_KERNELS}


# [resilience]: ROADMAP item 4 e's second half on the main path's gpt2 —
# the LM daemon's resilience seams and the /metrics they report through
RES_WEDGE_PERIOD = 30.0   # (g)'s --watchdog_s: one real probe round of
# the card before the wedge window, the next one inside it
RES_WEDGE_AT_S = 40.0     # (g)'s wedge window opens this long after its
# plan is installed: after the child serves and its first probe round
RES_WEDGE_STREAM = 900   # (g): tokens a stream, so one is in flight
RES_STEP_FAULT_AT = 8     # (a)/(b): the pool step the fault fires at
# (all four requests are admitted by then; each needs 15 decode steps)
RES_METRICS = (           # the serving path's series (JAX's names), as
    # /metrics renders them
    "serving_queue_depth", "serving_ttft_seconds",
    "serving_queue_wait_seconds", "serving_requests_total",
    "serving_prefill_chunks_total", "serving_deadline_exceeded_total",
    "serving_pool_exhausted_total", "serving_prefix_evictions_total",
    "serving_kv_adoptions_total", "serving_kvtier_blocks_adopted_total",
    "serving_kvput_expired_total", "dnn_tpu_kvtier_migrated_blocks_total",
    "dnn_tpu_kvtier_migrated_bytes_total", "dnn_tpu_kvtier_fallback_total",
    "dnn_tpu_replica_role")


def http(url, method="GET", timeout=10.0):
    """(status, body) of one HTTP request; an HTTP error's status too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def res_daemon(start, cfg, prepared, dev, slots=4, max_len=1024, **kv):
    """A daemon at run A's settings (paged f32 unless `kv` says otherwise,
    prompt_pad 64, blocks of 16) with its observability endpoint, warmed
    up (its decode step captured): (address, client, servicer, stop,
    the endpoint's base URL)."""
    from dnn_tpu_torch.comm.client import NodeClient

    port = free_port()
    kv = {"kv": "paged", **kv}
    stop = start(cfg, prepared, port=port, slots=slots, max_len=max_len,
                 prompt_pad=64, block_len=16, seed=0, device=dev,
                 metrics_port=0, **kv)
    client = NodeClient(f"127.0.0.1:{port}")
    if not client.wait_healthy(deadline=60):
        fail("[resilience] an LM daemon never became healthy")
    client.generate([1, 2, 3], max_new_tokens=2, timeout=300)  # warm-up
    srv = stop.servicer
    return (f"127.0.0.1:{port}", client, srv, stop,
            f"http://127.0.0.1:{srv.metrics_server.port}")


def events_since(base, seq0):
    """The daemon's flight events (GET /debugz?format=json) after seq0."""
    code, body = http(base + "/debugz?format=json")
    if code != 200:
        fail(f"[resilience] /debugz answered {code}")
    return [e for e in json.loads(body) if e["seq"] > seq0]


def last_seq():
    from dnn_tpu_torch import obs

    ev = obs.flight.recorder().events(last=1)
    return ev[-1]["seq"] if ev else 0


def concurrent(fn, n):
    """fn(i) for i < n on n threads: ({i: result}, {i: exception})."""
    out, errs = {}, {}

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — the caller judges it
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out, errs


class Leg:
    """One leg's accounting: the launch counts zeroed, the decode steps,
    prompt chunks and captures of `batcher` counted from here; `check`
    requires K5 = layers x chunks and the decode kernel = layers x steps
    (plus `extra_decode` launches made outside the steps) exactly, no
    recapture, and adds the launches into `total`."""

    def __init__(self, tag, batcher, total, L):
        self.tag, self.b, self.total, self.L = tag, batcher, total, L
        self.steps = counting_steps(batcher)
        graph = batcher._graph_step
        self.caps0 = graph.captures if graph is not None else 0
        self.chunks0 = batcher.prefill_chunks_run
        self.seq0 = last_seq()
        reset_counts()

    def chunks(self):
        return self.b.prefill_chunks_run - self.chunks0

    def check(self, dev, extra_decode=0, dt="f32"):
        counts = read_counts()
        graph = self.b._graph_step
        caps = (graph.captures if graph is not None else 0) - self.caps0
        decode = ("paged_decode_attention" if self.b.paged
                  else "decode_attention")
        require_launches(f"[resilience] {self.tag}", dev, counts, {
            ("cached_attention", dt): self.L * self.chunks(),
            (decode, dt): self.L * (self.steps[0] + extra_decode)})
        if caps:
            fail(f"[resilience] {self.tag}: the decode step was captured "
                 f"{caps} more times")
        add_into(self.total, counts)
        return counts


def res_compare(tag, results, prompts, refs):
    for i, toks in sorted(results.items()):
        compare_tokens(f"[resilience] {tag} request {i} (prompt "
                       f"{len(prompts[i])})", list(toks), *refs[i])


def leg_requeue(start, cfg, prepared, prompts, refs, a_streams, dev, card,
                total):
    """(a) a step fault mid-decode: the worker dies, a successor requeues
    the four unary requests, each equal to the reference and to run A's
    stream; /debugz shows worker_died then worker_restart; K5 counts the
    requeued prompts' chunks twice; the successor's first replay equals
    its eager step bit for bit. (c) on the successor: a dedup key shared
    by two concurrent SendTensors (identical replies, one prompt's
    chunks), and a request whose propagated deadline (dl=) passes
    (DEADLINE_EXCEEDED, serving.deadline_exceeded_total). Returns the
    daemon's stop."""
    from dnn_tpu_torch import chaos
    from dnn_tpu_torch.comm import wirecodec as wc
    from dnn_tpu_torch.comm.service import SERVICE_NAME, _tensor_msg

    import grpc

    addr, client, srv, stop, base = res_daemon(start, cfg, prepared, dev)
    b, L = srv.batcher, cfg.n_layer
    first_worker = srv.worker
    graph = b._graph_step
    bit = {}
    if graph is not None:
        orig_run = graph.run

        def checked_run(kind, fn, key):
            # the successor's first replay against its eager step on the
            # same static buffers (the eager step rewrites the same K/V)
            replays0 = graph.counts.get(kind, [0, 0])[1]
            out = orig_run(kind, fn, key)
            if (not bit and kind == "decode"
                    and threading.current_thread() is not first_worker
                    and graph.counts[kind][1] > replays0):
                replayed = out.clone()
                eager = fn()
                torch.cuda.synchronize()
                bit["equal"] = torch.equal(replayed, eager)
                bit["diff"] = (replayed - eager).abs().max().item()
            return out

        graph.run = checked_run
    leg = Leg("(a) requeue", b, total, L)
    chaos.install({"seed": 0, "faults": [{"kind": "step_fault",
                                          "at_n": RES_STEP_FAULT_AT}]})
    t0 = time.perf_counter()
    try:
        results, errs = concurrent(lambda i: client.generate(
            prompts[i], max_new_tokens=16, timeout=300).tolist(), 4)
    finally:
        chaos.uninstall()
    wall = time.perf_counter() - t0
    if errs:
        fail(f"[resilience] (a): requests failed across the restart: {errs}")
    ev = events_since(base, leg.seq0)
    kinds = [e["kind"] for e in ev]
    if "worker_died" not in kinds or "worker_restart" not in kinds or \
            kinds.index("worker_died") > kinds.index("worker_restart"):
        fail(f"[resilience] (a): /debugz shows {kinds}, not worker_died "
             "then worker_restart")
    died = ev[kinds.index("worker_died")]
    restart = ev[kinds.index("worker_restart")]
    admits = [e for e in ev if e["kind"] == "admit"]
    again = [e for e in admits if e["seq"] > died["seq"]]
    want_chunks = sum(-(-e["prompt_len"] // 64) for e in admits)
    if restart["requeued"] != 4 or len(again) != 4 or \
            leg.chunks() != want_chunks:
        fail(f"[resilience] (a): {restart['requeued']} requeued, "
             f"{len(again)} admitted again, {leg.chunks()} chunks run "
             f"against {want_chunks} admitted")
    if graph is not None and not bit.get("equal"):
        fail(f"[resilience] (a): the successor's first replay differs from "
             f"its eager step by {bit.get('diff')}")
    leg.check(dev, extra_decode=1 if graph is not None else 0)
    res_compare("(a)", results, prompts, refs)
    if [results[i] for i in range(4)] != a_streams:
        fail("[resilience] (a): the requeued streams differ from run A's")
    print(f"[resilience] (a) requeue: step fault at pool step "
          f"{RES_STEP_FAULT_AT}, {restart['requeued']} requeued, "
          f"{len(admits)} admissions, {leg.chunks()} prompt chunks (each "
          f"prompt's chunks twice), {leg.steps[0]} decode "
          f"steps; restart wall (worker_died -> worker_restart) "
          f"{(restart['ts'] - died['ts']) * 1e3:.2f} ms, to the first "
          f"requeued admission {(again[0]['ts'] - died['ts']) * 1e3:.2f} "
          f"ms; the 4 requests' wall {wall:.3f} s; "
          + ("the successor's first replay equals its eager step bit for "
             "bit; " if graph is not None else "")
          + f"every stream equals run A's; on {card}", flush=True)
    if graph is not None:
        graph.run = orig_run
    # (c) dedup on the successor
    leg = Leg("(c) dedup", b, total, L)
    results, errs = concurrent(lambda i: client.generate(
        prompts[2], max_new_tokens=16, dedup="res-c", timeout=300).tolist(),
        2)
    ev = events_since(base, leg.seq0)
    kinds = [e["kind"] for e in ev]
    if errs or results[0] != results[1] or kinds.count("admit") != 1 \
            or kinds.count("dedup_join") != 1 or leg.chunks() != 3:
        fail(f"[resilience] (c): errors {errs}, replies equal "
             f"{results.get(0) == results.get(1)}, events {kinds}, "
             f"{leg.chunks()} chunks")
    leg.check(dev)
    compare_tokens("[resilience] (c) dedup", results[0], *refs[2])
    print(f"[resilience] (c) dedup: two concurrent SendTensors with d=res-c "
          f"got identical replies from one admission (3 prompt chunks, "
          f"{leg.steps[0]} decode steps), one dedup_join; on {card}",
          flush=True)
    # (c) a propagated deadline that passes mid-generation
    leg = Leg("(c) deadline", b, total, L)
    call = client._channel.unary_unary(
        f"/{SERVICE_NAME}/SendTensor", request_serializer=wc.serialize_request,
        response_deserializer=wc.parse_response)
    try:
        call(wc.TensorRequest(request_id="gen:1000:dl=0.2", tensor=_tensor_msg(
            np.asarray(prompts[0], np.int32))), timeout=60)
        fail("[resilience] (c): a request past its deadline was answered")
    except grpc.RpcError as e:
        if e.code() != grpc.StatusCode.DEADLINE_EXCEEDED:
            fail(f"[resilience] (c): the deadline answered {e.code()}")
    t_end = time.monotonic() + 60
    while (b.n_active or not srv.worker.q.empty()) and \
            time.monotonic() < t_end:
        time.sleep(0.01)  # the slot retires at the next step boundary
    ev = events_since(base, leg.seq0)
    misses = [e for e in ev if e["kind"] == "deadline_miss"]
    retired = [e["reason"] for e in ev if e["kind"] == "retire"]
    admitted = [e for e in ev if e["kind"] == "admit"]
    # admitted before its deadline passed, it retires cancelled; still
    # queued, it is dropped at admission
    if len(misses) != 1 or retired != ["cancelled"] * len(admitted):
        fail(f"[resilience] (c): events {[e['kind'] for e in ev]}")
    leg.check(dev)
    print(f"[resilience] (c) a dl=0.2 request: DEADLINE_EXCEEDED after "
          f"{leg.steps[0]} decode steps, "
          + ("its slot cancelled (deadline_miss, retire cancelled)"
             if admitted else "dropped before admission (deadline_miss)")
          + f"; on {card}", flush=True)
    client.close()
    return stop


def leg_budget(start, cfg, prepared, prompts, dev, card, total):
    """(b) worker_restarts=0: the step fault fails every caller fast with
    "worker died"; no requeue."""
    from dnn_tpu_torch import chaos

    import grpc

    addr, client, srv, stop, base = res_daemon(start, cfg, prepared, dev,
                                               worker_restarts=0)
    try:
        leg = Leg("(b) budget", srv.batcher, total, cfg.n_layer)
        chaos.install({"seed": 0, "faults": [{"kind": "step_fault",
                                              "at_n": RES_STEP_FAULT_AT}]})
        t0 = time.perf_counter()
        try:
            results, errs = concurrent(lambda i: client.generate(
                prompts[i], max_new_tokens=16, timeout=300), 4)
        finally:
            chaos.uninstall()
        wall = time.perf_counter() - t0
        bad = {i: e for i, e in errs.items()
               if not (isinstance(e, grpc.RpcError)
                       and e.code() == grpc.StatusCode.UNAVAILABLE
                       and "worker died" in e.details())}
        if results or bad or len(errs) != 4:
            fail(f"[resilience] (b): answers {results}, errors {errs}")
        ev = events_since(base, leg.seq0)
        died = [e for e in ev if e["kind"] == "worker_died"]
        if len(died) != 1 or died[0]["requeue"] or any(
                e["kind"].startswith("worker_restart") for e in ev):
            fail(f"[resilience] (b): events {[e['kind'] for e in ev]}")
        if leg.steps[0] != RES_STEP_FAULT_AT:
            fail(f"[resilience] (b): {leg.steps[0]} steps before the fault")
        leg.check(dev)
        print(f"[resilience] (b) worker_restarts=0: all 4 callers failed "
              f"fast with UNAVAILABLE \"{errs[0].details()[:60]}\" in "
              f"{wall:.3f} s after {leg.steps[0]} decode steps and "
              f"{leg.chunks()} prompt chunks; on {card}", flush=True)
    finally:
        client.close()
        stop()


def leg_exhaust(start, cfg, prepared, prompts, refs, dev, card, total):
    """(d) kv_exhaust at admission, over a pool the four prompts do not
    fit (30 blocks: 29 allocatable against their 38) with a radix store
    of 8 blocks: held_back events, a real exhaustion (pool_exhausted)
    and store evictions, every stream equal to the reference."""
    from dnn_tpu_torch import chaos

    addr, client, srv, stop, base = res_daemon(
        start, cfg, prepared, dev, paged_blocks=30, prefix_cache=8)
    try:
        leg = Leg("(d) kv_exhaust", srv.batcher, total, cfg.n_layer)
        chaos.install({"seed": 0, "faults": [{"kind": "kv_exhaust",
                                              "from_n": 1, "count": 2}]})
        try:
            results, errs = concurrent(lambda i: client.generate(
                prompts[i], max_new_tokens=16, timeout=300).tolist(), 4)
        finally:
            chaos.uninstall()
        if errs:
            fail(f"[resilience] (d): {errs}")
        ev = events_since(base, leg.seq0)
        kinds = [e["kind"] for e in ev]
        inj = [e for e in ev if e["kind"] == "chaos_inject"
               and e.get("fault") == "kv_exhaust"]
        if len(inj) != 2 or "held_back" not in kinds or \
                "pool_exhausted" not in kinds or leg.chunks() != 11:
            fail(f"[resilience] (d): events {kinds}, {leg.chunks()} chunks")
        leg.check(dev)
        res_compare("(d)", results, prompts, refs)
        print(f"[resilience] (d) kv_exhaust: {kinds.count('held_back')} "
              f"held_back, {kinds.count('pool_exhausted')} pool_exhausted, "
              f"{kinds.count('prefix_evict')} prefix_evict events; 11 "
              f"prompt chunks, {leg.steps[0]} decode steps; every stream "
              f"equals the reference; on {card}", flush=True)
    finally:
        client.close()
        stop()


def leg_drain(start, cfg, prepared, prompts, refs, dev, card, total):
    """(e) 2 slots, 4 requests, then POST /drainz: the 2 in flight finish
    equal to the reference, the 2 queued get UNAVAILABLE "draining";
    meanwhile /statusz says draining, /healthz answers 503 and a new
    request is refused at preflight."""
    import grpc

    addr, client, srv, stop, base = res_daemon(start, cfg, prepared, dev,
                                               slots=2)
    b = srv.batcher
    checked = threading.Event()

    def hold():
        # with both slots busy the loop waits here until the checks are
        # done: the two queued stay queued, the two admitted stay in
        # flight
        t_end = time.monotonic() + 60
        while b.n_active == 2 and not checked.is_set() \
                and time.monotonic() < t_end:
            time.sleep(0.002)

    try:
        leg = Leg("(e) drain", b, total, cfg.n_layer)
        srv.worker.heartbeat = hold
        box = {}

        def run_four():
            box["out"], box["errs"] = concurrent(lambda i: client.generate(
                prompts[i], max_new_tokens=16, timeout=300).tolist(), 4)

        runner = threading.Thread(target=run_four)
        runner.start()
        t_end = time.monotonic() + 60
        while not (b.n_active == 2 and srv.worker.q.qsize() >= 2) and \
                time.monotonic() < t_end:
            time.sleep(0.002)
        t0 = time.perf_counter()
        code, body = http(base + "/drainz", "POST")
        state = json.loads(http(base + "/statusz")[1])["state"]
        health = http(base + "/healthz")
        try:
            client.generate(prompts[0], max_new_tokens=2, timeout=60)
            refused = None
        except grpc.RpcError as e:
            refused = (e.code(), e.details())
        checked.set()
        runner.join(timeout=600)
        srv._drain_thread.join(timeout=120)
        drain_s = time.perf_counter() - t0
        out, errs = box["out"], box["errs"]
        if code != 202 or state != "draining" or health[0] != 503 or \
                refused is None or refused[0] != grpc.StatusCode.UNAVAILABLE \
                or not refused[1].startswith("draining"):
            fail(f"[resilience] (e): /drainz {code}, /statusz {state}, "
                 f"/healthz {health}, a new request {refused}")
        drained = {i: e for i, e in errs.items()
                   if isinstance(e, grpc.RpcError)
                   and e.code() == grpc.StatusCode.UNAVAILABLE
                   and "draining" in e.details()}
        if len(out) != 2 or len(drained) != 2:
            fail(f"[resilience] (e): answered {sorted(out)}, errors {errs}")
        leg.check(dev)
        res_compare("(e)", out, prompts, refs)
        print(f"[resilience] (e) drain over HTTP: requests {sorted(out)} "
              f"finished equal to the reference, {sorted(drained)} came "
              f"back UNAVAILABLE \"draining\"; /statusz draining, /healthz "
              f"{health[0]}, a new request refused at preflight; "
              f"{leg.chunks()} prompt chunks, {leg.steps[0]} decode steps; "
              f"/drainz -> drained {drain_s * 1e3:.1f} ms; on {card}",
              flush=True)
    finally:
        checked.set()
        client.close()
        stop()


def leg_migrate(start, cfg, prepared, prompts, refs, dev, card, total):
    """(i) a donor and an adopter at G's settings: a kvpull of the
    300-token prompt adopts its 18 blocks; then the kv_migrate seam
    severs a pull of the 130-token prompt: kvtier_fallback,
    dnn_tpu_kvtier_fallback_total up by 1, and the next generate of that
    prompt prefills it whole."""
    from dnn_tpu_torch import chaos, obs

    da, dc, ds, stop_d, _ = res_daemon(start, cfg, prepared, dev,
                                       prefix_cache=256)
    aa, ac, as_, stop_a, _ = res_daemon(start, cfg, prepared, dev,
                                        prefix_cache=256)
    L = cfg.n_layer
    try:
        reset_counts()
        status = dc.kv_stage(prompts[3], timeout=300)
        if '"staged_blocks": 18' not in status:
            fail(f"[resilience] (i) kvstage: {status}")
        require_launches("[resilience] (i) kvstage", dev, read_counts(),
                         {("cached_attention", "f32"): L * 5})
        add_into(total, read_counts())
        m = obs.metrics()
        snap = m.snapshot()["counters"]
        status = ac.kv_pull_from(da, prompts[3], timeout=300)
        if "adopted 18 blocks" not in status:
            fail(f"[resilience] (i) kvpull: {status}")
        after = m.snapshot()["counters"]
        moved = {k: after.get(k, 0) - snap.get(k, 0) for k in (
            "dnn_tpu_kvtier_migrated_blocks_total",
            "dnn_tpu_kvtier_migrated_bytes_total",
            "serving.kvtier_blocks_adopted_total")}
        if moved["dnn_tpu_kvtier_migrated_blocks_total"] != 18 or \
                moved["serving.kvtier_blocks_adopted_total"] != 18:
            fail(f"[resilience] (i): counters moved {moved}")
        leg = Leg("(i) kv_migrate", as_.batcher, total, L)
        chaos.install({"seed": 0, "faults": [{"kind": "kv_migrate_fault",
                                              "at_n": 0}]})
        try:
            status = ac.kv_pull_from(da, prompts[2], timeout=300)
        finally:
            chaos.uninstall()
        fb = (m.snapshot()["counters"]["dnn_tpu_kvtier_fallback_total"]
              - after.get("dnn_tpu_kvtier_fallback_total", 0))
        if "kvtier_fallback" not in status or fb != 1:
            fail(f"[resilience] (i): {status}; fallback counter +{fb}")
        toks = ac.generate(prompts[2], max_new_tokens=16,
                           timeout=300).tolist()
        if leg.chunks() != 3:
            fail(f"[resilience] (i): {leg.chunks()} chunks after the "
                 "fallback, expected the whole prompt's 3")
        leg.check(dev)
        compare_tokens("[resilience] (i) after the fallback", toks,
                       *refs[2])
        print(f"[resilience] (i) kv_migrate: a pull of 18 blocks moved "
              f"{int(moved['dnn_tpu_kvtier_migrated_bytes_total'])} bytes; the "
              f"severed pull answered \"{status[:60]}...\", "
              f"dnn_tpu_kvtier_fallback_total +1, the next generate "
              f"prefilled 3 chunks; on {card}", flush=True)
    finally:
        for c in (dc, ac):
            c.close()
        stop_a()
        stop_d()


def leg_scrape(start, cfg, prepared, prompts, refs, dev, card, total):
    """(j) a daemon at max_len 512 (an f32 row fits the wire): its own
    prefill exported and staged twice under a TTL of 0.5 s (the second
    kvput sweeps the first: kvput_expired), the second adopted by a
    generate (kv_adoptions; no K5); then GET /metrics holds every series
    of RES_METRICS, by JAX's names, and the memory gauges of the card."""
    addr, client, srv, stop, base = res_daemon(
        start, cfg, prepared, dev, max_len=512, kv_handoff_ttl_s=0.5)
    L = cfg.n_layer
    try:
        leg = Leg("(j) handoff", srv.batcher, total, L)
        payload = client.prefill_kv(prompts[1], timeout=300)
        client.put_kv("res-j1", payload)
        time.sleep(0.6)
        client.put_kv("res-j2", payload)
        toks = client.generate(prompts[1], max_new_tokens=16,
                               kv_handle="res-j2", timeout=300).tolist()
        ev = events_since(base, leg.seq0)
        if [e["key"] for e in ev if e["kind"] == "kvput_expired"] != \
                ["res-j1"]:
            fail(f"[resilience] (j): events {[e['kind'] for e in ev]}")
        leg.check(dev)
        compare_tokens("[resilience] (j) adopted", toks, *refs[1])
        code, text = http(base + "/metrics")
        names = {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                 if ln and not ln.startswith("#")}
        missing = [n for n in RES_METRICS if n not in names]
        dev_idx = torch.cuda.current_device() if dev.type == "cuda" else 0
        mem = [ln for ln in text.splitlines() if ln.startswith(
            f'dnn_tpu_device_bytes_in_use{{device="cuda:{dev_idx}"}}')]
        if code != 200 or missing or (dev.type == "cuda" and (
                not mem or float(mem[0].split()[-1]) <= 0)):
            fail(f"[resilience] (j): /metrics {code}, missing {missing}, "
                 f"device memory lines {mem}")
        print(f"[resilience] (j) /metrics: {len(text.splitlines())} lines, "
              f"every series of RES_METRICS present, "
              f"{mem[0] if mem else 'no device gauges (CPU)'}; the "
              f"expired handoff res-j1 swept, res-j2 adopted; on {card}",
              flush=True)
    finally:
        client.close()
        stop()


def obs_step_walls(cfg, prepared, prompts, dev, card, steps=16):
    """A replayed decode step's launches, captures and wall with
    DNN_TPU_OBS on and off (3 active slots, A's pool): the launches and
    captures must be identical (every counter is host arithmetic)."""
    from dnn_tpu_torch import obs
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, block_len=16, device=dev,
                          kv="paged")
    for p in prompts[:3]:
        b.submit(p, 200)
    for _ in range(4):
        b.step()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    graph = b._graph_step
    res = {}
    try:
        for mode in (True, False, True, False):
            obs.set_enabled(mode)
            reset_counts()
            caps0 = graph.captures if graph is not None else 0
            t0 = time.perf_counter()
            for _ in range(steps):
                b.step()
            sync()
            wall = (time.perf_counter() - t0) * 1e3 / steps
            caps = (graph.captures if graph is not None else 0) - caps0
            key = "on" if mode else "off"
            res.setdefault(key, []).append((wall, read_counts(), caps))
    finally:
        obs.set_enabled(True)
    for a in res["on"] + res["off"]:
        if a[1:] != res["on"][0][1:]:
            fail(f"[resilience] obs on/off: launches or captures differ: "
                 f"{res}")
    print(f"[resilience] obs on/off: a replayed decode step (3 active "
          f"slots) {', '.join(f'{w:.3f}' for w, _, _ in res['on'])} ms "
          f"with DNN_TPU_OBS on, "
          f"{', '.join(f'{w:.3f}' for w, _, _ in res['off'])} ms off; "
          f"{steps} steps a turn, the same launches "
          f"({res['on'][0][1]['paged_decode_attention']['f32']} K7) and "
          f"{res['on'][0][2]} captures each; on {card}", flush=True)


def node_child(cfg_name, dev, *extra, **config):
    """`node --serve_lm` as a process at run A's settings (the config's
    seed-0 weights, the main path's) with its endpoint: (process,
    address, metrics base URL, the moment it started). `config` adds
    keys to the topology config (e.g. "dtype")."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    port, mport = free_port(), free_port()
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "lm.json")
    with open(path, "w") as f:
        json.dump({"model": cfg_name, "device_type": dev.type, "nodes": [
            {"id": "node1", "part_index": 0,
             "address": f"127.0.0.1:{port}"}], **config}, f)
    # its log goes to a file: a pipe nobody drains could block the child
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", path, "--serve_lm", "--slots", "4", "--max_len",
         "1024", "--prompt_pad", "64", "--metrics_port", str(mport),
         *extra], cwd=here, env={**os.environ, "PYTHONPATH": here},
        stdout=subprocess.DEVNULL,
        stderr=open(os.path.join(tmp, "stderr.log"), "w"))
    proc.log = os.path.join(tmp, "stderr.log")
    return proc, f"127.0.0.1:{port}", f"http://127.0.0.1:{mport}", \
        time.monotonic()


def child_log(proc) -> str:
    with open(proc.log) as f:
        return f.read()[-3000:]


def child_launches(base):
    """The child daemon's cache-kernel launches from its /metrics."""
    out = {}
    for ln in http(base + "/metrics")[1].splitlines():
        if ln.startswith("dnn_tpu_kernel_launches{"):
            labels = dict(re.findall(r'(\w+)="([^"]*)"', ln))
            out[(labels["kernel"], labels["kv_dtype"])] = float(ln.split()[-1])
    return out


def child_ready(tag, proc, addr, base, prompt, L, dev, card):
    """Wait for the child, warm it up, and hold its launches on one
    300-token request to the call pattern (K5 12 x 5, K7 12 x 15)."""
    from dnn_tpu_torch.comm.client import NodeClient

    client = NodeClient(addr)
    t_end = time.monotonic() + 300
    while not client.health_check(timeout=1.0):
        if proc.poll() is not None or time.monotonic() > t_end:
            fail(f"[resilience] {tag}: the child never became healthy "
                 f"(rc {proc.poll()}):\n{child_log(proc)}")
        time.sleep(0.2)
    client.generate(prompt[:5], max_new_tokens=2, timeout=300)  # warm-up
    c0 = child_launches(base)
    client.generate(prompt, max_new_tokens=16, timeout=300)
    c1 = child_launches(base)
    if dev.type == "cuda":
        want = {("cached_attention", "f32"): L * -(-len(prompt) // 64),
                ("paged_decode_attention", "f32"): L * 15}
        got = {k: c1.get(k, 0) - c0.get(k, 0) for k in want}
        if got != want:
            fail(f"[resilience] {tag}: the child's launches on one request "
                 f"{got}, expected {want}")
        print(f"[resilience] {tag}: the child's launches on one "
              f"{len(prompt)}-token request exactly {want} (its /metrics); "
              f"on {card}", flush=True)
    return client


def leg_sigterm(proc, addr, base, t_spawn, prompts, refs, L, dev, card):
    """(f) SIGTERM to a `node --serve_lm` process during a GenerateStream:
    the stream completes equal to the reference, the exit code is 0."""
    client = child_ready("(f) SIGTERM", proc, addr, base, prompts[3], L, dev,
                         card)
    ready_s = time.monotonic() - t_spawn
    stream = client.generate_stream(prompts[3], max_new_tokens=16,
                                    timeout=300)
    got = [next(stream)]
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    got += list(stream)
    client.close()
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail("[resilience] (f): the daemon did not exit within 120 s of "
             "SIGTERM")
    exit_s = time.monotonic() - t0
    if rc != 0:
        fail(f"[resilience] (f): exit code {rc}:\n{child_log(proc)}")
    compare_tokens("[resilience] (f) the stream across SIGTERM", got,
                   *refs[3])
    print(f"[resilience] (f) SIGTERM during a GenerateStream: the stream "
          f"completed equal to the reference, exit code 0, SIGTERM -> exit "
          f"{exit_s:.2f} s (the child served {ready_s:.1f} s after launch); "
          f"on {card}", flush=True)


def leg_wedge(proc, addr, base, t_spawn, prompts, L, dev, card):
    """(g) a child with --watchdog_s, --on_wedged restart and a
    wedge_device plan: /statusz reads ok while it serves, then wedged
    once the window opens, and the exit code is 43. Streams keep an RPC
    in flight at the escalation, so the server's stop grace holds
    /statusz up long enough to read it."""
    client = child_ready("(g) wedge", proc, addr, base, prompts[3], L, dev,
                         card)
    ready_s = time.monotonic() - t_spawn
    if ready_s > RES_WEDGE_AT_S:
        fail(f"[resilience] (g): the child served {ready_s:.1f} s after "
             f"launch, past its wedge window at {RES_WEDGE_AT_S} s after "
             "its plan's install: raise RES_WEDGE_AT_S")
    # the first probe round (a real probe of the card) must answer ok
    # before the window opens
    t_end = time.monotonic() + 60
    first = {}
    while proc.poll() is None:
        try:
            first = json.loads(http(base + "/statusz")[1])
        except Exception:  # noqa: BLE001 — judged below
            pass
        if "device" in first.get("components", {}) or \
                time.monotonic() > t_end:
            break
        time.sleep(0.1)
    if first.get("state") != "ok" or \
            first["components"].get("device", {}).get("state") != "ok":
        fail(f"[resilience] (g): /statusz {first} before the window (rc "
             f"{proc.poll()}):\n{child_log(proc)}")
    probed_s = time.monotonic() - t_spawn
    seen = []
    done = threading.Event()

    details = []

    def poll():
        while not done.is_set():
            try:
                st = json.loads(http(base + "/statusz", timeout=2)[1])
                seen.append(st["state"])
                if st["state"] == "wedged":
                    details.append(st["components"]["device"]["detail"])
            except Exception:  # noqa: BLE001 — the child may be gone
                pass
            time.sleep(0.02)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    t_end = t_spawn + RES_WEDGE_AT_S + RES_WEDGE_PERIOD + 60
    while proc.poll() is None and time.monotonic() < t_end:
        try:  # long streams: an RPC in flight when the policy fires
            list(client.generate_stream(prompts[0],
                                        max_new_tokens=RES_WEDGE_STREAM,
                                        timeout=60))
        except Exception:  # noqa: BLE001 — cut by the exit
            time.sleep(0.05)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail("[resilience] (g): the wedged daemon did not exit")
    done.set()
    poller.join(timeout=5)
    client.close()
    # the wedge must be the plan's, not a probe that timed out
    injected = f"chaos: injected device wedge (plan@{RES_WEDGE_AT_S:g}s)"
    if rc != 43 or "wedged" not in seen or details[:1] != [injected]:
        fail(f"[resilience] (g): exit code {rc}, /statusz states seen "
             f"{sorted(set(seen))}, the device's detail "
             f"{sorted(set(details))}:\n{child_log(proc)}")
    print(f"[resilience] (g) --watchdog_s {RES_WEDGE_PERIOD:g}, "
          f"wedge_device at {RES_WEDGE_AT_S:g} s: /statusz ok while "
          f"serving ({ready_s:.1f} s after launch; the first probe round "
          f"ok by {probed_s:.1f} s), then wedged "
          f"(\"{injected}\"); exit code 43 (EXIT_RESTART) "
          f"{time.monotonic() - t_spawn:.1f} s after launch; on {card}",
          flush=True)


def phase_resilience(cfg, prepared, prompts, refs, a_streams, dev, card,
                     model="gpt2"):
    """[resilience] ROADMAP item 4 e's second half on the main path's gpt2
    at run A's settings, every leg with exact K5/K7 launches, no
    recapture, and every stream against A's reference: (a) requeue after
    a step fault, (b) a spent restart budget, (c) dedup and a passed
    deadline, (d) kv_exhaust over a short pool, (e) a drain over HTTP,
    (f) SIGTERM to a `node --serve_lm` process, (g) a wedged child's exit
    43, (h) the real device probe, (i) kv_migrate's fallback, (j) the
    /metrics scrape; and a step's launches and walls with DNN_TPU_OBS on
    and off. The two children start first and warm up while the
    in-process legs run. Returns the launches."""
    from dnn_tpu_torch.obs.watchdog import subprocess_device_probe
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_loop

    t_phase = time.perf_counter()
    L = cfg.n_layer
    total = {name: {dt: 0 for dt in DTYPES}
             for name in CACHE_KERNELS}
    t0 = time.perf_counter()
    ok, detail, timed_out = subprocess_device_probe(
        60.0, "cuda" if dev.type == "cuda" else "cpu")
    probe_s = time.perf_counter() - t0
    if not ok:
        fail(f"[resilience] (h): the device probe answered {detail} "
             f"(timed out: {timed_out})")
    print(f"[resilience] (h) the watchdog's probe (a child: import torch, "
          f"then a 64x64 matmul on {dev.type} and a synchronize under the "
          f"deadline) answered ok in {probe_s:.2f} s; on {card}",
          flush=True)
    obs_step_walls(cfg, prepared, prompts, dev, card)
    plan = json.dumps({"seed": 0, "faults": [
        {"kind": "wedge_device", "at_s": RES_WEDGE_AT_S}]})
    # the SIGTERM child starts now and warms up while the in-process legs
    # run; the wedge child after its leg
    f_child = node_child(model, dev)
    g_child = None
    try:
        start, close = start_lm_server_loop()
        try:
            stop = leg_requeue(start, cfg, prepared, prompts, refs,
                               a_streams, dev, card, total)
            stop()
            leg_budget(start, cfg, prepared, prompts, dev, card, total)
            leg_exhaust(start, cfg, prepared, prompts, refs, dev, card,
                        total)
            leg_drain(start, cfg, prepared, prompts, refs, dev, card, total)
            leg_migrate(start, cfg, prepared, prompts, refs, dev, card,
                        total)
            leg_scrape(start, cfg, prepared, prompts, refs, dev, card, total)
        finally:
            close()
        print(f"[resilience] in-process legs done "
              f"{time.monotonic() - f_child[3]:.1f} s after the SIGTERM "
              "child's launch", flush=True)
        leg_sigterm(*f_child, prompts, refs, L, dev, card)
        g_child = node_child(model, dev, "--watchdog_s",
                             f"{RES_WEDGE_PERIOD:g}", "--on_wedged",
                             "restart", "--chaos", plan)
        leg_wedge(*g_child, prompts, L, dev, card)
    finally:
        for child in (f_child, g_child):
            if child is not None and child[0].poll() is None:
                child[0].kill()
                child[0].wait()
    print(f"[resilience] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


# [constrain]: the main path's gpt2 over A's daemon with grammars live
J_NEW = 24                # a j=1 request's budget
J_CHOICES = ("positive", "negative", "neutral")
J_CHOICE_NEW = 16
J_CHOICE_PROMPTS = (0, 2)  # the main prompts the two choice requests take
J_PLAIN = (1, 3)           # the main prompts that ride unconstrained


def reference_constrained(prepared, cfg, prompt, n_new, c, dev):
    """Independent greedy loop under a TokenConstraint `c`: the plain
    no-cache forward over the whole sequence, the logits masked at -1e30
    to the grammar's allowed tokens at the DFA state the host walks
    (c.allowed, c.advance), the argmax; it ends where nothing can extend
    a complete match (finish reason "constraint": the daemon has no eos)
    or after n_new tokens ("length"). Returns (tokens, the top-2 gap among
    the allowed tokens at each step (inf where one is allowed), reason)."""
    from dnn_tpu_torch.runtime.generate import forward_no_cache

    ids = torch.tensor(prompt, dtype=torch.int64, device=dev)[None]
    state, toks, gaps = c.start, [], []
    for _ in range(n_new):
        allowed = torch.from_numpy(c.allowed[state]).to(dev)
        logits = torch.where(allowed, forward_no_cache(prepared, ids,
                                                       cfg=cfg)[0, -1],
                             torch.tensor(-1e30, device=dev))
        top2 = torch.topk(logits, 2).values
        gaps.append(math.inf if top2[1].item() < -1e29
                    else (top2[0] - top2[1]).item())
        nxt = int(logits.argmax())
        toks.append(nxt)
        state = c.advance(state, nxt)
        if not c.has_continuation(state):
            return toks, gaps, "constraint"
        ids = torch.cat([ids, torch.tensor([[nxt]], device=dev)], dim=1)
    return toks, gaps, "length"


def constrain_run(label, cfg, prepared, prompts, refs, a_info, dev, card,
                  same_as=None, **kv):
    """One [constrain] run: the LM daemon at run A's pool (paged f32, 4
    slots, max_len 1024, prompt_pad 64) with ByteTokenizer's byte map and
    the daemon's default constraint pools (3600 rows), eight concurrent
    requests: four in JSON mode over gRPC (j=1, the main prompts,
    J_NEW tokens), two under choice_regex(J_CHOICES) through the daemon's
    worker, and two unconstrained over gRPC (prompts J_PLAIN, 16
    tokens). Every constrained stream against `refs` (near-tie rule),
    its finish reason the reference's, every completed one matching its
    grammar (constrain.match); the unconstrained streams equal run A's;
    launches exactly K5 = layers x prompt chunks and K7 = layers x steps;
    `same_as`, another run's info, makes every stream equal that run's.
    Returns (launch counts, info)."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.io.tokenizer import ByteTokenizer
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime import constrain
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    L = cfg.n_layer
    tok = ByteTokenizer(cfg.vocab_size)
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, kv="paged", tokenizer=tok,
        allow_constraints=True, **kv)
    srv, batcher = stop.servicer, stop.servicer.batcher
    step, n_steps, reasons = batcher.step, [0], []
    claim = batcher.claim

    def counted_step():
        n_steps[0] += 1
        return step()

    def recorded_claim(rid):  # the worker claims every finished request
        out = claim(rid)
        reasons.append((None if out[0] is None else out[0].tolist(), out[1]))
        return out

    batcher.step, batcher.claim = counted_step, recorded_claim
    json1 = srv.json_constraint(1)
    choice = constrain.TokenConstraint.from_regex(
        constrain.choice_regex(J_CHOICES), tok.vocab_bytes(cfg.vocab_size))
    jobs = ([("json", i, J_NEW, json1) for i in range(4)]
            + [("choice", i, J_CHOICE_NEW, choice) for i in J_CHOICE_PROMPTS]
            + [("plain", i, 16, None) for i in J_PLAIN])
    results, errors = {}, []
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail(f"[constrain] {label}: LM daemon never became healthy")
        # warm-up: the kernels, the graphs, the JSON grammar's rows
        client.send_tensor(np.asarray(prompts[0][:8], np.int32),
                           request_id="gen:2:j=1", timeout=300)
        sync(dev)
        reset_counts()
        n_steps[0], chunks0 = 0, batcher.prefill_chunks_run
        reasons.clear()

        def call(j, kind, i, n, c):
            try:
                if kind == "json":
                    out = client.send_tensor(
                        np.asarray(prompts[i], np.int32),
                        request_id=f"gen:{n}:j=1", timeout=300)[1]
                elif kind == "choice":
                    out = srv.worker.submit(np.asarray(prompts[i]), n, None,
                                            opts={"constraint": c}
                                            ).result(timeout=300)
                else:
                    out = client.generate(prompts[i], max_new_tokens=n,
                                          timeout=300)
                results[j] = np.asarray(out).reshape(-1).tolist()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{kind} request {i}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(j, *job))
                   for j, job in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = read_counts()
        steps, chunks = n_steps[0], batcher.prefill_chunks_run - chunks0
        client.close()
    finally:
        stop()
    if errors or len(results) != len(jobs):
        fail(f"[constrain] {label}: requests failed: {errors or 'timed out'}")
    pool_bytes = batcher._ctable.numel() + 4 * batcher._ctrans.numel()
    for j, (kind, i, n, c) in enumerate(jobs):
        name = f"[constrain] {label} {kind} request (prompt {len(prompts[i])})"
        got = results[j]
        if kind == "plain":
            want = a_info["streams"][i]
            if got != want:
                fail(f"{name}: {got} differs from run A's {want}")
            continue
        want, gaps, reason = refs[j]
        compare_tokens(name, got, want, gaps)
        served_reason = next((r for t, r in reasons if t == got), None)
        if got == want and served_reason != reason:
            fail(f"{name}: finish reason {served_reason}, the reference's "
                 f"{reason}")
        if served_reason == "constraint" and not constrain.match(
                c.dfa, bytes(got)):
            fail(f"{name}: {bytes(got)!r} does not match its grammar")
        if kind == "choice" and bytes(got).decode() not in J_CHOICES:
            fail(f"{name}: {bytes(got)!r} is not one of {J_CHOICES}")
    done = sum(r == "constraint" for _, r in reasons)
    print(f"[constrain] run {label}: {len(jobs)} concurrent requests (4 j=1 "
          f"over gRPC, 2 choice, 2 unconstrained) in {wall:.3f} s, "
          f"{steps} decode steps, {chunks} prompt chunks; {done} finished by "
          f"their grammar, every completed output matches it; JSON outputs "
          + ", ".join(repr(bytes(results[j]).decode(errors="replace"))
                      for j in range(4))
          + f"; choices " + ", ".join(bytes(results[j]).decode()
                                      for j in (4, 5))
          + f"; the unconstrained streams equal run A's; constraint pools "
          f"{batcher._ctab_rows} rows x {cfg.vocab_size}: "
          f"{pool_bytes / 1e9:.3f} GB on the device ({batcher._ctab_rows} "
          f"rows at llama3-8b's vocab 128256 would be "
          f"{batcher._ctab_rows * 128256 * 5 / 1e9:.3f} GB); on {card}",
          flush=True)
    if dev.type == "cuda":
        want_counts = {("cached_attention", "f32"): L * chunks,
                       ("paged_decode_attention", "f32"): L * steps}
        for (kname, dt), n in want_counts.items():
            if counts[kname][dt] != n:
                fail(f"[constrain] {label}: {kname} ({dt}) launched "
                     f"{counts[kname][dt]} times, expected {n}")
        print(f"[constrain] run {label}: launches equal the call pattern's: "
              f"cached_attention f32 {L * chunks}, paged_decode_attention "
              f"f32 {L * steps}", flush=True)
    if same_as is not None and [results[j] for j in range(len(jobs))] \
            != same_as["streams"]:
        fail(f"[constrain] {label}: streams differ from run "
             f"{same_as['label']}'s")
    if same_as is not None:
        print(f"[constrain] run {label}: every stream equals run "
              f"{same_as['label']}'s token for token", flush=True)
    return counts, {"label": label,
                    "streams": [results[j] for j in range(len(jobs))]}


def constrained_replay(cfg, prepared, prompts, json1, dev, card):
    """One constrained decode step replayed against the same step taken
    eagerly: a batcher at run A's pool with JSON mode live in every slot,
    two steps (the graph captured), then from one saved state the
    replayed graph and the eager forward, each followed by the step's
    masked sampling and the device DFA walk: the logits, the tokens and
    every slot's DFA row bit for bit. Before it, as information, the
    wall of a decode step with JSON mode in every slot and of one
    without constraints (10 steps each, 4 slots)."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, block_len=16, device=dev,
                          kv="paged", allow_constraints=True,
                          constraint_rows=json1.table.shape[0] + 1)
    plain = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                              prompt_pad=64, block_len=16, device=dev,
                              kv="paged")
    walls = {}
    for name, srv, opts in (("unconstrained", plain, {}),
                            ("constrained", b, {"constraint": json1})):
        for p in prompts:
            srv.submit(p, 200, **opts)
        srv.step()
        srv.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            srv.step()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e2
    print(f"[constrain] a decode step of 4 slots at run A's pool (captured "
          f"forward; sampling eager): {walls['constrained']:.3f} ms wall "
          f"with JSON mode in every slot, {walls['unconstrained']:.3f} ms "
          f"without; on {card}", flush=True)
    g = b._graph_step
    if g is None or g._graph is None:
        fail("[constrain] the decode step was not captured")
    state = [b._tok_d, b._pos_d, b._crow_d, b._seen]
    saved = [t.clone() for t in state]
    outs = []
    for mode in ("replayed", "eager"):
        for t, s0 in zip(state, saved):
            t.copy_(s0)
        logits = (g(b._decode, b.cache, b._tok_d, b._pos_d, b._active_d)
                  if mode == "replayed" else
                  b._decode(b.cache, b._tok_d, b._pos_d, b._active_d))
        logits = logits.clone()
        nxt, _ = b._sample_step(logits)
        outs.append((logits, nxt.clone(), b._crow_d.clone()))
    torch.cuda.synchronize()
    for what, r, e in zip(("logits", "tokens", "DFA rows"), *outs):
        if not torch.equal(r, e):
            fail(f"[constrain] a replayed constrained step's {what} differ "
                 f"from the eager step's")
    print(f"[constrain] one replayed constrained step (JSON mode in 4 slots, "
          f"{json1.table.shape[0]} DFA states) equals the eager step bit for "
          f"bit: logits, masked tokens {outs[0][1].tolist()}, DFA rows "
          f"{outs[0][2].tolist()}; on {card}", flush=True)


def phase_constrain(cfg, prepared, prompts, a_info, dev, card):
    """[constrain] ROADMAP item 4 d's constraints on the main path's gpt2:
    J (constrain_run on A's daemon), J-ilv (the same on H's daemon:
    prefill_chunk_tokens=64, overlap; every stream equal to J's), and on
    the card constrained_replay. Returns the launches."""
    from dnn_tpu_torch.io.tokenizer import ByteTokenizer
    from dnn_tpu_torch.runtime import constrain

    vb = ByteTokenizer(cfg.vocab_size).vocab_bytes(cfg.vocab_size)
    json1 = constrain.TokenConstraint.from_regex(constrain.json_regex(1), vb)
    choice = constrain.TokenConstraint.from_regex(
        constrain.choice_regex(J_CHOICES), vb)
    t0 = time.perf_counter()
    refs = ([reference_constrained(prepared, cfg, prompts[i], J_NEW, json1,
                                   dev) for i in range(4)]
            + [reference_constrained(prepared, cfg, prompts[i], J_CHOICE_NEW,
                                     choice, dev) for i in J_CHOICE_PROMPTS])
    print(f"[constrain] references (the masked no-cache loop) in "
          f"{time.perf_counter() - t0:.1f} s; JSON mode depth 1: "
          f"{json1.table.shape[0]} DFA states", flush=True)
    j_counts, j_info = constrain_run("J", cfg, prepared, prompts, refs,
                                     a_info, dev, card)
    ilv_counts, _ = constrain_run("J-ilv", cfg, prepared, prompts, refs,
                                  a_info, dev, card, same_as=j_info,
                                  prefill_chunk_tokens=64, overlap=True)
    if dev.type == "cuda":
        constrained_replay(cfg, prepared, prompts, json1, dev, card)
    return {name: {dt: j_counts[name][dt] + ilv_counts[name][dt]
                   for dt in DTYPES}
            for name in CACHE_KERNELS}


INT4_STEPS = 24  # [int4]'s captured decode steps a turn (C against C-int4)
# the solo bucketed decoder's ladder: the 300-token prompt prefills at
# 304 positions, and its 16 tokens grow the cache to 512
INT4_BUCKETS = (304, 512)


def captured_step_walls(cfg, prepared, prompts, dev, steps, pools):
    """The wall of a captured decode step (the batcher driven directly, 3
    active slots, A's pool settings) on each of `pools` ({label: cache
    options}), timed in turns (a, b, b, a): {label: [ms, ms]}."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    bats = {}
    for label, kv in pools.items():
        b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                              prompt_pad=64, block_len=16, device=dev, **kv)
        for p in prompts[:3]:
            b.submit(p, 4 * steps + 8)
        for _ in range(4):  # the eager step, the capture, replays
            b.step()
        bats[label] = b
    order = list(pools) + list(pools)[::-1]
    walls = {label: [] for label in pools}
    for label in order:
        b = bats[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            b.step()
        torch.cuda.synchronize()
        walls[label].append((time.perf_counter() - t0) * 1e3 / steps)
    return walls


def phase_int4(cfg, prepared, prompts, n_new, ref_i4, dev, card):
    """[int4] on the main path's gpt2 (ROADMAP item 2's remainder): C-int4
    (the LM daemon over a paged int4 pool: K5 on the packed row, K7 on the
    packed pool) and B-int4 (the dense pool with buckets: K6), each
    stream against the plain int4 cache loop at QUANT_TIE (C's rule at
    int4's larger levels: see QUANT_TIE), the loop prefilling in the
    served 64-token chunks and stepping the
    pool's 4 rows (so that its matmuls sum as the served ones do: a K/V
    value within f32 noise of a 7-level rounding boundary moves a whole
    level, about 1/7 of its row's largest value; the loop prefilling
    whole, `ref_i4`, is printed beside it as the measure of that noise);
    solo make_generate int4 and make_bucketed_generate int4 on the
    300-token prompt against `ref_i4` (both prefill whole, one row), the
    bucketed decoder's tokens equal to make_generate's, its bucket grows
    counted; and, as information, C's and C-int4's captured decode step
    in turns. Returns the launches."""
    from dnn_tpu_torch.runtime.decode_buckets import make_bucketed_generate
    from dnn_tpu_torch.runtime.generate import make_generate

    t0 = time.perf_counter()
    served_i4 = [reference_greedy_cache(prepared, cfg, p, n_new, dev, "int4",
                                        chunk=64, step_rows=4)
                 for p in prompts]
    print(f"[int4] the plain int4 loop in the served chunks and rows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    loop_partings("[int4] plain int4 loops", prompts, served_i4, ref_i4)
    runs = [
        serve_run("C-int4", cfg, prepared, prompts, n_new, served_i4,
                  [("cached_attention", "int4"),
                   ("paged_decode_attention", "int4")], dev, card,
                  tie=QUANT_TIE, kv="paged", kv_dtype="int4"),
        serve_run("B-int4", cfg, prepared, prompts, n_new, served_i4,
                  [("cached_attention", "int4"), ("decode_attention", "int4")],
                  dev, card, tie=QUANT_TIE, kv="dense", decode_buckets=True,
                  kv_dtype="int4"),
    ]
    prompt = prompts[3]
    solo = make_generate(cfg, max_new_tokens=n_new, kv_dtype="int4",
                         device=dev)
    bucketed = make_bucketed_generate(cfg, max_len=1024, max_new_tokens=n_new,
                                      buckets=INT4_BUCKETS, kv_dtype="int4",
                                      device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for gen in (solo, bucketed):
        gen(prepared, [prompt[:8]])  # warm-up
    toks = {}
    for label, gen in (("make_generate", solo),
                       ("make_bucketed_generate", bucketed)):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        out = gen(prepared, [prompt])
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {("cached_attention", "int4"): cfg.n_layer,
                ("decode_attention", "int4"): cfg.n_layer * (n_new - 1)}
        for (name, dt), n in want.items():
            if dev.type == "cuda" and counts[name][dt] != n:
                fail(f"[int4] {label}: {name} ({dt}) launched "
                     f"{counts[name][dt]} times, expected {n}")
        toks[label] = out[0].tolist()
        compare_tokens(f"[int4] {label}", toks[label], *ref_i4[3],
                       tie=QUANT_TIE)
        print(f"[int4] {label} int4: {n_new} tokens after a {len(prompt)}-"
              f"token prompt in {wall * 1e3:.1f} ms"
              + (f", cache {bucketed.buckets[0]}.. rungs "
                 f"{list(bucketed.buckets)}, {bucketed.bucket_grows} "
                 "bucket grows" if gen is bucketed else "")
              + f"; on {card}", flush=True)
        runs.append(counts)
    if toks["make_bucketed_generate"] != toks["make_generate"]:
        fail(f"[int4] make_bucketed_generate {toks['make_bucketed_generate']}"
             f" differs from make_generate {toks['make_generate']}")
    if bucketed.bucket_grows < 1:
        fail("[int4] make_bucketed_generate never grew its cache")
    print("[int4] make_bucketed_generate's tokens equal make_generate's",
          flush=True)
    if dev.type == "cuda":
        walls = captured_step_walls(
            cfg, prepared, prompts, dev, INT4_STEPS,
            {"C": {"kv": "paged", "kv_dtype": "int8"},
             "C-int4": {"kv": "paged", "kv_dtype": "int4"}})
        mean = {k: sum(v) / len(v) for k, v in walls.items()}
        print(f"[int4] captured decode step (3 active slots, turns C, "
              f"C-int4, C-int4, C): C {', '.join(f'{w:.4f}' for w in walls['C'])}"
              f" ms, C-int4 {', '.join(f'{w:.4f}' for w in walls['C-int4'])} "
              f"ms; C-int4 / C {mean['C-int4'] / mean['C']:.3f}; on {card}",
              flush=True)
    return {name: {dt: sum(r[name][dt] for r in runs) for dt in DTYPES}
            for name in CACHE_KERNELS}


OBS_SLO = dict(ttft_s=0.5, inter_token_s=0.05, availability=0.999,
               target=0.99)  # [obs]: the daemon's four --slo_* settings
OBS_STEPS = 60    # [obs]: replayed steps a mode, interleaved on/off
OBS_COVERAGE = 0.95  # JAX's contract: the phases cover >= 95% of a step
OBS_OVERHEAD = 0.10  # the step's wall with obs on over off, at most


def obs_overhead(cfg, prepared, prompts, dev, card, steps=OBS_STEPS):
    """A replayed decode step's wall with DNN_TPU_OBS on and off, the
    batcher carrying the daemon's step clock and goodput tracker (3
    active slots, A's pool): `steps` steps a mode, interleaved step by
    step; the medians, and the launches and captures identical."""
    from dnn_tpu_torch import obs
    from dnn_tpu_torch.obs.goodput import GoodputTracker, model_cost
    from dnn_tpu_torch.obs.timeline import StepClock
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, block_len=16, device=dev,
                          kv="paged")
    b.step_clock = StepClock()
    b.goodput = GoodputTracker(model_cost(cfg, prepared, kv_dtype="f32"))
    for p in prompts[:3]:
        b.submit(p, 2 * steps + 16)
    for _ in range(4):
        b.step()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    graph = b._graph_step
    walls = {True: [], False: []}
    counts = {}
    caps0 = graph.captures if graph is not None else 0
    try:
        for mode in (True, False):  # one step each to settle the mode
            obs.set_enabled(mode)
            b.step()
        for i in range(2 * steps):
            mode = i % 2 == 0
            obs.set_enabled(mode)
            reset_counts()
            sync()
            t0 = time.perf_counter()
            b.step()
            sync()
            walls[mode].append((time.perf_counter() - t0) * 1e3)
            c = read_counts()
            if counts.setdefault(mode, c) != c:
                fail(f"[obs] obs on/off: a step's launches changed: {c} "
                     f"against {counts[mode]}")
    finally:
        obs.set_enabled(True)
    caps = (graph.captures if graph is not None else 0) - caps0
    if counts[True] != counts[False] or caps:
        fail(f"[obs] obs on/off: launches {counts} or captures ({caps}) "
             f"differ")
    med = {m: sorted(w)[len(w) // 2] for m, w in walls.items()}
    ratio = med[True] / med[False]
    if dev.type != "cuda":  # a CPU time is no measure of the card's step
        return med
    print(f"[obs] a replayed decode step (3 active slots, clock and goodput "
          f"attached) with obs on {med[True]:.4f} ms, off {med[False]:.4f} "
          f"ms (medians of {steps} interleaved steps each): on / off "
          f"{ratio:.3f}; the same launches "
          f"({counts[True]['paged_decode_attention']['f32']} K7) and no "
          f"capture; on {card}", flush=True)
    if ratio > 1 + OBS_OVERHEAD:
        fail(f"[obs] obs on costs {100 * (ratio - 1):.1f}% of a step's wall "
             f"(> {100 * OBS_OVERHEAD:.0f}%)")
    return med


def phase_obs(cfg, prepared, prompts, refs, dev, card):
    """[obs] (ROADMAP Queue 1 item 12, serving half) on run A's settings:
    the LM daemon with its endpoint, obs on and the four --slo_* settings
    (OBS_SLO); the four prompts over gRPC concurrently, each tagged with a
    trace of its own (tr=). Holds: /trace?id= returns each request's
    spans (lm.request, queue_wait, admit, prefill, prefill_chunk, decode)
    under that request's trace id and /traces lists every one; the
    phases of every step /stepz records cover at least OBS_COVERAGE of
    that step's wall timed outside the clock (around the batcher's
    step()); dnn_tpu_mbu and dnn_tpu_mfu on /metrics lie in (0, 1]; the
    capture counters (cuda_graph_captures_total) equal the captures the
    batcher's CapturedDecode counted; the streams equal run A's
    references. Then the obs on/off step walls (obs_overhead). Returns
    the launches."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.obs.goodput import SLOConfig
    from dnn_tpu_torch.obs.trace import start_span
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
    from dnn_tpu_torch.utils.metrics import default_metrics

    def captures_counted():
        return sum(v for k, v in default_metrics.snapshot()["counters"].items()
                   if k.startswith("cuda_graph_captures_total"))

    gc.collect()
    caps0 = captures_counted()
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, kv="paged", metrics_port=0,
        slo=SLOConfig(**OBS_SLO))
    srv = stop.servicer
    b, sc = srv.batcher, srv.step_clock
    base = f"http://127.0.0.1:{srv.metrics_server.port}"
    step, walls = b.step, []

    def timed_step():  # the clock's record of this step, beside its wall
        n0 = sc.steps_total
        t0 = time.perf_counter()
        out = step()
        t1 = time.perf_counter()
        if sc.steps_total == n0 + 1:
            walls.append((t1 - t0, sc.records(last=1)[0]))
        return out

    b.step = timed_step
    spans, results, errors = {}, {}, []
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail("[obs] LM daemon never became healthy")
        client.generate(prompts[0], max_new_tokens=2, timeout=300)  # warm-up
        reset_counts()
        walls.clear()

        def call(i):
            sp = spans[i] = start_span("smoke.client", request=i)
            try:
                results[i] = client.generate(
                    prompts[i], max_new_tokens=len(refs[i][0]), timeout=300,
                    trace=sp).tolist()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")
            sp.end()

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        counts = read_counts()
        if errors or len(results) != len(prompts):
            fail(f"[obs] generate calls failed: {errors or 'timed out'}")
        for i, prompt in enumerate(prompts):
            compare_tokens(f"[obs] request {i} (prompt {len(prompt)})",
                           results[i], *refs[i])
        # the spans: each request's under its own trace id
        for i, prompt in enumerate(prompts):
            tid = spans[i].trace_id
            code, body = http(f"{base}/trace?id={tid}")
            ev = [e for e in json.loads(body)["traceEvents"]
                  if e["ph"] == "X"]
            names = sorted({e["name"] for e in ev})
            root = [e for e in ev if e["name"] == "lm.request"]
            n_chunks = -(-len(prompt) // 64)
            if (code != 200 or len(root) != 1
                    or root[0]["args"]["parent_id"] != spans[i].span_id
                    or any(e["args"]["trace_id"] != tid for e in ev)
                    or not {"queue_wait", "admit", "prefill",
                            "decode"} <= set(names)
                    or sum(e["name"] == "prefill_chunk" for e in ev)
                    != n_chunks):
                fail(f"[obs] request {i}: /trace?id={tid} holds {names} "
                     f"({len(ev)} spans; {n_chunks} chunks expected)")
            print(f"[obs] request {i} (prompt {len(prompt)}): /trace?id="
                  f"{tid}: {len(ev)} spans {names}, lm.request "
                  f"{root[0]['dur'] / 1e3:.2f} ms under the client's span",
                  flush=True)
        _, ids = http(f"{base}/traces")
        if not {spans[i].trace_id for i in spans} <= set(json.loads(ids)):
            fail("[obs] /traces misses a request's trace id")
        # the step clock against the steps' walls timed outside it
        cover = []
        for wall, rec in walls:
            admit = sum(t1 - t0 for t0, t1 in rec["admit_slices"])
            cover.append((rec["wall"] - admit) / wall)
        if not walls or min(cover) < OBS_COVERAGE:
            fail(f"[obs] /stepz phases cover {min(cover or [0]):.4f} of a "
                 f"step's wall (< {OBS_COVERAGE}) over {len(walls)} steps")
        _, body = http(f"{base}/stepz")
        stepz = json.loads(body)
        phases = {p: d["frac"] for p, d in stepz["phases"].items()}
        print(f"[obs] /stepz: {len(walls)} steps of the run, the clock's "
              f"phases cover {min(cover):.4f} .. {max(cover):.4f} of each "
              f"step's wall timed around step(); window phase fractions "
              f"{phases}, host_fraction {stepz['host_fraction']}, sync_tax "
              f"{stepz['sync_tax']}, last step {stepz['last_wall_ms']} ms; "
              f"on {card}", flush=True)
        # the goodput gauges and the capture counters on /metrics
        _, text = http(f"{base}/metrics")
        gauges = {}
        for line in text.splitlines():
            for name in ("dnn_tpu_mbu", "dnn_tpu_mfu",
                         "dnn_tpu_goodput_tokens_per_sec",
                         "serving_tokens_per_sec"):
                if line.startswith(name + " "):
                    gauges[name] = float(line.split()[1])
            if line.startswith("dnn_tpu_slo_burn_rate{"):
                gauges[line.split()[0]] = float(line.split()[1])
        for name in ("dnn_tpu_mbu", "dnn_tpu_mfu"):
            # the card's peaks price them; the CPU has none (they read 0)
            if dev.type == "cuda" and not 0.0 < gauges.get(name, 0.0) <= 1.0:
                fail(f"[obs] {name} {gauges.get(name)} is not in (0, 1]")
        if len([k for k in gauges if k.startswith("dnn_tpu_slo")]) != 3:
            fail(f"[obs] /metrics lacks a burn rate: {gauges}")
        for name in ("serving_inter_token_seconds", "step_wall_seconds") + (
                ("cuda_graph_captures_total",) if dev.type == "cuda"
                else ()):  # the CPU steps eagerly: it captures nothing
            if name not in text:
                fail(f"[obs] /metrics lacks {name}")
        client.close()
    finally:
        stop()
    graph = b._graph_step
    counted = captures_counted() - caps0
    if graph is not None and counted != graph.captures:
        fail(f"[obs] cuda_graph_captures_total rose by {counted}, the "
             f"daemon's batcher captured {graph.captures} graphs")
    print(f"[obs] /metrics over the daemon's life (warm-up included): "
          f"{gauges}; cuda_graph_captures_total +{counted} = the batcher's "
          f"{graph.captures if graph is not None else 0} captures; on "
          f"{card}", flush=True)
    if dev.type == "cuda":
        require("[obs] run", counts, [("cached_attention", "f32"),
                                      ("paged_decode_attention", "f32")])
    obs_overhead(cfg, prepared, prompts, dev, card)
    return counts


# [obs2]: ROADMAP Queue 1 item 12's second half on the main path's gpt2 —
# /profilez with timeline.analyze, /trainz with fit's gradient sentinel,
# /kvz and the fleet collector
OBS2_BUSY_TOL = 0.02   # P: analyze's device busy against _kernel_events
OBS2_MFU_TOL = 0.02    # T: the clock's MFU against the wall's
OBS2_GNORM_TOL = 1e-4  # T: the sentinel's grad-norm against a plain norm
OBS2_TRAIN_STEPS = 8   # T: fit's steps on gpt2
OBS2_SLEEP_AT = 3      # T: the train_fault sleep's counter (fit step 4)
OBS2_SLEEP_S = 0.05
OBS2_NAN_AT = 2        # T: the CIFAR leg's nan fault (fit step 3)
OBS2_KEEP = 2          # P: the spool's bound for the leg
OBS2_POOL = 32         # K: the radix store's blocks at pool P
OBS2_TENANTS = 96      # K: one 16-token block each, 3x P
OBS2_TURNS = 600       # K: Zipf(1.1)-chosen tenants, seeded
OBS2_MRC_TOL = 0.10    # K: |predicted at 2x - measured at 2P|
OBS2_FLASH = {}        # T's flash launches, added beside [train]'s


def obs2_profilez(start, cfg, prepared, prompts, dev, card):
    """P: A's daemon (paged f32, metrics_port) under POST /profilez. The
    auto trigger at threshold 0 captures one replayed decode step while
    four requests decode; the step after it runs under _kernel_events
    (a replay of the same graph at the next position). Then a timed
    capture of 300 ms under four streams, a concurrent capture refused
    409, and the spool pruned to OBS2_KEEP. Returns (base URL, stop)."""
    from dnn_tpu_torch.obs import profile as tprof
    from dnn_tpu_torch.obs.timeline import (analyze, find_meta,
                                            find_trace_file, render_report)

    addr, client, srv, stop = daemon(start, cfg, prepared, dev, kv="paged",
                                     metrics_port=0)
    base = f"http://127.0.0.1:{srv.metrics_server.port}"
    b = srv.batcher
    rep_dir = os.path.join(os.environ["DNN_TPU_OBS_DIR"], "replay")
    os.makedirs(rep_dir)
    client.generate(prompts[0], max_new_tokens=4, timeout=300)  # warm-up
    step, seen = b.step, {"replay_next": False}

    def delta(c1, c0):
        return {k: {dt: c1[k][dt] - c0[k][dt] for dt in c1[k]} for k in c1}

    def watched():
        c0 = read_counts()
        captured = tprof.capturing()
        if seen["replay_next"]:
            seen["replay_next"] = False
            box = []
            wall, evs = _kernel_events(
                lambda: box.append(step()),
                trace_path=os.path.join(rep_dir, "replay.trace.json"))
            seen["replay"] = (wall, sum(e.self_device_time_total
                                        for e in evs) / 1e3,
                              sum(e.count for e in evs))
            out = box[0]
        else:
            out = step()
        if captured:
            seen["captured"] = delta(read_counts(), c0)
            seen["replay_next"] = True
        return out

    b.step = watched
    code, body = http(f"{base}/profilez?auto=1&threshold_ms=0", "POST")
    if code != 200 or json.loads(body)["armed"] is None:
        fail(f"[obs2] P: arming answered {code} {body[:200]}")
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, client.generate(prompts[i], max_new_tokens=48, timeout=300)))
        for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    b.step = step
    if len(results) != 4 or "captured" not in seen or "replay" not in seen:
        fail(f"[obs2] P: {len(results)} requests answered; captured "
             f"{'captured' in seen}, replayed {'replay' in seen}")
    caps = json.loads(http(f"{base}/profilez")[1])["captures"]
    path = caps[-1]
    a = analyze(path, clock=srv.step_clock, top_k=64)
    k7 = seen["captured"]["paged_decode_attention"]["f32"]
    n_k7 = sum(op["count"] for op in a["top_ops"]
               if "paged_decode_kernel" in op["name"])
    n_merge = sum(op["count"] for op in a["top_ops"]
                  if "merge" in op["name"])
    with open(find_trace_file(path)) as f:
        trace = json.load(f)["traceEvents"]
    annots = {e.get("name") for e in trace
              if e.get("cat") == "gpu_user_annotation"}
    busy_ms = a["device"]["busy_s"] * 1e3
    # the summed op time: every distinct op is in top_ops (top_k 64)
    sum_ms = sum(op["total_ms"] for op in a["top_ops"])
    rep_wall, rep_ms, rep_n = seen["replay"]
    ra = analyze(os.path.join(rep_dir, "replay.trace.json"))
    rep_busy = ra["device"]["busy_s"] * 1e3
    print(render_report(a), flush=True)
    print(f"[obs2] P auto capture: the captured step launched K7 {k7} "
          f"times, analyze lists {n_k7} paged_decode_kernel and {n_merge} "
          f"merge events; device busy (the union of its device ops) "
          f"{busy_ms:.4f} ms of a {a['window_s'] * 1e3:.3f} ms window "
          f"({a['device']['ops']} ops in {len(a['top_ops'])} names, summed "
          f"{sum_ms:.4f} ms); the next step under _kernel_events: summed "
          f"{rep_ms:.4f} ms ({rep_n} kernels, wall {rep_wall:.3f} ms), "
          f"the union of its trace {rep_busy:.4f} ms; union / union "
          f"{busy_ms / rep_busy if rep_busy else float('nan'):.4f}, sum / "
          f"sum {sum_ms / rep_ms if rep_ms else float('nan'):.4f}; "
          f"gpu_user_annotation ranges {annots}; "
          f"steps {a['steps']}; on {card}", flush=True)
    if dev.type == "cuda":
        if k7 <= 0 or n_k7 != k7:
            fail(f"[obs2] P: analyze lists {n_k7} paged_decode_kernel "
                 f"events, the step launched K7 {k7} times")
        if len(a["top_ops"]) >= 64:
            fail("[obs2] P: more than 63 op names: top_ops is cut")
        if (abs(busy_ms / rep_busy - 1) > OBS2_BUSY_TOL
                or abs(sum_ms / rep_ms - 1) > OBS2_BUSY_TOL):
            fail(f"[obs2] P: device busy {busy_ms} ms vs the replay's "
                 f"{rep_busy} ms, summed {sum_ms} vs {rep_ms} ms "
                 f"(> {OBS2_BUSY_TOL:.0%})")
        if annots & {op["name"] for op in a["top_ops"]}:
            fail(f"[obs2] P: a gpu_user_annotation counted as a device "
                 f"op: {annots}")
    # the timed capture under four streams, a concurrent one refused
    results.clear()
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, client.generate(prompts[i], max_new_tokens=400, timeout=300)))
        for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    timed_out = {}
    first = threading.Thread(target=lambda: timed_out.update(
        r=http(f"{base}/profilez?ms=300", "POST", timeout=300)))
    first.start()
    time.sleep(0.1)
    busy = http(f"{base}/profilez?ms=10", "POST", timeout=300)
    first.join()
    for t in threads:
        t.join(timeout=600)
    code, body = timed_out["r"]
    if code != 200 or busy[0] != 409 or len(results) != 4:
        fail(f"[obs2] P: timed capture {code} {body[:200]}, the "
             f"concurrent one {busy[0]} (409 expected), "
             f"{len(results)} streams")
    tpath = json.loads(body)["capture"]
    meta = find_meta(tpath)
    with open(find_trace_file(tpath)) as f:
        trace = json.load(f)["traceEvents"]
    n_ann = sum(e.get("name") == "serving.decode_step"
                and e.get("cat") == "user_annotation" for e in trace)
    ta = analyze(tpath, clock=srv.step_clock)
    n_steps = meta["step_end"] - meta["step_begin"]
    print(f"[obs2] P timed capture 300 ms: steps {meta['step_begin']}.."
          f"{meta['step_end']} ({n_steps}) in the window, "
          f"{n_ann} serving.decode_step ranges of the worker thread in the "
          f"trace, device busy {ta['device']['busy_frac']:.4f} of the "
          f"{ta['window_s'] * 1e3:.1f} ms window, host gaps p50 "
          f"{ta['host_gaps']['p50_ms']} ms; a concurrent POST answered "
          f"{busy[0]}; on {card}", flush=True)
    if n_steps < 1 or n_ann < 1:
        fail(f"[obs2] P: {n_steps} steps, {n_ann} step ranges in the "
             f"timed capture")
    for _ in range(OBS2_KEEP):
        if http(f"{base}/profilez?ms=10", "POST", timeout=300)[0] != 200:
            fail("[obs2] P: a short capture failed")
    caps = json.loads(http(f"{base}/profilez")[1])["captures"]
    if len(caps) != OBS2_KEEP:
        fail(f"[obs2] P: the spool holds {len(caps)} captures after "
             f"{OBS2_KEEP + 2} (keep {OBS2_KEEP})")
    client.close()
    return base, stop


def obs2_train(cfg, prepared, dev, card):
    """T: fit on gpt2 (B=8 T=512, phase_train's data, a copy of the main
    path's weights) with a TrainClock, a GradSentinel and grad_stats, a
    train_fault sleep at step OBS2_SLEEP_AT + 1; then the CIFAR CNN with
    a nan fault, which must raise loss_nan within 2 steps. Returns the
    flash launches."""
    import os
    import shutil
    import tempfile

    from dnn_tpu_torch import chaos, optim, train
    from dnn_tpu_torch.data.tokens import TokenDataset, write_tokens
    from dnn_tpu_torch.models import cifar
    from dnn_tpu_torch.models.gpt import make_apply_stacked
    from dnn_tpu_torch.obs.trainlens import GradSentinel, TrainClock
    from dnn_tpu_torch.optim import tree_leaves
    from dnn_tpu_torch.utils.flops import gpt_train_step_flops

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        return tree.detach().clone()

    params = clone(prepared)  # the daemons go on serving `prepared`
    opt = optim.adamw(1e-4)
    opt_state = opt.init(params)
    apply = make_apply_stacked(cfg, use_flash=True)
    step = train.make_train_step(
        lambda p, bt: train.next_token_loss(apply, p, bt), opt,
        grad_stats=True, device=dev)
    stats_seen = []

    def fn(state, batch):
        p, o, loss, stats = step(*state, batch)
        stats_seen.append(stats)
        return (p, o), loss, stats

    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs2_")
    flops = gpt_train_step_flops(cfg, TRAIN_B, TRAIN_T)
    try:
        path = os.path.join(tmp, "tokens.bin")
        write_tokens(path, np.random.default_rng(1).integers(
            0, cfg.vocab_size, 2_000_000))
        ds = TokenDataset(path)
        batches = ds.batches(TRAIN_B, TRAIN_T, seed=2)
        state = (params, opt_state)
        state, _ = train.fit(fn, state, batches, num_steps=1)  # warm-up
        clock = TrainClock(flops_per_step=flops,
                           tokens_per_step=TRAIN_B * TRAIN_T).install()
        sentinel = GradSentinel(clock=clock)
        chaos.install(chaos.FaultPlan.from_cli(json.dumps({
            "seed": 0, "faults": [{"kind": "train_fault",
                                   "target": "sleep", "at_n": OBS2_SLEEP_AT,
                                   "delay_s": OBS2_SLEEP_S}]})))
        stats_seen.clear()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        try:
            state, _ = train.fit(fn, state, batches,
                                 num_steps=OBS2_TRAIN_STEPS, clock=clock,
                                 sentinel=sentinel, advance_batches=False)
        finally:
            chaos.uninstall()
        t1 = time.perf_counter()
        summary = clock.summary()
        counts = read_counts()
        require_exact("[obs2] T", counts, per_step(OBS2_TRAIN_STEPS))
        global OBS2_FLASH
        OBS2_FLASH = {n: dict(counts[n]) for n in FLASH_KERNELS}
        recs = clock.records()
        cover = sum(r["wall"] for r in recs) / (t1 - t0)
        data = [r["phases"].get("data", 0.0) for r in recs]
        want = flops * OBS2_TRAIN_STEPS / (t1 - t0) / summary["peak_flops"]
        gnorm = stats_seen[-1].tolist()[0]
        plain = math.sqrt(sum(float(leaf.grad.double().square().sum())
                              for leaf in tree_leaves(state[0])))
        print(f"[obs2] T fit {OBS2_TRAIN_STEPS} steps gpt2 B={TRAIN_B} "
              f"T={TRAIN_T}: the clock's phases cover {cover:.4f} of the "
              f"{(t1 - t0) * 1e3:.1f} ms wall; /trainz MFU "
              f"{summary['mfu']:.6f} of {summary['peak_flops']:.4g} FLOP/s "
              f"({summary['peak_flops_source']}), from the wall and "
              f"gpt_train_step_flops {want:.6f}; data phases (ms) "
              f"{[round(d * 1e3, 2) for d in data]} (a {OBS2_SLEEP_S} s "
              f"sleep at step {OBS2_SLEEP_AT + 1}); the last step's "
              f"grad-norm {gnorm:.9g} vs a plain total norm {plain:.9g}; "
              f"phase fractions "
              f"{ {p: d['frac'] for p, d in summary['phases'].items()} }; "
              f"on {card}", flush=True)
        if cover < OBS_COVERAGE:
            fail(f"[obs2] T: phases cover {cover:.4f} (< {OBS_COVERAGE})")
        if abs(summary["mfu"] / want - 1) > OBS2_MFU_TOL:
            fail(f"[obs2] T: MFU {summary['mfu']} vs {want}")
        if abs(gnorm / plain - 1) > OBS2_GNORM_TOL:
            fail(f"[obs2] T: grad-norm {gnorm} vs {plain}")
        slow = [i for i, d in enumerate(data) if d >= OBS2_SLEEP_S]
        if slow != [OBS2_SLEEP_AT]:
            fail(f"[obs2] T: the sleep landed in steps {slow} "
                 f"(expected [{OBS2_SLEEP_AT}])")
        del state, params, opt_state, stats_seen[:]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the CIFAR CNN: float images, so the nan fault poisons the batch
    cparams = {k: {kk: torch.as_tensor(v, device=dev) for kk, v in d.items()}
               for k, d in cifar.init(0).items()}
    copt = optim.sgd(0.01)
    cstate = (cparams, copt.init(cparams))

    def closs(p, bt):
        probs = cifar.apply(p, bt["x"])
        return -torch.log(probs.gather(1, bt["y"][:, None]) + 1e-9).mean()

    cstep = train.make_train_step(closs, copt, grad_stats=True, device=dev)
    rng = np.random.default_rng(3)

    def cbatches():
        while True:
            yield {"x": rng.standard_normal((32, 32, 32, 3),
                                            dtype=np.float32),
                   "y": rng.integers(0, 10, 32)}

    fired = []
    sentinel = GradSentinel()
    orig = sentinel.observe

    def observe(s, loss, stats=None):
        out = orig(s, loss, stats)
        fired.extend((s, k) for k in out)
        return out

    sentinel.observe = observe
    chaos.install(chaos.FaultPlan.from_cli(json.dumps({
        "seed": 0, "faults": [{"kind": "train_fault", "target": "nan",
                               "at_n": OBS2_NAN_AT}]})))
    try:
        train.fit(lambda st, bt: (lambda o: ((o[0], o[1]), o[2], o[3]))(
            cstep(*st, bt)), cstate, cbatches(), num_steps=6,
            sentinel=sentinel)
    finally:
        chaos.uninstall()
    nan_at = [s for s, k in fired if k == "loss_nan"]
    print(f"[obs2] T CIFAR CNN: a nan fault at fit step {OBS2_NAN_AT + 1}; "
          f"the sentinel fired {fired}; on {card}", flush=True)
    if not nan_at or nan_at[0] - (OBS2_NAN_AT + 1) > 2:
        fail(f"[obs2] T: loss_nan {nan_at} not within 2 steps of the "
             f"fault at step {OBS2_NAN_AT + 1}")


def obs2_tenants():
    """OBS2_TURNS tenant ids, Zipf(1.1) over OBS2_TENANTS by inverse CDF
    of a seeded stream (JAX's kv_economy_probe shape)."""
    w = np.array([1.0 / (k + 1) ** 1.1 for k in range(OBS2_TENANTS)])
    cdf = np.cumsum(w) / w.sum()
    u = np.random.default_rng(15).random(OBS2_TURNS)
    return np.minimum(np.searchsorted(cdf, u), OBS2_TENANTS - 1).tolist()


def obs2_kvz(start, cfg, prepared, dev, card):
    """K: the radix prefix cache under a prefix-heavy schedule (one
    16-token block a tenant, obs2_tenants) at pool P = OBS2_POOL and
    again at 2P, each daemon over gRPC; the curve of the run at P must
    predict the hit ratio measured at 2P within OBS2_MRC_TOL. /kvz
    served by both. Returns (2P's base URL, stop)."""
    tenants = obs2_tenants()
    lenses, out = {}, None
    for cap in (OBS2_POOL, 2 * OBS2_POOL):
        addr, client, srv, stop = daemon(
            start, cfg, prepared, dev, kv="paged", prefix_cache=cap,
            paged_blocks=cap + 4 * 64 + 1, metrics_port=0)
        base = f"http://127.0.0.1:{srv.metrics_server.port}"
        t0 = time.perf_counter()
        for t in tenants:
            client.generate(((np.arange(16) + 37 * t)
                             % (cfg.vocab_size - 1) + 1).tolist(),
                            max_new_tokens=1, timeout=300)
        wall = time.perf_counter() - t0
        code, body = http(f"{base}/kvz")
        kvz = json.loads(body)
        prom = http(f"{base}/kvz?format=prom")[1]
        lens = lenses[cap] = srv.batcher._kvlens
        print(f"[obs2] K pool {cap} blocks: {len(tenants)} turns in "
              f"{wall:.2f} s; /kvz {code}: sampled "
              f"{kvz['samples']['sampled']} of {kvz['samples']['accesses']}"
              f", measured hit ratio {kvz['measured']['hit_ratio']:.4f}, "
              f"curve { {c['mult']: c['predicted_hit_ratio'] for c in kvz['curve']} }"
              f", evictions {kvz['lifecycle']['evictions_by_cause']}, "
              f"refetches {kvz['thrash']['refetch_blocks']}; on {card}",
              flush=True)
        if (code != 200 or kvz["samples"]["sampled"] <= 0
                or "dnn_tpu_kvlens_pred_hit_ratio" not in prom):
            fail(f"[obs2] K: /kvz at pool {cap} answered {code}, "
                 f"{kvz['samples']}")
        client.close()
        if cap == OBS2_POOL:
            stop()
        else:
            out = (base, stop)
    pred = lenses[OBS2_POOL].predicted_hit_ratio(2.0)
    meas = lenses[2 * OBS2_POOL].measured_hit_ratio()
    print(f"[obs2] K: the curve at P predicts {pred:.4f} at 2x, measured "
          f"at 2P {meas:.4f}: error {abs(pred - meas):.4f} (limit "
          f"{OBS2_MRC_TOL}); on {card}", flush=True)
    if abs(pred - meas) > OBS2_MRC_TOL:
        fail(f"[obs2] K: predicted {pred} vs measured {meas}")
    return out


def obs2_fleetz(targets, card):
    """F: a FleetCollector over the P and K daemons' endpoints, served on
    /fleetz: both healthy, each with its MFU and MBU."""
    from dnn_tpu_torch import obs
    from dnn_tpu_torch.obs.fleet import FleetCollector

    col = FleetCollector(targets, interval_s=3600.0)
    col.poll_once()
    srv = obs.serve_metrics(0, fleet=col)
    try:
        code, body = http(f"http://127.0.0.1:{srv.port}/fleetz")
        z = json.loads(body)
        rows = z["stages"]
        print(f"[obs2] F /fleetz {code}: state {z['state']}, stages "
              f"{ {n: (r['state'], r.get('mfu'), r.get('mbu')) for n, r in rows.items()} }"
              f"; on {card}", flush=True)
        if (code != 200 or len(rows) != len(targets)
                or any(r["state"] != "ok" or r.get("mfu") is None
                       or r.get("mbu") is None for r in rows.values())):
            fail(f"[obs2] F: /fleetz {code} {body[:400]}")
    finally:
        srv.close()
        col.close()


def phase_obs2(cfg, prepared, prompts, dev, card):
    """[obs2] (ROADMAP Queue 1 item 12's second half) on the main path's
    gpt2: T (obs2_train), P (obs2_profilez), K (obs2_kvz), F
    (obs2_fleetz), with the profile spool in a temporary
    DNN_TPU_OBS_DIR bounded to OBS2_KEEP. Returns the cache kernels'
    launches of its daemons."""
    import shutil
    import tempfile

    from dnn_tpu_torch.runtime.lm_server import start_lm_server_loop

    t0 = time.perf_counter()
    obs2_train(cfg, prepared, dev, card)
    print(f"[obs2] T wall {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs2_spool_")
    saved = {k: os.environ.get(k) for k in ("DNN_TPU_OBS_DIR",
                                            "DNN_TPU_OBS_PROFILE_KEEP")}
    os.environ.update(DNN_TPU_OBS_DIR=tmp,
                      DNN_TPU_OBS_PROFILE_KEEP=str(OBS2_KEEP))
    start, close = start_lm_server_loop()
    stops = []
    reset_counts()
    try:
        t1 = time.perf_counter()
        p_base, p_stop = obs2_profilez(start, cfg, prepared, prompts, dev,
                                       card)
        stops.append(p_stop)
        print(f"[obs2] P wall {time.perf_counter() - t1:.1f} s", flush=True)
        t1 = time.perf_counter()
        k_base, k_stop = obs2_kvz(start, cfg, prepared, dev, card)
        stops.append(k_stop)
        print(f"[obs2] K wall {time.perf_counter() - t1:.1f} s", flush=True)
        obs2_fleetz([p_base, k_base], card)
        counts = read_counts()
    finally:
        for s in stops:
            s()
        close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    if dev.type == "cuda":
        require("[obs2] daemons", counts, [("cached_attention", "f32"),
                                           ("paged_decode_attention",
                                            "f32")])
    print(f"[obs2] phase wall {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def phase_main_path(dev, card: str):
    """Every main-path run: A paged f32, B dense + buckets f32, C paged
    int8, D paged bf16, then solo make_generate f32, bf16 and int8, and
    the later slices' phases on the same model ([int4], [obs], [obs2]
    last).
    Returns the launches of all runs summed per (kernel, dtype), and what
    the profile needs."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS, init

    cfg = PRESETS["gpt2"]
    t0 = time.perf_counter()
    prepared = from_jax_params(init(0, cfg), cfg, dev)
    torch.cuda.synchronize()
    print(f"[main] gpt2 weights (seed 0) on {dev} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    n_new = 16
    t0 = time.perf_counter()
    ref_f32 = [reference_greedy(prepared, cfg, p, n_new, dev) for p in prompts]
    ref_i8, ref_bf16, ref_i4 = ([reference_greedy_cache(
        prepared, cfg, p, n_new, dev, kv_dtype) for p in prompts]
        for kv_dtype in ("int8", "bf16", "int4"))
    print(f"[main] references (no-cache f32, plain int8, bf16 and int4 "
          f"cache loops) in {time.perf_counter() - t0:.1f} s", flush=True)
    a_info = {}
    runs = [
        serve_run("A", cfg, prepared, prompts, n_new, ref_f32,
                  [("cached_attention", "f32"),
                   ("paged_decode_attention", "f32")], dev, card,
                  info=a_info, kv="paged"),
        serve_run("B", cfg, prepared, prompts, n_new, ref_f32,
                  [("cached_attention", "f32"), ("decode_attention", "f32")],
                  dev, card, kv="dense", decode_buckets=True),
        serve_run("C", cfg, prepared, prompts, n_new, ref_i8,
                  [("cached_attention", "int8"),
                   ("paged_decode_attention", "int8")], dev, card,
                  kv="paged", kv_dtype="int8"),
        serve_run("D", cfg, prepared, prompts, n_new, ref_bf16,
                  [("cached_attention", "bf16"),
                   ("paged_decode_attention", "bf16")], dev, card,
                  kv="paged", kv_dtype="bf16"),
        phase_solo(cfg, prepared, prompts[3], n_new,
                   {"f32": ref_f32[3], "bf16": ref_bf16[3],
                    "int8": ref_i8[3]}, dev),
        phase_serve(cfg, prepared, prompts, ref_f32, a_info, dev, card),
        phase_constrain(cfg, prepared, prompts, a_info, dev, card),
        phase_item_4e(cfg, prepared, prompts,
                      {"f32": ref_f32, "bf16": ref_bf16, "int8": ref_i8},
                      dev, card),
        phase_resilience(cfg, prepared, prompts, ref_f32,
                         a_info["streams"], dev, card),
        timed("int4", phase_int4, cfg, prepared, prompts, n_new, ref_i4,
              dev, card),
        timed("obs", phase_obs, cfg, prepared, prompts, ref_f32, dev, card),
        timed("obs2", phase_obs2, cfg, prepared, prompts, dev, card),
    ]
    launches = {name: {dt: sum(r[name][dt] for r in runs)
                       for dt in DTYPES}
                for name in CACHE_KERNELS}
    return launches, prepared, cfg, prompts


def phase_bf16(dev, card, model="gpt2"):
    """[bf16] gpt2 at full width and depth in bf16 compute: the seed-0
    weights prepared with their matmul weights in bf16 (0.25 GB), the
    main path's four prompts, 16 greedy tokens each, every run with the
    launch counts zeroed just before and read just after, every launch
    with a bf16 q, and the exact counts of the call pattern (K5 once a
    layer a 64-token chunk, the decode kernel once a layer a step):
      E  the LM daemon, paged pool, bf16 KV (the default under bf16
         compute): K5, K7; against the plain bf16-compute loop over a
         bf16 cache prefilled in 64-token chunks, its decode steps at the
         pool's 4 rows (reference_greedy_cache's step_rows), at
         BF16_TIE;
      H-bf16 E with prefill_chunk_tokens=64 and overlap (the mixed step
         a captured graph): its streams equal E's token for token;
      F  the same over an int8 pool: K5, K7 int8; against the loop over
         an int8 cache;
      B-bf16 the dense pool with decode buckets, bf16 KV: K5, K6, a
         recapture at each bucket grow;
      solo-bf16 make_generate on the 300-token prompt (prefilled whole):
         K5 once a layer, K6 once a layer a token after the first;
      P-c-bf16 engine.generate, gpt2 in 4 parts, `"dtype": "bfloat16"`;
    then step_profile on E (one replayed step bit-equal to the eager
    step), mixed_profile on H-bf16, step_profile on F and B-bf16.
    Returns the runs' launches with a bf16 q."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS, init
    from dnn_tpu_torch.ops.nn import mm_out_dtype
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.generate import make_generate

    bf16 = torch.bfloat16
    cfg = PRESETS[model]
    L = cfg.n_layer
    t0 = time.perf_counter()
    prepared = from_jax_params(init(0, cfg), cfg, dev, compute_dtype=bf16)
    sync(dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(prepared))
    print(f"[bf16] gpt2 weights (seed 0), matmul weights in bf16: "
          f"{n_bytes / 1e9:.3f} GB in {time.perf_counter() - t0:.1f} s; "
          f"the head's bf16 x bf16 -> f32 product "
          + ("one torch.mm(out_dtype=float32)" if mm_out_dtype(dev) else
             "an f32 product of the rounded operands (no out_dtype mm)"),
          flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    n_new = 16
    t0 = time.perf_counter()
    ref_bf16, ref_i8 = ([reference_greedy_cache(
        prepared, cfg, p, n_new, dev, kv, chunk=64, compute_dtype=bf16,
        step_rows=4) for p in prompts] for kv in ("bf16", "int8"))
    ref_solo = reference_greedy_cache(prepared, cfg, prompts[3], n_new, dev,
                                      "bf16", compute_dtype=bf16)
    whole = [reference_greedy_cache(prepared, cfg, p, n_new, dev, "bf16",
                                    compute_dtype=bf16, step_rows=4)
             for p in prompts]
    print(f"[bf16] references (plain bf16-compute loops over bf16 and int8 "
          f"caches) in {time.perf_counter() - t0:.1f} s; smallest top-2 "
          f"gaps: bf16 {min(min(g) for _, g in ref_bf16):.3e}, int8 "
          f"{min(min(g) for _, g in ref_i8):.3e}", flush=True)
    loop_partings("[bf16] plain bf16 loops", prompts, ref_bf16, whole)
    chunks = sum(-(-len(p) // 64) for p in prompts)

    def exact(dt, decode):
        return lambda steps: {("cached_attention", dt): L * chunks,
                              (decode, dt): L * steps}

    runs, e_info = [], {}
    for label, refs, dt, decode, kv in (
            ("E", ref_bf16, "bf16", "paged_decode_attention",
             {"kv": "paged", "info": e_info}),
            ("H-bf16", ref_bf16, "bf16", "paged_decode_attention",
             {"kv": "paged", "same_as": e_info, "prefill_chunk_tokens": 64,
              "overlap": True}),
            ("F", ref_i8, "int8", "paged_decode_attention",
             {"kv": "paged", "kv_dtype": "int8"}),
            ("B-bf16", ref_bf16, "bf16", "decode_attention",
             {"kv": "dense", "decode_buckets": True})):
        runs.append(serve_run(
            label, cfg, prepared, prompts, n_new, refs,
            [("cached_attention", dt), (decode, dt)], dev, card,
            exact=exact(dt, decode), tie=BF16_TIE, compute_dtype=bf16, **kv))
    gen = make_generate(cfg, max_new_tokens=n_new, compute_dtype=bf16,
                        device=dev)
    gen(prepared, [prompts[3][:8]])  # warm-up
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = gen(prepared, [prompts[3]])
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts(bf16_q=True)
    want = {("cached_attention", "bf16"): L,
            ("decode_attention", "bf16"): L * (n_new - 1)}
    for (name, dt), n in want.items():
        if dev.type == "cuda" and counts[name][dt] != n:
            fail(f"[bf16] solo-bf16: {name} ({dt}) with a bf16 q launched "
                 f"{counts[name][dt]} times, expected {n}")
    print(f"[bf16] solo-bf16 make_generate: {n_new} tokens after a "
          f"{len(prompts[3])}-token prompt in {wall * 1e3:.1f} ms; launches "
          f"with a bf16 q: K5 {counts['cached_attention']['bf16']}, K6 "
          f"{counts['decode_attention']['bf16']}", flush=True)
    compare_tokens("solo-bf16 make_generate", out[0].tolist(), *ref_solo,
                   tie=BF16_TIE)
    runs.append(counts)
    runs.append(pipe_generate(dev, card, prompts[3], model=model,
                              dtype="bfloat16"))
    if dev.type == "cuda":
        step_profile("bf16", "E paged bf16", cfg, prepared, prompts, dev,
                     bit_check=True, kv="paged", compute_dtype=bf16)
        mixed_profile("bf16", "H-bf16 paged bf16", cfg, prepared, prompts,
                      dev, kv="paged", compute_dtype=bf16)
        step_profile("bf16", "F paged int8", cfg, prepared, prompts, dev,
                     kv="paged", kv_dtype="int8", compute_dtype=bf16)
        step_profile("bf16", "B-bf16 dense+buckets", cfg, prepared, prompts,
                     dev, kv="dense", decode_buckets=True,
                     compute_dtype=bf16)
    return {name: {dt: sum(r[name][dt] for r in runs)
                   for dt in DTYPES}
            for name in CACHE_KERNELS}


TEXT_PROMPT = ("Grüße aus Zürich — naïve café, déjà vu; ∑ λ ≈ 3.14, "
               "数据 流水线, 🙂🚀. ") * 3  # 282 UTF-8 bytes, multi-byte
TEXT_NEW = 16


class IdMarkedTokenizer:
    """[text]'s tokenizer: ByteTokenizer's encode, and a decode that gives
    every id a character of its own (U+F0000 + id, in plane 15's private
    use area), so the ids behind a text reply read back exactly.
    ByteTokenizer's decode maps every id of 256 or more to U+FFFD, and a
    random-weight model generates almost only such ids, so a reply in
    ByteTokenizer's text would pin down none of them."""

    BASE = 0xF0000

    def __init__(self, vocab_size):
        from dnn_tpu_torch.io.tokenizer import ByteTokenizer

        if vocab_size > 0xFFFE:  # U+FFFFE and U+FFFFF are noncharacters
            raise ValueError(f"vocab_size {vocab_size} exceeds plane 15")
        self.vocab_size = vocab_size
        self.byte_tok = ByteTokenizer(vocab_size)

    def encode(self, text):
        return self.byte_tok.encode(text)

    def decode(self, ids):
        return "".join(chr(self.BASE + int(i)) for i in ids)

    def ids(self, text, label):
        """The ids `text` decodes from; fails on any other character."""
        out = [ord(c) - self.BASE for c in text]
        if not all(0 <= i < self.vocab_size for i in out):
            fail(f"{label}: {text!r} holds characters no id decodes to")
        return out


def phase_text(cfg, prepared, dev, card):
    """[text] the daemon at serving run A's configuration (paged f32
    pool, 4 slots, max_len 1024, prompt_pad 64) with IdMarkedTokenizer
    (ByteTokenizer's encode) over the model's vocab: the ids behind
    generate_text's reply (SendMessage), the ids GenerateStream yields and
    the tokens SendTensor returns for the prompt's bytes each equal
    reference_greedy (near-tie rule); the reply equals the decode of
    SendTensor's tokens; generate_text_stream's chunks join to the reply;
    "!stats" answers with the pool's stats; K5 and K7 launched in the
    run. Returns the run's launch counts."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    tok = IdMarkedTokenizer(cfg.vocab_size)
    ids = tok.encode(TEXT_PROMPT)
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, kv="paged", tokenizer=tok)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail("[text] LM daemon never became healthy")
        client.generate_text(TEXT_PROMPT[:8], max_new_tokens=2,
                             timeout=300)  # warm-up
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        reply = client.generate_text(TEXT_PROMPT, max_new_tokens=TEXT_NEW,
                                     timeout=300)
        wall = time.perf_counter() - t0
        tokens = client.generate(ids, max_new_tokens=TEXT_NEW,
                                 timeout=300).tolist()
        streamed = [int(t) for t in client.generate_stream(
            ids, max_new_tokens=TEXT_NEW, timeout=300)]
        chunks = list(client.generate_text_stream(
            TEXT_PROMPT, tok, max_new_tokens=TEXT_NEW, timeout=300))
        stats = client.send_message("chip_smoke", "!stats")
        counts = read_counts()
        client.close()
    finally:
        stop()
    if reply != tok.decode(tokens):
        fail(f"[text] generate_text's reply decodes from "
             f"{tok.ids(reply, '[text] reply')}, SendTensor returned "
             f"{tokens}")
    if "".join(chunks) != reply:
        fail(f"[text] generate_text_stream's {len(chunks)} chunks decode "
             f"from {tok.ids(''.join(chunks), '[text] stream')}, not the "
             f"reply's {tok.ids(reply, '[text] reply')}")
    if not stats.startswith("[lm] pool: "):
        fail(f"[text] '!stats' answered {stats!r}")
    if dev.type == "cuda":
        require("[text]", counts, [("cached_attention", "f32"),
                                   ("paged_decode_attention", "f32")])
    want = reference_greedy(prepared, cfg, ids, TEXT_NEW, dev)
    for label, got in (("SendMessage", tok.ids(reply, "[text] reply")),
                       ("GenerateStream", streamed), ("SendTensor", tokens)):
        compare_tokens(f"[text] {len(ids)}-byte prompt, {label}", got, *want)
    print(f"[text] IdMarkedTokenizer({cfg.vocab_size}): a "
          f"{len(TEXT_PROMPT)}-character, {len(ids)}-byte prompt -> "
          f"{TEXT_NEW} tokens; the reply's ids {tok.ids(reply, '[text]')} "
          f"equal SendTensor's tokens, GenerateStream's equal them too, "
          f"and the text stream's {len(chunks)} chunks join to the reply "
          f"(ByteTokenizer's text: "
          f"{tok.byte_tok.decode(tok.ids(reply, '[text]'))!r}); '!stats': "
          f"{stats!r}; generate_text wall {wall * 1e3:.1f} ms; on {card}",
          flush=True)
    return counts


PIPE_B_TOKENS = 256  # P-b: one request of B=1 T=256 int32 ids
PIPE_C_NEW = 32      # P-c: greedy tokens after the 300-token prompt
PIPE_D_ITEMS = 4     # P-d: microbatches of B=1 T=PIPE_B_TOKENS over Relay


def pipe_config(name: str, **override) -> dict:
    """A config of configs/ with fresh localhost ports and `override`."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", name)) as f:
        raw = json.load(f)
    for node in raw["nodes"]:
        node["address"] = f"127.0.0.1:{free_port()}"
    raw.update(override)
    return raw


def _wait_for(path, text, procs, timeout):
    """Poll `path` until it holds `text`; fail if a process ends first."""
    t_end = time.monotonic() + timeout
    while True:
        with open(path) as f:
            got = f.read()
        if text in got:
            return got
        if time.monotonic() > t_end or any(p.poll() is not None
                                           for p in procs):
            fail(f"[pipe] no {text!r} in {path} (exit codes "
                 f"{[p.poll() for p in procs]}):\n{got[-3000:]}")
        time.sleep(0.2)


def pipe_cifar(dev, card):
    """P-a: cifar_cnn on configs/cifar_2stage.json. The in-process
    engine (role full, relay) on the dummy image against the port's
    apply on the CPU (1e-5, same argmax); then two `node --serve`
    subprocesses on a native .npz of the same weights, node1 given a
    missing --input_image (the dummy image): its FINAL PREDICTION must
    equal the engine's, and each child must log its device."""
    import shutil
    import tempfile

    from dnn_tpu_torch.comm.client import NodeClient, pipeline_budget
    from dnn_tpu_torch.config import TopologyConfig
    from dnn_tpu_torch.io.checkpoint import params_to_flat, save_npz
    from dnn_tpu_torch.io.preprocess import dummy_image
    from dnn_tpu_torch.parallel.pipeline import place
    from dnn_tpu_torch.registry import get_model
    from dnn_tpu_torch.runtime.engine import PipelineEngine

    where = {"device_type": "cpu"} if dev.type == "cpu" else {}
    raw = pipe_config("cifar_2stage.json", runtime="relay", **where)
    spec = get_model("cifar_cnn")
    params = spec.init(0)
    x = dummy_image()
    engine = PipelineEngine(TopologyConfig.from_dict(raw), params=params)
    probs = engine.run(x).cpu()
    pred = engine.predict(x)
    with torch.no_grad():
        want = spec.apply(place(params, "cpu"), torch.from_numpy(x))
    err = (probs - want).abs().max().item()
    if err > 1e-5 or int(want.argmax()) != pred:
        fail(f"[pipe] P-a engine probs max abs err {err:.3e} (limit 1e-5), "
             f"argmax {pred} vs CPU {int(want.argmax())}")
    print(f"[pipe] P-a cifar_cnn engine (relay, 2 stages on {dev}): "
          f"prediction {pred}, probs within {err:.2e} of the CPU apply",
          flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    procs = []
    try:
        save_npz(os.path.join(tmp, "cifar.npz"), params_to_flat(params))
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump({**raw, "model_weights": os.path.join(tmp, "cifar.npz")},
                      f)
        outs = [os.path.join(tmp, f"node{i}.out") for i in (1, 2)]
        env = {**os.environ, "PYTHONPATH": root}
        for node, out, extra in (
                ("node2", outs[1], []),
                ("node1", outs[0], ["--input_image",
                                    os.path.join(tmp, "missing.png")])):
            with open(out, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id",
                     node, "--config", cfg_path, "--serve", *extra],
                    cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        text = _wait_for(outs[0], "FINAL PREDICTION", procs, 300)
        first = time.perf_counter() - t0
        line = [ln for ln in text.splitlines() if "FINAL PREDICTION" in ln][0]
        if line.strip() != f"***** FINAL PREDICTION (Index): {pred} *****":
            fail(f"[pipe] P-a node1 printed {line.strip()!r}, the engine "
                 f"predicts {pred}")
        for node, out in zip(("node1", "node2"), outs):
            logged = _wait_for(out, f"device {dev.type}", procs, 60)
            # the record's message: after the logger's [node id] prefix
            print(f"[pipe] P-a {node}: " + [
                ln for ln in logged.splitlines()
                if f"device {dev.type}" in ln][0].split(
                    f"[{node}] ", 1)[-1].strip(), flush=True)
        client = NodeClient(raw["nodes"][0]["address"])
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            status, result = client.send_tensor(x, timeout=pipeline_budget(2))
            walls.append(time.perf_counter() - t1)
            if result is None or int(result.argmax()) != pred:
                fail(f"[pipe] P-a client round trip: {status}")
        client.close()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=60) for p in procs]
        if rcs != [0, 0]:
            fail(f"[pipe] P-a children exited {rcs} on SIGTERM")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[pipe] P-a two `node --serve` processes: node1 printed "
          f"prediction {pred} {first:.1f} s after launch (process start, "
          f"weights, health wait included); a client's round trip over "
          f"gRPC (stage 0 on node1, stage 1 on node2) median "
          f"{sorted(walls)[2] * 1e3:.2f} ms of 5 (min {min(walls) * 1e3:.2f})"
          f"; on {card}", flush=True)


def pipe_gpt_stages(dev, card, model=None, n_tokens=PIPE_B_TOKENS):
    """P-b: configs/gpt2_8stage.json (gpt2-medium, 8 stages, bf16
    compute) at full width, seeded weights drawn once and shared. Eight
    in-process stage servers (role stage) answer one send_tensor of int32
    ids B=1 T=n_tokens: the f32 logits must equal the in-process relay
    engine's bit for bit (same card, same operations), and lie within
    5e-2 x max|logit| of an f32 relay run, with the same argmax wherever
    the f32 top-2 gap exceeds 0.1. Then P-d on the same servers
    (pipe_relay)."""
    from dnn_tpu_torch.comm.client import NodeClient, pipeline_budget
    from dnn_tpu_torch.comm.service import start_stage_servers_in_background
    from dnn_tpu_torch.config import TopologyConfig
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.registry import get_model
    from dnn_tpu_torch.runtime.engine import PipelineEngine

    where = {"device_type": "cpu"} if dev.type == "cpu" else {}
    raw = pipe_config("gpt2_8stage.json", runtime="relay", **where,
                      **({"model": model} if model else {}))
    spec = get_model(raw["model"])
    t0 = time.perf_counter()
    params = spec.init(0)
    print(f"[pipe] P-b {raw['model']} weights (seed 0, numpy) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    config = TopologyConfig.from_dict(raw)
    ids = np.random.default_rng(1).integers(
        0, spec.config.vocab_size, (1, n_tokens)).astype(np.int32)
    relay = PipelineEngine(config, params=params)
    want = relay.run(ids).cpu()
    items = [np.random.default_rng(10 + i).integers(
        0, spec.config.vocab_size, (1, n_tokens)).astype(np.int32)
        for i in range(PIPE_D_ITEMS)]
    wants = [relay.run(x).cpu() for x in items]
    _, stage_s = relay.stage_times(ids)
    last_in = torch.as_tensor(ids)  # the activation entering the last stage
    for part in range(len(raw["nodes"]) - 1):
        last_in = relay.run_stage(part, last_in)
    last_in = last_in.cpu()
    _, stop = start_stage_servers_in_background([
        (PipelineEngine(config, params=params, role="stage"), node["id"], None)
        for node in raw["nodes"]])
    try:
        client = NodeClient(raw["nodes"][0]["address"])
        if not client.wait_healthy(deadline=60):
            fail("[pipe] P-b stage server node1 never became healthy")
        client.send_tensor(ids, timeout=pipeline_budget(8))  # warm-up
        t1 = time.perf_counter()
        status, got = client.send_tensor(ids, timeout=pipeline_budget(8))
        wall = time.perf_counter() - t1
        client.close()
        # the last stage alone: one hop in, the logits back
        last = NodeClient(raw["nodes"][-1]["address"])
        last.send_tensor(last_in, timeout=pipeline_budget(1))
        t1 = time.perf_counter()
        _, got_last = last.send_tensor(last_in, timeout=pipeline_budget(1))
        wall_last = time.perf_counter() - t1
        last.close()
        pipe_relay(raw["nodes"][0]["address"], items, wants, card)
    finally:
        stop()
    if got_last is None or not torch.equal(got_last, want):
        fail("[pipe] P-b the last stage server alone returned other logits "
             "than the relay engine's")
    if got is None:
        fail(f"[pipe] P-b no logits came back: {status}")
    if got.dtype != torch.float32 or got.shape != want.shape:
        fail(f"[pipe] P-b logits {got.dtype} {tuple(got.shape)}, the relay "
             f"engine's {want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        fail(f"[pipe] P-b logits over gRPC differ from the relay engine's: "
             f"max abs {(got - want).abs().max().item():.3e}")
    f32 = PipelineEngine(TopologyConfig.from_dict({**raw, "dtype": "float32"}),
                         params=params)
    ref = f32.run(ids).cpu()
    del relay, f32
    top = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    top2 = torch.topk(ref[0], 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 0.1
    flips = int((got[0].argmax(-1) != ref[0].argmax(-1))[decided].sum())
    if not torch.isfinite(got).all() or err > 5e-2 * top or flips:
        fail(f"[pipe] P-b bf16 logits against f32: max abs err {err:.3e} "
             f"(limit 5e-2 x {top:.3f}), {flips} argmax flips where the f32 "
             "top-2 gap > 0.1")
    sync(dev)
    print(f"[pipe] P-b {raw['model']} 8 stage servers, bf16 compute, "
          f"B=1 T={n_tokens}: {status.rsplit('Next node status: ', 1)[-1]}; "
          f"logits ({got.numel() * 4 / 1e6:.1f} MB f32) equal the relay "
          f"engine's bit for bit; against f32: max abs err {err:.3e} = "
          f"{err / top:.2e} x max|logit|, argmax equal at "
          f"{int(decided.sum())} decided positions", flush=True)
    print(f"[pipe] P-b request wall over gRPC (8 hops) {wall * 1e3:.1f} ms; "
          f"the last stage alone (its {last_in.numel() * 2 / 1e6:.2f} MB "
          f"bf16 input in, the logits back) {wall_last * 1e3:.1f} ms; "
          "relay per-stage compute (record_timings) ms "
          + " / ".join(f"{t * 1e3:.2f}" for t in stage_s)
          + f" (sum {sum(stage_s) * 1e3:.1f}); on {card}", flush=True)


def pipe_relay(address, items, wants, card):
    """P-d: the microbatches `items` through P-b's stage servers with
    send_tensors over the streamed Relay RPC (the client's hello must say
    relay); each result must equal the relay engine's run of its item
    (`wants`) bit for bit. Prints the streamed wall, each item's ack
    latency, and beside them the wall of the same items as sequential
    unary send_tensor calls (checked alike)."""
    from dnn_tpu_torch.comm.client import NodeClient, pipeline_budget

    client = NodeClient(address)
    neg = client.negotiated()
    if not neg.relay_ok:
        fail(f"[pipe] P-d the first stage's hello gave no Relay: {neg.reason}")
    budget = pipeline_budget(8)
    client.send_tensors(items[:1], timeout=budget)  # warm-up
    t0 = time.perf_counter()
    acks = []
    streamed = client.send_tensors(items, timeout=budget, ack_s=acks)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    unary = [client.send_tensor(x, timeout=budget) for x in items]
    wall_unary = time.perf_counter() - t0
    client.close()
    for i, ((status, got), (_, got_u), want) in enumerate(
            zip(streamed, unary, wants)):
        if got is None or "Processing complete" not in status:
            fail(f"[pipe] P-d item {i} over Relay: {status}")
        if not torch.equal(got, want) or not torch.equal(got_u, want):
            fail(f"[pipe] P-d item {i}: logits differ from the relay "
                 "engine's")
    if any(a is None for a in acks):
        fail(f"[pipe] P-d items without an ack: {acks}")
    n = len(items)
    print(f"[pipe] P-d {n} microbatches of {tuple(items[0].shape)} ids over "
          f"Relay (hello: grpc, relay): each result equals the relay "
          f"engine's bit for bit; streamed wall {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / n:.1f} ms an item), acks after "
          + " / ".join(f"{a * 1e3:.2f}" for a in acks)
          + f" ms; {n} sequential unary send_tensor {wall_unary * 1e3:.1f} ms"
          f" ({wall_unary * 1e3 / n:.1f} ms an item); streamed / unary "
          f"{wall / wall_unary:.2f}; on {card}", flush=True)


def pipe_generate(dev, card, prompt, model="gpt2", n_new=PIPE_C_NEW,
                  dtype="float32"):
    """P-c: a derived config (model, 4 parts, relay, `dtype`):
    engine.generate greedy, n_new tokens after `prompt`, against
    reference_greedy on the same weights (f32), or (P-c-bf16, dtype
    "bfloat16") the plain bf16-compute loop over a bf16 cache at
    BF16_TIE, with K5 and K6 launched (counted in the run; with a bf16 q
    under bf16). Returns the run's launch counts."""
    from dnn_tpu_torch.config import TopologyConfig
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.engine import PipelineEngine

    cfg = PRESETS[model]
    raw = {"nodes": [{"id": f"node{i + 1}", "part_index": i,
                      "address": f"127.0.0.1:{free_port()}"}
                     for i in range(4)],
           "model": model, "num_parts": 4, "runtime": "relay",
           "dtype": dtype,
           "device_type": "cpu" if dev.type == "cpu" else "tpu"}
    bf16 = dtype == "bfloat16"
    dt, label = ("bf16", "P-c-bf16") if bf16 else ("f32", "P-c")
    engine = PipelineEngine(TopologyConfig.from_dict(raw))
    engine.generate([prompt[:8]], max_new_tokens=2)  # warm-up
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    toks = engine.generate([prompt], max_new_tokens=n_new)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts(bf16_q=bf16)
    if dev.type == "cuda":
        require(f"{label} engine.generate", counts,
                [("cached_attention", dt), ("decode_attention", dt)])
    if bf16:
        ref = reference_greedy_cache(
            from_jax_params(engine.params, cfg, dev, torch.bfloat16), cfg,
            prompt, n_new, dev, "bf16", compute_dtype=torch.bfloat16)
    else:
        ref = reference_greedy(from_jax_params(engine.params, cfg, dev), cfg,
                               prompt, n_new, dev)
    compare_tokens(f"{label} engine.generate ({model}, 4 parts)",
                   toks[0].tolist(), *ref, tie=BF16_TIE if bf16 else NEAR_TIE)
    print(f"[pipe] {label} {n_new} tokens after a {len(prompt)}-token prompt "
          f"in {wall * 1e3:.1f} ms = {n_new / wall:.1f} tokens/s; on {card}",
          flush=True)
    return counts


# [spec]: gpt2-xl drafted by gpt2 (the HF assisted-generation pair)
SPEC_K = 4
SPEC_NEW = 16
SPEC_TARGET, SPEC_DRAFT = "gpt2-xl", "gpt2"


def spec_exact(l_target, l_draft, k, chunks, dt="f32"):
    """The launches a speculative run must show, from its step count:
    every step the draft sync (K5, one a draft layer), k draft steps (K6,
    one a draft layer each) and the target's verify (K5, one a target
    layer); every prompt chunk one K5 a layer of each model (at
    admission, or folded into a mixed step)."""
    return lambda steps: {
        ("cached_attention", dt): (l_target + l_draft) * (steps + chunks),
        ("decode_attention", dt): k * l_draft * steps}


def spec_replay(tag, b, prompts, kind="spec"):
    """One replayed speculative step against the same step taken eagerly:
    the four prompts in `b`'s slots (`kind` "spec_mixed": three decoding
    while the fourth folds in), the step captured and replayed once, then
    from one saved state the graph replayed and the step run eagerly
    (b._spec_core, or b._spec_mixed with the next chunk): the committed
    block, the accepted counts (and the chunk's logits), and the slots'
    state after (tokens, positions, sync chunks) bit for bit."""
    from dnn_tpu_torch.parallel.pipeline import sync

    if kind == "spec":
        for p in prompts:
            b.submit(p, 200)
        b.step()
        b.step()
        graph, walls = b._graph_step, {}
        for mode, n in (("captured", 10), ("eager", 3)):
            b._graph_step = graph if mode == "captured" else None
            sync(b.device)
            t0 = time.perf_counter()
            for _ in range(n):
                b.step()
            sync(b.device)
            walls[mode] = (time.perf_counter() - t0) * 1e3 / n
        b._graph_step = graph
        wall, dev_ms, n_kern, top, k5_ms, dec_ms = _profiled(b.step)
        print(f"[spec] {tag}: a speculative step of 4 active slots (spec_k "
              f"{b.spec_k}: the draft sync, {b.spec_k} draft steps, the "
              f"verify) {walls['captured']:.3f} ms wall captured, "
              f"{walls['eager']:.3f} ms eager; one captured step under the "
              f"profiler {wall:.3f} ms wall, {dev_ms:.3f} ms device busy "
              f"({100 * dev_ms / wall:.1f}%), {n_kern} kernels, K5 "
              f"{k5_ms:.3f} ms, K6 {dec_ms:.3f} ms; top {top[:3]}",
              flush=True)
    else:
        for p in prompts[:3]:
            b.submit(p, 200)
        while b._pending_q:
            b.step()
        b.submit(prompts[3], 200)
        b.step()
        b.step()
        ilv = b._ilv_next()
        if ilv is None:
            fail(f"[spec] {tag}: no chunk pending for the mixed replay")
        n = b._ilv
        b._chunk_d.copy_(ilv["p"]["padded"][:, ilv["c"] * n:
                                            (ilv["c"] + 1) * n])
        b._start_d.fill_(ilv["c"] * n)
    g = b._graph_step
    if g is None or kind not in g._graphs:
        fail(f"[spec] {tag}: the {kind} step was not captured")
    graph, static, log, _ = g._graphs[kind]
    state = [b._tok_d, b._pos_d, b._prev_chunk, b._prev_pos]
    saved = [t.clone() for t in state]
    graph.replay()
    log.replayed()
    replayed = [t.clone() for t in static] + [t.clone() for t in state]
    for t, s0 in zip(state, saved):
        t.copy_(s0)
    eager = [t.clone() for t in (b._spec_core() if kind == "spec"
                                 else b._spec_mixed())]
    eager += [t.clone() for t in state]
    torch.cuda.synchronize()
    names = (["block", "accepted"] + (["chunk logits"] if kind != "spec"
                                      else [])
             + ["tokens", "positions", "sync chunks", "sync bases"])
    for what, r, e in zip(names, replayed, eager):
        if not torch.equal(r, e):
            fail(f"[spec] {tag}: a replayed {kind} step's {what} differ from "
                 f"the eager step's")
    print(f"[spec] {tag}: one replayed {kind} step equals the eager step bit "
          f"for bit ({', '.join(names)}); accepted {replayed[1].tolist()}",
          flush=True)


def plain_step_wall(tag, cfg, prepared, prompts, dev, **kw):
    """Information: the captured decode step's wall of the plain dense
    batcher at the [spec] pool (4 slots decoding), the yardstick a
    speculative step (one token a slot at random weights) is read
    against."""
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, kv="dense", device=dev, **kw)
    for p in prompts:
        b.submit(p, 200)
    b.step()
    b.step()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        b.step()
    sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e2
    wall, dev_ms, _, _, _, _ = _profiled(b.step)
    print(f"[spec] {tag}: the plain batcher's captured decode step (4 "
          f"slots, dense f32) {step_ms:.3f} ms wall; under the profiler "
          f"{wall:.3f} ms wall, {dev_ms:.3f} ms device busy", flush=True)


def spec_self(cfg, prepared, prompts, refs, dev, card):
    """S-self: gpt2 drafted by itself, the four prompts through the
    speculative batcher: every proposal accepted, every step committing
    k+1 tokens for every active slot, the streams against the no-cache
    loop, launches exactly spec_exact's; then a replay check. Returns the
    launches."""
    from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher

    L = cfg.n_layer
    kw = dict(spec_k=SPEC_K, slots=4, max_len=1024, prompt_pad=64,
              device=dev)
    b = SpeculativeBatcher(cfg, prepared, cfg, prepared, **kw)
    b.drain()
    rid = b.submit(prompts[0], 2)  # warm-up: the kernels and the graph
    b.drain()
    b.claim(rid)
    reset_counts()
    steps0 = b.spec_steps
    b.spec_proposed = b.spec_accepted = 0
    rids = [b.submit(p, SPEC_NEW) for p in prompts]
    commits = []
    while b.n_active:
        commits.append(b.step())
    counts = read_counts()
    steps = b.spec_steps - steps0
    sizes = sorted({len(t) for out in commits for t in out.values()})
    if sizes != [SPEC_K + 1]:
        fail(f"[spec] S-self: steps committed {sizes} tokens a slot, "
             f"expected {SPEC_K + 1} every step")
    if b.spec_accepted != b.spec_proposed:
        fail(f"[spec] S-self: {b.spec_accepted} of {b.spec_proposed} "
             "proposals accepted, expected all")
    for i, (rid, p) in enumerate(zip(rids, prompts)):
        compare_tokens(f"[spec] S-self request {i} (prompt {len(p)})",
                       b.results[rid].tolist(), *refs[i])
    chunks = sum(-(-len(p) // 64) for p in prompts)
    if dev.type == "cuda":
        for (name, dt), n in spec_exact(L, L, SPEC_K, chunks)(steps).items():
            if counts[name][dt] != n:
                fail(f"[spec] S-self: {name} ({dt}) launched "
                     f"{counts[name][dt]} times, expected {n}")
    print(f"[spec] S-self ({cfg.n_layer}-layer gpt2 drafting itself, spec_k "
          f"{SPEC_K}): {steps} steps, every one committing {SPEC_K + 1} "
          f"tokens a slot, {b.spec_accepted} of {b.spec_proposed} proposals "
          f"accepted (1.000); streams match the reference; launches "
          f"{ {n: counts[n] for n in CACHE_KERNELS} }; on {card}",
          flush=True)
    if dev.type == "cuda":
        spec_replay("S-self", SpeculativeBatcher(cfg, prepared, cfg, prepared,
                                                 **kw), prompts)
    return counts


def spec_solo(t_cfg, t_prep, d_cfg, d_prep, prompt, ref, dev, card,
              tag="spec", label="S-solo"):
    """S-solo: make_speculative_generate (the target drafted by d_cfg) on
    the 300-token prompt, SPEC_NEW greedy tokens, against make_generate's
    on the target (make_generate_moe's for a GPT-MoE target; near-tie
    rule, the reference's gaps) and against the reference `ref` (tokens,
    gaps); launches exactly: both prefills and every iteration's sync
    and verify on K5, the draft's k steps on K6. Returns the launches
    and the iteration count."""
    from dnn_tpu_torch.models.gpt_moe import GPTMoEConfig
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.generate import make_generate
    from dnn_tpu_torch.runtime.generate_moe import make_generate_moe
    from dnn_tpu_torch.runtime.speculative import make_speculative_generate

    solo = (make_generate_moe if isinstance(t_cfg, GPTMoEConfig)
            else make_generate)
    want = solo(t_cfg, max_new_tokens=SPEC_NEW, device=dev)(
        t_prep, [prompt])[0].tolist()
    spec = make_speculative_generate(t_cfg, d_cfg, max_new_tokens=SPEC_NEW,
                                     k=SPEC_K, return_stats=True, device=dev)
    spec(t_prep, d_prep, [prompt[:8]])  # warm-up
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    toks, stats = spec(t_prep, d_prep, [prompt])
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    compare_tokens(f"[{tag}] {label} make_speculative_generate",
                   toks[0].tolist(), want, ref[1])
    compare_tokens(f"[{tag}] {label} against the reference",
                   toks[0].tolist(), *ref)
    it = stats["iterations"]
    if dev.type == "cuda":
        exact = {("cached_attention", "f32"):
                 (t_cfg.n_layer + d_cfg.n_layer) * (1 + it),
                 ("decode_attention", "f32"): SPEC_K * d_cfg.n_layer * it}
        for (name, dt), n in exact.items():
            if counts[name][dt] != n:
                fail(f"[{tag}] {label}: {name} ({dt}) launched "
                     f"{counts[name][dt]} times, expected {n}")
    print(f"[{tag}] {label}: {SPEC_NEW} tokens after a {len(prompt)}-token "
          f"prompt in {wall * 1e3:.1f} ms, {it} iterations, "
          f"{stats['accepted']} of {stats['proposed']} proposals accepted; "
          f"equal to make_generate's; launches "
          f"{ {n: counts[n] for n in CACHE_KERNELS} }; on {card}", flush=True)
    return counts, it


def phase_spec(dev, card, target=SPEC_TARGET, draft=SPEC_DRAFT):
    """[spec] ROADMAP item 4 d's speculative decoding: gpt2-xl (48
    layers, 1600 wide, 25 heads) as the target drafted by gpt2, both at
    full width with seed-0 weights, the dense f32 pool (4 slots, max_len
    1024, prompt_pad 64), spec_k 4, the main path's four prompts, 16
    greedy tokens each, every run with the launch counts zeroed just
    before and read just after and exactly spec_exact's:
      S       the LM daemon over gRPC (draft_cfg=), streams against
              gpt2-xl's no-cache greedy loop; acceptance and tokens/s
      S-ilv   S with 64-token interleaved chunks and overlap, streams
              equal to S's
      S-solo  make_speculative_generate, equal to make_generate's
      S-self  gpt2 drafting gpt2: every proposal accepted
      S-bf16  both in bf16 compute (bf16 caches), against the plain
              bf16-compute loop at BF16_TIE
    and on the card one replayed step of each pool bit-equal to the eager
    step. Random weights make gpt2-xl and gpt2 agree almost never: S's
    acceptance is near zero; S-self is the full-acceptance run. Returns
    ({"f32": launches, "bf16": launches with a bf16 q}, the verify
    launches at gpt2-xl's shape by cache type)."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS, init
    from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher

    t_cfg, d_cfg = PRESETS[target], PRESETS[draft]
    t0 = time.perf_counter()
    # drawn on the device: a numpy draw of gpt2-xl's 1.6 G weights costs
    # tens of seconds of host time
    tree = init(0, t_cfg, device=dev)
    t_prep = from_jax_params(tree, t_cfg, dev)
    d_tree = init(0, d_cfg, device=dev)
    d_prep = from_jax_params(d_tree, d_cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"[spec] {target} ({t_cfg.n_layer} layers, {t_cfg.n_embd} wide, "
          f"{t_cfg.n_head} heads) and {draft} weights (seed 0) on {dev} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, t_cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    t0 = time.perf_counter()
    refs = [reference_greedy(t_prep, t_cfg, p, SPEC_NEW, dev)
            for p in prompts]
    d_refs = [reference_greedy(d_prep, d_cfg, p, SPEC_NEW, dev)
              for p in prompts]
    print(f"[spec] references (no-cache loops) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    L_t, L_d = t_cfg.n_layer, d_cfg.n_layer
    chunks = sum(-(-len(p) // 64) for p in prompts)
    kw = dict(kv="dense", draft_cfg=d_cfg, spec_k=SPEC_K)
    pool = dict(spec_k=SPEC_K, slots=4, max_len=1024, prompt_pad=64,
                device=dev)
    f32 = [("cached_attention", "f32"), ("decode_attention", "f32")]
    s_info, ilv_info = {}, {}
    runs = [serve_run("S", t_cfg, t_prep, prompts, SPEC_NEW, refs, f32, dev,
                      card, exact=spec_exact(L_t, L_d, SPEC_K, chunks),
                      info=s_info, draft_prepared=d_prep, **kw)]
    if dev.type == "cuda":
        spec_replay("S", SpeculativeBatcher(t_cfg, t_prep, d_cfg, d_prep,
                                            **pool), prompts)
        plain_step_wall(f"plain {target}", t_cfg, t_prep, prompts, dev)
    runs.append(serve_run("S-ilv", t_cfg, t_prep, prompts, SPEC_NEW, refs,
                          f32, dev, card,
                          exact=spec_exact(L_t, L_d, SPEC_K, chunks),
                          info=ilv_info, same_as=s_info,
                          draft_prepared=d_prep, prefill_chunk_tokens=64,
                          overlap=True, **kw))
    if dev.type == "cuda":
        spec_replay("S-ilv", SpeculativeBatcher(
            t_cfg, t_prep, d_cfg, d_prep, prefill_chunk_tokens=64,
            overlap=True, **pool), prompts, kind="spec_mixed")
    solo, iters = spec_solo(t_cfg, t_prep, d_cfg, d_prep, prompts[3],
                            refs[3], dev, card)
    runs.append(solo)
    runs.append(spec_self(d_cfg, d_prep, prompts, d_refs, dev, card))
    del t_prep, d_prep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    t_b = from_jax_params(tree, t_cfg, dev, bf16)
    d_b = from_jax_params(d_tree, d_cfg, dev, bf16)
    del tree, d_tree
    b_refs = [reference_greedy_cache(t_b, t_cfg, p, SPEC_NEW, dev, "bf16",
                                     chunk=64, compute_dtype=bf16,
                                     step_rows=4) for p in prompts]
    b_info = {}
    b_counts = serve_run("S-bf16", t_cfg, t_b, prompts, SPEC_NEW, b_refs,
                         [("cached_attention", "bf16"),
                          ("decode_attention", "bf16")], dev, card,
                         exact=spec_exact(L_t, L_d, SPEC_K, chunks, "bf16"),
                         tie=BF16_TIE, info=b_info, draft_prepared=d_b,
                         compute_dtype=bf16, **kw)
    if dev.type == "cuda":
        spec_replay("S-bf16", SpeculativeBatcher(
            t_cfg, t_b, d_cfg, d_b, compute_dtype=bf16, **pool), prompts)
    del t_b, d_b
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    f32_counts = {name: {dt: sum(r[name][dt] for r in runs)
                         for dt in DTYPES}
                  for name in CACHE_KERNELS}
    verify = {"f32": L_t * (s_info["steps"] + ilv_info["steps"] + iters),
              "bf16": L_t * b_info["steps"]}
    return {"f32": f32_counts, "bf16": b_counts}, verify


def phase_pipe(dev, card, prompt):
    """The staged pipeline: P-a, P-b, P-c. Returns P-c's launches."""
    t0 = time.perf_counter()
    pipe_cifar(dev, card)
    pipe_gpt_stages(dev, card)
    counts = pipe_generate(dev, card, prompt)
    print(f"[pipe] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def _kernel_events(fn, trace_path=None):
    """(wall ms, the device-side events of fn()) under torch.profiler:
    kernels and copies only — an operator's row repeats the time of its
    kernels, and a user annotation (Optimizer.step) the time of the
    kernels inside it. With `trace_path`, the session's Chrome trace is
    also written there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnn_tpu_torch.obs.profile import exclusive

    # the process's one profiler session (ProfilerBusy while a capture of
    # the daemon records)
    with exclusive(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    return wall, [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time of one fn() call: the profiler's sum of its
    kernels' own time over `iters` calls, after a warm-up. For library
    calls that are not captured into a graph (an autograd backward): host
    overhead between kernels does not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    _, evs = _kernel_events(run)
    return sum(e.self_device_time_total for e in evs) / 1e3 / iters


DECODE_KERNEL_NAMES = ("decode_attn_kernel", "paged_decode_kernel",
                       "decode_merge_kernel")


def _profiled(fn):
    """(wall ms, device ms, kernel launches, top kernels, K5 device ms,
    K6/K7 device ms) of fn() under torch.profiler: device ms sums the
    kernels' own device time; K5's sums its split and merge kernels
    (cached_attn_*), K6/K7's theirs (DECODE_KERNEL_NAMES)."""
    wall, evs = _kernel_events(fn)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    k5_ms = sum(e.self_device_time_total for e in evs
                if "cached_attn" in e.key) / 1e3
    dec_ms = sum(e.self_device_time_total for e in evs
                 if any(n in e.key for n in DECODE_KERNEL_NAMES)) / 1e3
    n_kernels = sum(e.count for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    return wall, dev_ms, n_kernels, [(e.key[:60], e.self_device_time_total
                                      / 1e3, e.count) for e in top], k5_ms, \
        dec_ms


PROFILED_POOLS = (("A paged f32", {"kv": "paged"}),
                  ("B dense+buckets f32", {"kv": "dense",
                                           "decode_buckets": True}),
                  ("C paged int8", {"kv": "paged", "kv_dtype": "int8"}),
                  ("D paged bf16", {"kv": "paged", "kv_dtype": "bf16"}))


def step_profile(tag, label, cfg, prepared, prompts, dev, bit_check=False,
                 steps=8, **kv):
    """Information: a decode step of the batcher driven directly (as the
    daemon's worker drives it; 4 slots, max_len 1024, prompt_pad 64, 3
    active slots) with the cache options `kv`: the step's wall as the
    captured CUDA graph and eagerly (the graph taken away), each under
    the profiler too (device busy, kernel launches, top kernels, K6/K7's
    share), and the admission of the 300-token prompt. With `bit_check`,
    one replay of the captured step must give the eager step's logits on
    the same static inputs bit for bit (the step re-writes the same K/V
    rows, so both read the same cache). Returns the walls."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, block_len=16, device=dev, **kv)
    for p in prompts[:3]:
        b.submit(p, 64)
    for _ in range(4):
        b.step()
    torch.cuda.synchronize()

    def decode():
        for _ in range(steps):
            b.step()

    graph, walls = b._graph_step, {}
    for mode in ("captured", "eager"):
        b._graph_step = graph if mode == "captured" else None
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        walls[mode] = (time.perf_counter() - t0) * 1e3 / steps
        wall, dev_ms, n_kern, top, _, dec_ms = _profiled(decode)
        walls[mode + " device"] = dev_ms / steps
        print(f"[{tag}] {label}: decode step (3 active slots, {mode}) "
              f"{walls[mode]:.3f} ms wall; under the profiler "
              f"{wall / steps:.3f} ms wall, {dev_ms / steps:.3f} ms device "
              f"busy ({100 * dev_ms / wall:.1f}% of wall), "
              f"{n_kern / steps:.0f} kernel launches per step; K6/K7 "
              f"{dec_ms / steps:.4f} ms/step = {100 * dec_ms / dev_ms:.1f}% "
              "of device busy", flush=True)
        if mode == "captured":
            for name, ms, n in top[:4]:
                print(f"[{tag}]   decode {ms / steps:.4f} ms/step  "
                      f"x{n // steps}  {name}", flush=True)
    b._graph_step = graph
    print(f"[{tag}] {label}: captured / eager decode-step wall "
          f"{walls['captured'] / walls['eager']:.2f}", flush=True)
    if bit_check:
        graph._graph.replay()
        graph._log.replayed()
        torch.cuda.synchronize()
        replayed = graph._logits.clone()
        eager = b._decode(b.cache, graph.tok, graph.pos, graph.active)
        torch.cuda.synchronize()
        if not torch.equal(replayed, eager):
            fail(f"[{tag}] {label}: a replayed step's logits differ from "
                 f"the eager step's by "
                 f"{(replayed - eager).abs().max().item():.3e}")
        print(f"[{tag}] {label}: one replayed step's logits equal the eager "
              f"step's on the same inputs bit for bit", flush=True)
    wall, dev_ms, n_kern, top, k5_ms, _ = _profiled(
        lambda: b.submit(prompts[3], 2))
    walls["admission"] = wall
    print(f"[{tag}] {label}: admission of a {len(prompts[3])}-token "
          f"prompt (5 chunks + install): {wall:.3f} ms wall, "
          f"{dev_ms:.3f} ms device busy ({100 * dev_ms / wall:.1f}%), "
          f"{n_kern} kernel launches; K5 {k5_ms:.4f} ms = "
          f"{100 * k5_ms / dev_ms:.1f}% of device busy", flush=True)
    for name, ms, n in top[:3]:
        print(f"[{tag}]   prefill {ms:.4f} ms  x{n}  {name}", flush=True)
    return walls


def phase_profile(prepared, cfg, prompts, dev):
    """Information only: where a decode step's and a prefill's time goes
    on each main-path pool (step_profile: the captured step against the
    eager one, device busy, kernel launches, top kernels)."""
    for label, kv in PROFILED_POOLS:
        step_profile("profile", label, cfg, prepared, prompts, dev, **kv)


TRAIN_B, TRAIN_T, TRAIN_LAYERS = 8, 512, 12


def require_exact(label, counts, expected):
    """Every (kernel, dtype) of `expected` launched exactly that many
    times in the run; prints the run's flash counts."""
    flash = {n: {dt: c for dt, c in counts[n].items() if c}
             for n in FLASH_KERNELS}
    print(f"[train] {label} flash launches: {flash}", flush=True)
    for (name, dt), n in expected.items():
        if counts[name][dt] != n:
            fail(f"{label}: {name} ({dt}) launched {counts[name][dt]} times, "
                 f"expected {n}")


def per_step(n_steps: int, dt: str = "f32", remat: bool = False):
    """The exact flash launches of n train steps (no eval): K2 once per
    layer (twice under remat: the recompute), K3 and K4 once, K1 never."""
    n, k2 = n_steps * TRAIN_LAYERS, (2 if remat else 1)
    return {("flash_attention", dt): 0, ("flash_attention_lse", dt): k2 * n,
            ("flash_bwd_dq", dt): n, ("flash_bwd_dkv", dt): n}


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def add_counts(total, counts):
    for name in FLASH_KERNELS:
        for dt in ("f32", "bf16"):
            total[name][dt] += counts[name][dt]


def _flash_share(fn):
    """(wall ms, device ms, flash-kernel share of device time, top
    kernels) of fn() under torch.profiler."""
    wall, evs = _kernel_events(fn)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    flash_ms = sum(e.self_device_time_total for e in evs
                   if "flash_" in e.key) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    return wall, dev_ms, flash_ms, [(e.key[:70], e.self_device_time_total
                                     / 1e3, e.count) for e in top]


def phase_train(dev, card):
    """The training main path: full-width gpt2 (seed-0 weights, nothing
    cut), B=8 T=512, make_apply_stacked(use_flash=True), next_token_loss,
    the port's adamw(1e-4), batches from a seeded token file through
    TokenDataset. Runs T-a..T-e, each with the launch counts zeroed just
    before and read just after. Returns the flash launches summed over
    the runs, {kernel: {dtype: n}}."""
    import itertools
    import os
    import shutil
    import tempfile

    from dnn_tpu_torch import optim, train
    from dnn_tpu_torch.data.tokens import TokenDataset, write_tokens
    from dnn_tpu_torch.models.gpt import (PRESETS, init, make_apply_stacked,
                                          prepare_stacked)
    from dnn_tpu_torch.utils.flops import gpt_train_step_flops

    cfg = PRESETS["gpt2"]
    t0 = time.perf_counter()
    tree = init(0, cfg)
    total = {n: {"f32": 0, "bf16": 0} for n in FLASH_KERNELS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        path = os.path.join(tmp, "tokens.bin")
        write_tokens(path, np.random.default_rng(1).integers(
            0, cfg.vocab_size, 2_000_000))
        ds = TokenDataset(path)
        batch0 = next(ds.batches(TRAIN_B, TRAIN_T, seed=0))
        held = list(itertools.islice(ds.batches(TRAIN_B, TRAIN_T, seed=99), 2))
        print(f"[train] gpt2 tree (seed 0) and a {len(ds)}-token file in "
              f"{time.perf_counter() - t0:.1f} s; B={TRAIN_B} T={TRAIN_T}",
              flush=True)

        def fresh():
            prepared = prepare_stacked(tree, cfg, dev)
            opt = optim.adamw(1e-4)
            return (prepared, opt.init(prepared)), opt

        def fit_fn(opt, **kw):
            apply = make_apply_stacked(cfg, **kw)
            step = train.make_train_step(
                lambda p, b: train.next_token_loss(apply, p, b), opt)

            def fn(state, batch):
                params, opt_state, loss = step(*state, batch)
                return (params, opt_state), loss
            return fn

        def run(label, fn, state, batches, n, hook=None, **fit_kw):
            """fit n steps with the counts zeroed before and read after
            (hook(step) after each); returns (state, losses, per-step
            walls, counts)."""
            losses, stamps = [], []

            def on_step(step, loss):
                losses.append(loss.item())
                stamps.append(time.perf_counter())
                if hook is not None:
                    hook(step)
            torch.cuda.synchronize()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            stamps.append(time.perf_counter())
            state, _ = train.fit(fn, state, batches, num_steps=n,
                                 on_step=on_step, **fit_kw)
            torch.cuda.synchronize()
            counts = read_counts()
            add_counts(total, counts)
            walls = [b - a for a, b in zip(stamps, stamps[1:])]
            print(f"[train] {label}: losses {[round(x, 5) for x in losses]}",
                  flush=True)
            return state, losses, walls, counts

        # T-a: loss and per-leaf gradients, kernels against the einsum
        tokens0 = torch.as_tensor(batch0, device=dev)
        grads = {}
        for use_flash in (True, False):
            (prepared, _), _ = fresh()
            apply = make_apply_stacked(cfg, use_flash=use_flash)
            torch.cuda.synchronize()
            reset_counts()
            loss = train.next_token_loss(apply, prepared, tokens0)
            loss.backward()
            torch.cuda.synchronize()
            counts = read_counts()
            if use_flash:
                add_counts(total, counts)
                require_exact("T-a one step", counts, per_step(1))
            else:
                require_exact("T-a einsum step", counts, {
                    (n, "f32"): 0 for n in FLASH_KERNELS})
            grads[use_flash] = (loss.item(), {
                k: leaf.grad for k, leaf in named_leaves(prepared)})
            del prepared
        (lf, gf), (le, ge) = grads[True], grads[False]
        if not abs(lf - le) <= 1e-5 * abs(le):
            fail(f"T-a: loss {lf} (kernels) vs {le} (einsum)")
        worst = max(((gf[k] - ge[k]).abs().max().item()
                     / max(ge[k].abs().max().item(), 1e-30), k) for k in ge)
        if not worst[0] <= 1e-4:
            fail(f"T-a: leaf {worst[1]} max|dg| = {worst[0]:.3e} x max|g|")
        print(f"[train] T-a: loss {lf:.6f} (kernels) vs {le:.6f} (einsum), "
              f"rel {abs(lf - le) / le:.2e}; worst leaf {worst[1]} max|dg| "
              f"{worst[0]:.2e} x its max|g| (limit 1e-4)", flush=True)
        del grads, gf, ge

        # T-b: 8 steps on one repeated batch; the loss falls at every step
        state, opt = fresh()
        after2 = {}

        def keep_step2(step):
            if step == 2:
                after2.update({k: t.detach().clone()
                               for k, t in named_leaves(state[0])})
        _, losses_b, walls_b, counts = run(
            "T-b 8 steps, one batch", fit_fn(opt, use_flash=True), state,
            itertools.repeat(batch0), 8, hook=keep_step2)
        del state
        require_exact("T-b", counts, per_step(8))
        if any(b >= a for a, b in zip(losses_b, losses_b[1:])):
            fail(f"T-b: the loss did not fall at every step: {losses_b}")
        peak_f32 = torch.cuda.max_memory_allocated()

        # remat: 2 steps; K2 twice per layer, loss and params as without
        state_r, opt_r = fresh()
        state_r, losses_r, _, counts = run(
            "remat 2 steps", fit_fn(opt_r, use_flash=True, remat=True),
            state_r, itertools.repeat(batch0), 2)
        require_exact("remat", counts, per_step(2, remat=True))
        d_loss = max(abs(a - b) for a, b in zip(losses_r, losses_b[:2]))
        d_par = max((t - after2[k]).abs().max().item()
                    for k, t in named_leaves(state_r[0]))
        if d_loss > 1e-6 or d_par > 1e-6:
            fail(f"remat: loss differs by {d_loss}, params by {d_par}")
        print(f"[train] remat: losses within {d_loss:.1e}, params within "
              f"{d_par:.1e} of the run without it (limit 1e-6)", flush=True)
        del state_r, after2

        # T-c: 6 steps with checkpoints every 3; resume from 3, 3 more
        ck, ck3 = os.path.join(tmp, "ck"), os.path.join(tmp, "ck3")
        state, opt = fresh()
        fn = fit_fn(opt, use_flash=True)
        state, _, _, counts = run(
            "T-c 6 steps, checkpoint every 3", fn, state,
            ds.batches(TRAIN_B, TRAIN_T, seed=2), 6, ckpt_dir=ck,
            ckpt_every=3, keep_checkpoints=2)
        require_exact("T-c", counts, per_step(6))
        whole = {k: t.detach().clone() for k, t in named_leaves(state[0])}
        os.makedirs(ck3)
        for name in ("step_00000003.npz", "step_00000003.npz.manifest.json"):
            os.replace(os.path.join(ck, name), os.path.join(ck3, name))
        del state
        fresh_state, opt = fresh()
        state, start = train.resume_or_init(ck3, fresh_state)
        if start != 3:
            fail(f"T-c: resumed at step {start}, expected 3")
        state, _, _, counts = run(
            "T-c resumed at 3, to 6", fit_fn(opt, use_flash=True), state,
            ds.batches(TRAIN_B, TRAIN_T, seed=2), 6, start_step=3)
        require_exact("T-c resume", counts, per_step(3))
        d_res = max((t - whole[k]).abs().max().item()
                    for k, t in named_leaves(state[0]))
        if d_res != 0.0:
            fail(f"T-c: resumed params differ by {d_res} (expected "
                 "bit-equal: the kernels and the step are deterministic)")
        print(f"[train] T-c: resumed run == uninterrupted run, max|d| "
              f"{d_res} (bit-equal)", flush=True)
        del whole

        # T-d: evaluate, K1's path
        apply = make_apply_stacked(cfg, use_flash=True)
        torch.cuda.synchronize()
        reset_counts()
        ev = train.evaluate(apply, state[0], held)
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(total, counts)
        require_exact("T-d evaluate", counts, {
            ("flash_attention", "f32"): TRAIN_LAYERS * len(held),
            ("flash_attention_lse", "f32"): 0, ("flash_bwd_dq", "f32"): 0,
            ("flash_bwd_dkv", "f32"): 0})
        if not math.isfinite(ev["loss"]):
            fail(f"T-d: evaluate loss {ev['loss']}")
        print(f"[train] T-d: evaluate on {ev['batches']} held-out batches "
              f"({ev['tokens']} tokens): loss {ev['loss']:.5f} perplexity "
              f"{ev['perplexity']:.2f}", flush=True)

        # information: one profiled f32 step
        wall, dev_ms, flash_ms, top = _flash_share(
            lambda: fn(state, batch0))
        print(f"[profile] train step f32: {wall:.1f} ms wall, {dev_ms:.1f} ms "
              f"device busy; flash kernels {flash_ms:.2f} ms = "
              f"{100 * flash_ms / dev_ms:.1f}% of device time", flush=True)
        for name, ms, n in top:
            print(f"[profile]   {ms:8.3f} ms  x{n}  {name}", flush=True)
        del state

        # T-e: bf16 compute, 3 steps, then evaluate
        state, opt = fresh()
        fn_e = fit_fn(opt, use_flash=True, compute_dtype=torch.bfloat16)
        state, losses_e, _, counts = run(
            "T-e bf16 3 steps", fn_e, state, itertools.repeat(batch0), 3)
        if abs(losses_e[0] - lf) > 2e-2:
            fail(f"T-e: first bf16 loss {losses_e[0]} vs f32 {lf}")
        if not all(torch.isfinite(t.grad).all() for _, t in
                   named_leaves(state[0])):
            fail("T-e: non-finite gradients")
        apply_bf16 = make_apply_stacked(cfg, use_flash=True,
                                        compute_dtype=torch.bfloat16)
        reset_counts()
        ev_bf16 = train.evaluate(apply_bf16, state[0], held[:1])
        torch.cuda.synchronize()
        counts_e = read_counts()
        add_counts(total, counts_e)
        for name in FLASH_KERNELS:
            counts_e[name]["bf16"] += counts[name]["bf16"]
        require_exact("T-e steps + evaluate", counts_e, {
            **per_step(3, "bf16"),
            ("flash_attention", "bf16"): TRAIN_LAYERS})
        print(f"[train] T-e: first bf16 loss {losses_e[0]:.5f} vs f32 "
              f"{lf:.5f} (limit 2e-2); evaluate loss {ev_bf16['loss']:.5f}",
              flush=True)

        # information: 6 more bf16 steps for the step time, one profiled
        state, _, walls_e, counts = run(
            "bf16 timing, 6 more steps", fn_e, state,
            itertools.repeat(batch0), 6)
        require_exact("bf16 timing", counts, per_step(6, "bf16"))
        peak_bf16 = torch.cuda.max_memory_allocated()
        wall, dev_ms, flash_ms, top = _flash_share(
            lambda: fn_e(state, batch0))
        print(f"[profile] train step bf16: {wall:.1f} ms wall, {dev_ms:.1f} "
              f"ms device busy; flash kernels {flash_ms:.2f} ms = "
              f"{100 * flash_ms / dev_ms:.1f}% of device time", flush=True)
        for name, ms, n in top:
            print(f"[profile]   {ms:8.3f} ms  x{n}  {name}", flush=True)

        flops = gpt_train_step_flops(cfg, TRAIN_B, TRAIN_T)
        for label, walls, peak_mem, peak, pname in (
                ("f32", walls_b[1:], peak_f32, F32_FLOPS_PER_S,
                 "67 TFLOP/s f32 CUDA-core peak"),
                ("bf16", walls_e, peak_bf16, BF16_FLOPS_PER_S,
                 "989 TFLOP/s bf16 tensor-core peak")):
            step_s = float(np.median(walls))
            print(f"[train] {label} step (median of {len(walls)} warm "
                  f"steps): {step_s * 1e3:.1f} ms wall, "
                  f"{TRAIN_B * TRAIN_T / step_s:.0f} tokens/s, peak "
                  f"{peak_mem / 2**30:.2f} GiB allocated, MFU "
                  f"{100 * flops / step_s / peak:.2f}% of the {pname} "
                  f"({flops / 1e12:.3f} TFLOP/step); on {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


LLAMA_NEW, LLAMA_SOLO_NEW = 16, 32  # L-A / L-C tokens; L-solo tokens
LLAMA_PROMPTS = (5, 70, 130, 300)
LLAMA_SOLO_S = LLAMA_PROMPTS[-1] + LLAMA_SOLO_NEW  # L-solo's dense cache


def sdpa_gqa(q, k, v, mask=None):
    """The library yardstick: SDPA with grouped heads (enable_gqa)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def phase_llama_kernels(dev, gen):
    """[llama] kernel rows at llama3-8b's shapes (32 query heads over 8 KV
    heads, D=128), each against its plain version, f32, bf16 and int8:
    K5 with grouped heads at a prefill chunk (B=1 H=32 Hk=8 T=64 S=1024,
    base 960); K7 at the decode step (B=4 Hk=8 R=4, 16-row blocks, 64 a
    slot, 257 pool blocks, pos {0, 15, 16, 1023}); K6 at L-solo's shape
    (B=1 Hk=8 R=4, S=LLAMA_SOLO_S: the 300-token prompt plus its 32 new
    tokens, so its split plan; pos S - 2, the last decode step). The
    library time is SDPA with enable_gqa on q of (B, 32, T, 128) and the
    same boolean mask, for the float caches; none for int8 and for paged.
    Bounds as the gpt2 rows': bytes (the Hk heads' live K/V read once),
    K5's function products at its type's fastest rate (k5_bound), K6/K7's
    f32 FMAs at 67 TFLOP/s. Returns {"K5": rows, "K7": rows, "K6 solo":
    rows}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        K5_TILE, cached_attention, decode_attention, k5_split,
        paged_decode_attention, reference_cached_attention,
        reference_decode_attention, reference_paged_decode_attention)

    out = {"K5": {}, "K7": {}, "K6 solo": {}}
    H, HK, D = 32, 8, 128
    G = H // HK
    # K5, grouped heads
    B, T, S, base = 1, 64, 1024, 960
    split_tiles, n_split = k5_split(B * H, T, S)
    print(f"[llama] K5 B={B} H={H} Hk={HK} T={T} S={S} D={D} base {base}: "
          f"{n_split} splits of {split_tiles * K5_TILE} keys, grid "
          f"({n_split}, 1, {B * H})", flush=True)
    pos = torch.full((B,), base, dtype=torch.int32, device=dev)
    cols = torch.arange(S, device=dev)
    mask = cols[None, :] <= (base + torch.arange(T, device=dev))[:, None]
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, H, T, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, HK, S, D), name, dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"[llama] K5 {name} G={G}",
                    cached_attention(q[0], k[0], v[0], pos, **sc),
                    reference_cached_attention(q[0], k[0], v[0], pos, **sc),
                    tol)
        nbytes, _, ops, (b_ms, b_by, byte_ms, op_ms) = k5_bound(
            name, B, H, HK, T, S, base, D)
        ms = time_ms(cycling(lambda i: cached_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        plain = time_ms(cycling(lambda i: reference_cached_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        lib = None
        if name not in QUANT:
            qd = q.to(k.dtype)
            lib = time_ms(cycling(lambda i: sdpa_gqa(qd[i], k[i], v[i], mask),
                                  LAYERS))
        out["K5"][name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("llama", f"K5 {name:4s} G={G} base {base}", out["K5"][name],
               nbytes, byte_ms, op_ms, ops)
    # K7 at R = G rows a KV head
    B, bp, nb_max, n_blocks = 4, 16, 64, 257
    decode_plan("llama K7", B * HK, nb_max * bp, bp)
    pos_list = [0, 15, 16, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_blocks - 1,
                          generator=torch.Generator().manual_seed(0))
    tables = (perm[:B * nb_max] + 1).reshape(B, nb_max).to(torch.int32).to(dev)
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, HK, G, D, generator=gen, device=dev)
        kp, vp, ks, vs = kv_cache(gen, (LAYERS, n_blocks, HK, bp, D), name,
                                  dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"[llama] K7 {name} R={G}",
                    paged_decode_attention(q[0], kp[0], vp[0], tables, pos,
                                           **sc),
                    reference_paged_decode_attention(q[0], kp[0], vp[0],
                                                     tables, pos, **sc), tol)
        live = sum(p + 1 for p in pos_list)
        nbytes = (2 * B * HK * G * D * 4 + HK * kv_bytes(name, live, D)
                  + sum(p // bp + 1 for p in pos_list) * 4 + B * 4)
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, 4 * D * HK * G * live)
        ms = time_ms(cycling(lambda i: paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos, **scales_at(ks, vs, i)),
            LAYERS))
        plain = time_ms(cycling(lambda i: reference_paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos, **scales_at(ks, vs, i)),
            LAYERS))
        out["K7"][name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                               bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("llama", f"K7 {name:4s} R={G} pos {pos_list} (no one-call "
               "library equivalent)", out["K7"][name], nbytes, byte_ms, op_ms)
    # K6 at L-solo's shape, R = G: its dense cache of prompt + new tokens
    # (the split plan it launches), at its last decode step's position
    B, S, last = 1, LLAMA_SOLO_S, LLAMA_SOLO_S - 2
    decode_plan("llama K6 solo", B * HK, S)
    pos = torch.tensor([last], dtype=torch.int32, device=dev)
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, HK, G, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, HK, S, D), name, dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"[llama] K6 solo {name} R={G}",
                    decode_attention(q[0], k[0], v[0], pos, **sc),
                    reference_decode_attention(q[0], k[0], v[0], pos, **sc),
                    tol)
        nbytes = 2 * B * HK * G * D * 4 + HK * kv_bytes(name, last + 1, D) + 4
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, 4 * D * HK * G * (last + 1))
        ms = time_ms(cycling(lambda i: decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        plain = time_ms(cycling(lambda i: reference_decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        lib = None
        if name not in QUANT:  # columns <= last; q as 32 heads
            qd = q.reshape(LAYERS, B, H, 1, D).to(k.dtype)
            live = torch.arange(S, device=dev)[None, :] <= last
            lib = time_ms(cycling(lambda i: sdpa_gqa(qd[i], k[i], v[i],
                                                     live), LAYERS))
        out["K6 solo"][name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                    bound_ms=b_ms, bound_by=b_by,
                                    max_abs_err=err)
        report("llama", f"K6 solo {name:4s} R={G} S={S} pos {last}",
               out["K6 solo"][name], nbytes, byte_ms, op_ms)
    return out


def phase_llama(dev, card, cfg=None):
    """[llama] llama3-8b at full width and depth (or `cfg`), random
    weights in the JAX tree layout drawn on the card from a seeded
    torch.Generator (llama.init with device=: std 0.02, o and down at
    0.02 / sqrt(2 n_layer), norm scales at one) and passed through
    convert.from_jax_params; then, each run with the launch counts zeroed
    just before and read just after:
      L-A the LM daemon in-process (serve_run: 4 slots, max_len 1024,
          prompt_pad 64, paged f32 pool of 257 blocks of 16), 4
          concurrent greedy requests (prompts of 5/70/130/300 seeded
          tokens, 16 new each) equal to reference_greedy on the llama
          forward; K5 launched once per layer per prefill chunk (11
          chunks), K7 once per layer per decode step, exactly;
      L-C the same with int8 KV, against reference_greedy_cache over a
          dense int8 cache at KV heads, prefilled in 64-token chunks as
          served, a divergence accepted only where its top-2 gap is
          below QUANT_TIE (K5, K7 int8, exactly); the same loop
          prefilling each prompt whole is printed beside it, as the
          measure of the int8 noise;
      L-C-int4 the same with int4 KV against the plain int4 loop (K5,
          K7 int4, exactly);
      L-solo llama.make_generate on the 300-token prompt, dense f32
          cache, 32 tokens, equal to reference_greedy; K5 once per layer,
          K6 once per layer per token after the first, exactly;
    plus, as information, a decode step's (captured and eager) and the
    300-token admission's wall and device busy on the paged f32 pool
    (step_profile). Then [quant]'s Q8-L over this tree quantized to int8
    (phase_quant_llama). Returns the runs' launch counts, Q8-L's bf16-q
    launches and its teacher-forced errors."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.parallel.pipeline import sync

    cfg = cfg or llama.PRESETS["llama3-8b"]
    L = cfg.n_layer
    t0 = time.perf_counter()
    tree = llama.init(0, cfg, device=dev)
    prepared = from_jax_params(tree, cfg, dev)
    del tree
    sync(dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(prepared))
    print(f"[llama] {cfg.n_layer} layers, {cfg.n_embd} wide, "
          f"{cfg.n_head} heads over {cfg.n_kv_head} KV heads, D "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}: f32 weights "
          f"{n_bytes / 1e9:.2f} GB drawn on {dev} and prepared in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in LLAMA_PROMPTS]
    t0 = time.perf_counter()
    ref = [reference_greedy(prepared, cfg, p, LLAMA_NEW, dev)
           for p in prompts[:3]]
    solo_ref = reference_greedy(prepared, cfg, prompts[3], LLAMA_SOLO_NEW, dev)
    ref.append((solo_ref[0][:LLAMA_NEW], solo_ref[1][:LLAMA_NEW]))
    # the int8 reference prefills in the served path's 64-token chunks;
    # the loop prefilling each prompt whole measures the quantization
    # noise that QUANT_TIE allows for
    ref_i8 = [reference_greedy_cache(prepared, cfg, p, LLAMA_NEW, dev, "int8",
                                     chunk=64) for p in prompts]
    # int4: the pool's 4 rows a step too, as [int4]'s served loop (a
    # level is 1/7 of a row's largest value, so f32 noise moves more)
    ref_i4 = [reference_greedy_cache(prepared, cfg, p, LLAMA_NEW, dev, "int4",
                                     chunk=64, step_rows=4) for p in prompts]
    whole_i4 = [reference_greedy_cache(prepared, cfg, p, LLAMA_NEW, dev,
                                       "int4") for p in prompts]
    whole_i8 = [reference_greedy_cache(prepared, cfg, p, LLAMA_NEW, dev,
                                       "int8") for p in prompts]
    print(f"[llama] references (no-cache f32; plain int8 cache loops, "
          f"chunked and whole; the plain int4 loop, chunked) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    loop_partings("[llama] plain int8 loops", prompts, ref_i8, whole_i8)
    loop_partings("[llama] plain int4 loops (served chunks and rows, and "
                  "whole prompts a row at a time)", prompts, ref_i4, whole_i4)
    chunks = sum(-(-len(p) // 64) for p in prompts)

    def exact(dt):
        return lambda steps: {("cached_attention", dt): L * chunks,
                              ("paged_decode_attention", dt): L * steps}

    runs = [
        serve_run("L-A", cfg, prepared, prompts, LLAMA_NEW, ref,
                  [("cached_attention", "f32"),
                   ("paged_decode_attention", "f32")], dev, card,
                  exact=exact("f32"), kv="paged"),
        serve_run("L-C", cfg, prepared, prompts, LLAMA_NEW, ref_i8,
                  [("cached_attention", "int8"),
                   ("paged_decode_attention", "int8")], dev, card,
                  exact=exact("int8"), tie=QUANT_TIE, kv="paged",
                  kv_dtype="int8"),
        # [int4] L-C-int4: the same over a paged int4 pool (K5 and K7 on
        # the packed payload)
        serve_run("L-C-int4", cfg, prepared, prompts, LLAMA_NEW, ref_i4,
                  [("cached_attention", "int4"),
                   ("paged_decode_attention", "int4")], dev, card,
                  exact=exact("int4"), tie=INT4_TIE, kv="paged",
                  kv_dtype="int4"),
    ]
    # L-solo
    gen = llama.make_generate(cfg, max_new_tokens=LLAMA_SOLO_NEW, device=dev)
    gen(prepared, [prompts[3][:8]])  # warm-up
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    toks = gen(prepared, [prompts[3]])
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    if dev.type == "cuda":
        want = {("cached_attention", "f32"): L,
                ("decode_attention", "f32"): L * (LLAMA_SOLO_NEW - 1)}
        for (name, dt), n in want.items():
            if counts[name][dt] != n:
                fail(f"[llama] L-solo: {name} ({dt}) launched "
                     f"{counts[name][dt]} times, expected {n}")
    print(f"[llama] L-solo make_generate: {LLAMA_SOLO_NEW} tokens after a "
          f"{len(prompts[3])}-token prompt in {wall * 1e3:.1f} ms; launches "
          f"{ {n: {d: c for d, c in by.items() if c} for n, by in counts.items() if any(by.values())} }",
          flush=True)
    compare_tokens("[llama] L-solo make_generate f32", toks[0].tolist(),
                   *solo_ref)
    runs.append(counts)
    # information: where a decode step's and an admission's time goes
    if dev.type == "cuda":
        step_profile("llama", "L-A paged f32", cfg, prepared, prompts, dev,
                     kv="paged")
    counts = {name: {dt: sum(r[name][dt] for r in runs)
                     for dt in DTYPES}
              for name in CACHE_KERNELS}
    # [quant] Q8-L: this tree quantized on the card, the f32 copy freed
    from dnn_tpu_torch.quant import quantize_gpt

    t0 = time.perf_counter()
    qprep = quantize_gpt(prepared, bits=8)
    del prepared
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sync(dev)
    print(f"[quant] Q8-L: llama3-8b's f32 tree quantized to int8 on {dev} "
          f"in {time.perf_counter() - t0:.1f} s, the f32 copy freed",
          flush=True)
    t0 = time.perf_counter()
    q8l, q8l_forced = phase_quant_llama(cfg, qprep, prompts, dev, card)
    print(f"[quant] Q8-L phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return counts, q8l, q8l_forced


def phase_llama_bf16(dev, card, cfg=None):
    """[llama] L-B: llama3-8b at full width and depth (or `cfg`) in bf16
    compute, its weights drawn on the card as [llama] draws them (the
    f32 weights of [llama] freed first) and prepared with the matmul
    weights in bf16 (16.06 GB), served by the LM daemon over the paged
    bf16 pool (the four prompts, 16 greedy tokens each, the launch
    counts zeroed just before and read just after): K5 with grouped heads
    and a bf16 q once a layer a 64-token chunk, K7 at R = 4 once a layer
    a step, exactly; the streams against the plain bf16-compute loop
    over a bf16 cache prefilled in 64-token chunks, its decode steps at
    the pool's 4 rows, at BF16_TIE; L-B-ilv the same with
    prefill_chunk_tokens=64 and overlap, its streams equal to L-B's;
    the teacher-forced errors of the served path and of a whole-prompt
    loop against that loop (forced_check: Q8-L's control). Then
    step_profile (the decode step captured against eager, its device
    busy beside the byte bound of its weights, one replayed step
    bit-equal to the eager step). Returns the runs' bf16-q launches and
    the teacher-forced errors."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.parallel.pipeline import sync

    bf16 = torch.bfloat16
    cfg = cfg or llama.PRESETS["llama3-8b"]
    L = cfg.n_layer
    t0 = time.perf_counter()
    tree = llama.init(0, cfg, device=dev)
    prepared = from_jax_params(tree, cfg, dev, compute_dtype=bf16)
    del tree
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sync(dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(prepared))
    mm_bytes = sum(t.numel() * t.element_size() for t in _leaves(prepared)
                   if t.dtype == bf16)
    print(f"[llama] L-B weights: {n_bytes / 1e9:.2f} GB ({mm_bytes / 1e9:.2f} "
          f"GB of bf16 matmul weights) drawn on {dev} and prepared in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in LLAMA_PROMPTS]
    t0 = time.perf_counter()
    rows = [[] for _ in prompts]
    refs = [reference_greedy_cache(prepared, cfg, p, LLAMA_NEW, dev, "bf16",
                                   chunk=64, compute_dtype=bf16, step_rows=4,
                                   logits_out=r)
            for p, r in zip(prompts, rows)]
    print(f"[llama] L-B references (plain bf16-compute loops over a bf16 "
          f"cache, 64-token chunks) in {time.perf_counter() - t0:.1f} s; "
          f"smallest top-2 gap {min(min(g) for _, g in refs):.3e}",
          flush=True)
    chunks = sum(-(-len(p) // 64) for p in prompts)
    lb_info, counts = {}, {}
    for label, kv in (("L-B", {"info": lb_info}),
                      ("L-B-ilv", {"same_as": lb_info,
                                   "prefill_chunk_tokens": 64,
                                   "overlap": True})):
        run = serve_run(
            label, cfg, prepared, prompts, LLAMA_NEW, refs,
            [("cached_attention", "bf16"),
             ("paged_decode_attention", "bf16")],
            dev, card, exact=lambda steps: {
                ("cached_attention", "bf16"): L * chunks,
                ("paged_decode_attention", "bf16"): L * steps},
            tie=BF16_TIE, kv="paged", compute_dtype=bf16, **kv)
        counts = {name: {dt: counts.get(name, {}).get(dt, 0) + n
                         for dt, n in by.items()}
                  for name, by in run.items()}
    # [obs] at L-B: the daemon's dnn_tpu_mbu over the run (serve_run's
    # fresh tracker), in (0, 1]
    mbu, mfu, _ = lb_info.get("goodput") or (0.0, 0.0, 0.0)
    if dev.type == "cuda" and not (0.0 < mbu <= 1.0 and 0.0 < mfu <= 1.0):
        fail(f"[obs] L-B: dnn_tpu_mbu {mbu} or dnn_tpu_mfu {mfu} is not in "
             "(0, 1]")
    print(f"[obs] L-B: dnn_tpu_mbu {mbu:.4f}, dnn_tpu_mfu {mfu:.5f} over the "
          f"run (prefill and decode, the daemon's host gaps included); on "
          f"{card}", flush=True)
    t0 = time.perf_counter()
    run = phase_llama_4e(cfg, prepared, prompts, refs, dev, card)
    print(f"[llama] LH and LK wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    counts = {name: {dt: counts[name][dt] + n for dt, n in by.items()}
              for name, by in run.items()}
    forced = forced_check("llama", "L-B", cfg, prepared, prompts, refs, rows,
                          dev, kv="paged", compute_dtype=bf16)
    if dev.type == "cuda":
        walls = step_profile("llama", "L-B paged bf16", cfg, prepared,
                             prompts, dev, bit_check=True, kv="paged",
                             compute_dtype=bf16)
        bound_ms = mm_bytes / HBM_BYTES_PER_S * 1e3
        print(f"[llama] L-B decode step: {walls['captured device']:.3f} ms "
              f"device busy against the {bound_ms:.2f} ms byte bound of its "
              f"{mm_bytes / 1e9:.2f} GB of bf16 weights at 3.35 TB/s "
              f"({mm_bytes / walls['captured device'] / 1e9:.2f} TB/s); "
              f"captured wall {walls['captured']:.3f} ms, eager "
              f"{walls['eager']:.3f} ms; on {card}", flush=True)
    del prepared
    return counts, forced


# ----------------------------------------------------------------------
# ROADMAP item 4 d's second half: [quant], [lora], [beam], [embed]

QUANT_NEW = 16


def counted(dev, text: str) -> str:
    """`text` (a launch count the run was checked against) on the card;
    on the CPU, where a call launches no kernel, a note saying so."""
    return text if dev.type == "cuda" else "launches not counted on the CPU"


def main_exact(cfg, prompts, decode_kernel="paged_decode_attention",
               dt="f32"):
    """exact(steps) of a served run over `prompts` in 64-token chunks: K5
    once a layer a chunk, the decode kernel once a layer a step."""
    chunks = sum(-(-len(p) // 64) for p in prompts)
    return lambda steps: {("cached_attention", dt): cfg.n_layer * chunks,
                          (decode_kernel, dt): cfg.n_layer * steps}


def phase_quant(cfg, prepared, prompts, dev, card):
    """[quant] gpt2 with quantized weights (quant.py), each run with the
    launch counts zeroed just before and read just after, exact counts:
    Q8 A's daemon (paged f32 KV) with weights="int8" (the tree quantized
    once in LMServer), the four concurrent clients, 16 greedy tokens,
    every stream against the no-cache greedy loop over the same int8
    tree (A's near-tie rule); Q4 the tree quantized to packed int4
    (quantize_gpt(bits=4)) through the batcher over gRPC and through
    make_generate, against the no-cache loop over the int4 tree. As
    information: param_bytes at f32, int8 and int4, and each tree's
    decode step wall and device busy (step_profile). Returns the runs'
    launches."""
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.quant import param_bytes, quantize_gpt
    from dnn_tpu_torch.runtime.generate import make_generate

    L = cfg.n_layer
    t0 = time.perf_counter()
    q8 = quantize_gpt(prepared, bits=8)
    q4 = quantize_gpt(prepared, bits=4)
    sync(dev)
    sizes = {name: param_bytes(t) for name, t in
             (("f32", prepared), ("int8", q8), ("int4", q4))}
    print(f"[quant] gpt2 quantized on {dev} in "
          f"{time.perf_counter() - t0:.2f} s; param_bytes f32 "
          f"{sizes['f32']} ({sizes['f32'] / 1e6:.1f} MB), int8 "
          f"{sizes['int8']} ({sizes['int8'] / 1e6:.1f} MB, "
          f"{sizes['int8'] / sizes['f32']:.3f} of f32), int4 {sizes['int4']} "
          f"({sizes['int4'] / 1e6:.1f} MB, {sizes['int4'] / sizes['f32']:.3f}"
          f" of f32); on {card}", flush=True)
    t0 = time.perf_counter()
    refs8 = [reference_greedy(q8, cfg, p, QUANT_NEW, dev) for p in prompts]
    refs4 = [reference_greedy(q4, cfg, p, QUANT_NEW, dev) for p in prompts]
    print(f"[quant] references (no-cache greedy loops over the int8 and "
          f"int4 trees) in {time.perf_counter() - t0:.1f} s", flush=True)
    needed = [("cached_attention", "f32"), ("paged_decode_attention", "f32")]
    runs = [
        serve_run("Q8", cfg, prepared, prompts, QUANT_NEW, refs8, needed, dev,
                  card, exact=main_exact(cfg, prompts), kv="paged",
                  weights="int8"),
        serve_run("Q4", cfg, q4, prompts, QUANT_NEW, refs4, needed, dev, card,
                  exact=main_exact(cfg, prompts), kv="paged"),
    ]
    gen = make_generate(cfg, max_new_tokens=QUANT_NEW, device=dev)
    gen(q4, [prompts[3][:8]])  # warm-up
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = gen(q4, [prompts[3]])
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {("cached_attention", "f32"): L,
            ("decode_attention", "f32"): L * (QUANT_NEW - 1)}
    for (name, dt), n in want.items():
        if counts[name][dt] != n and dev.type == "cuda":
            fail(f"[quant] Q4 make_generate: {name} ({dt}) launched "
                 f"{counts[name][dt]} times, expected {n}")
    print(f"[quant] Q4 make_generate: {QUANT_NEW} tokens after a "
          f"{len(prompts[3])}-token prompt in {wall * 1e3:.1f} ms; "
          + counted(dev, f"launches exactly K5 {L}, K6 "
                    f"{L * (QUANT_NEW - 1)}"), flush=True)
    compare_tokens("[quant] Q4 make_generate", out[0].tolist(), *refs4[3])
    runs.append(counts)
    for label, tree in (("Q8 int8 weights, paged f32 KV", q8),
                        ("Q4 int4 weights, paged f32 KV", q4)):
        if dev.type == "cuda":
            step_profile("quant", label, cfg, tree, prompts, dev, kv="paged")
    return {name: {dt: sum(r[name][dt] for r in runs)
                   for dt in DTYPES}
            for name in CACHE_KERNELS}


def phase_quant_llama(cfg, qprep, prompts, dev, card):
    """[quant] Q8-L: llama3-8b at full width and depth with int8 weights
    (the f32 tree of [llama] quantized on the card, the f32 copy freed)
    in bf16 compute, L-B's daemon (paged bf16 pool) with
    weights="int8" -- the tree it is given is already quantized, and
    LMServer's quantize_gpt leaves a quantized tree as it is -- the four
    prompts, 16 greedy tokens each, exact launches (K5 grouped and K7 at
    R = 4, bf16 q). The run is held by teacher forcing (forced_check):
    the served path fed the plain bf16-compute loop's tokens (the same
    int8 tree, a bf16 cache prefilled in 64-token chunks), its logprobs
    against the loop's, the error at most FORCED_RATIO times L-B's
    (hold_forced, once L-B has run); each free-running stream's first
    parting from the loop is printed. Then step_profile: the decode step
    captured and eager, one replay bit-equal to the eager step. Returns
    the run's bf16-q launches and the teacher-forced errors."""
    from dnn_tpu_torch.models.gpt import for_compute
    from dnn_tpu_torch.quant import param_bytes

    bf16 = torch.bfloat16
    served = for_compute(qprep, bf16)
    n_bytes = param_bytes(served)
    q_bytes = sum(t.numel() * t.element_size() for t in _leaves(served)
                  if t.dtype == torch.int8)
    print(f"[quant] Q8-L llama3-8b int8 weights: {n_bytes / 1e9:.2f} GB "
          f"served ({q_bytes / 1e9:.2f} GB of int8 kernels); on {card}",
          flush=True)
    t0 = time.perf_counter()
    rows = [[] for _ in prompts]
    refs = [reference_greedy_cache(served, cfg, p, LLAMA_NEW, dev, "bf16",
                                   chunk=64, compute_dtype=bf16, step_rows=4,
                                   logits_out=r)
            for p, r in zip(prompts, rows)]
    print(f"[quant] Q8-L references (plain bf16-compute loops over the int8 "
          f"tree and a bf16 cache, 64-token chunks) in "
          f"{time.perf_counter() - t0:.1f} s; smallest top-2 gap "
          f"{min(min(g) for _, g in refs):.3e}", flush=True)
    counts = serve_run(
        "Q8-L", cfg, qprep, prompts, LLAMA_NEW, refs,
        [("cached_attention", "bf16"), ("paged_decode_attention", "bf16")],
        dev, card, exact=main_exact(cfg, prompts, dt="bf16"), tie=None,
        kv="paged", compute_dtype=bf16, weights="int8")
    forced = forced_check("quant", "Q8-L", cfg, qprep, prompts, refs, rows,
                          dev, kv="paged", compute_dtype=bf16)
    if dev.type != "cuda":
        return counts, forced
    walls = step_profile("quant", "Q8-L paged bf16, int8 weights", cfg, qprep,
                         prompts, dev, bit_check=True, kv="paged",
                         compute_dtype=bf16)
    print(f"[quant] Q8-L decode step: {walls['captured device']:.3f} ms "
          f"device busy against the {q_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms "
          f"byte bound of its {q_bytes / 1e9:.2f} GB of int8 kernels; "
          f"captured wall {walls['captured']:.3f} ms, eager "
          f"{walls['eager']:.3f} ms; on {card}", flush=True)
    return counts, forced


LORA_RANK, LORA_B_STD = 8, 0.02
# [lora]'s two waves: (prompt index, adapter index or None) per request;
# the second wave reassigns every slot's adapter
LORA_WAVES = (((0, 0), (1, 1), (2, 2), (3, None)),
              ((0, 2), (1, None), (2, 0), (3, 1)))


def lora_adapters(prepared, dev, n=3):
    """n rank-8 adapters on the default targets, drawn on the card from
    seeds: a as init_lora draws it, b ~ N(0, 0.02) (nonzero, so that each
    adapter changes the output)."""
    from dnn_tpu_torch.lora import init_lora

    out = []
    for s in range(n):
        ad = init_lora(100 + s, prepared, rank=LORA_RANK)
        g = torch.Generator(device=dev).manual_seed(200 + s)
        for ab in ad.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g,
                                  device=dev) * LORA_B_STD
        out.append(ad)
    return out


def lora_replay_check(cfg, prepared, ads, prompts, dev):
    """The batcher's captured decode step over the LoRA views, replayed
    bit-equal to the eager step before and after the slots' adapters are
    reassigned (the one-hot buffer written in place), with no second
    capture."""
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, block_len=16, kv="paged",
                          lora_adapters=ads, device=dev)
    graph = b._graph_step
    rids = [b.submit(prompts[i], 64, adapter=a)
            for i, a in ((0, 0), (1, 1), (2, None))]

    def bit_check(when):
        graph._graph.replay()
        graph._log.replayed()
        sync(dev)
        replayed = graph._logits.clone()
        eager = b._decode(b.cache, graph.tok, graph.pos, graph.active)
        sync(dev)
        if not torch.equal(replayed, eager):
            fail(f"[lora] {when}: a replayed step's logits differ from the "
                 f"eager step's by {(replayed - eager).abs().max().item():.3e}")

    for _ in range(3):
        b.step()
    bit_check("before the reassignment")
    b.cancel(rids[0])
    b.submit(prompts[3], 64, adapter=2)  # slot 0 now serves adapter 2
    b.step()
    bit_check("after the reassignment")
    if graph.captures != 1:
        fail(f"[lora] the decode step was captured {graph.captures} times, "
             "expected once across the reassignment")
    print(f"[lora] captured decode step: one capture, {graph.replays} "
          "replays across an adapter reassignment; a replay's logits equal "
          "the eager step's bit for bit before and after it", flush=True)


def lora_prefix_check(cfg, prepared, ads, prompts, refs, dev):
    """The dense pool's prefix LRU keys by (adapter, tokens): the 300-token
    prompt under adapter 1 twice (the second a hit: one chunk run), then
    under the base model (a miss: the same tokens under another adapter
    id); each stream against its reference."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, kv="dense", prefix_cache=8,
                          lora_adapters=ads, device=dev)
    p = prompts[3]
    seq = []
    for adapter in (1, 1, None):
        c0 = b.prefill_chunks_run
        rid = b.submit(p, QUANT_NEW, adapter=adapter)
        seq.append((adapter, b.drain()[rid].tolist(),
                    b.prefill_chunks_run - c0))
    stats = (b.prefix_hits, b.prefix_misses)
    print(f"[lora] dense pool, prefix LRU: the 300-token prompt under "
          f"adapters {[a for a, _, _ in seq]} ran "
          f"{[c for _, _, c in seq]} prompt chunks; hits/misses {stats}",
          flush=True)
    if stats != (1, 2) or [c for _, _, c in seq] != [5, 1, 5]:
        fail(f"[lora] prefix cache by adapter: hits/misses {stats}, chunks "
             f"{[c for _, _, c in seq]}; expected (1, 2) and [5, 1, 5]")
    if seq[1][1] != seq[0][1]:
        fail("[lora] the prefix hit's stream differs from the first run's")
    for adapter, toks, _ in seq:
        compare_tokens(f"[lora] dense prefix run, adapter {adapter}", toks,
                       *refs[(3, adapter)])


def phase_lora(cfg, prepared, prompts, dev, card):
    """[lora] gpt2 with three rank-8 adapters served per request (A's
    daemon, paged f32 pool, lora_adapters): two waves of four concurrent
    gRPC requests mixing a=0, a=1, a=2 and the base model (LORA_WAVES;
    the second reassigns every slot's adapter), the launch counts zeroed
    before the first wave and read after the second, exact (K5 12 a
    chunk, K7 12 a step); every stream against the no-cache greedy loop
    over merge_lora(base, adapter i) (A's near-tie rule); the decode
    step captured once for both waves. Then lora_replay_check and
    lora_prefix_check. Returns the runs' launches."""
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.lora import merge_lora
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    ads = lora_adapters(prepared, dev)
    t0 = time.perf_counter()
    merged = {a: (prepared if a is None else merge_lora(prepared, ads[a]))
              for a in (None, 0, 1, 2)}
    refs = {(i, a): reference_greedy(merged[a], cfg, prompts[i], QUANT_NEW,
                                     dev)
            for wave in LORA_WAVES for i, a in wave}
    del merged
    print(f"[lora] 3 adapters of rank {LORA_RANK} on every default target "
          f"({len(ads[0])} stacked sites); references (no-cache loops over "
          f"the merged trees) in {time.perf_counter() - t0:.1f} s", flush=True)
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, kv="paged", lora_adapters=ads)
    batcher = stop.servicer.batcher
    step, n_steps = batcher.step, [0]

    def counted_step():
        n_steps[0] += 1
        return step()

    batcher.step = counted_step
    streams = {}
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail("[lora] LM daemon never became healthy")
        client.generate(prompts[0], max_new_tokens=2, timeout=300)  # warm-up
        sync(dev)
        graph = batcher._graph_step
        caps0 = graph.captures if graph is not None else 0
        reset_counts()
        n_steps[0] = 0
        t0 = time.perf_counter()
        for wave in LORA_WAVES:
            errors, threads = [], []

            def call(i, a):
                try:
                    streams[i, a] = client.generate(
                        prompts[i], max_new_tokens=QUANT_NEW, adapter=a,
                        timeout=300).tolist()
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"request {i} adapter {a}: {e!r}")

            threads = [threading.Thread(target=call, args=ia) for ia in wave]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if errors or any(t.is_alive() for t in threads):
                fail(f"[lora] generate calls failed: {errors or 'timed out'}")
        wall = time.perf_counter() - t0
        counts = read_counts()
        steps = n_steps[0]
        captures = (graph.captures if graph is not None else 1) - caps0
        client.close()
    finally:
        stop()
    chunks = 2 * sum(-(-len(p) // 64) for p in prompts)
    want = {("cached_attention", "f32"): cfg.n_layer * chunks,
            ("paged_decode_attention", "f32"): cfg.n_layer * steps}
    if dev.type == "cuda":
        require("[lora] run", counts, list(want))
        for (name, dt), n in want.items():
            if counts[name][dt] != n:
                fail(f"[lora] {name} ({dt}) launched {counts[name][dt]} "
                     f"times, expected {n} ({steps} decode steps, {chunks} "
                     "chunks)")
        if captures != 0 or graph.captures != 1:
            fail(f"[lora] the decode step was captured {graph.captures} "
                 f"times ({captures} in the waves); expected once, at the "
                 "warm-up")
    n_tokens = sum(len(s) for s in streams.values())
    print(f"[lora] two waves of 4 requests (adapters "
          f"{[[a for _, a in w] for w in LORA_WAVES]}): {n_tokens} tokens in "
          f"{wall:.3f} s over {steps} decode steps"
          + (f", all replays of the one capture of the warm-up; launches "
             f"exactly K5 {want[('cached_attention', 'f32')]}, K7 "
             f"{want[('paged_decode_attention', 'f32')]}"
             if dev.type == "cuda" else "") + f"; on {card}", flush=True)
    for (i, a), toks in sorted(streams.items(), key=str):
        compare_tokens(f"[lora] prompt {len(prompts[i])} adapter {a}", toks,
                       *refs[i, a])
    if streams[0, 0] == streams[0, 2]:
        fail("[lora] adapters 0 and 2 gave one stream: the deltas change "
             "nothing")
    if dev.type == "cuda":
        lora_replay_check(cfg, prepared, ads, prompts, dev)
    lora_prefix_check(cfg, prepared, ads, prompts, refs, dev)
    return counts


BEAM_K, BEAM_NEW, BEAM_ALPHA = 4, 32, 0.6
BEAM_T = 130  # each row's prompt length: make_beam_generate takes one T


def beam_ids(prompts):
    """[beam]'s B = 2 rows: the 130-token main prompt, and the 70-token one
    followed by the 300-token prompt's tokens 70-129 (one T per call, as
    JAX's make_beam_generate takes)."""
    return np.asarray([prompts[2], prompts[1] + prompts[3][70:BEAM_T]],
                      np.int64)


def reference_beam(prepared, cfg, ids, n_new, k, eos, alpha, dev):
    """An independent beam search: each step recomputes the plain no-cache
    forward over every beam's whole sequence (prompt + history), sums f32
    log-softmax scores on the host, picks the top k of each row by a
    stable numpy sort (ties to the lower index), freezes beams at `eos`
    (continuation eos at 0) and orders by the GNMT length penalty.
    Returns (tokens (B, k, n_new), scores (B, k), the smallest score gap
    between ranks k-1 and k of any step)."""
    from dnn_tpu_torch.runtime.generate import forward_no_cache

    b_rows, v = ids.shape[0], cfg.vocab_size

    def logp(seqs):
        x = torch.as_tensor(np.asarray(seqs), dtype=torch.int64, device=dev)
        return torch.log_softmax(forward_no_cache(prepared, x, cfg=cfg)[
            :, -1].float(), dim=-1).cpu().numpy()

    lp = logp(ids)
    order = np.argsort(-lp, axis=1, kind="stable")
    top = order[:, :k]
    gap = float(np.min(np.take_along_axis(lp, order[:, k - 1:k], 1)
                       - np.take_along_axis(lp, order[:, k:k + 1], 1)))
    scores = np.take_along_axis(lp, top, 1)
    hist = [[[int(top[r, j])] for j in range(k)] for r in range(b_rows)]
    fin = (top == eos) if eos is not None else np.zeros(top.shape, bool)
    lens = np.ones(top.shape, np.int32)
    frozen = np.full((v,), -1e30, np.float32)
    if eos is not None:
        frozen[eos] = 0.0
    for _ in range(n_new - 1):
        lp = logp([list(ids[r]) + hist[r][j] for r in range(b_rows)
                   for j in range(k)]).reshape(b_rows, k, v)
        if eos is not None:
            lp = np.where(fin[:, :, None], frozen, lp)
        total = (scores[:, :, None] + lp).reshape(b_rows, k * v)
        order = np.argsort(-total, axis=1, kind="stable")
        top = order[:, :k]
        gap = min(gap, float(np.min(
            np.take_along_axis(total, order[:, k - 1:k], 1)
            - np.take_along_axis(total, order[:, k:k + 1], 1))))
        parent, tok = top // v, top % v
        scores = np.take_along_axis(total, top, 1)
        hist = [[hist[r][parent[r, j]] + [int(tok[r, j])] for j in range(k)]
                for r in range(b_rows)]
        fin = np.take_along_axis(fin, parent, 1)
        lens = np.take_along_axis(lens, parent, 1)
        if eos is not None:
            lens = np.where(fin, lens, lens + 1)
            fin = fin | (tok == eos)
        else:
            lens = lens + 1
    pen = (np.ones(lens.shape, np.float32) if alpha == 0.0 else
           ((np.float32(5.0) + lens.astype(np.float32)) / np.float32(6.0))
           ** np.float32(alpha))
    final = (scores / pen).astype(np.float32)
    order = np.argsort(-final, axis=1, kind="stable")
    toks = np.asarray(hist)[np.arange(b_rows)[:, None], order]
    return toks, np.take_along_axis(final, order, 1), gap


def phase_beam(cfg, prepared, prompts, dev, card, model="gpt2"):
    """[beam] gpt2 (seed-0 weights): make_beam_generate with K=4 beams over
    B=2 rows of 130 tokens (beam_ids), 32 new tokens, length penalty 0.6
    and an eos id the beams reach (the token at step 5 of the best beam
    of row 0 in a search without one), every beam's tokens and scores
    (within 1e-4) against reference_beam; exact launches: K5 once a
    layer for the prefill, K6 once a layer a step at 8 rows; beam_size 1
    equal to make_generate's greedy tokens; `node --generate 16 --beam 4`
    as a process (the `model` config, seed-0 random weights; None skips
    it) printing the library's best beam. Returns the main search's
    launches."""
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.beam import make_beam_generate
    from dnn_tpu_torch.runtime.generate import make_generate

    L = cfg.n_layer
    ids = beam_ids(prompts)
    plain = make_beam_generate(cfg, max_new_tokens=BEAM_NEW,
                               beam_size=BEAM_K, return_all=True, device=dev)
    eos = int(plain(prepared, ids)[0][0, 0, 5])
    beam = make_beam_generate(cfg, max_new_tokens=BEAM_NEW, beam_size=BEAM_K,
                              eos_id=eos, length_penalty=BEAM_ALPHA,
                              return_all=True, device=dev)
    beam(prepared, ids[:, :8])  # warm-up
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    toks, scores = beam(prepared, ids)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {("cached_attention", "f32"): L,
            ("decode_attention", "f32"): L * (BEAM_NEW - 1)}
    for (name, dt), n in want.items():
        if counts[name][dt] != n and dev.type == "cuda":
            fail(f"[beam] {name} ({dt}) launched {counts[name][dt]} times, "
                 f"expected {n}")
    toks, scores = toks.cpu().numpy(), scores.cpu().numpy()
    finished = int((toks == eos).any(axis=2).sum())
    print(f"[beam] K={BEAM_K} B=2 T={BEAM_T} {BEAM_NEW} new tokens, eos "
          f"{eos}, length penalty {BEAM_ALPHA}: {wall * 1e3:.1f} ms; "
          f"{finished} of {2 * BEAM_K} final beams reached eos; "
          + counted(dev, f"launches exactly K5 {L} (prefill), K6 "
                    f"{L * (BEAM_NEW - 1)} (8 rows a step)")
          + f"; on {card}", flush=True)
    if not finished:
        fail(f"[beam] no beam reached eos {eos}")
    t0 = time.perf_counter()
    rtoks, rscores, gap = reference_beam(prepared, cfg, ids, BEAM_NEW,
                                         BEAM_K, eos, BEAM_ALPHA, dev)
    print(f"[beam] reference (no-cache forward over whole sequences a step) "
          f"in {time.perf_counter() - t0:.1f} s; smallest gap at the top-"
          f"{BEAM_K} boundary {gap:.3e}", flush=True)
    if not np.array_equal(toks, rtoks):
        if gap >= NEAR_TIE:
            fail(f"[beam] tokens differ from the reference's (smallest "
                 f"boundary gap {gap:.3e})\nserved    {toks.tolist()}\n"
                 f"reference {rtoks.tolist()}")
        print(f"[beam] tokens part from the reference at a near-tie of its "
              f"selection (gap {gap:.3e} < {NEAR_TIE}); scores not compared",
              flush=True)
    else:
        err = float(np.abs(scores - rscores).max())
        if err > 1e-4:
            fail(f"[beam] scores differ from the reference's by {err:.3e}")
        print(f"[beam] every beam's tokens equal the reference's; scores "
              f"within {err:.2e} (best {scores[:, 0].tolist()})", flush=True)
    one = make_beam_generate(cfg, max_new_tokens=16, beam_size=1,
                             device=dev)(prepared, ids)
    greedy = make_generate(cfg, max_new_tokens=16, device=dev)(prepared, ids)
    if not torch.equal(one.cpu(), greedy.cpu()):
        fail(f"[beam] beam_size 1 {one.tolist()} != make_generate "
             f"{greedy.tolist()}")
    print("[beam] beam_size 1 equals make_generate's greedy tokens on both "
          "rows", flush=True)
    if model is not None:
        beam_node_process(cfg, prepared, prompts, dev, card, model)
    return counts


def beam_node_process(cfg, prepared, prompts, dev, card, model):
    """`node --generate 16 --beam 4` as a process: the gpt2 config with no
    model_weights (the seed-0 random init, the weights of the main path),
    the 70-token prompt; its printed tokens must equal the library's best
    beam."""
    import tempfile

    from dnn_tpu_torch.runtime.beam import make_beam_generate

    want = make_beam_generate(cfg, max_new_tokens=16, beam_size=BEAM_K,
                              device=dev)(prepared, [prompts[1]])[0].tolist()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpt2.json")
        with open(path, "w") as f:
            json.dump({"model": model, "num_parts": 1,
                       "device_type": dev.type,
                       "nodes": [{"id": "node1", "part_index": 0,
                                  "address": f"127.0.0.1:{free_port()}"}]},
                      f)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id",
             "node1", "--config", path, "--generate", "16", "--beam",
             str(BEAM_K), "--prompt_ids",
             ",".join(str(t) for t in prompts[1])],
            cwd=here, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": here})
    if proc.returncode != 0:
        fail(f"[beam] node --beam exited {proc.returncode}:\n"
             f"{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if "GENERATED TOKENS" in ln]
    got = [int(t) for t in line[-1].split(":")[1].strip(" *").split(",")]
    if got != want:
        fail(f"[beam] node --beam printed {got}, the library's best beam is "
             f"{want}")
    print(f"[beam] node --generate 16 --beam {BEAM_K} as a process "
          f"({time.perf_counter() - t0:.1f} s) printed the library's best "
          f"beam {got[:8]}...", flush=True)


EMBED_T = 320  # the four prompts (5/70/130/300 tokens) padded to 5 chunks


def reference_hidden(prepared, cfg, ids):
    """The plain stateless forward's final-normed hidden states: the
    blocks with reference_attention (use_flash=False), then ln_f."""
    from dnn_tpu_torch.models import gpt
    from dnn_tpu_torch.ops.nn import layer_norm

    with torch.no_grad():
        x = gpt.embed(prepared, ids, cfg=cfg)
        x = gpt.blocks_scan(prepared["blocks"], x, cfg=cfg, use_flash=False)
        return layer_norm(prepared["ln_f"], x.float(), eps=cfg.ln_eps)


def phase_embed(cfg, prepared, prompts, dev, card):
    """[embed] gpt2: make_embed with pooling mean, last and none over the
    four prompts padded to 320 tokens (B=4), each within 1e-4 of the
    output's scale of the plain forward's (reference_hidden, pooled by
    the true lengths), exactly K1 once a layer a call; then A's daemon:
    embed and embed:last for each prompt over gRPC, each reply bit-equal
    to the library's call on the daemon's padding (a prompt_pad
    multiple), K1 once a layer a request. Returns the launches."""
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.runtime.embeddings import make_embed
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    L = cfg.n_layer
    ids = torch.zeros((4, EMBED_T), dtype=torch.int64, device=dev)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = torch.tensor(p, device=dev)
    lengths = torch.tensor([len(p) for p in prompts], device=dev)
    h = reference_hidden(prepared, cfg, ids)
    mask = (torch.arange(EMBED_T, device=dev)[None, :]
            < lengths[:, None]).float()
    refs = {"none": h,
            "mean": (h * mask[..., None]).sum(1) / lengths[:, None].float(),
            "last": h[torch.arange(4, device=dev), lengths - 1]}
    total = None
    for pooling in ("mean", "last", "none"):
        fn = make_embed(cfg, pooling=pooling)
        fn(prepared, ids[:, :64], lengths.clamp(max=64))  # warm-up
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        out = fn(prepared, ids, lengths)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
        total = counts if total is None else {
            n: {d: total[n][d] + c for d, c in by.items()}
            for n, by in counts.items()}
        launched = {(n, d): c for n, by in counts.items()
                    for d, c in by.items() if c}
        if launched != {("flash_attention", "f32"): L} and \
                dev.type == "cuda":
            fail(f"[embed] {pooling}: launches {launched}, expected "
                 f"flash_attention f32 {L} only")
        want = refs[pooling]
        if pooling == "none":  # rows past each length are padding
            out, want = out * mask[..., None], want * mask[..., None]
        err = (out - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        if not err <= 1e-4 * scale:
            fail(f"[embed] {pooling}: max abs err {err:.3e} > 1e-4 x "
                 f"{scale:.3f} against the plain forward")
        print(f"[embed] make_embed {pooling} B=4 T={EMBED_T}: {tuple(out.shape)}"
              f" in {wall * 1e3:.2f} ms, err {err:.3e} (scale {scale:.2f}) "
              f"against the plain forward; "
              + counted(dev, f"K1 exactly {L}") + f"; on {card}",
              flush=True)
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, kv="paged")
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail("[embed] LM daemon never became healthy")
        client.send_tensor(np.asarray(prompts[0], np.int32),
                           request_id="embed")  # warm-up
        sync(dev)
        reset_counts()
        replies = {}
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            for rid in ("embed", "embed:last"):
                status, vec = client.send_tensor(np.asarray(p, np.int32),
                                                 request_id=rid, timeout=120)
                replies[i, rid] = (status, vec)
        wall = time.perf_counter() - t0
        counts = read_counts()
        client.close()
    finally:
        stop()
    n_calls = len(replies)
    if counts["flash_attention"]["f32"] != L * n_calls and \
            dev.type == "cuda":
        fail(f"[embed] daemon: K1 launched "
             f"{counts['flash_attention']['f32']} times for {n_calls} "
             f"requests, expected {L * n_calls}")
    for (i, rid), (status, vec) in replies.items():
        t = len(prompts[i])
        padded = torch.zeros((1, -(-t // 64) * 64), dtype=torch.int64,
                             device=dev)
        padded[0, :t] = torch.tensor(prompts[i], device=dev)
        lib = make_embed(cfg, pooling="last" if rid.endswith("last")
                         else "mean")(prepared, padded, [t])[0].cpu()
        if status != f"[lm] ok: embedding dim {cfg.n_embd}" or \
                not torch.equal(vec.float(), lib):
            fail(f"[embed] daemon {rid} prompt {t}: {status!r}, reply "
                 f"differs from the library's by "
                 f"{(vec.float() - lib).abs().max().item():.3e}")
    print(f"[embed] daemon: {n_calls} embed / embed:last replies over gRPC "
          f"in {wall * 1e3:.1f} ms, each bit-equal to the library's; "
          + counted(dev, f"K1 exactly {L} a request") + f"; on {card}",
          flush=True)
    return {n: {d: total[n][d] + c for d, c in by.items()}
            for n, by in counts.items()}


BEAM_S = BEAM_T + BEAM_NEW  # the beams' dense cache
BEAM_K6_SAMPLES = 5


def phase_beam_embed_kernels(dev, gen):
    """K6 at the beam search's decode shape (B*K=8 rows, Hk=12, R=1, D=64,
    a 162-column cache at pos 161: the last step), an f32 q over an f32
    cache and a bf16 q over a bf16 cache; K1 at the embed shape (B=4,
    H=12, T=S=320, D=64, causal) in f32 and bf16. Each against its plain
    version, timed beside its bound and SDPA. Returns {shape: {label:
    row}}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        decode_attention, reference_decode_attention)
    from dnn_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, reference_attention)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Hk, D, S = 2 * BEAM_K, 12, 64, BEAM_S
    decode_plan("K6 beam", B * Hk, S)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    out = {"K6 beam": {}, "K1 embed": {}}
    for label, qdt, cdt in (("f32", torch.float32, "f32"),
                            ("bf16 q", torch.bfloat16, "bf16")):
        q = torch.randn(LAYERS, B, Hk, 1, D, generator=gen,
                        device=dev).to(qdt)
        k, v, _, _ = kv_cache(gen, (LAYERS, B, Hk, S, D), cdt, dev)
        got = decode_attention(q[0], k[0], v[0], pos)
        want = reference_decode_attention(q[0], k[0], v[0], pos)
        err = (check(f"K6 beam {label}", got, want, F32_TOL)
               if label == "f32" else
               check_scaled(f"K6 beam {label}", got, want, BF16_TOL))
        el = 4 if label == "f32" else 2
        nbytes = 2 * B * Hk * D * el + Hk * kv_bytes(cdt, B * S, D) + B * 4
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, 4 * D * Hk * B * S)
        # the kernel and SDPA within a few percent of each other here:
        # each the median of BEAM_K6_SAMPLES timings, interleaved
        ms, lib = [], []
        for _ in range(BEAM_K6_SAMPLES):
            ms.append(time_ms(cycling(lambda i: decode_attention(
                q[i], k[i], v[i], pos), LAYERS)))
            lib.append(time_ms(cycling(lambda i: sdpa(q[i], k[i], v[i]),
                                       LAYERS)))
        row = out["K6 beam"][label] = dict(
            ms=float(np.median(ms)),
            plain_ms=time_ms(cycling(lambda i: reference_decode_attention(
                q[i], k[i], v[i], pos), LAYERS)),
            library_ms=float(np.median(lib)), bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err)
        report("K6 beam", f"{label:6s} B*K={B} S={S} pos {S - 1}", row,
               nbytes, byte_ms, op_ms)
        print(f"[K6 beam] {label:6s} {BEAM_K6_SAMPLES} timings, kernel "
              f"{', '.join(f'{t:.5f}' for t in ms)} ms, SDPA "
              f"{', '.join(f'{t:.5f}' for t in lib)} ms: the kernel "
              f"{row['ms'] / row['library_ms']:.3f}x SDPA (medians)",
              flush=True)
    for name, dt, tol in FLASH_TYPES:
        q, k, v = (torch.randn(4, 12, EMBED_T, 64, generator=gen,
                               device=dev).to(dt) for _ in range(3))
        err = check(f"K1 embed {name}", flash_attention(q, k, v).float(),
                    reference_attention(q.float(), k.float(), v.float()),
                    tol)
        b = flash_fwd_bound(dt == torch.float32, 48, EMBED_T, EMBED_T, 64,
                            False)
        row = out["K1 embed"][name] = dict(
            ms=time_ms(lambda: flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: reference_attention(q, k, v)),
            library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True)),
            bound_ms=b["bound_ms"], bound_by=b["bound_by"], max_abs_err=err)
        flash_report("K1 embed", f"{name:4s} B=4 H=12 T=S={EMBED_T} D=64 "
                     "causal", row, b)
    return out


def phase_item_4d(cfg, prepared, prompts, dev, card, model="gpt2"):
    """[quant], [lora], [beam] and [embed] on the main path's gpt2 (the
    zoo's `model`: phase_beam's process); each phase's wall printed.
    Returns the launches of all their runs."""
    runs = []
    for tag, fn in (("quant", phase_quant), ("lora", phase_lora),
                    ("beam", lambda *a: phase_beam(*a, model=model)),
                    ("embed", phase_embed)):
        t0 = time.perf_counter()
        runs.append(fn(cfg, prepared, prompts, dev, card))
        print(f"[{tag}] phase wall {time.perf_counter() - t0:.1f} s",
              flush=True)
    out = {}
    for r in runs:
        for name, by in r.items():
            for dt, n in by.items():
                out.setdefault(name, {}).setdefault(dt, 0)
                out[name][dt] += n
    return out


# ----------------------------------------------------------------------
# sliding windows, logit softcaps and head dim 256 (ROADMAP item 2's
# bands and rings, the softcaps, Gemma's D = 256): [K5 band], [K6 band],
# [K7 band], [D256]; [mistral], [gemma2], [gemma]

WIN = 4096                 # mistral-7b's and gemma2-9b's sliding window
WIN_SLOTS, WIN_MAX_LEN, WIN_PAD, WIN_BP = 2, 4608, 512, 16
WIN_PROMPTS = (4150, 4290)  # mistral-7b: both streams past the window
G2_PROMPTS = (4200, 1000)  # gemma2-9b: one stream past the window
WIN_NEW = 32
G1_NEW, G1_SOLO_NEW = 16, 32  # gemma-2b on the main path's prompts
# the kernel rows: (key, kernel, shape, band / cap), each with an f32 and
# a bf16 q (WIN_Q). The shapes are the
# served ones: mistral-7b's last prefill chunk (rows 4096.. of a 4608
# row: every row bands) and its decode step on both pools at the
# streams' last positions; gemma2-9b's even (banded, soft-capped) layer
# at the same chunk and step; gemma-2b's chunk (G = 8 over one KV head),
# its paged step (R = 8) and its solo step (R = 8, the 300-token prompt
# plus 32 tokens)
WIN_ROWS = (
    ("K5 band", "K5", dict(B=1, H=32, HK=8, T=WIN_PAD, S=WIN_MAX_LEN, D=128,
                           base=WIN), dict(window=WIN)),
    ("K6 band", "K6", dict(B=2, HK=8, R=4, S=WIN_MAX_LEN, D=128,
                           pos=(4181, 4321)), dict(window=WIN)),
    ("K7 band", "K7", dict(B=2, HK=8, R=4, bp=WIN_BP,
                           nb=WIN_MAX_LEN // WIN_BP, D=128, pos=(4181, 4321)),
     dict(window=WIN)),
    ("K5 D256 gemma2", "K5", dict(B=1, H=16, HK=8, T=WIN_PAD, S=WIN_MAX_LEN,
                                  D=256, base=WIN),
     dict(window=WIN, softcap=50.0)),
    ("K6 D256 gemma2", "K6", dict(B=2, HK=8, R=2, S=WIN_MAX_LEN, D=256,
                                  pos=(4231, 1031)),
     dict(window=WIN, softcap=50.0)),
    ("K5 D256 gemma", "K5", dict(B=1, H=8, HK=1, T=64, S=1024, D=256,
                                 base=960), {}),
    ("K7 D256 gemma", "K7", dict(B=4, HK=1, R=8, bp=16, nb=64, D=256,
                                 pos=(0, 15, 16, 1023)), {}),
    ("K6 D256 gemma solo", "K6", dict(B=1, HK=1, R=8, S=332, D=256,
                                      pos=(330,)), {}),
)


# the rows held at an int4 cache too: one banded, one at D = 256 (the
# card tests hold every variant at int4)
WIN_INT4 = ("K7 band", "K5 D256 gemma")


def band_lo(limit: int, window) -> int:
    """The first live column of a row whose causal limit is `limit`."""
    return 0 if window is None else max(0, limit - window + 1)


# A softcapped row is checked on two draws of q: at unit scale, where the
# band's control is read (the softmax spreads over many keys, so dropping
# the band moves every row), and SOFTCAP_Q_SCALE[q type] times wider, where
# the cap's is: its scores (then about N(0, 4) / N(0, 16)) reach the part
# of cap * tanh(s / cap) that bends at cap 50 (with unit scores the cap
# moved the output by less than the tolerance). An f32 q stays at 2x,
# where the f32 rounding of the wider scores sits well inside 1e-4; a bf16
# q's tolerance scales with the output, so the cap must move more of it
SOFTCAP_Q_SCALE = {"f32": 2.0, "bf16": 4.0}
WIN_Q = ("f32", "bf16")  # the q types of WIN_ROWS: f32 compute, bf16


def check_rel(label: str, got, want, tol: float) -> float:
    """check() for a bf16 output, relative to the output's own scale (its
    largest |value|, no floor): within `tol` of it. Returns the error."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not math.isfinite(err) or err > tol * scale:
        fail(f"{label}: max abs err {err} > {tol} x {scale:.4f}")
    return err


def phase_window_kernels(dev, gen):
    """[K5 band], [K6 band], [K7 band], [D256]: each row of WIN_ROWS
    against its plain version with the same band and cap, with an f32 q
    (f32 compute: [gemma], W-f32) and a bf16 q (bf16 compute: [mistral]'s
    bf16 legs, [gemma2]) over f32, bf16 and int8 caches. An f32 q is held
    within F32_TOL (1e-4) absolute for every cache type; a bf16 q (the
    output bf16 on both sides) within BF16_TOL (2e-2) of the output's
    largest |value|, no floor. Controls, in the same call: the plain
    version without the band (on q at unit scale) and without the cap
    (on the wider q of SOFTCAP_Q_SCALE) must miss the kernel's output by
    more than the tolerance just applied, so that a kernel which skipped
    either would fail. Each case is timed (on the unit-scale q) beside
    its plain version, its bound and, where one PyTorch call computes
    the same function on the same inputs (SDPA with the band as an
    explicit boolean mask and enable_gqa; a float cache of q's own type,
    no softcap), that call. The bound counts the bytes inside each row's
    band only: q and the output in q's type, the KV heads' columns from
    the lowest first live column to the highest limit (K7: their blocks
    and table entries; the blocks wholly before the band, whose entries
    point at the junk block as a windowed pool reclaims them, are never
    read), int8 scales; or the products over the live scores (K5: at its
    cache type's fastest tensor-core rate, as k5_bound; K6/K7: f32
    FMAs). The launch variants, and the bf16-q count, are checked on
    every call. Returns {key: {q type: {cache type: row}}}."""
    from dnn_tpu_torch.ops.cuda import cached_attention as tca

    fn_names = {"K5": "cached_attention", "K6": "decode_attention",
                "K7": "paged_decode_attention"}
    out = {}
    for key, kernel, shp, kw in WIN_ROWS:
        d, window, cap = shp["D"], kw.get("window"), kw.get("softcap")
        tag = "D256" if d == 256 else key
        variants = (("band",) if window else ()) + (
            ("softcap",) if cap else ()) + (("d256",) if d == 256 else ())
        fn = getattr(tca, fn_names[kernel])
        plain_fn = getattr(tca, "reference_" + fn_names[kernel])
        b = shp["B"]
        if kernel == "K5":
            h, hk, t, s_len, base = (shp[x] for x in ("H", "HK", "T", "S",
                                                      "base"))
            q_shape, kv_shape = (LAYERS, b, h, t, d), (LAYERS, b, hk, s_len, d)
            pos = torch.full((b,), base, dtype=torch.int32, device=dev)
            limits = [min(s_len - 1, base + r) for r in range(t)]
            los = [band_lo(base + r, window) for r in range(t)]
            scores = b * h * sum(L - lo + 1 for L, lo in zip(limits, los))
            kv_cols = b * hk * (max(limits) - min(los) + 1)
            extra_bytes, flops = b * 4, 4 * d * scores
            shape = f"B={b} H={h} Hk={hk} T={t} S={s_len} base {base}"
            lim = base + torch.arange(t, device=dev)[:, None]
            mask = tca.band_keep(torch.arange(s_len, device=dev)[None, :],
                                 lim, window)
        else:
            hk, r, pos_list = shp["HK"], shp["R"], shp["pos"]
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            q_shape = (LAYERS, b, hk, r, d)
            s_len = shp["S"] if kernel == "K6" else shp["nb"] * shp["bp"]
            live = [min(p, s_len - 1) - band_lo(p, window) + 1
                    for p in pos_list]
            extra_bytes, flops = b * 4, 4 * d * hk * r * sum(live)
            if kernel == "K6":
                kv_shape = (LAYERS, b, hk, s_len, d)
                shape = f"B={b} Hk={hk} R={r} S={s_len} pos {pos_list}"
                mask = tca.band_keep(
                    torch.arange(s_len, device=dev)[None, :],
                    pos[:, None].long(), window)[:, None, None, :]
            else:
                bp, nb = shp["bp"], shp["nb"]
                n_blocks = b * nb + 1
                kv_shape = (LAYERS, n_blocks, hk, bp, d)
                perm = torch.randperm(
                    n_blocks - 1,
                    generator=torch.Generator().manual_seed(1)) + 1
                tables = perm[:b * nb].reshape(b, nb).to(torch.int32)
                for row, p in enumerate(pos_list):  # reclaimed blocks
                    tables[row, :band_lo(p, window) // bp] = 0
                tables = tables.to(dev)
                extra_bytes += 4 * sum(p // bp - band_lo(p, window) // bp + 1
                                       for p in pos_list)
                shape = (f"B={b} Hk={hk} R={r} bp={bp} nb_max={nb} pos "
                         f"{pos_list}")
        out[key] = {}
        for qn, name in ((qn, name) for qn in WIN_Q for name, _ in KV_CASES
                         if name != "int4" or key in WIN_INT4):
            qdt = torch.float32 if qn == "f32" else torch.bfloat16
            q_bytes = 4 if qn == "f32" else 2
            k, v, ks, vs = kv_cache(gen, kv_shape, name, dev)
            lead = (pos,) if kernel != "K7" else (tables, pos)

            def call(i, q, f=fn, **over):
                return f(q[i], k[i], v[i], *lead, **scales_at(ks, vs, i),
                         **{**kw, **over})

            label = f"[{tag}] {key} {qn} q {name}"
            draws = [(1.0, ("band",) if window else ())]
            if cap:
                draws.append((SOFTCAP_Q_SCALE[qn], ("softcap",)))
            err, controls, tol_said = 0.0, {}, []
            for widen, controlled in draws:
                q = (widen * torch.randn(*q_shape, generator=gen,
                                         device=dev)).to(qdt)
                before = (read_variants(), read_counts(bf16_q=True))
                got = call(0, q)
                after = (read_variants(), read_counts(bf16_q=True))
                if dev.type == "cuda":
                    fname = fn_names[kernel]
                    for var in ("band", "softcap", "d256"):
                        n = (after[0][fname][var][name]
                             - before[0][fname][var][name])
                        if n != (var in variants):
                            fail(f"{label}: {var} launches {n}, expected "
                                 f"{int(var in variants)}")
                    n = after[1][fname][name] - before[1][fname][name]
                    if n != (qn == "bf16"):
                        fail(f"{label}: bf16-q launches {n}, expected "
                             f"{int(qn == 'bf16')}")
                want = call(0, q, plain_fn)
                if qn == "f32":
                    err = max(err, check(f"{label} q x{widen:g}", got, want,
                                         F32_TOL))
                    tol = F32_TOL
                else:
                    err = max(err, check_rel(f"{label} q x{widen:g}", got,
                                             want, BF16_TOL))
                    tol = BF16_TOL * want.float().abs().max().item()
                tol_said.append(f"q x{widen:g} tol {tol:.3e}")
                for var in controlled:
                    over = {"window": None} if var == "band" else {
                        "softcap": None}
                    miss = (got.float() - call(0, q, plain_fn, **over)
                            .float()).abs().max().item()
                    controls[var] = miss
                    if not miss > tol:
                        fail(f"{label} q x{widen:g}: the plain version "
                             f"without the {var} misses the kernel by "
                             f"{miss:.3e}, within the tolerance {tol:.3e}: "
                             f"the check cannot tell the {var} from its "
                             "absence")
                if widen == 1.0:
                    q_unit = q
            lib_fn = None
            if qn == name and not cap and kernel != "K7":
                qh = (q_unit if kernel == "K5"
                      else q_unit.reshape(LAYERS, b, hk * r, 1, d))

                def lib_fn(i):
                    return sdpa_gqa(qh[i], k[i], v[i], mask)
            kv_read = (kv_bytes(name, kv_cols, d) if kernel == "K5" else
                       hk * sum(kv_bytes(name, n, d) for n in live))
            nbytes = (2 * math.prod(q_shape[1:]) * q_bytes + extra_bytes
                      + kv_read)
            peak = (F32_FLOPS_PER_S if kernel != "K5" else
                    TF32_FLOPS_PER_S if name == "f32" else BF16_FLOPS_PER_S)
            b_ms, b_by, byte_ms, op_ms = bound(nbytes, flops, peak)
            row = dict(
                ms=time_ms(cycling(lambda i: call(i, q_unit), LAYERS)),
                plain_ms=time_ms(cycling(
                    lambda i: call(i, q_unit, plain_fn), LAYERS)),
                library_ms=(None if lib_fn is None
                            else time_ms(cycling(lib_fn, LAYERS))),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            out[key].setdefault(qn, {})[name] = row
            report(tag, f"{key} {qn} q {name:4s} {shape} {kw or ''} ("
                   + ", ".join(tol_said)
                   + "".join(f"; without the {var} {m:.3e}"
                             for var, m in controls.items())
                   + ")", row, nbytes, byte_ms, op_ms,
                   "TF32 ops" if peak == TF32_FLOPS_PER_S
                   else "bf16 ops" if peak == BF16_FLOPS_PER_S else "f32 ops")
            del q, q_unit, k, v, ks, vs
    return out


def window_ref_logits(prepared, cfg, ids, rows, dev, kv_dtype=None,
                      compute_dtype=None, band=True):
    """The independent plain banded recompute: one no-cache forward of
    ids (1, T) through the LLaMA family's own blocks (models/llama.py's
    norms, projections, RoPE and residuals) with an attention written
    here — scores in f32 over K/V stored as the served cache stores them
    (`kv_dtype` "bf16": rounded to bf16; "int8": quantized with the
    port's _quantize_rows and dequantized; None: as computed), /
    sqrt(D), Gemma-2's softcap, the layer's band (its alternating window
    or the config's; none with `band` False: the control), softmax, P.V
    — in query blocks of 1024 rows; no cache, no batcher, no kernel.
    Returns the f32 logits (len(rows), V) of the positions `rows` (the
    final softcap included)."""
    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.models.gpt import layer_params
    from dnn_tpu_torch.ops.attention import merge_heads
    from dnn_tpu_torch.ops.cuda.cached_attention import band_keep, soft_cap
    from dnn_tpu_torch.ops.nn import linear
    from dnn_tpu_torch.runtime.kvcache import _quantize_rows

    cdt = compute_dtype
    t = ids.shape[1]
    positions = torch.arange(t, device=dev)
    wins = llama.layer_windows(cfg)

    def stored(x):
        if kv_dtype == "bf16":
            return x.to(torch.bfloat16).float()
        if kv_dtype == "int8":
            xq, sc = _quantize_rows(x)
            return xq.float() * sc[..., None]
        return x.float()

    with torch.no_grad():
        x = llama._scaled_embed(prepared, ids, cfg)
        x = x if cdt is None else x.to(cdt)
        cos, sin = llama._rope_tables(cfg, positions)
        for i in range(cfg.n_layer):
            bp = layer_params(prepared["blocks"], i)
            h = llama._pre_normed(bp, x, cfg)
            q, k, v = llama._qkv(bp, h, cfg, cdt)
            q, k = llama._rotated(q, k, cos, sin, cfg)
            k, v = stored(k), stored(v)  # (1, Hk, T, D)
            window = None if not band else (
                wins[i] if wins is not None else cfg.sliding_window)
            hk, d = k.shape[1], k.shape[-1]
            qg = q.float().reshape(1, hk, -1, t, d)
            y = torch.empty_like(qg)
            for r0 in range(0, t, 1024):
                r1 = min(t, r0 + 1024)
                s = torch.einsum("bkgtd,bksd->bkgts", qg[:, :, :, r0:r1],
                                 k) / math.sqrt(d)
                s = soft_cap(s, cfg.attn_softcap)
                keep = band_keep(positions[None, :],
                                 positions[r0:r1, None], window)
                p = torch.softmax(torch.where(keep, s, -1e30), dim=-1)
                y[:, :, :, r0:r1] = torch.einsum("bkgts,bksd->bkgtd", p, v)
            y = y.reshape(1, -1, t, d)
            o = linear(bp["attn"]["o"], merge_heads(y.to(x.dtype)),
                       compute_dtype=cdt)
            x = llama._branches_residual(bp, x, o, h, cfg=cfg,
                                         compute_dtype=cdt)
        sel = torch.as_tensor(list(rows), device=dev)
        return llama.head(prepared, x[:, sel].float(), cfg=cfg,
                          compute_dtype=cdt)[0]


# a bf16 stream may part from the banded recompute at near-ties only, and
# at no more than this share of its steps (the most seen on an H100 was
# 4 of 32)
WIN_MAX_PARTING_SHARE = 0.25
# the control of a [mistral] bf16 stream, the same recompute without the
# band, must miss the served tokens by more than this many times the
# banded recompute does (the largest logprob gap of a served token to the
# argmax). On an H100 80GB HBM3 at 700 W: banded 0.05-0.16, unbanded
# 2.0-4.6, 18-28 of 32 tokens not its argmax
WIN_CONTROL_BF16 = 4


def hold_forced_stream(tag, label, prepared, cfg, prompt, stream, dev, tie,
                       hold_control=False, **ref):
    """Teacher forcing of one served stream: window_ref_logits over the
    prompt and the stream (but its last token) gives, at every step, the
    reference's next-token logits after the served prefix; each served
    token must be their argmax unless their top-2 gap is below `tie`
    (then the step is a near-tie and the rest is still checked, each
    step on the served prefix), and near-ties may part at no more than
    WIN_MAX_PARTING_SHARE of the steps. Where the stream reaches past
    the window, the same recompute without the band (the control) is
    read beside it: how often and how far the served tokens miss its
    argmax. With `hold_control` that miss must exceed WIN_CONTROL_BF16
    times the banded recompute's (a run without the band would fail
    this check); without, it is information (gemma2-9b's final softcap
    leaves its argmax where the band moves the logits). Returns the
    number of near-tie partings."""
    p = len(prompt)
    ids = torch.tensor([list(prompt) + list(stream[:-1])], device=dev)
    rows = range(p - 1, p - 1 + len(stream))

    def regret(logits):
        """(argmax ids, the served tokens' largest logprob gap to it)."""
        lsm = torch.log_softmax(logits, dim=-1)
        chosen = lsm[torch.arange(len(stream), device=dev),
                     torch.tensor(stream, device=dev)]
        return (logits.argmax(dim=-1).tolist(),
                (lsm.max(dim=-1).values - chosen).max().item())

    logits = window_ref_logits(prepared, cfg, ids, rows, dev, **ref)
    top2 = torch.topk(logits, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    arg, lp_err = regret(logits)
    partings = []
    for j, (a, want) in enumerate(zip(stream, arg)):
        if a != want:
            if gaps[j] >= tie:
                fail(f"[{tag}] {label} (prompt {p}) step {j}: served {a}, "
                     f"the banded recompute's argmax {want} (top-2 gap "
                     f"{gaps[j]:.3e} >= {tie})")
            partings.append((j, gaps[j]))
    if len(partings) > WIN_MAX_PARTING_SHARE * len(stream):
        fail(f"[{tag}] {label} (prompt {p}): {len(partings)} near-tie "
             f"partings of {len(stream)} steps, more than "
             f"{WIN_MAX_PARTING_SHARE:.0%}: {partings}")
    said = ""
    window = cfg.sliding_window
    if window is not None and p + len(stream) - 2 >= window:
        c_arg, c_err = regret(window_ref_logits(prepared, cfg, ids, rows, dev,
                                                band=False, **ref))
        said = (f"; control, the recompute without the band: "
                f"{sum(a != w for a, w in zip(stream, c_arg))} served tokens "
                f"not its argmax, largest logprob gap {c_err:.3e}")
        if hold_control and not c_err > WIN_CONTROL_BF16 * lp_err:
            fail(f"[{tag}] {label} (prompt {p}){said}: not above "
                 f"{WIN_CONTROL_BF16} x the banded recompute's {lp_err:.3e}")
    print(f"[{tag}] {label} (prompt {p}, {len(stream)} tokens): "
          + ("every token the banded recompute's argmax" if not partings
             else f"near-tie partings {partings}")
          + f"; smallest top-2 gap {min(gaps):.3e}; the served tokens' "
          f"largest logprob gap to the argmax {lp_err:.3e}{said}",
          flush=True)
    return len(partings)


def window_run(tag, label, cfg, prepared, prompts, n_new, dev, card, exact,
               window=None, **kv):
    """One served run of [mistral] / [gemma2]: the LM daemon in-process
    (start_lm_server_in_background: WIN_SLOTS slots, max_len WIN_MAX_LEN,
    prompt_pad WIN_PAD, blocks of WIN_BP, the options `kv`), the prompts
    as concurrent greedy gRPC generate calls, the launch counts zeroed
    just before and read just after. `exact(steps)` gives {(kernel, dtype
    or variant): launches} the run must show exactly; under bf16 compute
    every cache-kernel launch took a bf16 q. A windowed paged pool's
    reclaimed blocks are read as each request's slot is released: they
    must equal floor((limit - window + 1) / block_len), limit the last
    attend limit. Returns (streams, counts by dtype, steps)."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    # an earlier batcher's CUDA graphs sit in reference cycles: collected
    # now, not by a collection that some allocation triggers while this
    # daemon's worker captures (destroying a graph during a capture
    # invalidates it)
    gc.collect()
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=WIN_SLOTS, max_len=WIN_MAX_LEN,
        prompt_pad=WIN_PAD, block_len=WIN_BP, seed=0, device=dev, **kv)
    batcher = stop.servicer.batcher
    step, n_steps, freed = batcher.step, [0], []
    release = batcher._release

    def counted_step():
        n_steps[0] += 1
        return step()

    def logged_release(slot):
        req = batcher._slot_req[slot]
        if req is not None and "pending" not in req:
            freed.append((req["prompt_len"],
                          req["prompt_len"] + len(req["emitted"]) - 1,
                          req["freed"], len(req["blocks"])))
        return release(slot)

    batcher.step, batcher._release = counted_step, logged_release
    results, errors = {}, []
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=120):
            fail(f"[{tag}] {label}: LM daemon never became healthy")
        client.generate(prompts[0][:40], max_new_tokens=2, timeout=600)
        sync(dev)
        reset_counts()
        n_steps[0] = 0
        freed.clear()

        def call(i):
            try:
                results[i] = client.generate(prompts[i], max_new_tokens=n_new,
                                             timeout=600).tolist()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        sync(dev)
        counts, variants = read_counts(), read_variants()
        counts_bf16_q = read_counts(bf16_q=True)
        steps = n_steps[0]
        client.close()
    finally:
        stop()
    if errors or len(results) != len(prompts):
        fail(f"[{tag}] {label}: generate calls failed: "
             f"{errors or 'timed out'}")
    graph = batcher._graph_step
    print(f"[{tag}] run {label}: {'paged' if batcher.paged else 'dense'} "
          f"pool, kv_dtype {kv.get('kv_dtype') or 'bf16'}; {len(prompts)} "
          f"concurrent requests (prompts {[len(p) for p in prompts]}, "
          f"{n_new} tokens each) in {wall:.3f} s, {steps} decode steps"
          + (f" (a CUDA graph: {graph.captures} captures in all)"
             if graph is not None else "") + f"; on {card}", flush=True)
    if dev.type == "cuda":
        cache_counts = {n: counts[n] for n in CACHE_KERNELS}
        if kv.get("compute_dtype") is not None and \
                counts_bf16_q != cache_counts:
            fail(f"[{tag}] run {label}: launches with a bf16 q "
                 f"{counts_bf16_q} are not all of the run's {cache_counts}")
        want = exact(steps)
        for (name, key), n in want.items():
            got = (counts[name][key] if key in counts[name] else
                   sum(variants[name][key].values()))
            if got != n:
                fail(f"[{tag}] run {label}: {name} ({key}) launched {got} "
                     f"times, expected {n} ({steps} decode steps)")
        print(f"[{tag}] run {label}: launches equal the call pattern's: "
              + ", ".join(f"{name} {key} {n}"
                          for (name, key), n in want.items()), flush=True)
    if batcher.paged and window is not None:
        if len(freed) != len(prompts):
            fail(f"[{tag}] run {label}: {len(freed)} releases logged, "
                 f"expected {len(prompts)}")
        for p_len, limit, n_freed, n_blocks in freed:
            want_freed = min(max(0, limit - window + 1) // WIN_BP, n_blocks)
            if n_freed != want_freed:
                fail(f"[{tag}] run {label}: a {p_len}-token request freed "
                     f"{n_freed} blocks, expected floor(({limit} - {window} "
                     f"+ 1) / {WIN_BP}) = {want_freed}")
        print(f"[{tag}] run {label}: blocks reclaimed while running "
              f"(prompt, limit, freed of held): {freed}, each "
              f"floor((limit - {window} + 1) / {WIN_BP}); pool "
              f"{batcher.allocator.n_blocks} blocks, high water "
              f"{batcher.allocator.high_water}", flush=True)
    return [results[i] for i in range(len(prompts))], counts, steps


# f32 compute's served logprobs (the top FORCED_TOPK and the chosen
# token's) against an f32 recompute on the served prefix: f32 rounding
# through 18-32 layers moves logits of magnitude 1-40 by about 1e-5 to
# 1e-4; 1e-3 leaves a tenfold margin. W-f32's control, the recompute
# without the band, must miss them by WIN_CONTROL_RATIO times that
FORCED_F32_TOL = 1e-3
WIN_CONTROL_RATIO = 10


def logprob_run(tag, label, cfg, prepared, prompts, n_new, dev, exact,
                **pool):
    """The served path with logprobs on: a ContinuousBatcher as the
    daemon builds it (the options `pool`, greedy, seed 0, logprobs_k =
    FORCED_TOPK), the prompts submitted together and drained, the launch
    counts zeroed just before and read just after and held to
    `exact(steps)` ({(kernel, dtype or variant): launches}). Returns
    ([(tokens, top ids, top logprobs, chosen logprobs)] a prompt,
    launches by dtype, by variant)."""
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    gc.collect()  # earlier batchers' graphs go outside this one's capture
    b = ContinuousBatcher(cfg, prepared, seed=0, device=dev,
                          logprobs_k=FORCED_TOPK, **pool)
    step, n_steps = b.step, [0]

    def counted_step():
        n_steps[0] += 1
        return step()

    b.step = counted_step
    sync(dev)
    reset_counts()
    rids = [b.submit(p, n_new, logprobs=True) for p in prompts]
    b.drain()
    sync(dev)
    counts, variants = read_counts(), read_variants()
    if dev.type == "cuda":
        for (name, key), n in exact(n_steps[0]).items():
            got = (counts[name][key] if key in counts[name] else
                   sum(variants[name][key].values()))
            if got != n:
                fail(f"[{tag}] {label}: {name} ({key}) launched {got} "
                     f"times, expected {n} ({n_steps[0]} decode steps)")
    out = []
    for rid in rids:
        toks, _, lps = b.claim(rid)
        out.append(([int(t) for t in toks], lps["top_ids"],
                    lps["top_logprobs"], lps["chosen"]))
    del b, step
    gc.collect()
    said = {n: {k: v for k, v in by.items() if v}
            for n, by in counts.items() if any(by.values())}
    print(f"[{tag}] {label}: {len(prompts)} requests, {n_new} tokens each "
          f"with logprobs (top {FORCED_TOPK}), {n_steps[0]} decode steps; "
          f"launches {said}", flush=True)
    return out, counts, variants


def window_f32_control(cfg, prompts, dev, card):
    """W-f32 of [mistral]: the model drawn again in f32 and served in f32
    over the windowed paged pool (f32 KV, logprob_run at the daemon's
    settings: K5 and K7 with an f32 q and the band, launches exact); each
    request's logprobs held within FORCED_F32_TOL of the f32 banded
    recompute on its own served prefix, and the same recompute without
    the band (the control) must miss them by at least WIN_CONTROL_RATIO x
    FORCED_F32_TOL: an unbanded kernel would fail this check. Returns
    (launches by dtype, by variant)."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.parallel.pipeline import sync

    t0 = time.perf_counter()
    tree = llama.init(0, cfg, device=dev)
    prepared = from_jax_params(tree, cfg, dev)
    del tree
    gc.collect()
    sync(dev)
    print(f"[mistral] W-f32: f32 weights drawn on {dev} and prepared in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    L = cfg.n_layer
    chunks = sum(-(-len(p) // WIN_PAD) for p in prompts)

    def exact(steps):
        return {("cached_attention", "f32"): L * chunks,
                ("cached_attention", "band"): L * chunks,
                ("paged_decode_attention", "f32"): L * steps,
                ("paged_decode_attention", "band"): L * steps}

    runs, counts, variants = logprob_run(
        "mistral", "W-f32", cfg, prepared, prompts, WIN_NEW, dev, exact,
        slots=WIN_SLOTS, max_len=WIN_MAX_LEN, prompt_pad=WIN_PAD,
        block_len=WIN_BP, kv="paged")
    for prompt, (toks, top_ids, top_lp, chosen) in zip(prompts, runs):
        p = len(prompt)
        ids = torch.tensor([list(prompt) + toks[:-1]], device=dev)
        rows = range(p - 1, p - 1 + len(toks))
        err = {band: forced_errors(
            list(window_ref_logits(prepared, cfg, ids, rows, dev, band=band)),
            toks, top_ids, top_lp, chosen).max().item()
            for band in (True, False)}
        said = (f"[mistral] W-f32 (prompt {p}, {len(toks)} tokens): served "
                f"logprobs {err[True]:.3e} from the banded recompute's, "
                f"{err[False]:.3e} from the unbanded control's")
        if err[True] > FORCED_F32_TOL:
            fail(f"{said}: above {FORCED_F32_TOL}")
        if err[False] < WIN_CONTROL_RATIO * FORCED_F32_TOL:
            fail(f"{said}: the control misses by less than "
                 f"{WIN_CONTROL_RATIO} x {FORCED_F32_TOL}")
        print(f"{said} (tolerance {FORCED_F32_TOL}, the control at least "
              f"{WIN_CONTROL_RATIO}x it); on {card}", flush=True)
    del prepared
    return counts, {f"{n} {v}": by for n, vs in variants.items()
                    for v, by in vs.items()}


def window_step_profile(tag, label, cfg, prepared, prompts, dev, card,
                        n_bytes, steps=8, **kv):
    """Information: where a decode step of a [mistral] / [gemma2] run goes
    -- the batcher at the run's settings (WIN_SLOTS slots, max_len
    WIN_MAX_LEN), every slot decoding past the window: the step's wall
    as the captured graph and eagerly, each under the profiler too
    (device busy, launches, top kernels, K6/K7's share), beside the byte
    bound of the weights (`n_bytes` at 3.35 TB/s)."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=WIN_SLOTS, max_len=WIN_MAX_LEN,
                          prompt_pad=WIN_PAD, block_len=WIN_BP, device=dev,
                          **kv)
    for p in prompts:
        b.submit(p, 6 * steps)
    for _ in range(4):
        b.step()
    torch.cuda.synchronize()

    def decode():
        for _ in range(steps):
            b.step()

    graph = b._graph_step
    for mode in ("captured", "eager"):
        b._graph_step = graph if mode == "captured" else None
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        p_wall, dev_ms, n_kern, top, _, dec_ms = _profiled(decode)
        print(f"[{tag}] {label}: decode step ({len(prompts)} slots past "
              f"position {min(len(p) for p in prompts)}, {mode}) {wall:.3f} "
              f"ms wall; under the profiler {p_wall / steps:.3f} ms wall, "
              f"{dev_ms / steps:.3f} ms device busy, {n_kern / steps:.0f} "
              f"launches a step; K6/K7 {dec_ms / steps:.4f} ms/step = "
              f"{100 * dec_ms / dev_ms:.1f}% of device busy; the weights' "
              f"byte bound {n_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms; on "
              f"{card}", flush=True)
        if mode == "captured":
            for name, ms, n in top[:5]:
                print(f"[{tag}]   decode {ms / steps:.4f} ms/step  "
                      f"x{n // steps}  {name}", flush=True)
    del b, graph
    gc.collect()  # its graphs go now, outside any later capture


def _draw_bf16(cfg, dev):
    """A LLaMA-family model drawn on the card in the JAX tree layout
    (llama.init, seed 0) and prepared for bf16 compute, the f32 tree
    freed. Returns (prepared, its bytes, the wall)."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.parallel.pipeline import sync

    t0 = time.perf_counter()
    tree = llama.init(0, cfg, device=dev)
    prepared = from_jax_params(tree, cfg, dev, compute_dtype=torch.bfloat16)
    del tree
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sync(dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(prepared))
    return prepared, n_bytes, time.perf_counter() - t0


def _win_prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]


def _win_merge(total, counts):
    for name, by in counts.items():
        for dt, n in by.items():
            total.setdefault(name, {}).setdefault(dt, 0)
            total[name][dt] += n
    return total


def phase_mistral(dev, card, cfg=None):
    """[mistral] mistral-7b (or `cfg`) at full width and depth in bf16
    compute, its weights drawn on the card from seed 0, served by the LM
    daemon as `node --serve_lm` builds it (WIN_SLOTS slots, max_len
    WIN_MAX_LEN, prompt_pad WIN_PAD): two prompts of WIN_PROMPTS tokens,
    WIN_NEW greedy tokens each, every stream past the 4096 window, on
    W-paged (the windowed paged pool, bf16 KV: K5 with the band on every
    prefill chunk, K7 with the band every step, the rolled-out blocks
    reclaimed), W-int8 (the same over int8 KV), W-dense (the dense pool,
    K6 with the band) and W-solo (make_generate on the rolling ring: the
    prompt banded by K5 on a prompt-length cache, then K6 over the
    4096-slot ring); each stream held by teacher forcing against the
    plain banded recompute (window_ref_logits, K/V stored as the run
    stores them) at BF16_TIE, near-ties parting at no more than
    WIN_MAX_PARTING_SHARE of the steps, the unbanded recompute missing
    them by more than WIN_CONTROL_BF16 times as much; launches exact.
    Then W-f32
    (window_f32_control): the model in f32 on the windowed paged pool,
    its logprobs held to the f32 banded recompute and apart from the
    unbanded one. Returns (launch counts by dtype, by variant), each
    {q type: ...}: the bf16 legs under "bf16", W-f32 under "f32"."""
    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.parallel.pipeline import sync

    bf16 = torch.bfloat16
    cfg = cfg or llama.PRESETS["mistral-7b"]
    w, L = cfg.sliding_window, cfg.n_layer
    prepared, n_bytes, wall = _draw_bf16(cfg, dev)
    print(f"[mistral] {L} layers, {cfg.n_embd} wide, {cfg.n_head} heads over "
          f"{cfg.n_kv_head} KV heads, window {w}: {n_bytes / 1e9:.2f} GB of "
          f"weights (bf16 matmuls) drawn on {dev} and prepared in "
          f"{wall:.1f} s", flush=True)
    prompts = _win_prompts(cfg, WIN_PROMPTS)
    chunks = sum(-(-len(p) // WIN_PAD) for p in prompts)
    total, variants = {}, {}
    for label, kv_kw, ref_kv in (
            ("W-paged", dict(kv="paged"), "bf16"),
            ("W-int8", dict(kv="paged", kv_dtype="int8"), "int8"),
            ("W-dense", dict(kv="dense"), "bf16")):
        dt = ref_kv
        decode = ("decode_attention" if kv_kw["kv"] == "dense"
                  else "paged_decode_attention")

        def exact(steps, dt=dt, decode=decode):
            return {("cached_attention", dt): L * chunks,
                    ("cached_attention", "band"): L * chunks,
                    (decode, dt): L * steps, (decode, "band"): L * steps}

        reset_counts()
        streams, counts, _ = window_run(
            "mistral", label, cfg, prepared, prompts, WIN_NEW, dev, card,
            exact, window=w, compute_dtype=bf16, **kv_kw)
        _win_merge(total, counts)
        _win_merge(variants, {f"{n} {v}": by for n, vs in
                              read_variants().items() for v, by in vs.items()})
        if dev.type == "cuda" and label != "W-int8":
            window_step_profile("mistral", label, cfg, prepared, prompts,
                                dev, card, n_bytes, compute_dtype=bf16,
                                **kv_kw)
        for prompt, stream in zip(prompts, streams):
            hold_forced_stream("mistral", label, prepared, cfg, prompt,
                               stream, dev, BF16_TIE, hold_control=True,
                               kv_dtype=ref_kv, compute_dtype=bf16)
    # W-solo: the rolling ring
    gen = llama.make_generate(cfg, max_new_tokens=WIN_NEW,
                              compute_dtype=bf16, device=dev)
    prompt = prompts[1]
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    toks = gen(prepared, [prompt])[0].tolist()
    sync(dev)
    wall = time.perf_counter() - t0
    counts, var = read_counts(), read_variants()
    if dev.type == "cuda":
        want = {("cached_attention", "bf16", L), ("decode_attention", "bf16",
                                                  L * (WIN_NEW - 1))}
        for name, dt, n in want:
            if counts[name][dt] != n:
                fail(f"[mistral] W-solo: {name} ({dt}) launched "
                     f"{counts[name][dt]} times, expected {n}")
        if (sum(var["cached_attention"]["band"].values()) != L
                or sum(var["decode_attention"]["band"].values()) != 0):
            fail(f"[mistral] W-solo: band launches {var}, expected K5 {L} "
                 "(the prompt) and no K6 (the ring needs none)")
    print(f"[mistral] W-solo make_generate on the rolling ring: {WIN_NEW} "
          f"tokens after a {len(prompt)}-token prompt in {wall * 1e3:.1f} ms "
          f"(K5 banded once a layer over the prompt, K6 over the {w}-slot "
          f"ring {WIN_NEW - 1} times a layer); on {card}", flush=True)
    hold_forced_stream("mistral", "W-solo", prepared, cfg, prompt, toks, dev,
                       BF16_TIE, hold_control=True, kv_dtype="bf16",
                       compute_dtype=bf16)
    _win_merge(total, counts)
    _win_merge(variants, {f"{n} {v}": by for n, vs in var.items()
                          for v, by in vs.items()})
    del prepared, gen
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    counts32, variants32 = window_f32_control(cfg, prompts, dev, card)
    return ({"bf16": total, "f32": counts32},
            {"bf16": variants, "f32": variants32})


def phase_gemma2(dev, card, cfg=None):
    """[gemma2] gemma2-9b (or `cfg`) at full width and depth in bf16
    compute (D = 256, attention softcap 50, final softcap 30, the
    4096-window on its even layers), its weights drawn on the card,
    served by the LM daemon with kv="auto", which falls back to the dense
    pool as JAX's does (a softcapped, alternating family has no paged
    channel): prompts of G2_PROMPTS tokens, WIN_NEW greedy tokens each,
    the first past the window so that the even layers band; K5 at D =
    256 with the softcap on every chunk and the band on the even layers'
    chunks, K6 likewise every step, exactly; each stream held by teacher
    forcing against the plain banded recompute at BF16_TIE. Returns
    (launch counts by dtype, by variant), each under "bf16" (its q)."""
    from dnn_tpu_torch.models import llama

    bf16 = torch.bfloat16
    cfg = cfg or llama.PRESETS["gemma2-9b"]
    L = cfg.n_layer
    n_band = len([x for x in llama.layer_windows(cfg) if x < WIN_MAX_LEN])
    prepared, n_bytes, wall = _draw_bf16(cfg, dev)
    print(f"[gemma2] {L} layers, {cfg.n_embd} wide, {cfg.n_head} heads over "
          f"{cfg.n_kv_head} KV heads, D {cfg.head_dim}, softcaps "
          f"{cfg.attn_softcap} / {cfg.final_softcap}, window "
          f"{cfg.sliding_window} on {n_band} of {L} layers: "
          f"{n_bytes / 1e9:.2f} GB of weights drawn on {dev} and prepared in "
          f"{wall:.1f} s", flush=True)
    prompts = _win_prompts(cfg, G2_PROMPTS)
    chunks = sum(-(-len(p) // WIN_PAD) for p in prompts)

    def exact(steps):
        out = {}
        for name, n in (("cached_attention", chunks),
                        ("decode_attention", steps)):
            out.update({(name, "bf16"): L * n, (name, "softcap"): L * n,
                        (name, "d256"): L * n, (name, "band"): n_band * n})
        return out

    reset_counts()
    streams, counts, _ = window_run("gemma2", "G2-dense", cfg, prepared,
                                    prompts, WIN_NEW, dev, card, exact,
                                    compute_dtype=bf16)
    variants = {f"{n} {v}": by for n, vs in read_variants().items()
                for v, by in vs.items()}
    for prompt, stream in zip(prompts, streams):
        hold_forced_stream("gemma2", "G2-dense", prepared, cfg, prompt,
                           stream, dev, BF16_TIE, kv_dtype="bf16",
                           compute_dtype=bf16)
    if dev.type == "cuda":
        window_step_profile("gemma2", "G2-dense", cfg, prepared, prompts,
                            dev, card, n_bytes, compute_dtype=bf16)
    del prepared
    return {"bf16": counts}, {"bf16": variants}


def phase_gemma(dev, card, cfg=None):
    """[gemma] gemma-2b (or `cfg`) at full width and depth in f32 (D =
    256, 8 query heads over one KV head), its weights drawn on the card:
    G1-paged the LM daemon over the paged f32 pool (serve_run: the main
    path's four prompts, G1_NEW greedy tokens) against the no-cache loop,
    K5 (G = 8) and K7 (R = 8) at D = 256 exactly; G1-logprobs the same
    pool with logprobs on (logprob_run), the served logprobs (the top
    FORCED_TOPK and the chosen token's) within FORCED_F32_TOL of the
    no-cache loop's on the same prefix (each stream is one token
    repeated: its tokens say little of the attention, the logprobs of
    the others do); G1-solo make_generate on the 300-token prompt,
    G1_SOLO_NEW tokens, K6 at R = 8. Returns (launch counts by dtype, by
    variant), each under "f32" (its q)."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.parallel.pipeline import sync

    cfg = cfg or llama.PRESETS["gemma-2b"]
    L = cfg.n_layer
    t0 = time.perf_counter()
    tree = llama.init(0, cfg, device=dev)
    prepared = from_jax_params(tree, cfg, dev)
    del tree
    sync(dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(prepared))
    print(f"[gemma] {L} layers, {cfg.n_embd} wide, {cfg.n_head} heads over "
          f"{cfg.n_kv_head} KV head, D {cfg.head_dim}: f32 weights "
          f"{n_bytes / 1e9:.2f} GB drawn on {dev} and prepared in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = _win_prompts(cfg, LLAMA_PROMPTS)
    t0 = time.perf_counter()
    ref_rows = [[] for _ in prompts]
    refs = [reference_greedy(prepared, cfg, p, G1_NEW, dev, rows)
            for p, rows in zip(prompts[:3], ref_rows)]
    solo_ref = reference_greedy(prepared, cfg, prompts[3], G1_SOLO_NEW, dev,
                                ref_rows[3])
    del ref_rows[3][G1_NEW:]
    refs.append((solo_ref[0][:G1_NEW], solo_ref[1][:G1_NEW]))
    print(f"[gemma] references (no-cache f32 loops) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    chunks = sum(-(-len(p) // 64) for p in prompts)
    total = serve_run(
        "G1-paged", cfg, prepared, prompts, G1_NEW, refs,
        [("cached_attention", "f32"), ("paged_decode_attention", "f32")],
        dev, card, exact=lambda steps: {
            ("cached_attention", "f32"): L * chunks,
            ("paged_decode_attention", "f32"): L * steps},
        kv="paged")
    # every launch since serve_run's reset (its TTFT stream's too) at D = 256
    now, var = read_counts(), read_variants()
    if dev.type == "cuda" and any(
            var[n]["d256"] != now[n] for n in CACHE_KERNELS):
        fail(f"[gemma] G1-paged: the D = 256 launches {var} are not all of "
             f"the daemon's {now}")
    variants = {f"{n} d256": dict(total[n]) for n in CACHE_KERNELS}
    runs, counts, var = logprob_run(
        "gemma", "G1-logprobs", cfg, prepared, prompts, G1_NEW, dev,
        lambda steps: {("cached_attention", "d256"): L * chunks,
                       ("paged_decode_attention", "d256"): L * steps},
        slots=4, max_len=1024, prompt_pad=64, block_len=16, kv="paged")
    for p, (want, gaps), rows, (toks, top_ids, top_lp, chosen) in zip(
            prompts, refs, ref_rows, runs):
        compare_tokens(f"[gemma] G1-logprobs (prompt {len(p)})", toks, want,
                       gaps)
        # the rows up to the first (near-tie) parting share the prefix
        n = next((j + 1 for j, (a, w) in enumerate(zip(toks, want))
                  if a != w), len(toks))
        err = forced_errors(rows[:n], toks[:n], top_ids[:n], top_lp[:n],
                            chosen[:n]).max().item()
        said = (f"[gemma] G1-logprobs (prompt {len(p)}, {len(toks)} tokens): "
                f"served logprobs {err:.3e} from the no-cache loop's")
        if err > FORCED_F32_TOL:
            fail(f"{said}: above {FORCED_F32_TOL}")
        print(f"{said} (tolerance {FORCED_F32_TOL}); on {card}", flush=True)
    _win_merge(total, counts)
    _win_merge(variants, {f"{n} {v}": by for n, vs in var.items()
                          for v, by in vs.items()})
    gen = llama.make_generate(cfg, max_new_tokens=G1_SOLO_NEW, device=dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    toks = gen(prepared, [prompts[3]])[0].tolist()
    sync(dev)
    wall = time.perf_counter() - t0
    counts, var = read_counts(), read_variants()
    if dev.type == "cuda":
        for name, n in (("cached_attention", L),
                        ("decode_attention", L * (G1_SOLO_NEW - 1))):
            if counts[name]["f32"] != n or sum(var[name]["d256"].values()) != n:
                fail(f"[gemma] G1-solo: {name} launched {counts[name]} "
                     f"({var[name]['d256']} at D = 256), expected {n}")
    print(f"[gemma] G1-solo make_generate: {G1_SOLO_NEW} tokens after a "
          f"{len(prompts[3])}-token prompt in {wall * 1e3:.1f} ms; on {card}",
          flush=True)
    compare_tokens("[gemma] G1-solo make_generate f32", toks, *solo_ref)
    _win_merge(total, counts)
    _win_merge(variants, {f"{n} {v}": by for n, vs in var.items()
                          for v, by in vs.items()})
    del prepared
    return {"f32": total}, {"f32": variants}


def _win_phase(key: str) -> str:
    """The phase that serves WIN_ROWS row `key`'s shape."""
    return ("gemma2" if "gemma2" in key else "gemma" if "gemma" in key
            else "mistral")


def window_records(rows, by_phase):
    """The kernels line's entries of the band and D = 256 variants, one a
    variant (K5 / K6 / K7 with the band; at D = 256): on top the case
    the main path launches most (the band: mistral-7b's shape, a bf16 q,
    the bf16 cache of W-paged; D = 256: gemma-2b's, an f32 q and cache),
    with that q type's rows by cache type; every other (shape, q type)
    of WIN_ROWS the variant covers beside it. Each row carries the
    variant's launches on the main path at its shape and q type (`rows`
    from phase_window_kernels; `by_phase` {"mistral" | "gemma2" |
    "gemma": {q type: {"kernel variant": {cache type: launches}}}}), and
    the entry's "launches" is their sum."""
    src = "dnn_tpu_torch/ops/cuda/csrc/"
    pallas = "dnn_tpu/ops/pallas/cached_attention.py"
    zero = dict.fromkeys(DTYPES, 0)
    entries = []
    for name, source, line, var, main, main_q, keys in (
            ("cached_attention", "cached_attention.cu", 77, "band",
             "K5 band", "bf16", ("K5 band", "K5 D256 gemma2")),
            ("decode_attention", "decode_attention.cu", 296, "band",
             "K6 band", "bf16", ("K6 band", "K6 D256 gemma2")),
            ("paged_decode_attention", "paged_decode.cu", 459, "band",
             "K7 band", "bf16", ("K7 band",)),
            ("cached_attention", "cached_attention.cu", 77, "d256",
             "K5 D256 gemma", "f32", ("K5 D256 gemma", "K5 D256 gemma2")),
            ("decode_attention", "decode_attention.cu", 296, "d256",
             "K6 D256 gemma solo", "f32",
             ("K6 D256 gemma solo", "K6 D256 gemma2")),
            ("paged_decode_attention", "paged_decode.cu", 459, "d256",
             "K7 D256 gemma", "f32", ("K7 D256 gemma",))):

        def launches(key, q):
            return by_phase.get(_win_phase(key), {}).get(q, {}).get(
                f"{name} {var}", zero)

        def shape_of(key):
            return {**next(s for k, _, s, _ in WIN_ROWS if k == key),
                    **next(c for k, _, _, c in WIN_ROWS if k == key)}

        extra, total = {}, sum(launches(main, main_q).values())
        for key in keys:
            for q in WIN_Q:
                if (key, q) == (main, main_q):
                    continue
                n = launches(key, q)
                total += sum(n.values())
                extra[f"{key.replace(' ', '_').lower()}_{q}_q_shape"] = {
                    **shape_of(key), "q": q, "by_dtype": {
                        dt: {"launches": n[dt], **row}
                        for dt, row in rows[key][q].items()}}
        entry = kernel_record(
            f"{name} ({'band' if var == 'band' else 'D = 256'})",
            src + source, f"{pallas}:{line}", rows[main][main_q], main_q,
            launches(main, main_q), shape={**shape_of(main), "q": main_q},
            **extra)
        entry["launches"] = total
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------
# [moe]: the MoE families (slice 20) on the LM daemon's path
# ---------------------------------------------------------------------
MOE_PROMPTS = (5, 70, 130, 300)   # A's prompts (M-GA, M-GB, QM)
MOE_NEW = 16
MX_PROMPTS = (301, 420)           # MX-Q8: two slots, each past 300
MOE_PROFILE_STEPS = 4             # step_profile's steps a mode (MX-Q8's
                                  # eager step is ~0.17 s)
MOE_LOG = 4096                    # routing calls the drop log keeps
# MX-Q8's teacher-forced logprob error may be at most this multiple of
# the second plain loop's (the same int8 tree, its prompts prefilled
# whole instead of in 64-token chunks: the bf16-compute noise of a
# different summation order, measured the same way in the same run).
# No f32-weight control fits the card beside Mixtral-8x7B's 47 GB, so
# the loop is the yardstick. At random weights a bf16 rounding flips
# near-tie expert choices and each flip carries into every later layer:
# on an H100 the two loops' prefills of the 301-token prompt routed 24%
# of their (token, layer) selections differently (routing_flips) and
# their logprobs differed by up to 4.8; the served path's error was
# 1.56x the loop's. At that noise the gate cannot tell a faulty routed
# FFN from a right one (the control below is printed, not held): MX-F32
# holds the same model's first layers in f32, where it can
MOE_FORCED_RATIO = 4.0
# MX-F32: the first MX_F32_LAYERS layers of MX-Q8's model (its int8
# blocks, the same seed), served in f32 compute over the paged f32 pool.
# Without bf16 rounding a summation order moves no route, so the served
# path's teacher-forced logprob error against the plain f32 loop must
# stay under MOE_F32_FORCED nats, and the control -- the loop with the
# router's top-k weights left unnormalised (router_norm_topk=False, Qwen's
# rule in place of Mixtral's: a fault of the routed FFN) -- must miss by
# more than that bound (the gate would catch it) and by more than
# MOE_CONTROL x the served path's error
MX_F32_LAYERS = 4
MOE_F32_FORCED = 1e-2
MOE_CONTROL = 10.0
# the routed FFN against dense_moe_reference at MX-Q8's layer 0, within
# this share of the output's scale: f32 compute (the products' order
# only), bf16 compute (the SwiGLU product rounded to bf16 before the down
# projection, as the served path rounds it)
MOE_FFN_TOL = {"f32": 1e-4, "bf16": 2e-2}


def moe_prompts(vocab: int, lengths, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


class DropLog:
    """Every routing call's tokens and dropped selections
    (parallel/moe.route_topk wrapped while installed), appended on the
    device by index ops that a captured graph replays; read after a run
    as one (tokens, dropped) pair per call, in call order."""

    def __init__(self, dev):
        self.buf = torch.zeros((MOE_LOG, 2), dtype=torch.int64, device=dev)
        self.idx = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._route = None

    def __enter__(self):
        from dnn_tpu_torch.parallel import moe

        route = self._route = moe.route_topk

        def logged(logits, *, top_k, capacity, normalize=True):
            out = route(logits, top_k=top_k, capacity=capacity,
                        normalize=normalize)
            tokens = logits.numel() // logits.shape[-1]
            kept = out[0].sum().long()
            row = torch.stack([torch.full_like(kept, tokens),
                               tokens * top_k - kept])
            self.buf.index_copy_(0, self.idx % MOE_LOG, row[None])
            self.idx.add_(1)
            return out

        moe.route_topk = logged
        return self

    def __exit__(self, *exc):
        from dnn_tpu_torch.parallel import moe

        moe.route_topk = self._route

    def reset(self):
        self.idx.zero_()

    def forwards(self, n_layer: int):
        """[(tokens routed, selections dropped over the layers)] per
        forward (n_layer consecutive calls)."""
        rows = self.buf[:int(self.idx.item())].tolist()
        return [(rows[i][0], sum(r[1] for r in rows[i:i + n_layer]))
                for i in range(0, len(rows), n_layer)]


def reference_moe_batch(prepared, cfg, prompts, n_new, dev, ffn, chunk=64):
    """Independent greedy loop of the batcher's schedule on a GPT-MoE
    model, f32, no batcher and no kernel: the prompts admitted in order
    into slots 0, 1, ..., each prefilled in `chunk`-token pieces (the
    last right-padded with id 0, as the batcher pads) or whole (chunk
    None), each piece's rows routed as one group; then every decode step
    routes all the slots' rows together, in slot order, as the batcher's
    step does when every slot is active. Attention is the plain version
    over a dense f32 cache a slot. Returns ([(tokens, top-2 gaps)] a
    prompt, [(tokens routed, selections dropped)] a routing call)."""
    from dnn_tpu_torch.models.gpt import head, layer_params
    from dnn_tpu_torch.ops.attention import merge_heads
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        reference_cached_attention)
    from dnn_tpu_torch.ops.nn import embedding, layer_norm, linear
    from dnn_tpu_torch.runtime.generate import _qkv_heads

    b_n, L = len(prompts), cfg.n_layer
    padded = [len(p) if chunk is None else -(-len(p) // chunk) * chunk
              for p in prompts]
    s_len = max(max(padded), max(len(p) for p in prompts) + n_new)
    hd = cfg.n_embd // cfg.n_head
    kc = torch.zeros((L, b_n, cfg.n_head, s_len, hd), device=dev)
    vc = torch.zeros_like(kc)

    def forward(ids, slots, starts):
        t = ids.shape[1]
        pos = torch.tensor(starts, device=dev)
        x = (embedding(prepared["wte"], ids) + embedding(
            prepared["wpe"], pos[:, None] + torch.arange(t, device=dev)))
        for i in range(L):
            bp = layer_params(prepared["blocks"], i)
            q, k, v = _qkv_heads(bp, layer_norm(bp["ln_1"], x, eps=cfg.ln_eps),
                                 cfg=cfg)
            ys = []
            for j, (slot, s0) in enumerate(zip(slots, starts)):
                kc[i, slot, :, s0:s0 + t] = k[j]
                vc[i, slot, :, s0:s0 + t] = v[j]
                ys.append(reference_cached_attention(
                    q[j:j + 1], kc[i, slot:slot + 1], vc[i, slot:slot + 1],
                    pos[j:j + 1].int()))
            x = x + linear(bp["attn"]["proj"], merge_heads(torch.cat(ys)))
            x = x + ffn(bp, layer_norm(bp["ln_2"], x, eps=cfg.ln_eps))
        return head(prepared, x, cfg=cfg)

    toks = [[] for _ in prompts]
    gaps = [[] for _ in prompts]

    def pick(slot, logits):
        top2 = torch.topk(logits, 2).values
        gaps[slot].append((top2[0] - top2[1]).item())
        toks[slot].append(int(logits.argmax()))

    with DropLog(dev) as log, torch.no_grad():
        for slot, p in enumerate(prompts):
            ids = torch.zeros((1, padded[slot]), dtype=torch.int64,
                              device=dev)
            ids[0, :len(p)] = torch.tensor(p, device=dev)
            step = chunk or padded[slot]
            for c0 in range(0, padded[slot], step):
                logits = forward(ids[:, c0:c0 + step], [slot], [c0])
            pick(slot, logits[0, len(p) - 1 - c0])
        starts = [len(p) for p in prompts]
        for _ in range(n_new - 1):
            ids = torch.tensor([[t[-1]] for t in toks], device=dev)
            logits = forward(ids, list(range(b_n)), starts)
            for slot in range(b_n):
                pick(slot, logits[slot, -1])
            starts = [s + 1 for s in starts]
        forwards = log.forwards(L)
    return list(zip(toks, gaps)), forwards


def print_drops(tag, label, forwards, ref_forwards=None):
    """The dropped selections of each forward of a run (prefill pieces,
    then decode steps), beside the reference's where given."""
    steps = [d for n, d in forwards]
    said = (f"[{tag}] {label}: dropped selections a forward (tokens "
            f"routed: dropped over the layers): "
            + ", ".join(f"{n}:{d}" for n, d in forwards))
    if ref_forwards is not None:
        same = [a == b for a, b in zip(forwards, ref_forwards)]
        said += (f"; the reference's in {sum(same)} of {len(same)} forwards"
                 + ("" if len(forwards) == len(ref_forwards) else
                    f" ({len(ref_forwards)} forwards there)"))
    print(said + f"; {sum(steps)} in all", flush=True)


def moe_serve(tag, label, cfg, prepared, prompts, n_new, refs, needed, dev,
              card, exact, tie=NEAR_TIE, drops=None, **kv):
    """One [moe] run through the LM daemon in-process (4 slots, max_len
    1024, prompt_pad 64, blocks of 16, the options `kv`, ffn among them
    for gpt2-moe): a 2-token warm-up request (its steps capture the
    graphs), then the worker held at the top of its loop while the
    prompts' gRPC generate calls queue one after another, so that it
    admits them all, in order, into slots 0, 1, ... before its first
    decode step (with drops the streams depend on the rows routed
    together: reference_moe_batch's schedule). Greedy streams against
    `refs` (compare_tokens, `tie`; None: printed, not judged), launches
    exactly `exact(steps)`; with `drops` (a DropLog, installed) each
    forward's drops are returned. Returns (launches -- with a bf16 q
    under bf16 compute --, streams, forwards or None)."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    gc.collect()
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, **kv)
    batcher, worker = stop.servicer.batcher, stop.servicer.worker
    step, n_steps = batcher.step, [0]

    def counted_step():
        n_steps[0] += 1
        return step()

    batcher.step = counted_step
    results, errors = {}, []
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=120):
            fail(f"[{tag}] {label}: LM daemon never became healthy")
        client.generate(prompts[0], max_new_tokens=2, timeout=600)
        sync(dev)
        entered, release = threading.Event(), threading.Event()

        def gate():
            entered.set()
            release.wait()

        worker.heartbeat = gate
        if not entered.wait(60):
            fail(f"[{tag}] {label}: the worker never reached its gate")
        reset_counts()
        n_steps[0] = 0
        if drops is not None:
            drops.reset()

        def call(i):
            try:
                results[i] = client.generate(prompts[i], max_new_tokens=n_new,
                                             timeout=600).tolist()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")

        threads = []
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=call, args=(i,)))
            threads[-1].start()
            t_end = time.monotonic() + 30
            while worker.q.qsize() < i + 1:
                if time.monotonic() > t_end:
                    fail(f"[{tag}] {label}: request {i} never queued")
                time.sleep(0.001)
        t0 = time.perf_counter()
        worker.heartbeat = None
        release.set()
        for t in threads:
            t.join(timeout=900)
        sync(dev)
        wall = time.perf_counter() - t0
        counts, counts_bf16_q = read_counts(), read_counts(bf16_q=True)
        steps = n_steps[0]
        forwards = drops.forwards(cfg.n_layer) if drops is not None else None
        client.close()
    finally:
        stop()
    if errors or len(results) != len(prompts):
        fail(f"[{tag}] {label}: generate calls failed: "
             f"{errors or 'timed out'}")
    bf16 = kv.get("compute_dtype") is not None
    if dev.type == "cuda":
        require(f"[{tag}] {label}", counts, needed)
        if bf16 and counts_bf16_q != {n: counts[n] for n in CACHE_KERNELS}:
            fail(f"[{tag}] {label}: launches with a bf16 q {counts_bf16_q} "
                 f"are not all of the run's")
        for (name, dt), n in exact(steps).items():
            if counts[name][dt] != n:
                fail(f"[{tag}] {label}: {name} ({dt}) launched "
                     f"{counts[name][dt]} times, expected {n} ({steps} "
                     "decode steps)")
    n_tok = sum(len(r) for r in results.values())
    print(f"[{tag}] {label}: {'paged' if batcher.paged else 'dense'} pool, "
          f"{len(prompts)} requests admitted together, {steps} decode steps "
          f"(captured CUDA graphs), {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s; "
          + counted(dev, "launches " + ", ".join(
              f"{name} {dt} {n}" for (name, dt), n in
              exact(steps).items()) + " exactly")
          + f"; on {card}", flush=True)
    streams = [results[i] for i in range(len(prompts))]
    for i, p in enumerate(prompts):
        compare_tokens(f"[{tag}] {label} request {i} (prompt {len(p)})",
                       streams[i], *refs[i], tie=tie)
    return (counts_bf16_q if bf16 else counts), streams, forwards


def routing_flips(tag, label, prepared, cfg, prompt, dev, compute_dtype,
                  kv_dtype="bf16"):
    """Information: the prompt's prefill through the plain loop in
    64-token chunks and whole (reference_greedy_cache over a `kv_dtype`
    cache, one token), each
    routing call's selected experts recorded: how many (token, layer)
    selections differ between the two, whose only difference is the
    order their products sum in (the bf16 noise a MoE model's routing
    turns into a different expert)."""
    from dnn_tpu_torch.parallel import moe

    route = moe.route_topk
    picks = []

    def recording(logits, *, top_k, capacity, normalize=True):
        out = route(logits, top_k=top_k, capacity=capacity,
                    normalize=normalize)
        picks[-1].append(out[0].sum(dim=-1).reshape(-1, logits.shape[-1])
                         > 0)
        return out

    moe.route_topk = recording
    try:
        for chunk in (64, None):
            picks.append([])
            reference_greedy_cache(prepared, cfg, prompt, 1, dev, kv_dtype,
                                   chunk=chunk, compute_dtype=compute_dtype)
    finally:
        moe.route_topk = route
    n, L = len(prompt), cfg.n_layer
    chunked = [torch.cat(picks[0][i::L])[:n] for i in range(L)]
    whole = [picks[1][i][:n] for i in range(L)]
    differ = sum(int((a != b).any(dim=-1).sum())
                 for a, b in zip(chunked, whole))
    print(f"[{tag}] {label}: the {n}-token prompt's routing in 64-token "
          f"chunks and whole differs at {differ} of {n * L} (token, layer) "
          f"selections", flush=True)
    return differ


def moe_step_share(tag, label, cfg, prepared, ffn, rows, dev, busy_ms,
                   compute_dtype=None):
    """Information: the routed FFN's device time a decode step (every
    layer's ffn on `rows` tokens, the profiler's kernel sum; the step
    routes all its slots' rows) and its share of the step's device busy
    `busy_ms`."""
    from dnn_tpu_torch.models.gpt import for_compute, layer_params

    served = for_compute(prepared, compute_dtype)
    dt = compute_dtype or torch.float32
    h = torch.randn((rows, 1, cfg.n_embd), device=dev).to(dt)
    layers = [layer_params(served["blocks"], i) for i in range(cfg.n_layer)]
    ms = device_ms(lambda: [ffn(bp, h) for bp in layers], iters=3)
    print(f"[{tag}] {label}: the routed FFN {ms:.3f} ms of device time a "
          f"step ({cfg.n_layer} layers x {rows} rows) = "
          f"{100 * ms / busy_ms:.1f}% of the captured step's "
          f"{busy_ms:.3f} ms device busy; on the card as printed", flush=True)
    return ms


def moe_gpt_legs(dev, card, cfg=None, d_cfg=None):
    """M-GA, M-GB, M-Gsolo, M-Gspec: gpt2-moe at full width (12 x 768, 8
    experts top-2, d_ff 3072 an expert; or `cfg`), seed-0 weights drawn
    on the card, f32; M-Gspec drafted by gpt2 (or `d_cfg`)."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models import gpt as tgpt
    from dnn_tpu_torch.models import gpt_moe as tgm
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.quant import param_bytes
    from dnn_tpu_torch.runtime.generate_moe import (make_generate_moe,
                                                    moe_cache_ffn)

    cfg = cfg or tgm.PRESETS["gpt2-moe"]
    prepared = from_jax_params(tgm.init(0, cfg, device=dev), cfg, dev)
    ffn = moe_cache_ffn(cfg)
    prompts = moe_prompts(cfg.vocab_size, MOE_PROMPTS, 20)
    print(f"[moe] gpt2-moe: {cfg.n_layer} layers x {cfg.n_embd}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor}: {param_bytes(prepared) / 1e9:.3f} GB of "
          f"f32 weights; on {card}", flush=True)
    t0 = time.perf_counter()
    refs, ref_fwd = reference_moe_batch(prepared, cfg, prompts, MOE_NEW, dev,
                                        ffn)
    print(f"[moe] M-GA/M-GB reference (the batcher's schedule, plain "
          f"attention, f32) in {time.perf_counter() - t0:.1f} s; smallest "
          f"top-2 gap {min(min(g) for _, g in refs):.3e}", flush=True)
    print_drops("moe", "M-GA/M-GB reference", ref_fwd)
    total = {n: {dt: 0 for dt in DTYPES}
             for n in CACHE_KERNELS}
    streams = {}
    for label, kv, decode in (
            ("M-GA", {"kv": "paged"}, "paged_decode_attention"),
            ("M-GB", {"kv": "dense", "decode_buckets": True},
             "decode_attention")):
        t_leg = time.perf_counter()
        with DropLog(dev) as log:
            counts, streams[label], fwd = moe_serve(
                "moe", label, cfg, prepared, prompts, MOE_NEW, refs,
                [("cached_attention", "f32"), (decode, "f32")], dev, card,
                main_exact(cfg, prompts, decode), drops=log, ffn=ffn, **kv)
        print_drops("moe", label, fwd, ref_fwd)
        add_into(total, counts)
        if dev.type == "cuda":
            walls = step_profile("moe", f"{label} gpt2-moe", cfg, prepared,
                                 prompts, dev, bit_check=True,
                                 steps=MOE_PROFILE_STEPS, ffn=ffn, **kv)
            moe_step_share("moe", f"{label} decode step", cfg, prepared,
                           ffn, 4, dev, walls["captured device"])
        print(f"[wall] moe {label} {time.perf_counter() - t_leg:.1f} s",
              flush=True)
    if streams["M-GA"] != streams["M-GB"]:
        fail("[moe] M-GB's streams differ from M-GA's")
    # M-Gsolo: make_generate_moe on the 300-token prompt: the prompt
    # routed as one group, then each step's one token
    solo_ref, solo_fwd = reference_moe_batch(prepared, cfg, prompts[3:],
                                             MOE_NEW, dev, ffn, chunk=None)
    gen = make_generate_moe(cfg, max_new_tokens=MOE_NEW, device=dev)
    gen(prepared, [prompts[3][:8]])
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = gen(prepared, [prompts[3]])[0].tolist()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    if dev.type == "cuda":
        for (name, n) in (("cached_attention", cfg.n_layer),
                          ("decode_attention", cfg.n_layer * (MOE_NEW - 1))):
            if counts[name]["f32"] != n:
                fail(f"[moe] M-Gsolo: {name} launched {counts[name]['f32']} "
                     f"times, expected {n}")
    print(f"[moe] M-Gsolo make_generate_moe: {MOE_NEW} tokens after a "
          f"{len(prompts[3])}-token prompt in {wall * 1e3:.1f} ms; "
          + counted(dev, f"K5 {cfg.n_layer}, K6 "
                    f"{cfg.n_layer * (MOE_NEW - 1)} exactly")
          + f"; on {card}", flush=True)
    print_drops("moe", "M-Gsolo reference", solo_fwd)
    compare_tokens("[moe] M-Gsolo", out, *solo_ref[0])
    add_into(total, counts)
    # M-Gspec: the solo speculative decoder, gpt2-moe at a capacity that
    # cannot drop (its verify chunks then route as the target alone
    # would) drafted by gpt2
    hi = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    d_cfg = d_cfg or tgpt.PRESETS["gpt2"]
    d_prep = from_jax_params(tgpt.init(1, d_cfg), d_cfg, dev)
    spec_ref, _ = reference_moe_batch(prepared, hi, prompts[3:], MOE_NEW,
                                      dev, moe_cache_ffn(hi), chunk=None)
    counts, _ = spec_solo(hi, prepared, d_cfg, d_prep, prompts[3],
                          spec_ref[0], dev, card, tag="moe",
                          label="M-Gspec")
    add_into(total, counts)
    return total


def dense_moe_reference(moe, x, cfg, round_to=None):
    """The routed FFN without parallel/moe.py: every expert's SwiGLU on
    every token in f32 from the dequantized stacks (an int8 stack times
    its per-(expert, channel) scale), the product rounded to `round_to`
    before the down projection where given, each token's top-k experts by
    torch.topk of the f32 router softmax, their weights renormalised
    (Mixtral's rule; raw for router_norm_topk=False), no capacity (at
    capacity_factor >= n_expert nothing drops). x (N, D) -> (N, D) f32."""
    from dnn_tpu_torch.ops.nn import silu

    def stack(name):
        w = moe[name].float()
        scale = moe.get(name + "_scale")
        return w if scale is None else w * scale.float()

    x = x.float()
    probs = torch.softmax(x @ moe["router"]["kernel"].float(), dim=-1)
    w, idx = torch.topk(probs, cfg.router_top_k, dim=-1)
    if cfg.router_norm_topk:
        w = w / w.sum(dim=-1, keepdim=True)
    gate = torch.zeros_like(probs).scatter(1, idx, w)         # (N, E)
    h = silu(torch.einsum("nd,edf->enf", x, stack("wg"))) \
        * torch.einsum("nd,edf->enf", x, stack("wu"))
    if round_to is not None:
        h = h.to(round_to).float()
    return torch.einsum("ne,end->nd", gate,
                        torch.einsum("enf,efd->end", h, stack("wd")))


def moe_ffn_check(tag, label, cfg, prepared, dev, gen):
    """The served routed FFN (cfg.default_ffn -> parallel/moe.moe_ffn) at
    layer 0 of `prepared`, on a prefill chunk (1 x 64 tokens) and a decode
    step's rows (4 x 1) of unit-normal inputs, in f32 and in bf16 compute,
    against dense_moe_reference within MOE_FFN_TOL of the output's scale
    (under bf16 compute the reference rounds the SwiGLU product to bf16,
    as the served path does)."""
    from dnn_tpu_torch.models.gpt import for_compute, layer_params

    said = []
    for name, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        bp = layer_params(for_compute(prepared, cdt)["blocks"], 0)
        ffn = cfg.default_ffn(cdt)
        for shape in ((1, 64), (4, 1)):
            x = torch.randn(shape + (cfg.n_embd,), device=dev,
                            generator=gen).to(cdt or torch.float32)
            with torch.no_grad():
                got = ffn(bp, x).float().reshape(-1, cfg.n_embd)
                want = dense_moe_reference(bp["moe"],
                                           x.reshape(-1, cfg.n_embd), cfg,
                                           round_to=cdt)
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if not err <= MOE_FFN_TOL[name] * scale:
                fail(f"[{tag}] {label} routed FFN, {name} compute, {shape}: "
                     f"max |served - dense reference| {err:.3e} above "
                     f"{MOE_FFN_TOL[name]} x its scale {scale:.3e}")
            said.append(f"{name} {shape[0]}x{shape[1]} {err / scale:.2e}")
            del got, want
    print(f"[{tag}] {label} routed FFN at layer 0 against the dense "
          f"reference (every expert on every token, dequantized in f32), "
          f"error / scale: {', '.join(said)}", flush=True)


def mixtral_spec(cfg=None):
    """mixtral-8x7b's registry spec, or the spec of `cfg` (a cut for the
    CPU rehearsal) with its init_prepared bound to that config."""
    from dnn_tpu_torch.models import llama_moe as tlm
    from dnn_tpu_torch.registry import get_model

    spec = get_model("mixtral-8x7b")
    if cfg is None:
        return spec
    return dataclasses.replace(spec, config=cfg, extras={
        **spec.extras, "init_prepared": lambda seed, device, **kw:
            tlm.init_prepared(seed, cfg, device, **kw)})


def moe_mixtral(dev, card, cfg=None):
    """MX-Q8: mixtral-8x7b at full width and depth (32 layers x 4096, 8
    experts top-2, d_ff 14336, GQA 32/8), seed-0 weights loaded as `node
    --serve_lm --weights int8` loads them (engine.served_params: the
    spec's init_prepared draws, quantizes -- expert stacks included --
    and stacks them one block at a time on the card; or `cfg`), bf16
    compute, the paged bf16 pool, two prompts past 300 tokens, 16 greedy
    tokens each; held by teacher forcing (forced_check) against the plain
    bf16-compute loop over the same int8 tree. Before serving, the routed
    FFN at layer 0 against the dense reference (moe_ffn_check); after, as
    information, the control of MX-F32 (the router's weights left
    unnormalised) read against the same loop. Returns the run's bf16-q
    launches."""
    from dnn_tpu_torch.config import TopologyConfig
    from dnn_tpu_torch.models.gpt import for_compute
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.quant import param_bytes
    from dnn_tpu_torch.runtime.engine import served_params

    bf16 = torch.bfloat16
    spec = mixtral_spec(cfg)
    cfg = spec.config
    t0 = time.perf_counter()
    qprep = served_params(
        TopologyConfig.from_dict({"model": spec.name,
                                  "device_type": dev.type}),
        spec, 0, dev, weights="int8")
    sync(dev)
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else float("nan"))
    served = for_compute(qprep, bf16)
    q_bytes = sum(t.numel() for t in _leaves(served) if t.dtype == torch.int8)
    e_bytes = sum(served["blocks"]["moe"][k].numel()
                  for k in ("wg", "wu", "wd"))
    print(f"[moe] MX-Q8 ({cfg.n_layer} layers x {cfg.n_embd}, "
          f"{cfg.n_expert} experts of {cfg.d_ff}): drawn, quantized and "
          f"stacked block by block (engine.served_params, the daemon's "
          f"loader) in {time.perf_counter() - t0:.1f} s: "
          f"{param_bytes(served) / 1e9:.2f} GB served ({q_bytes / 1e9:.2f} "
          f"GB of int8, {e_bytes / 1e9:.2f} GB of it the expert stacks); "
          f"peak device memory {peak:.1f} GB; on {card}", flush=True)
    moe_ffn_check("moe", "MX-Q8", cfg, qprep, dev,
                  torch.Generator(device=dev).manual_seed(20))
    prompts = moe_prompts(cfg.vocab_size, MX_PROMPTS, 21)
    t0 = time.perf_counter()
    rows = [[] for _ in prompts]
    refs = [reference_greedy_cache(served, cfg, p, MOE_NEW, dev, "bf16",
                                   chunk=64, compute_dtype=bf16, step_rows=4,
                                   logits_out=r)
            for p, r in zip(prompts, rows)]
    print(f"[moe] MX-Q8 references (plain bf16-compute loops over the int8 "
          f"tree and a bf16 cache, 64-token chunks) in "
          f"{time.perf_counter() - t0:.1f} s; smallest top-2 gap "
          f"{min(min(g) for _, g in refs):.3e}", flush=True)
    counts, _, _ = moe_serve(
        "moe", "MX-Q8", cfg, qprep, prompts, MOE_NEW, refs,
        [("cached_attention", "bf16"), ("paged_decode_attention", "bf16")],
        dev, card, main_exact(cfg, prompts, dt="bf16"), tie=None,
        kv="paged", compute_dtype=bf16, weights="int8")
    forced = forced_check("moe", "MX-Q8", cfg, qprep, prompts, refs, rows,
                          dev, kv="paged", compute_dtype=bf16)
    routing_flips("moe", "MX-Q8", served, cfg, prompts[0], dev, bf16)
    ratio = forced["served"] / max(forced["loop"], 1e-30)
    said = (f"[moe] MX-Q8: teacher-forced logprob error {forced['served']:.3e}"
            f", {ratio:.2f}x the whole-prompt loop's {forced['loop']:.3e}")
    if ratio > MOE_FORCED_RATIO:
        fail(f"{said}: above {MOE_FORCED_RATIO}x")
    print(f"{said} (at most {MOE_FORCED_RATIO}x)", flush=True)
    ctl = dataclasses.replace(cfg, router_norm_topk=False)
    c_err = loop_forced_errors(served, ctl, prompts[:1], refs[:1], rows[:1],
                               dev, "bf16", bf16)[0].max().item()
    c_ratio = c_err / max(forced["loop"], 1e-30)
    print(f"[moe] MX-Q8 control (information; MX-F32 holds it), the loop "
          f"with the router's top-k weights unnormalised, prompt "
          f"{len(prompts[0])}: teacher-forced error {c_err:.3e}, "
          f"{c_ratio:.2f}x the whole-prompt loop's: "
          + ("beyond" if c_ratio > MOE_FORCED_RATIO else "within")
          + f" the {MOE_FORCED_RATIO}x gate", flush=True)
    if dev.type != "cuda":
        return counts
    # step_profile steps three slots, then admits a fourth prompt
    walls = step_profile("moe", "MX-Q8 paged bf16, int8 weights", cfg, qprep,
                         prompts + prompts, dev, bit_check=True,
                         steps=MOE_PROFILE_STEPS, kv="paged",
                         compute_dtype=bf16)
    moe_step_share("moe", "MX-Q8 decode step", cfg, served,
                   cfg.default_ffn(bf16), 4, dev, walls["captured device"],
                   compute_dtype=bf16)
    print(f"[moe] MX-Q8 decode step: {walls['captured device']:.3f} ms device "
          f"busy against the {q_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms byte "
          f"bound of its {q_bytes / 1e9:.2f} GB of int8 weights; captured "
          f"wall {walls['captured']:.3f} ms, eager {walls['eager']:.3f} ms; "
          f"on {card}", flush=True)
    return counts


def moe_mixtral_f32(dev, card, cfg=None):
    """MX-F32: the first MX_F32_LAYERS layers of MX-Q8's model (the same
    seed: init_layer draws each block from its own stream, so these are
    MX-Q8's int8 blocks; or of `cfg`) served in f32 compute over the
    paged f32 pool, MX-Q8's prompts, 16 greedy tokens each: the streams
    against the plain f32 loop within NEAR_TIE, launches exact; teacher
    forcing (forced_check) within MOE_F32_FORCED nats of the loop; the
    control, the loop with the router's top-k weights unnormalised, beyond
    that bound and beyond MOE_CONTROL x the served path's error. Returns
    the run's f32 launches."""
    from dnn_tpu_torch.models import llama_moe as tlm

    full = cfg or tlm.PRESETS["mixtral-8x7b"]
    cfg = dataclasses.replace(full, n_layer=min(MX_F32_LAYERS, full.n_layer))
    t0 = time.perf_counter()
    prep = tlm.init_prepared(0, cfg, dev, weights="int8")
    prompts = moe_prompts(cfg.vocab_size, MX_PROMPTS, 21)
    rows = [[] for _ in prompts]
    refs = [reference_greedy_cache(prep, cfg, p, MOE_NEW, dev, "f32",
                                   chunk=64, step_rows=4, logits_out=r)
            for p, r in zip(prompts, rows)]
    print(f"[moe] MX-F32 ({cfg.n_layer} of MX-Q8's layers, int8 weights, f32 "
          f"compute): drawn and the plain f32 loops run in "
          f"{time.perf_counter() - t0:.1f} s; smallest top-2 gap "
          f"{min(min(g) for _, g in refs):.3e}", flush=True)
    counts, _, _ = moe_serve(
        "moe", "MX-F32", cfg, prep, prompts, MOE_NEW, refs,
        [("cached_attention", "f32"), ("paged_decode_attention", "f32")],
        dev, card, main_exact(cfg, prompts), kv="paged", weights="int8")
    forced = forced_check("moe", "MX-F32", cfg, prep, prompts, refs, rows,
                          dev, loop_kv="f32", kv="paged")
    routing_flips("moe", "MX-F32", prep, cfg, prompts[0], dev, None, "f32")
    ctl = dataclasses.replace(cfg, router_norm_topk=False)
    c_err = max(e.max().item() for e in loop_forced_errors(
        prep, ctl, prompts, refs, rows, dev, "f32"))
    said = (f"[moe] MX-F32: teacher-forced logprob error {forced['served']:.3e}"
            f" (whole-prompt loop {forced['loop']:.3e}); the control, the "
            f"router's top-k weights unnormalised, {c_err:.3e}")
    if not forced["served"] <= MOE_F32_FORCED:
        fail(f"{said}: the served path above {MOE_F32_FORCED}")
    if not (c_err > MOE_F32_FORCED
            and c_err > MOE_CONTROL * forced["served"]):
        fail(f"{said}: the control not beyond {MOE_F32_FORCED} and "
             f"{MOE_CONTROL} x the served path's error")
    print(f"{said}: the served path within {MOE_F32_FORCED}, the control "
          f"beyond it and {c_err / max(forced['served'], 1e-30):.3g}x the "
          f"served path's error (at least {MOE_CONTROL}x); on {card}",
          flush=True)
    return counts


def moe_qwen(dev, card, name="qwen15-moe-a2.7b"):
    """QM: qwen15-moe-a2.7b at full width and depth (24 layers x 2048, 60
    experts top-4 with raw softmax weights, the shared expert, vocab
    151936) in bf16 compute, served by `node --serve_lm` as a process
    (its seed-0 weights drawn on the card in bf16, the paged bf16 pool):
    the four prompts one after another, 16 greedy tokens each, launches
    from the child's /metrics exactly; the child stopped, the parent
    draws the same weights (llama_moe.init_prepared with dtype=bf16) and
    holds each stream to the plain bf16-compute loop within BF16_TIE;
    then the decode step captured against eager. Returns the run's
    bf16-q launches."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.models import llama_moe as tlm
    from dnn_tpu_torch.quant import param_bytes
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    bf16 = torch.bfloat16
    cfg = tlm.PRESETS[name]
    prompts = moe_prompts(cfg.vocab_size, MOE_PROMPTS, 22)
    t0 = time.perf_counter()
    proc, addr, base, _ = node_child(name, dev, "--kv", "paged",
                                     dtype="bfloat16")
    streams, launches = [], {}
    try:
        client = NodeClient(addr)
        t_end = time.monotonic() + 400
        while not client.health_check(timeout=1.0):
            if proc.poll() is not None or time.monotonic() > t_end:
                fail(f"[moe] QM: the node never became healthy (rc "
                     f"{proc.poll()}):\n{child_log(proc)}")
            time.sleep(0.5)
        ready = time.perf_counter() - t0
        client.generate(prompts[0], max_new_tokens=2, timeout=600)
        c0 = child_launches(base)
        t1 = time.perf_counter()
        for p in prompts:
            streams.append(client.generate(p, max_new_tokens=MOE_NEW,
                                           timeout=600).tolist())
        wall = time.perf_counter() - t1
        c1 = child_launches(base)
        client.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    chunks = sum(-(-len(p) // 64) for p in prompts)
    want = {("cached_attention", "bf16"): cfg.n_layer * chunks,
            ("paged_decode_attention", "bf16"):
                cfg.n_layer * len(prompts) * (MOE_NEW - 1)}
    got = {k: int(c1.get(k, 0) - c0.get(k, 0)) for k in want}
    if dev.type == "cuda" and got != want:
        fail(f"[moe] QM: the node's launches {got}, expected {want}")
    for (kern, dt), n in got.items():
        launches.setdefault(kern, {})[dt] = n
    print(f"[moe] QM node --serve_lm ({name}, bf16): healthy after "
          f"{ready:.1f} s; 4 requests one after another, "
          f"{sum(map(len, streams))} tokens in {wall:.3f} s; "
          + counted(dev, f"launches {got} exactly (its /metrics)")
          + f"; on {card}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prep = tlm.init_prepared(0, cfg, dev, compute_dtype=bf16, dtype=bf16)
    print(f"[moe] QM weights drawn again in the parent (bf16) in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{param_bytes(prep) / 1e9:.2f} GB; on {card}", flush=True)
    # the library's batcher in this process, the daemon's settings, the
    # requests one after another: the node's streams bit for bit
    lib = ContinuousBatcher(cfg, prep, slots=4, max_len=1024, prompt_pad=64,
                            block_len=16, seed=0, device=dev, kv="paged",
                            compute_dtype=bf16)
    for i, p in enumerate(prompts):
        rid = lib.submit(p, MOE_NEW)
        got = [int(t) for t in lib.drain()[rid]]
        if got != streams[i]:
            fail(f"[moe] QM request {i}: the node served {streams[i]}, the "
                 f"library's batcher {got}")
    del lib
    print(f"[moe] QM: the node's four streams equal the library batcher's "
          f"on the same weights token for token", flush=True)
    t0 = time.perf_counter()
    refs = [reference_greedy_cache(prep, cfg, p, MOE_NEW, dev, "bf16",
                                   chunk=64, compute_dtype=bf16, step_rows=4)
            for p in prompts]
    print(f"[moe] QM references (plain bf16-compute loops, 64-token chunks) "
          f"in {time.perf_counter() - t0:.1f} s; smallest top-2 gap "
          f"{min(min(g) for _, g in refs):.3e}", flush=True)
    for i, p in enumerate(prompts):
        compare_tokens(f"[moe] QM request {i} (prompt {len(p)})", streams[i],
                       *refs[i], tie=BF16_TIE)
    routing_flips("moe", "QM", prep, cfg, prompts[3], dev, bf16)
    out = {k: {dt: launches.get(k, {}).get(dt, 0)
               for dt in DTYPES} for k in CACHE_KERNELS}
    if dev.type != "cuda":
        return out
    walls = step_profile("moe", "QM paged bf16", cfg, prep, prompts, dev,
                         bit_check=True, steps=MOE_PROFILE_STEPS, kv="paged",
                         compute_dtype=bf16)
    moe_step_share("moe", "QM decode step", cfg, prep,
                   cfg.default_ffn(bf16), 4, dev, walls["captured device"],
                   compute_dtype=bf16)
    return out


def phase_moe_kernels(dev, gen):
    """[moe] K5 and K7 at qwen15-moe-a2.7b's MHA shapes (16 heads, no
    grouping, D = 128), bf16 q over a bf16 cache, against their plain
    versions within BF16_TOL of the output's scale: K5 at a prefill
    chunk (B=1 H=Hk=16 T=64 S=1024, base 960), K7 at a decode step (B=4
    Hk=16 R=1, blocks of 16, 64 a slot, 257 pool blocks, pos {0, 15, 16,
    1023}). Library time: SDPA on the bf16 q/k/v with the same mask (K5;
    none for paged). Bounds: k5_bound's; K7's bytes and f32 FMAs at 67
    TFLOP/s. Returns {"K5": row, "K7": row}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        cached_attention, paged_decode_attention, reference_cached_attention,
        reference_paged_decode_attention)

    bf16 = torch.bfloat16
    H, D, out = 16, 128, {}
    B, T, S, base = 1, 64, 1024, 960
    pos = torch.full((B,), base, dtype=torch.int32, device=dev)
    q = torch.randn(LAYERS, B, H, T, D, generator=gen, device=dev).to(bf16)
    k, v, _, _ = kv_cache(gen, (LAYERS, B, H, S, D), "bf16", dev)
    err = check_scaled("[moe] K5 qwen bf16", cached_attention(q[0], k[0], v[0],
                                                              pos),
                       reference_cached_attention(q[0], k[0], v[0], pos),
                       BF16_TOL)
    cols = torch.arange(S, device=dev)
    mask = cols[None, :] <= (base + torch.arange(T, device=dev))[:, None]
    nbytes, _, ops, (b_ms, b_by, byte_ms, op_ms) = k5_bound(
        "bf16", B, H, H, T, S, base, D, q_bytes=2)
    out["K5"] = dict(
        ms=time_ms(cycling(lambda i: cached_attention(q[i], k[i], v[i], pos),
                           LAYERS)),
        plain_ms=time_ms(cycling(lambda i: reference_cached_attention(
            q[i], k[i], v[i], pos), LAYERS)),
        library_ms=time_ms(cycling(lambda i: torch.nn.functional.
                                   scaled_dot_product_attention(
                                       q[i], k[i], v[i], attn_mask=mask),
                                   LAYERS)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    report("moe", "K5 qwen15-moe B=1 H=Hk=16 T=64 S=1024 D=128 base 960, "
           "bf16 q, bf16 cache", out["K5"], nbytes, byte_ms, op_ms, ops)
    B, bp, nb_max, n_blocks = 4, 16, 64, 257
    pos_list = [0, 15, 16, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_blocks - 1,
                          generator=torch.Generator().manual_seed(0))
    tables = (perm[:B * nb_max] + 1).reshape(B, nb_max).to(torch.int32).to(dev)
    q = torch.randn(LAYERS, B, H, 1, D, generator=gen, device=dev).to(bf16)
    kp, vp, _, _ = kv_cache(gen, (LAYERS, n_blocks, H, bp, D), "bf16", dev)
    err = check_scaled("[moe] K7 qwen bf16",
                       paged_decode_attention(q[0], kp[0], vp[0], tables,
                                              pos),
                       reference_paged_decode_attention(q[0], kp[0], vp[0],
                                                        tables, pos),
                       BF16_TOL)
    live = sum(p + 1 for p in pos_list)
    nbytes = (2 * B * H * D * 2 + H * kv_bytes("bf16", live, D)
              + sum(p // bp + 1 for p in pos_list) * 4 + B * 4)
    b_ms, b_by, byte_ms, op_ms = bound(nbytes, 4 * D * H * live)
    out["K7"] = dict(
        ms=time_ms(cycling(lambda i: paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos), LAYERS)),
        plain_ms=time_ms(cycling(lambda i: reference_paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos), LAYERS)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    report("moe", f"K7 qwen15-moe B=4 Hk=16 R=1 D=128 pos {pos_list}, bf16 q, "
           "bf16 cache (no one-call library equivalent)", out["K7"], nbytes,
           byte_ms, op_ms)
    return out


def phase_moe(dev, card, mixtral_cfg=None):
    """[moe] (slice 20): the MoE families through the LM daemon's path,
    each leg's launch counts zeroed just before it and read just after,
    exact; every leg's decode step one replay bit-equal to its eager step
    (step_profile); the leg's captured step wall and device busy, the
    routed FFN's share, its weight bytes. Returns (the f32 launches of
    the gpt2-moe legs and MX-F32, the bf16-q launches of MX-Q8 and QM,
    QM's). `mixtral_cfg`: MX-Q8's config (default mixtral-8x7b's)."""
    t0 = time.perf_counter()
    f32 = timed("moe gpt2-moe", moe_gpt_legs, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = timed("moe mixtral", moe_mixtral, dev, card, mixtral_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    add_into(f32, timed("moe mixtral f32", moe_mixtral_f32, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    qm = timed("moe qwen", moe_qwen, dev, card)
    add_into(bf16, qm)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe] phase wall {time.perf_counter() - t0:.1f} s; on {card}",
          flush=True)
    return f32, bf16, qm


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def kernel_record(name, source, replaces, rows, main_row, launches,
                  **extra):
    """One entry of the kernels line: the f32 case at the main-path shape
    on top, every cache type under by_dtype, launches summed over the
    main-path runs; `extra` entries (rows at other shapes) beside."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    by = {dt: {"launches": launches[dt], **{k: rows[dt][k] for k in keys}}
          for dt in rows}
    top = {k: rows[main_row][k] for k in keys}
    top["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            **top, "by_dtype": by, **extra}


# one turn of --decode-turns, run from a tree's root (its chip_smoke and
# its package): that tree's phases 3 and 4, then its wrappers timed at the
# solo decoder's shape (K6, B=1 S=316 pos 315) and at a decode step's
# short positions (K7, B=4 pos {8, 80, 140, 0}, nb_max=64 blocks of 16);
# prints the kernel times
TURN_CODE = """
import json, torch, chip_smoke as c
from dnn_tpu_torch.ops.cuda import _build
from dnn_tpu_torch.ops.cuda.cached_attention import (
    decode_attention, paged_decode_attention)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
_build.build(["decode_attention", "paged_decode"])
ms = {kernel: {dt: r["ms"] for dt, r in by.items()} for kernel, by in
      (("K6", c.phase_k6(dev, gen)), ("K7", c.phase_k7(dev, gen)))}
solo = torch.tensor([315], dtype=torch.int32, device=dev)
short = torch.tensor([8, 80, 140, 0], dtype=torch.int32, device=dev)
tables = torch.arange(1, 257, dtype=torch.int32, device=dev).reshape(4, 64)
ms["K6 solo"], ms["K7 short"] = {}, {}
for dt in ("f32", "bf16", "int8"):
    q = torch.randn(c.LAYERS, 4, 12, 1, 64, generator=gen, device=dev)
    k, v, ks, vs = c.kv_cache(gen, (c.LAYERS, 1, 12, 316, 64), dt, dev)
    ms["K6 solo"][dt] = c.time_ms(c.cycling(lambda i: decode_attention(
        q[i, :1], k[i], v[i], solo, **c.scales_at(ks, vs, i)), c.LAYERS))
    k, v, ks, vs = c.kv_cache(gen, (c.LAYERS, 257, 12, 16, 64), dt, dev)
    ms["K7 short"][dt] = c.time_ms(c.cycling(
        lambda i: paged_decode_attention(q[i], k[i], v[i], tables, short,
                                         **c.scales_at(ks, vs, i)),
        c.LAYERS))
print("TURN " + json.dumps(ms))
"""


TURN_DTYPES = ("f32", "bf16", "int8")  # a parent tree may lack int4


def decode_turns(parent: str, smi: str):
    """K6/K7 of the tree at `parent` and of this one, timed in turns
    (parent, this tree, this tree, parent) on one card, one process a
    turn; prints each turn's kernel times and the ratio of the means."""
    here = os.path.dirname(os.path.abspath(__file__))
    turns = []
    for label, root in (("parent", parent), ("tree", here), ("tree", here),
                        ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", TURN_CODE], cwd=root, text=True,
            capture_output=True, timeout=900,
            env={**os.environ, "PYTHONPATH": os.path.abspath(root)})
        if proc.returncode != 0:
            fail(f"decode turn in {root} failed:\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-3000:]}")
        times = json.loads([ln for ln in proc.stdout.splitlines()
                            if ln.startswith("TURN ")][-1][5:])
        turns.append((label, times))
        print(f"[turns] {label} ({root}): {json.dumps(times)}", flush=True)
    for kernel in ("K6", "K7", "K6 solo", "K7 short"):
        for dt in TURN_DTYPES:
            old = [t[kernel][dt] for label, t in turns if label == "parent"]
            new = [t[kernel][dt] for label, t in turns if label == "tree"]
            print(f"[turns] {kernel} {dt:4s}: parent "
                  f"{', '.join(f'{x:.4f}' for x in old)} ms, this tree "
                  f"{', '.join(f'{x:.4f}' for x in new)} ms: parent / tree "
                  f"{sum(old) / sum(new):.2f}; on {smi}", flush=True)


T_START = time.perf_counter()

# The whole smoke's depth cuts (widths, heads, vocabularies kept): the
# run had grown to 1134 s of the 1200 s limit with slice 21's phases, so
# the three largest later-slice models are served at these depths here,
# halved again when [obs2] added its 27 s (PERF.md section 4);
# tools/window_phases.py and tools/moe_phases.py still run them at full
# depth.
SMOKE_LAYERS = {"mistral-7b": 8, "gemma2-9b": 10, "mixtral-8x7b": 8}


def smoke_cut(family, name):
    """`family.PRESETS[name]` at its SMOKE_LAYERS depth."""
    return dataclasses.replace(family.PRESETS[name],
                               n_layer=SMOKE_LAYERS[name])


def timed(label, fn, *args):
    """fn(*args), its wall printed as a [wall] line."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[wall] {label} {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    if sys.argv[1:2] == ["--decode-turns"] and len(sys.argv) == 3:
        decode_turns(sys.argv[2], smi)
        return
    if len(sys.argv) > 1:
        fail(f"unknown arguments {sys.argv[1:]} (none, or --decode-turns "
             "PARENT)")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    timed("build", phase_build)
    timed("wire", phase_wire, smi)
    k5 = phase_k5(dev, gen)
    k5_verify = phase_k5_verify(dev, gen)
    k6 = phase_k6(dev, gen)
    k6_solo = phase_k6_solo(dev, gen)
    k7 = phase_k7(dev, gen)
    phase_decode_splits(dev, gen)
    flash = {**phase_flash_fwd(dev, gen), **phase_flash_bwd(dev, gen)}
    beam_embed_rows = phase_beam_embed_kernels(dev, gen)
    launches, prepared, cfg, prompts = timed("main path", phase_main_path,
                                             dev, smi)
    text = phase_text(cfg, prepared, dev, smi)
    phase_profile(prepared, cfg, prompts, dev)
    item_4d = timed("item 4d", phase_item_4d, cfg, prepared, prompts, dev,
                    smi)
    del prepared
    bf16_q_rows = phase_bf16_q_kernels(dev, gen)
    bf16_launches = timed("bf16", phase_bf16, dev, smi)
    pipe = timed("pipe", phase_pipe, dev, smi, prompts[3])
    gc.collect()
    torch.cuda.empty_cache()
    spec, verify_launches = timed("spec", phase_spec, dev, smi)
    for counts in (text, pipe, spec["f32"], item_4d):
        for name in CACHE_KERNELS:
            for dt, n in counts[name].items():
                launches[name][dt] += n
    for name in CACHE_KERNELS:
        for dt, n in spec["bf16"][name].items():
            bf16_launches[name][dt] += n
    launches.update(timed("train", phase_train, dev, smi))
    for name, by_dtype in OBS2_FLASH.items():  # [obs2] T's fit
        for dt, n in by_dtype.items():
            launches[name][dt] += n
    for dt, n in item_4d["flash_attention"].items():  # [embed]'s K1
        launches["flash_attention"][dt] += n
    gc.collect()  # the gpt2 phases' tensors go before llama3-8b's 32 GB
    torch.cuda.empty_cache()
    llama_rows = phase_llama_kernels(dev, gen)
    llama_counts, q8l_counts, q8l_forced = timed("llama", phase_llama,
                                                 dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lb_counts, lb_forced = timed("llama bf16", phase_llama_bf16, dev, smi)
    hold_forced(q8l_forced, lb_forced)
    gc.collect()
    torch.cuda.empty_cache()
    for name in CACHE_KERNELS:
        for dt, n in llama_counts[name].items():
            launches[name][dt] += n
    # sliding windows, softcaps, D = 256: the kernel rows, then mistral-7b
    # and gemma2-9b in bf16 compute (their launches all with a bf16 q) and
    # gemma-2b in f32, each model freed before the next is drawn
    win_rows = timed("window kernels", phase_window_kernels, dev, gen)
    from dnn_tpu_torch.models import llama as tllama

    win_variants = {}
    for tag, phase, cfg in (
            ("mistral", phase_mistral, smoke_cut(tllama, "mistral-7b")),
            ("gemma2", phase_gemma2, smoke_cut(tllama, "gemma2-9b")),
            ("gemma", phase_gemma, None)):
        counts, win_variants[tag] = timed(phase.__name__, phase, dev, smi,
                                          cfg)
        gc.collect()
        torch.cuda.empty_cache()
        for q, by_q in counts.items():  # into the f32 or the bf16-q entries
            into = launches if q == "f32" else bf16_launches
            for name in CACHE_KERNELS:
                for dt, n in by_q[name].items():
                    into[name][dt] += n
    # the MoE families (slice 20): K5/K7 at qwen15-moe's shapes, then
    # gpt2-moe (f32), mixtral-8x7b (int8 weights) and qwen15-moe (bf16)
    moe_rows = timed("moe kernels", phase_moe_kernels, dev, gen)
    from dnn_tpu_torch.models import llama_moe as tlm

    moe_f32, moe_bf16, qm_counts = timed(
        "moe", phase_moe, dev, smi, smoke_cut(tlm, "mixtral-8x7b"))
    add_into(launches, moe_f32)
    add_into(bf16_launches, moe_bf16)

    def llama_extra(kernel, rows, counts=llama_counts, **shape):
        """A kernel's [llama] rows, each with the llama runs' launches."""
        return {**shape, "by_dtype": {
            dt: {"launches": counts[kernel][dt], **row}
            for dt, row in rows.items()}}

    def bf16_q_record(name, source, line, gpt2, llama_rows, key, **shapes):
        """A kernel's bf16-q entry: the gpt2 rows (the bf16 cache on top)
        and the launches with a bf16 q of the [bf16] gpt2 runs, L-B and
        Q8-L; llama3-8b's rows under `key`, with L-B's and Q8-L's
        launches."""
        llama_runs = {name: {dt: lb_counts[name][dt] + q8l_counts[name][dt]
                             for dt in lb_counts[name]}}
        runs = {dt: bf16_launches[name][dt] + llama_runs[name][dt]
                for dt in bf16_launches[name]}
        return kernel_record(
            f"{name} (bf16 q)", src + source, f"{pallas}:{line}",
            bf16_q_rows[gpt2], "bf16", runs,
            **{key: llama_extra(name, bf16_q_rows[llama_rows],
                                counts=llama_runs, **shapes)})

    def verify_extra(model, label):
        """K5's row at a speculative verify shape; its launches those of
        the [spec] runs' verifies at gpt2-xl's shape (none at
        llama3-8b's: no run serves it speculatively)."""
        _, b, h, hk, d = next(v for v in VERIFY_SHAPES if v[0] == model)
        dt = "f32" if label == "f32" else "bf16"
        n = verify_launches[dt] if model == "gpt2-xl" else 0
        return {"model": model, "B": b, "H": h, "Hk": hk, "T": SPEC_K + 1,
                "S": 1024, "D": d, "bases": list(VERIFY_BASES),
                "by_dtype": {dt: {"launches": n,
                                  **k5_verify[(model, label)]}}}

    src = "dnn_tpu_torch/ops/cuda/csrc/"
    pallas = "dnn_tpu/ops/pallas/cached_attention.py"
    kernels = [
        kernel_record("cached_attention", src + "cached_attention.cu",
                      pallas + ":77",
                      {dt: k5[(dt, 960)] for dt, _ in KV_CASES}, "f32",
                      launches["cached_attention"],
                      llama_shape=llama_extra(
                          "cached_attention", llama_rows["K5"], B=1, H=32,
                          Hk=8, T=64, S=1024, D=128, base=960)),
        kernel_record("decode_attention", src + "decode_attention.cu",
                      pallas + ":296", k6, "f32",
                      launches["decode_attention"],
                      solo_shape={"B": SOLO_B, "Hk": SOLO_HK, "S": SOLO_S,
                                  "by_dtype": k6_solo},
                      llama_solo_shape=llama_extra(
                          "decode_attention", llama_rows["K6 solo"], B=1,
                          Hk=8, R=4, S=LLAMA_SOLO_S, D=128,
                          pos=LLAMA_SOLO_S - 2)),
        kernel_record("paged_decode_attention", src + "paged_decode.cu",
                      pallas + ":459", k7, "f32",
                      launches["paged_decode_attention"],
                      llama_shape=llama_extra(
                          "paged_decode_attention", llama_rows["K7"], B=4,
                          Hk=8, R=4, D=128, bp=16, nb_max=64)),
    ]
    kernels += [
        bf16_q_record("cached_attention", "cached_attention.cu", 77, "K5",
                      "llama K5", "llama_shape", B=1, H=32, Hk=8, T=64,
                      S=1024, D=128, base=960),
        bf16_q_record("decode_attention", "decode_attention.cu", 296, "K6",
                      "llama K6 solo", "llama_solo_shape", B=1, Hk=8, R=4,
                      S=LLAMA_SOLO_S, D=128, pos=LLAMA_SOLO_S - 2),
        bf16_q_record("paged_decode_attention", "paged_decode.cu", 459, "K7",
                      "llama K7", "llama_shape", B=4, Hk=8, R=4, D=128,
                      bp=16, nb_max=64),
    ]
    kernels[-2]["solo_shape"] = {"B": SOLO_B, "Hk": SOLO_HK, "S": SOLO_S,
                                 "by_dtype": bf16_q_rows["K6 solo"]}
    # [beam]'s decode shape: f32 launches from the [beam] search (no beam
    # search runs with a bf16 q)
    k6_beam = beam_embed_rows["K6 beam"]
    beam_shape = {"B": 2 * BEAM_K, "Hk": 12, "R": 1, "D": 64, "S": BEAM_S,
                  "pos": BEAM_S - 1}
    next(k for k in kernels if k["name"] == "decode_attention").update(
        beam_shape={**beam_shape, "by_dtype": {"f32": {
            "launches": LAYERS * (BEAM_NEW - 1),
            **k6_beam["f32"]}}})
    kernels[-2]["beam_shape"] = {**beam_shape, "by_dtype": {"bf16": {
        "launches": 0, **k6_beam["bf16 q"]}}}
    for name, label in (("cached_attention", "f32"),
                        ("cached_attention (bf16 q)", "bf16 q")):
        next(k for k in kernels if k["name"] == name).update(
            verify_shape=verify_extra("gpt2-xl", label),
            llama_verify_shape=verify_extra("llama3-8b", label))
    flash_py = "dnn_tpu/ops/pallas/flash_attention.py"
    for name, source, line in (
            ("flash_attention", "flash_attention.cu", 50),
            ("flash_attention_lse", "flash_attention.cu", 102),
            ("flash_bwd_dq", "flash_backward.cu", 149),
            ("flash_bwd_dkv", "flash_backward.cu", 181)):
        kernels.append(kernel_record(name, src + source, f"{flash_py}:{line}",
                                     flash[name], "f32", launches[name]))
    # [embed]'s shape: K1's launches in the [embed] runs
    kernels[-4]["embed_shape"] = {
        "B": 4, "H": 12, "T": EMBED_T, "S": EMBED_T, "D": 64,
        "by_dtype": {dt: {"launches": item_4d["flash_attention"][dt], **row}
                     for dt, row in beam_embed_rows["K1 embed"].items()}}
    kernels += window_records(win_rows, win_variants)
    # qwen15-moe-a2.7b's MHA shapes (D = 128, no grouping), bf16 q over a
    # bf16 cache: the launches those of QM's node
    for name, key, shape in (
            ("cached_attention (bf16 q)", "K5",
             {"B": 1, "H": 16, "Hk": 16, "T": 64, "S": 1024, "D": 128,
              "base": 960}),
            ("paged_decode_attention (bf16 q)", "K7",
             {"B": 4, "Hk": 16, "R": 1, "D": 128, "bp": 16, "nb_max": 64})):
        kern = name.split(" ")[0]
        next(k for k in kernels if k["name"] == name)["qwen_moe_shape"] = {
            **shape, "by_dtype": {"bf16": {
                "launches": qm_counts[kern]["bf16"], **moe_rows[key]}}}
    print(f"[wall] chip_smoke {time.perf_counter() - T_START:.1f} s", flush=True)
    print(f"{smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
