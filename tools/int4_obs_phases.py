"""chip_smoke.py's int4 and obs phases alone, on one CUDA card: the
kernel build, K5/K6/K7 at gpt2's shapes in every cache type, int4
included (phase_k5, phase_k6, phase_k7, phase_k6_solo), gpt2's seed-0
weights and references (the no-cache loop and the plain int4 cache
loop), then [int4] (C-int4, B-int4, solo make_generate and
make_bucketed_generate at int4, C against C-int4's captured step) and
[obs] (the daemon with its four SLOs: spans, /stepz coverage, MBU/MFU,
capture counters, the obs on/off step). With --llama, also llama3-8b's
kernel rows (phase_llama_kernels) and [llama] (L-A, L-C, L-C-int4,
L-solo, Q8-L). A quicker card iteration than the whole smoke.

    PYTHONPATH=$PWD python3 tools/int4_obs_phases.py [--llama]
"""
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def main():
    if not torch.cuda.is_available():
        cs.fail("this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cs.timed("build", cs.phase_build)
    for phase in (cs.phase_k5, cs.phase_k6, cs.phase_k6_solo, cs.phase_k7):
        cs.timed(phase.__name__, phase, dev, gen)
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS, init

    cfg = PRESETS["gpt2"]
    prepared = from_jax_params(init(0, cfg), cfg, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    t0 = time.perf_counter()
    ref_f32 = [cs.reference_greedy(prepared, cfg, p, 16, dev)
               for p in prompts]
    ref_i4 = [cs.reference_greedy_cache(prepared, cfg, p, 16, dev, "int4")
              for p in prompts]
    print(f"[main] references in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cs.timed("int4", cs.phase_int4, cfg, prepared, prompts, 16, ref_i4, dev,
             smi)
    cs.timed("obs", cs.phase_obs, cfg, prepared, prompts, ref_f32, dev, smi)
    if "--llama" in sys.argv[1:]:
        del prepared
        cs.gc.collect()
        torch.cuda.empty_cache()
        cs.timed("llama kernels", cs.phase_llama_kernels, dev, gen)
        cs.timed("llama", cs.phase_llama, dev, smi)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
