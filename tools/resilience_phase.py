"""chip_smoke.py's [resilience] phase alone, on one CUDA card: the kernel
build, gpt2's seed-0 weights and greedy references, run A (the phase
compares every stream with it), then phase_resilience. A quicker card
iteration than the whole smoke (a few minutes of command).

    PYTHONPATH=$PWD python3 tools/resilience_phase.py    # from the repo root
"""
import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models.gpt import PRESETS, init


def main():
    if not torch.cuda.is_available():
        cs.fail("this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.phase_build()
    cfg = PRESETS["gpt2"]
    prepared = from_jax_params(init(0, cfg), cfg, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    refs = [cs.reference_greedy(prepared, cfg, p, 16, dev) for p in prompts]
    a_info = {}
    cs.serve_run("A", cfg, prepared, prompts, 16, refs,
                 [("cached_attention", "f32"),
                  ("paged_decode_attention", "f32")],
                 dev, smi, info=a_info, kv="paged")
    t0 = time.perf_counter()
    counts = cs.phase_resilience(cfg, prepared, prompts, refs,
                                 a_info["streams"], dev, smi)
    print(f"[resilience] launches {counts}; {time.perf_counter() - t0:.1f} s; "
          f"on {smi}", flush=True)


if __name__ == "__main__":
    main()
