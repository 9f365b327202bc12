"""chip_smoke.py's [obs2] phase alone, on one CUDA card: the kernel
build, gpt2's seed-0 weights, then [obs2] — T (fit on gpt2 B=8 T=512
with the TrainClock, the GradSentinel and grad_stats; the CIFAR CNN's
nan fault), P (POST /profilez: an auto-captured decode step read by
timeline.analyze against _kernel_events, a timed capture under four
streams), K (the radix store's hit-ratio curve at pool P against the
ratio measured at 2P) and F (/fleetz over the P and K daemons). A
quicker card iteration than the whole smoke.

    PYTHONPATH=$PWD python3 tools/obs2_phases.py
"""
import subprocess
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
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cs.timed("build", cs.phase_build)
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS, init

    cfg = PRESETS["gpt2"]
    t0 = time.perf_counter()
    prepared = from_jax_params(init(0, cfg), cfg, dev)
    print(f"[main] gpt2 weights in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    cs.timed("obs2", cs.phase_obs2, cfg, prepared, prompts, dev, smi)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
