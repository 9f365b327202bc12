"""chip_smoke.py's sliding-window, softcap and head-dim-256 phases alone,
on one CUDA card: the kernel build, [K5 band] [K6 band] [K7 band] [D256]
(phase_window_kernels), then [mistral], [gemma2] and [gemma], and the
kernels line's entries they make. A quicker card iteration than the
whole smoke (a few minutes of command).

    PYTHONPATH=$PWD python3 tools/window_phases.py    # from the repo root
"""
import gc
import json
import subprocess

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
    rows = cs.timed("window kernels", cs.phase_window_kernels, dev, gen)
    by_phase = {}
    for tag, phase in (("mistral", cs.phase_mistral),
                       ("gemma2", cs.phase_gemma2),
                       ("gemma", cs.phase_gemma)):
        counts, by_phase[tag] = cs.timed(phase.__name__, phase, dev, smi)
        print(f"[{tag}] launches by q type {counts}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"kernels": cs.window_records(rows, by_phase)}),
          flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
