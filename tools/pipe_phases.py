"""chip_smoke.py's [pipe] phase alone, on one CUDA card: the kernel
build, then P-a (the cifar pairs of `node --serve` processes on grpc and,
with P-g's metrics and chaos checks, on shm), P-b and P-d (gpt2-medium's
eight in-process stage servers on grpc), P-g's device rung (the same
servers on transport=device), P-e (configs/gpt2_8stage.json on the spmd
runtime, one card as eight stages, against the relay engine; the CIFAR
CNN on the packed and replicated paths), P-c (engine.generate, 4 relay
parts), P-f (pipeline-parallel decode of gpt2 with f32 and int8 shards
and of llama3-8b cut to 8 layers, against make_generate with exact K5/K6
launches) and K5/K6 at P-f's stage-local shapes against their plain
versions. A quicker card iteration than the whole smoke.

    PYTHONPATH=$PWD python3 tools/pipe_phases.py
"""
import subprocess

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
    gen = torch.Generator(device=dev).manual_seed(0)
    cs.timed("build", cs.phase_build)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50257, n).tolist() for n in (5, 70, 130, 300)]
    out = cs.timed("pipe", cs.phase_pipe, dev, smi, prompts, gen)
    print(f"[pipe] launches: P-c + P-f gpt2 {out['counts']['cached_attention']}"
          f" K5, {out['counts']['decode_attention']} K6; P-f llama (bf16 q) "
          f"{out['bf16_q']['cached_attention']} K5, "
          f"{out['bf16_q']['decode_attention']} K6", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
