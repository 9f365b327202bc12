"""chip_smoke.py's MoE phases alone, on one CUDA card: the kernel build,
[moe]'s K5/K7 rows at qwen15-moe-a2.7b's shapes (phase_moe_kernels),
then [moe] itself (phase_moe: M-GA, M-GB, M-Gsolo, M-Gspec on gpt2-moe,
MX-Q8 on mixtral-8x7b with int8 weights, QM on qwen15-moe-a2.7b through
`node --serve_lm`). A quicker card iteration than the whole smoke.

    PYTHONPATH=$PWD python3 tools/moe_phases.py    # from the repo root
"""
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
    rows = cs.timed("moe kernels", cs.phase_moe_kernels, dev, gen)
    f32, bf16, qm = cs.timed("moe", cs.phase_moe, dev, smi)
    print(json.dumps({"moe_rows": rows, "f32": f32, "bf16_q": bf16,
                      "qm": qm}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
