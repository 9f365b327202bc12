"""Where the watchdog's probe child spends its wall on this host: four
children like obs/watchdog.subprocess_device_probe's (`import torch`,
CUDA init, a 64x64 tensor, the matmul, an elementwise op, each timed),
one of them with CUDA_MODULE_LOADING=LAZY and one without the matmul,
then `python -X importtime -c "import torch"`'s slowest modules.

    python3 tools/probe_timing.py    # on a machine with a CUDA card
"""
import os
import subprocess
import sys
import time

CODE = """
import time; t0 = time.time()
import torch; t1 = time.time()
d = torch.device('cuda'); torch.cuda.init(); t2 = time.time()
x = torch.ones((64, 64), device=d); torch.cuda.synchronize(d); t3 = time.time()
y = x @ x; torch.cuda.synchronize(d); t4 = time.time()
z = (x * x).sum(); torch.cuda.synchronize(d); t5 = time.time()
print(f"import {t1-t0:.2f} init {t2-t1:.2f} ones {t3-t2:.2f} matmul {t4-t3:.2f} mul {t5-t4:.2f}")
"""


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    no_mm = CODE.replace("y = x @ x; ", "y = x; ")
    for label, code, env in (("as is", CODE, {}), ("as is", CODE, {}),
                             ("lazy", CODE, {"CUDA_MODULE_LOADING": "LAZY"}),
                             ("no matmul first", no_mm, {})):
        t0 = time.time()
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             env={**os.environ, **env})
        print(f"[{label}] wall {time.time() - t0:.2f} s: "
              f"{out.stdout.strip()} {out.stderr.strip()[-300:]}; on {smi}",
              flush=True)
    t0 = time.time()
    out = subprocess.run([sys.executable, "-X", "importtime", "-c",
                          "import torch"], capture_output=True, text=True)
    rows = []
    for ln in out.stderr.splitlines():
        parts = ln.split("|")
        if len(parts) == 3 and parts[1].strip().isdigit():
            rows.append((int(parts[1]), parts[2].rstrip()))
    rows.sort(reverse=True)
    print(f"[importtime] wall {time.time() - t0:.2f} s; top cumulative:")
    for us, name in rows[:15]:
        print(f"  {us / 1e6:.2f} s {name}")


if __name__ == "__main__":
    main()
