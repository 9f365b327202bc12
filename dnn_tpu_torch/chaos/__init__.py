"""dnn_tpu_torch.chaos: deterministic fault injection (port of
dnn_tpu/chaos, without the supervisor: ROADMAP Queue 1 item 11).

  * `plan.FaultPlan` — a seeded schedule of faults, loadable from JSON,
    a file or the `--chaos` CLI flag. In-process faults fire on call
    counters through a seeded hash (`plan.decide`), so the same plan
    replays the same injections, equal to the JAX package's.
  * `inject.Injector` — the process-local seam driver: the LM daemon's
    admission, pool step and kvpull, the watchdog's probe and the
    client's send each consult it with one is-None check when chaos is
    off. Every injection lands in the flight recorder as a
    `chaos_inject` event.
"""

from dnn_tpu_torch.chaos.inject import (  # noqa: F401
    Injector,
    active,
    corrupt_file,
    install,
    uninstall,
)
from dnn_tpu_torch.chaos.plan import Fault, FaultPlan  # noqa: F401

__all__ = ["Fault", "FaultPlan", "Injector", "install", "uninstall",
           "active", "corrupt_file"]
