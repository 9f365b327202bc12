"""Hung-device watchdog: bounded liveness probes + heartbeat staleness
(port of dnn_tpu/obs/watchdog.py; `Watchdog`'s state machine copied
whole, the device probe on torch).

A server on a wedged card does not crash; it stops, and a /healthz that
only checks thread liveness keeps saying "ok". This module is the
detector:

  * a daemon thread runs a DEVICE PROBE once a period, in a SUBPROCESS
    with a hard deadline on its device work (`subprocess_device_probe`:
    a child `python -c` that imports torch only and runs a 64x64 matmul
    on the daemon's own device; its import is bounded apart) — a wedged
    card hangs the probe child, never the server.
    Custom probe callables (tests stub a hanging one) are also bounded
    by a probe thread joined with the deadline;
  * a DECODE HEARTBEAT: the LM batcher worker calls `beat()` every loop
    iteration; a heartbeat older than `heartbeat_stale_s` while the
    thread is alive means a step wedged inside the device runtime;
  * state is the worst component: `ok` -> `degraded` (the probe failed
    fast) -> `wedged` (the probe's deadline passed, or the heartbeat is
    stale). The classification reads the probe's structured `timed_out`
    flag, never its detail text. Transitions land in the flight
    recorder and the `dnn_tpu_watchdog_state` gauge (0/1/2);
    `GET /statusz` serves the per-component detail and /healthz
    degrades from binary to ok|degraded|wedged (obs/http.py).
"""

from __future__ import annotations

import select
import subprocess
import sys
import threading
import time
from typing import Callable, Optional, Tuple

__all__ = ["Watchdog", "subprocess_device_probe", "STATE_VALUES",
           "PROBE_DEADLINE_FLOOR_S", "PROBE_IMPORT_BUDGET_S"]

STATE_VALUES = {"ok": 0.0, "degraded": 1.0, "wedged": 2.0}

#: the least probe deadline LMServer gives its watchdog (JAX's floor)
PROBE_DEADLINE_FLOOR_S = 6.0
#: the probe child's `import torch`, bounded apart from the deadline:
#: 9.4-10.3 s on the H100's host, over JAX's whole 6-10 s deadline, and
#: it touches no device. The watchdog's join allows it (probe_slack_s)
PROBE_IMPORT_BUDGET_S = 60.0

# the child imports torch and nothing of this repo, says so, then runs
# the device work; on a CUDA device it synchronizes, so a hung card
# hangs the child, not the caller
_PROBE_CODE = ("import torch; print('imported', flush=True); "
               "d = torch.device({device!r}); "
               "x = torch.ones((64, 64), device=d); y = x @ x; "
               "torch.cuda.synchronize(d) if d.type == 'cuda' else None; "
               "print(float(y[0, 0]))")


def subprocess_device_probe(deadline_s: float = 10.0,
                            platform: Optional[str] = None,
                            import_budget_s: float = PROBE_IMPORT_BUDGET_S,
                            ) -> Tuple[bool, str, bool]:
    """One bounded probe: a 64x64 matmul in a child process on `platform`
    (the device the CALLER serves on: "cuda", "cuda:N" or "cpu"; None is
    "cuda"), never on another — a CPU daemon's probe never touches the
    card, and a CUDA daemon's never falls back to the CPU (without a
    card its child fails, which reads degraded). Returns (ok, detail,
    timed_out); `timed_out` is the structured hung-vs-failed flag the
    watchdog classifies on.

    `deadline_s` bounds the device work: it starts when the child says
    its `import torch` is done. The import touches no device and is
    bounded by `import_budget_s` apart (passing it reads degraded, not
    wedged): on the H100's host the import alone took longer than JAX's
    whole deadline (JAX's deadline covers its child's lifetime, `import
    jax` included, about 4 s). Popen + wait(timeout), not
    subprocess.run: run() reaps the child after kill(), and a child
    stuck in uninterruptible device I/O cannot be reaped until that
    syscall returns. On timeout the child is killed best-effort and the
    probe moves on."""
    device = platform or "cuda"
    proc = subprocess.Popen(
        [sys.executable, "-c", _PROBE_CODE.format(device=device)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], import_budget_s)
        line = proc.stdout.readline() if ready else b""
        if not line.startswith(b"imported"):
            if proc.poll() is None:  # still importing: the host, not the
                proc.kill()          # device, is slow
                return (False, f"probe import exceeded "
                        f"{import_budget_s:.0f}s", False)
            rc = proc.wait()
            return False, f"probe exited rc={rc}", False
        try:
            rc = proc.wait(timeout=deadline_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            return False, f"probe timeout after {deadline_s:.0f}s", True
        return rc == 0, "ok" if rc == 0 else f"probe exited rc={rc}", False
    finally:
        proc.stdout.close()


class Watchdog:
    """Liveness monitor for one serving process. Construct, then
    `start()`; read `state()` / `status()`; `close()` to stop.

    device_probe: callable(deadline_s) -> (ok, detail) or (ok, detail,
    timed_out), or None to disable the device leg (CPU-only test
    servers). The default is `subprocess_device_probe`. Hung-vs-failed
    is decided STRUCTURALLY, never by sniffing the detail text: wedged
    when the probe reports timed_out=True, or when the call itself
    outlives its deadline (even if it eventually returns); a fast
    (False, detail) from a 2-tuple custom probe is by definition not
    hung and reads as degraded.

    alive_check: optional callable -> bool for the serving worker
    thread; False -> wedged (the work loop is gone).

    on_wedged: optional callable(detail) fired ONCE per wedged EPISODE
    (latched while the state stays wedged, re-armed when it recovers) —
    the escalation hook `--on_wedged restart|drain` wires to the
    supervisor/drain path (runtime/lm_server.py). Fired from the
    watchdog thread AFTER the state flip, so /statusz already reads
    wedged when the policy runs; exceptions are swallowed-but-logged
    (a broken policy must not kill the detector). The first-step
    warm-up grace rules are unchanged — a cold chip's compile still
    reads degraded, so the policy can never evict a healthy warming
    server.

    Chaos hook (dnn_tpu_torch/chaos): when a fault plan with an active
    `wedge_device` window is installed in this process, the probe
    round reports that injected wedge (timed_out=True semantics)
    WITHOUT touching any device — the injection exercises exactly the
    classification + escalation path a real wedge would.
    """

    def __init__(self, *, period_s: float = 30.0,
                 probe_deadline_s: float = 10.0,
                 device_probe: "Optional[Callable]" = subprocess_device_probe,
                 heartbeat_stale_s: float = 120.0,
                 alive_check: Optional[Callable[[], bool]] = None,
                 on_wedged: Optional[Callable[[str], None]] = None,
                 registry=None, probe_slack_s: float = 2.0):
        self.period_s = float(period_s)
        self.probe_deadline_s = float(probe_deadline_s)
        # the probe thread's join allows the deadline plus this: JAX's 2 s
        # of thread and spawn time, and for the subprocess probe its
        # child's import budget (LMServer passes it)
        self.probe_slack_s = float(probe_slack_s)
        self.device_probe = device_probe
        self.heartbeat_stale_s = float(heartbeat_stale_s)
        self.alive_check = alive_check
        self.on_wedged = on_wedged
        self._wedged_latched = False
        self._lock = threading.Lock()
        self._components: dict = {}
        self._t_beat: Optional[float] = None
        self._warmed = False  # a step has completed: see step_done()
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_result: Optional[tuple] = None  # (ok, detail[, timed_out])
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="obs-watchdog")
        self._register_gauge(registry)

    def _register_gauge(self, registry):
        from dnn_tpu_torch import obs

        reg = registry if registry is not None else obs.metrics()
        if reg is None:
            return
        import weakref

        ref = weakref.ref(self)

        def read() -> float:
            wd = ref()
            return STATE_VALUES[wd.state()] if wd is not None else 0.0

        reg.set_fn("dnn_tpu_watchdog_state", read)

    # -- producer side --------------------------------------------------

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def beat(self):
        """Heartbeat from the serving work loop (one perf_counter read +
        one attribute store; called every worker iteration)."""
        self._t_beat = time.perf_counter()

    def step_done(self):
        """A decode/prefill step COMPLETED (one attribute store; the LM
        worker calls this after every successful step). Until the first
        one, a stale heartbeat reads `degraded`, not `wedged`: the first
        step's kernel builds and graph capture on a cold card legitimately
        block the loop (nvcc takes seconds a kernel library), and a 503
        there makes an orchestrator evict a healthy warming server —
        potentially forever, since each restart re-compiles."""
        self._warmed = True

    def close(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.period_s + 1)

    # -- state ----------------------------------------------------------

    def _set_component(self, name: str, state: str, detail: str):
        from dnn_tpu_torch.obs import flight

        with self._lock:
            prev = self._components.get(name, {}).get("state")
            self._components[name] = {
                "state": state, "detail": detail, "t": time.time()}
        if prev != state:
            flight.record("watchdog", component=name,
                          prev=prev or "unknown", state=state,
                          detail=detail)

    def _check_heartbeat(self):
        if self.alive_check is not None and not self.alive_check():
            self._set_component("decode_heartbeat", "wedged",
                                "serving worker thread is not alive")
            return
        tb = self._t_beat
        if tb is None:
            return  # no loop has ever beaten: component not tracked
        age = time.perf_counter() - tb
        if age > self.heartbeat_stale_s:
            if not self._warmed:
                # no step has EVER completed: the loop is most likely
                # blocked in the first step's kernel builds (seconds to
                # minutes on a cold card), not a wedge — visible, but not
                # a 503
                self._set_component(
                    "decode_heartbeat", "degraded",
                    f"last heartbeat {age:.0f}s ago with no completed "
                    "step yet: first-step compile in progress, or the "
                    "device wedged at init")
                return
            self._set_component(
                "decode_heartbeat", "wedged",
                f"last heartbeat {age:.0f}s ago (stale > "
                f"{self.heartbeat_stale_s:.0f}s: a step is stuck inside "
                "the device runtime)")
        else:
            self._set_component("decode_heartbeat", "ok",
                                f"last heartbeat {age:.1f}s ago")

    def _run_probe(self):
        """One device-probe round. The probe runs on ITS OWN thread and
        we join with the deadline (+ slack for the subprocess probe,
        which bounds itself): a stubbed/in-process probe that hangs
        leaks exactly one daemon thread and reads as a timeout — and no
        new probe is spawned while the stuck one lives."""
        from dnn_tpu_torch.chaos import inject as _chaos_inject

        injected = _chaos_inject.wedge_detail()
        if injected is not None:
            # chaos wedge_device window: the probe result IS the
            # injection (structural timed_out semantics) — no device
            # touched, same classification path as a real hang
            self._set_component("device", "wedged", injected)
            return
        if self._probe_thread is not None and self._probe_thread.is_alive():
            self._set_component(
                "device", "wedged",
                "previous probe still hung past its deadline")
            return

        def probe_main():
            try:
                self._probe_result = self.device_probe(self.probe_deadline_s)
            except Exception as e:  # noqa: BLE001 — a broken probe is a
                self._probe_result = (False, f"probe raised: {e}")  # result

        self._probe_result = None
        t = threading.Thread(target=probe_main, daemon=True,
                             name="obs-watchdog-probe")
        self._probe_thread = t
        t.start()
        # the slack covers thread scheduling and the spawn (JAX's 2 s)
        # and, for the subprocess probe, its child's import budget: the
        # deadline itself bounds only the device work
        t.join(timeout=self.probe_deadline_s + self.probe_slack_s)
        res = self._probe_result
        if t.is_alive() or (res is None):
            self._set_component(
                "device", "wedged",
                f"device probe hung past {self.probe_deadline_s:.0f}s "
                "deadline")
            return
        ok, detail = res[0], res[1]
        timed_out = len(res) > 2 and bool(res[2])
        if ok:
            self._set_component("device", "ok", detail)
        elif timed_out:
            self._set_component("device", "wedged", detail)
        else:
            # fast failure: the backend answered, unhealthily — a HUNG
            # probe never reaches here (child timeout sets timed_out;
            # an in-process hang is caught by the join deadline above)
            self._set_component("device", "degraded", detail)

    def _fire_escalation(self):
        """Once-per-episode wedged escalation: latched while wedged,
        re-armed on recovery. Runs AFTER the component flip, so the
        policy sees consistent /statusz state."""
        if self.state() == "wedged":
            if not self._wedged_latched:
                self._wedged_latched = True
                cb = self.on_wedged
                if cb is not None:
                    detail = "; ".join(
                        f"{k}: {v['detail']}"
                        for k, v in self.status()["components"].items()
                        if v["state"] == "wedged")
                    try:
                        cb(detail)
                    except Exception:  # noqa: BLE001 — a broken policy
                        import logging

                        logging.getLogger("dnn_tpu_torch.obs").exception(
                            "on_wedged escalation hook failed")
        else:
            self._wedged_latched = False

    def _run(self):
        while not self._stop.is_set():
            if self.device_probe is not None:
                self._run_probe()
            self._check_heartbeat()
            self._fire_escalation()
            # first round runs immediately (a wedged chip must be
            # reported within ONE period of startup), then period cadence
            self._stop.wait(self.period_s)

    def state(self) -> str:
        with self._lock:
            states = [c["state"] for c in self._components.values()]
        if not states:
            return "ok"
        return max(states, key=lambda s: STATE_VALUES[s])

    def status(self) -> dict:
        self._check_heartbeat()  # staleness must be fresh at read time
        with self._lock:
            comps = {k: dict(v) for k, v in self._components.items()}
        states = [c["state"] for c in comps.values()]
        return {
            "state": max(states, key=lambda s: STATE_VALUES[s])
            if states else "ok",
            "components": comps,
            "period_s": self.period_s,
            "probe_deadline_s": self.probe_deadline_s,
            "t": time.time(),
        }
