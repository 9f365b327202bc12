"""Process-local fault injector: the seams consult, the plan decides
(port of dnn_tpu/chaos/inject.py, copied whole; only the imports point
at this package).

One injector per process, installed with `install(plan)` (the node CLI's
`--chaos` flag or a test). Seam entry points are module-level functions
that cost ONE global is-None check when chaos is off — the same
degradation discipline as `obs.flight.record`:

    perturb_rpc(seam, target)   comm client/service, before each RPC
                                attempt: may sleep (rpc_delay), raise a
                                retryable UNAVAILABLE (rpc_drop), or
                                raise PayloadCorruptError (rpc_corrupt)
    perturb_relay()             relay frame ingress (ChunkAssembler):
                                drop (frame vanishes -> upstream
                                deadline) or corrupt (PayloadCorrupt)
    kv_exhaust()                LM admission: True -> the admission
                                raises InsufficientBlocks (held-back /
                                requeue path under a full pool)
    step_fault()                LM batcher step: raises at the
                                scheduled step counter (worker-death /
                                requeue path)
    train_fault()               training loop (train.fit): non-None ->
                                a directive dict — {"mode": "nan"}
                                poisons the batch's float leaves (the
                                gradient-sentinel vector) or
                                {"mode": "sleep", "delay_s": s} stalls
                                the input pipeline (the data_stall
                                attribution vector)
    wedge_detail()              watchdog probe: non-None -> the probe
                                reports a structural timeout (wedged)
                                without touching any device

Where the port consults them: kv_exhaust() at the LM worker's
admission, step_fault() before each pool step, kv_migrate() in the
daemon's kvpull, wedge_detail() in the watchdog's probe,
perturb_rpc("client") in NodeClient.send_tensor and train_fault() in
train.fit's data phase. perturb_rpc("stage") and perturb_relay() wait
for the stage servers' seams (ROADMAP Queue 1 item 7's remainder).

Every firing lands in the flight recorder as a `chaos_inject` event
(kind, seam, counter, target), so an induced incident reconstructs
from /debugz exactly like a real one. Decisions come from
`plan.decide(seed, seam, n)` — counter-indexed, seeded, no wall-clock
randomness (see plan.py's determinism contract).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from dnn_tpu_torch.chaos.plan import FaultPlan, decide

__all__ = ["Injector", "install", "uninstall", "active", "perturb_rpc",
           "perturb_relay", "kv_exhaust", "step_fault", "train_fault",
           "wedge_detail", "corrupt_file", "InjectedFault"]


class InjectedFault(Exception):
    """Marker base: every exception the injector raises derives from it
    (directly or via the transport's own error types), so logs can tell
    an induced failure from an organic one."""


def _record(kind: str, **fields):
    from dnn_tpu_torch.obs import flight

    flight.record("chaos_inject", fault=kind, **fields)


def _injected_unavailable(detail: str):
    """A retryable transport error indistinguishable from a real
    UNAVAILABLE to the client's retry ladder (grpc imported lazily —
    the injector itself stays stdlib-only until an rpc fault fires)."""
    import grpc

    class _InjectedRpcError(grpc.RpcError, InjectedFault):
        def __init__(self, d):
            super().__init__(d)
            self._d = d

        def code(self):
            return grpc.StatusCode.UNAVAILABLE

        def details(self):
            return self._d

    return _InjectedRpcError(detail)


class Injector:
    """Executes a FaultPlan's IN-PROCESS faults. Thread-safe: seams are
    hit from the gRPC event loop, the batcher worker and the watchdog
    thread concurrently; one lock guards the counters."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._counters: dict = {}      # seam -> consultations so far
        self._fired: dict = {}         # fault index -> firings so far
        self._t0 = time.monotonic()    # wedge windows anchor here
        self._wedge_until: Optional[float] = None  # manual activation
        self._wedge_logged = False
        self._faults = list(plan.inprocess_faults())

    # -- internals -----------------------------------------------------

    def _tick(self, seam: str) -> int:
        with self._lock:
            n = self._counters.get(seam, 0)
            self._counters[seam] = n + 1
            return n

    def _take(self, idx: int, fault) -> bool:
        """Consume one firing of fault `idx` if budget remains."""
        with self._lock:
            fired = self._fired.get(idx, 0)
            if fired >= fault.count:
                return False
            self._fired[idx] = fired + 1
            return True

    def _match_p(self, kinds, seam_group: str, n: int):
        """First budgeted probabilistic fault of `kinds` whose seam
        matches and whose seeded decision fires at counter n."""
        for idx, f in enumerate(self._faults):
            if f.kind not in kinds:
                continue
            if f.seam and f.seam != seam_group:
                continue
            if decide(self.plan.seed, f"{f.kind}:{f.seam}", n) < f.p \
                    and self._take(idx, f):
                return f
        return None

    # -- seams ---------------------------------------------------------

    def perturb_rpc(self, seam_group: str, target: str = ""):
        n = self._tick(f"rpc:{seam_group}")
        f = self._match_p(("rpc_drop", "rpc_delay", "rpc_corrupt"),
                          seam_group, n)
        if f is None:
            return
        _record(f.kind, seam=seam_group, n=n, target=target)
        if f.kind == "rpc_delay":
            time.sleep(f.delay_s)
            return
        if f.kind == "rpc_drop":
            raise _injected_unavailable(
                f"chaos: injected rpc drop (seam={seam_group}, n={n})")
        from dnn_tpu_torch.comm.wirecodec import PayloadCorruptError

        raise PayloadCorruptError(
            f"chaos: injected payload corruption (seam={seam_group}, "
            f"n={n})")

    def perturb_relay(self) -> bool:
        """Relay-frame seam. Returns True when the frame should be
        DROPPED (caller discards it); raises for corruption."""
        n = self._tick("relay")
        f = self._match_p(("relay_drop", "relay_corrupt"), "", n)
        if f is None:
            return False
        _record(f.kind, n=n)
        if f.kind == "relay_drop":
            return True
        from dnn_tpu_torch.comm.wirecodec import PayloadCorruptError

        raise PayloadCorruptError(
            f"chaos: injected relay frame corruption (n={n})")

    def kv_exhaust(self) -> bool:
        n = self._tick("kv")
        for f in self._faults:
            if f.kind != "kv_exhaust" or f.from_n < 0:
                continue
            if f.from_n <= n < f.from_n + f.count:
                _record("kv_exhaust", n=n)
                return True
        return False

    def step_fault(self):
        n = self._tick("step")
        for f in self._faults:
            if f.kind != "step_fault" or f.at_n < 0:
                continue
            if f.at_n <= n < f.at_n + f.count:
                _record("step_fault", n=n)
                raise RuntimeError(
                    f"chaos: injected device step fault (step n={n})")

    def train_fault(self) -> Optional[dict]:
        """Training-loop seam (train.fit's input phase): a `train_fault`
        fires at exact step counters and returns a DIRECTIVE rather
        than raising — the loop executes it inside its data window, so
        the injected cost lands exactly where the fault claims to live.
        `target` picks the mode: "nan" (default) poisons the batch's
        float leaves — the gradient-sentinel test vector — and "sleep"
        stalls for `delay_s` — the data_stall attribution vector."""
        n = self._tick("train")
        for f in self._faults:
            if f.kind != "train_fault" or f.at_n < 0:
                continue
            if f.at_n <= n < f.at_n + f.count:
                mode = f.target or "nan"
                _record("train_fault", n=n, mode=mode)
                return {"mode": mode, "delay_s": f.delay_s}
        return None

    def kv_migrate(self):
        """KV-tier migration seam (runtime/lm_server kvpull): a
        `kv_migrate_fault` severs the pull AS IF the donor died
        mid-migration — the adopter must take its kvtier_fallback
        path (re-prefill loud), never adopt partial blocks. Counter-
        positioned like step_fault for deterministic replay."""
        n = self._tick("kv_migrate")
        for f in self._faults:
            if f.kind != "kv_migrate_fault" or f.at_n < 0:
                continue
            if f.at_n <= n < f.at_n + f.count:
                _record("kv_migrate_fault", n=n)
                raise ConnectionError(
                    f"chaos: injected donor death mid-migration "
                    f"(pull n={n})")

    # -- wedge (watchdog probe hook) ------------------------------------

    def activate_wedge(self, duration_s: Optional[float] = None):
        """Manual wedge window (tests / the probe driver); None = until
        clear_wedge()."""
        with self._lock:
            self._wedge_until = (float("inf") if duration_s is None
                                 else time.monotonic() + duration_s)
            self._wedge_logged = False

    def clear_wedge(self):
        with self._lock:
            self._wedge_until = None
            self._wedge_logged = False

    def wedge_detail(self) -> Optional[str]:
        """Non-None while a wedge_device fault window is open: the
        watchdog probe reports THIS detail with timed_out=True instead
        of touching the device. Plan windows anchor at install time."""
        now = time.monotonic()
        active_f = None
        with self._lock:
            if self._wedge_until is not None and now < self._wedge_until:
                active_f = "manual"
            else:
                for f in self._faults:
                    if f.kind != "wedge_device":
                        continue
                    if f.at_s <= now - self._t0 < f.at_s + (
                            f.duration_s or float("inf")):
                        active_f = f"plan@{f.at_s:g}s"
                        break
            if active_f is None:
                self._wedge_logged = False
                return None
            first = not self._wedge_logged
            self._wedge_logged = True
        if first:  # once per window, not once per probe period
            _record("wedge_device", window=active_f)
        return f"chaos: injected device wedge ({active_f})"


# ----------------------------------------------------------------------
# module-level seam API (one global check when chaos is off)
# ----------------------------------------------------------------------

_active: Optional[Injector] = None


def install(plan) -> Injector:
    """Install `plan` (a FaultPlan, dict, or JSON/path string) as THIS
    process's injector. Replaces any previous one. Records the install
    as a flight event so the incident timeline starts with its cause."""
    global _active
    if isinstance(plan, Injector):
        inj = plan
    elif isinstance(plan, FaultPlan):
        inj = Injector(plan)
    elif isinstance(plan, dict):
        inj = Injector(FaultPlan.from_dict(plan))
    else:
        inj = Injector(FaultPlan.from_cli(str(plan)))
    _active = inj
    _record("install", seed=inj.plan.seed, faults=len(inj.plan.faults))
    return inj


def uninstall():
    global _active
    _active = None


def active() -> Optional[Injector]:
    return _active


def perturb_rpc(seam_group: str, target: str = ""):
    # "client": NodeClient.send_tensor; "stage" has no caller yet (the
    # stage servers' seam, ROADMAP Queue 1 item 7's remainder)
    inj = _active
    if inj is not None:
        inj.perturb_rpc(seam_group, target)


def perturb_relay() -> bool:
    # no caller yet: Relay's ingress seam is ROADMAP Queue 1 item 7's
    # remainder
    inj = _active
    return inj.perturb_relay() if inj is not None else False


def kv_exhaust() -> bool:
    inj = _active
    return inj.kv_exhaust() if inj is not None else False


def step_fault():
    inj = _active
    if inj is not None:
        inj.step_fault()


def train_fault() -> Optional[dict]:
    # train.fit's data phase
    inj = _active
    return inj.train_fault() if inj is not None else None


def kv_migrate():
    inj = _active
    if inj is not None:
        inj.kv_migrate()


def wedge_detail() -> Optional[str]:
    inj = _active
    return inj.wedge_detail() if inj is not None else None


def corrupt_file(path: str, *, seed: int = 0, nbytes: int = 32) -> str:
    """Deterministically corrupt `nbytes` of `path` in place (seeded
    positions + values via plan.decide) — the ckpt_corrupt fault.
    Records a flight event naming the file; returns the path. The
    corruption targets the file BODY (offset >= 1) so a zero-length or
    1-byte file still changes detectably."""
    size = os.path.getsize(path)
    if size == 0:
        with open(path, "wb") as f:
            f.write(b"\x00")
        _record("ckpt_corrupt", path=path, bytes=1)
        return path
    with open(path, "r+b") as f:
        for i in range(nbytes):
            pos = int(decide(seed, f"corrupt:{path}", i) * size)
            f.seek(min(pos, size - 1))
            old = f.read(1)
            f.seek(min(pos, size - 1))
            f.write(bytes([old[0] ^ 0xFF if old else 0xFF]))
    _record("ckpt_corrupt", path=path, bytes=nbytes)
    return path
