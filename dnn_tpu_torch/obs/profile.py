"""On-demand device profiling on torch.profiler (port of
dnn_tpu/obs/profile.py; JAX's capture is jax.profiler, this one Kineto:
CUPTI's device activity on the card, the host's operators and
record_function ranges on every thread).

  * `POST /profilez?ms=N` on the obs HTTP endpoint (obs/http.py)
    captures N milliseconds into a bounded spool directory and returns
    the capture path;
  * `POST /profilez?auto=1&threshold_ms=T[&ms=N]` arms the auto
    trigger: the LM daemon's batcher worker captures the next pool step
    after one exceeds T milliseconds (runtime/lm_server.py);
  * `annotation(name)` / `annotation_ctx(name)` / `step_annotation(step)`
    are the obs-gated host ranges (torch.profiler.record_function) that
    make captures readable: the batcher wraps each decode step and each
    prefill chunk in them. `annotation_ctx` costs a shared nullcontext
    while no capture is recording (`capturing()`).

Spool layout, one directory a capture:

    <root>/capture-<ms since epoch, hex>/
        <host>.<pid>.pt.trace.json   the Chrome trace export_chrome_trace
                                     writes (Perfetto loads it)
        meta.json                    perf_begin / perf_end (perf_counter,
                                     the StepClock's clock), wall bounds,
                                     the step-counter range and the
                                     backend ("cuda" or "cpu")

The spool keeps the newest `keep` captures (8; DNN_TPU_OBS_PROFILE_KEEP
overrides). Each capture starts with a `obs.profile.start_trace` range
on the capturing thread, and perf_begin is read as it ends: that range's
end is where meta's perf_begin sits on the trace's microsecond axis
(obs/timeline.analyze anchors there, as JAX's anchors at the end of
jax.profiler's own start_trace span). CUPTI's first start costs seconds
on the card; they fall before the anchor, so they never read as device
idle.

One session a process. torch.profiler does not refuse a second session:
it silently takes over the first one's state, and the first one's stop
then crashes the process. So every session of this package goes through
`exclusive()` — the module lock, and a check that no session started
elsewhere is recording — and a capture against a busy profiler raises
ProfilerBusy (409 on /profilez) instead of queueing or corrupting.

Host ranges of other threads: the session is started with Kineto's
`profile_all_threads`, so a capture that POST /profilez starts on the
HTTP thread records the batcher worker's step annotations too.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import socket
import threading
import time
from typing import Iterator, Optional

__all__ = ["ProfilerBusy", "CaptureFailed", "capture", "capture_step",
           "spool_dir", "list_captures", "trace_files", "annotation",
           "annotation_ctx", "step_annotation", "capturing",
           "mark_recording", "exclusive", "Profiler", "START_MARKER"]

#: the range each capture opens with; its end is meta's perf_begin
START_MARKER = "obs.profile.start_trace"


class ProfilerBusy(RuntimeError):
    """A profiler session is already recording in this process."""


class CaptureFailed(RuntimeError):
    """The profiler machinery failed around a step that `capture_step`
    ran: `.result` is the step's output (None when the step did not
    run, `.ran` False)."""

    def __init__(self, msg: str, *, result=None, ran: bool = False):
        super().__init__(msg)
        self.result = result
        self.ran = ran


_capture_lock = threading.Lock()


def spool_dir() -> str:
    """$DNN_TPU_OBS_DIR/profiles (obs/flight.default_dump_dir anchors
    the obs artifact root)."""
    from dnn_tpu_torch.obs.flight import default_dump_dir

    return os.path.join(default_dump_dir(), "profiles")


def list_captures(root: Optional[str] = None) -> list:
    """Capture dirs in the spool, oldest first."""
    root = root or spool_dir()
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, d) for d in os.listdir(root)
                  if d.startswith("capture-"))


def _prune(root: str, keep: int):
    for old in list_captures(root)[:-keep] if keep > 0 else []:
        shutil.rmtree(old, ignore_errors=True)


def trace_files(capture_dir: str) -> list:
    """The Perfetto-loadable trace files inside one capture dir."""
    return sorted(glob.glob(os.path.join(capture_dir, "*.trace.json"))
                  + glob.glob(os.path.join(capture_dir, "*.trace.json.gz")))


_capturing = False  # read by annotation_ctx: ranges are only paid for
# while a capture records


def capturing() -> bool:
    return _capturing


@contextlib.contextmanager
def mark_recording() -> Iterator[None]:
    """Mark a session driven outside this module's captures
    (utils/tracing.trace_to) as recording, so annotation_ctx emits
    during it."""
    global _capturing
    prev = _capturing
    _capturing = True
    try:
        yield
    finally:
        _capturing = prev


def _external_session() -> bool:
    """True when a torch.profiler session is recording in this process
    (started anywhere: a second start would take it over)."""
    import torch

    return bool(torch._C._autograd._profiler_enabled())


@contextlib.contextmanager
def exclusive() -> Iterator[None]:
    """Hold the process's one profiler session: raises ProfilerBusy when
    a capture of this module holds it, or a session started elsewhere is
    recording. Every torch.profiler session of the port (captures,
    utils/tracing.trace_to, chip_smoke's kernel timings) opens inside
    this."""
    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture is already in flight")
    try:
        if _external_session():
            raise ProfilerBusy("a torch.profiler session started elsewhere "
                               "is recording in this process")
        yield
    finally:
        _capture_lock.release()


def new_session(**kw):
    """An unstarted torch.profiler.profile over the host and, where a
    card is present, the device, recording every thread's host ranges
    (Kineto's profile_all_threads; a torch without it raises here)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
        **kw)


def _step_counter() -> Optional[int]:
    """The active StepClock's step counter (obs/timeline.py), or None
    without one."""
    from dnn_tpu_torch.obs.timeline import active_clock

    clk = active_clock()
    return None if clk is None else int(clk.steps_total)


def _backend() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def _traced(capture_root: Optional[str], keep: int) -> Iterator[str]:
    """One exclusive session around the body; yields the capture dir.
    The trace and meta.json are written when the body ends; any failure
    of the machinery raises (a capture that did not land never reads as
    one that did)."""
    global _capturing
    import torch
    from torch.profiler import record_function

    with exclusive():
        root = capture_root or spool_dir()
        path = os.path.join(root, f"capture-{int(time.time() * 1e3):x}")
        os.makedirs(path, exist_ok=True)
        prof = new_session()
        prof.start()
        try:
            with record_function(START_MARKER):
                pass
            # read as the marker ends: (perf_counter - perf_begin) maps a
            # StepClock stamp onto the trace's axis from the marker's end
            meta = {"perf_begin": time.perf_counter(),
                    "t_begin_unix": time.time(),
                    "step_begin": _step_counter(),
                    "backend": _backend()}
            _capturing = True
            try:
                yield path
            finally:
                _capturing = False
                meta["perf_end"] = time.perf_counter()
                meta["t_end_unix"] = time.time()
                meta["step_end"] = _step_counter()
                if torch.cuda.is_available():
                    # the work queued inside the window finishes, so its
                    # device activity is in the trace
                    torch.cuda.synchronize()
        finally:
            prof.stop()
        name = f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(path, name))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    try:
        keep_n = int(os.environ["DNN_TPU_OBS_PROFILE_KEEP"])
    except (KeyError, ValueError):
        keep_n = keep
    _prune(root, keep_n)


def capture(duration_ms: float = 1000.0, *,
            capture_root: Optional[str] = None, keep: int = 8) -> str:
    """Capture `duration_ms` of whatever the process does (the serving
    worker keeps stepping; this thread sleeps inside the session).
    Returns the capture dir; flight-records the capture."""
    from dnn_tpu_torch.obs import flight

    with _traced(capture_root, keep) as path:
        time.sleep(max(0.0, float(duration_ms)) / 1e3)
    flight.record("profile_capture", path=path, ms=float(duration_ms))
    return path


def capture_step(fn, *, capture_root: Optional[str] = None,
                 keep: int = 8, extra_s: float = 0.0):
    """Capture exactly one call of `fn` (the auto trigger's "next pool
    step"); `extra_s` extends the session past the call. Returns
    (capture_dir, fn's result).

    ProfilerBusy and fn's own exceptions propagate. A failure of the
    profiler machinery (start, export, an unwritable spool) raises
    CaptureFailed carrying fn's result when fn ran, so the caller keeps
    the step's output and reports the miss; the failure is also a
    `profile_capture_failed` flight event. The first capture on the card
    stalls the calling thread for CUPTI's start and the export (seconds):
    an operator-armed post-mortem's cost, not a steady-state tax."""
    from dnn_tpu_torch.obs import flight

    t0 = time.perf_counter()
    ran, out, step_err, step_ms, path = False, None, None, None, None
    try:
        with _traced(capture_root, keep) as path:
            t1 = time.perf_counter()
            try:
                out = fn()
                ran = True
            except Exception as e:
                step_err = e
                raise
            step_ms = round((time.perf_counter() - t1) * 1e3, 3)
            if extra_s > 0:
                time.sleep(extra_s)
    except ProfilerBusy:
        raise
    except Exception as e:
        if step_err is not None:
            raise  # the step's own failure is the caller's
        flight.record("profile_capture_failed", error=str(e)[:200],
                      step_ran=ran)
        raise CaptureFailed(f"profiler capture failed: {e}", result=out,
                            ran=ran) from e
    flight.record("profile_capture", path=path, trigger="auto",
                  step_ms=step_ms,
                  capture_ms=round((time.perf_counter() - t0) * 1e3, 3))
    return path, out


# ----------------------------------------------------------------------
# host annotations
# ----------------------------------------------------------------------

_NULL_CTX = contextlib.nullcontext()


def annotation_ctx(name: str):
    """Hot-path form: a torch.profiler.record_function range while obs
    is on AND a capture records, else a shared nullcontext (a call and
    two checks, no generator)."""
    from dnn_tpu_torch import obs

    if not _capturing or not obs.enabled():
        return _NULL_CTX
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def annotation(name: str) -> Iterator[None]:
    """Named host range in captured profiles; nothing when obs is off or
    no capture records. For ms-scale paths; per-step code uses
    `annotation_ctx`."""
    with annotation_ctx(name):
        yield


@contextlib.contextmanager
def step_annotation(step: int, name: str = "step") -> Iterator[None]:
    """Mark one pipeline or training step (`<name>#<step>`, torch's
    ProfilerStep naming); obs-gated like JAX's StepTraceAnnotation."""
    from dnn_tpu_torch import obs

    if not obs.enabled():
        yield
        return
    from torch.profiler import record_function

    with record_function(f"{name}#{int(step)}"):
        yield


# ----------------------------------------------------------------------
# the /profilez backend
# ----------------------------------------------------------------------

class Profiler:
    """On-demand capture plus, with `arm_target`, the auto trigger's
    arm. `arm_target` is any object with a writable `auto_profile`
    attribute (the LM daemon: its worker reads it once a step)."""

    def __init__(self, *, capture_root: Optional[str] = None,
                 arm_target=None, keep: int = 8):
        self.capture_root = capture_root or spool_dir()
        self.keep = keep
        self._arm_target = arm_target

    def capture(self, duration_ms: float) -> str:
        return capture(duration_ms, capture_root=self.capture_root,
                       keep=self.keep)

    @property
    def can_arm(self) -> bool:
        return self._arm_target is not None

    def arm_auto(self, threshold_ms: float, duration_ms: float = 0.0):
        """Arm the next-slow-step capture; duration_ms > 0 extends it
        past the captured step (0: exactly one step)."""
        if self._arm_target is None:
            raise ValueError("this endpoint has no step loop to arm "
                             "(stage servers capture on demand only)")
        self._arm_target.auto_profile = {
            "threshold_s": float(threshold_ms) / 1e3,
            "extra_s": max(0.0, float(duration_ms)) / 1e3,
            "capture_root": self.capture_root, "keep": self.keep,
        }

    def disarm(self):
        if self._arm_target is not None:
            self._arm_target.auto_profile = None

    def status(self) -> dict:
        armed = getattr(self._arm_target, "auto_profile", None) \
            if self._arm_target is not None else None
        return {
            "captures": list_captures(self.capture_root),
            "armed": None if armed is None else {
                "threshold_ms": armed["threshold_s"] * 1e3,
                "extra_ms": armed["extra_s"] * 1e3},
        }
