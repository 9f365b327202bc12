"""trainlens: the training-step observatory — MFU, stall attribution,
gradient health, checkpoint freshness (port of dnn_tpu/obs/trainlens.py,
copied: the clock is host bookkeeping, so the same phase stamps give the
same summary, Prometheus text and trace in both packages; the port's
summary also names the peak its MFU divides by, `peak_flops_source`).

Training was the one ROADMAP pillar with zero observability: `fit()`
loops, the dp×tp/zero1 sharded steps, and the checkpoint path emitted
nothing — no clock, no goodput, no flight events — while ROADMAP item 2
names "step-time MFU ... as an asserted ledger row" as the pillar's
metric. This module is the instrument, in the StepClock pattern, in
three connected pieces on the existing obs substrate:

  * **TrainClock** — the training loop's phase clock, in the StepClock
    idiom (single producer, one-None-check gate, 32-step batched
    registry flush honoring the <2% obs contract). `train.fit` splits
    every iteration into named contiguous phases:

        data      next(batch_iter): host input pipeline (+ any chaos
                  train_fault sleep — injected stalls land exactly here)
        dispatch  the jit call itself, call-to-return
        wait      dispatch-return -> the step's outputs done on the
                  card (torch.cuda.synchronize): the window the step's
                  kernels are in flight
        ckpt      periodic save_train_state wall
        eval      periodic in-training evaluation wall
        obs       sentinel + callbacks + this clock's own bookkeeping

    Derived series: `data_stall_fraction` = data / wall (THE input-
    pipeline starvation ratchet), steps/s and tokens/s over the ring's
    newest 60 s, and step-time **MFU** = flops_per_step × steps/s ÷
    peak — priced by the utils/flops.py training helpers
    (gpt_train_step_flops / llama_train_step_flops, 3× forward,
    microbatch/remat-aware) against the same `device_peak_flops`
    roofline the serving goodput gauges use (the card's bf16 dense peak
    from utils/flops._CUDA_PEAKS; DNN_TPU_PEAK_FLOPS states one, the
    CPU host's opt-in). Exported as weak scrape-time gauges
    (`dnn_tpu_train_mfu`, `dnn_tpu_train_tokens_per_sec`,
    `dnn_tpu_train_data_stall`, ...), a `/trainz` endpoint
    (JSON|prom|trace) next to /stepz, a Perfetto host-track export,
    and `python -m dnn_tpu_torch.obs trainlens [--url URL | PATH |
    --selftest]`.

  * **GradSentinel** — gradient-health sentinels over the opt-in
    on-device stats leg the train steps grow (`grad_stats=True`:
    global grad-norm, update/param-norm ratio, nonfinite count — ONE
    small-array readback per step, donation-safe). Host-side detectors
    feed bounded flight events: `grad_spike` (EMA spike detector),
    `loss_nan` (nonfinite loss or nonfinite grads — latched per
    episode, and optionally a full incident bundle via the
    forensics machinery, obs/slo.write_incident_bundle, so a diverging
    run produces a /debugz post-mortem instead of a silent flat loss),
    `train_stall` (update ratio pinned at ~0 for N consecutive steps —
    the wedged-optimizer signature).

  * **Checkpoint observability** — `note_ckpt_saved`/`note_ckpt_restored`
    (wired through train.fit / resume_or_init): save/restore
    duration+bytes histograms, `dnn_tpu_ckpt_last_good_step` /
    `dnn_tpu_ckpt_staleness_seconds` gauges (how much work a crash
    would lose RIGHT NOW), and `ckpt_saved`/`ckpt_restored` flight
    events, so a restore-latest-good incident reconstructs from
    /debugz.

On the card, chip_smoke.py's [obs2] T leg holds the contract: phase
coverage >= 95% of the external wall, the MFU against one worked out
from the wall and gpt_train_step_flops, the grad-norm against a plain
total norm, an injected sleep in its step's data phase, an injected NaN
-> loss_nan within 2 steps.

The clock is pure perf_counter bookkeeping; peak-FLOPs resolution
touches utils.flops (and torch.cuda) lazily, only when no explicit
`peak_flops` was given.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

from dnn_tpu_torch import obs as _obs
from dnn_tpu_torch.obs import flight
from dnn_tpu_torch.obs.timeline import STEP_BUCKETS
from dnn_tpu_torch.utils.metrics import labeled

__all__ = ["TrainClock", "GradSentinel", "TRAIN_PHASES",
           "active_trainlens", "note_ckpt_saved", "note_ckpt_restored",
           "CKPT_SECONDS_BUCKETS", "CKPT_BYTES_BUCKETS"]

#: phase names, in within-step order
TRAIN_PHASES = ("data", "dispatch", "wait", "ckpt", "eval", "obs")

#: checkpoint save/restore duration bounds (seconds): a toy npz lands in
#: ms; a multihost allgather + full-state write can take minutes
CKPT_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 5.0, 30.0, 120.0, 600.0)

#: checkpoint size bounds (bytes): test trees through full LLM states
CKPT_BYTES_BUCKETS = (1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11)


class _TrainRec:
    """One training iteration's phase boundaries: t0 at loop entry, then
    (phase, t) marks in order — phase P's duration is its mark minus the
    previous boundary; the remainder after the last mark folds into
    "obs" (the clock's own end-of-iteration bookkeeping). Folded lazily
    off the hot path, exactly like timeline._StepRec."""

    __slots__ = ("t0", "t_end", "marks", "tokens", "wall", "phases")

    def __init__(self, t0: float):
        self.t0 = t0
        self.t_end = t0
        self.marks: list = []
        self.tokens = 0
        self.wall = 0.0
        self.phases: "Optional[Dict[str, float]]" = None


def _fold(rec: _TrainRec) -> _TrainRec:
    """Fold a published record's marks into per-phase durations (in
    place, idempotent). Runs at flush and scrape time only."""
    if rec.phases is not None:
        return rec
    phases: Dict[str, float] = {}
    t = rec.t0
    for name, tm in rec.marks:
        phases[name] = tm - t
        t = tm
    if rec.t_end > t:
        phases["obs"] = phases.get("obs", 0.0) + (rec.t_end - t)
    rec.wall = rec.t_end - rec.t0
    rec.phases = phases
    return rec


class TrainClock:
    """Per-phase training-step clock. Attach via `TrainClock(...).
    install()` before calling train.fit — fit picks up the active clock
    (or takes one explicitly) and feeds it behind the obs gate.

    Producer protocol (what train.fit runs each iteration):

        rec = clock.begin()          # None when the obs gate is off
        batch = next(batch_iter)     # -> "data"
        clock.mark(rec, "data")
        out = step_fn(state, batch)  # -> "dispatch"
        clock.mark(rec, "dispatch")
        block_until_ready(loss)      # -> "wait"
        clock.mark(rec, "wait")
        ... ckpt / eval ...          # -> "ckpt", "eval"
        clock.end(rec, tokens=B*T)   # publishes; bulk-flushes every
                                     # FLUSH_EVERY steps

    `flops_per_step` is the analytic training-step cost at the run's
    pinned shape (utils.flops.gpt_train_step_flops / llama_...);
    `tokens_per_step` the tokens one optimizer step consumes (end()'s
    default). `peak_flops` pins the MFU roofline explicitly; left None
    it resolves lazily from utils.flops.device_peak_flops (the card's
    table / DNN_TPU_PEAK_FLOPS env) the first time a scrape asks — never at
    construction, and never fatally (a CPU host without the env opt-in
    simply reports no MFU rather than a made-up one).

    Threading/registry discipline is StepClock's verbatim: end() is one
    perf_counter read + a GIL-atomic append; `_land()` (ring-only) is
    the half gauge reads may run — a gauge read reaching Metrics.bulk
    would self-deadlock on the registry's non-reentrant lock; flush()
    does the batched histogram bill every FLUSH_EVERY steps and from
    the clock's own scrape surfaces."""

    FLUSH_EVERY = 32

    def __init__(self, capacity: int = 256, *,
                 flops_per_step: Optional[float] = None,
                 tokens_per_step: int = 0,
                 registry=None, peak_flops: Optional[float] = None,
                 now=time.perf_counter):
        self.capacity = int(capacity)
        self._ring: "deque[_TrainRec]" = deque(maxlen=self.capacity)
        self._now = now
        self._lock = threading.Lock()
        self.steps_total = 0
        self.flops_per_step = flops_per_step
        self.tokens_per_step = int(tokens_per_step)
        self._registry = registry
        self._peak = peak_flops
        self._peak_resolved = peak_flops is not None
        self._peak_source = ("explicit peak_flops"
                             if peak_flops is not None else None)
        self._t_last_end: Optional[float] = None
        self._pending_flush: list = []
        self._pending_bulk: list = []
        self._derived_cache = None
        # checkpoint freshness (the supervisor-loop gauges)
        self._ckpt_last_good_step = 0
        self._ckpt_last_good_t: Optional[float] = None
        self._hist_keys = {p: labeled("train.phase_seconds", phase=p)
                           for p in TRAIN_PHASES}
        ref = weakref.ref(self)

        def _weak(method):
            def read():
                c = ref()
                return getattr(c, method)() if c is not None else 0.0
            return read

        # gauge keys are FULL prometheus family names (unlike the
        # clock-internal train.* counter/hist keys): the fleet rollup
        # reads these families off a polled target's /metrics text, so
        # the registry render must emit exactly `dnn_tpu_train_mfu`,
        # not a sanitized `train_mfu`
        self._gauges = {
            "dnn_tpu_train_mfu": _weak("_mfu_read"),
            "dnn_tpu_train_tokens_per_sec": _weak("tokens_per_sec"),
            "dnn_tpu_train_data_stall": _weak("data_stall_fraction"),
            "dnn_tpu_train_steps_per_sec": _weak("steps_per_sec"),
            "dnn_tpu_train_last_wall_ms": _weak("last_wall_ms"),
            "dnn_tpu_ckpt_last_good_step": _weak("_ckpt_step_read"),
            "dnn_tpu_ckpt_staleness_seconds": _weak("ckpt_staleness_s"),
        }

    def install(self) -> "TrainClock":
        """Make this the process's active training clock (what
        train.fit and the module-level ckpt notes pick up)."""
        global _active_trainlens
        _active_trainlens = weakref.ref(self)
        return self

    # -- roofline ------------------------------------------------------

    def peak_flops(self) -> Optional[float]:
        """The MFU denominator, resolved lazily (goodput-style): an
        explicit constructor value wins; else the utils.flops table /
        DNN_TPU_PEAK_FLOPS env the first time asked. Never raises — an
        unresolvable roofline means "no MFU", not a crash."""
        if not self._peak_resolved:
            self._peak_resolved = True
            try:
                from dnn_tpu_torch.utils.flops import (
                    device_peak_flops,
                    peak_flops_source,
                )

                self._peak = device_peak_flops()
                self._peak_source = peak_flops_source()
            except Exception:  # noqa: BLE001 — no card / no driver
                self._peak = None
        return self._peak

    def peak_source(self) -> Optional[str]:
        """What the MFU divides by, in words (the explicit value, the
        DNN_TPU_PEAK_FLOPS env, or the card's table row); None without
        a peak."""
        self.peak_flops()
        return self._peak_source if self._peak is not None else None

    # -- producer side (the fit loop's thread) -------------------------

    def begin(self) -> Optional[_TrainRec]:
        """Start one iteration's record — None when observability is
        off (fit's one None check covers every later site)."""
        if not _obs.enabled():
            return None
        return _TrainRec(self._now())

    def mark(self, rec: _TrainRec, phase: str):
        """Close the current phase at now (one perf_counter read + one
        tuple append on the hot path)."""
        rec.marks.append((phase, self._now()))

    def end(self, rec: _TrainRec, tokens: Optional[int] = None):
        """Stamp and publish one iteration — one perf_counter read and
        ONE GIL-atomic append (StepClock.end's budget discipline); the
        fold and the registry bulk run off this path in flush()."""
        rec.t_end = self._now()
        rec.tokens = self.tokens_per_step if tokens is None else tokens
        self.steps_total += 1
        self._t_last_end = rec.t_end
        pf = self._pending_flush
        pf.append(rec)
        if len(pf) >= self.FLUSH_EVERY:
            self.flush()

    def _land(self):
        """Move the pending batch into the scrape ring — the half of
        flush() ring readers need, and the ONLY half gauge-reachable
        code may run (a reader that reached Metrics.bulk from inside
        the registry's own gauge render would self-deadlock)."""
        if not self._pending_flush:
            return
        with self._lock:
            pending, self._pending_flush = self._pending_flush, []
            self._ring.extend(pending)
            self._pending_bulk.extend(pending)

    def flush(self):
        """Land + bill the accumulated observations in ONE bulk
        registry update. Called every FLUSH_EVERY steps by end() and by
        summary()/render_prom() — never from inside a registry render."""
        m = self._registry if self._registry is not None \
            else _obs.metrics()
        self._land()
        with self._lock:
            pending, self._pending_bulk = self._pending_bulk, []
        if m is None or not pending:
            return
        hists: Dict[str, list] = {}
        walls = []
        tokens = 0
        for r in pending:
            _fold(r)
            for p, v in r.phases.items():
                hists.setdefault(self._hist_keys[p], []).append(v)
            walls.append(r.wall)
            tokens += r.tokens
        hists["train.wall_seconds"] = walls
        m.bulk(counters={"train.steps_total": len(pending),
                         "train.tokens_total": tokens},
               hists=hists, hist_buckets=STEP_BUCKETS,
               gauge_fns=self._gauges)

    # -- checkpoint observability --------------------------------------

    def ckpt_saved(self, step: int, seconds: float, nbytes: float):
        """Feed one completed save: freshness gauges + duration/bytes
        histograms. The flight event is the module helper's job (one
        event per save regardless of how many clocks watch)."""
        self._ckpt_last_good_step = int(step)
        self._ckpt_last_good_t = self._now()
        m = self._registry if self._registry is not None \
            else _obs.metrics()
        if m is None:
            return
        m.observe_hist("train.ckpt_save_seconds", float(seconds),
                       CKPT_SECONDS_BUCKETS)
        m.observe_hist("train.ckpt_save_bytes", float(nbytes),
                       CKPT_BYTES_BUCKETS)
        m.bulk(counters={"train.ckpt_saves": 1},
               gauge_fns=self._gauges)

    def ckpt_restored(self, step: int, seconds: float, nbytes: float):
        """Feed one completed restore. The restored step is also the
        last KNOWN-GOOD step — a fresh resume must not report infinite
        staleness until the first new save."""
        self._ckpt_last_good_step = int(step)
        self._ckpt_last_good_t = self._now()
        m = self._registry if self._registry is not None \
            else _obs.metrics()
        if m is None:
            return
        m.observe_hist("train.ckpt_restore_seconds", float(seconds),
                       CKPT_SECONDS_BUCKETS)
        m.observe_hist("train.ckpt_restore_bytes", float(nbytes),
                       CKPT_BYTES_BUCKETS)
        m.bulk(counters={"train.ckpt_restores": 1},
               gauge_fns=self._gauges)

    def ckpt_staleness_s(self) -> float:
        """Seconds since the last known-good checkpoint — the work a
        crash right now would lose. 0.0 before any save/restore (a run
        with checkpointing disabled reads as 'nothing to lose' rather
        than alarming forever)."""
        t = self._ckpt_last_good_t
        return 0.0 if t is None else max(0.0, self._now() - t)

    def _ckpt_step_read(self) -> float:
        return float(self._ckpt_last_good_step)

    # -- derived series (scrape-time reads over the ring) --------------

    def _sums(self, last: Optional[int] = None):
        self._land()  # ring readers: land only, never the registry
        with self._lock:
            recs = list(self._ring)
        if last:
            recs = recs[-last:]
        tot: Dict[str, float] = {p: 0.0 for p in TRAIN_PHASES}
        wall = 0.0
        tokens = 0
        for r in recs:
            _fold(r)
            for p, v in r.phases.items():
                tot[p] = tot.get(p, 0.0) + v
            wall += r.wall
            tokens += r.tokens
        return recs, tot, wall, tokens

    def data_stall_fraction(self) -> float:
        """data-phase share of step wall over the ring — THE input-
        pipeline starvation series (memoized per landed step, like
        StepClock._derived: a /metrics render reads several gauges in
        one scrape and must not re-walk the ring for each)."""
        key = self.steps_total
        cached = self._derived_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        _, tot, wall, _ = self._sums()
        frac = tot["data"] / wall if wall > 0 else 0.0
        self._derived_cache = (key, frac)
        return frac

    def _rate(self):
        """(steps/s, tokens/s) over the ring's newest 60 s — computed
        at scrape time over the span the surviving records cover."""
        self._land()  # gauge-reachable: land only (registry deadlock)
        now = self._now()
        with self._lock:
            recent = [r for r in self._ring if now - r.t0 <= 60.0]
            oldest = self._ring[0].t0 if self._ring else now
        if not recent:
            return 0.0, 0.0
        span = max(min(60.0, now - oldest), 1e-9)
        return len(recent) / span, sum(r.tokens for r in recent) / span

    def steps_per_sec(self) -> float:
        return self._rate()[0]

    def tokens_per_sec(self) -> float:
        return self._rate()[1]

    def mfu(self) -> Optional[float]:
        """Step-time model-FLOPs utilization: flops_per_step × steps/s
        ÷ peak. None (not 0.0) when the cost or the roofline is unknown
        — callers omit the field rather than publish a made-up one."""
        peak = self.peak_flops()
        if peak is None or not self.flops_per_step:
            return None
        return self.flops_per_step * self.steps_per_sec() / peak

    def _mfu_read(self) -> float:
        return self.mfu() or 0.0

    def last_wall_ms(self) -> float:
        self._land()  # gauge-reachable: land only (registry deadlock)
        with self._lock:
            if not self._ring:
                return 0.0
            rec = self._ring[-1]
        return _fold(rec).wall * 1e3

    def last_step_age_s(self) -> Optional[float]:
        with self._lock:
            t = self._t_last_end
        return None if t is None else max(0.0, self._now() - t)

    def records(self, last: Optional[int] = None) -> List[dict]:
        """Ring records as plain dicts (newest last) — what the probe's
        coverage assertion reads."""
        self._land()
        with self._lock:
            recs = list(self._ring)
        if last:
            recs = recs[-last:]
        return [{"t0": r.t0, "wall": _fold(r).wall, "tokens": r.tokens,
                 "phases": dict(r.phases), "marks": list(r.marks)}
                for r in recs]

    # -- export surfaces -----------------------------------------------

    def summary(self, last: Optional[int] = None) -> dict:
        """The /trainz JSON payload: per-phase totals/means/fractions
        over the ring (or the newest `last` steps) plus the derived
        series and checkpoint freshness."""
        self.flush()  # scrapes read fresh histograms/counters
        recs, tot, wall, tokens = self._sums(last)
        n = len(recs)
        phases = {}
        for p in TRAIN_PHASES:
            s = tot.get(p, 0.0)
            phases[p] = {"s": round(s, 6),
                         "frac": round(s / wall, 4) if wall > 0 else 0.0,
                         "mean_ms": round(s / n * 1e3, 4) if n else 0.0}
        sps, tps = self._rate()
        m = self.mfu()
        return {
            "steps_total": self.steps_total,
            "window_steps": n,
            "window_wall_s": round(wall, 6),
            "tokens": tokens,
            "phases": phases,
            "data_stall_fraction": round(
                tot["data"] / wall, 4) if wall > 0 else 0.0,
            "steps_per_sec": round(sps, 3),
            "tokens_per_sec": round(tps, 1),
            "flops_per_step": self.flops_per_step,
            "peak_flops": self.peak_flops(),
            "peak_flops_source": self.peak_source(),
            "mfu": None if m is None else round(m, 6),
            "last_wall_ms": round(self.last_wall_ms(), 4),
            "ckpt": {
                "last_good_step": self._ckpt_last_good_step,
                "staleness_s": round(self.ckpt_staleness_s(), 3),
            },
        }

    def status_component(self) -> dict:
        """A /statusz `train` component: progress at a glance.
        Informational — state stays "ok" (divergence escalation is the
        sentinel's flight-event job, not a health state)."""
        s = self.summary()
        age = self.last_step_age_s()
        mfu_txt = ("" if s["mfu"] is None
                   else f", mfu {s['mfu']:.1%}")
        return {
            "state": "ok",
            "detail": (f"step {s['steps_total']}, last "
                       f"{s['last_wall_ms']:.1f} ms "
                       f"({'never' if age is None else f'{age:.1f}s ago'})"
                       f", data stall {s['data_stall_fraction']:.0%}"
                       f"{mfu_txt}"),
            "steps_total": s["steps_total"],
            "last_step_age_s": None if age is None else round(age, 3),
            "data_stall_fraction": s["data_stall_fraction"],
            "mfu": s["mfu"],
        }

    def render_prom(self, last: Optional[int] = None) -> str:
        """The ?format=prom re-export: the summary as gauges, for
        scrape-only collectors. Family names match the weak gauges the
        registry exports, so a /trainz-only scrape and a /metrics
        scrape read the same series."""
        from dnn_tpu_torch.utils.metrics import Metrics, render_prometheus

        s = self.summary(last)
        m = Metrics()
        m.set("dnn_tpu_train_steps_total", float(s["steps_total"]))
        m.set("dnn_tpu_train_window_wall_s", float(s["window_wall_s"]))
        m.set("dnn_tpu_train_mfu", float(s["mfu"] or 0.0))
        m.set("dnn_tpu_train_tokens_per_sec", float(s["tokens_per_sec"]))
        m.set("dnn_tpu_train_data_stall",
              float(s["data_stall_fraction"]))
        m.set("dnn_tpu_train_steps_per_sec", float(s["steps_per_sec"]))
        m.set("dnn_tpu_train_last_wall_ms", float(s["last_wall_ms"]))
        m.set("dnn_tpu_ckpt_last_good_step",
              float(s["ckpt"]["last_good_step"]))
        m.set("dnn_tpu_ckpt_staleness_seconds",
              float(s["ckpt"]["staleness_s"]))
        for p, d in s["phases"].items():
            m.set(labeled("dnn_tpu_train_phase_seconds_total", phase=p),
                  d["s"])
            m.set(labeled("dnn_tpu_train_phase_frac", phase=p),
                  d["frac"])
        return render_prometheus(m)

    def chrome_trace(self, last: Optional[int] = None) -> dict:
        """The ring as a Perfetto-loadable HOST track: one process
        ("trainlens"), one slice per phase per step, timestamps rebased
        so the oldest exported slice starts at ts 0 (absolute
        perf_counter stamps render days into the timeline)."""
        self._land()
        with self._lock:
            recs = list(self._ring)
        if last:
            recs = recs[-last:]
        origin = recs[0].t0 if recs else 0.0
        events = [
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "trainlens"}},
            {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
             "args": {"name": "train-step phases"}},
        ]
        for i, r in enumerate(recs):
            t = r.t0
            args = {"step": i, "tokens": r.tokens}
            for name, tm in r.marks:
                events.append({"ph": "X", "pid": 1, "tid": 1,
                               "name": name,
                               "ts": (t - origin) * 1e6,
                               "dur": (tm - t) * 1e6,
                               "args": args})
                t = tm
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# the process's active training clock (train.fit picks it up)
_active_trainlens: "Optional[weakref.ref]" = None


def active_trainlens() -> Optional[TrainClock]:
    ref = _active_trainlens
    if ref is None:
        return None
    return ref()


# ----------------------------------------------------------------------
# checkpoint observability: the module-level wires train.py calls
# ----------------------------------------------------------------------

def note_ckpt_saved(step: int, seconds: float, nbytes: float, *,
                    clock: Optional[TrainClock] = None):
    """One completed checkpoint save: a `ckpt_saved` flight event (the
    /debugz record a restore-latest-good post-mortem needs) + the
    active clock's freshness gauges and duration/bytes histograms.
    One boolean check when observability is off."""
    if not _obs.enabled():
        return
    flight.record("ckpt_saved", step=int(step),
                  seconds=round(float(seconds), 6),
                  bytes=int(nbytes))
    c = clock if clock is not None else active_trainlens()
    if c is not None:
        c.ckpt_saved(step, seconds, nbytes)


def note_ckpt_restored(step: int, seconds: float, nbytes: float, *,
                       clock: Optional[TrainClock] = None):
    """One completed checkpoint restore (resume_or_init's hit path)."""
    if not _obs.enabled():
        return
    flight.record("ckpt_restored", step=int(step),
                  seconds=round(float(seconds), 6),
                  bytes=int(nbytes))
    c = clock if clock is not None else active_trainlens()
    if c is not None:
        c.ckpt_restored(step, seconds, nbytes)


# ----------------------------------------------------------------------
# gradient-health sentinels
# ----------------------------------------------------------------------

class GradSentinel:
    """Host-side detectors over the train step's on-device stats leg.

    `observe(step, loss, stats)` each iteration — `stats` is the
    3-vector the `grad_stats=True` steps return ([global grad-norm,
    update/param-norm ratio, nonfinite grad count], already on host),
    or None when the step runs without the leg (the loss-only checks
    still fire). Returns the list of event kinds fired this call (what
    the probe asserts on); every firing is a bounded flight event:

      loss_nan     nonfinite loss OR any nonfinite gradient — latched
                   per episode (one event per divergence, not one per
                   step while it lasts). With `bundle_dir` set, the
                   FIRST firing also writes a full incident bundle via
                   obs/slo.write_incident_bundle (flight ring window +
                   the clock's /trainz snapshot) — the diverging run's
                   post-mortem, reconstructable offline with
                   `python -m dnn_tpu_torch.obs incident PATH`.
      grad_spike   grad-norm > spike_factor × its EMA after `warmup`
                   observations — latched until the norm returns under
                   the threshold. The EMA updates on finite norms only
                   (a NaN norm must not poison the baseline).
      train_stall  update/param-norm ratio below `stall_ratio` for
                   `stall_steps` CONSECUTIVE steps — the wedged-
                   optimizer signature (lr 0, all-masked grads, a
                   frozen tree): loss flat, nothing moving.

    All checks degrade to one boolean when the obs gate is off."""

    def __init__(self, *, spike_factor: float = 8.0,
                 ema_alpha: float = 0.1, warmup: int = 5,
                 stall_ratio: float = 1e-9, stall_steps: int = 50,
                 bundle_dir: Optional[str] = None,
                 clock: Optional[TrainClock] = None):
        if spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {spike_factor}")
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(
                f"ema_alpha must be in (0, 1], got {ema_alpha}")
        self.spike_factor = float(spike_factor)
        self.ema_alpha = float(ema_alpha)
        self.warmup = int(warmup)
        self.stall_ratio = float(stall_ratio)
        self.stall_steps = int(stall_steps)
        self.bundle_dir = bundle_dir
        self._clock = clock
        self._ema: Optional[float] = None
        self._n_obs = 0
        self._nan_latched = False
        self._spike_latched = False
        self._stall_run = 0
        self._stall_latched = False
        self.events_fired = 0

    def observe(self, step: int, loss, stats=None) -> List[str]:
        if not _obs.enabled():
            return []
        fired: List[str] = []
        try:
            loss_f = float(loss)
        except (TypeError, ValueError):
            loss_f = float("nan")
        grad_norm = ratio = None
        nonfinite = 0
        if stats is not None:
            # ONE host transfer for the 3-vector: iterating a device
            # array element-wise costs three dispatched index reads —
            # measurable against the <2% per-step obs budget
            vals = stats.tolist() if hasattr(stats, "tolist") \
                else [float(v) for v in stats]
            grad_norm, ratio = vals[0], vals[1]
            nonfinite = int(vals[2]) if math.isfinite(vals[2]) else 1

        # -- loss_nan: the divergence sentinel -------------------------
        bad = not math.isfinite(loss_f) or nonfinite > 0
        if bad and not self._nan_latched:
            self._nan_latched = True
            fired.append("loss_nan")
            flight.record("loss_nan", step=int(step), loss=loss_f,
                          nonfinite_grads=nonfinite)
            if self.bundle_dir:
                self._write_bundle(step, loss_f, nonfinite)
        elif not bad:
            self._nan_latched = False

        # -- grad_spike: EMA spike detector ----------------------------
        if grad_norm is not None and math.isfinite(grad_norm):
            ema = self._ema
            if ema is not None and self._n_obs >= self.warmup \
                    and grad_norm > self.spike_factor * ema:
                if not self._spike_latched:
                    self._spike_latched = True
                    fired.append("grad_spike")
                    flight.record("grad_spike", step=int(step),
                                  grad_norm=grad_norm,
                                  ema=round(ema, 9),
                                  factor=round(grad_norm / ema, 2))
            else:
                self._spike_latched = False
            self._ema = grad_norm if ema is None else \
                (1.0 - self.ema_alpha) * ema + self.ema_alpha * grad_norm
            self._n_obs += 1

        # -- train_stall: nothing-moving detector ----------------------
        if ratio is not None and math.isfinite(ratio):
            if ratio < self.stall_ratio:
                self._stall_run += 1
                if self._stall_run >= self.stall_steps \
                        and not self._stall_latched:
                    self._stall_latched = True
                    fired.append("train_stall")
                    flight.record("train_stall", step=int(step),
                                  update_ratio=ratio,
                                  run=self._stall_run)
            else:
                self._stall_run = 0
                self._stall_latched = False

        self.events_fired += len(fired)
        return fired

    def _write_bundle(self, step: int, loss: float, nonfinite: int):
        """The diverging run's post-mortem: a minimal breach report +
        the flight ring window + the clock's /trainz snapshot, through
        the forensics machinery. Never fatal — a full disk must
        not kill the training loop that just survived a NaN."""
        try:
            from dnn_tpu_torch.obs.slo import SLOReport, write_incident_bundle

            now = time.time()
            clock = self._clock if self._clock is not None \
                else active_trainlens()
            report = SLOReport(
                scenario="train", ok=False,
                objectives=[{
                    "name": "loss_finite", "ok": False,
                    "measured": loss, "threshold": "finite",
                    "detail": (f"nonfinite loss/grads at step {step} "
                               f"({nonfinite} nonfinite grad elements)"),
                }],
                requests=int(step), completed=int(step), rejected=0,
                lost=0, goodput_tps=0.0, wall_s=0.0,
                breach_window=(now, now))
            write_incident_bundle(self.bundle_dir, report,
                                  stepclock=clock)
        except Exception:  # noqa: BLE001
            import logging

            logging.getLogger("dnn_tpu_torch.obs").exception(
                "trainlens: incident bundle write failed")
