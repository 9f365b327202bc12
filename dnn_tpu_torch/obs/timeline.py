"""Step-timeline attribution: where does one decode step's wall time go?
(port of the StepClock half of dnn_tpu/obs/timeline.py:1-613, copied: its
logic uses nothing of JAX, so the same records give the same numbers).

**StepClock** — the serving step loop's phase clock. The
ContinuousBatcher (and its speculative override) splits every decode
iteration into named contiguous phases:

    admit     submit() end-to-end: validation, slot install, prefill
              chunks, first-token sample (accumulated onto the NEXT
              step's record — admits happen between steps)
    host      step-entry bookkeeping before the device call (bucket
              growth, constraint-row flush, the slots' uploads)
    dispatch  the launch of the step's work: on the card the replay of
              the step's captured CUDA graph (eager launches on the
              CPU) — host time spent handing the work to the card
    wait      dispatch-return -> tokens on the host: the wait on the
              step's CUDA event before the pinned token readback (under
              overlap, the wait flush_overlap pays)
    commit    the host slot loop: token append, stop/eos/constraint
              checks, retirement
    obs       the step's one bulk registry update + goodput feed

The clock reads only the host's perf_counter: it adds no device sync and
no launch to a step. Derived series:

    device_s        = dispatch + wait
    host_s          = admit + host + commit + obs
    host_fraction   = host_s / wall
    dispatch_slack  = host_s / device_s
    sync_tax        = wait / wall

All series land in the registry behind the one-None-check DNN_TPU_OBS
gate: `begin()` returns None when the gate is off. Scrape-time CALLABLE
gauges (step.dispatch_slack / step.sync_tax / step.host_fraction /
step.per_sec / step.last_wall_ms / step.overlap_depth /
step.constrained_slots) + fixed-bucket histograms
(step.phase_seconds{phase=...}, step.wall_seconds). The ring exports as
a Perfetto-loadable host track (`chrome_trace()`, GET
/stepz?format=trace). Served via GET /stepz (JSON; ?format=prom|trace).

**analyze / render_report** — the device half (JAX's :614-947): read
one profiler capture (obs/profile.py's spool: a torch.profiler Chrome
trace and its meta.json; a JAX capture reads the same) and compute the
device ops that took the most time, the device's busy and idle share
in the capture window, the host gaps between device ops, and, with the
sidecar meta and a live StepClock, each step's device busy. The same
JAX-format trace gives the same dict in both packages; a Kineto trace
is read by its categories (see analyze). CLI: `python -m
dnn_tpu_torch.obs timeline PATH`.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

from dnn_tpu_torch import obs as _obs
from dnn_tpu_torch.utils.metrics import labeled

__all__ = ["StepClock", "PHASES", "STEP_BUCKETS", "analyze",
           "active_clock", "render_report", "find_trace_file",
           "find_meta"]

#: phase names, in within-step order (admit precedes the step proper)
PHASES = ("admit", "host", "dispatch", "wait", "commit", "obs")

#: histogram bounds for phase/wall series (seconds): decode phases run
#: tens of µs (host bookkeeping) through seconds (a cold dispatch)
STEP_BUCKETS = (2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                0.01, 0.025, 0.05, 0.1, 0.25, 1.0, 5.0)

_HOST_PHASES = ("admit", "host", "commit", "obs")
_DEVICE_PHASES = ("dispatch", "wait")

#: shared empty admit-slice seq — most steps have no admissions, and
#: the per-step allocation was measurable against the <2% obs budget;
#: end() REPLACES the attribute (never appends) when slices exist, and
#: every consumer (fold/summary/stepz) only iterates, so sharing is safe
_NO_ADMITS: tuple = ()


class _StepRec:
    """One step's phase boundaries: t0 at step entry, then (phase, t)
    marks in order — phase P's duration is its mark minus the previous
    boundary. `phases`/`wall` are folded LAZILY (`_fold`) at flush or
    scrape time: the producer path only stamps timestamps. The worker
    thread owns the record until `StepClock.end` publishes it into the
    ring; after that it is append-only, and the idempotent fold from a
    scrape thread recomputes the same values it would assign twice."""

    __slots__ = ("t0", "t_end", "marks", "n_adv", "wall", "phases",
                 "admit_slices", "mixed")

    def __init__(self, t0: float):
        self.t0 = t0
        self.t_end = t0
        self.marks: list = []
        self.n_adv = 0
        self.wall = 0.0
        self.phases: "Optional[Dict[str, float]]" = None
        self.admit_slices = _NO_ADMITS
        # mixed = this step's dispatch folded an interleaved prefill
        # chunk (serving prefill_chunk_tokens) — /stepz distinguishes
        # interleaved-prefill steps from pure-decode steps with it
        self.mixed = False


def _fold(rec: _StepRec) -> _StepRec:
    """Fold a published record's marks into per-phase durations (in
    place, idempotent). Runs off the step path — at flush and scrape
    time only."""
    if rec.phases is not None:
        return rec
    phases: Dict[str, float] = {}
    t = rec.t0
    for name, tm in rec.marks:  # marks are unique per step
        phases[name] = tm - t
        t = tm
    if rec.t_end > t:
        # remainder after the last mark (end() stamps right after the
        # "obs" mark, so this is ns-scale) stays attributed
        phases["obs"] = phases.get("obs", 0.0) + (rec.t_end - t)
    admit_s = sum(t1 - t0 for t0, t1 in rec.admit_slices)
    if admit_s:
        phases["admit"] = phases.get("admit", 0.0) + admit_s
    rec.wall = (rec.t_end - rec.t0) + admit_s
    rec.phases = phases
    return rec


class StepClock:
    """Per-phase decode-step clock. Attach post-construction like the
    goodput tracker (`batcher.step_clock = StepClock().install()`);
    the batcher's step()/submit() feed it behind the obs gate.

    Producer protocol (what serving.py calls):

        rec = clock.begin()            # None when the obs gate is off
        ... bookkeeping ...            # -> "host"
        clock.mark(rec, "host")
        ... device call ...            # -> "dispatch"
        clock.mark(rec, "dispatch")
        ...
        clock.end(rec, n_adv)          # publishes + one bulk registry
                                       # update (counters, histograms,
                                       # idempotent gauge re-register)

    submit() reports its whole wall as `note_admit(t0)`; pending admit
    slices attach to the NEXT step's record (admissions happen between
    steps, and the worker loop's iteration = admits + one step).

    Thread safety: the worker thread produces; /stepz scrapes read the
    ring under the lock. `now` is injectable for deterministic tests —
    but it governs only the CLOCK-driven methods (begin/mark/end/
    note_admit): the serving producers stamp `time.perf_counter()`
    inline (a method call per mark was measurable against the <2%
    obs budget), so attach only default-`now` clocks to a real pool;
    injected clocks are for hand-driven records.

    Registry cost: per-step observations are accumulated locally and
    FLUSHED in one bulk update every `FLUSH_EVERY` steps (summary()/
    render_prom() flush first, so scrapes stay fresh) — per-step
    histogram observes measurably taxed the sub-ms decode step this
    clock exists to measure (the obs_overhead <2% contract prices it).
    The derived gauges are scrape-time callables over the ring, so
    they are exact at every scrape regardless of the flush cadence.
    """

    FLUSH_EVERY = 32

    def __init__(self, capacity: int = 256, *, registry=None,
                 now=time.perf_counter):
        self.capacity = int(capacity)
        self._ring: "deque[_StepRec]" = deque(maxlen=self.capacity)
        self._now = now
        self._lock = threading.Lock()
        self._pending_admit: list = []
        self.steps_total = 0
        self._registry = registry
        self._t_last_end: Optional[float] = None
        # registry batch: records awaiting the bulk flush (end() only
        # appends; flush() does the per-phase fan-out off the hot path)
        self._pending_flush: list = []
        self._pending_bulk: list = []  # landed, not yet billed
        # (steps_total, {...}) memo for the derived gauges — see _derived
        self._derived_cache = None
        # memoized labeled histogram keys — string formatting is
        # measurable on the per-step path (the serving _bucket_key
        # lesson)
        self._hist_keys = {p: labeled("step.phase_seconds", phase=p)
                           for p in PHASES}
        # scrape-time callable gauges, weakly bound: the registry must
        # not pin a dead clock (and its ring) for the process lifetime
        ref = weakref.ref(self)

        def _weak(method):
            def read():
                c = ref()
                return getattr(c, method)() if c is not None else 0.0
            return read

        # overlap_depth: how many dispatched-but-uncommitted steps the
        # producer's pipeline holds (0 = classic dispatch→wait→commit;
        # 1 = the batcher's double-buffered dispatch is live). Set by
        # the producer with one attr store; scraped like every gauge.
        self.overlap_depth = 0
        # constrained_slots: how many of the producer's live slots hold
        # a grammar constraint (ISSUE 16: constrained requests ride the
        # same hot path, so the scrape must say WHEN the host_fraction
        # it reports covered constraint-live traffic). Set by the
        # producer at admit/retire with one attr store, never per step.
        self.constrained_slots = 0
        self._gauges = {
            "step.dispatch_slack": _weak("dispatch_slack"),
            "step.sync_tax": _weak("sync_tax"),
            "step.host_fraction": _weak("host_fraction"),
            "step.per_sec": _weak("steps_per_sec"),
            "step.last_wall_ms": _weak("last_wall_ms"),
            "step.overlap_depth": _weak("_overlap_depth_read"),
            "step.constrained_slots": _weak("_constrained_slots_read"),
        }

    def install(self) -> "StepClock":
        """Make this the process's active clock (`active_clock()`)."""
        global _active_clock
        _active_clock = weakref.ref(self)
        return self

    # -- producer side (the batcher worker thread) ---------------------

    def begin(self) -> Optional[_StepRec]:
        """Start one step's record — None when observability is off
        (the producer's one None check covers every later site)."""
        if not _obs.enabled():
            return None
        return _StepRec(self._now())

    def mark(self, rec: _StepRec, phase: str):
        """Close the current phase at now (one perf_counter read + one
        tuple append on the hot path)."""
        rec.marks.append((phase, self._now()))

    def note_admit(self, t0: float):
        """One submit()'s wall interval [t0, now) — attached to the
        next step's record. Bounded: a pathological admit storm with no
        steps keeps the newest 64 slices. Lock-free: submit and step
        run on the ONE thread that owns the batcher (the lm_server
        worker contract), so the producer side never races itself —
        and flush()'s swap-then-read is safe against a GIL-atomic
        append (an append racing the swap lands in whichever list the
        interpreter saw, and both are drained)."""
        if not _obs.enabled():
            return
        t1 = self._now()
        pa = self._pending_admit
        pa.append((t0, t1))
        if len(pa) > 64:
            del pa[0]

    def end(self, rec: _StepRec, n_adv: int = 0):
        """Stamp and publish one step. Deliberately MINIMAL — one
        perf_counter read and ONE GIL-atomic append, no lock: this
        runs inside the decode loop the clock exists to measure, and
        the obs_overhead <2% contract prices every microsecond here.
        Single-producer by the batcher's threading contract. The rec
        lands only in the pending batch here; flush() moves the batch
        into the scrape ring (and runs the ring's evictions) every
        FLUSH_EVERY steps — ring maintenance per step was measurable
        against the budget, and every ring reader (_sums, records,
        summary, render_prom) flushes first, so scrapes stay exact.
        The phase fold and the registry bulk run off this path too."""
        rec.t_end = self._now()
        rec.n_adv = n_adv
        if self._pending_admit:
            rec.admit_slices, self._pending_admit = \
                self._pending_admit, []
        self.steps_total += 1
        self._t_last_end = rec.t_end
        pf = self._pending_flush
        pf.append(rec)
        if len(pf) >= self.FLUSH_EVERY:
            self.flush()

    def _land(self):
        """Move the pending batch into the scrape ring (one extend +
        up to FLUSH_EVERY evictions instead of an append+eviction per
        step). This is the HALF of flush() ring readers need — and the
        only half they may run: the registry's own gauge render calls
        the ring-derived series (dispatch_slack & co.) while HOLDING
        the registry lock, so a reader that reached Metrics.bulk from
        there would self-deadlock on that non-reentrant lock. Landed
        recs queue in _pending_bulk for the next real flush()'s
        histogram bill. The swap is locked against concurrent landers
        (two scrapes must not double-land a batch); a producer append
        racing the swap is GIL-atomic and lands in one of the two
        lists, never lost."""
        if not self._pending_flush:
            return
        with self._lock:
            pending, self._pending_flush = self._pending_flush, []
            self._ring.extend(pending)
            self._pending_bulk.extend(pending)

    def flush(self):
        """Land the accumulated observations in ONE bulk registry
        update. Called every FLUSH_EVERY steps by end(), and by
        summary()/render_prom() — StepClock's own scrape surfaces,
        never reached from inside a registry render — so a /stepz
        scrape never reads a stale histogram. Pending work is dropped
        (not retried) when the gate went off mid-batch — re-enabling
        starts clean."""
        m = self._registry if self._registry is not None \
            else _obs.metrics()
        self._land()
        with self._lock:
            pending, self._pending_bulk = self._pending_bulk, []
        if m is None or not pending:
            return
        hists: Dict[str, list] = {}
        walls = []
        for r in pending:
            _fold(r)
            for p, v in r.phases.items():
                hists.setdefault(self._hist_keys[p], []).append(v)
            walls.append(r.wall)
        hists["step.wall_seconds"] = walls
        m.bulk(counters={"step.steps_total": len(pending)},
               hists=hists, hist_buckets=STEP_BUCKETS,
               gauge_fns=self._gauges)

    # -- derived series (scrape-time reads over the ring) --------------

    def _sums(self, last: Optional[int] = None):
        self._land()  # ring readers: land only, never the registry
        with self._lock:
            recs = list(self._ring)
        if last:
            recs = recs[-last:]
        tot: Dict[str, float] = {p: 0.0 for p in PHASES}
        wall = 0.0
        n_adv = 0
        for r in recs:
            _fold(r)
            for p, v in r.phases.items():
                tot[p] = tot.get(p, 0.0) + v
            wall += r.wall
            n_adv += r.n_adv
        return recs, tot, wall, n_adv

    def _derived(self) -> dict:
        """The three ring-derived gauges from ONE _sums pass, memoized
        on the step counter: a /metrics render calls each gauge in the
        same scrape, and three independent ring copies + folds per
        scrape is pointless lock traffic against the producer. The
        cache read/write is a benign race (gauges may be stale by the
        one step that landed mid-scrape)."""
        key = self.steps_total
        cached = self._derived_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        _, tot, wall, _ = self._sums()
        dev = sum(tot[p] for p in _DEVICE_PHASES)
        host = sum(tot[p] for p in _HOST_PHASES)
        d = {
            "dispatch_slack": host / dev if dev > 0 else 0.0,
            "sync_tax": tot["wait"] / wall if wall > 0 else 0.0,
            "host_fraction": host / wall if wall > 0 else 0.0,
        }
        self._derived_cache = (key, d)
        return d

    def dispatch_slack(self) -> float:
        return self._derived()["dispatch_slack"]

    def sync_tax(self) -> float:
        return self._derived()["sync_tax"]

    def host_fraction(self) -> float:
        return self._derived()["host_fraction"]

    def steps_per_sec(self) -> float:
        """Rate over the ring's newest 60 s of records — computed at
        scrape time (a per-step Throughput feed measurably taxed the
        step; the ring already carries every timestamp needed)."""
        self._land()  # gauge-reachable: land only (registry deadlock)
        now = self._now()
        with self._lock:
            n = sum(1 for r in self._ring if now - r.t0 <= 60.0)
            oldest = self._ring[0].t0 if self._ring else now
        if n == 0:
            return 0.0
        # divide by the span the surviving records actually cover: a
        # full ring may have evicted part of the 60 s window
        return n / max(min(60.0, now - oldest), 1e-9)

    def _overlap_depth_read(self) -> float:
        return float(self.overlap_depth)

    def _constrained_slots_read(self) -> float:
        return float(self.constrained_slots)

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
        coverage assertion and analyze()'s step alignment read."""
        self._land()
        with self._lock:
            recs = list(self._ring)
        if last:
            recs = recs[-last:]
        return [{"t0": r.t0, "wall": _fold(r).wall, "n_adv": r.n_adv,
                 "mixed": r.mixed,
                 "phases": dict(r.phases),
                 "admit_slices": list(r.admit_slices),
                 "marks": list(r.marks)} for r in recs]

    # -- export surfaces -----------------------------------------------

    def summary(self, last: Optional[int] = None) -> dict:
        """The /stepz JSON payload: per-phase totals/means/fractions
        over the ring (or the newest `last` steps) plus the derived
        series."""
        self.flush()  # scrapes read fresh histograms/counters
        recs, tot, wall, n_adv = self._sums(last)
        n = len(recs)
        n_mixed = sum(1 for r in recs if r.mixed)
        phases = {}
        for p in PHASES:
            s = tot.get(p, 0.0)
            phases[p] = {"s": round(s, 6),
                         "frac": round(s / wall, 4) if wall > 0 else 0.0,
                         "mean_ms": round(s / n * 1e3, 4) if n else 0.0}
        dev = sum(tot[p] for p in _DEVICE_PHASES)
        host = sum(tot[p] for p in _HOST_PHASES)
        return {
            "steps_total": self.steps_total,
            "window_steps": n,
            "window_wall_s": round(wall, 6),
            "tokens": n_adv,
            # interleaved-prefill steps in the window (the `mixed` tag:
            # the dispatch folded a prompt chunk into the decode program)
            "mixed_steps": n_mixed,
            "mixed_frac": round(n_mixed / n, 4) if n else 0.0,
            # the producer's dispatch-pipeline depth (0 = no overlap,
            # 1 = double-buffered dispatch live)
            "overlap_depth": self.overlap_depth,
            # live slots holding a grammar constraint — says whether
            # the window's host_fraction covered constrained traffic
            "constrained_slots": self.constrained_slots,
            "phases": phases,
            "device_s": round(dev, 6),
            "host_s": round(host, 6),
            "host_fraction": round(host / wall, 4) if wall > 0 else 0.0,
            "dispatch_slack": round(host / dev, 4) if dev > 0 else 0.0,
            "sync_tax": round(tot["wait"] / wall, 4) if wall > 0 else 0.0,
            "steps_per_sec": round(self.steps_per_sec(), 3),
            "last_wall_ms": round(self.last_wall_ms(), 4),
        }

    def status_component(self) -> dict:
        """The /statusz `step` component: slow-but-healthy vs wedged at
        a glance, no profile pull needed. Informational — state stays
        "ok"; the watchdog's decode_heartbeat owns escalation (both
        read the same worker loop, so their recency agrees)."""
        s = self.summary()
        age = self.last_step_age_s()
        return {
            "state": "ok",
            "detail": (f"last step {s['last_wall_ms']:.2f} ms "
                       f"({'never' if age is None else f'{age:.1f}s ago'}), "
                       f"host fraction {s['host_fraction']:.0%}, "
                       f"{s['steps_per_sec']:.1f} steps/s"),
            "last_wall_ms": s["last_wall_ms"],
            "last_step_age_s": None if age is None else round(age, 3),
            "host_fraction": s["host_fraction"],
            "steps_per_sec": s["steps_per_sec"],
            "steps_total": s["steps_total"],
        }

    def render_prom(self, last: Optional[int] = None) -> str:
        """The ?format=prom re-export: the summary as gauges, for
        scrape-only collectors (same pattern as /statusz?format=prom).
        `last` bounds the window like the JSON form."""
        from dnn_tpu_torch.utils.metrics import Metrics, render_prometheus

        s = self.summary(last)
        m = Metrics()
        for k in ("steps_total", "window_steps", "window_wall_s",
                  "host_fraction", "dispatch_slack", "sync_tax",
                  "steps_per_sec", "last_wall_ms", "mixed_steps",
                  "overlap_depth", "constrained_slots"):
            m.set(f"dnn_tpu_step_{k}", float(s[k]))
        for p, d in s["phases"].items():
            m.set(labeled("dnn_tpu_step_phase_seconds_total", phase=p),
                  d["s"])
            m.set(labeled("dnn_tpu_step_phase_frac", phase=p), d["frac"])
        return render_prometheus(m)

    def chrome_trace(self, last: Optional[int] = None) -> dict:
        """The ring as a Perfetto-loadable HOST track: one process
        ("stepclock"), one slice per phase per step (admit slices keep
        their own real boundaries — they happened before the step).
        Timestamps are perf_counter µs REBASED so the oldest exported
        slice starts at ts 0 (Perfetto renders absolute monotonic
        stamps days into the timeline). A device capture has its OWN ts
        origin (the profiler session start), so the two files do not
        overlay directly."""
        self._land()
        with self._lock:
            recs = list(self._ring)
        if last:
            recs = recs[-last:]
        origin = 0.0
        if recs:
            r0 = recs[0]
            origin = min([r0.t0] + [a for a, _ in r0.admit_slices])
        events = [
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "stepclock"}},
            {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
             "args": {"name": "decode-step phases"}},
        ]
        for i, r in enumerate(recs):
            for a0, a1 in r.admit_slices:
                events.append({"ph": "X", "pid": 1, "tid": 1,
                               "name": "admit",
                               "ts": (a0 - origin) * 1e6,
                               "dur": (a1 - a0) * 1e6,
                               "args": {"step": i}})
            t = r.t0
            args = {"step": i, "n_adv": r.n_adv}
            if r.mixed:
                args["mixed"] = True
            for name, tm in r.marks:
                events.append({"ph": "X", "pid": 1, "tid": 1,
                               "name": name,
                               "ts": (t - origin) * 1e6,
                               "dur": (tm - t) * 1e6,
                               "args": args})
                t = tm
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# the process's active clock (StepClock.install)
_active_clock: "Optional[weakref.ref]" = None


def active_clock() -> Optional[StepClock]:
    ref = _active_clock
    if ref is None:
        return None
    return ref()


# ----------------------------------------------------------------------
# capture analysis: the device half of the attribution
# ----------------------------------------------------------------------

#: host-gap histogram bounds (seconds between consecutive device ops)
GAP_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
               5e-3, 0.01, 0.05, 0.25)

#: Kineto's device-activity categories (CUPTI records); a replayed CUDA
#: graph's kernel nodes arrive as `kernel` events each
_KINETO_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Kineto categories that are never device ops, whatever track they sit
#: on: the record_function ranges mirrored onto the GPU track
_KINETO_HOST_CATS = ("gpu_user_annotation",)


def _merge(intervals: List[tuple]) -> List[tuple]:
    """Union of [t0, t1) intervals, sorted."""
    out: List[tuple] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _load_trace(path: str) -> dict:
    """One Perfetto/Chrome trace JSON, possibly gzipped. ValueError
    with a plain message for anything that is not one — a truncated
    spool or a stray file must fail loud, not half-parse."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt") as f:
                data = json.load(f)
        else:
            with open(path, "r") as f:
                data = json.load(f)
    except (OSError, EOFError, gzip.BadGzipFile, json.JSONDecodeError,
            UnicodeDecodeError) as e:
        raise ValueError(f"not a readable Perfetto JSON trace: {path} "
                         f"({e})") from None
    if isinstance(data, list):  # chrome's bare-array form
        data = {"traceEvents": data}
    if not isinstance(data, dict) or not isinstance(
            data.get("traceEvents"), list):
        raise ValueError(f"no traceEvents array in {path}")
    return data


def find_trace_file(path: str) -> str:
    """Resolve a capture DIR (obs/profile.py's spool layout, or JAX's
    plugins/profile/<run>/ layout) or a direct trace-JSON path to the
    trace file to analyze (newest when several). torch.profiler's
    export_chrome_trace writes plain `.json`; the sidecar meta.json is
    never taken for a trace."""
    if os.path.isdir(path):
        hits = sorted(
            glob.glob(os.path.join(path, "plugins", "profile", "*",
                                   "*.trace.json.gz"))
            or glob.glob(os.path.join(path, "*.trace.json.gz"))
            or glob.glob(os.path.join(path, "*.trace.json"))
            or glob.glob(os.path.join(path, "*.json.gz"))
            or [h for h in glob.glob(os.path.join(path, "*.json"))
                if os.path.basename(h) != "meta.json"])
        if not hits:
            raise ValueError(f"no trace json found under {path}")
        return hits[-1]
    return path


def find_meta(path: str) -> Optional[dict]:
    """The sidecar meta.json for a capture (profile.py writes it at the
    capture root; a trace FILE lives a few levels below it)."""
    d = path if os.path.isdir(path) else os.path.dirname(path)
    for _ in range(4):
        cand = os.path.join(d, "meta.json")
        if os.path.isfile(cand):
            try:
                with open(cand) as f:
                    return json.load(f)
            except (OSError, json.JSONDecodeError):
                return None
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return None


def analyze(path: str, *, clock: Optional[StepClock] = None,
            meta: Optional[dict] = None, top_k: int = 10) -> dict:
    """Structured numbers out of one device capture.

    `path` is a capture dir (POST /profilez's return) or a trace JSON
    (.json / .json.gz). Returns:

      window_s            capture window (first event start to last end)
      tracks              per-(process/thread) busy seconds + fraction
      device              busy/idle fraction of the union of DEVICE ops:
                          in a torch.profiler (Kineto) trace the events
                          of category kernel, gpu_memcpy and gpu_memset
                          (never gpu_user_annotation: Kineto mirrors
                          each record_function range onto the GPU
                          track, and those ranges span kernels); in a
                          JAX trace the events carrying an hlo_op arg,
                          or any event on a "/device:*" process
      host_gaps           histogram of the gaps between consecutive
                          device ops — each gap is host serialization
                          the device sat idle through
      top_ops             top-K op names by summed device time
      steps               StepClock correlation when a sidecar meta
                          (and optionally a live clock) places the
                          capture on the step axis: steps in window,
                          per-step device busy, device-overlap fraction

    Stdlib only; tolerant of the capture's host-side noise (the
    profiler's own start_trace span, threadpool markers, Kineto's ac2g
    flow events and cuda_runtime launches, which are host-side). The
    window anchors at the end of the first event whose name holds
    "start_trace": obs/profile.START_MARKER in the port's captures,
    jax.profiler's own span in JAX's."""
    trace_file = find_trace_file(path)
    data = _load_trace(trace_file)
    if meta is None:
        meta = find_meta(path)

    proc_names: Dict[int, str] = {}
    thread_names: Dict[tuple, str] = {}
    xs = []
    for e in data["traceEvents"]:
        ph = e.get("ph")
        if ph == "M":
            args = e.get("args") or {}
            if e.get("name") == "process_name":
                proc_names[e.get("pid")] = str(args.get("name", ""))
            elif e.get("name") == "thread_name":
                thread_names[(e.get("pid"), e.get("tid"))] = str(
                    args.get("name", ""))
        elif ph == "X":
            xs.append(e)
    if not xs:
        raise ValueError(f"trace has no complete (ph=X) events: "
                         f"{trace_file}")

    def _num(e, k):
        v = e.get(k, 0.0)
        return float(v) if isinstance(v, (int, float)) else 0.0

    t_min = min(_num(e, "ts") for e in xs)
    t_max = max(_num(e, "ts") + _num(e, "dur") for e in xs)

    # ts-axis anchor for StepClock correlation: the trace's ts 0 is the
    # profiler SESSION start (start_trace entry), but the sidecar meta's
    # perf_begin lands at start_trace RETURN — a first capture pays
    # seconds of profiler init in between. The host track records that
    # init as a "start_trace" span; its END is where perf_begin sits on
    # the ts axis. Synthetic/processed traces without one anchor at 0.
    anchor = 0.0
    for e in xs:
        if "start_trace" in str(e.get("name", "")):
            anchor = _num(e, "ts") + _num(e, "dur")
            break

    # analysis window: the ARMED capture window (meta perf bounds,
    # anchored) when available — a first capture's init seconds must
    # not read as device idle — else the events' own span
    w0, w1 = t_min, t_max
    if meta is not None and isinstance(meta.get("perf_begin"),
                                       (int, float)) \
            and isinstance(meta.get("perf_end"), (int, float)):
        w0 = anchor
        w1 = anchor + (meta["perf_end"] - meta["perf_begin"]) * 1e6
    window_s = max(w1 - w0, 1e-9) / 1e6

    def _clipped_busy(merged) -> float:
        return sum(max(0.0, min(t1, w1) - max(t0, w0))
                   for t0, t1 in merged) / 1e6

    by_track: Dict[tuple, list] = {}
    device_ops: list = []
    for e in xs:
        key = (e.get("pid"), e.get("tid"))
        by_track.setdefault(key, []).append(e)
        args = e.get("args") or {}
        pname = proc_names.get(e.get("pid"), "")
        cat = e.get("cat")
        if cat in _KINETO_DEVICE_CATS:
            device_ops.append(e)
        elif cat in _KINETO_HOST_CATS:
            pass
        elif "hlo_op" in args or "/device:" in pname \
                or pname.startswith("/device"):
            # skip the CPU runtime's zero-width threadpool markers —
            # they carry no hlo_op but would otherwise ride a /device
            # pid on some backends
            if _num(e, "dur") > 0.0 or "hlo_op" in args:
                device_ops.append(e)

    tracks = {}
    for (pid, tid), evs in sorted(by_track.items(),
                                  key=lambda kv: str(kv[0])):
        merged = _merge([(_num(e, "ts"), _num(e, "ts") + _num(e, "dur"))
                         for e in evs])
        busy = _clipped_busy(merged)
        name = (proc_names.get(pid, str(pid)) + "/"
                + thread_names.get((pid, tid), str(tid)))
        tracks[name] = {"events": len(evs),
                        "busy_s": round(busy, 6),
                        "busy_frac": round(busy / window_s, 4)}

    dev_ivals = _merge([(_num(e, "ts"), _num(e, "ts") + _num(e, "dur"))
                        for e in device_ops])
    dev_busy_s = _clipped_busy(dev_ivals)
    device = {
        "ops": len(device_ops),
        "busy_s": round(dev_busy_s, 6),
        "busy_frac": round(dev_busy_s / window_s, 4),
        "idle_frac": round(1.0 - dev_busy_s / window_s, 4),
    }

    gaps = [(t0 - prev_t1) / 1e6
            for (_, prev_t1), (t0, _) in zip(dev_ivals, dev_ivals[1:])
            if t0 > prev_t1]
    gap_hist: Dict[str, int] = {}
    for b in GAP_BUCKETS:
        gap_hist[f"le_{b:g}"] = sum(1 for g in gaps if g <= b)
    gap_hist["inf"] = len(gaps)
    gaps_sorted = sorted(gaps)

    def _pct(q):
        if not gaps_sorted:
            return 0.0
        k = min(len(gaps_sorted) - 1,
                int(round(q / 100.0 * (len(gaps_sorted) - 1))))
        return gaps_sorted[k]

    host_gaps = {
        "count": len(gaps),
        "total_s": round(sum(gaps), 6),
        "p50_ms": round(_pct(50) * 1e3, 4),
        "p90_ms": round(_pct(90) * 1e3, 4),
        "max_ms": round((gaps_sorted[-1] if gaps_sorted else 0.0) * 1e3,
                        4),
        "hist": gap_hist,
    }

    by_op: Dict[str, list] = {}
    for e in device_ops:
        by_op.setdefault(str(e.get("name", "?")), [0.0, 0])
        rec = by_op[str(e.get("name", "?"))]
        rec[0] += _num(e, "dur") / 1e6
        rec[1] += 1
    top_ops = [{"name": n, "total_ms": round(s * 1e3, 4), "count": c,
                "frac_of_device": round(s / dev_busy_s, 4)
                if dev_busy_s > 0 else 0.0}
               for n, (s, c) in sorted(by_op.items(),
                                       key=lambda kv: -kv[1][0])[:top_k]]

    steps = None
    if meta is not None:
        steps = {
            "backend": meta.get("backend"),
            "step_begin": meta.get("step_begin"),
            "step_end": meta.get("step_end"),
            "steps_in_capture": None,
            "aligned": False,
        }
        sb, se = meta.get("step_begin"), meta.get("step_end")
        if isinstance(sb, int) and isinstance(se, int):
            steps["steps_in_capture"] = se - sb
        pb = meta.get("perf_begin")
        if clock is None:
            clock = active_clock()
        if clock is not None and isinstance(pb, (int, float)):
            pe = meta.get("perf_end", float("inf"))

            def _ivals(r):
                # a record's PHYSICAL extent: its admit slices (which
                # happened before t0 — submit runs between steps) plus
                # the in-step span; wall is the summed length of these
                admit_s = sum(t1 - t0 for t0, t1 in r["admit_slices"])
                return list(r["admit_slices"]) + [
                    (r["t0"], r["t0"] + (r["wall"] - admit_s))]

            recs = [r for r in clock.records()
                    if all(pb <= a and b <= pe for a, b in _ivals(r))]
            if recs:
                # map each step's perf intervals onto the capture's ts
                # axis (perf_begin sits at `anchor`) and intersect with
                # the merged device intervals: per-step device busy
                per_step = []
                for r in recs:
                    busy = 0.0
                    for ia, ib in _ivals(r):
                        a = (ia - pb) * 1e6 + anchor
                        b = (ib - pb) * 1e6 + anchor
                        busy += sum(max(0.0, min(b, t1) - max(a, t0))
                                    for t0, t1 in dev_ivals)
                    per_step.append((r["wall"], busy / 1e6))
                wall_sum = sum(w for w, _ in per_step)
                busy_sum = sum(b for _, b in per_step)
                steps.update({
                    "aligned": True,
                    "n_steps": len(per_step),
                    "mean_wall_ms": round(wall_sum / len(per_step) * 1e3,
                                          4),
                    "mean_device_busy_ms": round(
                        busy_sum / len(per_step) * 1e3, 4),
                    "device_overlap_frac": round(busy_sum / wall_sum, 4)
                    if wall_sum > 0 else 0.0,
                })

    return {
        "trace_file": trace_file,
        "window_s": round(window_s, 6),
        "events": len(xs),
        "tracks": tracks,
        "device": device,
        "host_gaps": host_gaps,
        "top_ops": top_ops,
        "steps": steps,
    }


def render_report(a: dict) -> str:
    """Human-readable one-capture report (the CLI's default output)."""
    lines = [f"capture: {a['trace_file']}",
             f"window: {a['window_s'] * 1e3:.2f} ms, "
             f"{a['events']} events",
             f"device: busy {a['device']['busy_frac']:.1%} / idle "
             f"{a['device']['idle_frac']:.1%} "
             f"({a['device']['ops']} ops, "
             f"{a['device']['busy_s'] * 1e3:.2f} ms)",
             f"host gaps between device ops: {a['host_gaps']['count']} "
             f"(total {a['host_gaps']['total_s'] * 1e3:.2f} ms, "
             f"p50 {a['host_gaps']['p50_ms']:.3f} ms, "
             f"p90 {a['host_gaps']['p90_ms']:.3f} ms, "
             f"max {a['host_gaps']['max_ms']:.3f} ms)"]
    if a["top_ops"]:
        lines.append("top device ops:")
        for op in a["top_ops"]:
            lines.append(f"  {op['total_ms']:10.3f} ms  "
                         f"{op['frac_of_device']:6.1%}  x{op['count']:<5d}"
                         f" {op['name']}")
    st = a.get("steps")
    if st:
        if st.get("aligned"):
            lines.append(
                f"steps: {st['n_steps']} aligned to the capture — mean "
                f"wall {st['mean_wall_ms']:.3f} ms, device busy "
                f"{st['mean_device_busy_ms']:.3f} ms/step (overlap "
                f"{st['device_overlap_frac']:.1%})")
        elif st.get("steps_in_capture") is not None:
            lines.append(f"steps: {st['steps_in_capture']} in capture "
                         f"(counter {st['step_begin']}..{st['step_end']},"
                         f" backend {st.get('backend')}); none aligned "
                         "(no step records inside the window, or no "
                         "live clock)")
    lines.append("tracks:")
    for name, t in sorted(a["tracks"].items(),
                          key=lambda kv: -kv[1]["busy_s"]):
        lines.append(f"  {t['busy_frac']:6.1%} busy "
                     f"({t['busy_s'] * 1e3:9.2f} ms, {t['events']:6d} ev)"
                     f"  {name}")
    return "\n".join(lines)
