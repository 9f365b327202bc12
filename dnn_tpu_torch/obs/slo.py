"""SLO verdict engine + automatic breach forensics (port of
dnn_tpu/obs/slo.py, copied: the same records give the same SLOReport,
and a bundle either package writes loads in the other's load_incident).

obs/goodput.py tracks LIVE burn rates (the paging signal); this module
is the after-the-fact judge: a scenario (JAX's dnn_tpu/workloads) hands it
the per-request records it collected plus the scenario's declared SLO,
and gets back a per-objective report with one ok/breach VERDICT — the
per-scenario goodput-under-SLO accounting the Gemma-on-TPU serving
comparison (PAPERS.md 2605.25645) reports, as an asserted artifact
instead of a table in a paper.

Record schema (one dict per request; the workloads runner produces
these, but anything shaped like this evaluates):

    {"i": int, "t": sched offset s, "outcome": "ok"|"rejected"|None,
     "tokens": int, "ttft_s": float|None, "itl_s": [float, ...],
     "t_done": float|None}

`outcome=None` means SILENTLY LOST — the one thing no SLO tolerates;
it fails availability unconditionally.

On breach, `write_incident_bundle` snapshots the process's forensic
surfaces — the flight ring filtered to the breach window (/debugz),
the step clock (/stepz), the fleet view (/fleetz) — into one on-disk
directory, and `python -m dnn_tpu_torch.obs incident PATH` renders the
event-by-event timeline back out of it. That is the "reconstructable
from the flight recorder" promise (ROADMAP item 5) automated: the
breach scenario's test asserts by READING THE BUNDLE BACK, never from
in-memory state. Stdlib only on these paths.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

__all__ = ["SLOSpec", "SLOReport", "evaluate", "write_incident_bundle",
           "load_incident", "render_incident"]


# nearest-rank percentile — the registry's convention, shared so the
# SLO verdicts can never diverge from the /metrics reservoir quantiles
# (utils.metrics is stdlib-only, safe on the CLI path)
from dnn_tpu_torch.utils.metrics import percentile as _percentile  # noqa: E402


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """A scenario's declared objectives. Latency objectives are
    (percentile, threshold) pairs — `ttft_p=95, ttft_s=0.5` reads "the
    95th-percentile time-to-first-token stays under 500 ms".
    `availability` is the COMPLETED fraction of submitted requests —
    stricter than the chaos probe's completed-or-rejected accounting,
    because a scenario declares the demand it expects SERVED: a shed
    request is a served-SLO failure even when it is a correct admission
    decision. Silently-lost requests additionally fail the always-on
    `lost` objective, which tolerates ZERO. `goodput_floor_tps` is the
    delivered-tokens/sec floor over the measured window — the "goodput
    under SLO" column."""

    ttft_s: Optional[float] = None
    ttft_p: float = 95.0
    itl_s: Optional[float] = None
    itl_p: float = 95.0
    availability: Optional[float] = None
    goodput_floor_tps: Optional[float] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass
class SLOReport:
    """The verdict: `ok` is the AND over objectives; `objectives` holds
    one row per declared objective (name, measured, threshold, ok);
    `breach_window` is the [first, last] wall-clock epoch-second span
    of the bad samples that tripped it (None when ok) — the window the
    incident bundle filters the flight ring to."""

    scenario: str
    ok: bool
    objectives: List[dict]
    requests: int
    completed: int
    rejected: int
    lost: int
    goodput_tps: float
    wall_s: float
    breach_window: Optional[tuple] = None
    burn_rates: Optional[dict] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.breach_window is not None:
            d["breach_window"] = list(self.breach_window)
        return d


def evaluate(scenario: str, records: List[dict], spec: SLOSpec, *,
             wall_s: float, t0_epoch: Optional[float] = None,
             burn_rates: Optional[dict] = None) -> SLOReport:
    """Judge `records` against `spec`. `wall_s` is the measured window
    (the goodput denominator — the runner's, never inferred from the
    records, which would under-count an idle tail). `t0_epoch` maps the
    records' relative `t` offsets onto wall-clock epoch seconds so the
    breach window can address the flight ring; omitted, the window is
    reported in relative offsets. `burn_rates` (obs/goodput
    GoodputTracker.burn_rates()) rides the report verbatim — the live
    gauges' view next to the post-hoc arithmetic."""
    if wall_s <= 0:
        raise ValueError(f"wall_s must be > 0, got {wall_s}")
    n = len(records)
    completed = [r for r in records if r.get("outcome") == "ok"]
    rejected = [r for r in records if r.get("outcome") == "rejected"]
    lost = [r for r in records if r.get("outcome") is None]
    goodput = sum(int(r.get("tokens") or 0) for r in completed) / wall_s

    def _epoch(rel: float) -> float:
        return rel if t0_epoch is None else t0_epoch + rel

    objectives: List[dict] = []
    bad_ts: List[float] = []

    def obj(name, measured, threshold, ok, *, bad_records=()):
        objectives.append({
            "name": name,
            "measured": (None if measured is None
                         else round(float(measured), 6)),
            "threshold": threshold, "ok": bool(ok)})
        if not ok:
            for r in bad_records:
                # a lost record carries t_done=None (the key exists) —
                # its scheduled time still anchors the breach window
                t = r.get("t_done")
                if t is None:
                    t = r.get("t")
                if t is not None:
                    bad_ts.append(_epoch(float(t)))

    if spec.ttft_s is not None:
        samples = [(r["ttft_s"], r) for r in completed
                   if r.get("ttft_s") is not None]
        if samples:
            p = _percentile([s for s, _ in samples], spec.ttft_p)
            bad = [r for s, r in samples if s > spec.ttft_s]
            obj(f"ttft_p{spec.ttft_p:g}", p, spec.ttft_s,
                p <= spec.ttft_s, bad_records=bad)
        else:
            # an SLO over zero samples is vacuous only when nothing
            # completed AND availability judges that; a declared TTFT
            # objective with no completions is a failure, not a pass
            obj(f"ttft_p{spec.ttft_p:g}", None, spec.ttft_s,
                not records, bad_records=records)
    if spec.itl_s is not None:
        samples = [s for r in completed for s in (r.get("itl_s") or ())]
        if samples:
            p = _percentile(samples, spec.itl_p)
            bad = [r for r in completed
                   if any(s > spec.itl_s for s in (r.get("itl_s") or ()))]
            obj(f"itl_p{spec.itl_p:g}", p, spec.itl_s, p <= spec.itl_s,
                bad_records=bad)
        # no samples at all (all requests emitted <= 1 token): vacuous
        # by construction, skip rather than fail — the objective had no
        # events to judge and availability covers the did-anything-run
        # question
    if spec.availability is not None:
        avail = len(completed) / n if n else 0.0
        obj("availability", avail, spec.availability,
            avail >= spec.availability and not lost,
            bad_records=rejected + lost)
    # silent loss is unconditionally asserted — a record without an
    # outcome is the failure mode every probe in this repo exists to
    # make impossible
    obj("lost", len(lost), 0, not lost, bad_records=lost)
    if spec.goodput_floor_tps is not None:
        obj("goodput_tps", goodput, spec.goodput_floor_tps,
            goodput >= spec.goodput_floor_tps)

    ok = all(o["ok"] for o in objectives)
    window = None
    if not ok and bad_ts:
        window = (min(bad_ts), max(bad_ts))
    return SLOReport(
        scenario=scenario, ok=ok, objectives=objectives, requests=n,
        completed=len(completed), rejected=len(rejected),
        lost=len(lost), goodput_tps=round(goodput, 3),
        wall_s=round(wall_s, 3), breach_window=window,
        burn_rates=burn_rates)


# ----------------------------------------------------------------------
# incident bundles: the breach's forensic snapshot, on disk
# ----------------------------------------------------------------------

MANIFEST = "manifest.json"
FLIGHT = "flight.jsonl"
STEPZ = "stepz.json"
FLEETZ = "fleetz.json"


def write_incident_bundle(dir_path: str, report: SLOReport, *,
                          flight=None, stepclock=None, fleet=None,
                          url: Optional[str] = None,
                          records: Optional[List[dict]] = None,
                          window_pad_s: float = 30.0) -> str:
    """Snapshot the forensic surfaces into `dir_path` (created):

      manifest.json   the SLO report + what was captured and why a
                      surface is absent (honest nulls, never silence)
      flight.jsonl    the flight ring, filtered to the breach window
                      (± window_pad_s) when the report has one, whole
                      ring otherwise — /debugz's content
      stepz.json      StepClock.summary() — /stepz's content
      fleetz.json     FleetCollector.fleetz() — /fleetz's content

    Sources are either in-process objects (`flight` a FlightRecorder —
    default the shared ring, `stepclock`, `fleet`) or a live server's
    obs endpoint (`url`), in which case the three surfaces are fetched
    over HTTP exactly as an operator would. Returns `dir_path`."""
    os.makedirs(dir_path, exist_ok=True)
    captured: dict = {}

    if url is not None:
        from urllib.request import urlopen

        base = url.rstrip("/")
        for name, path, fname in (("flight", "/debugz", FLIGHT),
                                  ("stepz", "/stepz", STEPZ),
                                  ("fleetz", "/fleetz", FLEETZ)):
            try:
                body = urlopen(base + path, timeout=10).read().decode()
                with open(os.path.join(dir_path, fname), "w") as f:
                    f.write(body)
                captured[name] = fname
            except Exception as e:  # noqa: BLE001 — a server without the
                # surface (404) or mid-crash must not lose the bundle
                captured[name] = f"unavailable: {str(e)[:120]}"
    else:
        if flight is None:
            from dnn_tpu_torch.obs import flight as _flight

            flight = _flight.recorder()
        events = flight.events()
        if report.breach_window is not None:
            lo = report.breach_window[0] - window_pad_s
            hi = report.breach_window[1] + window_pad_s
            events = [e for e in events if lo <= e["ts"] <= hi]
        with open(os.path.join(dir_path, FLIGHT), "w") as f:
            for e in events:
                f.write(json.dumps(e, sort_keys=True, default=str) + "\n")
        captured["flight"] = f"{FLIGHT} ({len(events)} events)"
        if stepclock is not None and getattr(stepclock, "steps_total", 0):
            with open(os.path.join(dir_path, STEPZ), "w") as f:
                json.dump(stepclock.summary(), f, default=str)
            captured["stepz"] = STEPZ
        else:
            captured["stepz"] = "unavailable: no step clock attached"
        if fleet is not None:
            with open(os.path.join(dir_path, FLEETZ), "w") as f:
                json.dump(fleet.fleetz(), f, default=str)
            captured["fleetz"] = FLEETZ
        else:
            captured["fleetz"] = ("unavailable: single process, no "
                                  "fleet collector")

    with open(os.path.join(dir_path, MANIFEST), "w") as f:
        json.dump({"kind": "dnn_tpu_incident", "version": 1,
                   "written_at": time.time(), "report": report.to_dict(),
                   "captured": captured,
                   "records": records if records is not None else None},
                  f, indent=2, default=str)
    from dnn_tpu_torch.obs import flight as _fl

    _fl.record("incident_bundle", scenario=report.scenario,
               path=dir_path)
    return dir_path


def load_incident(path: str) -> dict:
    """Read a bundle back: {"manifest", "flight" (event list),
    "stepz"|None, "fleetz"|None}. Fails loud on a directory without a
    manifest — half a bundle must not render as a clean incident."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        raise ValueError(
            f"{path!r} is not an incident bundle (no {MANIFEST})")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("kind") != "dnn_tpu_incident":
        raise ValueError(
            f"{mpath} is not an incident manifest "
            f"(kind={manifest.get('kind')!r})")
    out = {"manifest": manifest, "flight": [], "stepz": None,
           "fleetz": None}
    fpath = os.path.join(path, FLIGHT)
    if os.path.isfile(fpath):
        with open(fpath) as f:
            for line in f:
                line = line.strip()
                if line:
                    out["flight"].append(json.loads(line))
    for key, fname in (("stepz", STEPZ), ("fleetz", FLEETZ)):
        p = os.path.join(path, fname)
        if os.path.isfile(p):
            with open(p) as f:
                out[key] = json.load(f)
    return out


def render_incident(bundle: dict) -> str:
    """The event-by-event timeline, human-first: the verdict header,
    each failed objective, then every flight event in seq order with
    its offset from the breach window's start — the post-mortem a
    responder reads top to bottom."""
    man = bundle["manifest"]
    rep = man["report"]
    lines = [f"incident: scenario {rep['scenario']!r} — "
             + ("OK (no breach)" if rep["ok"] else "SLO BREACH"),
             f"  requests {rep['requests']}  completed "
             f"{rep['completed']}  rejected {rep['rejected']}  lost "
             f"{rep['lost']}  goodput {rep['goodput_tps']} tok/s over "
             f"{rep['wall_s']} s"]
    for o in rep["objectives"]:
        mark = "ok " if o["ok"] else "FAIL"
        lines.append(f"  [{mark}] {o['name']}: measured "
                     f"{o['measured']} vs threshold {o['threshold']}")
    if rep.get("burn_rates"):
        lines.append("  live burn rates at verdict: " + ", ".join(
            f"{k}={v:.2f}" for k, v in rep["burn_rates"].items()))
    win = rep.get("breach_window")
    if win:
        lines.append(f"  breach window: {win[0]:.3f} .. {win[1]:.3f} "
                     f"({win[1] - win[0]:.3f} s)")
    events = bundle["flight"]
    lines.append(f"timeline ({len(events)} flight events):")
    t_anchor = win[0] if win else (events[0]["ts"] if events else 0.0)
    for e in events:
        extra = {k: v for k, v in e.items()
                 if k not in ("seq", "ts", "kind")}
        detail = " ".join(f"{k}={v}" for k, v in extra.items())
        lines.append(f"  {e['ts'] - t_anchor:+9.3f}s  #{e['seq']:<5d} "
                     f"{e['kind']:<24s} {detail}".rstrip())
    sz = bundle.get("stepz")
    if sz:
        lines.append(
            f"step clock: {sz.get('steps_total')} steps, host fraction "
            f"{sz.get('host_fraction', 0):.1%}, "
            f"{sz.get('steps_per_sec', 0):.1f} steps/s")
    fz = bundle.get("fleetz")
    if fz:
        lines.append(f"fleet: state {fz.get('state')!r}, "
                     f"{len(fz.get('stages', {}))} stages")
    return "\n".join(lines)
