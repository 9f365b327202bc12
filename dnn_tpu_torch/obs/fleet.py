"""Fleet observability: cross-process aggregation and trace stitching
(port of dnn_tpu/obs/fleet.py, copied: it polls HTTP endpoints and
merges their text, so the same payloads give the same merged view,
offsets, stitched trace and critical path in both packages, and it
reads JAX and port daemons alike; a port target's compile count is its
CUDA graph captures, cuda_graph_captures_total, when it reports no
jax_compilations_total).

The paper's core artifact is a MULTI-PROCESS pipeline (one node per
stage, activations relayed over gRPC), yet every obs surface built so
far (/metrics, /statusz, /debugz, /trace) is per-process: a 3-stage
operator gets three disjoint dashboards on three unsynchronized clocks,
and no answer to "which stage is the bottleneck, how big is the
pipeline bubble, and what fraction of peak are we using". This module
is the control-plane collector that merges them:

  * DISCOVERY + POLLING: stage endpoints come from explicit `targets`
    (base URLs of each node's obs endpoint) or from the pipeline config
    (`targets_from_config` — every node's host + one shared metrics
    port). A daemon thread polls each node's existing /metrics,
    /statusz, and /trace.jsonl on an interval; nothing new runs on the
    stages themselves.

  * MERGED VIEW (/fleetz, or the one-shot terminal report): worst-of
    health rollup (the fleet /healthz), per-stage RPC / decode / queue
    percentiles side by side, fleet-total throughput, live MFU/MBU per
    stage (obs/goodput.py gauges), and the estimated clock offsets.

  * CROSS-HOST TRACE STITCHING: every RPC hop already links spans
    across processes (the server's root span parents under the client's
    rpc span via the wire tag — obs/trace.py), but each host stamps its
    spans with ITS OWN clock. The collector estimates per-stage clock
    offset NTP-style from those very hops: the client span's wall-clock
    send/receive window (`cs`/`cr` attrs, comm/client.py) brackets the
    server span, so  offset = server_midpoint - client_midpoint  per
    hop; the median over hops gives the pair offset, and a BFS over the
    pair graph anchors every stage to one timeline. `stitch()` then
    emits ONE Perfetto/Chrome trace with one process track per stage.

  * CRITICAL PATH + BUBBLE: with one request's spans on one corrected
    timeline, `critical_path()` sweeps the leaf (work) spans from
    request start to end, yielding the chain of spans that actually
    gates latency and the BUBBLE FRACTION — the part of the request's
    wall time no stage was working on it (queueing, wire, scheduling
    gaps). MPMD pipeline work (arxiv 2412.14374) shows this is *the*
    actionable signal for pipeline configurations.

Pure stdlib + utils.metrics, so the collector runs on
any operator laptop. CLI: `python -m dnn_tpu_torch.obs fleet` (obs/__main__).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional
from urllib.request import urlopen

log = logging.getLogger("dnn_tpu_torch.obs")

__all__ = [
    "FleetCollector", "parse_prometheus", "estimate_offsets",
    "critical_path", "stitch_spans", "targets_from_config",
]

# health ranking for the worst-of rollup; "unreachable" sits between
# degraded and wedged: the stage may be mid-restart (don't page as hard
# as a confirmed-wedged chip) but the pipeline through it IS down.
# "draining" (a stage whose admission is closed while
# in-flight work finishes) ranks with degraded — route around it, but
# nothing is broken
_STATE_RANK = {"ok": 0, "degraded": 1, "draining": 1, "unreachable": 2,
               "wedged": 3}
# map a fleet state onto the watchdog's three-valued vocabulary so the
# existing /healthz handler (503 on "wedged") serves the fleet too
_STATE_AS_WATCHDOG = {"ok": "ok", "degraded": "degraded",
                      "draining": "degraded",
                      "unreachable": "wedged", "wedged": "wedged"}


# ----------------------------------------------------------------------
# Prometheus text parsing (the poller's half of render_prometheus)
# ----------------------------------------------------------------------

_LINE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+([^\s]+)\s*$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Prometheus text exposition -> {"types": {family: kind},
    "samples": [(family, labels_dict, value)]}. Tolerant: malformed
    lines are skipped (one stage on an older build must not take the
    fleet view down)."""
    types: Dict[str, str] = {}
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _LINE.match(line)
        if not m:
            continue
        name, _, labels_raw, val = m.groups()
        try:
            value = float(val.replace("+Inf", "inf"))
        except ValueError:
            continue
        labels = {}
        if labels_raw:
            for lm in _LABEL.finditer(labels_raw):
                labels[lm.group(1)] = (lm.group(2)
                                       .replace(r'\"', '"')
                                       .replace("\\\\", "\\"))
        samples.append((name, labels, value))
    return {"types": types, "samples": samples}


def _compiles(s) -> Optional[float]:
    """A target's one-time program builds: JAX's XLA compilations, or a
    port daemon's CUDA graph captures (obs/compile_watch.py)."""
    v = s.get("jax_compilations_total")
    return v if v is not None else s.sum("cuda_graph_captures_total")


class _Samples:
    """Query helper over parsed samples."""

    def __init__(self, parsed: dict):
        self._samples = parsed["samples"]

    def get(self, family: str, default=None, **labels):
        for name, labs, v in self._samples:
            if name == family and all(labs.get(k) == str(w)
                                      for k, w in labels.items()):
                return v
        return default

    def sum(self, family: str, **labels) -> Optional[float]:
        hit = False
        total = 0.0
        for name, labs, v in self._samples:
            if name == family and all(labs.get(k) == str(w)
                                      for k, w in labels.items()):
                hit, total = True, total + v
        return total if hit else None

    def hist_quantile(self, family: str, q: float,
                      **labels) -> Optional[float]:
        """histogram_quantile over `family` (summed across any label
        sets matching `labels`, `le` excluded) — linear interpolation
        inside the winning bucket, the Prometheus convention."""
        buckets: Dict[float, float] = defaultdict(float)
        for name, labs, v in self._samples:
            if name != family + "_bucket":
                continue
            if not all(labs.get(k) == str(w) for k, w in labels.items()):
                continue
            try:
                le = float(labs.get("le", "").replace("+Inf", "inf"))
            except ValueError:
                continue
            buckets[le] += v
        if not buckets:
            return None
        pairs = sorted(buckets.items())
        total = pairs[-1][1]  # the +Inf bucket is cumulative total
        if total <= 0:
            return None
        target = q * total
        prev_le, prev_c = 0.0, 0.0
        for le, c in pairs:
            if c >= target:
                if le == float("inf"):
                    return prev_le
                span = c - prev_c
                frac = (target - prev_c) / span if span else 1.0
                return prev_le + (le - prev_le) * frac
            prev_le, prev_c = le, c
        return prev_le


# ----------------------------------------------------------------------
# clock-offset estimation (NTP-style, from the existing RPC spans)
# ----------------------------------------------------------------------

_CLIENT_SPAN_NAMES = ("rpc.SendTensor", "rpc.forward",
                      "rpc.GenerateStream", "rpc.SendMessage")

# leaf spans that measure WAITING, not stage work — critical_path must
# count their cover as bubble (see its docstring)
_WAIT_SPAN_NAMES = frozenset({"queue_wait"})


def estimate_offsets(spans_by_stage: Dict[str, List[dict]],
                     anchor: Optional[str] = None) -> Dict[str, float]:
    """Per-stage clock offset (seconds to SUBTRACT from a stage's span
    timestamps to land on the anchor stage's timeline).

    Every cross-process hop gives one sample: the client-side rpc span
    (stage U) brackets the server's root span (stage T, parented under
    it via the wire tag). With symmetric network delay the server span's
    midpoint coincides with the client window's midpoint on the TRUE
    timeline, so  offset(T rel U) = server_mid - client_mid  — the
    classic NTP midpoint estimate; the error is bounded by the one-way
    delay asymmetry, far below the multi-ms skew it corrects. The
    client midpoint prefers the `cs`/`cr` wall-clock attrs (the
    successful attempt's window, comm/client.py) over the span's ts/dur,
    which includes retry backoff. Per-pair samples reduce by MEDIAN
    (kills the retried-hop and GC-pause outliers); a BFS over the pair
    graph chains offsets for stages the anchor never calls directly."""
    # span_id -> (stage, span) for client-side rpc spans
    client_by_id: Dict[str, tuple] = {}
    for stage, spans in spans_by_stage.items():
        for s in spans:
            if s.get("name") in _CLIENT_SPAN_NAMES:
                client_by_id[s["span_id"]] = (stage, s)
    pair_samples: Dict[tuple, List[float]] = defaultdict(list)
    for stage, spans in spans_by_stage.items():
        for s in spans:
            p = s.get("parent_id")
            if not p or p not in client_by_id:
                continue
            c_stage, c = client_by_id[p]
            if c_stage == stage:
                continue  # same process: same clock, no information
            attrs = c.get("attrs") or {}
            cs, cr = attrs.get("cs"), attrs.get("cr")
            if cs and cr:
                client_mid = (cs + cr) / 2.0
            else:
                client_mid = c["ts"] + (c.get("dur") or 0.0) / 2.0
            server_mid = s["ts"] + (s.get("dur") or 0.0) / 2.0
            pair_samples[(c_stage, stage)].append(server_mid - client_mid)

    def med(xs):
        xs = sorted(xs)
        n = len(xs)
        return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2

    # undirected adjacency with directed medians
    adj: Dict[str, Dict[str, float]] = defaultdict(dict)
    for (u, t), xs in pair_samples.items():
        o = med(xs)
        adj[u][t] = o       # t's clock = u's clock + o
        adj[t].setdefault(u, -o)
    stages = list(spans_by_stage)
    if anchor is None:
        anchor = stages[0] if stages else None
    offsets: Dict[str, float] = {}
    if anchor is None:
        return offsets
    offsets[anchor] = 0.0
    frontier = [anchor]
    while frontier:
        u = frontier.pop()
        for t, o in adj.get(u, {}).items():
            if t not in offsets:
                offsets[t] = offsets[u] + o
                frontier.append(t)
    for s in stages:  # unlinked stages: no evidence, assume in sync
        offsets.setdefault(s, 0.0)
    return offsets


# ----------------------------------------------------------------------
# stitching + critical path
# ----------------------------------------------------------------------

def stitch_spans(spans_by_stage: Dict[str, List[dict]],
                 offsets: Optional[Dict[str, float]] = None,
                 trace_id: Optional[str] = None) -> dict:
    """Merge per-stage span dumps into ONE Chrome-trace/Perfetto JSON on
    one corrected timeline: one PROCESS track per stage (pid = stage
    order, process_name metadata), one thread track per original
    (stage, tid), every event's args carrying the stage and the offset
    applied. Spans are deduped by span_id (overlapping polls of a
    stage's ring re-fetch old spans)."""
    if offsets is None:
        offsets = estimate_offsets(spans_by_stage)
    events = []
    tid_tracks: Dict[tuple, int] = {}
    seen: set = set()
    for pid, (stage, spans) in enumerate(spans_by_stage.items(), 1):
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": f"stage {stage}"}})
        off = offsets.get(stage, 0.0)
        for s in spans:
            if trace_id is not None and s.get("trace_id") != trace_id:
                continue
            if s["span_id"] in seen:
                continue
            seen.add(s["span_id"])
            key = (pid, s.get("tid", 0))
            if key not in tid_tracks:
                tid_tracks[key] = len(tid_tracks) + 1
                events.append({
                    "ph": "M", "pid": pid, "tid": tid_tracks[key],
                    "name": "thread_name",
                    "args": {"name": f"{stage} thread {s.get('tid', 0)}"},
                })
            events.append({
                "name": s["name"], "cat": "dnn_tpu_fleet", "ph": "X",
                "ts": round((s["ts"] - off) * 1e6, 3),
                "dur": round((s.get("dur") or 0.0) * 1e6, 3),
                "pid": pid, "tid": tid_tracks[key],
                "args": {**(s.get("attrs") or {}),
                         "trace_id": s.get("trace_id"),
                         "span_id": s["span_id"],
                         "parent_id": s.get("parent_id"),
                         "stage": stage,
                         "clock_offset_s": round(off, 6)},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def critical_path(spans: List[dict]) -> dict:
    """Critical-path / bubble attribution for ONE request's spans on ONE
    corrected timeline (apply `estimate_offsets` first for cross-host
    trees).

    Work = the tree's LEAF spans (a parent span's self-time is
    coordination around its children), minus spans that MEASURE waiting
    (`queue_wait` — a leaf by construction, but its whole meaning is
    "no stage was working yet"; counting it as work would make an
    overloaded server read bubble-free). The sweep walks from the
    root's start to its end; at each instant the active leaf reaching
    furthest is "the" critical span, and instants covered by no leaf
    are BUBBLE — wall time no stage was working on the request
    (queueing, wire, scheduler gaps, pipeline stalls). Returns:

        {"total_s", "work_s", "bubble_s", "bubble_fraction",
         "path": [{"name", "stage", "enter_s", "exit_s"}, ...],
         "per_stage_busy_s": {stage: s}}

    `enter_s`/`exit_s` are relative to request start; a span appears in
    `path` only for the segment where it gates progress."""
    if not spans:
        return {"total_s": 0.0, "work_s": 0.0, "bubble_s": 0.0,
                "bubble_fraction": 0.0, "path": [],
                "per_stage_busy_s": {}}
    by_id = {s["span_id"]: s for s in spans}
    has_child: set = set()
    for s in spans:
        p = s.get("parent_id")
        if p in by_id:
            has_child.add(p)
    roots = [s for s in spans if s.get("parent_id") not in by_id]
    root = min(roots, key=lambda s: s["ts"]) if roots \
        else min(spans, key=lambda s: s["ts"])
    t0 = root["ts"]
    t1 = root["ts"] + (root.get("dur") or 0.0)
    leaves = [s for s in spans
              if s["span_id"] not in has_child and s is not root
              and s["name"] not in _WAIT_SPAN_NAMES]
    if not leaves:
        leaves = [root]
    ivs = []
    for s in leaves:
        a = max(s["ts"], t0)
        b = min(s["ts"] + (s.get("dur") or 0.0), t1)
        if b > a:
            ivs.append((a, b, s))
    ivs.sort(key=lambda x: (x[0], -x[1]))
    per_stage: Dict[str, float] = defaultdict(float)
    # union coverage for work_s / per-stage busy
    cur_a = cur_b = None
    work = 0.0
    for a, b, s in ivs:
        stage = (s.get("attrs") or {}).get("stage") \
            or s.get("_stage") or "?"
        per_stage[stage] += b - a
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                work += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        work += cur_b - cur_a
    # greedy chain: at time t, the active interval reaching furthest
    path = []
    t = t0
    i = 0
    n = len(ivs)
    while t < t1 and i < n:
        best = None
        j = i
        while j < n and ivs[j][0] <= t + 1e-9:
            if best is None or ivs[j][1] > best[1]:
                best = ivs[j]
            j += 1
        if best is None or best[1] <= t + 1e-9:
            # bubble: jump to the next interval's start
            nxt = ivs[i][0] if ivs[i][0] > t else None
            for a, b, _ in ivs[i:]:
                if a > t and b > t:
                    nxt = a
                    break
            if nxt is None:
                break
            t = nxt
            continue
        a, b, s = best
        path.append({
            "name": s["name"],
            "stage": (s.get("attrs") or {}).get("stage")
            or s.get("_stage") or "?",
            "enter_s": round(max(t, a) - t0, 6),
            "exit_s": round(b - t0, 6),
        })
        t = b
        while i < n and ivs[i][1] <= t + 1e-9:
            i += 1
    total = max(t1 - t0, 0.0)
    work = min(work, total)
    return {
        "total_s": round(total, 6),
        "work_s": round(work, 6),
        "bubble_s": round(total - work, 6),
        "bubble_fraction": round(1.0 - work / total, 4) if total else 0.0,
        "path": path,
        "per_stage_busy_s": {k: round(v, 6)
                             for k, v in sorted(per_stage.items())},
    }


# ----------------------------------------------------------------------
# the collector
# ----------------------------------------------------------------------

def targets_from_config(config, metrics_port: int) -> Dict[str, str]:
    """{stage name: obs base URL} from a pipeline TopologyConfig (or a
    path to one): every node's host + one shared metrics port — the
    deployment convention where each node passes the same
    --metrics_port."""
    if isinstance(config, str):
        from dnn_tpu_torch.config import TopologyConfig

        config = TopologyConfig.from_json(config)
    out = {}
    for node in config.nodes:
        host = (node.address or "127.0.0.1").rsplit(":", 1)[0]
        out[node.id] = f"http://{host}:{metrics_port}"
    if len(set(out.values())) != len(out):
        # same-host nodes share one derived URL: one endpoint would be
        # polled under N names and the others silently never — refuse
        # rather than double-count
        raise ValueError(
            "pipeline config derives duplicate obs URLs (multiple nodes "
            "share a host, so one --metrics_port cannot address them "
            f"all): {out} — pass explicit per-stage targets instead "
            "(--fleet_targets / --targets)")
    return out


class FleetCollector:
    """Poll every stage's obs endpoint; serve the merged view.

    `targets`: {stage name: base URL} (or a list of URLs — names derive
    from the URLs). `interval_s`: poll period of the daemon thread
    (`start()`); `poll_once()` polls synchronously (the one-shot report
    path). All state is swapped atomically under a lock, so /fleetz
    renders a consistent snapshot while the poller runs."""

    def __init__(self, targets, *, interval_s: float = 5.0,
                 timeout_s: float = 5.0, span_cap: int = 20000,
                 poll_traces: bool = True):
        if isinstance(targets, (list, tuple)):
            targets = {u.split("//")[-1]: u for u in targets}
        self.targets: Dict[str, str] = {
            name: url.rstrip("/") for name, url in targets.items()}
        if not self.targets:
            raise ValueError("fleet collector needs at least one target")
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._span_cap = int(span_cap)
        # poll_traces=False skips each target's /trace.jsonl entirely —
        # signal-plane consumers (the router's ReplicaSet) poll at
        # ~1 s cadence and want fresh rows, not span stitching
        self._poll_traces = bool(poll_traces)
        self._lock = threading.Lock()
        self._snaps: Dict[str, dict] = {}
        # per-stage span cache keyed by span_id: successive polls of a
        # stage's bounded ring overlap; the cache keeps the union
        # (bounded — oldest evicted) so stitching sees whole requests
        # even when a poll lands mid-request
        self._spans: Dict[str, Dict[str, dict]] = {
            name: {} for name in self.targets}
        # derived-at-poll-time caches: offsets and trace-id ranking only
        # change when the span caches do, so scrapes (/fleetz every few
        # seconds) must not recompute them from full span copies
        self._offsets: Dict[str, float] = {}
        self._tids: List[str] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._polls = 0
        # autoscaling-signal memory: dnn_tpu_wanted_replicas is a
        # scrape-time gauge with no history — the collector is the one
        # place that sees every sample, so it records TRANSITIONS as
        # bounded flight events (`wanted_replicas_change`) and keeps a
        # bounded recent series on /fleetz: the demand trace a future
        # autoscaler replays (ROADMAP item 3). A step-function series —
        # one point per change — is complete: the gauge holds its value
        # between transitions.
        self._wanted_last: Optional[float] = None
        self._wanted_hist: "deque" = deque(maxlen=256)

    # -- polling -------------------------------------------------------

    def _fetch(self, url: str) -> str:
        with urlopen(url, timeout=self.timeout_s) as r:
            return r.read().decode()

    def _poll_target(self, name: str, url: str) -> dict:
        snap = {"url": url, "t": time.time(), "ok": False,
                "state": "unreachable", "error": None,
                "statusz": None, "metrics": None}
        try:
            snap["statusz"] = json.loads(self._fetch(url + "/statusz"))
            snap["metrics"] = parse_prometheus(
                self._fetch(url + "/metrics"))
            spans = []
            if self._poll_traces:
                for ln in self._fetch(url + "/trace.jsonl").splitlines():
                    ln = ln.strip()
                    if ln:
                        try:
                            spans.append(json.loads(ln))
                        except ValueError:
                            pass
            with self._lock:
                # scrape threads snapshot these caches under the same
                # lock (spans_by_stage) — hold it for the mutation so
                # the docstring's atomic-swap claim covers spans too
                cache = self._spans[name]
                for s in spans:
                    if "span_id" in s:
                        cache[s["span_id"]] = s
                while len(cache) > self._span_cap:
                    cache.pop(next(iter(cache)))
            snap["ok"] = True
            snap["state"] = (snap["statusz"] or {}).get("state", "ok")
            if snap["state"] not in _STATE_RANK:
                snap["state"] = "ok"
        except Exception as e:  # noqa: BLE001 — a down stage is a DATUM
            snap["error"] = str(e)[:200]  # (unreachable), never a crash
        return snap

    def poll_once(self) -> dict:
        """Poll every target (concurrently — one slow stage must not
        delay the others' freshness) and swap in the new snapshots."""
        results: Dict[str, dict] = {}
        threads = []

        def run(name, url):
            results[name] = self._poll_target(name, url)

        for name, url in self.targets.items():
            t = threading.Thread(target=run, args=(name, url),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(self.timeout_s * 2 + 5)
        # recompute the span-derived caches once per poll (a straggler
        # worker past its join timeout may still be ingesting — snapshot
        # under the lock it writes under)
        by_stage = self.spans_by_stage()
        offs = estimate_offsets(by_stage)
        counts: Dict[str, int] = defaultdict(int)
        for spans in by_stage.values():
            for s in spans:
                tid = s.get("trace_id")
                if tid:
                    counts[tid] += 1
        tids = [t for t, _ in
                sorted(counts.items(), key=lambda kv: -kv[1])]
        # wanted_replicas transition detection (explicit MAX across
        # targets, matching the fleetz rollup — a multi-router fleet
        # provisions for its hungriest front door). Outside the lock
        # for the fetch, inside for the history append; the flight
        # record self-gates on the obs env.
        wanted = None
        for snap in results.values():
            if snap.get("metrics") is not None:
                v = _Samples(snap["metrics"]).get(
                    "dnn_tpu_wanted_replicas")
                if v is not None and (wanted is None or v > wanted):
                    wanted = v
        with self._lock:
            self._snaps.update(results)
            self._offsets = offs
            self._tids = tids
            self._polls += 1
            if wanted is not None and wanted != self._wanted_last:
                self._wanted_hist.append(
                    {"t": round(time.time(), 3), "v": wanted})
                prev = self._wanted_last
                self._wanted_last = wanted
            else:
                prev = wanted = None
        if wanted is not None:
            from dnn_tpu_torch.obs import flight as _flight

            _flight.record("wanted_replicas_change", prev=prev,
                           to=wanted)
        return results

    def start(self) -> "FleetCollector":
        def loop():
            while not self._stop.wait(
                    0.0 if self._polls == 0 else self.interval_s):
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — keep polling
                    log.exception("fleet poll failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="obs-fleet-poller")
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- merged views --------------------------------------------------

    def status(self) -> dict:
        """Watchdog-shaped status for the fleet endpoint's /statusz +
        /healthz (obs/http.py expects {"state", "components"}): each
        stage is a component, the fleet state is the worst of them
        mapped onto ok|degraded|wedged (unreachable counts as wedged —
        the pipeline through that stage is down). Never-yet-polled
        reads degraded, not wedged: a collector that just started has
        no evidence either way."""
        with self._lock:
            snaps = dict(self._snaps)
        comps = {}
        worst = "ok"
        for name in self.targets:
            snap = snaps.get(name)
            if snap is None:
                st, detail = "degraded", "not polled yet"
            else:
                st = snap["state"]
                detail = snap["error"] or f"polled {snap['url']}"
            comps[name] = {"state": _STATE_AS_WATCHDOG[st],
                           "raw_state": st, "detail": detail}
            if _STATE_RANK.get(st, 1) > _STATE_RANK.get(worst, 0):
                worst = st
        return {"state": _STATE_AS_WATCHDOG[worst], "fleet_state": worst,
                "components": comps, "t": time.time()}

    def boot_signals(self, name: str) -> dict:
        """Raw boot/compile samples for one target — the caplens
        cold-start ledger's `signals` source (obs/caplens): the child
        measures its own boot (node.py `dnn_tpu_boot_*` gauges + the
        compile-telemetry counter), this collector scrapes it, the
        lens attributes the spawn->first-token wall. Empty dict while
        the target has no successful poll yet."""
        with self._lock:
            snap = self._snaps.get(name)
        if snap is None or snap.get("metrics") is None:
            return {}
        s = _Samples(snap["metrics"])
        return {
            "compile_seconds_total":
                s.sum("jax_compile_seconds_total"),
            "boot_imports_s": s.get("dnn_tpu_boot_imports_seconds"),
            "boot_weight_load_s":
                s.get("dnn_tpu_boot_weight_load_seconds"),
            "boot_compile_preready_s":
                s.get("dnn_tpu_boot_compile_preready_seconds"),
            "boot_ready_total_s":
                s.get("dnn_tpu_boot_ready_total_seconds"),
        }

    def spans_by_stage(self) -> Dict[str, List[dict]]:
        with self._lock:
            return {name: list(cache.values())
                    for name, cache in self._spans.items()}

    def offsets(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._offsets)

    def trace_ids(self) -> List[str]:
        """Distinct trace ids across the fleet, most-spanned first —
        the head is the best candidate for a complete stitched request.
        Computed at poll time (poll_once), not per scrape."""
        with self._lock:
            return list(self._tids)

    def stitch(self, trace_id: Optional[str] = None) -> dict:
        """One Perfetto JSON across all stages on the corrected
        timeline; `trace_id` restricts to one request."""
        return stitch_spans(self.spans_by_stage(), self.offsets(),
                            trace_id=trace_id)

    def request_report(self, trace_id: Optional[str] = None) -> dict:
        """Critical-path/bubble attribution for one request (default:
        the most-spanned trace). Spans are flattened across stages with
        offsets applied and each tagged with its stage."""
        by_stage = self.spans_by_stage()
        if trace_id is None:
            ids = self.trace_ids()
            if not ids:
                return {"error": "no traces collected yet"}
            trace_id = ids[0]
        offs = self.offsets()
        flat, seen = [], set()
        for stage, spans in by_stage.items():
            off = offs.get(stage, 0.0)
            for s in spans:
                if s.get("trace_id") != trace_id or s["span_id"] in seen:
                    continue
                seen.add(s["span_id"])
                c = dict(s)
                c["ts"] = s["ts"] - off
                c["_stage"] = stage
                flat.append(c)
        rep = critical_path(flat)
        rep["trace_id"] = trace_id
        rep["spans"] = len(flat)
        return rep

    def _stage_row(self, snap: Optional[dict]) -> dict:
        # never-yet-polled reads degraded (no evidence either way),
        # matching status() — "unreachable" is reserved for a poll that
        # actually failed, so a scrape between start() and the first
        # completed poll can't page as a down stage
        row = {"state": "degraded" if snap is None else snap["state"],
               "url": None if snap is None else snap["url"],
               "error": "not polled yet" if snap is None
               else snap["error"]}
        stz = (snap["statusz"] if snap is not None else None) or {}
        if stz.get("role"):
            # fleet role (dnn_tpu/control): replicas advertise
            # prefill|decode|both, the router advertises "router" — the
            # rollup's per-target role column
            row["role"] = stz["role"]
        if snap is None or snap["metrics"] is None:
            return row
        s = _Samples(snap["metrics"])
        ms = lambda v: None if v is None else round(v * 1e3, 3)  # noqa: E731
        row.update({
            "tokens_per_sec": s.get("serving_tokens_per_sec"),
            "goodput_tokens_per_sec":
                s.get("dnn_tpu_goodput_tokens_per_sec"),
            "mfu": s.get("dnn_tpu_mfu"),
            "mbu": s.get("dnn_tpu_mbu"),
            "queue_depth": s.get("serving_queue_depth"),
            "occupancy": s.get("serving_batch_occupancy"),
            "requests_total": s.sum("serving_requests_total"),
            "ttft_p50_ms": ms(s.get("serving_ttft_seconds",
                                    quantile="0.5")),
            "ttft_p99_ms": ms(s.get("serving_ttft_seconds",
                                    quantile="0.99")),
            "inter_token_p50_ms": ms(s.get("serving_inter_token_seconds",
                                           quantile="0.5")),
            "inter_token_p99_ms": ms(s.get("serving_inter_token_seconds",
                                           quantile="0.99")),
            "queue_wait_p99_ms": ms(s.get("serving_queue_wait_seconds",
                                          quantile="0.99")),
            "rpc_p50_ms": ms(s.hist_quantile("comm_rpc_latency_seconds",
                                             0.5)),
            "rpc_p99_ms": ms(s.hist_quantile("comm_rpc_latency_seconds",
                                             0.99)),
            "compiles_total": _compiles(s),
            "kv_util": s.get("serving_kv_slot_utilization"),
            "slo_burn": {
                labs.get("slo"): v
                for name, labs, v in snap["metrics"]["samples"]
                if name == "dnn_tpu_slo_burn_rate"} or None,
        })
        # router-target series (dnn_tpu/control/router.py): present only
        # when this target IS a router — queue of in-flight forwards,
        # shed counts by reason, the autoscaling signal
        for fam, key in (("dnn_tpu_router_queue_depth", "router_queue"),
                         ("dnn_tpu_wanted_replicas", "wanted_replicas")):
            v = s.get(fam)
            if v is not None:
                row[key] = v
        # KV-tier series (dnn_tpu/kvtier): per-replica radix residency
        # + prefix effectiveness — present only when the replica serves
        # kv=paged with prefix_cache on
        for fam, key in (
                ("dnn_tpu_kvtier_blocks", "kvtier_blocks"),
                ("dnn_tpu_prefix_hit_ratio", "prefix_hit_ratio"),
                ("dnn_tpu_kvtier_remote_hit_ratio",
                 "kvtier_remote_ratio")):
            v = s.get(fam)
            if v is not None:
                row[key] = v
        # memory-economy series (obs/kvlens.py): the predicted hit
        # ratio at 1x/2x/4x of the replica's pool + the thrash bill —
        # present only when a lens rides the replica's radix store.
        # The 2x column is the capacity-sizing headline: "what would
        # doubling this replica's pool buy"
        for mult, key in (("1x", "kvlens_pred_1x"),
                          ("2x", "kvlens_pred_2x"),
                          ("4x", "kvlens_pred_4x")):
            v = s.get("dnn_tpu_kvlens_pred_hit_ratio", mult=mult)
            if v is not None:
                row[key] = v
        v = s.get("dnn_tpu_kvlens_thrash_chunk_seconds_total")
        if v is not None:
            row["kvlens_thrash_chunk_s"] = v
        # training series (obs/trainlens.py): present only when the
        # target is a training job serving /trainz's weak gauges — the
        # fleet view then answers "is the run compute-bound or
        # input-bound, and how stale is its newest checkpoint" without
        # a separate training dashboard
        for fam, key in (
                ("dnn_tpu_train_mfu", "train_mfu"),
                ("dnn_tpu_train_data_stall", "train_data_stall"),
                ("dnn_tpu_train_tokens_per_sec", "train_tokens_per_sec"),
                ("dnn_tpu_ckpt_staleness_seconds", "ckpt_staleness")):
            v = s.get(fam)
            if v is not None:
                row[key] = v
        sheds = s.sum("dnn_tpu_router_shed_total")
        if sheds is not None:
            row["shed_total"] = sheds
        # capacity series (obs/caplens.py on a router target) + the
        # per-replica cold-start evidence (node.py boot gauges,
        # obs/compile_watch compile counter) the ledger attributes from
        for fam, key in (
                ("dnn_tpu_caplens_arrival_rate_hz", "caplens_rate_hz"),
                ("dnn_tpu_caplens_peak_to_mean", "caplens_peak_to_mean"),
                ("dnn_tpu_caplens_coldstart_p50_seconds",
                 "coldstart_p50_s"),
                ("dnn_tpu_caplens_coldstart_coverage",
                 "coldstart_coverage"),
                ("dnn_tpu_boot_imports_seconds", "boot_imports_s"),
                ("dnn_tpu_boot_weight_load_seconds",
                 "boot_weight_load_s"),
                ("jax_compile_seconds_total", "compile_seconds")):
            v = s.get(fam)
            if v is not None:
                row[key] = v
        v = s.get("dnn_tpu_caplens_plan_availability", n="2")
        if v is not None:
            row["caplens_plan2_availability"] = v
        return row

    def fleetz(self) -> dict:
        """The merged fleet view (/fleetz): worst-of state, per-stage
        health + percentile tables side by side, fleet totals, clock
        offsets, and the current best-known trace ids."""
        with self._lock:
            snaps = dict(self._snaps)
            polls = self._polls
            wanted_hist = list(self._wanted_hist)
        stages = {name: self._stage_row(snaps.get(name))
                  for name in self.targets}
        status = self.status()

        def total(key):
            vals = [r[key] for r in stages.values()
                    if r.get(key) is not None]
            return round(sum(vals), 3) if vals else None

        return {
            "state": status["fleet_state"],
            "stages": stages,
            "fleet": {
                "tokens_per_sec": total("tokens_per_sec"),
                "goodput_tokens_per_sec": total("goodput_tokens_per_sec"),
                "requests_total": total("requests_total"),
                "stages_total": len(self.targets),
                "stages_ok": sum(1 for r in stages.values()
                                 if r["state"] == "ok"),
                # the autoscaling signal: explicit MAX across router
                # targets (a multi-front-door fleet must provision for
                # its hungriest router, and "first non-None" depended
                # on dict order) — the per-stage map keeps each
                # router's own verdict visible
                "wanted_replicas": max(
                    (r["wanted_replicas"] for r in stages.values()
                     if r.get("wanted_replicas") is not None),
                    default=None),
                "wanted_replicas_by_stage": {
                    name: r["wanted_replicas"]
                    for name, r in stages.items()
                    if r.get("wanted_replicas") is not None} or None,
                # the signal's recent history: one {"t", "v"} point per
                # TRANSITION observed by this collector (bounded; the
                # flight ring holds the same changes as events)
                "wanted_replicas_recent": wanted_hist,
                "shed_total": total("shed_total"),
            },
            "clock_offsets_s": {k: round(v, 6)
                                for k, v in self.offsets().items()},
            "trace_ids": self.trace_ids()[:20],
            "polls": polls,
            "t": time.time(),
        }

    def render_prom(self) -> str:
        """The fleet view re-exported in Prometheus text format (the
        /fleetz?format=prom passthrough): per-stage up/state plus the
        fleet totals, so one scrape of the collector covers the fleet's
        health without N scrape configs."""
        from dnn_tpu_torch.utils.metrics import Metrics, labeled, \
            render_prometheus

        z = self.fleetz()
        m = Metrics()
        m.set("dnn_tpu_fleet_state",
              float(_STATE_RANK.get(z["state"], 1)))
        for key in ("tokens_per_sec", "goodput_tokens_per_sec"):
            if z["fleet"][key] is not None:
                m.set(f"dnn_tpu_fleet_{key}", z["fleet"][key])
        m.set("dnn_tpu_fleet_stages_ok", z["fleet"]["stages_ok"])
        m.set("dnn_tpu_fleet_stages_total", z["fleet"]["stages_total"])
        if z["fleet"].get("wanted_replicas") is not None:
            m.set("dnn_tpu_wanted_replicas",
                  z["fleet"]["wanted_replicas"])
        if z["fleet"].get("wanted_replicas_recent"):
            # how many transitions this collector has witnessed — a flat
            # line and a flapping autoscaler signal scrape differently
            m.set("dnn_tpu_wanted_replicas_changes_total",
                  float(len(z["fleet"]["wanted_replicas_recent"])))
        if z["fleet"].get("shed_total") is not None:
            m.set("dnn_tpu_fleet_shed_total", z["fleet"]["shed_total"])
        for name, row in z["stages"].items():
            m.set(labeled("dnn_tpu_fleet_stage_up", stage=name),
                  1.0 if row["state"] == "ok" else 0.0)
            m.set(labeled("dnn_tpu_fleet_stage_state", stage=name),
                  float(_STATE_RANK.get(row["state"], 1)))
            if row.get("role"):
                # role as a one-hot labeled gauge — the prom idiom for
                # a string-valued attribute
                m.set(labeled("dnn_tpu_fleet_stage_role", stage=name,
                              role=row["role"]), 1.0)
            for key in ("tokens_per_sec", "mfu", "mbu", "router_queue",
                        "shed_total", "kvtier_blocks",
                        "prefix_hit_ratio", "kvtier_remote_ratio",
                        "kvlens_pred_1x", "kvlens_pred_2x",
                        "kvlens_pred_4x", "kvlens_thrash_chunk_s",
                        "train_mfu", "train_data_stall",
                        "train_tokens_per_sec", "ckpt_staleness",
                        "wanted_replicas", "caplens_rate_hz",
                        "caplens_peak_to_mean", "coldstart_p50_s",
                        "coldstart_coverage", "compile_seconds",
                        "boot_imports_s", "boot_weight_load_s",
                        "caplens_plan2_availability"):
                if row.get(key) is not None:
                    m.set(labeled(f"dnn_tpu_fleet_stage_{key}",
                                  stage=name), row[key])
        for stage, off in z["clock_offsets_s"].items():
            m.set(labeled("dnn_tpu_fleet_clock_offset_seconds",
                          stage=stage), off)
        return render_prometheus(m)

    # -- the one-shot terminal report ----------------------------------

    def report(self, trace_id: Optional[str] = None) -> str:
        """Human-readable fleet report (the CLI's default output)."""
        z = self.fleetz()
        lines = [f"fleet state: {z['state']}  "
                 f"({z['fleet']['stages_ok']}/{z['fleet']['stages_total']}"
                 f" stages ok)"]
        cols = [("state", 11), ("role", 8), ("tokens_per_sec", 9),
                ("mfu", 7), ("mbu", 7), ("queue_depth", 6),
                ("ttft_p99_ms", 12), ("inter_token_p99_ms", 13),
                ("rpc_p99_ms", 11), ("kvtier_blocks", 8),
                ("prefix_hit_ratio", 9)]
        hdr = "stage".ljust(14) + "".join(h.rjust(w + 1)
                                          for h, w in cols)
        lines.append(hdr)

        def fmt(v, w):
            if v is None:
                return "-".rjust(w + 1)
            if isinstance(v, float):
                return f"{v:.3g}".rjust(w + 1)
            return str(v).rjust(w + 1)

        for name, row in z["stages"].items():
            lines.append(name.ljust(14) + "".join(
                fmt(row.get(h), w) for h, w in cols))
        ft = z["fleet"]
        if ft["tokens_per_sec"] is not None:
            lines.append(f"fleet total tokens/sec: "
                         f"{ft['tokens_per_sec']}")
        offs = {k: v for k, v in z["clock_offsets_s"].items()
                if abs(v) > 1e-4}
        if offs:
            lines.append("clock offsets (s, vs anchor): " + ", ".join(
                f"{k}={v:+.4f}" for k, v in offs.items()))
        rep = self.request_report(trace_id)
        if "error" not in rep:
            lines.append(
                f"request {rep['trace_id']}: total "
                f"{rep['total_s'] * 1e3:.1f} ms, bubble "
                f"{rep['bubble_fraction'] * 100:.1f}% "
                f"({rep['bubble_s'] * 1e3:.1f} ms idle)")
            for seg in rep["path"][:12]:
                lines.append(
                    f"  {seg['enter_s'] * 1e3:8.2f}.."
                    f"{seg['exit_s'] * 1e3:8.2f} ms  "
                    f"[{seg['stage']}] {seg['name']}")
        return "\n".join(lines)
