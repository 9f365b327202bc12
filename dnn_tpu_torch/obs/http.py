"""Stdlib-HTTP observability endpoint of the LM daemon (port of
dnn_tpu/obs/http.py, the routes the resilience seams report through):
a ThreadingHTTPServer on a daemon thread, so any Prometheus scraper or
a plain curl can watch the daemon.

    GET  /metrics   Prometheus text format (utils.metrics
                    render_prometheus over the shared registry)
    GET  /healthz   200 "ok" / 200 "degraded" / 503 "wedged" or
                    "draining" from /statusz's state; a `healthy`
                    callable (worker liveness, not draining) that reads
                    False answers 503 "unhealthy"
    GET  /statusz   the watchdog's state with per-component detail
                    (JSON; ?format=prom re-renders it as gauges)
    GET  /debugz    the flight recorder's ring as JSONL
                    (application/x-ndjson); ?format=json a JSON array;
                    ?kind= ?trace= filter, ?last=N keeps the newest N
    GET  /trace     Chrome-trace JSON of the collected request spans
                    (obs/trace.py); ?id=<trace id> keeps one trace
    GET  /trace.jsonl  the same spans as JSONL, one span a line
    GET  /traces    the distinct trace ids in the ring (JSON)
    GET  /stepz     the step clock's phase attribution (obs/timeline.py)
                    as JSON; ?format=prom|trace; ?last=N the newest N
                    steps (404 without a clock attached)
    GET  /trainz    the training-step observatory (obs/trainlens.py)
                    with a TrainClock attached: JSON; ?format=prom|trace;
                    ?last=N
    GET  /kvz       the memory-economy observatory (obs/kvlens.py) with
                    a KVLens attached: JSON; ?format=prom
    GET  /fleetz    the merged fleet view (obs/fleet.py) with a
                    FleetCollector attached: JSON; ?format=prom|trace|
                    report (?id= one request's stitched trace); the
                    fleet's worst-of state is then /statusz and /healthz
                    unless a `status` is given
    GET  /profilez  the capture spool and the auto trigger's arm (JSON)
    POST /profilez?ms=N   capture N ms of host + device profile into the
                    bounded spool (obs/profile.py): the capture dir and
                    its trace files; 409 while another session records
    POST /profilez?auto=1&threshold_ms=T[&ms=N]   arm the auto trigger
                    (the LM daemon captures the pool step after one over
                    T ms); ?auto=0 disarms
    POST /drainz    connection draining (the LM daemon's handler): 202
                    and the drain's state as JSON; idempotent

/capz (the capacity observatory, whose only producer is the router)
answers 404 naming ROADMAP Queue 1 item 11, never an empty 200; any
other path answers 404 "not found". A handler that raises answers 500
(and logs it).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

log = logging.getLogger("dnn_tpu_torch.obs")

_STATE_GAUGE = {"ok": 0.0, "degraded": 1.0, "draining": 1.0,
                "wedged": 2.0}

#: the JAX endpoint's routes this port does not serve yet
UNPORTED_ROUTES = ("/capz",)
_UNPORTED_BODY = ("{path}: not ported to dnn_tpu_torch yet (ROADMAP Queue 1 "
                  "item 11)\n")
_TEXT = "text/plain; charset=utf-8"
_PROM = "text/plain; version=0.0.4; charset=utf-8"


def _status_prom(status: dict) -> str:
    """A /statusz payload as Prometheus gauges: dnn_tpu_status_state
    0|1|2 (ok|degraded or draining|wedged) and one series a component."""
    from dnn_tpu_torch.utils.metrics import Metrics, labeled, render_prometheus

    m = Metrics()
    m.set("dnn_tpu_status_state",
          _STATE_GAUGE.get(status.get("state"), 1.0))
    for name, comp in (status.get("components") or {}).items():
        m.set(labeled("dnn_tpu_status_component_state", component=name),
              _STATE_GAUGE.get((comp or {}).get("state"), 1.0))
    return render_prometheus(m)


class MetricsHTTPServer:
    """Serve the shared registry and flight ring (or explicit ones) over
    HTTP; port=0 binds an ephemeral port (read `.port`). Loopback by
    default: the endpoint is unauthenticated, so wider exposure is an
    explicit `host="0.0.0.0"`.

    `status`: callable -> dict with at least {"state": ...}, or None
    (and a callable that returns None) for the worker-liveness shape
    built from `healthy`. `drain`: callable -> dict behind POST
    /drainz. `stepclock`: the obs.timeline.StepClock behind /stepz;
    `collector`: the span ring behind /trace* (default: the process's,
    obs.trace.collector()); `profiler` (obs.profile.Profiler) behind
    /profilez, `kvlens` (obs.kvlens.KVLens) behind /kvz, `trainlens`
    (obs.trainlens.TrainClock) behind /trainz, `fleet`
    (obs.fleet.FleetCollector) behind /fleetz."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 registry=None, flight=None,
                 healthy: Optional[Callable[[], bool]] = None,
                 status: Optional[Callable[[], dict]] = None,
                 drain: Optional[Callable[[], dict]] = None,
                 stepclock=None, collector=None, profiler=None,
                 kvlens=None, trainlens=None, fleet=None):
        from dnn_tpu_torch.obs import flight as _flight
        from dnn_tpu_torch.obs import trace as _trace
        from dnn_tpu_torch.utils import metrics as _metrics

        self._registry = (registry if registry is not None
                          else _metrics.default_metrics)
        self._flight = flight if flight is not None else _flight.recorder()
        self._healthy = healthy
        self._status = status
        self._drain = drain
        self._stepclock = stepclock
        self._collector = (collector if collector is not None
                           else _trace.collector())
        self._profiler = profiler
        self._kvlens = kvlens
        self._trainlens = trainlens
        self._fleet = fleet
        if fleet is not None and status is None:
            # the fleet endpoint's health is the fleet's worst-of state
            self._status = fleet.status
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # to logging, not stderr
                log.debug("metrics http: " + fmt, *args)

            def _send(self, code: int, body: str, ctype: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_json(self, code: int, obj):
                # default=str: a flight event's exotic value degrades to
                # its repr instead of failing the dump
                self._send(code, json.dumps(obj, default=str),
                           "application/json")

            def _statusz(self):
                if outer._status is not None:
                    s = outer._status()
                    if s is not None:
                        return s
                ok = outer._healthy() if outer._healthy else True
                return {"state": "ok" if ok else "wedged",
                        "components": {"worker": {
                            "state": "ok" if ok else "wedged",
                            "detail": "serving worker thread liveness"}}}

            def _healthz(self):
                if outer._healthy is not None and not outer._healthy():
                    self._send(503, "unhealthy\n", _TEXT)
                    return
                state = self._statusz()["state"]
                # draining is 503 too: a load balancer must stop routing
                # here while in-flight decodes finish
                self._send(503 if state in ("wedged", "draining") else 200,
                           state + "\n", _TEXT)

            def _debugz(self, q):
                filters = {}
                if "kind" in q:
                    filters["kind"] = q["kind"][0]
                if "trace" in q:
                    filters["trace_id"] = q["trace"][0]
                if "last" in q:
                    try:
                        filters["last"] = int(q["last"][0])
                    except ValueError:
                        self._send(400, "last must be an int\n", _TEXT)
                        return
                fmt = q.get("format", ["jsonl"])[0]
                if fmt == "json":
                    self._send_json(200, outer._flight.events(**filters))
                elif fmt == "jsonl":
                    self._send(200, outer._flight.jsonl(**filters),
                               "application/x-ndjson")
                else:
                    self._send(400, f"unknown format {fmt!r} (jsonl|json)\n",
                               _TEXT)

            def _stepz(self, q):
                self._clock_view(q, outer._stepclock, "step clock")

            def _trainz(self, q):
                self._clock_view(q, outer._trainlens, "train clock")

            def _clock_view(self, q, clock, what):
                """/stepz and /trainz: a clock's summary (json), gauges
                (prom) or host track (trace) over the newest `last`."""
                if clock is None:
                    self._send(404, f"no {what} attached\n", _TEXT)
                    return
                last = None
                if "last" in q:
                    try:
                        last = int(q["last"][0])
                    except ValueError:
                        last = 0
                    if last < 1:
                        self._send(400, "last must be an int >= 1\n",
                                   _TEXT)
                        return
                fmt = q.get("format", ["json"])[0]
                if fmt == "json":
                    self._send_json(200, clock.summary(last))
                elif fmt == "prom":
                    self._send(200, clock.render_prom(last), _PROM)
                elif fmt == "trace":
                    self._send_json(200, clock.chrome_trace(last))
                else:
                    self._send(400, f"unknown format {fmt!r} "
                               "(json|prom|trace)\n", _TEXT)

            def _kvz(self, q):
                lens = outer._kvlens
                if lens is None:
                    self._send(404, "no kvlens attached\n", _TEXT)
                    return
                fmt = q.get("format", ["json"])[0]
                if fmt == "json":
                    self._send_json(200, lens.summary())
                elif fmt == "prom":
                    self._send(200, lens.render_prom(), _PROM)
                else:
                    self._send(400, f"unknown format {fmt!r} (json|prom)\n",
                               _TEXT)

            def _fleetz(self, q):
                fleet = outer._fleet
                if fleet is None:
                    self._send(404, "no fleet collector attached\n", _TEXT)
                    return
                fmt = q.get("format", ["json"])[0]
                tid = q.get("id", [None])[0]
                if fmt == "json":
                    self._send_json(200, fleet.fleetz())
                elif fmt == "prom":
                    self._send(200, fleet.render_prom(), _PROM)
                elif fmt == "trace":
                    self._send_json(200, fleet.stitch(tid))
                elif fmt == "report":
                    self._send(200, fleet.report(tid) + "\n", _TEXT)
                else:
                    self._send(400, f"unknown format {fmt!r} "
                               "(json|prom|trace|report)\n", _TEXT)

            def _profilez_post(self, q):
                """POST /profilez: a timed capture, or the auto
                trigger's arm (?auto=1) and disarm (?auto=0), as JAX's
                obs/http.py:440-500."""
                from dnn_tpu_torch.obs.profile import (
                    ProfilerBusy,
                    trace_files,
                )

                prof = outer._profiler
                if "auto" in q:
                    if q["auto"][0] in ("0", "false", "off"):
                        prof.disarm()
                        self._send_json(200, {"armed": None})
                        return
                    try:
                        prof.arm_auto(
                            float(q.get("threshold_ms", ["100"])[0]),
                            float(q.get("ms", ["0"])[0]))
                    except ValueError as e:
                        self._send(400, str(e) + "\n", _TEXT)
                        return
                    self._send_json(200, prof.status())
                    return
                try:
                    ms = float(q.get("ms", ["1000"])[0])
                except ValueError:
                    self._send(400, "ms must be a number\n", _TEXT)
                    return
                try:
                    path = prof.capture(ms)
                except ProfilerBusy as e:
                    self._send(409, str(e) + "\n", _TEXT)
                    return
                self._send_json(200, {"capture": path, "ms": ms,
                                      "trace_files": trace_files(path)})

            def _route(self, post: bool):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path in UNPORTED_ROUTES:
                    self._send(404, _UNPORTED_BODY.format(path=url.path),
                               _TEXT)
                elif url.path == "/profilez" and outer._profiler is None:
                    self._send(404, "no profiler attached\n", _TEXT)
                elif post and url.path == "/profilez":
                    self._profilez_post(q)
                elif post and url.path == "/drainz":
                    if outer._drain is None:
                        self._send(404, "no drain handler attached\n", _TEXT)
                    else:
                        self._send_json(202, outer._drain())
                elif post:
                    self._send(404, "not found\n", _TEXT)
                elif url.path == "/metrics":
                    self._send(200, _metrics.render_prometheus(
                        outer._registry), _PROM)
                elif url.path == "/healthz":
                    self._healthz()
                elif url.path == "/statusz":
                    fmt = q.get("format", ["json"])[0]
                    if fmt == "prom":
                        self._send(200, _status_prom(self._statusz()), _PROM)
                    elif fmt == "json":
                        self._send_json(200, self._statusz())
                    else:
                        self._send(400, f"unknown format {fmt!r} "
                                   "(json|prom)\n", _TEXT)
                elif url.path == "/debugz":
                    self._debugz(q)
                elif url.path == "/stepz":
                    self._stepz(q)
                elif url.path == "/trainz":
                    self._trainz(q)
                elif url.path == "/kvz":
                    self._kvz(q)
                elif url.path == "/fleetz":
                    self._fleetz(q)
                elif url.path == "/profilez":
                    self._send_json(200, outer._profiler.status())
                elif url.path == "/trace":
                    self._send_json(200, outer._collector.chrome_trace(
                        q.get("id", [None])[0]))
                elif url.path == "/trace.jsonl":
                    self._send(200, outer._collector.jsonl(
                        q.get("id", [None])[0]), "application/jsonl")
                elif url.path == "/traces":
                    self._send_json(200, outer._collector.trace_ids())
                else:
                    self._send(404, "not found\n", _TEXT)

            def _handle(self, post: bool):
                try:
                    self._route(post)
                except BrokenPipeError:  # the scraper hung up mid-reply
                    pass
                except Exception:  # noqa: BLE001 — one bad request must
                    # not kill the endpoint; it answers 500, never 200
                    log.exception("metrics endpoint request failed")
                    try:
                        self._send(500, "internal error\n", _TEXT)
                    except Exception:  # noqa: BLE001 — connection gone
                        pass

            def do_GET(self):
                self._handle(post=False)

            def do_POST(self):
                self._handle(post=True)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        # a short poll interval: close() waits one interval for the loop
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name=f"obs-metrics-http:{self.port}")
        self._thread.start()
        log.info("observability endpoint on http://%s:%d/metrics",
                 host or "0.0.0.0", self.port)

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
