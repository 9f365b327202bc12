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
    POST /drainz    connection draining (the LM daemon's handler): 202
                    and the drain's state as JSON; idempotent

The JAX endpoint's other routes (/profilez, /kvz, /fleetz, /capz,
/trainz) answer 404 naming ROADMAP Queue 1 item 12, never an empty 200;
any other path answers 404 "not found". A handler that raises answers
500 (and logs it).
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
UNPORTED_ROUTES = ("/profilez", "/kvz", "/fleetz", "/capz", "/trainz")
_UNPORTED_BODY = ("{path}: not ported to dnn_tpu_torch yet (ROADMAP Queue 1 "
                  "item 12)\n")
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
    obs.trace.collector())."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 registry=None, flight=None,
                 healthy: Optional[Callable[[], bool]] = None,
                 status: Optional[Callable[[], dict]] = None,
                 drain: Optional[Callable[[], dict]] = None,
                 stepclock=None, collector=None):
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
                clock = outer._stepclock
                if clock is None:
                    self._send(404, "no step clock attached\n", _TEXT)
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

            def _route(self, post: bool):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path in UNPORTED_ROUTES:
                    self._send(404, _UNPORTED_BODY.format(path=url.path),
                               _TEXT)
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
