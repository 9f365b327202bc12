"""dnn_tpu_torch.obs — observability for the port's serving stack (the
subset of dnn_tpu/obs that the LM daemon's resilience seams report
through):

  * metrics (utils/metrics.py): counters, gauges, quantile summaries
    and histograms under the JAX package's names, rendered in
    Prometheus text format from a stdlib-HTTP endpoint (obs/http.py);
  * the flight recorder (obs/flight.py): a bounded ring of structured
    events, served on GET /debugz and dumped on an unhandled crash;
  * memory gauges (obs/mem.py): the daemon's CUDA device memory and the
    host's RSS;
  * the hung-device watchdog (obs/watchdog.py): subprocess-bounded
    device probes and the decode heartbeat -> ok|degraded|wedged on
    /statusz and /healthz;
  * request spans (obs/trace.py): a trace id and a tree of timed spans a
    request, continued from a client's `tr=` tag, on /trace*;
  * the step clock (obs/timeline.py): each decode step split into
    admit/host/dispatch/wait/commit/obs, on /stepz;
  * goodput (obs/goodput.py): live MFU, MBU, goodput tokens/sec and SLO
    burn rates;
  * capture and build counters (obs/compile_watch.py): the CUDA graphs
    the batchers capture and the kernel libraries built at first use.

/profilez, kvlens, caplens, fleet and trainlens are ROADMAP Queue 1 item
12's second half; their routes answer 404 here.

Gate: DNN_TPU_OBS=off (or 0/false/no) disables everything, as in the
JAX package — `metrics()` returns None and `flight.record` returns at
one boolean check. Every counter and gauge is host arithmetic: nothing
here reads the device on a step.
"""

from __future__ import annotations

import os

from dnn_tpu_torch.obs import flight  # noqa: F401 — obs.flight.record(...)
from dnn_tpu_torch.obs.trace import (  # noqa: F401 — obs.start_span(...)
    NULL_SPAN,
    continue_or_start,
    record_span,
    start_span,
    tag_request_id,
)

__all__ = ["enabled", "set_enabled", "metrics", "serve_metrics", "flight",
           "NULL_SPAN", "continue_or_start", "record_span", "start_span",
           "tag_request_id"]

_enabled = os.environ.get("DNN_TPU_OBS", "on").lower() not in (
    "off", "0", "false", "no")


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool):
    """Runtime toggle (tests, the smoke's on/off comparison). Producers
    re-check per call, so flipping takes effect at once."""
    global _enabled
    _enabled = bool(on)


_default_metrics = None  # resolved once: metrics() is on hot paths


def metrics():
    """The shared registry (utils.metrics.default_metrics) when
    observability is on, else None — hot paths guard with one `is not
    None` check and skip all bookkeeping when off."""
    if not _enabled:
        return None
    global _default_metrics
    if _default_metrics is None:
        from dnn_tpu_torch.utils.metrics import default_metrics

        _default_metrics = default_metrics
    return _default_metrics


def serve_metrics(port: int = 0, host: str = "127.0.0.1", *,
                  healthy=None, status=None, drain=None, device=None,
                  stepclock=None):
    """Start the observability HTTP endpoint on a daemon thread; returns
    the MetricsHTTPServer (`.port` for port=0 binds, `.close()` to stop;
    loopback by default). Serves GET /metrics /healthz /statusz /debugz
    /trace /trace.jsonl /traces, /stepz with `stepclock` (an
    obs.timeline.StepClock) and, with `drain` (callable -> dict), POST
    /drainz; installs the memory gauges (obs/mem.py) for `device` (a CUDA
    device gets device gauges, the CPU none). `healthy`/`status` as on
    MetricsHTTPServer."""
    from dnn_tpu_torch.obs.http import MetricsHTTPServer
    from dnn_tpu_torch.obs.mem import install_memory_gauges

    install_memory_gauges(device=device)
    return MetricsHTTPServer(port=port, host=host, healthy=healthy,
                             status=status, drain=drain,
                             stepclock=stepclock)
