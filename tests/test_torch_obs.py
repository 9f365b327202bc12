"""The port's observability layer (dnn_tpu_torch/obs, utils/metrics.py)
against the JAX package's: the same metric calls render the same
Prometheus text byte for byte, the flight ring overflows and orders as
JAX's, the watchdog classifies stubbed probes as JAX's does, the CPU
probe is real and bounded (its child imports no jax), and every route of
the HTTP endpoint answers as specified — the unported ones 404."""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from dnn_tpu.obs import flight as jflight
from dnn_tpu.obs import http as jhttp
from dnn_tpu.obs import watchdog as jwd
from dnn_tpu.utils import metrics as jmetrics
from dnn_tpu_torch.obs import flight as tflight
from dnn_tpu_torch.obs import http as thttp
from dnn_tpu_torch.obs import mem as tmem
from dnn_tpu_torch.obs import watchdog as twd
from dnn_tpu_torch.utils import metrics as tmetrics


def _script(m, lib):
    """One sequence of registry calls: counters, labeled series with
    characters the exposition format escapes, gauges stored and
    callable, reservoirs, histograms, a bulk update."""
    m.inc("serving.requests_total")
    m.inc(lib.labeled("serving.requests_total", outcome="length"), 3)
    m.inc(lib.labeled("comm.retries_total", target='a"b\\c', outcome="x"))
    m.set("dnn_tpu_replica_role{role=\"both\"}", 1.0)
    m.set("serving.kv_cache_bytes", 1.5e9)
    m.set("tiny", 1e-7)
    m.set_fn("serving.queue_depth", lambda: 4)
    m.set_fn("dead.gauge", lambda: 1 / 0)  # a dying producer reads 0
    for v in (0.004, 0.002, 0.2, 1.7, 0.0003, 12.0):
        m.observe("serving.ttft_seconds", v)
        m.observe_hist("comm.rpc_latency_seconds{method=\"x\"}", v)
    m.observe_hist("h.custom", 3.0, buckets=(1, 2, 5))
    m.bulk(counters={"serving.prefill_chunks_total": 7},
           gauges={"g.bulk": 2},
           observations={"serving.queue_wait_seconds": [0.1, 0.3]},
           hists={"h.bulk": [0.01, 7.0]})


def test_prometheus_text_is_byte_equal_to_jax():
    tm, jm = tmetrics.Metrics(), jmetrics.Metrics()
    _script(tm, tmetrics)
    _script(jm, jmetrics)
    text = tmetrics.render_prometheus(tm)
    assert text == jmetrics.render_prometheus(jm)
    assert "serving_requests_total{outcome=\"length\"} 3" in text
    assert tm.json_line() == jm.json_line()
    assert tmetrics.percentile([3, 1, 2], 50) == \
        jmetrics.percentile([3, 1, 2], 50)


def _ring(lib, cap):
    rec = lib.FlightRecorder(cap)
    for i in range(cap + 3):
        rec.record("admit" if i % 2 else "retire", rid=i,
                   trace_id="t1" if i % 3 == 0 else None, obj={1, 2})
    return rec


def _strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_flight_ring_overflow_and_order_match_jax():
    t, j = _ring(tflight, 5), _ring(jflight, 5)
    assert len(t) == len(j) == 5
    assert _strip_ts(t.events()) == _strip_ts(j.events())
    assert [e["seq"] for e in t.events()] == [4, 5, 6, 7, 8]
    for filters in ({"kind": "admit"}, {"trace_id": "t1"}, {"last": 2},
                    {"kind": "retire", "last": 1}):
        assert _strip_ts(t.events(**filters)) == \
            _strip_ts(j.events(**filters))
    drop = lambda text: [{k: v for k, v in json.loads(ln).items()
                          if k != "ts"} for ln in text.splitlines()]
    assert drop(t.jsonl()) == drop(j.jsonl())
    t.clear()
    assert len(t) == 0


# stubbed probes, each one's classification; "hang" sleeps past its
# deadline (the join's deadline plus 2 s of slack bounds it)
PROBES = {
    "ok": lambda d: (True, "ok"),
    "fast_fail": lambda d: (False, "backend error"),
    "timed_out": lambda d: (False, "probe timeout after 1s", True),
    "raises": lambda d: 1 / 0,
    "hang": lambda d: time.sleep(d + 3) or (True, "late"),
}


def _classify(lib, probe):
    wd = lib.Watchdog(period_s=0.1, probe_deadline_s=0.05,
                      device_probe=probe, heartbeat_stale_s=0.05,
                      registry=lib_registry(lib))
    wd._run_probe()
    return wd.state(), {k: v["state"]
                        for k, v in wd.status()["components"].items()}


def lib_registry(lib):
    return (tmetrics if lib is twd else jmetrics).Metrics()


def test_watchdog_classifies_probes_as_jax():
    """Both packages' watchdogs probed concurrently (the hanging probe
    costs its join deadline once)."""
    out = {}

    def run(key, lib, name):
        out[key] = _classify(lib, PROBES[name])

    threads = [threading.Thread(target=run, args=((lib, name), lib, name))
               for lib in (twd, jwd) for name in PROBES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for name in PROBES:
        assert out[(twd, name)] == out[(jwd, name)], name
    assert out[(twd, "ok")][0] == "ok"
    assert out[(twd, "fast_fail")][0] == "degraded"
    assert out[(twd, "raises")][0] == "degraded"
    assert out[(twd, "timed_out")][0] == "wedged"
    assert out[(twd, "hang")][0] == "wedged"


@pytest.mark.parametrize("warmed", [False, True])
def test_watchdog_heartbeat_staleness_and_escalation_match_jax(warmed):
    """A stale heartbeat reads degraded before the first completed step
    and wedged after it; a dead worker reads wedged; the wedged hook
    fires once an episode and re-arms on recovery."""
    res = {}
    for lib in (twd, jwd):
        fired = []
        alive = [True]
        wd = lib.Watchdog(period_s=0.1, device_probe=None,
                          heartbeat_stale_s=5.0,
                          alive_check=lambda: alive[0],
                          on_wedged=fired.append,
                          registry=lib_registry(lib))
        seq = [wd.state()]
        wd.beat()
        if warmed:
            wd.step_done()
        wd._check_heartbeat()
        seq.append(wd.state())
        wd._t_beat -= 10.0  # the last beat 10 s ago: stale
        wd._check_heartbeat()
        seq.append(wd.state())
        alive[0] = False
        wd._check_heartbeat()
        wd._fire_escalation()
        wd._fire_escalation()
        seq.append(wd.state())
        alive[0] = True
        wd.beat()
        wd._check_heartbeat()
        wd._fire_escalation()
        alive[0] = False
        wd._check_heartbeat()
        wd._fire_escalation()
        seq.append(len(fired))
        res[lib] = seq
    assert res[twd] == res[jwd]
    assert res[twd][2] == ("wedged" if warmed else "degraded")
    assert res[twd][3:] == ["wedged", 2]


def test_probe_is_real_bounded_imports_no_jax_and_never_falls_back():
    """The CPU probe answers ok; its child code imports neither jax nor
    dnn_tpu; a deadline too short for the device work times out (wedged:
    timed_out), an import past its budget fails fast (degraded: not
    timed out); and a CUDA daemon's probe on a host without a card fails
    (degraded) instead of answering from the CPU. The children run side
    by side."""
    code = twd._PROBE_CODE.format(device="cpu") + (
        "; import sys; bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'dnn_tpu'))]; print(bad)")
    out = {}
    jobs = {
        "cpu": lambda: twd.subprocess_device_probe(60.0, "cpu"),
        "deadline": lambda: twd.subprocess_device_probe(0.001, "cpu"),
        "imports": lambda: subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=60),
        "cuda": lambda: twd.subprocess_device_probe(60.0, "cuda"),
    }
    threads = [threading.Thread(target=lambda k=k: out.update({k: jobs[k]()}))
               for k in jobs]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    ok, detail, timed_out = twd.subprocess_device_probe(60.0, "cpu",
                                                        import_budget_s=0.01)
    assert (ok, timed_out) == (False, False)
    assert detail.startswith("probe import exceeded")
    assert time.perf_counter() - t0 < 5
    for t in threads:
        t.join(timeout=120)
    assert out["cpu"] == (True, "ok", False)
    ok, detail, timed_out = out["deadline"]
    assert (ok, timed_out) == (False, True)
    assert detail.startswith("probe timeout")
    assert out["imports"].returncode == 0, out["imports"].stderr
    assert out["imports"].stdout.strip().splitlines()[-1] == "[]"
    if not torch.cuda.is_available():
        ok, detail, timed_out = out["cuda"]
        assert (ok, timed_out) == (False, False)
        assert detail.startswith("probe exited rc=")
    assert twd.PROBE_DEADLINE_FLOOR_S == 6.0


@pytest.mark.parametrize("slack,state", [(0.05, "wedged"), (2.0, "ok")])
def test_watchdog_join_allows_the_probe_slack(slack, state):
    """A probe that outlives its deadline reads wedged unless the join's
    slack (the subprocess probe's import budget) covers it."""
    wd = twd.Watchdog(period_s=0.1, probe_deadline_s=0.05,
                      device_probe=lambda d: time.sleep(0.3) or (True, "ok"),
                      registry=tmetrics.Metrics(), probe_slack_s=slack)
    wd._run_probe()
    assert wd.state() == state


def test_memory_gauges_name_the_device():
    reg = tmetrics.Metrics()
    assert tmem.install_memory_gauges(reg, device=torch.device("cpu")) == \
        ["process_resident_bytes"]
    assert tmem.install_memory_gauges(reg, device=torch.device("cpu")) == []
    assert reg.snapshot()["gauges"]["process_resident_bytes"] > 0
    names = tmem.install_memory_gauges(reg, device=torch.device("cuda:0"))
    assert names == [
        'dnn_tpu_device_bytes_in_use{device="cuda:0"}',
        'dnn_tpu_device_peak_bytes_in_use{device="cuda:0"}',
        'dnn_tpu_device_bytes_limit{device="cuda:0"}']
    reg.clear()  # a cleared registry gets the gauges again
    assert tmem.install_memory_gauges(reg) == ["process_resident_bytes"]


@pytest.fixture(scope="module")
def endpoint():
    """A MetricsHTTPServer over its own registry and ring; the status,
    liveness and drain callables are switchable."""
    reg = tmetrics.Metrics()
    _script(reg, tmetrics)
    ring = tflight.FlightRecorder(16)
    for i in range(4):
        ring.record("admit" if i % 2 else "retire", rid=i, trace_id="x")
    state = {"status": {"state": "ok", "components": {
        "device": {"state": "ok", "detail": "ok"}}}, "healthy": True,
        "raise": False, "drains": 0}

    def status():
        if state["raise"]:
            raise RuntimeError("status broke")
        return state["status"]

    def drain():
        state["drains"] += 1
        return {"draining": True, "n": state["drains"]}

    srv = thttp.MetricsHTTPServer(port=0, registry=reg, flight=ring,
                                  healthy=lambda: state["healthy"],
                                  status=status, drain=drain)
    try:
        yield f"http://127.0.0.1:{srv.port}", reg, ring, state
    finally:
        srv.close()


def _get(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers["Content-Type"]


def test_served_routes(endpoint):
    base, reg, ring, state = endpoint
    code, body, ctype = _get(base + "/metrics")
    assert (code, body) == (200, tmetrics.render_prometheus(reg))
    assert ctype.startswith("text/plain; version=0.0.4")
    assert _get(base + "/healthz")[:2] == (200, "ok\n")
    code, body, _ = _get(base + "/statusz")
    assert code == 200 and json.loads(body) == state["status"]
    code, body, _ = _get(base + "/statusz?format=prom")
    assert body == jhttp._status_prom(state["status"])
    assert _get(base + "/statusz?format=xml")[0] == 400
    code, body, ctype = _get(base + "/debugz")
    assert ctype == "application/x-ndjson" and body == ring.jsonl()
    code, body, ctype = _get(base + "/debugz?format=json&kind=admit&last=1")
    assert ctype == "application/json"
    assert json.loads(body) == ring.events(kind="admit", last=1)
    assert _get(base + "/debugz?last=x")[0] == 400
    code, body, ctype = _get(base + "/drainz", "POST")
    assert (code, json.loads(body)) == (202, {"draining": True, "n": 1})
    assert _get(base + "/nope")[:2] == (404, "not found\n")
    assert _get(base + "/metrics", "POST")[0] == 404


@pytest.mark.parametrize("state_name,code", [
    ("degraded", 200), ("wedged", 503), ("draining", 503)])
def test_healthz_follows_statusz(endpoint, state_name, code):
    base, _, _, state = endpoint
    state["status"] = {"state": state_name, "components": {}}
    try:
        assert _get(base + "/healthz")[:2] == (code, state_name + "\n")
    finally:
        state["status"] = {"state": "ok", "components": {}}


def test_healthz_unhealthy_and_handler_errors(endpoint):
    base, _, _, state = endpoint
    state["healthy"] = False
    try:
        assert _get(base + "/healthz")[:2] == (503, "unhealthy\n")
    finally:
        state["healthy"] = True
    state["raise"] = True
    try:  # a handler that raises answers 500, never an empty 200
        assert _get(base + "/statusz")[:2] == (500, "internal error\n")
    finally:
        state["raise"] = False


@pytest.mark.parametrize("path", thttp.UNPORTED_ROUTES)
def test_unported_routes_answer_404(endpoint, path):
    base = endpoint[0]
    for method in ("GET", "POST"):
        code, body, _ = _get(base + path, method)
        assert code == 404 and "ROADMAP Queue 1 item 12" in body, body
