"""The port's fleet collector, the batcher's memory-economy lens, `node
--fleet_*` and the obs CLI against the JAX package's: both packages'
FleetCollectors over the same two canned endpoints (metrics, status and
spans with an injected clock skew) give equal merged views, offsets,
stitched traces and critical paths; the pure span functions agree on
canned payloads; a CPU batcher over the radix store feeds its KVLens
through the store's hooks and /kvz serves it; `node --serve_lm
--fleet_port 0 --fleet_targets ...` serves /fleetz as a process; each
ported `python -m dnn_tpu_torch.obs` subcommand's --selftest passes,
`caplens` exits 2, and `timeline PATH` / `incident PATH` print JAX's
text for the same capture and bundle. Exact equality: the fleet and
report code is host arithmetic on the same parsed numbers."""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from dnn_tpu import obs as jobs
from dnn_tpu.obs import __main__ as jcli
from dnn_tpu.obs import fleet as jfleet
from dnn_tpu.obs import slo as jslo
from dnn_tpu_torch import obs as tobs
from dnn_tpu_torch.obs import __main__ as tcli
from dnn_tpu_torch.obs import fleet as tfleet
from dnn_tpu_torch.obs import trace as ttrace
from dnn_tpu_torch.obs.http import MetricsHTTPServer
from dnn_tpu_torch.utils.metrics import Metrics

from test_torch_llama import one_torch_thread  # noqa: F401 — autouse

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _obs_on():
    was = (jobs.enabled(), tobs.enabled())
    jobs.set_enabled(True)
    tobs.set_enabled(True)
    yield
    jobs.set_enabled(was[0])
    tobs.set_enabled(was[1])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def _span(col, trace_id, span_id, parent_id, name, ts, dur, **attrs):
    """A finished span at a controlled wall-clock stamp in a collector."""
    s = ttrace.Span(name, trace_id, span_id, parent_id, attrs)
    s.t0 = ts - ttrace._EPOCH0
    s.dur = dur
    s._done = True
    col.add(s)
    return s


def _stable(z):
    """A /fleetz body without the poll's wall-clock stamps."""
    z = json.loads(json.dumps(z))
    for row in z.get("stages", {}).values():
        for k in ("age_s", "last_poll_s", "polled_at"):
            row.pop(k, None)
    for k in ("t", "polled_at", "generated_at", "age_s"):
        z.pop(k, None)
    return z


@pytest.fixture()
def two_stages():
    """Two port endpoints: node1 healthy with throughput, MFU, MBU and a
    client rpc span; node2 degraded, its server span 0.5 s skewed."""
    regA, regB = Metrics(), Metrics()
    regA.set("serving.tokens_per_sec", 10.0)
    regA.set("dnn_tpu_mfu", 0.25)
    regA.set("dnn_tpu_mbu", 0.5)
    regA.inc("cuda_graph_captures_total{graph=\"decode\"}", 2)
    regA.observe("serving.ttft_seconds", 0.02)
    regB.set("serving.tokens_per_sec", 5.0)
    colA, colB = ttrace.TraceCollector(), ttrace.TraceCollector()
    now = time.time()
    _span(colA, "t1", "c1", None, "rpc.forward", now, 0.10,
          cs=now, cr=now + 0.10)
    _span(colB, "t1", "s1", "c1", "stage.request", now + 0.52, 0.06,
          stage="node2")
    _span(colB, "t1", "s2", "s1", "stage.compute", now + 0.53, 0.03)
    sA = MetricsHTTPServer(port=0, registry=regA, collector=colA,
                           healthy=lambda: True)
    sB = MetricsHTTPServer(
        port=0, registry=regB, collector=colB,
        status=lambda: {"state": "degraded", "components": {
            "worker": {"state": "degraded", "detail": "t"}}})
    targets = {"node1": f"http://127.0.0.1:{sA.port}",
               "node2": f"http://127.0.0.1:{sB.port}"}
    yield targets
    sA.close()
    sB.close()


def test_fleet_views_equal_jax(two_stages):
    cols = {lib: mod.FleetCollector(two_stages, interval_s=3600.0)
            for lib, mod in (("t", tfleet), ("j", jfleet))}
    for c in cols.values():
        c.poll_once()
    zt, zj = (_stable(cols[k].fleetz()) for k in ("t", "j"))
    # a port target's compile count is its CUDA graph captures, which
    # JAX's collector does not read; the rest is equal
    assert zt["stages"]["node1"].pop("compiles_total") == 2.0
    assert zj["stages"]["node1"].pop("compiles_total") is None
    assert zt == zj
    assert zt["state"] == "degraded" and zt["stages"]["node1"]["mfu"] == 0.25
    assert abs(zt["clock_offsets_s"]["node2"] - 0.5) < 0.05
    st, sj = cols["t"].status(), cols["j"].status()
    st.pop("t"), sj.pop("t")
    assert st == sj
    assert cols["t"].stitch("t1") == cols["j"].stitch("t1")
    assert cols["t"].report("t1") == cols["j"].report("t1")
    assert cols["t"].render_prom() == cols["j"].render_prom()
    srv = tobs.serve_metrics(0, fleet=cols["t"], profiler=False)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        code, body = _get(base + "/fleetz")
        served = _stable(json.loads(body))
        served["stages"]["node1"].pop("compiles_total")
        assert code == 200 and served == zt
        assert _get(base + "/fleetz?format=prom")[1] == \
            cols["t"].render_prom()
        # the fleet's worst-of state is the endpoint's health
        code, body = _get(base + "/statusz")
        assert json.loads(body)["state"] == "degraded"
    finally:
        srv.close()
        for c in cols.values():
            c.close()


def test_span_functions_equal_jax():
    """estimate_offsets, stitch_spans and critical_path on one canned
    three-stage payload: equal outputs."""
    now = 1.7e9
    spans = {
        "A": [{"trace_id": "t", "span_id": "c1", "parent_id": None,
               "name": "rpc.forward", "ts": now, "dur": 0.3, "tid": 1,
               "attrs": {"cs": now, "cr": now + 0.3}}],
        "B": [{"trace_id": "t", "span_id": "s1", "parent_id": "c1",
               "name": "stage.request", "ts": now + 0.25, "dur": 0.1,
               "tid": 2, "attrs": {"stage": "B"}},
              {"trace_id": "t", "span_id": "c2", "parent_id": "s1",
               "name": "rpc.forward", "ts": now + 0.27, "dur": 0.05,
               "tid": 2, "attrs": {"cs": now + 0.27, "cr": now + 0.32}}],
        "C": [{"trace_id": "t", "span_id": "s2", "parent_id": "c2",
               "name": "stage.request", "ts": now - 0.7, "dur": 0.02,
               "tid": 3, "attrs": {"stage": "C"}}]}
    assert tfleet.estimate_offsets(spans) == jfleet.estimate_offsets(spans)
    assert tfleet.stitch_spans(spans) == jfleet.stitch_spans(spans)
    flat = [dict(s, stage=k) for k, v in spans.items() for s in v]
    assert tfleet.critical_path(flat) == jfleet.critical_path(flat)
    text = ("# TYPE a counter\na_total{x=\"1\"} 3\nb 2.5\ngarbage line\n")
    assert tfleet.parse_prometheus(text) == jfleet.parse_prometheus(text)


def test_batcher_feeds_the_kvlens_and_kvz_serves_it():
    """A paged CPU batcher with a 6-block radix store under 12 tenants'
    one-block prompts, twice round: the lens attaches at construction
    (its axis the effective pool), every admission is an access, the
    store's inserts are births (a full hit inserts nothing), its
    capacity evictions are attributed,
    re-admitted tenants are refetches, the shares equal the store's
    block hits; /kvz serves the summary in both formats."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models import gpt as tgpt
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    cfg = tgpt.PRESETS["gpt2-test"]
    prepared = from_jax_params(tgpt.init(0, cfg), cfg, "cpu")
    b = ContinuousBatcher(cfg, prepared, slots=2, max_len=64, prompt_pad=16,
                          block_len=8, kv="paged", paged_blocks=6 + 17,
                          prefix_cache=6, device="cpu")
    lens = b._kvlens
    assert lens is not None and b._prefix_store.lens is lens
    assert lens.pool_blocks == 6 and lens.block_len == 8
    for _ in range(2):
        for t in range(12):
            rid = b.submit((np.arange(8) + 37 * t) % 255 + 1, 1)
            b.drain()
            b.claim(rid)
    s = lens.summary()
    assert s["samples"]["accesses"] == 24 and lens.measured_accesses == 24
    # a resident tenant is a full hit: no chunk runs, nothing is born
    assert s["lifecycle"]["births"] == 24 - lens.measured_hits > 12
    assert s["lifecycle"]["evictions_by_cause"] == {
        "capacity": s["lifecycle"]["births"] - b._prefix_store.n_blocks}
    assert s["thrash"]["refetch_blocks"] >= 6
    assert lens.shares == b._prefix_store.block_hits
    assert s["thrash"]["chunk_s_ema"] > 0  # note_prefill fed the price
    srv = tobs.serve_metrics(0, kvlens=lens, profiler=False)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        code, body = _get(base + "/kvz")
        assert code == 200 and json.loads(body)["samples"]["accesses"] == 24
        assert "dnn_tpu_kvlens_pred_hit_ratio{mult=\"2x\"}" in \
            _get(base + "/kvz?format=prom")[1]
        assert "dnn_tpu_kvlens_measured_hit_ratio" in _get(
            base + "/metrics")[1]
    finally:
        srv.close()
    tobs.set_enabled(False)
    try:  # gate off at construction: no lens, the hooks one None test
        off = ContinuousBatcher(cfg, prepared, slots=2, max_len=64,
                                prompt_pad=16, block_len=8, kv="paged",
                                prefix_cache=6, device="cpu")
        assert off._kvlens is None and off._prefix_store.lens is None
    finally:
        tobs.set_enabled(True)


def test_node_serve_lm_with_the_fleet_collector_as_a_process(tmp_path):
    """`node --serve_lm --metrics_port M --fleet_port F --fleet_targets
    http://127.0.0.1:M --fleet_interval 0.2` as a process: /fleetz on F
    holds the daemon's own endpoint as a healthy stage, and SIGTERM
    drains it (exit 0)."""
    from dnn_tpu_torch.comm.client import NodeClient

    port, mport, fport = _free_port(), _free_port(), _free_port()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0, "address": f"127.0.0.1:{port}"}]}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", str(cfg), "--serve_lm", "--device", "cpu",
         "--metrics_port", str(mport), "--fleet_port", str(fport),
         "--fleet_targets", f"http://127.0.0.1:{mport}",
         "--fleet_interval", "0.2", "--slots", "2", "--max_len", "64",
         "--prompt_pad", "16"], cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=90)
        assert len(client.generate(np.arange(1, 9, dtype=np.int32),
                                   max_new_tokens=3)) == 3
        client.close()
        for _ in range(50):
            z = json.loads(_get(f"http://127.0.0.1:{fport}/fleetz")[1])
            (row,) = z["stages"].values()
            if row["state"] == "ok" and row.get("tokens_per_sec"):
                break
            time.sleep(0.2)
        assert z["state"] == "ok" and row["state"] == "ok"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


@pytest.mark.parametrize("cmd", ["trace", "flight", "fleet", "timeline",
                                 "kvlens", "trainlens"])
def test_cli_selftests_pass(cmd, capsys):
    assert tcli.main([cmd, "--selftest"]) == 0
    assert "selftest ok" in capsys.readouterr().out


def test_cli_caplens_exits_2_and_reports_print_jax_text(tmp_path, capsys):
    assert tcli.main(["caplens", "--url", "http://127.0.0.1:9"]) == 2
    assert "ROADMAP Queue 1 item 11" in capsys.readouterr().err
    from test_torch_obs_profile import _jax_trace

    _jax_trace(str(tmp_path), meta={"perf_begin": 1.0, "perf_end": 1.031,
                                    "step_begin": 0, "step_end": 3,
                                    "backend": "cpu"})
    outs = []
    for cli in (tcli, jcli):
        assert cli.main(["timeline", str(tmp_path)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "device: busy" in outs[0]
    recs = [{"i": 0, "t": 0.0, "outcome": None, "tokens": 0,
             "ttft_s": None, "itl_s": [], "t_done": None}]
    rep = jslo.evaluate("x", recs, jslo.SLOSpec(availability=0.9),
                        wall_s=1.0)
    d = jslo.write_incident_bundle(str(tmp_path / "inc"), rep, records=recs,
                                   flight=jobs.flight.FlightRecorder(4))
    for cli in (tcli, jcli):
        assert cli.main(["incident", d]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[2] == outs[3] and "SLO BREACH" in outs[2]
