"""CLI: `python -m dnn_tpu_torch.obs {trace,flight,fleet,timeline,incident,
kvlens,trainlens,caplens} ...` — obs tooling (port of dnn_tpu/obs/
__main__.py, the same subcommands over the port's modules; `caplens`
exits 2: the capacity observatory is the router's, ROADMAP Queue 1
item 11).

    python -m dnn_tpu_torch.obs trainlens --url http://host:port
        Fetch a running trainer's /trainz (the training-step
        observatory, obs/trainlens.py) and print the per-phase step
        decomposition (data/dispatch/wait/ckpt/eval/obs with fractions),
        the data-stall fraction, MFU against the device roofline,
        tokens/sec, and the checkpoint staleness. --json for the raw
        dict.

    python -m dnn_tpu_torch.obs trainlens PATH
        Render a saved /trainz JSON dump (a `curl .../trainz >
        trainz.json` capture) with the same table — post-mortems read
        dumps, not live servers.

    python -m dnn_tpu_torch.obs trainlens --selftest
        In-process smoke: hand-computed phase/stall/MFU goldens on an
        injected clock, checkpoint staleness arithmetic, the
        gradient-sentinel NaN latch, gate-off-records-nothing, and the
        /trainz endpoint in both formats; exit 0 on success. Tier-1
        wired (tests/test_obs_trainlens.py).

    python -m dnn_tpu_torch.obs kvlens --url http://host:port
        Fetch a running server's /kvz (the memory-economy observatory,
        obs/kvlens.py) and print the miss-ratio curve — predicted
        block-hit ratio at 0.5x..8x of the configured KV pool — next
        to the measured ratio at the real capacity, the sampling
        stats, and the thrash bill (evict→refetch re-prefill
        chunk-seconds + migrated bytes). --json for the raw dict.

    python -m dnn_tpu_torch.obs kvlens PATH
        Render a saved /kvz JSON dump (a `curl .../kvz > kvz.json`
        capture) with the same table — post-mortems read dumps, not
        live servers.

    python -m dnn_tpu_torch.obs kvlens --selftest
        In-process smoke: hand-computed LRU stack-distance/MRC
        goldens (rate=1), SHARDS sampling determinism (same seed ⇒
        bit-identical curve), thrash-window arithmetic on an injected
        clock, gate-off-records-nothing, and the /kvz endpoint in both
        formats; exit 0 on success. Tier-1 wired
        (tests/test_obs_kvlens.py).

    python -m dnn_tpu_torch.obs incident PATH [--json]
        Render an SLO-breach incident bundle (obs/slo.py — written
        automatically by the workload runner when a scenario's verdict
        is a breach): the verdict header, each failed objective, and
        the flight ring's event-by-event timeline over the breach
        window, plus the step-clock and fleet snapshots when captured.

    python -m dnn_tpu_torch.obs timeline --url http://host:port
        Fetch a running server's /stepz and print the per-phase
        decode-step decomposition (admit/host/dispatch/wait/commit/obs
        with fractions, dispatch-slack, sync-tax, host fraction).
        --out steps.json additionally writes the last N steps as a
        Perfetto-loadable host track (?format=trace).

    python -m dnn_tpu_torch.obs timeline PATH
        Analyze one device capture (a POST /profilez capture dir, or a
        *.trace.json[.gz] file) with obs/timeline.analyze: per-track
        busy fractions, device busy/idle, the host-gap histogram
        between consecutive device ops, top-K ops by device time, and
        — when the capture's sidecar meta.json is present — its
        position on the step axis. --json for the raw dict.

    python -m dnn_tpu_torch.obs timeline --selftest
        In-process smoke: a deterministic StepClock (injected clock)
        plus a synthetic gzipped Perfetto trace, checked end to end;
        exit 0 on success. Tier-1 wired (tests/test_obs_timeline.py).

    python -m dnn_tpu_torch.obs fleet --targets http://h1:9100,http://h2:9100
        One-shot fleet report: poll every stage's /metrics /statusz
        /trace.jsonl, print the merged rollup (worst-of health,
        per-stage percentiles, fleet throughput, clock offsets) and the
        newest request's critical-path/bubble attribution.
        --config config.json --metrics_port 9100  derives the targets
        from the pipeline config instead (every node's host + one
        shared metrics port). --out stitched.json additionally writes
        the stitched cross-host Perfetto trace (--id to pick a trace).

    python -m dnn_tpu_torch.obs fleet --targets ... --serve PORT
        Long-lived collector: poll on --interval (default 5 s) and
        serve /fleetz (+ /metrics /statusz /healthz with the fleet's
        worst-of health) until interrupted.

    python -m dnn_tpu_torch.obs fleet --selftest
        In-process smoke: two real stage HTTP endpoints with injected
        clock skew, poll, merged rollup, offset recovery, stitched
        trace, critical-path golden; exit 0 on success. Tier-1 wired
        (tests/test_obs_fleet.py).

    python -m dnn_tpu_torch.obs trace --selftest
        In-process smoke of the whole span pipeline (nested spans,
        cross-thread explicit parents, wire-tag round-trip, JSONL and
        Chrome-trace export, Prometheus render) with schema validation;
        exit 0 on success. Wired into tier-1 (tests/test_obs.py).

    python -m dnn_tpu_torch.obs trace --jsonl spans.jsonl --out chrome.json \
        [--id TRACE_ID]
        Convert a JSONL span dump (the /trace.jsonl endpoint's format,
        or TraceCollector.dump_jsonl) into Chrome-trace JSON for
        Perfetto / chrome://tracing.

    python -m dnn_tpu_torch.obs flight --url http://host:port \
        [--out ring.jsonl] [--kind KIND] [--trace ID] [--last N]
        Fetch a running server's flight-recorder ring (GET /debugz,
        obs/flight.py) and print or save it as JSONL.

    python -m dnn_tpu_torch.obs flight --selftest
        In-process smoke of the flight ring (record/overflow/filters/
        crash-dump schema); exit 0 on success.

Pure Python over the port's obs modules: the tooling imports no torch
state a host without a card lacks.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def _selftest() -> int:
    from dnn_tpu_torch import obs

    obs.set_enabled(True)
    col = obs.TraceCollector(capacity=256)
    # route this selftest's spans into a private collector so a shared
    # process (the test suite) keeps its ring clean
    import dnn_tpu_torch.obs.trace as _t

    saved = _t._collector
    _t._collector = col
    try:
        with obs.span("request", kind="selftest") as root:
            with obs.span("prefill", chunks=2):
                time.sleep(0.001)
            # cross-thread child via explicit parent (the batcher-worker
            # pattern)
            def worker():
                s = obs.start_span("decode", parent=root, bucket=64)
                time.sleep(0.001)
                s.end(tokens=3)

            t = threading.Thread(target=worker)
            t.start()
            t.join()
            # wire round-trip: tag -> parse -> remote child
            rid = obs.tag_request_id("gen:8", root)
            parsed = obs.parse_wire_tag(rid)
            assert parsed is not None and parsed[0] == root.trace_id, rid
            assert obs.strip_wire_tag(rid) == "gen:8", rid
            remote = obs.start_span("rpc.remote", trace_id=parsed[0],
                                    parent_id=parsed[1])
            remote.end()

        spans = col.spans(root.trace_id)
        names = {s.name for s in spans}
        assert names == {"request", "prefill", "decode", "rpc.remote"}, names
        by_name = {s.name: s for s in spans}
        for child in ("prefill", "decode", "rpc.remote"):
            assert by_name[child].parent_id == root.span_id, child
            assert by_name[child].trace_id == root.trace_id, child
        assert by_name["request"].parent_id is None

        # JSONL: one valid object per line, schema keys present
        lines = [json.loads(ln) for ln in
                 col.jsonl(root.trace_id).splitlines()]
        assert len(lines) == 4
        for d in lines:
            assert {"trace_id", "span_id", "parent_id", "name", "ts",
                    "dur", "tid", "attrs"} <= set(d), d
            assert d["dur"] >= 0.0

        # Chrome trace: X events with µs timestamps + thread metadata
        ct = col.chrome_trace(root.trace_id)
        xs = [e for e in ct["traceEvents"] if e.get("ph") == "X"]
        ms = [e for e in ct["traceEvents"] if e.get("ph") == "M"]
        assert len(xs) == 4 and ms, ct
        for e in xs:
            assert e["ts"] > 0 and e["dur"] >= 0
            assert e["args"]["trace_id"] == root.trace_id

        # Prometheus render smoke (the other export surface)
        from dnn_tpu_torch.utils.metrics import Metrics, labeled, render_prometheus

        m = Metrics()
        m.inc(labeled("selftest_total", leg="trace"))
        m.observe("selftest_seconds", 0.001)
        text = render_prometheus(m)
        assert "# TYPE selftest_total counter" in text
        assert 'selftest_total{leg="trace"} 1' in text
    finally:
        _t._collector = saved
    print(f"obs selftest ok: {len(spans)} spans, 1 trace "
          f"({root.trace_id}), chrome+jsonl+prometheus schemas valid")
    return 0


def _convert(jsonl_path: str, out_path: str, trace_id=None) -> int:
    from dnn_tpu_torch.obs.trace import spans_to_chrome

    dicts = []
    with open(jsonl_path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            d = json.loads(ln)
            if trace_id is None or d.get("trace_id") == trace_id:
                dicts.append(d)
    chrome = spans_to_chrome(dicts)
    with open(out_path, "w") as f:
        json.dump(chrome, f)
    n = sum(1 for e in chrome["traceEvents"] if e.get("ph") == "X")
    print(f"wrote {out_path}: {n} spans"
          + (f" (trace {trace_id})" if trace_id else ""))
    return 0


def _flight_selftest() -> int:
    from dnn_tpu_torch import obs
    from dnn_tpu_torch.obs.flight import FlightRecorder

    obs.set_enabled(True)
    fr = FlightRecorder(capacity=4)
    for i in range(6):
        fr.record("probe", i=i)
    evs = fr.events()
    assert len(evs) == 4, evs  # bounded: newest 4 survive
    assert [e["i"] for e in evs] == [2, 3, 4, 5], evs
    assert [e["seq"] for e in evs] == sorted(e["seq"] for e in evs)
    fr.record("deadline_miss", trace_id="cafe", rid=7)
    hit = fr.events(kind="deadline_miss")
    assert len(hit) == 1 and hit[0]["trace_id"] == "cafe"
    assert fr.events(trace_id="cafe") == hit
    assert len(fr.events(last=2)) == 2
    lines = [json.loads(ln) for ln in fr.jsonl().splitlines()]
    for d in lines:
        assert {"seq", "ts", "kind"} <= set(d), d
    win = fr.window(hit[0]["ts"], before_s=60, after_s=1)
    assert hit[0] in win and len(win) >= 2  # surrounding events ride along
    print(f"flight selftest ok: {len(lines)} events, overflow/filters/"
          "window/schema valid")
    return 0


def _flight_fetch(url: str, out=None, kind=None, trace=None,
                  last=None) -> int:
    from urllib.parse import urlencode
    from urllib.request import urlopen

    q = {k: v for k, v in
         (("kind", kind), ("trace", trace), ("last", last))
         if v is not None}
    full = url.rstrip("/") + "/debugz" + ("?" + urlencode(q) if q else "")
    body = urlopen(full, timeout=10).read().decode()
    if out:
        with open(out, "w") as f:
            f.write(body)
        print(f"wrote {out}: {len(body.splitlines())} events")
    else:
        sys.stdout.write(body)
    return 0


def _fleet_selftest() -> int:
    """Two REAL stage HTTP endpoints in-process (private registries +
    collectors, ±500 ms injected skew on the second), one FleetCollector
    over them: merged rollup, offset recovery, stitching, critical-path
    math, and the prom re-export all checked end to end."""
    import time as _time

    from dnn_tpu_torch import obs
    from dnn_tpu_torch.obs import trace as _t
    from dnn_tpu_torch.obs.fleet import FleetCollector, critical_path
    from dnn_tpu_torch.obs.http import MetricsHTTPServer
    from dnn_tpu_torch.utils.metrics import Metrics

    obs.set_enabled(True)
    SKEW = 0.5
    regA, regB = Metrics(), Metrics()
    regA.set("serving.tokens_per_sec", 10.0)
    regB.set("serving.tokens_per_sec", 5.0)
    colA, colB = obs.TraceCollector(), obs.TraceCollector()

    def mk(col, trace_id, span_id, parent_id, name, ts, dur, **attrs):
        s = _t.Span(name, trace_id, span_id, parent_id, attrs)
        s.t0, s.dur, s._done = ts - _t._EPOCH0, dur, True
        col.add(s)

    now = _time.time()
    # client hop on A (true timeline), server span on B stamped by a
    # clock running SKEW ahead
    mk(colA, "t1", "c1", None, "rpc.forward", now, 0.10,
       cs=now, cr=now + 0.10)
    mk(colB, "t1", "s1", "c1", "stage.request", now + 0.02 + SKEW, 0.06,
       stage="node2")
    sA = MetricsHTTPServer(port=0, registry=regA, collector=colA,
                           healthy=lambda: True)
    sB = MetricsHTTPServer(
        port=0, registry=regB, collector=colB,
        status=lambda: {"state": "degraded", "components": {}})
    try:
        fc = FleetCollector({"node1": f"http://127.0.0.1:{sA.port}",
                             "node2": f"http://127.0.0.1:{sB.port}"})
        fc.poll_once()
        z = fc.fleetz()
        assert z["state"] == "degraded", z["state"]  # worst-of rollup
        assert z["fleet"]["tokens_per_sec"] == 15.0, z["fleet"]
        assert z["stages"]["node1"]["state"] == "ok"
        off = z["clock_offsets_s"]["node2"]
        assert abs(off - SKEW) < 0.1 * SKEW, off  # ±500 ms within 10%
        ct = fc.stitch("t1")
        xs = [e for e in ct["traceEvents"] if e.get("ph") == "X"]
        assert len(xs) == 2, ct
        pids = {e["args"]["stage"]: e["pid"] for e in xs}
        assert len(set(pids.values())) == 2, pids  # one track per stage
        # after correction the server span sits INSIDE the client hop
        by_name = {e["name"]: e for e in xs}
        c, s = by_name["rpc.forward"], by_name["stage.request"]
        assert c["ts"] <= s["ts"] <= s["ts"] + s["dur"] \
            <= c["ts"] + c["dur"] + 1e3, (c, s)
        assert "dnn_tpu_fleet_state" in fc.render_prom()
        rep = fc.request_report("t1")
        assert rep["spans"] == 2 and 0.0 < rep["bubble_fraction"] < 1.0
        # critical-path golden: 3 sequential leaves under a 10 ms root
        # with a 1 ms gap -> bubble exactly 10%
        g = critical_path([
            {"span_id": "r", "parent_id": None, "name": "request",
             "ts": 0.0, "dur": 0.010, "attrs": {}},
            {"span_id": "a", "parent_id": "r", "name": "compute",
             "ts": 0.0, "dur": 0.003, "attrs": {"stage": "s0"}},
            {"span_id": "b", "parent_id": "r", "name": "compute",
             "ts": 0.004, "dur": 0.003, "attrs": {"stage": "s1"}},
            {"span_id": "c", "parent_id": "r", "name": "compute",
             "ts": 0.007, "dur": 0.003, "attrs": {"stage": "s2"}},
        ])
        assert abs(g["bubble_fraction"] - 0.1) < 1e-6, g
        assert [p["stage"] for p in g["path"]] == ["s0", "s1", "s2"], g
        fc.close()
    finally:
        sA.close()
        sB.close()
    print(f"fleet selftest ok: rollup worst-of, offset {off:+.3f}s "
          f"recovered (true {SKEW:+.3f}s), stitch + critical-path/"
          "bubble golden, prom re-export valid")
    return 0


def _timeline_selftest() -> int:
    """Deterministic StepClock (injected clock) + a synthetic gzipped
    Perfetto capture with a sidecar meta, checked end to end: phase
    arithmetic, derived series, chrome export, prom render, registry
    histograms, capture analysis, step alignment, garbage rejection."""
    import gzip
    import os
    import tempfile

    from dnn_tpu_torch import obs
    from dnn_tpu_torch.obs.timeline import StepClock, analyze
    from dnn_tpu_torch.utils.metrics import Metrics

    obs.set_enabled(True)
    t = [100.0]
    reg = Metrics()
    clk = StepClock(capacity=8, registry=reg, now=lambda: t[0])
    for _i in range(3):
        t[0] += 0.0005  # one admit per iteration, 0.5 ms
        clk.note_admit(t[0] - 0.0005)
        rec = clk.begin()
        assert rec is not None
        for phase, dt in (("host", 0.001), ("dispatch", 0.002),
                          ("wait", 0.004), ("commit", 0.001),
                          ("obs", 0.001)):
            t[0] += dt
            clk.mark(rec, phase)
        clk.end(rec, n_adv=4)
        t[0] += 0.0005  # inter-step gap: genuinely unattributed
    s = clk.summary()
    assert s["window_steps"] == 3 and s["steps_total"] == 3, s
    # per step: wall 9 ms + 0.5 ms admit; host 3.5 ms, device 6 ms
    assert abs(s["host_fraction"] - 3.5 / 9.5) < 1e-3, s
    assert abs(s["dispatch_slack"] - 3.5 / 6.0) < 1e-3, s
    assert abs(s["sync_tax"] - 4.0 / 9.5) < 1e-3, s
    assert s["tokens"] == 12, s
    ct = clk.chrome_trace()
    xs = [e for e in ct["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == 3 * 6, len(xs)  # 5 phases + 1 admit slice / step
    assert {e["name"] for e in xs} == {"admit", "host", "dispatch",
                                       "wait", "commit", "obs"}
    prom = clk.render_prom()
    assert "dnn_tpu_step_host_fraction" in prom, prom
    snap = reg.snapshot()
    assert 'step.phase_seconds{phase="wait"}' in snap["histogram"], snap

    # synthetic capture: one 6 ms device op per step's in-flight window
    d = tempfile.mkdtemp(prefix="tl-selftest")
    events = [
        {"ph": "M", "pid": 7, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 7, "tid": 2, "name": "thread_name",
         "args": {"name": "tf_XLATfrtCpuClient"}},
    ]
    for i in range(3):
        t0_rel = (0.0005 + 0.010 * i + 0.001) * 1e6  # dispatch start
        events.append({"ph": "X", "pid": 7, "tid": 2, "name": "fusion.1",
                       "ts": t0_rel, "dur": 6000.0,
                       "args": {"hlo_op": "fusion.1",
                                "hlo_module": "jit_step"}})
    with gzip.open(os.path.join(d, "vm.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ns"}, f)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"perf_begin": 100.0, "perf_end": 100.0305,
                   "step_begin": 0, "step_end": 3, "backend": "cpu"}, f)
    a = analyze(d, clock=clk)
    assert a["device"]["ops"] == 3, a["device"]
    assert abs(a["device"]["busy_s"] - 0.018) < 1e-6, a["device"]
    assert a["host_gaps"]["count"] == 2, a["host_gaps"]
    assert abs(a["host_gaps"]["p50_ms"] - 4.0) < 0.01, a["host_gaps"]
    assert a["top_ops"][0]["name"] == "fusion.1", a["top_ops"]
    st = a["steps"]
    assert st and st["aligned"] and st["n_steps"] == 3, st
    assert st["steps_in_capture"] == 3, st
    # each step: 6 ms device busy inside a 9.5 ms attributed wall
    assert abs(st["device_overlap_frac"] - 18.0 / 28.5) < 1e-3, st

    # garbage and truncated inputs fail loud, not half-parsed
    bad = os.path.join(d, "garbage.json")
    with open(bad, "w") as f:
        f.write("not a trace {{{")
    for p in (bad,):
        try:
            analyze(p)
            raise AssertionError("garbage input must raise ValueError")
        except ValueError:
            pass
    print("timeline selftest ok: 3 deterministic steps (host fraction "
          f"{s['host_fraction']:.2%}, slack {s['dispatch_slack']:.2f}, "
          f"sync tax {s['sync_tax']:.2%}), synthetic capture analyzed "
          f"(device busy {a['device']['busy_frac']:.1%}, 3 steps "
          "aligned), garbage rejected")
    return 0


def _timeline_url(url: str, out=None, last=None) -> int:
    from urllib.request import urlopen

    base = url.rstrip("/") + "/stepz"
    q = f"?last={last}" if last else ""
    s = json.loads(urlopen(base + q, timeout=10).read().decode())
    phases = s.get("phases", {})
    print(f"steps: {s.get('steps_total')} total, "
          f"{s.get('window_steps')} in window "
          f"({s.get('window_wall_s', 0) * 1e3:.1f} ms wall, "
          f"{s.get('tokens')} tokens)")
    for p, d in phases.items():
        print(f"  {p:<9} {d['frac']:7.1%}  {d['mean_ms']:9.3f} ms/step")
    print(f"host fraction {s.get('host_fraction', 0):.1%} | "
          f"dispatch slack {s.get('dispatch_slack', 0):.2f} | "
          f"sync tax {s.get('sync_tax', 0):.1%} | "
          f"{s.get('steps_per_sec', 0):.1f} steps/s | last step "
          f"{s.get('last_wall_ms', 0):.2f} ms")
    if out:
        trace = urlopen(base + "?format=trace"
                        + (f"&last={last}" if last else ""),
                        timeout=10).read().decode()
        with open(out, "w") as f:
            f.write(trace)
        n = sum(1 for e in json.loads(trace)["traceEvents"]
                if e.get("ph") == "X")
        print(f"wrote {out}: {n} phase slices (load in Perfetto)")
    return 0


def _timeline_path(path: str, as_json: bool, top: int) -> int:
    from dnn_tpu_torch.obs.timeline import analyze, render_report

    a = analyze(path, top_k=top)
    if as_json:
        print(json.dumps(a, indent=2))
    else:
        print(render_report(a))
    return 0


def _kvlens_selftest() -> int:
    """Deterministic KVLens end to end: MRC goldens at rate=1 (every
    access sampled — stack distances are exact), sampling determinism,
    thrash-window arithmetic on an injected clock, the gate, and the
    /kvz endpoint in both formats."""
    from types import SimpleNamespace
    from urllib.request import urlopen

    import numpy as np

    from dnn_tpu_torch import obs
    from dnn_tpu_torch.obs.kvlens import KVLens

    obs.set_enabled(True)
    # -- MRC golden: pool=4, caps (2,4,8,16,32); trace A B C A --------
    bp = 4
    A = np.arange(0, bp)
    B = np.arange(100, 100 + bp)
    C = np.arange(200, 200 + bp)
    lens = KVLens(4, bp, seed=0, rate=1.0, now=lambda: 0.0)
    for p in (A, B, C, A):
        lens.on_access(p)
    # the re-accessed A sits at stack distance 2 (B, C more recent):
    # a hit at every capacity > 2, a miss at the 0.5x (=2) pool
    got = [c["predicted_hit_ratio"] for c in lens.curve()]
    assert got == [0.0, 0.25, 0.25, 0.25, 0.25], got
    assert lens.sampled == 4 and lens.sampled_cold == 3, (
        lens.sampled, lens.sampled_cold)

    # -- sampling determinism: same seed ⇒ bit-identical curve --------
    def run(seed):
        ln = KVLens(8, bp, seed=seed, rate=0.3, now=lambda: 0.0)
        for i in range(200):
            ln.on_access(np.arange((i % 17) * bp, (i % 17) * bp + bp))
        return ln

    l1, l2 = run(7), run(7)
    assert l1.curve() == l2.curve() and l1.sampled == l2.sampled
    assert 0 < l1.sampled < l1.accesses  # the rate really subsamples

    # -- thrash-window arithmetic (injected clock) --------------------
    t = [0.0]
    lens = KVLens(4, bp, seed=0, rate=1.0, thrash_window_s=10.0,
                  bytes_per_block=64, now=lambda: t[0])
    lens.note_prefill(2, 1.0)   # EMA seeds at 0.5 s/chunk
    node = SimpleNamespace(depth=1, obskey=None)
    lens.on_insert(A, [node])
    assert node.obskey is not None
    lens.on_evict([node.obskey], cause="capacity")
    t[0] = 5.0                  # inside the window: a refetch
    lens.on_insert(A, [SimpleNamespace(depth=1, obskey=None)])
    assert lens.refetch_blocks == 1, lens.refetch_blocks
    assert abs(lens.thrash_chunk_seconds - 0.5) < 1e-9
    nb = SimpleNamespace(depth=1, obskey=None)
    lens.on_insert(B, [nb])
    lens.on_evict([nb.obskey], cause="capacity")
    t[0] = 16.0                 # past the window: churn, not thrash
    lens.on_insert(B, [SimpleNamespace(depth=1, obskey=None)])
    assert lens.refetch_blocks == 1, lens.refetch_blocks
    # an ADOPTED refetch bills the wire too
    na = SimpleNamespace(depth=1, obskey=None)
    lens.on_insert(C, [na], origin="adopted")
    lens.on_evict([na.obskey], cause="capacity")
    t[0] = 17.0
    lens.on_insert(C, [SimpleNamespace(depth=1, obskey=None)],
                   origin="adopted")
    assert lens.refetch_blocks == 2
    assert lens.thrash_migrated_bytes == 64
    kinds = [e["kind"] for e in lens.ledger.events()]
    assert kinds.count("refetch") == 2 and "evict" in kinds, kinds

    # -- gate off records NOTHING -------------------------------------
    obs.set_enabled(False)
    try:
        off = KVLens(4, bp, seed=0, rate=1.0)
        off.on_access(A)
        off.on_insert(A, [SimpleNamespace(depth=1, obskey=None)])
        off.on_evict([b"x" * 16])
        off.on_share(3)
        off.note_prefill(1, 1.0)
        assert off.accesses == 0 and off.births == 0
        assert off.shares == 0 and len(off.ledger) == 0
    finally:
        obs.set_enabled(True)

    # -- /kvz endpoint, both formats ----------------------------------
    srv = obs.serve_metrics(0, kvlens=lens)
    try:
        base = f"http://127.0.0.1:{srv.port}/kvz"
        z = json.loads(urlopen(base, timeout=10).read().decode())
        assert [c["mult"] for c in z["curve"]] == \
            ["0.5x", "1x", "2x", "4x", "8x"], z["curve"]
        assert z["thrash"]["refetch_blocks"] == 2, z["thrash"]
        prom = urlopen(base + "?format=prom",
                       timeout=10).read().decode()
        assert 'dnn_tpu_kvlens_pred_hit_ratio{mult="2x"}' in prom
        assert "dnn_tpu_kvlens_thrash_chunk_seconds_total" in prom
    finally:
        srv.close()
    print("kvlens selftest ok: MRC golden [0, .25, .25, .25, .25] at "
          f"caps (2..32), determinism ({l1.sampled}/{l1.accesses} "
          "sampled twice, bit-identical), thrash 2 refetches = "
          f"{lens.thrash_chunk_seconds:.1f} chunk-s + 64 B wire, gate "
          "off silent, /kvz json+prom served")
    return 0


def _kvlens_render(z: dict) -> None:
    cfg = z.get("config", {})
    smp = z.get("samples", {})
    meas = z.get("measured", {})
    print(f"pool {cfg.get('pool_blocks')} blocks x block_len "
          f"{cfg.get('block_len')} | sampling rate {cfg.get('rate')} "
          f"seed {cfg.get('seed')} | {smp.get('sampled')}/"
          f"{smp.get('accesses')} accesses sampled "
          f"({smp.get('cold')} cold)")
    print(f"{'capacity':>10} {'mult':>6} {'predicted hit':>14}")
    for c in z.get("curve", []):
        v = c.get("predicted_hit_ratio")
        print(f"{c.get('capacity_blocks'):>10} {c.get('mult'):>6} "
              + (f"{v:>13.1%}" if v is not None else f"{'—':>13}"))
    mr = meas.get("hit_ratio")
    print(f"measured at 1x: "
          + (f"{mr:.1%}" if mr is not None else "—")
          + f" ({meas.get('hits')}/{meas.get('accesses')} blocks)")
    th = z.get("thrash", {})
    print(f"thrash: {th.get('refetch_blocks')} refetches inside "
          f"{th.get('window_s')}s = {th.get('chunk_seconds')} "
          f"re-prefill chunk-s + {th.get('migrated_bytes')} B "
          "re-migrated")
    lc = z.get("lifecycle", {})
    print(f"lifecycle: {lc.get('births')} births, {lc.get('shares')} "
          f"shares ({lc.get('cows')} COW), {lc.get('migrations')} "
          f"migrated blocks, evictions {lc.get('evictions_by_cause')}")


def _kvlens_url(url: str, as_json: bool) -> int:
    from urllib.request import urlopen

    z = json.loads(urlopen(url.rstrip("/") + "/kvz",
                           timeout=10).read().decode())
    if as_json:
        print(json.dumps(z, indent=2, default=str))
    else:
        _kvlens_render(z)
    return 0


def _kvlens_path(path: str, as_json: bool) -> int:
    with open(path) as f:
        z = json.load(f)
    if as_json:
        print(json.dumps(z, indent=2, default=str))
    else:
        _kvlens_render(z)
    return 0


def _trainlens_selftest() -> int:
    """Deterministic trainlens end to end: hand-computed phase/stall/
    MFU goldens on an injected clock, checkpoint staleness arithmetic,
    the sentinel's NaN latch, gate-off-records-nothing, and the /trainz
    endpoint in both formats."""
    from urllib.request import urlopen

    from dnn_tpu_torch import obs
    from dnn_tpu_torch.obs.trainlens import GradSentinel, TrainClock
    from dnn_tpu_torch.utils.metrics import Metrics

    obs.set_enabled(True)
    t = [100.0]
    reg = Metrics()
    clk = TrainClock(capacity=8, registry=reg, flops_per_step=1e6,
                     tokens_per_step=64, peak_flops=1e9,
                     now=lambda: t[0])
    # 4 steps: data 10 ms, dispatch 2 ms, wait 30 ms, 2 ms tail -> obs
    for _i in range(4):
        rec = clk.begin()
        assert rec is not None
        for phase, dt in (("data", 0.010), ("dispatch", 0.002),
                          ("wait", 0.030)):
            t[0] += dt
            clk.mark(rec, phase)
        t[0] += 0.002
        clk.end(rec)
    s = clk.summary()
    assert s["window_steps"] == 4 and s["steps_total"] == 4, s
    # per step: wall 44 ms, data 10 ms -> stall fraction 10/44
    assert abs(s["data_stall_fraction"] - 10.0 / 44.0) < 1e-3, s
    assert abs(s["window_wall_s"] - 4 * 0.044) < 1e-9, s
    assert s["tokens"] == 4 * 64, s
    # rate window: 4 steps over the 176 ms the ring spans
    sps = 4 / 0.176
    assert abs(s["steps_per_sec"] - sps) < 0.1, s
    # MFU golden: flops_per_step x steps/s / peak, hand-computed
    assert s["mfu"] is not None
    assert abs(s["mfu"] - 1e6 * sps / 1e9) < 1e-4, s["mfu"]
    # checkpoint freshness: a save at now, read 7 s later
    clk.ckpt_saved(4, 0.01, 12345)
    t[0] += 7.0
    assert abs(clk.ckpt_staleness_s() - 7.0) < 1e-9
    s = clk.summary()
    assert s["ckpt"]["last_good_step"] == 4, s["ckpt"]
    ct = clk.chrome_trace()
    xs = [e for e in ct["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == 4 * 3, len(xs)  # 3 marked slices per step
    prom = clk.render_prom()
    assert "dnn_tpu_train_mfu" in prom, prom
    assert 'dnn_tpu_train_phase_frac{phase="data"}' in prom, prom
    snap = reg.snapshot()
    assert 'train.phase_seconds{phase="wait"}' in snap["histogram"], snap

    # sentinel: NaN latches ONCE per episode, recovers, re-fires
    sen = GradSentinel(warmup=1, spike_factor=4.0)
    assert sen.observe(1, 1.0, [1.0, 0.01, 0]) == []
    assert sen.observe(2, float("nan"), [1.0, 0.01, 0]) == ["loss_nan"]
    assert sen.observe(3, float("nan"), [1.0, 0.01, 0]) == []  # latched
    assert sen.observe(4, 0.9, [1.0, 0.01, 0]) == []           # recovers
    assert sen.observe(5, 1.0, [99.0, 0.01, 0]) == ["grad_spike"]

    # gate off records NOTHING
    obs.set_enabled(False)
    try:
        assert clk.begin() is None
        assert sen.observe(6, float("nan")) == []
    finally:
        obs.set_enabled(True)

    # /trainz endpoint, both formats
    srv = obs.serve_metrics(0, trainlens=clk)
    try:
        base = f"http://127.0.0.1:{srv.port}/trainz"
        z = json.loads(urlopen(base, timeout=10).read().decode())
        assert z["steps_total"] == 4, z
        assert set(z["phases"]) == {"data", "dispatch", "wait", "ckpt",
                                    "eval", "obs"}, z["phases"]
        ptext = urlopen(base + "?format=prom",
                        timeout=10).read().decode()
        assert "dnn_tpu_train_data_stall" in ptext
        assert "dnn_tpu_ckpt_staleness_seconds" in ptext
    finally:
        srv.close()
    print("trainlens selftest ok: 4 deterministic steps (data stall "
          f"{10 / 44:.1%}, mfu {1e6 * sps / 1e9:.2%} hand-checked), "
          "ckpt staleness 7.0s, sentinel nan-latch + spike, gate off "
          "silent, /trainz json+prom served")
    return 0


def _trainlens_render(z: dict) -> None:
    print(f"steps: {z.get('steps_total')} total, "
          f"{z.get('window_steps')} in window "
          f"({z.get('window_wall_s', 0) * 1e3:.1f} ms wall, "
          f"{z.get('tokens')} tokens)")
    for p, d in z.get("phases", {}).items():
        print(f"  {p:<9} {d['frac']:7.1%}  {d['mean_ms']:9.3f} ms/step")
    mfu = z.get("mfu")
    print(f"data stall {z.get('data_stall_fraction', 0):.1%} | "
          + (f"mfu {mfu:.2%} | " if mfu is not None
             else "mfu - (no roofline) | ")
          + f"{z.get('steps_per_sec', 0):.2f} steps/s | "
          f"{z.get('tokens_per_sec', 0):.0f} tokens/s | last step "
          f"{z.get('last_wall_ms', 0):.2f} ms")
    ck = z.get("ckpt", {})
    print(f"ckpt: last good step {ck.get('last_good_step')}, "
          f"staleness {ck.get('staleness_s')}s")


def _trainlens_url(url: str, as_json: bool, last=None) -> int:
    from urllib.request import urlopen

    base = url.rstrip("/") + "/trainz"
    q = f"?last={last}" if last else ""
    z = json.loads(urlopen(base + q, timeout=10).read().decode())
    if as_json:
        print(json.dumps(z, indent=2, default=str))
    else:
        _trainlens_render(z)
    return 0


def _trainlens_path(path: str, as_json: bool) -> int:
    with open(path) as f:
        z = json.load(f)
    if as_json:
        print(json.dumps(z, indent=2, default=str))
    else:
        _trainlens_render(z)
    return 0


def _fleet_cmd(args) -> int:
    from dnn_tpu_torch.obs.fleet import FleetCollector, targets_from_config

    if args.targets:
        urls = [u.strip() for u in args.targets.split(",") if u.strip()]
        if args.names:
            names = [n.strip() for n in args.names.split(",")]
            if len(names) != len(urls):
                print("--names must match --targets in count",
                      file=sys.stderr)
                return 2
            targets = dict(zip(names, urls))
        else:
            targets = {f"stage{i}" if len(urls) > 1 else "stage0": u
                       for i, u in enumerate(urls)}
    elif args.config:
        if args.metrics_port is None:
            print("--config needs --metrics_port (the port every node "
                  "passed to --metrics_port)", file=sys.stderr)
            return 2
        targets = targets_from_config(args.config, args.metrics_port)
    else:
        print("fleet needs --targets, --config, or --selftest",
              file=sys.stderr)
        return 2
    fc = FleetCollector(targets, interval_s=args.interval)
    if args.serve is not None:
        from dnn_tpu_torch import obs

        fc.start()
        srv = obs.serve_metrics(args.serve, host=args.host, fleet=fc)
        print(f"fleet collector serving http://{args.host}:{srv.port}"
              f"/fleetz over {len(targets)} stages "
              f"(poll every {args.interval:g}s); Ctrl-C to stop")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            srv.close()
            fc.close()
        return 0
    fc.poll_once()
    print(fc.report(args.trace_id))
    if args.out:
        chrome = fc.stitch(args.trace_id)
        with open(args.out, "w") as f:
            json.dump(chrome, f)
        n = sum(1 for e in chrome["traceEvents"] if e.get("ph") == "X")
        print(f"wrote {args.out}: {n} spans across "
              f"{len(targets)} stages (load in Perfetto)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dnn_tpu_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("trace", help="trace export tooling")
    tr.add_argument("--selftest", action="store_true",
                    help="in-process span-pipeline smoke; exit 0 on pass")
    tr.add_argument("--jsonl", help="input JSONL span dump to convert")
    tr.add_argument("--out", help="output Chrome-trace JSON path")
    tr.add_argument("--id", dest="trace_id", default=None,
                    help="restrict conversion to one trace id")
    fl = sub.add_parser("flight", help="flight-recorder tooling")
    fl.add_argument("--selftest", action="store_true",
                    help="in-process flight-ring smoke; exit 0 on pass")
    fl.add_argument("--url", help="obs endpoint base URL to fetch "
                                  "/debugz from (http://host:port)")
    fl.add_argument("--out", help="write the JSONL here instead of stdout")
    fl.add_argument("--kind", default=None, help="filter by event kind")
    fl.add_argument("--trace", default=None, help="filter by trace id")
    fl.add_argument("--last", default=None, type=int,
                    help="keep only the newest N events")
    fz = sub.add_parser("fleet", help="cluster-wide aggregation + "
                        "cross-host trace stitching (obs/fleet.py)")
    fz.add_argument("--selftest", action="store_true",
                    help="in-process fleet smoke (two endpoints, "
                         "injected skew); exit 0 on pass")
    fz.add_argument("--targets", default=None,
                    help="comma-separated obs endpoint base URLs "
                         "(http://host:port), one per stage")
    fz.add_argument("--names", default=None,
                    help="comma-separated stage names matching --targets")
    fz.add_argument("--config", default=None,
                    help="pipeline config JSON — stages derive from its "
                         "nodes' hosts + --metrics_port")
    fz.add_argument("--metrics_port", type=int, default=None,
                    help="with --config: the obs port every node serves")
    fz.add_argument("--interval", type=float, default=5.0,
                    help="--serve poll period in seconds")
    fz.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="run the long-lived collector and serve "
                         "/fleetz on this port (0 = ephemeral)")
    fz.add_argument("--host", default="127.0.0.1",
                    help="--serve bind host (default loopback; "
                         "0.0.0.0 exposes to the network)")
    fz.add_argument("--out", default=None,
                    help="write the stitched cross-host Perfetto JSON "
                         "here (one-shot mode)")
    fz.add_argument("--id", dest="trace_id", default=None,
                    help="restrict the report/stitch to one trace id")
    inc = sub.add_parser("incident", help="render an SLO-breach "
                         "incident bundle (obs/slo.py) as an event-by-"
                         "event timeline")
    inc.add_argument("path", help="bundle directory (manifest.json + "
                                  "flight.jsonl [+ stepz/fleetz.json])")
    inc.add_argument("--json", action="store_true",
                     help="print the raw loaded bundle instead of the "
                          "rendered timeline")
    tl = sub.add_parser("timeline", help="step-timeline attribution: "
                        "/stepz fetch + device-capture analysis "
                        "(obs/timeline.py)")
    tl.add_argument("path", nargs="?", default=None,
                    help="capture dir (POST /profilez result) or "
                         "*.trace.json[.gz] file to analyze")
    tl.add_argument("--selftest", action="store_true",
                    help="in-process smoke (deterministic clock + "
                         "synthetic capture); exit 0 on pass")
    tl.add_argument("--url", default=None,
                    help="obs endpoint base URL to fetch /stepz from")
    tl.add_argument("--out", default=None,
                    help="with --url: write the step host track "
                         "(?format=trace Perfetto JSON) here")
    tl.add_argument("--last", type=int, default=None,
                    help="bound the /stepz window to the newest N steps")
    tl.add_argument("--json", action="store_true",
                    help="print the raw analysis dict instead of the "
                         "report")
    tl.add_argument("--top", type=int, default=10,
                    help="top-K device ops to report (default 10)")
    kv = sub.add_parser("kvlens", help="memory-economy observatory: "
                        "/kvz fetch — miss-ratio curve, thrash bill, "
                        "block forensics (obs/kvlens.py)")
    kv.add_argument("path", nargs="?", default=None,
                    help="saved /kvz JSON dump to render")
    kv.add_argument("--selftest", action="store_true",
                    help="in-process smoke (MRC goldens, sampling "
                         "determinism, thrash arithmetic, /kvz); "
                         "exit 0 on pass")
    kv.add_argument("--url", default=None,
                    help="obs endpoint base URL to fetch /kvz from")
    kv.add_argument("--json", action="store_true",
                    help="print the raw /kvz dict instead of the table")
    tn = sub.add_parser("trainlens", help="training-step observatory: "
                        "/trainz fetch — phase decomposition, MFU, "
                        "data-stall, ckpt freshness (obs/trainlens.py)")
    tn.add_argument("path", nargs="?", default=None,
                    help="saved /trainz JSON dump to render")
    tn.add_argument("--selftest", action="store_true",
                    help="in-process smoke (phase/stall/MFU goldens, "
                         "sentinel latch, /trainz); exit 0 on pass")
    tn.add_argument("--url", default=None,
                    help="obs endpoint base URL to fetch /trainz from")
    tn.add_argument("--json", action="store_true",
                    help="print the raw /trainz dict instead of the "
                         "table")
    tn.add_argument("--last", type=int, default=None,
                    help="bound the /trainz window to the newest N "
                         "steps")
    cp = sub.add_parser("caplens", help="capacity observatory: not "
                        "ported (ROADMAP Queue 1 item 11)")
    cp.add_argument("path", nargs="?", default=None)
    cp.add_argument("--selftest", action="store_true")
    cp.add_argument("--url", default=None)
    cp.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.cmd == "trace":
        if args.selftest:
            return _selftest()
        if args.jsonl and args.out:
            return _convert(args.jsonl, args.out, args.trace_id)
        ap.error("trace needs --selftest or --jsonl FILE --out FILE")
    if args.cmd == "flight":
        if args.selftest:
            return _flight_selftest()
        if args.url:
            return _flight_fetch(args.url, args.out, args.kind,
                                 args.trace, args.last)
        ap.error("flight needs --selftest or --url URL")
    if args.cmd == "fleet":
        if args.selftest:
            return _fleet_selftest()
        return _fleet_cmd(args)
    if args.cmd == "incident":
        from dnn_tpu_torch.obs.slo import load_incident, render_incident

        bundle = load_incident(args.path)
        if args.json:
            print(json.dumps(bundle, indent=2, default=str))
        else:
            print(render_incident(bundle))
        return 0
    if args.cmd == "timeline":
        if args.selftest:
            return _timeline_selftest()
        if args.url:
            return _timeline_url(args.url, args.out, args.last)
        if args.path:
            return _timeline_path(args.path, args.json, args.top)
        ap.error("timeline needs --selftest, --url URL, or a capture "
                 "PATH")
    if args.cmd == "kvlens":
        if args.selftest:
            return _kvlens_selftest()
        if args.url:
            return _kvlens_url(args.url, args.json)
        if args.path:
            return _kvlens_path(args.path, args.json)
        ap.error("kvlens needs --selftest, --url URL, or a saved /kvz "
                 "JSON PATH")
    if args.cmd == "trainlens":
        if args.selftest:
            return _trainlens_selftest()
        if args.url:
            return _trainlens_url(args.url, args.json, args.last)
        if args.path:
            return _trainlens_path(args.path, args.json)
        ap.error("trainlens needs --selftest, --url URL, or a saved "
                 "/trainz JSON PATH")
    if args.cmd == "caplens":
        print("caplens: the capacity observatory (/capz, obs/caplens.py) "
              "is not ported to dnn_tpu_torch yet (ROADMAP Queue 1 item "
              "11: its producer is the router)", file=sys.stderr)
        return 2
    return 2


if __name__ == "__main__":
    sys.exit(main())
