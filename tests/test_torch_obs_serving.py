"""ROADMAP Queue 1 item 12's serving half in the port, on the CPU, against
the JAX package: request spans and the wire tag (obs/trace.py), the
step clock (obs/timeline.py) on hand-driven records with an injected
clock, goodput and the cost model (obs/goodput.py, utils/flops.py), the
Throughput window, the capture counters (obs/compile_watch.py), JSON
logging, and a CPU daemon answering /trace, /trace.jsonl, /traces and
/stepz with a JAX client's tr= trace continued.

Tolerance: the JAX modules' arithmetic is copied, so every number is
compared exactly (==), save the span timestamps, which are each
process's own clock."""

import io
import json
import logging
import os
import pathlib
import socket
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu import obs as jobs
from dnn_tpu.comm.client import NodeClient as JaxClient
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama as jllama
from dnn_tpu.obs import goodput as jgp
from dnn_tpu.obs import timeline as jtl
from dnn_tpu.obs import trace as jtr
from dnn_tpu.utils import flops as jflops
from dnn_tpu.utils import metrics as jmetrics
from dnn_tpu_torch import obs as tobs
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.models import llama_moe as tmoe
from dnn_tpu_torch.obs import compile_watch as tcw
from dnn_tpu_torch.obs import goodput as tgp
from dnn_tpu_torch.obs import timeline as ttl
from dnn_tpu_torch.obs import trace as ttr
from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
from dnn_tpu_torch.utils import flops as tflops
from dnn_tpu_torch.utils import metrics as tmetrics

from test_torch_llama import one_torch_thread  # noqa: F401 — autouse

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


# ----------------------------------------------------------------------
# spans and the wire tag
# ----------------------------------------------------------------------

@pytest.mark.parametrize("rid", ["gen:8", "gen:8:tr=abc.def", "tr=00ff",
                                 "gen:4:7:dl=1.5:tr=1234abcd.5678:d=k", ""])
def test_wire_tag_helpers_match_jax(rid):
    """parse_wire_tag / strip_wire_tag / tag_request_id give JAX's
    strings on the same request ids and spans."""
    assert ttr.parse_wire_tag(rid) == jtr.parse_wire_tag(rid)
    assert ttr.strip_wire_tag(rid) == jtr.strip_wire_tag(rid)
    sp = types.SimpleNamespace(trace_id="0123456789abcdef", span_id="89abcdef")
    assert ttr.tag_request_id(rid, sp) == jtr.tag_request_id(rid, sp)
    assert ttr.tag_request_id(rid, ttr.NULL_SPAN) == rid


def test_span_tree_and_chrome_export_match_jax():
    """The same tree built through each package's producers (a root
    continued from a wire tag, explicit children, a recorded interval,
    the ambient `span`) has the same names, parent links and attrs; the
    Chrome export of the same span dicts is JAX's, event for event."""
    trees = {}
    for lib in (jtr, ttr):
        lib.collector().clear()
        root = lib.continue_or_start("lm.request", "gen:4:tr=feedf00d.1234",
                                     method="SendTensor")
        adm = root.child("admit", slot=0)
        pf = adm.child("prefill", prompt_len=5)
        pf.end(chunks=1)
        adm.end()
        lib.record_span("queue_wait", time.perf_counter() - 0.01, 0.01,
                        parent=root)
        with lib.span("outer") as o:
            with lib.span("inner"):
                pass
        root.end(tokens=4)
        spans = lib.collector().spans()
        ids = {s.span_id: s.name for s in spans}
        trees[lib] = sorted((s.trace_id if s.trace_id == "feedf00d" else "-",
                             s.name, ids.get(s.parent_id, s.parent_id),
                             json.dumps(s.attrs, sort_keys=True))
                            for s in spans)
        assert lib.collector().trace_ids()[0] == "feedf00d"
        assert o.parent_id is None
    assert trees[ttr] == trees[jtr]
    dicts = [s.to_dict() for s in ttr.collector().spans()]
    assert ttr.spans_to_chrome(dicts) == jtr.spans_to_chrome(dicts)
    assert ttr.collector().jsonl("feedf00d").count("\n") == 4


def test_spans_are_free_with_obs_off():
    tobs.set_enabled(False)
    try:
        assert ttr.start_span("x") is ttr.NULL_SPAN
        assert ttr.continue_or_start("x", "tr=ab.cd") is ttr.NULL_SPAN
        assert not ttr.NULL_SPAN.child("y")
    finally:
        tobs.set_enabled(True)


# ----------------------------------------------------------------------
# the step clock
# ----------------------------------------------------------------------

def _drive(lib, clock_t):
    """Hand-driven records on an injected clock: 40 steps (past one
    flush), admits between some, an overlap depth, mixed steps."""
    clock = lib.StepClock(capacity=32, registry=(
        jmetrics.Metrics() if lib is jtl else tmetrics.Metrics()),
        now=lambda: clock_t[0])
    for i in range(40):
        if i % 7 == 0:
            t_sub = clock_t[0]
            clock_t[0] += 0.0005
            clock.note_admit(t_sub)
        rec = clock.begin()
        for k, phase in enumerate(lib.PHASES[1:]):
            clock_t[0] += 1e-4 * (k + 1) * (1 + i % 3)
            clock.mark(rec, phase)
        rec.mixed = i % 5 == 0
        clock_t[0] += 1e-6
        clock.end(rec, n_adv=2 + i % 2)
    clock.overlap_depth = 1
    clock.constrained_slots = 2
    return clock


def test_step_clock_matches_jax_on_the_same_records():
    """summary (every phase's total, fraction and mean, the derived
    series), the ?format=prom text, the Perfetto host track, records and
    the registry's step histograms equal JAX's clock driven the same
    way; the phases cover the wall exactly."""
    tj, tt = [100.0], [100.0]
    cj, ct = _drive(jtl, tj), _drive(ttl, tt)
    assert ct.summary() == cj.summary()
    assert ct.summary(last=5) == cj.summary(last=5)
    assert ct.render_prom() == cj.render_prom()
    assert ct.chrome_trace() == cj.chrome_trace()
    assert ct.records() == cj.records()
    assert tmetrics.render_prometheus(ct._registry) == \
        jmetrics.render_prometheus(cj._registry)
    s = ct.summary()
    covered = sum(p["s"] for p in s["phases"].values())
    assert abs(covered - s["window_wall_s"]) < 1e-5
    assert s["mixed_steps"] > 0 and s["overlap_depth"] == 1
    assert ct.status_component()["steps_total"] == 40


# ----------------------------------------------------------------------
# goodput, the cost model and the card's peaks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt2", "gpt2-test", "llama3-8b",
                                  "llama-test"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "int4"])
def test_model_cost_matches_jax(name, kv):
    """model_cost's FLOPs (decode at 3 contexts, prefill at 2 lengths),
    analytic weight bytes and KV bytes a position (int4 at half a byte
    plus the f32 scale rows) equal JAX's for the same config and KV
    type."""
    jcfg = (jgpt.PRESETS if name.startswith("gpt") else jllama.PRESETS)[name]
    tcfg = (tgpt.PRESETS if name.startswith("gpt") else tllama.PRESETS)[name]
    jkv = {"f32": jnp.float32, "bf16": jnp.bfloat16}.get(kv, kv)
    tkv = {"f32": torch.float32, "bf16": torch.bfloat16}.get(kv, kv)
    jc, tc = jgp.model_cost(jcfg, kv_dtype=jkv), tgp.model_cost(tcfg,
                                                               kv_dtype=tkv)
    assert tc.weight_bytes == jc.weight_bytes
    assert tc.kv_bytes_per_pos == jc.kv_bytes_per_pos
    assert tc.step_bytes(4) == jc.weight_bytes
    for ctx in (1, 37.5, 900):
        assert tc.flops_per_token(ctx) == jc.flops_per_token(ctx)
    for n in (1, 64):
        assert tc.prefill_flops(n) == jc.prefill_flops(n)
    assert tflops.kv_bytes_per_pos(tcfg, kv_dtype=tkv) == \
        jflops.kv_bytes_per_pos(jcfg, kv_dtype=jkv)
    assert tflops.decode_step_bytes(1e9, 300, tcfg) == \
        jflops.decode_step_bytes(1e9, 300, jcfg)


@pytest.mark.parametrize("name", ["mixtral-test", "qwen2moe-test",
                                  "gpt2-moe-test"])
def test_moe_model_cost_prices_the_experts_a_step_reads(name):
    """A MoE config: KV bytes as JAX prices the same attention; a token's
    FLOPs are those of its dense-equivalent config (top_k experts, the
    shared expert) in JAX's formula plus the router's; a step's weight
    bytes rise with its tokens until all E experts are read, and the
    analytic total equals the drawn tree's parameter count (less the
    attention biases, which JAX's count leaves out)."""
    import dataclasses

    from dnn_tpu_torch.models import gpt_moe as tgm

    if name == "gpt2-moe-test":
        from dnn_tpu.models import gpt_moe as jgm

        tcfg, jcfg = tgm.PRESETS[name], jgm.PRESETS[name]
        tree = tgm.init(0, tcfg)
        e, k = tcfg.n_experts, tcfg.top_k
    else:
        from dnn_tpu.models import llama_moe as jlm

        tcfg, jcfg = tmoe.PRESETS[name], jlm.PRESETS[name]
        tree = tmoe.init(0, tcfg)
        e, k = tcfg.n_expert, tcfg.router_top_k
        dense = dataclasses.replace(
            jcfg, d_ff=k * jcfg.d_ff + (jcfg.d_shared or 0))
        c = tcfg.n_embd
        router = tcfg.n_layer * 2.0 * c * (e + bool(tcfg.d_shared))
        assert tgp.model_cost(tcfg).flops_per_token(50) == \
            jflops.llama_decode_token_flops(dense, 50) + router
    cost = tgp.model_cost(tcfg, weight_dtype_bytes=4)
    n_params = sum(np.asarray(a).size for a in jax.tree.leaves(tree))
    if getattr(tcfg, "attn_bias", False):
        # the q/k/v biases, which JAX's llama_param_count leaves out too
        n_params -= tcfg.n_layer * (tcfg.n_head + 2 * tcfg.n_kv_head) * \
            tcfg.head_dim
    assert cost.weight_bytes == 4 * n_params
    assert cost.kv_bytes_per_pos == jflops.kv_bytes_per_pos(jcfg)
    steps = [cost.step_bytes(n) for n in (1, 2, e)]
    assert steps[0] < steps[1] <= steps[2] == cost.weight_bytes
    assert cost.step_bytes(10 * e) == cost.weight_bytes


def test_goodput_tracker_matches_jax():
    """The same feed (prefills, decode steps past a flush, TTFTs, inter-
    token samples, outcomes) on an injected clock: MFU, MBU, goodput
    tokens/sec and every burn rate equal JAX's, and the gauges render
    the same Prometheus text."""
    t = [1000.0]
    slo_kw = dict(ttft_s=0.05, inter_token_s=0.01, availability=0.99,
                  target=0.9)
    out = {}
    for lib, cfg, reg in ((jgp, CFG_J, jmetrics.Metrics()),
                          (tgp, CFG_T, tmetrics.Metrics())):
        t[0] = 1000.0
        tr = lib.GoodputTracker(lib.model_cost(cfg, kv_dtype="int4"),
                                peak_flops=1e12, peak_bytes=1e11,
                                slo=lib.SLOConfig(**slo_kw),
                                now=lambda: t[0]).install(reg)
        for i in range(40):
            t[0] += 0.01
            if i % 9 == 0:
                tr.on_prefill(17 + i)
                tr.on_ttft(0.02 * (i % 4))
            tr.on_decode_step(3, 120.0 + i)
            tr.on_inter_token([0.004, 0.015 if i % 6 == 0 else 0.008])
            tr.on_outcome(i % 13 != 0)
        out[lib] = (tr.mfu(), tr.mbu(), tr.tokens_per_sec(),
                    tr.burn_rates(),
                    (jmetrics if lib is jgp else tmetrics)
                    .render_prometheus(reg))
    assert out[tgp] == out[jgp]
    assert 0 < out[tgp][0] and 0 < out[tgp][1]


def test_card_peaks_are_unknown_on_the_cpu(monkeypatch):
    """No card here: both peaks (and the roofline, MFU and MBU) are None,
    and the tracker's gauges read 0; an operator-stated peak wins; a
    malformed or non-positive one reads as unset."""
    monkeypatch.delenv("DNN_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("DNN_TPU_PEAK_HBM_BW", raising=False)
    assert tflops.device_peak_flops() is None
    assert tflops.device_peak_hbm_bw() is None
    assert tflops.device_peak_flops("cpu") is None
    assert tflops.roofline_items_per_sec(1.0, 1.0) is None
    assert tflops.mfu(1.0, 1.0) is None and tflops.mbu(1.0, 1.0) is None
    tr = tgp.GoodputTracker(tgp.model_cost(CFG_T))
    tr.on_decode_step(2, 10.0)
    assert tr.mfu() == 0.0 and tr.mbu() == 0.0
    monkeypatch.setenv("DNN_TPU_PEAK_FLOPS", "2e12")
    monkeypatch.setenv("DNN_TPU_PEAK_HBM_BW", "junk")
    assert tflops.device_peak_flops() == 2e12
    assert tflops.device_peak_hbm_bw() is None
    monkeypatch.setenv("DNN_TPU_PEAK_HBM_BW", "0")
    assert tflops.device_peak_hbm_bw() is None
    assert tflops._CUDA_PEAKS[0] == ("H100 80GB HBM3", 989e12, 3.35e12)


def test_throughput_window_matches_jax():
    t = [50.0]
    out = []
    for lib in (jmetrics, tmetrics):
        t[0] = 50.0
        w = lib.Throughput(window_s=10.0, now=lambda: t[0])
        rates = []
        for i in range(30):
            t[0] += 0.7
            w.add(i % 4)
            rates.append(w.per_sec)
        rates.append(w.per_sec_with(5, t[0] - 1.0))
        t[0] += 100.0
        rates.append(w.per_sec)
        out.append(rates)
    assert out[0] == out[1] and out[1][-1] == 0.0


def test_capture_and_build_counters():
    """note_capture / note_build land JAX-family counters and flight
    events; a batcher's stand-in capture counts under its graph's name
    (a constrained pool's decode graph as "constrained")."""
    from dnn_tpu_torch.runtime.serving import CapturedDecode
    from dnn_tpu_torch.utils.metrics import default_metrics, labeled

    def key(graph):
        return labeled("cuda_graph_captures_total", graph=graph)

    before = {g: default_metrics.snapshot()["counters"].get(key(g), 0)
              for g in ("decode", "constrained")}
    tcw.note_build("decode_attention", 3.5)
    snap = default_metrics.snapshot()["counters"]
    assert snap[labeled("cuda_kernel_builds_total",
                        kernel="decode_attention")] >= 1

    def stand_in(fn):
        return object(), fn(), types.SimpleNamespace(replayed=lambda: None)

    for names, graph in ((None, "decode"),
                         ({"decode": "constrained"}, "constrained")):
        g = CapturedDecode(2, "cpu", capture=stand_in, names=names)
        g(lambda *a: torch.zeros(2, 3), {}, g.tok, g.pos, g.active)
        assert g.captures == 1
        assert default_metrics.snapshot()["counters"][key(graph)] == \
            before[graph] + 1
    assert tobs.flight.recorder().events(kind="capture")


def test_json_logging_carries_the_trace_id():
    from dnn_tpu_torch.utils.logging import JSONFormatter, setup_logging

    buf = io.StringIO()
    root = setup_logging("INFO", node_id="n1", stream=buf, fmt="json")
    try:
        with ttr.span("work") as sp:
            logging.getLogger("dnn_tpu_torch.test").info("hello %d", 3)
        line = json.loads(buf.getvalue().splitlines()[-1])
        assert line["msg"] == "hello 3" and line["node_id"] == "n1"
        assert line["trace_id"] == sp.trace_id
        assert isinstance(root.handlers[0].formatter, JSONFormatter)
    finally:
        root.handlers.clear()


# ----------------------------------------------------------------------
# the daemon
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def daemon():
    """gpt2-test served on the CPU with obs on, an endpoint and SLOs;
    yields (gRPC address, endpoint base URL, the LMServer)."""
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(1), CFG_J))
    port = _free_port()
    thread, stop = start_lm_server_in_background(
        CFG_T, from_jax_params(tree, CFG_T, "cpu"), port=port,
        device="cpu", slots=2, max_len=64, prompt_pad=16, block_len=8,
        kv_dtype="int4", metrics_port=0,
        slo=tgp.SLOConfig(ttft_s=0.5, inter_token_s=0.2))
    srv = stop.servicer
    try:
        yield (f"127.0.0.1:{port}",
               f"http://127.0.0.1:{srv.metrics_server.port}", srv)
    finally:
        stop()
        assert not thread.is_alive()


def test_daemon_continues_a_jax_clients_trace(daemon):
    """A JAX NodeClient inside its own span tags the request (tr=); the
    port's daemon continues that trace: /trace?id= holds lm.request as
    a child of the client's rpc span, and queue_wait, admit, prefill,
    prefill_chunk (one a 16-token chunk) and decode under it;
    /trace.jsonl and /traces agree."""
    addr, base, _ = daemon
    prompt = np.arange(3, 40, dtype=np.int32)  # 37 tokens: 3 chunks
    client = JaxClient(addr)
    try:
        with jobs.span("client") as csp:
            toks = client.generate(prompt, max_new_tokens=6)
    finally:
        client.close()
    assert len(toks) == 6
    rpc = [s for s in jtr.collector().spans(csp.trace_id)
           if s.name == "rpc.SendTensor"][-1]
    code, body = _get(f"{base}/trace?id={csp.trace_id}")
    ev = [e for e in json.loads(body)["traceEvents"] if e["ph"] == "X"]
    names = [e["name"] for e in ev]
    by_id = {e["args"]["span_id"]: e for e in ev}
    req = next(e for e in ev if e["name"] == "lm.request")
    assert req["args"]["parent_id"] == rpc.span_id
    assert req["args"]["trace_id"] == csp.trace_id
    for name in ("queue_wait", "admit", "decode"):
        assert by_id[next(e for e in ev if e["name"] == name)["args"][
            "parent_id"]]["name"] == "lm.request", name
    pf = next(e for e in ev if e["name"] == "prefill")
    assert by_id[pf["args"]["parent_id"]]["name"] == "admit"
    assert names.count("prefill_chunk") == 3
    code, jl = _get(f"{base}/trace.jsonl?id={csp.trace_id}")
    assert len(jl.splitlines()) == len(ev)
    code, ids = _get(f"{base}/traces")
    assert csp.trace_id in json.loads(ids)


def test_daemon_stepz_and_goodput_gauges(daemon):
    """After traffic, /stepz's phases cover its window's wall, its prom
    and trace forms answer, and /metrics carries the batcher's gauges,
    the inter-token summary, the step histograms, the goodput gauges
    (MFU/MBU 0: no peak on the CPU) and both SLO burn rates; an int4
    pool's kv_cache_bytes is the packed pool's."""
    addr, base, srv = daemon
    client = JaxClient(addr)
    try:
        for i in range(3):
            client.generate(np.arange(5 + i, dtype=np.int32) + 1,
                            max_new_tokens=8)
    finally:
        client.close()
    code, body = _get(f"{base}/stepz")
    s = json.loads(body)
    assert code == 200 and s["steps_total"] >= 7
    covered = sum(p["s"] for p in s["phases"].values())
    assert covered == pytest.approx(s["window_wall_s"], abs=1e-4)
    code, prom = _get(f"{base}/stepz?format=prom")
    assert "dnn_tpu_step_host_fraction" in prom
    code, tr = _get(f"{base}/stepz?format=trace&last=2")
    assert json.loads(tr)["traceEvents"]
    code, m = _get(f"{base}/metrics")
    for name in ("serving_tokens_per_sec", "serving_batch_occupancy",
                 "serving_kv_cache_bytes", "serving_kv_slot_utilization",
                 "serving_kv_live_positions_high_water",
                 "serving_active_slots_high_water",
                 "serving_inter_token_seconds", "serving_decode_steps_total",
                 "step_wall_seconds", "dnn_tpu_mfu", "dnn_tpu_mbu",
                 "dnn_tpu_goodput_tokens_per_sec",
                 'dnn_tpu_slo_burn_rate{slo="ttft"}',
                 'dnn_tpu_slo_burn_rate{slo="inter_token"}'):
        assert name in m, name
    pool = srv.batcher.cache
    assert pool["k"].dtype == torch.uint8
    assert srv.batcher._kv_bytes_read() == sum(
        t.numel() * t.element_size() for t in pool.values())
    assert srv.goodput.cost.kv_bytes_per_pos == tflops.kv_bytes_per_pos(
        CFG_T, kv_dtype="int4")
    code, st = _get(f"{base}/statusz")
    assert "step" in json.loads(st)["components"]


def test_node_serve_lm_int4_with_an_slo_as_a_process(tmp_path):
    """`node --serve_lm --kv_dtype int4 --slo_ttft_ms 500 --metrics_port`
    as a process: it serves, its /metrics carries the TTFT burn rate
    and its /stepz steps, and it drains on SIGTERM (exit 0). --slo_target
    without an objective, and an --slo_* flag without --serve_lm, exit
    1."""
    import signal

    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.node import main

    port, mport = _free_port(), _free_port()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0, "address": f"127.0.0.1:{port}"}]}))
    assert main(["--node_id", "node1", "--config", str(cfg), "--serve_lm",
                 "--slo_target", "0.9"]) == 1
    assert main(["--node_id", "node1", "--config", str(cfg),
                 "--slo_ttft_ms", "500"]) == 1
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", str(cfg), "--serve_lm", "--device", "cpu",
         "--kv_dtype", "int4", "--slo_ttft_ms", "500", "--metrics_port",
         str(mport), "--slots", "2", "--max_len", "64", "--prompt_pad",
         "16"], cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=90)
        toks = client.generate(np.arange(1, 9, dtype=np.int32),
                               max_new_tokens=5)
        client.close()
        assert len(toks) == 5
        _, m = _get(f"http://127.0.0.1:{mport}/metrics")
        assert 'dnn_tpu_slo_burn_rate{slo="ttft"}' in m
        _, s = _get(f"http://127.0.0.1:{mport}/stepz")
        assert json.loads(s)["steps_total"] >= 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
