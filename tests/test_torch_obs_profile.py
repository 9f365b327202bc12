"""The port's device-capture layer on the CPU: obs/profile.py's spool
(torch.profiler captures, meta.json with JAX's keys, the bound, the one
session a process: ProfilerBusy) and obs/timeline.analyze /
render_report against the JAX package's on the same synthetic JAX trace
(floats within 1e-9, the same report text), against hand-computed
numbers on a synthetic Kineto trace, and on a real CPU capture (zero
device ops); then /profilez on a CPU LM daemon beside JAX's endpoint:
the same codes and JSON keys for arming, disarming, a bad `ms` and a
timed capture, and the auto trigger capturing a decode step."""

import gzip
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dnn_tpu import obs as jobs
from dnn_tpu.obs import http as jhttp
from dnn_tpu.obs import profile as jprof
from dnn_tpu.obs import timeline as jtl
from dnn_tpu_torch import obs as tobs
from dnn_tpu_torch.obs import profile as tprof
from dnn_tpu_torch.obs import timeline as ttl
from dnn_tpu_torch.utils import tracing as ttracing

from test_torch_llama import one_torch_thread  # noqa: F401 — autouse

#: JAX's sidecar meta keys (dnn_tpu/obs/profile.py:_traced)
META_KEYS = {"perf_begin", "t_begin_unix", "step_begin", "backend",
             "perf_end", "t_end_unix", "step_end"}


@pytest.fixture(autouse=True)
def _obs_on():
    was = (jobs.enabled(), tobs.enabled())
    jobs.set_enabled(True)
    tobs.set_enabled(True)
    yield
    jobs.set_enabled(was[0])
    tobs.set_enabled(was[1])


def _approx_equal(a, b, tol=1e-9):
    """Nested dicts/lists equal, floats within `tol` absolute."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            _approx_equal(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _approx_equal(x, y, tol)
    elif isinstance(a, float):
        assert abs(a - b) <= tol, (a, b)
    else:
        assert a == b, (a, b)


# ----------------------------------------------------------------------
# the spool
# ----------------------------------------------------------------------

def test_capture_spool_meta_and_bound(tmp_path):
    """Three timed captures into a spool kept at 2: two dirs remain,
    each with a Chrome trace and a meta.json of JAX's keys (backend
    "cpu"); the trace opens with the start marker, which analyze
    anchors at; a CPU capture has no device ops and analyzes cleanly."""
    root = str(tmp_path / "spool")
    paths = [tprof.capture(15, capture_root=root, keep=2)
             for _ in range(3)]
    left = tprof.list_captures(root)
    assert left == sorted(paths[1:]) and len(left) == 2
    for p in left:
        (tf,) = tprof.trace_files(p)
        assert tf.endswith(".pt.trace.json")
        meta = ttl.find_meta(p)
        assert set(meta) == META_KEYS and meta["backend"] == "cpu"
        assert meta["perf_end"] - meta["perf_begin"] >= 0.015
        with open(tf) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert tprof.START_MARKER in names
        a = ttl.analyze(p)
        assert a["device"]["ops"] == 0 and a["top_ops"] == []
        assert a["window_s"] == pytest.approx(
            meta["perf_end"] - meta["perf_begin"], abs=1e-6)
        assert ttl.find_trace_file(p) == tf
        assert "capture:" in ttl.render_report(a)


def test_capture_step_and_machinery_failure(tmp_path):
    """capture_step runs the function once inside a capture and returns
    its result; annotation_ctx ranges land only while a capture records;
    a spool that cannot be made raises CaptureFailed (the function never
    ran), never a silent (None, result)."""
    root = str(tmp_path / "spool")
    calls = []

    def fn():
        calls.append(tprof.capturing())
        with tprof.annotation_ctx("serving.decode_step"):
            torch.ones(8).sum()
        return 41

    path, out = tprof.capture_step(fn, capture_root=root)
    assert out == 41 and calls == [True]
    with open(tprof.trace_files(path)[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "serving.decode_step" in names
    assert tprof.annotation_ctx("x") is tprof.annotation_ctx("y")  # off
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(tprof.CaptureFailed) as e:
        tprof.capture_step(fn, capture_root=str(blocker / "spool"))
    assert not e.value.ran and len(calls) == 1
    with pytest.raises(ZeroDivisionError):  # the function's own error
        tprof.capture_step(lambda: 1 / 0, capture_root=root)


def test_one_session_a_process(tmp_path):
    """While a capture records, another capture, trace_to and
    exclusive() raise ProfilerBusy; a torch.profiler session started
    elsewhere makes a capture raise ProfilerBusy too (a second session
    would take the first one over)."""
    root = str(tmp_path / "spool")
    t = threading.Thread(target=tprof.capture, args=(400,),
                         kwargs={"capture_root": root})
    t.start()
    time.sleep(0.15)
    try:
        with pytest.raises(tprof.ProfilerBusy):
            tprof.capture(10, capture_root=root)
        with pytest.raises(tprof.ProfilerBusy):
            with ttracing.trace_to(str(tmp_path / "tt")):
                pass
    finally:
        t.join()
    assert len(tprof.list_captures(root)) == 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(tprof.ProfilerBusy, match="elsewhere"):
            tprof.capture(10, capture_root=root)
    with ttracing.trace_to(str(tmp_path / "tt")):
        with ttracing.span("annotated"):
            pass
    with open(tmp_path / "tt" / "trace.json") as f:
        assert "annotated" in {e.get("name")
                               for e in json.load(f)["traceEvents"]}


class _Target:
    auto_profile = None


def test_profiler_status_and_arm_equal_jax(tmp_path):
    """Profiler.status() has JAX's keys and values through arm and
    disarm; arming without a step loop raises ValueError in both."""
    tt, jt = _Target(), _Target()
    tp = tprof.Profiler(capture_root=str(tmp_path / "t"), arm_target=tt)
    jp = jprof.Profiler(capture_root=str(tmp_path / "j"), arm_target=jt)
    assert tp.status() == jp.status()
    for p in (tp, jp):
        p.arm_auto(25.0, 40.0)
    assert tp.status() == jp.status()
    assert tt.auto_profile == {**jt.auto_profile,
                               "capture_root": tp.capture_root}
    for p in (tp, jp):
        p.disarm()
    assert tp.status() == jp.status() == {"captures": [], "armed": None}
    for lib in (tprof, jprof):
        with pytest.raises(ValueError, match="no step loop"):
            lib.Profiler(capture_root=str(tmp_path)).arm_auto(1.0)


# ----------------------------------------------------------------------
# analyze / render_report
# ----------------------------------------------------------------------

def _jax_trace(d, *, meta=None, gz=True, n_steps=3):
    """A JAX-format capture: one 6 ms hlo op a 10 ms step on the CPU
    backend's execution thread, a /device: process with a kernel and a
    zero-width marker, a host python span, jax.profiler's start_trace
    span (the anchor) and metadata."""
    events = [
        {"ph": "M", "pid": 7, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 7, "tid": 2, "name": "thread_name",
         "args": {"name": "tf_XLATfrtCpuClient"}},
        {"ph": "M", "pid": 7, "tid": 1, "name": "thread_name",
         "args": {"name": "python"}},
        {"ph": "X", "pid": 7, "tid": 1, "name": "start_trace",
         "ts": 0.0, "dur": 1000.0},
    ]
    for i in range(n_steps):
        events.append({"ph": "X", "pid": 7, "tid": 2, "name": "fusion.1",
                       "ts": 1500.0 + 10000.0 * i, "dur": 6000.0,
                       "args": {"hlo_op": "fusion.1"}})
        events.append({"ph": "X", "pid": 9, "tid": 3, "name": "gemm",
                       "ts": 8000.0 + 10000.0 * i, "dur": 1500.0})
    events.append({"ph": "X", "pid": 9, "tid": 3, "name": "marker",
                   "ts": 9000.0, "dur": 0.0})
    events.append({"ph": "X", "pid": 7, "tid": 1, "name": "step()",
                   "ts": 1000.0, "dur": n_steps * 10000.0})
    doc = {"traceEvents": events}
    p = os.path.join(d, "vm.trace.json.gz" if gz else "vm.trace.json")
    with (gzip.open(p, "wt") if gz else open(p, "w")) as f:
        json.dump(doc, f)
    if meta is not None:
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)
    return p


def _drive(lib, t0):
    """Three 10 ms steps through a StepClock of either package on an
    injected clock, the first entering at `t0`."""
    t = [t0]
    clk = lib.StepClock(capacity=16, now=lambda: t[0])
    for _ in range(3):
        rec = clk.begin()
        for phase, dt in (("host", 0.001), ("dispatch", 0.002),
                          ("wait", 0.005), ("commit", 0.002)):
            t[0] += dt
            clk.mark(rec, phase)
        clk.end(rec, 1)
    return clk


@pytest.mark.parametrize("with_meta,gz", [(False, True), (True, True),
                                          (True, False)])
def test_analyze_jax_trace_equals_jax(tmp_path, with_meta, gz):
    meta = ({"perf_begin": 100.0, "perf_end": 100.031, "step_begin": 5,
             "step_end": 8, "backend": "cpu"} if with_meta else None)
    d = str(tmp_path)
    _jax_trace(d, meta=meta, gz=gz)
    tc, jc = _drive(ttl, 100.0005), _drive(jtl, 100.0005)
    ta = ttl.analyze(d, clock=tc, top_k=5)
    ja = jtl.analyze(d, clock=jc, top_k=5)
    _approx_equal(ta, ja)
    assert ta["device"]["ops"] == 6
    assert ttl.render_report(ta) == jtl.render_report(ja)
    if with_meta:
        assert ta["steps"]["aligned"] and ta["steps"]["n_steps"] == 3


def test_analyze_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("not { json")
    empty = tmp_path / "empty"
    empty.mkdir()
    only_meta = tmp_path / "meta_only"
    only_meta.mkdir()
    (only_meta / "meta.json").write_text("{}")
    for p in (bad, empty, only_meta):
        with pytest.raises(ValueError):
            ttl.analyze(str(p))
    shape = tmp_path / "shape.json"
    shape.write_text(json.dumps({"traceEvents": [{"ph": "M"}]}))
    for lib in (ttl, jtl):
        with pytest.raises(ValueError, match="no complete"):
            lib.analyze(str(shape))


def _kineto(d):
    """A torch.profiler (Kineto) export, hand-laid on a µs axis: the
    capture marker ends at 1005 (meta's perf_begin), a 300 µs window;
    on the GPU stream a 100 µs K7 kernel, a 10 µs memcpy and a 50 µs
    merge kernel, with a gpu_user_annotation spanning them (a mirrored
    host range, not device work); host cpu_op / cuda_runtime events
    and ac2g flow events; a kernel that starts inside the window and
    ends 20 µs past it."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 11,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 11, "tid": 11,
         "args": {"name": "thread 11 (python3)"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "user_annotation", "pid": 11, "tid": 11,
         "name": tprof.START_MARKER, "ts": 1000.0, "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "pid": 11, "tid": 11,
         "name": "serving.decode_step", "ts": 1006.0, "dur": 280.0},
        {"ph": "X", "cat": "cuda_runtime", "pid": 11, "tid": 11,
         "name": "cudaGraphLaunch", "ts": 1007.0, "dur": 4.0},
        {"ph": "X", "cat": "cpu_op", "pid": 11, "tid": 11,
         "name": "aten::copy_", "ts": 1012.0, "dur": 3.0},
        {"ph": "s", "cat": "ac2g", "id": 1, "pid": 11, "tid": 11,
         "ts": 1007.0, "name": "ac2g"},
        {"ph": "f", "cat": "ac2g", "id": 1, "pid": 0, "tid": 7,
         "ts": 1010.0, "name": "ac2g", "bp": "e"},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "name": "serving.decode_step", "ts": 1010.0, "dur": 180.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void paged_decode_kernel<64>(...)", "ts": 1010.0,
         "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
         "name": "Memcpy DtoH (Device -> Pinned)", "ts": 1120.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void decode_merge_kernel<64>(...)", "ts": 1140.0,
         "dur": 50.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void paged_decode_kernel<64>(...)", "ts": 1295.0,
         "dur": 30.0},
    ]
    with open(os.path.join(d, "h.11.pt.trace.json"), "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": ev}, f)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"perf_begin": 50.0, "perf_end": 50.0003,
                   "t_begin_unix": 1.0, "t_end_unix": 1.0003,
                   "step_begin": 0, "step_end": 1, "backend": "cuda"}, f)


def test_analyze_kineto_trace_hand_computed(tmp_path):
    """Window [1005, 1305] µs. Device ops: the kernels and the memcpy,
    never the gpu_user_annotation: busy 100 + 10 + 50 + 10 (the last
    kernel clipped at the window's end) = 170 µs of 300; host gaps
    between device ops 10, 10 and 105 µs; top ops by summed time."""
    d = str(tmp_path)
    _kineto(d)
    a = ttl.analyze(d)
    assert a["device"]["ops"] == 4
    assert a["device"]["busy_s"] == pytest.approx(170e-6, abs=1e-12)
    assert a["window_s"] == pytest.approx(300e-6, abs=1e-12)
    assert a["device"]["busy_frac"] == pytest.approx(0.5667, abs=1e-12)
    assert a["device"]["idle_frac"] == pytest.approx(0.4333, abs=1e-12)
    hg = a["host_gaps"]
    assert hg["count"] == 3 and hg["total_s"] == pytest.approx(125e-6)
    assert hg["p50_ms"] == pytest.approx(0.01) and \
        hg["max_ms"] == pytest.approx(0.105)
    assert hg["hist"]["le_1e-05"] == 2 and hg["hist"]["inf"] == 3
    top = [(o["name"], o["count"], o["total_ms"]) for o in a["top_ops"]]
    assert top == [("void paged_decode_kernel<64>(...)", 2, 0.13),
                   ("void decode_merge_kernel<64>(...)", 1, 0.05),
                   ("Memcpy DtoH (Device -> Pinned)", 1, 0.01)]
    assert "serving.decode_step" not in {o["name"] for o in a["top_ops"]}
    assert a["steps"]["backend"] == "cuda" and \
        a["steps"]["steps_in_capture"] == 1
    text = ttl.render_report(a)
    assert "device: busy 56.7% / idle 43.3% (4 ops" in text


# ----------------------------------------------------------------------
# /profilez
# ----------------------------------------------------------------------

def _req(url, method="GET"):
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, method=method), timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """gpt2-test served on the CPU with an endpoint, its spool in a
    temporary dir; yields (gRPC address, endpoint base URL, the
    LMServer)."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models import gpt as tgpt
    from dnn_tpu_torch.runtime.lm_server import (
        start_lm_server_in_background,
    )

    cfg = tgpt.PRESETS["gpt2-test"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    saved = os.environ.get("DNN_TPU_OBS_DIR")
    os.environ["DNN_TPU_OBS_DIR"] = str(tmp_path_factory.mktemp("obsdir"))
    try:
        thread, stop = start_lm_server_in_background(
            cfg, from_jax_params(tgpt.init(0, cfg), cfg, "cpu"), port=port,
            device="cpu", slots=2, max_len=64, prompt_pad=16, block_len=8,
            metrics_port=0)
    finally:
        if saved is None:
            os.environ.pop("DNN_TPU_OBS_DIR")
        else:
            os.environ["DNN_TPU_OBS_DIR"] = saved
    srv = stop.servicer
    try:
        yield (f"127.0.0.1:{port}",
               f"http://127.0.0.1:{srv.metrics_server.port}", srv)
    finally:
        stop()


def test_profilez_codes_and_keys_equal_jax(daemon, tmp_path):
    """The same requests against the port's daemon and a JAX endpoint
    with a JAX Profiler: GET, arm, disarm and bad numbers answer the
    same codes and JSON keys; a timed capture answers JAX's keys, the
    capture listed on GET."""
    _, base, _ = daemon
    jsrv = jhttp.MetricsHTTPServer(port=0, profiler=jprof.Profiler(
        capture_root=str(tmp_path), arm_target=_Target()))
    jbase = f"http://127.0.0.1:{jsrv.port}"
    try:
        for path, method in (
                ("/profilez", "GET"),
                ("/profilez?auto=1&threshold_ms=40&ms=5", "POST"),
                ("/profilez", "GET"),
                ("/profilez?auto=0", "POST"),
                ("/profilez?auto=1&threshold_ms=abc", "POST"),
                ("/profilez?ms=abc", "POST"),
                ("/profilez/x", "POST")):
            tc, tb = _req(base + path, method)
            jc, jb = _req(jbase + path, method)
            assert tc == jc, (path, tc, jc)
            if tc == 200:
                tj, jj = json.loads(tb), json.loads(jb)
                assert tj.keys() == jj.keys()
                assert tj.get("armed") == jj.get("armed"), path
    finally:
        jsrv.close()
    code, body = _req(base + "/profilez?ms=30", "POST")
    got = json.loads(body)
    assert code == 200 and set(got) == {"capture", "ms", "trace_files"}
    assert got["ms"] == 30.0 and len(got["trace_files"]) == 1
    assert got["capture"] in json.loads(_req(base + "/profilez")[1])[
        "captures"]


def test_profilez_auto_trigger_captures_a_decode_step(daemon):
    """Armed at threshold 0, the worker captures the step after the
    first one and disarms; the capture holds one serving.decode_step
    range and its meta places one step in the window; a concurrent
    timed capture while one records answers 409."""
    from dnn_tpu_torch.comm.client import NodeClient

    addr, base, srv = daemon
    before = set(json.loads(_req(base + "/profilez")[1])["captures"])
    code, body = _req(base + "/profilez?auto=1&threshold_ms=0", "POST")
    assert code == 200 and json.loads(body)["armed"]["threshold_ms"] == 0
    client = NodeClient(addr)
    try:
        toks = client.generate(np.arange(1, 20), max_new_tokens=6)
    finally:
        client.close()
    assert len(toks) == 6
    st = json.loads(_req(base + "/profilez")[1])
    new = sorted(set(st["captures"]) - before)
    assert st["armed"] is None and len(new) == 1
    a = ttl.analyze(new[0], clock=srv.step_clock)
    assert a["steps"]["steps_in_capture"] == 1
    with open(ttl.find_trace_file(new[0])) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("serving.decode_step") == 1
    t = threading.Thread(target=_req, args=(base + "/profilez?ms=400",
                                            "POST"))
    t.start()
    time.sleep(0.15)
    try:
        assert _req(base + "/profilez?ms=10", "POST")[0] == 409
    finally:
        t.join()
