"""The port's LM-daemon resilience seams beside the JAX package's daemon,
on the same gpt2-test weights and the same fault plan: a step fault
mid-decode kills the worker, a successor requeues the survivors, and the
greedy streams and the sequence of flight-event kinds equal JAX's; a
spent restart budget fails every caller fast; a drain under load loses
nothing and admits nothing new (/drainz, /healthz, /statusz, preflight
UNAVAILABLE); a dedup key joins over gRPC; serve_lm returns 43 after a
wedged escalation (its SIGTERM drain to rc 0, a `node --serve_lm`
process, is tests/test_torch_lm_server.py::
test_node_cli_daemon_serves_and_drains_on_sigterm); the client's circuit
breaker goes open, half-open, closed as JAX's does."""

import asyncio
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_tpu import obs as jobs
from dnn_tpu.chaos import inject as jinject
from dnn_tpu.comm import client as jclient
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime.lm_server import LMServer as JaxServer
from dnn_tpu_torch import obs
from dnn_tpu_torch.chaos import inject as tinject
from dnn_tpu_torch.comm import client as tclient
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.obs.watchdog import Watchdog
from dnn_tpu_torch.runtime.lm_server import (
    EXIT_RESTART,
    DrainingError,
    LMServer,
    serve_lm,
    start_lm_server_loop,
)
from dnn_tpu_torch.utils.metrics import Metrics

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
POOL = dict(slots=4, max_len=64, prompt_pad=16, block_len=8)
PROMPTS = [np.random.default_rng(i).integers(0, 256, n).astype(np.int32)
           for i, n in enumerate((6, 19, 40, 9))]
N_NEW = 10
# the kinds both daemons record on these paths (JAX also records its
# compile telemetry, which the port has no counterpart of)
KINDS = {"chaos_inject", "admit", "retire", "held_back", "worker_died",
         "worker_restart", "worker_restart_exhausted", "dedup_join"}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tree():
    return jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(1), CFG_J))


@pytest.fixture(scope="module")
def daemons():
    """(port daemon over gRPC: address, servicer; JAX daemon (worker
    only); the greedy reference streams)."""
    tree = _tree()
    jsrv = JaxServer(CFG_J, jgpt.prepare_stacked(
        jax.tree.map(jnp.asarray, tree), CFG_J), kv="paged", **POOL)
    port = _free_port()
    # the file's gRPC daemons share one event loop (several loops in one
    # process flood gRPC's poller)
    start, close = start_lm_server_loop()
    stop = start(CFG_T, from_jax_params(tree, CFG_T, "cpu"), port=port,
                 device="cpu", kv="paged", **POOL)
    srv = stop.servicer
    try:
        ref = [_wait(_submit_all(srv.worker, [p], "call"))[0]
               for p in PROMPTS]
        assert ref == [_wait(_submit_all(jsrv.worker, [p],
                                         "submit_control"))[0]
                       for p in PROMPTS]
        yield f"127.0.0.1:{port}", srv, jsrv, ref, start
    finally:
        stop()
        close()
        jsrv.close()
        assert not close.thread.is_alive()


def _submit_all(worker, prompts, method):
    """Queue every prompt from the worker's own thread between two steps
    (call / submit_control), so one loop iteration admits them all before
    the next step: the schedule, and so the flight sequence, is the same
    on every run."""
    return getattr(worker, method)(lambda: [
        worker.submit(np.asarray(p, np.int32), N_NEW, None)
        for p in prompts]).result(timeout=60)


def _wait(futs):
    return [np.asarray(f.result(timeout=120)).tolist() for f in futs]


def _kinds(ring):
    return [e["kind"] for e in ring.events() if e["kind"] in KINDS]


def _revive(srv):
    """A fresh worker for a daemon whose worker a test let die."""
    srv.worker_restarts = 2
    srv._restart_times.clear()
    srv.worker = srv._spawn_worker()
    srv.worker.start()


def test_requeue_after_a_step_fault_matches_jax(daemons):
    _, srv, jsrv, ref, _ = daemons
    plan = {"seed": 0, "faults": [{"kind": "step_fault", "at_n": 3}]}
    got = {}
    for key, worker_of, method, ring, inj in (
            ("port", lambda: srv.worker, "call", obs.flight.recorder(),
             tinject),
            ("jax", lambda: jsrv.worker, "submit_control",
             jobs.flight.recorder(), jinject)):
        ring.clear()
        inj.install(plan)
        try:
            got[key] = (_wait(_submit_all(worker_of(), PROMPTS, method)),
                        _kinds(ring))
        finally:
            inj.uninstall()
    assert got["port"][0] == got["jax"][0] == ref
    kinds = got["port"][1]
    # worker_restart is recorded by the dying thread while the successor
    # already admits: its place among the admits is a race, so it is
    # held apart
    drop = lambda ks: [k for k in ks if k != "worker_restart"]
    assert drop(kinds) == drop(got["jax"][1])
    assert kinds.count("worker_restart") == \
        got["jax"][1].count("worker_restart") == 1
    assert drop(kinds) == (["chaos_inject"] + ["admit"] * 4
                           + ["chaos_inject", "worker_died"]
                           + ["retire"] * 4 + ["admit"] * 4
                           + ["retire"] * 4)
    ev = obs.flight.recorder().events(kind="worker_restart")[0]
    assert (ev["requeued"], ev["failed"]) == (4, 0)


@pytest.mark.parametrize("at_n", [2, 5])
def test_requeue_under_overlap_drops_the_uncommitted_step(daemons, at_n):
    """Interleaved admission and overlap: a step dispatched but not
    committed when the worker died is dropped (never committed into a
    requeued request), and the requeued streams equal the reference —
    the fault mid-admission (at_n 2) and mid-decode (at_n 5)."""
    ref = daemons[3]
    srv = LMServer(CFG_T, from_jax_params(_tree(), CFG_T, "cpu"),
                   device="cpu", kv="paged", prefill_chunk_tokens=16,
                   overlap=True, **POOL)
    tinject.install({"seed": 0, "faults": [{"kind": "step_fault",
                                            "at_n": at_n}]})
    try:
        assert _wait(_submit_all(srv.worker, PROMPTS, "call")) == ref
        assert srv.batcher._inflight is None or srv.batcher.n_active == 0
        ev = obs.flight.recorder().events(kind="worker_restart")[-1]
        assert ev["requeued"] == 4
    finally:
        tinject.uninstall()
        srv.close()


def test_spent_budget_fails_fast_as_jax(daemons):
    """Past the restart budget the survivors fail fast with "worker
    died", as JAX's daemon fails them; both daemons get a new worker
    after."""
    _, srv, jsrv, _, _ = daemons
    plan = {"seed": 0, "faults": [{"kind": "step_fault", "at_n": 1}]}
    errs = {}
    for key, s, method, ring, inj in (
            ("port", srv, "call", obs.flight.recorder(), tinject),
            ("jax", jsrv, "submit_control", jobs.flight.recorder(),
             jinject)):
        ring.clear()
        s.worker_restarts = 0
        inj.install(plan)
        try:
            futs = _submit_all(s.worker, PROMPTS[:2], method)
            errs[key] = [str(f.exception(timeout=60)) for f in futs]
            s.worker.join(timeout=30)
            assert not s.worker.is_alive()
            errs[key].append(_kinds(ring))
        finally:
            inj.uninstall()
            _revive(s)
    assert errs["port"] == errs["jax"]
    assert errs["port"][0] == ("LM batcher worker died: chaos: injected "
                               "device step fault (step n=1)")
    assert errs["port"][2] == ["chaos_inject", "admit", "admit",
                               "chaos_inject", "worker_died",
                               "worker_restart_exhausted"]
    assert _wait(_submit_all(srv.worker, PROMPTS[:1], "call")) == \
        daemons[3][:1]


def test_no_restarts_configured_fails_every_caller_fast():
    """worker_restarts=0 at construction: no requeue hook, every caller
    (in flight and queued) fails fast and new submits too."""
    tree = _tree()
    srv = LMServer(CFG_T, from_jax_params(tree, CFG_T, "cpu"), device="cpu",
                   worker_restarts=0, kv="paged", **{**POOL, "slots": 2})
    tinject.install({"seed": 0, "faults": [{"kind": "step_fault",
                                            "at_n": 0}]})
    try:
        futs = _submit_all(srv.worker, PROMPTS, "call")
        for f in futs:
            assert "LM batcher worker died" in str(f.exception(timeout=60))
        srv.worker.join(timeout=30)
        late = srv.worker.submit(PROMPTS[0], 2, None)
        assert "worker died" in str(late.exception(timeout=5))
    finally:
        tinject.uninstall()
        srv.close()


def _http(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_drain_under_load_loses_nothing_and_admits_nothing(daemons):
    """2 slots, 4 requests, then POST /drainz: while the 2 in flight
    decode, /statusz says draining, /healthz answers 503, HealthCheck is
    unhealthy and a new request is refused at preflight with UNAVAILABLE
    "draining"; then the 2 in flight finish equal to the reference and
    the 2 queued come back DrainingError (UNAVAILABLE over gRPC)."""
    ref = daemons[3]
    start = daemons[4]
    port = _free_port()
    stop = start(CFG_T, from_jax_params(_tree(), CFG_T, "cpu"), port=port,
                 device="cpu", kv="paged", metrics_port=0, drain_grace_s=30,
                 **{**POOL, "slots": 2})
    srv = stop.servicer
    base = f"http://127.0.0.1:{srv.metrics_server.port}"
    checked = threading.Event()

    def hold():
        # the loop's next turn after the two admissions waits here until
        # the checks below are done: the queued two stay queued and the
        # two in flight stay in flight
        t_end = time.monotonic() + 30
        while (srv.batcher.n_active == 2 and not checked.is_set()
               and time.monotonic() < t_end):
            time.sleep(0.005)

    srv.worker.heartbeat = hold
    c = tclient.NodeClient(f"127.0.0.1:{port}", breaker=False)
    try:
        futs = _submit_all(srv.worker, PROMPTS, "call")
        t_end = time.monotonic() + 30  # both slots admitted: the loop holds
        while srv.batcher.n_active < 2 and time.monotonic() < t_end:
            time.sleep(0.002)
        code, body = _http(base + "/drainz", "POST")
        assert code == 202 and json.loads(body)["draining"] is True
        assert json.loads(_http(base + "/statusz")[1])["state"] == "draining"
        assert _http(base + "/healthz") == (503, "unhealthy\n")
        assert not c.health_check()
        with pytest.raises(grpc.RpcError) as e:
            c.generate(PROMPTS[0], max_new_tokens=2, timeout=30)
        assert e.value.code() == grpc.StatusCode.UNAVAILABLE
        assert e.value.details().startswith("draining")
        assert srv.batcher.n_active == 2 and srv.worker.q.qsize() >= 2
        checked.set()
        done = [f.exception(timeout=60) for f in futs]
        assert [np.asarray(f.result()).tolist() for f in futs[:2]] == ref[:2]
        assert all(isinstance(e, DrainingError) for e in done[2:])
        srv._drain_thread.join(timeout=30)
        assert srv._escalated.is_set() and not srv.worker.is_alive()
        kinds = [e["kind"] for e in obs.flight.recorder().events()
                 if e["kind"].startswith("drain")]
        assert kinds[-5:] == ["drainz", "drain_begin", "drain_handback",
                              "drain_done", "drain_exit"]
    finally:
        checked.set()
        c.close()
        stop()


def test_dedup_key_joins_over_grpc(daemons):
    """Two concurrent SendTensors sharing a d= key: identical replies,
    one admission, one dedup_join; a stream drops the key."""
    addr, srv, _, ref, _ = daemons
    obs.flight.recorder().clear()
    c = tclient.NodeClient(addr)
    out, errors = {}, []

    def call(i):
        try:
            out[i] = c.generate(PROMPTS[2], max_new_tokens=N_NEW,
                                dedup="key-1", timeout=60).tolist()
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and out[0] == out[1] == ref[2]
    kinds = _kinds(obs.flight.recorder())
    assert kinds.count("admit") == 1 and kinds.count("dedup_join") == 1
    assert list(c.generate_stream(PROMPTS[0], max_new_tokens=N_NEW,
                                  dedup="key-1")) == ref[0]
    c.close()
    assert tclient.gen_request_id(4, 1, adapter=2, dedup="k", kv_handle="h") \
        == "gen:4:1:a=2:d=k:h=h"
    assert tclient.gen_request_id(4, 1, adapter=2, dedup="k") == \
        jclient._gen_rid(4, 1, None, None, None, adapter=2, dedup="k")


def test_serve_lm_returns_43_after_a_wedged_escalation():
    """on_wedged="restart": the watchdog's wedged episode (a stubbed probe
    that times out) makes serve_lm return EXIT_RESTART."""
    wd = Watchdog(period_s=0.1, probe_deadline_s=0.05,
                  device_probe=lambda d: (False, "probe timeout", True),
                  registry=Metrics())
    rc = asyncio.run(serve_lm(
        CFG_T, from_jax_params(_tree(), CFG_T, "cpu"), port=_free_port(),
        device="cpu", watchdog=wd, on_wedged="restart", kv="paged",
        **{**POOL, "slots": 1}))
    assert rc == EXIT_RESTART == 43
    assert obs.flight.recorder().events(kind="wedged_policy")[-1][
        "policy"] == "restart"


@pytest.mark.parametrize("lib", ["port", "jax"])
def test_circuit_breaker_open_half_open_closed(lib):
    """Two failures open the breaker; past the cooldown one half-open
    probe goes through, fails and opens it for twice as long; past that,
    a probe that succeeds closes it and resets the cooldown. The clock
    is moved by hand (the breaker's open time set back)."""
    mod = tclient if lib == "port" else jclient
    br = mod.CircuitBreaker("t", threshold=2, cooldown_s=5.0)
    seq = [br.state]
    for ok in (False, False):
        assert br.allow()
        br.record(ok)
    seq += [br.state, br.allow()]
    br._opened_at -= 6.0
    seq += [br.allow(), br.state, br.allow()]  # one half-open probe
    br.record(False)  # the probe failed: open, cooldown doubled
    seq += [br.state, br._cooldown, br.allow()]
    br._opened_at -= 11.0
    seq += [br.allow(), br.state]
    br.record(True)  # the probe succeeded: closed, cooldown reset
    seq += [br.state, br.allow(), br._cooldown]
    assert seq == ["closed", "open", False, True, "half_open", False,
                   "open", 10.0, False, True, "half_open", "closed", True,
                   5.0]
