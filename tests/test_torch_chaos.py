"""The port's chaos package (dnn_tpu_torch/chaos) against the JAX
package's: plans parse, and are refused, as JAX's are; `decide` and the
injector's firing schedule equal JAX's for three seeds; and each seam
the port wires fires at its counter — kv_exhaust at the LM worker's
admission, step_fault before each pool step (tests/test_torch_resilience
.py holds the requeue it forces against JAX's daemon), kv_migrate in
kvpull, wedge_detail in the watchdog's probe and perturb_rpc("client")
in NodeClient.send_tensor."""

import json
import socket

import grpc
import numpy as np
import pytest

from dnn_tpu.chaos import inject as jinject
from dnn_tpu.chaos import plan as jplan
from dnn_tpu_torch import obs
from dnn_tpu_torch.chaos import inject as tinject
from dnn_tpu_torch.chaos import plan as tplan
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.obs import watchdog as twd
from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
from dnn_tpu_torch.utils import metrics as tmetrics

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

PLANS = [
    {"seed": 0, "faults": [{"kind": "step_fault", "at_n": 3}]},
    {"seed": 7, "faults": [
        {"kind": "rpc_drop", "seam": "client", "p": 0.3, "count": 3},
        {"kind": "rpc_delay", "seam": "stage", "p": 0.1, "delay_s": 0.0},
        {"kind": "kv_exhaust", "from_n": 2, "count": 3},
        {"kind": "kv_migrate_fault", "at_n": 1},
        {"kind": "wedge_device", "at_s": 5, "duration_s": 8},
        {"kind": "kill_stage", "target": "node2", "at_s": 15},
        {"kind": "train_fault", "target": "sleep", "at_n": 3, "count": 4,
         "delay_s": 0.05},
        {"kind": "ckpt_corrupt", "target": "/x.npz"}]},
]

BAD = [
    {"faults": [{"kind": "typo_fault"}]},
    {"faults": [{"kind": "rpc_drop", "p": 1.5}]},
    {"faults": [{"kind": "step_fault", "count": 0}]},
    {"faults": [{"kind": "step_fault", "when": 3}]},
    {"seed": 1},
    [1, 2],
]


@pytest.mark.parametrize("obj", PLANS)
def test_plans_parse_as_jax(obj):
    t, j = tplan.FaultPlan.from_dict(obj), jplan.FaultPlan.from_dict(obj)
    assert t.to_dict() == j.to_dict()
    assert tplan.FaultPlan.from_cli(json.dumps(obj)).to_dict() == t.to_dict()
    for part in ("process_faults", "inprocess_faults", "file_faults"):
        assert [f.kind for f in getattr(t, part)()] == \
            [f.kind for f in getattr(j, part)()]
    assert tplan.KINDS == jplan.KINDS


@pytest.mark.parametrize("obj", BAD)
def test_plans_refused_as_jax(obj):
    with pytest.raises(ValueError) as te:
        tplan.FaultPlan.from_dict(obj)
    with pytest.raises(ValueError) as je:
        jplan.FaultPlan.from_dict(obj)
    assert str(te.value) == str(je.value)


def test_cli_refuses_a_missing_path_as_jax():
    with pytest.raises(ValueError) as te:
        tplan.FaultPlan.from_cli("/no/such/plan.json")
    with pytest.raises(ValueError) as je:
        jplan.FaultPlan.from_cli("/no/such/plan.json")
    assert str(te.value) == str(je.value)


def _schedule(lib_plan, lib_inject, obj, n=40):
    """Which consultations of each seam fire, seam by seam."""
    inj = lib_inject.Injector(lib_plan.FaultPlan.from_dict(obj))
    out = {"rpc": [], "kv": [], "step": [], "migrate": [], "train": []}
    for i in range(n):
        try:
            inj.perturb_rpc("client", "t")
        except Exception as e:  # noqa: BLE001 — the injected drop
            out["rpc"].append((i, type(e).__mro__[1].__name__))
        out["kv"].append(inj.kv_exhaust())
        try:
            inj.step_fault()
        except RuntimeError:
            out["step"].append(i)
        try:
            inj.kv_migrate()
        except ConnectionError:
            out["migrate"].append(i)
        out["train"].append(inj.train_fault())
    return out


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_schedule_equals_jax(seed):
    for seam in ("kv_exhaust:", "rpc_drop:client", "x", "step"):
        vals = [tplan.decide(seed, seam, n) for n in range(64)]
        assert vals == [jplan.decide(seed, seam, n) for n in range(64)]
    obj = {"seed": seed, "faults": [
        {"kind": "rpc_drop", "seam": "client", "p": 0.3, "count": 4},
        {"kind": "kv_exhaust", "from_n": 5, "count": 3},
        {"kind": "step_fault", "at_n": 7, "count": 2},
        {"kind": "kv_migrate_fault", "at_n": 2},
        {"kind": "train_fault", "at_n": 4, "count": 2}]}
    t = _schedule(tplan, tinject, obj)
    assert t == _schedule(jplan, jinject, obj)
    assert t["step"] == [7, 8] and t["migrate"] == [2]
    assert [i for i, v in enumerate(t["kv"]) if v] == [5, 6, 7]
    assert len(t["rpc"]) == 4


def test_wedge_seam_reports_wedged_without_probing():
    """An injected wedge_device window: the watchdog's probe round reads
    wedged with the injection's detail and never calls the probe."""
    probed = []
    wd = twd.Watchdog(period_s=0.1, probe_deadline_s=0.05,
                      device_probe=lambda d: probed.append(d) or (True, "ok"),
                      registry=tmetrics.Metrics())
    tinject.install({"seed": 0, "faults": [{"kind": "wedge_device",
                                            "at_s": 0}]})
    try:
        wd._run_probe()
    finally:
        tinject.uninstall()
    comp = wd.status()["components"]["device"]
    assert comp["state"] == "wedged" and probed == []
    assert comp["detail"] == "chaos: injected device wedge (plan@0s)"
    wd._run_probe()
    assert wd.state() == "ok" and len(probed) == 1


def test_client_seam_fires_before_the_attempt():
    """perturb_rpc("client") in send_tensor: an injected drop is the
    attempt's UNAVAILABLE (no server needed), counted and recorded."""
    obs.flight.recorder().clear()
    tinject.install({"seed": 0, "faults": [
        {"kind": "rpc_drop", "seam": "client", "p": 1.0, "count": 1}]})
    c = NodeClient("127.0.0.1:9", breaker=False)
    try:
        with pytest.raises(grpc.RpcError) as e:
            c.send_tensor(np.zeros(2, np.int32), retries=0, timeout=5)
        assert e.value.code() == grpc.StatusCode.UNAVAILABLE
        assert "chaos: injected rpc drop (seam=client, n=0)" in \
            e.value.details()
    finally:
        tinject.uninstall()
        c.close()
    ev = obs.flight.recorder().events(kind="chaos_inject")
    assert [(e["fault"], e.get("n")) for e in ev] == [
        ("install", None), ("rpc_drop", 0)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CFG = tgpt.PRESETS["gpt2-test"]
PROMPTS = [np.random.default_rng(i).integers(0, 256, n).astype(np.int32)
           for i, n in enumerate((6, 19, 40))]


@pytest.fixture(scope="module")
def daemon():
    """A paged CPU daemon with the radix store on (kvpull is served)."""
    port = _free_port()
    tree = tgpt.init(3, CFG)
    thread, stop = start_lm_server_in_background(
        CFG, from_jax_params(tree, CFG, "cpu"), port=port, device="cpu",
        slots=2, max_len=64, prompt_pad=16, block_len=8, prefix_cache=32)
    client = NodeClient(f"127.0.0.1:{port}")
    assert client.wait_healthy(deadline=30)
    ref = [client.generate(p, max_new_tokens=8).tolist() for p in PROMPTS]
    try:
        yield client, stop.servicer, ref
    finally:
        client.close()
        stop()


def test_kv_exhaust_seam_holds_back_at_admission(daemon):
    """kv_exhaust at admission: the request is held back (one held_back
    event an item) and admitted when the window passes; every stream
    still equals the reference."""
    client, srv, ref = daemon
    obs.flight.recorder().clear()
    tinject.install({"seed": 0, "faults": [{"kind": "kv_exhaust",
                                            "from_n": 1, "count": 3}]})
    try:
        got = [client.generate(p, max_new_tokens=8).tolist()
               for p in PROMPTS]
    finally:
        tinject.uninstall()
    assert got == ref
    kinds = [(e["kind"], e.get("fault"), e.get("n"))
             for e in obs.flight.recorder().events()
             if e["kind"] in ("chaos_inject", "held_back", "admit")]
    assert kinds == [("chaos_inject", "install", None),
                     ("admit", None, None),
                     ("chaos_inject", "kv_exhaust", 1),
                     ("held_back", None, None),
                     ("chaos_inject", "kv_exhaust", 2),
                     ("chaos_inject", "kv_exhaust", 3),
                     ("admit", None, None), ("admit", None, None)]


def test_kv_migrate_seam_answers_kvtier_fallback(daemon):
    """kv_migrate in kvpull: the pull answers kvtier_fallback before
    contacting the donor, the fallback counter rises by one, and the
    next generate prefills the whole prompt."""
    client, srv, ref = daemon
    m = obs.metrics()
    before = m.snapshot()["counters"].get("dnn_tpu_kvtier_fallback_total", 0)
    fresh = np.random.default_rng(77).integers(0, 256, 40).astype(np.int32)
    chunks0 = srv.batcher.prefill_chunks_run
    tinject.install({"seed": 0, "faults": [{"kind": "kv_migrate_fault",
                                            "at_n": 0}]})
    try:
        status = client.kv_pull_from("127.0.0.1:9", fresh)
    finally:
        tinject.uninstall()
    assert status.startswith("[lm] kvtier_fallback: ConnectionError: chaos")
    assert m.snapshot()["counters"]["dnn_tpu_kvtier_fallback_total"] == \
        before + 1
    client.generate(fresh, max_new_tokens=2)
    assert srv.batcher.prefill_chunks_run - chunks0 == 3
