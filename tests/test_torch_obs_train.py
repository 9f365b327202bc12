"""The port's training observability against the JAX package's:
`make_train_step(grad_stats=True)` on gpt2-test at accum_steps 1 and 2
gives JAX's loss and gradient-health 3-vector ([grad-norm, update /
param norm ratio, nonfinite count]) within 1e-5 relative; fit with a
3-tuple step, a TrainClock and a GradSentinel records the same flight
events as JAX's fit on the same loss/stats sequence; the chaos
train_fault seam's sleep lands in the data phase and its nan poisons a
float batch into loss_nan in both; checkpoints feed note_ckpt_saved and
resume_or_init note_ckpt_restored.

Tolerance: 1e-5 relative on the loss and the 3-vector — the two
frameworks' f32 gradients agree to ~1e-6 in norm, and the port's update
is the parameters' realized change (new - old, rounded into f32), whose
rounding averages out over the tree's ~10^5 elements; both packages
accumulate the norms exactly enough (JAX's tree reductions, the port's
float64 sums)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_tpu import chaos as jchaos
from dnn_tpu import obs as jobs
from dnn_tpu import train as jtrain
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.obs import trainlens as jtl
from dnn_tpu.utils.metrics import Metrics as JMetrics
from dnn_tpu_torch import chaos as tchaos
from dnn_tpu_torch import obs as tobs
from dnn_tpu_torch import optim as topt
from dnn_tpu_torch import train as ttrain
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.obs import trainlens as ttl
from dnn_tpu_torch.utils.metrics import Metrics as TMetrics

from test_torch_llama import one_torch_thread  # noqa: F401 — autouse

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
STATS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _obs_on():
    was = (jobs.enabled(), tobs.enabled())
    jobs.set_enabled(True)
    tobs.set_enabled(True)
    yield
    jobs.set_enabled(was[0])
    tobs.set_enabled(was[1])


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0), CFG_J))


def _tokens(seed, b=4, t=17):
    return np.random.default_rng(seed).integers(
        0, CFG_T.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("accum,opt", [(1, "sgd"), (2, "sgd"),
                                       (2, "adamw")])
def test_grad_stats_match_jax(tree, accum, opt):
    """Two steps on one batch: the loss and the 3-vector of each step
    within STATS_RTOL of JAX's (nonfinite counts equal: 0), and the
    3-vector within STATS_RTOL of a float64 recomputation from the
    port's own gradients and parameters."""
    jopt = optax.sgd(0.1) if opt == "sgd" else optax.adamw(1e-3)
    tpt = topt.sgd(0.1) if opt == "sgd" else topt.adamw(1e-3)
    batch = _tokens(4)
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)
    japply = jgpt.make_apply_stacked(CFG_J)
    jstep = jtrain.make_train_step(
        lambda p, b: jtrain.next_token_loss(japply, p, b), jopt,
        accum_steps=accum, grad_stats=True)
    tprep = from_jax_params(tree, CFG_T, "cpu")
    tapply = tgpt.make_apply_stacked(CFG_T, use_flash=True)
    tstep = ttrain.make_train_step(
        lambda p, b: ttrain.next_token_loss(tapply, p, b), tpt,
        accum_steps=accum, grad_stats=True, device="cpu")
    js, ts = jopt.init(jprep), tpt.init(tprep)
    leaves = topt.tree_leaves(tprep)
    for _ in range(2):
        old = [p.detach().double().clone() for p in leaves]
        jprep, js, jloss, jstats = jstep(jprep, js, jnp.asarray(batch))
        tprep, ts, tloss, tstats = tstep(tprep, ts, batch)
        assert tstats.dtype == torch.float32 and tstats.shape == (3,)
        got, want = tstats.numpy(), np.asarray(jstats)
        np.testing.assert_allclose(tloss.item(), float(jloss),
                                   rtol=STATS_RTOL)
        np.testing.assert_allclose(got[:2], want[:2], rtol=STATS_RTOL)
        assert got[2] == want[2] == 0.0
        norm = lambda ts_: sum(float(t.square().sum()) for t in ts_) ** .5
        np.testing.assert_allclose(got[:2], [
            norm(p.grad.double() for p in leaves),
            norm(p.detach().double() - o for p, o in zip(leaves, old))
            / norm(old)], rtol=STATS_RTOL)


def _toy(lib):
    """A float linear model with the grad_stats leg in either package;
    its batch's float leaf carries a NaN when poisoned (fit's chaos nan
    vector). Returns (step_fn, state, batch iterator factory)."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((8, 3)).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 3)).astype(np.float32)
    if lib == "jax":
        params = {"w": jnp.asarray(w0), "b": jnp.zeros((3,))}
        opt = optax.sgd(1e-2)
        raw = jtrain.make_train_step(
            lambda p, bt: jnp.mean((bt["x"] @ p["w"] + p["b"] - bt["y"])
                                   ** 2), opt, grad_stats=True)
        state = (params, opt.init(params))
    else:
        params = {"w": torch.tensor(w0), "b": torch.zeros(3)}
        opt = topt.sgd(1e-2)
        raw = ttrain.make_train_step(
            lambda p, bt: ((bt["x"] @ p["w"] + p["b"] - bt["y"]) ** 2
                           ).mean(), opt, grad_stats=True, device="cpu")
        state = (params, opt.init(params))

    def step_fn(st, bt):
        p, s, loss, stats = raw(*st, bt)
        return (p, s), loss, stats

    def batches():
        while True:
            yield {"x": x, "y": y, "ids": np.arange(16)}

    return step_fn, state, batches


def _events_since(recorder, seq0, kinds):
    """The events after `seq0` of `kinds`, without ts and seq, as JSON
    text (a NaN loss compares equal as its text)."""
    return json.dumps([{k: v for k, v in e.items() if k not in ("ts", "seq")}
                       for e in recorder.events() if e["seq"] > seq0
                       and e["kind"] in kinds], sort_keys=True)


def _last_seq(recorder):
    evs = recorder.events()
    return evs[-1]["seq"] if evs else -1


KINDS = ("grad_spike", "loss_nan", "train_stall", "train_step",
         "chaos_inject", "ckpt_saved")


def test_fit_with_a_scripted_step_fires_jax_events():
    """A 3-tuple step replaying one scripted loss/stats sequence (a
    spike, a NaN loss, nonfinite grads, then a frozen optimizer) through
    both fits with a TrainClock and a GradSentinel: the same flight
    events, and the clocks count every step."""
    seq = []
    for i in range(14):
        stats = [1.0 + 0.01 * i, 1e-3, 0.0]
        loss = 2.0 - 0.01 * i
        if i == 4:
            stats[0] = 40.0
        if i == 6:
            loss = float("nan")
        if i == 8:
            stats[2] = 5.0
        if i >= 9:
            stats[1] = 0.0
        seq.append((loss, stats))
    got = {}
    for lib, fit, tl, fl, arr, metrics in (
            ("t", ttrain.fit, ttl, tobs.flight, torch.tensor, TMetrics),
            ("j", jtrain.fit, jtl, jobs.flight, jnp.asarray, JMetrics)):
        it = iter(seq)

        def step(state, batch, it=it, arr=arr):
            loss, stats = next(it)
            return state, arr(loss), arr(np.asarray(stats, np.float32))

        clock = tl.TrainClock(registry=metrics())
        sentinel = tl.GradSentinel(warmup=2, stall_steps=3)
        s0 = _last_seq(fl.recorder())
        fit(step, {}, iter(range(100)), num_steps=len(seq), clock=clock,
            sentinel=sentinel)
        got[lib] = _events_since(fl.recorder(), s0, KINDS)
        assert clock.steps_total == len(seq)
    assert got["t"] == got["j"]
    assert [e["kind"] for e in json.loads(got["t"])] == [
        "train_step", "grad_spike", "loss_nan", "loss_nan", "train_stall"]


def test_train_fault_sleep_and_nan_match_jax(tmp_path):
    """The same chaos plan in both packages: a 30 ms sleep at counter 1
    lands in step 2's data phase; a nan at counter 3 poisons step 4's
    float leaves (the int ids untouched), and the sentinel fires
    loss_nan at that step with every gradient element nonfinite; the
    flight events equal JAX's."""
    plan = {"seed": 0, "faults": [
        {"kind": "train_fault", "target": "sleep", "at_n": 1,
         "delay_s": 0.03},
        {"kind": "train_fault", "target": "nan", "at_n": 3}]}
    got, clocks = {}, {}
    for lib, fit, tl, fl, chaos in (
            ("t", ttrain.fit, ttl, tobs.flight, tchaos),
            ("j", jtrain.fit, jtl, jobs.flight, jchaos)):
        step_fn, state, batches = _toy("torch" if lib == "t" else "jax")
        clocks[lib] = clock = tl.TrainClock(registry=(
            TMetrics if lib == "t" else JMetrics)())
        s0 = _last_seq(fl.recorder())
        chaos.install(chaos.FaultPlan.from_dict(plan))
        try:
            fit(step_fn, state, batches(), num_steps=5, clock=clock,
                sentinel=tl.GradSentinel(warmup=1))
        finally:
            chaos.uninstall()
        got[lib] = _events_since(fl.recorder(), s0, KINDS)
    assert got["t"] == got["j"]
    nan = [e for e in json.loads(got["t"]) if e["kind"] == "loss_nan"]
    assert [(e["step"], e["nonfinite_grads"]) for e in nan] == [(4, 27)]
    for lib in ("t", "j"):
        # the nan step's data phase holds the poisoning (JAX's first
        # jnp.full_like dispatch takes ~0.1 s on the CPU): not compared
        data = [r["phases"]["data"] for r in clocks[lib].records()]
        assert data[1] >= 0.03 and max(data[0], data[2]) < 0.03
    poisoned = ttrain.poison_batch({"x": torch.ones(2),
                                    "ids": torch.arange(2),
                                    "np": np.ones(2, np.float32)})
    assert torch.isnan(poisoned["x"]).all() and \
        np.isnan(poisoned["np"]).all()
    assert torch.equal(poisoned["ids"], torch.arange(2))


def test_checkpoints_feed_the_clock_and_the_flight_ring(tmp_path):
    """fit's saves feed note_ckpt_saved (a ckpt_saved event with the
    file's bytes, the clock's last good step) and resume_or_init a
    ckpt_restored event, as JAX's."""
    step_fn, state, batches = _toy("torch")
    clock = ttl.TrainClock(registry=TMetrics()).install()
    s0 = _last_seq(tobs.flight.recorder())
    ttrain.fit(step_fn, state, batches(), num_steps=4,
               ckpt_dir=str(tmp_path), ckpt_every=2, clock=clock)
    saves = json.loads(_events_since(tobs.flight.recorder(), s0,
                                     ("ckpt_saved",)))
    assert [e["step"] for e in saves] == [2, 4]
    assert all(e["bytes"] > 0 for e in saves)
    assert clock.summary()["ckpt"]["last_good_step"] == 4
    _, start = ttrain.resume_or_init(str(tmp_path), _toy("torch")[1])
    assert start == 4
    ev = tobs.flight.recorder().events(kind="ckpt_restored")[-1]
    assert ev["step"] == 4 and ev["bytes"] > 0
