"""The port's copies of the JAX package's pure-Python lenses against the
originals, on the same inputs made from a seed: obs/slo.py (the same
records give the same SLOReport; an incident bundle either package
writes loads and renders in the other), obs/trainlens.py (the same phase
stamps give the same /trainz summary, Prometheus text and host track)
and obs/kvlens.py (the same admission keys give a bit-equal curve and
summary). Exact equality throughout: the modules are host arithmetic on
the same Python floats."""

import json
import time

import numpy as np
import pytest

from dnn_tpu import obs as jobs
from dnn_tpu.obs import kvlens as jkv
from dnn_tpu.obs import slo as jslo
from dnn_tpu.obs import trainlens as jtl
from dnn_tpu.utils import metrics as jmetrics
from dnn_tpu_torch import obs as tobs
from dnn_tpu_torch.obs import kvlens as tkv
from dnn_tpu_torch.obs import slo as tslo
from dnn_tpu_torch.obs import trainlens as ttl
from dnn_tpu_torch.utils import metrics as tmetrics


@pytest.fixture(autouse=True)
def _obs_on():
    was = (jobs.enabled(), tobs.enabled())
    jobs.set_enabled(True)
    tobs.set_enabled(True)
    yield
    jobs.set_enabled(was[0])
    tobs.set_enabled(was[1])


# ----------------------------------------------------------------------
# slo
# ----------------------------------------------------------------------

def _records(seed: int, n: int = 40):
    """Seeded request records: completed, rejected and silently lost
    ones, TTFTs and inter-token gaps, some over the objectives."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = rng.choice(["ok", "ok", "ok", "rejected", None],
                          p=[.5, .25, .15, .07, .03])
        tok = int(rng.integers(1, 40)) if kind == "ok" else 0
        out.append({
            "i": i, "t": float(i * 0.05),
            "outcome": None if kind is None else str(kind),
            "tokens": tok,
            "ttft_s": float(rng.gamma(2.0, 0.15)) if kind == "ok" else None,
            "itl_s": [float(x) for x in rng.gamma(2.0, 0.01, tok)],
            "t_done": float(i * 0.05 + 1.0) if kind == "ok" else None})
    return out


SPECS = [dict(ttft_s=0.5, itl_s=0.05, availability=0.9),
         dict(ttft_s=0.2, ttft_p=99.0, goodput_floor_tps=50.0),
         dict(itl_s=0.1, itl_p=50.0, availability=0.5)]


@pytest.mark.parametrize("seed,spec", [(0, SPECS[0]), (1, SPECS[1]),
                                       (2, SPECS[2])])
def test_slo_report_equals_jax(seed, spec):
    recs = _records(seed)
    kw = dict(wall_s=3.25, t0_epoch=1.7e9,
              burn_rates={"ttft": 2.5, "availability": 0.25})
    tr = tslo.evaluate("chat", recs, tslo.SLOSpec(**spec), **kw)
    jr = jslo.evaluate("chat", recs, jslo.SLOSpec(**spec), **kw)
    assert tr.to_dict() == jr.to_dict()
    assert tslo.SLOSpec(**spec).to_dict() == jslo.SLOSpec(**spec).to_dict()


def test_incident_bundles_cross_load(tmp_path):
    """A bundle the port writes loads and renders in JAX's
    load_incident/render_incident as in its own, and the reverse; each
    package's flight events land in its own bundle."""
    recs = _records(3)
    spec = dict(ttft_s=0.1, availability=0.99)
    t0 = time.time() - 1.0  # the breach window brackets the events below
    tr = tslo.evaluate("burst", recs, tslo.SLOSpec(**spec), wall_s=2.0,
                       t0_epoch=t0)
    jr = jslo.evaluate("burst", recs, jslo.SLOSpec(**spec), wall_s=2.0,
                       t0_epoch=t0)
    assert not tr.ok and tr.to_dict() == jr.to_dict()
    tfl = tobs.flight.FlightRecorder(16)
    jfl = jobs.flight.FlightRecorder(16)
    for fl in (tfl, jfl):
        for k in range(3):
            fl.record("worker_died", n=k)
    tdir = tslo.write_incident_bundle(str(tmp_path / "t"), tr,
                                      records=recs, flight=tfl)
    jdir = jslo.write_incident_bundle(str(tmp_path / "j"), jr,
                                      records=recs, flight=jfl)
    for d in (tdir, jdir):
        tb, jb = tslo.load_incident(d), jslo.load_incident(d)
        strip = [{k: v for k, v in e.items() if k != "ts"}
                 for e in tb["flight"]]
        assert strip == [{k: v for k, v in e.items() if k != "ts"}
                         for e in jb["flight"]]
        assert len(tb["flight"]) == 3
        assert tb["manifest"] == jb["manifest"]
        assert tslo.render_incident(tb) == jslo.render_incident(jb)
        assert "SLO BREACH" in tslo.render_incident(tb)
    with pytest.raises(ValueError, match="not an incident bundle"):
        tslo.load_incident(str(tmp_path))


# ----------------------------------------------------------------------
# trainlens
# ----------------------------------------------------------------------

def _drive(lens, metrics, seed: int):
    """The same seeded phase stamps through a TrainClock of either
    package, with its clock and registry injected; checkpoint notes
    between steps."""
    rng = np.random.default_rng(seed)
    t = [100.0]
    clk = lens.TrainClock(capacity=8, flops_per_step=3.3e12,
                          tokens_per_step=4096, peak_flops=1e15,
                          registry=metrics.Metrics(), now=lambda: t[0])
    for i in range(12):
        rec = clk.begin()
        for phase in lens.TRAIN_PHASES[:5]:
            t[0] += float(rng.gamma(2.0, 0.004))
            clk.mark(rec, phase)
        t[0] += float(rng.gamma(2.0, 0.001))
        clk.end(rec, tokens=4096 + i)
        if i == 5:
            clk.ckpt_saved(6, 0.25, 1.5e9)
    t[0] += 0.5
    return clk


@pytest.mark.parametrize("last", [None, 3])
def test_trainlens_summary_prom_trace_equal_jax(last):
    tc, jc = _drive(ttl, tmetrics, 7), _drive(jtl, jmetrics, 7)
    ts, js = tc.summary(last), jc.summary(last)
    # the port names the peak its MFU divides by; the rest is JAX's
    assert ts.pop("peak_flops_source") == "explicit peak_flops"
    assert ts == js
    assert ts["mfu"] is not None and ts["ckpt"]["last_good_step"] == 6
    assert tc.render_prom(last) == jc.render_prom(last)
    assert tc.chrome_trace(last) == jc.chrome_trace(last)
    assert tc.records() == jc.records()
    assert tc.status_component() == jc.status_component()


def _get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_trainz_served_as_jax_serves_it():
    """GET /trainz on both packages' endpoints over the same stamps: the
    JSON (less the port's peak source), ?format=prom, ?format=trace and
    ?last=N are equal; an endpoint without a clock answers 404 in both."""
    tc, jc = _drive(ttl, tmetrics, 3), _drive(jtl, jmetrics, 3)
    srvs = [tobs.serve_metrics(0, trainlens=tc, profiler=False),
            jobs.serve_metrics(0, trainlens=jc, profiler=False),
            tobs.serve_metrics(0, profiler=False),
            jobs.serve_metrics(0, profiler=False)]
    try:
        t, j, t0, j0 = (f"http://127.0.0.1:{s.port}/trainz" for s in srvs)
        for q in ("", "?last=4"):
            (tcode, tbody), (jcode, jbody) = _get(t + q), _get(j + q)
            tz = json.loads(tbody)
            assert tcode == jcode == 200
            assert tz.pop("peak_flops_source") == "explicit peak_flops"
            assert tz == json.loads(jbody)
        for q in ("?format=prom", "?format=trace&last=5"):
            assert _get(t + q) == _get(j + q)
        assert _get(t0)[0] == _get(j0)[0] == 404
    finally:
        for s in srvs:
            s.close()


def test_trainlens_sentinel_events_equal_jax():
    """The same loss/stats sequence through both GradSentinels fires the
    same events at the same steps: a spike past warmup, a NaN latched
    once an episode, a stall after its run of tiny update ratios."""
    rng = np.random.default_rng(11)
    seq = []
    for i in range(40):
        loss, stats = float(rng.uniform(2, 3)), [float(rng.uniform(1, 2)),
                                                 1e-3, 0.0]
        if i == 9:
            stats[0] = 50.0
        if i in (15, 16):
            loss = float("nan")
        if i == 20:
            stats[2] = 3.0
        if i >= 25:
            stats[1] = 0.0
        seq.append((loss, stats))
    got = {}
    for name, lens in (("t", ttl), ("j", jtl)):
        s = lens.GradSentinel(warmup=3, stall_steps=5)
        got[name] = [(i + 1, s.observe(i + 1, loss, np.asarray(st)))
                     for i, (loss, st) in enumerate(seq)]
    assert got["t"] == got["j"]
    fired = [(i, k) for i, ks in got["t"] for k in ks]
    assert fired == [(10, "grad_spike"), (16, "loss_nan"), (21, "loss_nan"),
                     (30, "train_stall")]


# ----------------------------------------------------------------------
# kvlens
# ----------------------------------------------------------------------

class _Node:
    def __init__(self, depth):
        self.depth = depth
        self.obskey = None


def _feed(lens, seed: int):
    """One seeded admission stream: prompts over a few shared prefixes,
    inserts of their blocks, evictions and migrations, on an injected
    clock."""
    rng = np.random.default_rng(seed)
    t = [0.0]
    kv = lens.KVLens(8, 4, seed=3, rate=0.5, thrash_window_s=5.0,
                     bytes_per_block=64, now=lambda: t[0])
    heads = [rng.integers(0, 1000, 12) for _ in range(6)]
    for i in range(80):
        t[0] += 0.25
        p = np.concatenate([heads[int(rng.integers(0, 6))],
                            rng.integers(0, 1000, int(rng.integers(0, 9)))])
        kv.on_access(p, n_resident=int(rng.integers(0, 3)))
        nodes = [_Node(d + 1) for d in range(len(p) // 4)]
        kv.on_insert(p, nodes, origin="adopted" if i % 7 == 0 else "local")
        kv.on_share(int(rng.integers(0, 3)), int(i % 2), cow=i % 5 == 0)
        kv.note_prefill(2, 0.01 * (1 + i % 3))
        if i % 4 == 3:
            kv.on_evict([n.obskey for n in nodes[:2]] + [None],
                        cause="capacity" if i % 8 else "clear")
        if i % 9 == 0:
            kv.on_migrate(2, 4096)
    return kv


def test_kvlens_curve_and_summary_bit_equal_jax():
    tk, jk = _feed(tkv, 5), _feed(jkv, 5)
    assert tk.curve() == jk.curve()
    ts, js = tk.summary(), jk.summary()
    for s in (ts, js):
        for e in s["ledger"]:
            e.pop("ts")
    assert ts == js
    assert tk.render_prom() == jk.render_prom()
    assert tk.sampled > 0 and tk.refetch_blocks > 0
    assert tk.chunk_keys(np.arange(9)) == jk.chunk_keys(np.arange(9))
    assert {k: f() for k, f in tk.prom_gauges().items()} == \
        {k: f() for k, f in jk.prom_gauges().items()}


def test_kvlens_gate_off_records_nothing():
    tobs.set_enabled(False)
    kv = tkv.KVLens(8, 4)
    kv.on_access(np.arange(16), n_resident=2)
    kv.on_migrate(3, 10)
    assert kv.accesses == 0 and kv.migrations == 0
    assert json.dumps(kv.summary())
