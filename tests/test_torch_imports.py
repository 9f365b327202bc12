"""The port stands alone: no module of dnn_tpu_torch imports jax or
anything of dnn_tpu, and its entry points never drop to the CPU on
their own."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "dnn_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter imports every dnn_tpu_torch module; neither
    jax nor dnn_tpu may appear in sys.modules afterwards."""
    names = [n for n, _ in _modules()]
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'dnn_tpu' or "
        "m.startswith('dnn_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(names) >= 15


@pytest.mark.parametrize("path", [p for _, p in _modules()] +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    """AST scan: no import statement names jax or dnn_tpu."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "dnn_tpu"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_entry_points_need_a_card_unless_told_otherwise():
    """Without device=, ContinuousBatcher (every cache layout), LMServer
    and make_generate run on CUDA — on a host without a card they raise
    instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default is satisfiable")
    from dnn_tpu_torch import resolve_device
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS, init
    from dnn_tpu_torch.runtime.generate import make_generate
    from dnn_tpu_torch.runtime.lm_server import LMServer
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    cfg = PRESETS["gpt2-test"]
    prepared = from_jax_params(init(0, cfg), cfg, "cpu")
    for ctor in (ContinuousBatcher, LMServer):
        for layout in ({}, {"kv": "dense", "kv_dtype": "int8"},
                       {"kv": "dense", "decode_buckets": True}):
            with pytest.raises(RuntimeError, match="CUDA"):
                ctor(cfg, prepared, slots=2, max_len=32, prompt_pad=16,
                     **layout)
    for kv_dtype in (None, "int8"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_generate(cfg, max_new_tokens=4, kv_dtype=kv_dtype)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_node_cli_refuses_cpu_fallback(tmp_path):
    """The daemon CLI defaults to --device cuda: on a host without a card
    it exits with an error instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0, "address": "127.0.0.1:1"}]}))
    from dnn_tpu_torch.node import main

    assert main(["--node_id", "node1", "--config", str(cfg),
                 "--serve_lm"]) == 1


def test_the_constraint_and_speculative_modules_are_scanned():
    """The modules of constrained and speculative decoding are among the
    modules the two tests above import and scan."""
    names = {n for n, _ in _modules()}
    assert {"dnn_tpu_torch.runtime.constrain",
            "dnn_tpu_torch.runtime.speculative",
            "dnn_tpu_torch.runtime.serving_spec"} <= names


def test_the_resilience_modules_are_scanned():
    """The observability and chaos modules the LM daemon's resilience
    seams report through are among the modules scanned above (the
    watchdog's probe child is held to the same rule in
    tests/test_torch_obs.py)."""
    names = {n for n, _ in _modules()}
    assert {"dnn_tpu_torch.obs", "dnn_tpu_torch.obs.flight",
            "dnn_tpu_torch.obs.http", "dnn_tpu_torch.obs.mem",
            "dnn_tpu_torch.obs.watchdog", "dnn_tpu_torch.chaos",
            "dnn_tpu_torch.chaos.plan", "dnn_tpu_torch.chaos.inject",
            "dnn_tpu_torch.utils.metrics"} <= names


def test_the_profiling_and_lens_modules_are_scanned():
    """The profiler, the timeline reader, the training, KV and SLO
    lenses, the fleet collector and the obs CLI are among the modules
    the two tests above import and scan: each keeps its own copy of the
    JAX package's pure-Python module, never an import of it."""
    names = {n for n, _ in _modules()}
    assert {"dnn_tpu_torch.obs.profile", "dnn_tpu_torch.obs.timeline",
            "dnn_tpu_torch.obs.trainlens", "dnn_tpu_torch.obs.kvlens",
            "dnn_tpu_torch.obs.slo", "dnn_tpu_torch.obs.fleet",
            "dnn_tpu_torch.obs.__main__"} <= names


def test_speculative_entry_points_need_a_card():
    """Without device=, the speculative batcher and the solo speculative
    decoder run on CUDA: on a host without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default is satisfiable")
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS, init
    from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher
    from dnn_tpu_torch.runtime.speculative import make_speculative_generate

    cfg = PRESETS["gpt2-test"]
    prepared = from_jax_params(init(0, cfg), cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeculativeBatcher(cfg, prepared, cfg, prepared, slots=2, max_len=32,
                           prompt_pad=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_speculative_generate(cfg, cfg, max_new_tokens=4)
