"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the port."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]

HARNESS = ("benchmark.run", "benchmark.port", "benchmark.control",
           "benchmark.trace", "benchmark.check")
REFERENCE = ("benchmark.reference", "benchmark.weights",
             "benchmark.traffic", "benchmark.counts", "benchmark.check")


def _loaded_after(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _loaded_after(HARNESS)
    assert "keras_rs_tpu_torch" in loaded
    assert not loaded & run.FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(REFERENCE)
    assert not loaded & (run.FORBIDDEN | {"keras_rs_tpu_torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("keras_rs_tpu_torch", "keras_rs_tpu_torch.models",
                 "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "keras_rs_tpu.layers", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "keras_rs_tpu"]


def test_benchmark_alone_exits_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "dlrm-packed.multihot", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
