"""BENCHMARK.json against the benchmark's contract, and every name it
holds found as a file of its own."""

import json
import re
from pathlib import Path

import pytest

from benchmark import spec
from benchmark.check import NUMBERS

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok|mlp")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (ROOT / p).is_dir()
        assert not p.endswith("_torch")


def test_names_units_and_sources():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in names
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_configs_are_used_and_cut_only_in_scale():
    used = {w["config"] for w in BENCH["workloads"]}
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and set(names) == used
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert c["source"].startswith("https://") and _line(c["source"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)
    assert 1 <= len(CELLS) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_is_found_by_name(workload):
    cell = spec.load_cell(workload, ROOT)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    assert len(cell.traffic["valences"]) == len(cell.config["vocab_sizes"])
    compared = set(cell.limits) & set(NUMBERS)
    assert compared >= {"grad_gap", "change_gap", "change_gap_wide_leaf",
                        "late_change_gap", "late_change_gap_wide_leaf"}
    assert all(cell.limits[n] > 0 for n in compared)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)


def test_a_missing_name_is_an_error():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell", ROOT)
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")


def test_derived_seeds_are_stable_and_distinct():
    assert spec.derive(2**31 + 5, "a", 1) == spec.derive(2**31 + 5, "a", 1)
    assert spec.derive(2**31 + 5, "a", 1) != spec.derive(2**31 + 5, "a", 2)
    assert 0 <= spec.derive(2**40, "x") < 2**63
