"""A cell on several cards, rehearsed on the CPU: run.Ranks starts a
cell's `chips` ranks over gloo, each running the small packed cell
(small.py) through the adapter for D ranks (port_sharded.py). Each run
is a process of its own (small_run.py) with a timeout, since a rank that
fails ends the process that launched it."""

import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from benchmark import check, run
from benchmark.tests.small import small_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4099
WORKLOAD = "dlrm-packed.multihot"
#: A run's limit here; a rank that raises has to end the run well within.
CASE_TIMEOUT_S = 120
#: D = 2 against D = 1, by check.py's measure (a leaf's gap over the
#: larger of its own and the median leaf's D = 1 norm). The dense stack
#: computes in bf16, so each rank's partial gradient is rounded to bf16
#: (2**-8 relative, at most) before the f32 all-reduce sums them, where
#: D = 1 rounds the whole sum once; and the order of the sums changes.
#: After one step that is all (the first gradient: at most 0.14% over 5
#: seeds). Steps 2 and 3 start from states that already differ so, and a
#: bias, a sum of cancelling terms over the batch, carries the difference
#: in its norm (the change after three steps: median leaf at most 0.13%,
#: tables 0.32%, biases 1.5%). A shard left unchanged reads 30%.
LOSS_TOL = 1e-3
FIRST_GRAD_TOL = 2**-8
MEDIAN_CHANGE_TOL = 2**-8
CHANGE_TOL = 2**-5


def _run(chips, seconds, **keys):
    keys.setdefault("port_module", "benchmark.tests.ranked")
    t = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.tests.small_run", WORKLOAD,
         str(SEED), str(seconds), str(chips), json.dumps(keys)],
        cwd=ROOT, capture_output=True, text=True, timeout=CASE_TIMEOUT_S)
    result = (json.loads(out.stdout.strip().splitlines()[-1])
              if out.returncode == 0 else None)
    return out, time.monotonic() - t, result


def _readings(path):
    return {kind: json.loads((path / f"{kind}.json").read_text())
            for kind in ("first", "late")}


def test_two_ranks_are_correct_and_read_as_one_rank(tmp_path):
    (tmp_path / "d1").mkdir()
    (tmp_path / "d2").mkdir()
    # --seconds 0: one window step on each side, and D = 1 takes the
    # set-up steps that agree on the window at D = 2, so that the late
    # readings start from the same state.
    out2, _, two = _run(2, 0, record_to=str(tmp_path / "d2"))
    assert out2.returncode == 0, out2.stderr[-4000:]
    out1, _, one = _run(1, 0, wraps="benchmark.port",
                        record_to=str(tmp_path / "d1"),
                        steps_after_first=run.AGREE_STEPS)
    assert out1.returncode == 0, out1.stderr[-4000:]
    assert two["correct"], two["check"]
    assert two["window_steps_per_rank"] == [1, 1]
    assert two["device"]["count"] == 2
    assert len(two["device"]["memory_peak_bytes_per_rank"]) == 2
    assert one["device"]["count"] == 1 and "window_steps_per_rank" not in one
    d1, d2 = _readings(tmp_path / "d1"), _readings(tmp_path / "d2")
    for kind in ("first", "late"):
        assert d2[kind]["losses"] == pytest.approx(d1[kind]["losses"],
                                                   rel=LOSS_TOL)
        if kind == "first":  # the late readings have no first gradient
            grad = check._gaps(d2[kind]["grad_norms"],
                               d1[kind]["grad_norms"], d1[kind]["grad_norms"])
            assert max(grad.values()) <= FIRST_GRAD_TOL, grad
        change = check._gaps(d2[kind]["change_norms"],
                             d1[kind]["change_norms"],
                             d1[kind]["change_norms"])
        assert set(change) == set(d2[kind]["change_norms"])
        assert statistics.median(change.values()) <= MEDIAN_CHANGE_TOL
        assert max(change.values()) <= CHANGE_TOL, change


def test_every_rank_runs_the_agreed_window():
    out, _, result = _run(2, 2.0)
    assert out.returncode == 0, out.stderr[-4000:]
    assert result["correct"], result["check"]
    K = result["window_steps_per_rank"][0]
    assert result["window_steps_per_rank"] == [K, K] and K > 1
    # Rank 0's window line: examples of the global batch, both ranks' rows.
    steps, wall = re.search(r"^\[benchmark [^]]*\] window: (\d+) steps in "
                            r"([0-9.]+) s$", out.stderr, re.M).groups()
    assert int(steps) == K
    B = small_cell(WORKLOAD).config["global_batch_size"]
    assert result["metrics"]["train_examples_per_s"]["value"] == (
        pytest.approx(K * B / float(wall), rel=2e-3))


def test_a_rank_that_skips_its_sparse_update_is_not_correct():
    out, _, result = _run(2, 0, rank_fault="skip_update")
    assert out.returncode == 0, out.stderr[-4000:]
    assert not result["correct"]
    assert result["check"]["table_change_gap"]["value"] > (
        result["check"]["table_change_gap"]["limit"])


def test_a_rank_that_raises_ends_the_run():
    out, seconds, result = _run(2, 0, rank_fault="raise")
    assert out.returncode == run.EXIT_RANK_FAILED, out.stderr[-4000:]
    assert result is None and out.stdout.strip() == ""
    assert seconds < CASE_TIMEOUT_S
    pids = [int(p) for p in re.findall(r"rank \d+ started, pid (\d+)",
                                       out.stderr)]
    assert len(pids) == 1
    deadline = time.monotonic() + 10
    while any(os.path.exists(f"/proc/{p}") for p in pids):
        assert time.monotonic() < deadline, f"rank left running: {pids}"
        time.sleep(0.1)


def test_one_chip_starts_no_process_group(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a one-chip run started a process group")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    result, code = run.run_cell(small_cell(WORKLOAD), SEED, 0.2, False,
                                torch.device("cpu"))
    assert code == 0 and result["correct"], result["check"]
    assert not dist.is_initialized()
    assert result["device"]["count"] == 1
    assert "window_steps_per_rank" not in result
