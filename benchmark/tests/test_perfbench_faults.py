"""A whole run of the harness on the CPU (the look for a chip skipped),
with the timed path broken underneath: each fault a training cell can
have makes `correct` false, where the sound run at the same size is
correct (small.py: the cell's own limits). One chip exchanges nothing,
so a left-out exchange is no fault here."""

import pytest
import torch

from benchmark import port, run
from benchmark import reference as ref
from benchmark.tests.small import small_cell
from keras_rs_tpu_torch.examples.ml_perf import main as ml_main
from keras_rs_tpu_torch.models.dlrm import bce_loss

SEED = 2**31 + 99
CELLS = ["dlrm-packed.multihot", "dlrm-capacity.multihot"]


def state_unchanged(monkeypatch):
    """The step computes the loss and updates nothing."""
    def make(model, loss_fn, optimizer, **kw):
        def step(batch):
            with torch.no_grad():
                return loss_fn(model, batch).detach()
        return step
    monkeypatch.setattr(port, "make_train_step", make)


def state_unchanged_after_warm_up(monkeypatch):
    """The step updates the state through the checked first steps and the
    warm-up, and not after them: what a step captured after warm-up (a
    graph replayed over stale buffers) can do, and the first steps'
    reading alone cannot see."""
    real_make = port.make_train_step

    def make(model, loss_fn, optimizer, **kw):
        real = real_make(model, loss_fn, optimizer, **kw)
        calls = [0]

        def step(batch):
            calls[0] += 1
            if calls[0] <= ref.CHECK_STEPS + run.WARM_STEPS:
                return real(batch)
            with torch.no_grad():
                return loss_fn(model, batch).detach()
        return step
    monkeypatch.setattr(port, "make_train_step", make)


def half_batch(monkeypatch):
    """The loss is the mean over the first half of the batch."""
    def make_loss_fn(device_preprocessing):
        def loss_fn(m, b):
            logits = m(m.preprocess_on_device(b))
            y = b["label"]
            per = (torch.clamp(logits, min=0.0) - logits * y
                   + torch.log1p(torch.exp(-torch.abs(logits))))
            return per[: per.shape[0] // 2].mean()
        return loss_fn
    monkeypatch.setattr(ml_main, "make_loss_fn", make_loss_fn)


def update_altered(monkeypatch):
    """The step's answer, the new dense parameters, altered where it is
    produced: the optimizer applies its update twice."""
    real = port.DenseAdagrad.step

    def step(self):
        real(self)
        real(self)
    monkeypatch.setattr(port.DenseAdagrad, "step", step)


FAULTS = [state_unchanged, state_unchanged_after_warm_up, half_batch,
          update_altered]


def _run(cell):
    result, code = run.run_cell(cell, SEED, 0.5, False, torch.device("cpu"))
    assert code == 0
    return result


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = _run(small_cell(workload))
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_examples_per_s",
                                      "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_correct_false(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(small_cell(workload))
    assert not result["correct"], result["check"]
    if fault is state_unchanged_after_warm_up:
        first = [n for n, v in result["check"].items()
                 if not n.startswith("late_") and n != "failed_steps"]
        assert all(result["check"][n]["value"] <= result["check"][n]["limit"]
                   for n in first), result["check"]


def test_bce_of_the_port_is_the_mean_the_fault_halves():
    logits = torch.tensor([0.5, -1.0, 2.0, 0.0])
    y = torch.tensor([1.0, 0.0, 1.0, 0.0])

    class M:
        def __call__(self, batch):
            return logits

    per = (torch.clamp(logits, min=0.0) - logits * y
           + torch.log1p(torch.exp(-torch.abs(logits))))
    assert float(bce_loss(M(), {"label": y})) == pytest.approx(
        float(per.mean()))


def test_result_line_stays_strict_json():
    import json
    import math

    line = json.dumps(run.finite({"check": {"loss_gap": {
        "value": math.inf, "limit": 1e-4}}, "losses": [math.nan, 0.5]}),
        allow_nan=False)
    value = json.loads(line)["check"]["loss_gap"]["value"]
    assert value > 1e300
