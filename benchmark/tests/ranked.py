"""The adapter of the multi-rank tests, named by a test configuration as
its `port_module`: port_sharded.py (or the module that the configuration's
`wraps` names), with what a test asks for through keys of the
configuration that only the tests set:

  rank_fault  on rank 1 only: "raise", build raises; "skip_update", the
              packed update (kernel B1's entry in lookup.py) does
              nothing, so that rank's shard of every table keeps its
              rows while the exchange and the rest of the step run;
  record_to   a directory where rank 0 writes the first and the late
              readings (first.json, late.json);
  steps_after_first  steps that first_readings runs after its own, on
              the next pool batches in the loader's order but not through
              the loader (a multiple of the pool's length, so that the
              loader's batches then go on in that order): at D = 1 they
              stand for the run.AGREE_STEPS set-up steps that a run on
              several ranks takes, so that the window starts from the
              same state and the late readings compare.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import torch.distributed as dist

from keras_rs_tpu_torch.examples.ml_perf import main as ml_main


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _wrapped(config: dict):
    return importlib.import_module(config.get("wraps",
                                              "benchmark.port_sharded"))


def _record(config: dict, kind: str, readings) -> None:
    if "record_to" in config and _rank() == 0:
        (Path(config["record_to"]) / f"{kind}.json").write_text(json.dumps(
            {"losses": readings.losses, "grad_norms": readings.grad_norms,
             "change_norms": readings.change_norms}))


def build(config, traffic, seed, device):
    fault = config.get("rank_fault")
    if fault is not None and _rank() == 1:
        if fault == "raise":
            raise RuntimeError("a fault planted in rank 1: it raises")
        if fault != "skip_update":
            raise ValueError(f"unknown fault {fault!r}")
        from keras_rs_tpu_torch.layers.embedding import lookup

        lookup.apply_scatter_row_blocks = lambda *args, **kwargs: None
    return _wrapped(config).build(config, traffic, seed, device)


def load_weights(model, config, seed):
    _wrapped(config).load_weights(model, config, seed)


def Trainer(model, config, pool, loss_fn=None):  # noqa: N802 (the interface)
    return _wrapped(config).Trainer(model, config, pool, loss_fn)


def first_readings(trainer, config, seed, pool, sync):
    out = _wrapped(config).first_readings(trainer, config, seed, pool, sync)
    _record(config, "first", out[0])
    steps = int(config.get("steps_after_first", 0))
    if steps % len(pool):
        raise ValueError(f"{steps} steps over a pool of {len(pool)}")
    for j in range(steps):
        batch = pool[(len(out[0].losses) + j) % len(pool)]
        trainer.step(trainer.model.to_device(ml_main._raw(batch)))
    return out


def late_readings(trainer, config, batches, sync):
    out = _wrapped(config).late_readings(trainer, config, batches, sync)
    _record(config, "late", out[0])
    return out
