"""The adapter of the exchange's byte test, named by a test
configuration as its `port_module`: benchmark/tests/ranked.py (with its
faults and records), whose training step counts the bytes of the
collectives it runs (the port's parallel/collectives.count_bytes). When
the trainer stops, rank 0 writes each step's bytes by kind to
`record_to`/bytes.json.
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.tests import ranked
from keras_rs_tpu_torch.parallel import collectives

build = ranked.build
load_weights = ranked.load_weights
first_readings = ranked.first_readings
late_readings = ranked.late_readings


def Trainer(model, config, pool, loss_fn=None):  # noqa: N802 (the interface)
    trainer = ranked.Trainer(model, config, pool, loss_fn)
    step, stop, steps = trainer.step, trainer.stop, []

    def counted(batch):
        with collectives.count_bytes() as counts:
            out = step(batch)
        steps.append(dict(counts))
        return out

    def stopped():
        stop()
        if "record_to" in config and ranked._rank() == 0:
            (Path(config["record_to"]) / "bytes.json").write_text(
                json.dumps(steps))

    trainer.step, trainer.stop = counted, stopped
    return trainer
