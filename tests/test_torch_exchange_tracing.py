"""The exchange's spans and counters (parallel/collectives.py under
utils/tracing.py): at D = 2 and 4 gloo CPU ranks
(tests/torch_dist_workers.py), one training step of the weak-scaling
tool's model runs each torch.distributed collective inside one span
"collective.<kind>" whose `bytes` are the bytes `count_bytes()` counts
for that call, and the counter "collective.<kind>_bytes" sums them; a
one-rank group is the identity and opens no span and counts nothing.
"""

import collections

import pytest
import torch_dist_workers as workers
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu_torch.parallel import collectives
from keras_rs_tpu_torch.tools import weak_scaling
from keras_rs_tpu_torch.utils import tracing

BL = 8


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


@pytest.mark.parametrize("D", [2, 4])
def test_one_span_per_collective_with_its_counted_bytes(ranks, D):
    for r in ranks(D).run("traced_exchange_case", per_device_batch=BL):
        spans = collections.Counter(name for name, _, _ in r["spans"])
        span_bytes = collections.Counter()
        for name, n, step in r["spans"]:
            assert step is not None, name  # inside the training step
            span_bytes[name] += n
        for kind in collectives.KINDS:
            name = collectives.SPANS[kind]
            assert spans[name] == r["calls"][kind], kind
            assert span_bytes[name] == r["per_kind"][kind], kind
            assert r["counters"].get(name + "_bytes", 0) == (
                r["per_kind"][kind]), kind
        # The step's exchange: the ids, the activations, the cotangents,
        # the dense gradients and the loss.
        for kind in ("all-to-all", "reduce-scatter", "all-gather"):
            assert r["calls"][kind] >= 1 and r["per_kind"][kind] > 0
        assert r["calls"]["all-reduce"] == 2


def test_one_rank_opens_no_span_and_counts_nothing():
    tracing.reset()
    tracing.enable()
    try:
        out = weak_scaling.counted_step(0, 1, BL, device="cpu")
        names = {s.name for s in tracing.spans()}
        counters = tracing.counters()
    finally:
        tracing.disable()
        tracing.reset()
    assert "step" in names
    assert not any(n.startswith("collective") for n in names)
    assert not any(n.startswith("collective") for n in counters)
    assert out["per_kind"] == dict.fromkeys(collectives.KINDS, 0)
