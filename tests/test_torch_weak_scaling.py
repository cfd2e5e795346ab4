"""The port's weak-scaling communication accounting
(keras_rs_tpu_torch/tools/weak_scaling.py over
parallel/collectives.count_bytes) against the JAX tool
(tools/weak_scaling.py), live: at D = 2 and 4 gloo CPU ranks
(tests/torch_dist_workers.py) each rank's bytes per collective kind of
one training step equal the JAX tool's per-device bytes of its compiled
step, for the f32 exchange and for comm_dtype="bfloat16" (against the
JAX tool's "requested" wire bytes for the embedding exchange, which the
port sends as asked; its executed all-reduce for the dense gradients).
Byte counts are integers: equal. Each is also held to its closed form
(the tool's docstring). The tool's own launcher (`main`, `run_ranks`)
prints what the pool's ranks count.
"""

import json

import numpy as np
import pytest
import torch
import torch_dist_workers as workers
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu_torch.parallel import collectives
from keras_rs_tpu_torch.tools import weak_scaling
from tools import weak_scaling as jax_tool

KINDS = ("all-to-all", "reduce-scatter", "all-gather", "all-reduce")
BL = weak_scaling.PER_DEVICE_BATCH
#: Large-table features, their width, the bucket capacity and the dense
#: parameters of the tool's model (bottom, DCN, top, the two small
#: tables).
F, DIM, C = 2, 64, 2048
DENSE_PARAMS = 338_497


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


_JAX: dict = {}


def jax_measure(D: int, comm_dtype=None) -> dict:
    """The JAX tool's row at D (compiled once per module)."""
    if (D, comm_dtype) not in _JAX:
        _JAX[D, comm_dtype] = jax_tool.measure(D, per_device_batch=BL,
                                               comm_dtype=comm_dtype)
    return _JAX[D, comm_dtype]


@pytest.fixture(scope="module")
def one_rank():
    return weak_scaling.counted_step(0, 1, device="cpu")


def closed_form(D: int, wire_bytes: int) -> dict:
    return {
        "all-to-all": D * 3 * C * 4,
        "reduce-scatter": BL * F * DIM * wire_bytes,
        "all-gather": D * BL * F * DIM * wire_bytes,
        "all-reduce": (DENSE_PARAMS + 1) * 4,
    }


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("comm_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
def test_bytes_per_rank_equal_the_jax_tool(ranks, D, comm_dtype):
    ref = jax_measure(D, comm_dtype)
    executed = ref["per_kind_per_device"]
    requested = ref["requested_per_kind_per_device"]
    want = ({k: executed[k] for k in KINDS} if comm_dtype is None else
            {**{k: requested[k] for k in KINDS},
             # GSPMD inserts the dense all-reduce after the lowering the
             # requested bytes come from: its executed bytes.
             "all-reduce": executed["all-reduce"]})
    got = ranks(D).run("weak_scaling_case", per_device_batch=BL,
                       comm_dtype=comm_dtype)
    wire = 4 if comm_dtype is None else 2
    assert want == closed_form(D, wire)
    for r in got:
        assert {k: r["per_kind"][k] for k in KINDS} == want
        assert r["per_kind"]["broadcast"] == 0
        assert r["flops"] > 0
    assert len({r["loss"] for r in got}) == 1
    assert np.isfinite(got[0]["loss"])


def test_one_rank_sends_nothing(one_rank):
    """At D = 1 the group is the identity: nothing is sent or counted.
    The JAX step keeps one trivial all-gather of 32,768 bytes there (a
    stated difference, ROADMAP C4)."""
    assert one_rank["per_kind"] == dict.fromkeys(collectives.KINDS, 0)
    ref = jax_measure(1)["per_kind_per_device"]
    assert ref["all-gather"] == BL * F * DIM * 4
    assert sum(ref.values()) == ref["all-gather"]


def test_counter_is_off_by_default_and_nests():
    assert collectives._counts is None
    x = torch.ones(8)
    with collectives.count_bytes() as outer:
        collectives.all_reduce(x, None)  # one rank: no collective
        with collectives.count_bytes() as inner:
            collectives._count("all-gather", torch.ones(4,
                                                        dtype=torch.bfloat16))
        collectives._count("all-to-all", torch.ones(3, dtype=torch.int32))
    assert inner == {**dict.fromkeys(collectives.KINDS, 0),
                     "all-gather": 8}
    assert outer == {**dict.fromkeys(collectives.KINDS, 0),
                     "all-to-all": 12}
    assert collectives._counts is None


def test_tool_row_keeps_the_jax_tool_keys(one_rank):
    ref = jax_measure(1)
    row = weak_scaling._row(1, BL, [one_rank])
    assert set(row) == set(ref)
    assert row["n_devices"] == 1 and row["global_batch"] == BL


def test_main_prints_what_the_ranks_count(ranks, one_rank, capsys,
                                          monkeypatch):
    """`python -m keras_rs_tpu_torch.tools.weak_scaling --device cpu`
    through its own spawned ranks, at D = 1 and 2: its JSON line holds
    the bytes per kind that one process and the pool's two ranks count,
    for the f32 and the bf16 exchange."""
    monkeypatch.setattr(weak_scaling, "COUNTS", (1, 2))
    out = weak_scaling.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    for key, comm_dtype in (("weak_scaling_float32", None),
                            ("weak_scaling_comm_bfloat16", "bfloat16")):
        one, two = out[key]
        assert (one["n_devices"], two["n_devices"]) == (1, 2)
        if comm_dtype is None:
            assert one["per_kind_per_device"] == one_rank["per_kind"]
        pool = ranks(2).run("weak_scaling_case", per_device_batch=BL,
                            comm_dtype=comm_dtype)
        assert two["per_kind_per_device"] == pool[0]["per_kind"]
        assert two["collective_bytes_per_device"] == sum(
            pool[0]["per_kind"].values())


def test_tool_runs_on_the_card_unless_asked(monkeypatch):
    """Without CUDA the tool raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        weak_scaling.main([])
    with pytest.raises(RuntimeError, match="No CUDA device"):
        weak_scaling.counted_step(0, 1)
