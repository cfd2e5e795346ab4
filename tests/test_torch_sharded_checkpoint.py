"""Checkpoints of state sharded over D > 1 gloo CPU ranks
(training/checkpoint.py; tests/torch_dist_workers.py): one file per
rank beside rank 0's dense file and the marker, restore into the same D
and layout only, and the ml_perf entry point's resume at two ranks.

What is held: a restored state equals the saved one bit for bit (every
parameter and buffer, the dense optimizer), and the next pipelined step
of both is equal; a restore into another D, shard rotation or stacking
raises; a step whose marker or one rank's file is missing is not the
latest step; the entry point's rerun resumes on every rank and ends
where one process's resumed run ends (the last loss within 1e-4, as
tests/test_torch_sharded_dlrm.py holds the entry point at two ranks).
"""

import os

import jax
import numpy as np
import pytest
import torch_dist_workers as workers
from torch_parity import B, MULTI_HOT, VOCAB, dlrm_config_kwargs
from torch_parity import jax_dlrm_params

from keras_rs_tpu.models import dlrm as jax_dlrm
from keras_rs_tpu.parallel import mesh as jmesh
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.training import checkpoint

TABLES = [
    dict(name="big", vocab=4096, dim=16, optimizer="adagrad",
         combiner="mean"),
    dict(name="small", vocab=512, dim=16, optimizer="adagrad"),
    dict(name="other", vocab=300, dim=8, optimizer="sgd"),
]
FEATURES = [
    dict(name="a", table="big", input_shape=(16, 3), output_shape=(16, 16)),
    dict(name="b", table="small", input_shape=(16, 2),
         output_shape=(16, 16)),
    dict(name="c", table="other", input_shape=(16, 1), output_shape=(16, 8)),
]
LAYER = dict(tables=TABLES, features=FEATURES)


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


def test_pipelined_dlrm_round_trip_and_next_step(ranks, tmp_path):
    kw = dlrm_config_kwargs(compute_dtype=None,
                            dense_output_dtype="float32")
    jmodel = jax_dlrm.DLRMDCNv2(jax_dlrm.DLRMConfig(**kw),
                                key=jax.random.key(3),
                                mesh=jmesh.create_mesh(jax.devices()[:2]))
    params, tables = jax_dlrm_params(jmodel)
    raws = [synthetic.criteo_like_batch(B, vocab_sizes=VOCAB,
                                        multi_hot_sizes=MULTI_HOT, seed=s)
            for s in (40, 41, 42, 43)]
    got = ranks(2).run("checkpoint_case", config=kw, params=params,
                       tables=tables, batches=raws,
                       directory=str(tmp_path / "ck"))
    for r, out in enumerate(got):
        # Restored at step 2, then one more step.
        assert out["latest"] == 2 and out["step"] == 3, out
        bad = [k for k, same in out["equal"].items() if not same]
        assert not bad, f"rank {r}: restored state differs in {bad}"
        assert out["next"][0] == out["next"][1]
        assert out["after_equal"]
        assert out["files"] == ["COMPLETE", "dense.pt", "rank0-of-2.pt",
                                "rank1-of-2.pt"]
    assert got[0]["next"] == got[1]["next"]


def test_layer_round_trip_and_refusals(ranks, tmp_path):
    path = str(tmp_path / "layer")
    saved = ranks(2).run("layer_checkpoint_case", **LAYER, path=path,
                         save=True, steps=2)
    back = ranks(2).run("layer_checkpoint_case", **LAYER, path=path,
                        save=False, seed=5)
    for s, b in zip(saved, back):
        assert b["steps"] == s["steps"] == [2] * len(s["steps"])
        for x, y in zip(s["local"], b["local"]):
            np.testing.assert_array_equal(x, y)
        for k in s["tables"]:
            np.testing.assert_array_equal(s["tables"][k], b["tables"][k])
    for world, kwargs, what in (
            (4, {}, "ranks (D)"),
            (2, {"shard_rotation": False}, "stack layouts"),
            (2, {"table_stacking": "never"}, "stack layouts"),
            (2, {"table_stacking": [["big"], ["small"]]}, "stack layouts")):
        out = ranks(world).run("layer_checkpoint_case", **LAYER, path=path,
                               save=False, **kwargs)
        for o in out:
            assert "error" in o and what in o["error"], (kwargs, o)
    # A state of one device is not a sharded checkpoint, and back.
    one = workers.layer_checkpoint_case(0, 1, **LAYER, path=path,
                                        save=False)
    assert "sharded checkpoint" in one["error"]
    file_path = str(tmp_path / "one.pt")
    workers.layer_checkpoint_case(0, 1, **LAYER, path=file_path, save=True)
    out = ranks(2).run("layer_checkpoint_case", **LAYER, path=file_path,
                       save=False)
    assert all("one-device checkpoint" in o["error"] for o in out)


def test_incomplete_steps_are_not_latest(ranks, tmp_path):
    directory = str(tmp_path / "manager")
    ranks(2).run("layer_checkpoint_case", **LAYER, path=directory,
                 save=True, steps=3, manager=True)
    mgr = checkpoint.CheckpointManager(directory)
    # max_to_keep=2 pruned step 1 after step 3 was committed.
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(os.path.join(directory, "step_3"))) == [
        "COMPLETE", "dense.pt", "rank0-of-2.pt", "rank1-of-2.pt"]
    os.remove(os.path.join(directory, "step_3", "rank1-of-2.pt"))
    assert mgr.latest_step() == 2
    os.remove(os.path.join(directory, "step_2", "COMPLETE"))
    assert mgr.latest_step() is None
    out = ranks(2).run("layer_checkpoint_case", **LAYER, path=directory,
                       save=False, manager=True)
    assert all("No checkpoint" in o["error"] for o in out)


SMOKE = dict(num_steps=12, num_loader_threads=1, device_preprocessing=True,
             pipeline_embedding=True)


def test_mlperf_pipelined_resume_at_two_ranks(ranks, tmp_path):
    """8 pipelined steps with a checkpoint every 4, then a rerun to 12
    that resumes from step 8 on every rank (and draws the dummy batches
    from the start again, as the JAX entry point does): its last loss
    within 1e-4 of one process's same resumed run, as
    tests/test_torch_sharded_dlrm.py holds the entry point at two
    ranks."""
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf

    one_ck = str(tmp_path / "one")
    mlperf.main("smoke_test", device="cpu", **dict(
        SMOKE, num_steps=8, checkpoint_dir=one_ck, checkpoint_every=4))
    one = mlperf.main("smoke_test", device="cpu", **dict(
        SMOKE, checkpoint_dir=one_ck, checkpoint_every=4))
    ck = str(tmp_path / "two")
    first = ranks(2).run("mlperf_log_case", overrides=dict(
        SMOKE, num_steps=8, checkpoint_dir=ck, checkpoint_every=4))
    assert all("resumed" not in logged for _, logged in first)
    assert checkpoint.CheckpointManager(ck).all_steps() == [4, 8]
    assert sorted(os.listdir(os.path.join(ck, "step_8"))) == [
        "COMPLETE", "dense.pt", "rank0-of-2.pt", "rank1-of-2.pt"]
    resumed = ranks(2).run("mlperf_log_case", overrides=dict(
        SMOKE, checkpoint_dir=ck, checkpoint_every=4))
    for r, (res, logged) in enumerate(resumed):
        assert "resumed from checkpoint step 8" in logged, (r, logged)
        np.testing.assert_allclose(res["loss"], one["loss"], rtol=1e-4,
                                   atol=1e-4, err_msg=f"rank {r}")
    assert resumed[0][0]["loss"] == resumed[1][0]["loss"]
    # The entry point keeps 3.
    assert checkpoint.CheckpointManager(ck).all_steps() == [4, 8, 12]
