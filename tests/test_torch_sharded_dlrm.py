"""The port's DLRM-DCNv2 data parallel over D = 2 gloo CPU ranks
(tests/torch_dist_workers.py) against the JAX package's on a two-device
mesh, and the ml_perf entry point at WORLD_SIZE = 2 against one process.

Every rank builds the model from the same generator seed, so the dense
replicas start equal (held below, bit for bit) and the logical tables are
those of one device. Bounds, f32 dense stack (compute_dtype None): the
losses of 3 steps, the dense parameters and the tables after them within
1e-5, as tests/test_torch_dlrm.py holds one device (summation order: the
gradient all_reduce and the lookup's reduce-scatter add in another
order). The entry point's smoke run at two ranks against one process:
the last loss within 1e-4 and the AUC within 2e-3 (the data-parallel
steps sum in another order than one device's, over 20 steps; the AUC is
thresholded at 512 points).
"""

import jax
import numpy as np
import pytest
import torch_dist_workers as workers
from torch_parity import (
    B,
    LR,
    MULTI_HOT,
    VOCAB,
    dlrm_config_kwargs,
    jax_dlrm_params,
    train_jax,
)

from keras_rs_tpu.models import dlrm as jax_dlrm
from keras_rs_tpu.parallel import mesh as jmesh
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.examples.ml_perf import main as mlperf

F32 = dict(compute_dtype=None, dense_output_dtype="float32")


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


def _batch(seed):
    return synthetic.criteo_like_batch(
        B, vocab_sizes=VOCAB, multi_hot_sizes=MULTI_HOT, seed=seed)


def test_dlrm_steps_at_two_ranks_match_jax(ranks):
    D = 2
    kw = dlrm_config_kwargs(**F32)
    jmodel = jax_dlrm.DLRMDCNv2(jax_dlrm.DLRMConfig(**kw),
                                key=jax.random.key(4),
                                mesh=jmesh.create_mesh(jax.devices()[:D]))
    assert jmodel.embedding_layer.stacks[0].num_shards == D
    params, tables = jax_dlrm_params(jmodel)
    batches = [_batch(seed=s) for s in (20, 21, 20)]
    j_losses, j_after = train_jax(jmodel, LR, batches)
    got = ranks(D).run("dlrm_case", config=kw, params=params,
                       tables=tables, batches=batches)
    j_params, j_tables = jax_dlrm_params(j_after)
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["losses"], j_losses, rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        for k, v in out["params"].items():
            np.testing.assert_allclose(v, j_params[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} rank {r}")
        for k, v in out["tables"].items():
            np.testing.assert_allclose(v, j_tables[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} rank {r}")
            assert not np.array_equal(v, tables[k]), k


def test_dense_replicas_start_equal_and_stay_equal(ranks):
    kw = dlrm_config_kwargs(**F32)
    jmodel = jax_dlrm.DLRMDCNv2(jax_dlrm.DLRMConfig(**kw),
                                key=jax.random.key(5),
                                mesh=jmesh.create_mesh(jax.devices()[:2]))
    params, tables = jax_dlrm_params(jmodel)
    got = ranks(2).run("dlrm_case", config=kw, params=params,
                       tables=tables, batches=[_batch(seed=30)], seed=7)
    # Built from one seed: equal before anything is loaded, and after a
    # data-parallel step on different rows.
    for k in got[0]["built"]:
        np.testing.assert_array_equal(got[0]["built"][k],
                                      got[1]["built"][k], err_msg=k)
        np.testing.assert_array_equal(got[0]["params"][k],
                                      got[1]["params"][k], err_msg=k)
    assert got[0]["losses"] == got[1]["losses"]


SMOKE = dict(num_steps=20, num_loader_threads=1, device_preprocessing=True)


def test_mlperf_entry_point_at_two_ranks_matches_one_process(ranks):
    one = mlperf.main("smoke_test", device="cpu", **SMOKE)
    two = ranks(2).run("mlperf_case", overrides=dict(SMOKE))
    for r, res in enumerate(two):
        assert isinstance(res, dict), res
        np.testing.assert_allclose(res["loss"], one["loss"], rtol=1e-4,
                                   atol=1e-4, err_msg=f"rank {r}")
        assert abs(res["auc"] - one["auc"]) < 2e-3, (res, one)
        assert abs(res["accuracy"] - one["accuracy"]) < 2e-3, (res, one)
    assert two[0]["loss"] == two[1]["loss"]
    assert two[0]["auc"] == two[1]["auc"]


def test_mlperf_host_mode_turns_into_device_mode_at_two_ranks(ranks):
    # The host COO needs the global batch: with more than one process
    # the entry point preprocesses on the device, as the JAX one does.
    two = ranks(2).run("mlperf_case", overrides=dict(
        SMOKE, device_preprocessing=False))
    dev = ranks(2).run("mlperf_case", overrides=dict(SMOKE))
    assert [r["loss"] for r in two] == [r["loss"] for r in dev]
