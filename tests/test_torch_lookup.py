"""The port's DistributedEmbedding (stacked lookup, D = 1) against the JAX
package's on a one-device mesh: forward activations, then one backward
update through the Overwrite contract, compared on the logical tables
that get_embedding_tables exports.

Tolerance: 1e-6 (f32; the segment-sums add in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch_parity import one_device_mesh

from keras_rs_tpu import training as jax_training
from keras_rs_tpu.layers.embedding import config as jax_config
from keras_rs_tpu.layers.embedding import (
    distributed_embedding as jax_de,
)
from keras_rs_tpu.layers.embedding import optimizers as jax_optimizers
from keras_rs_tpu_torch.layers.embedding import config
from keras_rs_tpu_torch.layers.embedding import distributed_embedding
from keras_rs_tpu_torch.layers.embedding import optimizers

B = 64
LR = 0.05
# Two stacked tables with different combiners (the gains carry the
# divisor fold) and a weighted feature with zero (padding) weights.
TABLES = [("t_a", 2000, 3, "sum"), ("t_b", 1500, 2, "mean")]


def _configs(cfg_mod, placement="sharded"):
    return {
        f"f_{name}": cfg_mod.FeatureConfig(
            name=f"f_{name}",
            table=cfg_mod.TableConfig(
                name=name,
                vocabulary_size=vocab,
                embedding_dim=128,
                optimizer="adagrad",
                combiner=combiner,
                placement=placement,
                max_ids_per_partition=5 * B,
                max_unique_ids_per_partition=5 * B,
            ),
            input_shape=(B, valence),
            output_shape=(B, 128),
        )
        for name, vocab, valence, combiner in TABLES
    }


def _inputs():
    rng = np.random.default_rng(4)
    ids = {
        f"f_{name}": rng.integers(0, vocab, size=(B, valence))
        for name, vocab, valence, _ in TABLES
    }
    w = rng.uniform(0.5, 2.0, size=(B, 2)).astype(np.float32)
    w[rng.random((B, 2)) < 0.25] = 0.0
    weights = {"f_t_b": w}
    cot = {
        f"f_{name}": rng.standard_normal((B, 128)).astype(np.float32)
        for name, _, _, _ in TABLES
    }
    return ids, weights, cot


def _pair(placement="sharded"):
    jcfg = _configs(jax_config, placement)
    tcfg = _configs(config, placement)
    j_opt = jax_optimizers.Adagrad(learning_rate=LR)
    t_opt = optimizers.Adagrad(learning_rate=LR)
    for fc in jcfg.values():
        fc.table.optimizer = j_opt
    for fc in tcfg.values():
        fc.table.optimizer = t_opt
    jlayer = jax_de.DistributedEmbedding(
        jcfg, key=jax.random.key(0), mesh=one_device_mesh()
    )
    tlayer = distributed_embedding.DistributedEmbedding(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu"
    )
    tlayer.set_embedding_tables(
        {k: np.asarray(v) for k, v in jlayer.get_embedding_tables().items()}
    )
    return jlayer, tlayer


def test_forward_and_update_match_jax():
    jlayer, tlayer = _pair()
    assert len(tlayer.stacks) == 1 and tlayer.stacks[0].packed_state
    ids, weights, cot = _inputs()

    jpre = jlayer.preprocess(ids, weights)
    j_acts = jax.jit(lambda m, p: m(p))(jlayer, jpre)
    t_acts = tlayer(tlayer.preprocess(ids, weights))
    assert t_acts.keys() == j_acts.keys()
    for k in j_acts:
        np.testing.assert_allclose(
            t_acts[k].detach().numpy(), np.asarray(j_acts[k]),
            rtol=1e-6, atol=1e-6,
        )

    # One update: loss = sum(acts * cot), so d_acts = cot.
    def jloss(m, pre):
        acts = m(pre)
        return sum(jnp.sum(acts[k] * cot[k]) for k in acts)

    opt = optax.sgd(0.0)  # the layer has no dense parameters
    state = jax_training.create_train_state(jlayer, opt)
    step = jax_training.make_train_step(jloss, opt, donate=False)
    state, _ = step(state, jpre)
    j_tables = state.model.get_embedding_tables()

    before = tlayer.get_embedding_tables()
    sum((t_acts[k] * torch.from_numpy(cot[k])).sum() for k in t_acts
        ).backward()
    t_tables = tlayer.get_embedding_tables()
    for name, t in t_tables.items():
        assert not torch.equal(t, before[name])
        np.testing.assert_allclose(
            t.numpy(), np.asarray(j_tables[name]), rtol=1e-6, atol=1e-6
        )
    assert float(tlayer.stack_state(0)["step"]) == 1.0
    # The whole packed state, accumulator plane and sink row included.
    j_state = state.model.state.value[tlayer.stacks[0].name]["table"]
    np.testing.assert_allclose(
        tlayer.stack_state(0)["table"].numpy(), np.asarray(j_state),
        rtol=1e-6, atol=1e-6,
    )


def test_scoring_under_no_grad_leaves_state_unchanged():
    _, tlayer = _pair()
    ids, weights, _ = _inputs()
    state = tlayer.stack_state(0)["table"].clone()
    with torch.no_grad():
        acts = tlayer(tlayer.preprocess(ids, weights))
    assert all(not a.requires_grad for a in acts.values())
    assert torch.equal(tlayer.stack_state(0)["table"], state)
    assert float(tlayer.stack_state(0)["step"]) == 0.0


def test_auto_placement_is_a_dense_table_on_one_device():
    """"auto" resolves to default_device at D = 1 in both packages: plain
    EmbedReduce tables, looked up from raw (not preprocessed) inputs."""
    jlayer, tlayer = _pair(placement="auto")
    assert not tlayer.stacks and set(tlayer.dense_tables) == {"t_a", "t_b"}
    ids, weights, _ = _inputs()
    j_acts = jlayer(ids, weights)
    t_acts = tlayer(ids, weights)
    for k in j_acts:
        np.testing.assert_allclose(
            t_acts[k].detach().numpy(), np.asarray(j_acts[k]),
            rtol=1e-6, atol=1e-6,
        )
