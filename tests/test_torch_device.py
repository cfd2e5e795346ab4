"""The port's modules build on the card unless the caller asks for the
CPU: without `device` they resolve to cuda:0, and where CUDA is absent
they raise instead of falling back to the CPU."""

import pytest
import torch

from keras_rs_tpu_torch.layers import attention, dense
from keras_rs_tpu_torch.layers.embedding import config, embed_reduce
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.layers.feature_interaction import feature_cross
from keras_rs_tpu_torch.models import (
    dlrm,
    ranking_model,
    sasrec,
    two_tower,
)
from keras_rs_tpu_torch.utils.device import resolve_device


def _embedding_features():
    table = config.TableConfig(name="t", vocabulary_size=100,
                               embedding_dim=128, optimizer="adagrad",
                               placement="sharded")
    return {"f": config.FeatureConfig(name="f", table=table,
                                      input_shape=(4, 1),
                                      output_shape=(4, 128))}


CONSTRUCTORS = {
    "DLRMDCNv2": lambda **kw: dlrm.DLRMDCNv2(
        dlrm.DLRMConfig(vocab_sizes=[100, 30000], bottom_mlp=(8, 128),
                        top_mlp=(8, 1), num_dcn_layers=1,
                        dcn_projection_dim=4, global_batch_size=4,
                        table_placement="sharded"), **kw),
    "DistributedEmbedding": lambda **kw: DistributedEmbedding(
        _embedding_features(), **kw),
    "Dense": lambda **kw: dense.Dense(4, 4, **kw),
    "MLP": lambda **kw: dense.MLP(4, (4, 2), **kw),
    "EmbedReduce": lambda **kw: embed_reduce.EmbedReduce(10, 4, **kw),
    "FeatureCross": lambda **kw: feature_cross.FeatureCross(
        4, projection_dim=2, **kw),
    "SASRec": lambda **kw: sasrec.SASRec(10, hidden_dim=8,
                                         max_sequence_length=6, **kw),
    "TransformerBlock": lambda **kw: attention.TransformerBlock(8, 2, 8,
                                                                **kw),
    "TwoTower": lambda **kw: two_tower.TwoTower(10, 10, 4, tower_units=(4,),
                                                **kw),
    "BasicRanking": lambda **kw: ranking_model.BasicRanking(10, 10, 4,
                                                            (4, 1), **kw),
}


def _devices(module):
    return {t.device for t in [*module.parameters(), *module.buffers()]}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_default_device_is_the_card(name):
    build = CONSTRUCTORS[name]
    if torch.cuda.is_available():
        assert _devices(build()) == {torch.device("cuda", 0)}
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert _devices(build(device="cpu")) == {torch.device("cpu")}


def test_resolve_device_passes_an_explicit_device_through():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
