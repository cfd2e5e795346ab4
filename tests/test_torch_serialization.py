"""The port's serialization registry (core/serialization.py) against the
JAX package's: every class the JAX package registers with `@export` that
the port has is registered under "keras_rs_tpu_torch.<kind>.<Name>" (and
its bare name), gives the JAX class's `get_config()` dict (JAX-only
entries, such as a DistributedEmbedding's mesh settings, left out), and
round-trips through `serialize` / `deserialize`.
"""

import re
from pathlib import Path

import jax
import pytest
import torch_parity  # noqa: F401  (caps torch's threads)

import keras_rs_tpu
from keras_rs_tpu.core import serialization as jser
from keras_rs_tpu.layers.embedding import config as jconfig
from keras_rs_tpu.layers.embedding import distributed_embedding as jde
from keras_rs_tpu.layers.embedding import embed_reduce as jembed
from keras_rs_tpu.layers.feature_interaction import dot_interaction as jdot
from keras_rs_tpu.layers.feature_interaction import feature_cross as jcross
from keras_rs_tpu.layers.retrieval import (
    hard_negative_mining as jhnm,
    kmeans_retrieval as jkm,
    remove_accidental_hits as jrah,
    retrieval as jret,
    sampling_probability_correction as jspc,
)
from keras_rs_tpu.losses import list_mle_loss as jlistmle
from keras_rs_tpu.losses import pairwise_losses as jpair
from keras_rs_tpu.metrics import classification as jcls
from keras_rs_tpu.metrics import ranking_metrics as jrank
from keras_rs_tpu.parallel import mesh as mesh_lib
from keras_rs_tpu_torch.core import initializers as init_lib
from keras_rs_tpu_torch.core import serialization
from keras_rs_tpu_torch.layers.embedding import config
from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.layers.embedding.embed_reduce import EmbedReduce
from keras_rs_tpu_torch.layers.feature_interaction.dot_interaction import (
    DotInteraction,
)
from keras_rs_tpu_torch.layers.feature_interaction.feature_cross import (
    FeatureCross,
)
from keras_rs_tpu_torch.layers.retrieval import (
    hard_negative_mining,
    kmeans_retrieval,
    remove_accidental_hits,
    retrieval,
    sampling_probability_correction,
)
from keras_rs_tpu_torch.losses import list_mle_loss, pairwise_losses
from keras_rs_tpu_torch.metrics import classification, ranking_metrics

KEY = jax.random.key(0)
CPU = {"device": "cpu"}


def _tables(lib, init, opt):
    t1 = lib.TableConfig("t1", 100, 16, initializer="random_uniform",
                         optimizer="adagrad", placement="sharded",
                         max_ids_per_partition=64,
                         max_unique_ids_per_partition=32)
    t2 = lib.TableConfig("t2", 30, 8,
                         initializer=init.RandomNormal(0.0, 0.1),
                         optimizer=opt.Adam(learning_rate=0.02),
                         combiner="sum", placement="default_device")
    return {
        "a": lib.FeatureConfig("a", t1, (8, 3), (8, 16)),
        "b": lib.FeatureConfig("b", t1, (8, 1), (8, 16)),
        "c": lib.FeatureConfig("c", t2, (8, 2), (8, 8)),
    }


def _jax_de():
    from keras_rs_tpu.core import initializers as jinit
    from keras_rs_tpu.layers.embedding import optimizers as jopt
    return jde.DistributedEmbedding(
        _tables(jconfig, jinit, jopt), key=KEY,
        mesh=mesh_lib.create_mesh(jax.devices()[:1]))


# name -> (port object, JAX object, run-time kwargs of deserialize,
#          JAX-only config keys)
CASES = {
    "FeatureCross": (lambda: FeatureCross(8, projection_dim=4, name="x",
                                          device="cpu"),
                     lambda: jcross.FeatureCross(8, key=KEY, projection_dim=4,
                                                 name="x"), CPU, ()),
    "DotInteraction": (lambda: DotInteraction(True, False),
                       lambda: jdot.DotInteraction(True, False), {}, ()),
    "EmbedReduce": (lambda: EmbedReduce(20, 4, combiner="sqrtn", name="e",
                                        device="cpu"),
                    lambda: jembed.EmbedReduce(20, 4, key=KEY,
                                               combiner="sqrtn", name="e"),
                    CPU, ()),
    "QuantizedEmbedReduce": (
        lambda: EmbedReduce(20, 4, device="cpu").quantize_int8("packed"),
        lambda: jembed.EmbedReduce(20, 4, key=KEY).quantize_int8("packed"),
        CPU, ()),
    "DistributedEmbedding": (
        lambda: DistributedEmbedding(_tables(config, init_lib, opt_lib),
                                     device="cpu"),
        _jax_de, CPU, ()),
    "BruteForceRetrieval": (
        lambda: retrieval.BruteForceRetrieval(k=7, return_scores=False),
        lambda: jret.BruteForceRetrieval(k=7, return_scores=False), {}, ()),
    "KMeansRetrieval": (
        lambda: kmeans_retrieval.KMeansRetrieval(
            k=5, num_clusters=16, num_probes=3, quantize="int8", seed=2,
            device="cpu"),
        lambda: jkm.KMeansRetrieval(k=5, num_clusters=16, num_probes=3,
                                    quantize="int8", seed=2), CPU, ()),
    "HardNegativeMining": (
        lambda: hard_negative_mining.HardNegativeMining(3),
        lambda: jhnm.HardNegativeMining(3), {}, ()),
    "RemoveAccidentalHits": (
        lambda: remove_accidental_hits.RemoveAccidentalHits(),
        lambda: jrah.RemoveAccidentalHits(), {}, ()),
    "SamplingProbabilityCorrection": (
        lambda: sampling_probability_correction
        .SamplingProbabilityCorrection(epsilon=1e-4),
        lambda: jspc.SamplingProbabilityCorrection(epsilon=1e-4), {}, ()),
    "ListMLELoss": (lambda: list_mle_loss.ListMLELoss(temperature=0.5),
                    lambda: jlistmle.ListMLELoss(temperature=0.5), {}, ()),
    **{name: (lambda name=name: getattr(pairwise_losses, name)(
                  temperature=2.0, reduction="sum"),
              lambda name=name: getattr(jpair, name)(temperature=2.0,
                                                     reduction="sum"),
              {}, ())
       for name in ("PairwiseHingeLoss", "PairwiseLogisticLoss",
                    "PairwiseSoftZeroOneLoss", "PairwiseMeanSquaredError")},
    **{name: (lambda name=name: getattr(ranking_metrics, name)(
                  k=4, seed=3, name="m", device="cpu"),
              lambda name=name: getattr(jrank, name)(k=4, seed=3, name="m"),
              CPU, ())
       for name in ("DCG", "NDCG", "MeanAveragePrecision",
                    "MeanReciprocalRank", "PrecisionAtK", "RecallAtK")},
    "AUC": (lambda: classification.AUC(64, device="cpu"),
            lambda: jcls.AUC(64), CPU, ()),
    "BinaryAccuracy": (lambda: classification.BinaryAccuracy(0.3,
                                                             device="cpu"),
                       lambda: jcls.BinaryAccuracy(0.3), CPU, ()),
}


def test_every_jax_export_the_port_has_is_registered():
    root = Path(keras_rs_tpu.__file__).parent
    exported = set()
    for path in root.rglob("*.py"):
        exported |= set(re.findall(r'@export\("keras_rs_tpu\.(\w+)\.(\w+)"',
                                   path.read_text()))
    assert {name for _, name in exported} == set(CASES)
    for kind, name in exported:
        cls = serialization.get_registered_class(
            f"keras_rs_tpu_torch.{kind}.{name}")
        assert cls.__name__ == name
        assert serialization.get_registered_class(name) is cls
        assert serialization.get_registered_name(cls) == (
            f"keras_rs_tpu_torch.{kind}.{name}")
        assert jser.get_registered_name(jser.get_registered_class(name)) == (
            f"keras_rs_tpu.{kind}.{name}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_matches_jax_and_round_trips(name):
    ours, theirs, runtime, jax_only = CASES[name]
    obj = ours()
    want = {k: v for k, v in theirs().get_config().items()
            if k not in jax_only}
    assert obj.get_config() == want
    spec = serialization.serialize(obj)
    assert spec["class_name"].startswith("keras_rs_tpu_torch.")
    back = serialization.deserialize(spec, **runtime)
    assert type(back) is type(obj)
    assert back.get_config() == obj.get_config()


def test_unknown_and_none():
    assert serialization.serialize(None) is None
    assert serialization.deserialize(None) is None
    with pytest.raises(ValueError, match="Unknown registered class"):
        serialization.get_registered_class("keras_rs_tpu_torch.layers.Nope")
    with pytest.raises(ValueError, match="Duplicate export path"):
        serialization.export("keras_rs_tpu_torch.layers.FeatureCross")(
            type("Other", (), {}))


def test_table_and_feature_configs_match_jax():
    from keras_rs_tpu.core import initializers as jinit
    from keras_rs_tpu.layers.embedding import optimizers as jopt
    ours = _tables(config, init_lib, opt_lib)
    theirs = _tables(jconfig, jinit, jopt)
    for k in ours:
        assert ours[k].get_config() == theirs[k].get_config()
        back = config.FeatureConfig.from_config(ours[k].get_config())
        assert back.get_config() == ours[k].get_config()
    default = config.TableConfig("d", 10, 4)
    assert default.get_config() == jconfig.TableConfig("d", 10,
                                                       4).get_config()
    assert isinstance(config.TableConfig.from_config(
        default.get_config()).initializer, init_lib.VarianceScaling)
