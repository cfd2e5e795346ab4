"""keras_rs_tpu_torch and chip_smoke.py import neither JAX, optax,
orbax nor the JAX package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import keras_rs_tpu_torch

BLOCKED = ("jax", "jaxlib", "optax", "orbax", "keras_rs_tpu")

_SCRIPT = """
import importlib, sys
blocked = {blocked!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in blocked:
    sys.modules.pop(name, None)
for name in {modules!r}:
    importlib.import_module(name)
import runpy
runpy.run_path("chip_smoke.py", run_name="chip_smoke")  # defines, no run
leaked = sorted(m for m in sys.modules if m.split(".")[0] in blocked)
assert not leaked, leaked
print("imported", len({modules!r}))
"""


def _all_modules():
    pkg_dir = Path(keras_rs_tpu_torch.__file__).parent
    return ["keras_rs_tpu_torch"] + [
        m.name
        for m in pkgutil.walk_packages([str(pkg_dir)], "keras_rs_tpu_torch.")
    ]


def test_port_imports_without_jax():
    modules = _all_modules()
    assert "keras_rs_tpu_torch.ops.row_ops" in modules
    assert "keras_rs_tpu_torch.models.dlrm" in modules
    assert "keras_rs_tpu_torch.ops.flash_attention" in modules
    assert "keras_rs_tpu_torch.models.sasrec" in modules
    for name in ("layers.embedding.device_preprocessing",
                 "layers.embedding.native", "data.criteo", "data.tfrecord",
                 "data.native_io", "data.loader", "data.synthetic",
                 "metrics.classification", "utils.timing",
                 "utils.native_build", "examples.ml_perf.configs",
                 "examples.ml_perf.main", "ops.topk", "ops.pairwise",
                 "ops.ranking", "layers.retrieval.retrieval",
                 "layers.retrieval.hard_negative_mining",
                 "layers.retrieval.remove_accidental_hits",
                 "layers.retrieval.sampling_probability_correction",
                 "layers.retrieval.kmeans_retrieval", "losses.base",
                 "losses.pairwise_losses", "losses.list_mle_loss",
                 "metrics.ranking_metric", "metrics.ranking_metrics",
                 "models.two_tower", "models.ranking_model",
                 "data.ragged", "data.sparse_utils",
                 "data.feature_engineering", "serving",
                 "examples.serving_deployment", "core.initializers",
                 "core.regularizers", "core.serialization",
                 "layers.recurrent",
                 "layers.feature_interaction.dot_interaction",
                 "layers.feature_interaction.feature_cross",
                 "models.gru4rec", "training.checkpoint",
                 "training.trainer", "examples.sequential_retrieval",
                 "examples.dcn", "training.pipelined",
                 "examples.basic_ranking", "examples.basic_retrieval",
                 "examples.listwise_ranking", "examples.multi_task",
                 "examples.deep_recommender", "examples.sas_rec",
                 "parallel", "parallel.mesh", "parallel.multihost",
                 "parallel.collectives", "parallel.sharded_retrieval",
                 "parallel.dryrun", "examples.ann_retrieval",
                 "examples.data_parallel_retrieval", "version",
                 "utils.doc_utils", "bench",
                 "utils.shape_utils", "tools", "tools.weak_scaling"):
        assert f"keras_rs_tpu_torch.{name}" in modules, name
    root = Path(keras_rs_tpu_torch.__file__).parent.parent
    proc = subprocess.run(
        [sys.executable, "-c",
         _SCRIPT.format(blocked=BLOCKED, modules=modules)],
        cwd=root,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(modules)}" in proc.stdout
