"""The port's ml_perf entry point (keras_rs_tpu_torch/examples/ml_perf/),
its data stack (data/criteo.py, tfrecord.py, native_io.py, loader.py)
and its metrics (metrics/classification.py) on the CPU, against the JAX
package's where both exist.

Bounds: config values, TFRecord arrays and the CPU host / device-mode
losses equal exactly (the COO arrays of the two modes are bit-exact and
the CPU sums in one order); AUC and BinaryAccuracy within 1e-6 of the
JAX metrics (f32 count sums in another order); the learnable dummy data
gives AUC > 0.60 after 300 smoke steps, the JAX test's gate.
"""

import dataclasses
import os
import tempfile
import threading

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from examples.ml_perf import configs as jax_configs
from keras_rs_tpu.data import criteo as jax_criteo
from keras_rs_tpu.data import tfrecord as jax_tfrecord
from keras_rs_tpu.metrics import AUC as JaxAUC
from keras_rs_tpu.metrics import BinaryAccuracy as JaxBinaryAccuracy
from keras_rs_tpu_torch.data import criteo, native_io
from keras_rs_tpu_torch.data.loader import ThreadedDataLoader
from keras_rs_tpu_torch.examples.ml_perf import configs
from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
from keras_rs_tpu_torch.metrics.classification import AUC, BinaryAccuracy
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    make_train_step,
)
from keras_rs_tpu_torch.utils import timing

SMOKE = configs.smoke_test()


def test_configs_match_jax():
    assert list(configs.CONFIGS) == list(jax_configs.CONFIGS)
    assert configs.CRITEO_VOCAB_SIZES == jax_configs.CRITEO_VOCAB_SIZES
    assert (configs.CRITEO_MULTI_HOT_SIZES
            == jax_configs.CRITEO_MULTI_HOT_SIZES)
    for name in configs.CONFIGS:
        ours = dataclasses.asdict(configs.CONFIGS[name]())
        ref = dataclasses.asdict(jax_configs.CONFIGS[name]())
        # The JAX default is a fixed /tmp path; the port's None resolves
        # under TMPDIR (main.profile_dir).
        assert ours.pop("profile_dir") is None
        assert ref.pop("profile_dir") == "/tmp/keras_rs_tpu_profile"
        assert ours == ref, name
    c = configs.CONFIGS["v6e_32_full_dataset"](val_file_pattern="v/*")
    assert c.val_file_pattern == "v/*" and c.num_steps == 28_000


def test_capacities_are_the_worst_case():
    large = sum(m for v, m in zip(SMOKE.vocab_sizes, SMOKE.multi_hot_sizes)
                if v >= SMOKE.embedding_threshold)
    assert mlperf.capacities(SMOKE) == (512 * large, 512 * large)
    full = configs.full_criteo()
    assert mlperf.capacities(full) == (2_818_048, 2_818_048)


@pytest.mark.parametrize("device_preprocessing", [False, True],
                         ids=["host", "device"])
def test_smoke_main_runs_on_the_cpu(device_preprocessing):
    r = mlperf.main("smoke_test", device="cpu",
                    device_preprocessing=device_preprocessing, num_steps=5,
                    eval_every=4)
    assert set(r) == {"loss", "throughput", "accuracy", "auc", "auc_curve",
                      "capacities"}
    assert np.isfinite(r["loss"]) and r["throughput"] > 0
    assert 0.0 <= r["auc"] <= 1.0 and 0.0 <= r["accuracy"] <= 1.0
    assert [p["step"] for p in r["auc_curve"]] == [4]


def test_host_and_device_modes_give_equal_losses():
    """Three steps on the same dummy batches from the same weights: the
    COO arrays of the two modes are bit-exact, so the losses are equal.
    Through main as well (one loader thread keeps the batch order)."""
    batches = list(criteo.CriteoDataset(
        None, global_batch_size=SMOKE.global_batch_size,
        vocab_sizes=SMOKE.vocab_sizes,
        multi_hot_sizes=SMOKE.multi_hot_sizes).dummy_batches(3))
    losses = {}
    for device_preprocessing in (False, True):
        model = mlperf.build_model(SMOKE, torch.device("cpu"))
        step = make_train_step(
            model, mlperf.make_loss_fn(device_preprocessing),
            DenseAdagrad(model.parameters(), SMOKE.learning_rate))
        prepare = (model.to_device if device_preprocessing
                   else model.preprocess)
        losses[device_preprocessing] = [float(step(prepare(b)))
                                        for b in batches]
    assert losses[True] == losses[False]
    assert losses[True][0] != losses[True][1]
    finals = [mlperf.main("smoke_test", device="cpu", num_steps=3,
                          num_loader_threads=1,
                          device_preprocessing=dp)["loss"]
              for dp in (False, True)]
    assert finals[0] == finals[1] == losses[True][-1]


def test_auc_gate_after_300_smoke_steps():
    r = mlperf.main("smoke_test", device="cpu", num_steps=300,
                    device_preprocessing=True)
    assert r["auc"] > 0.60, r


@pytest.mark.parametrize("overrides, item", [
    # More than one process runs the pipelined step and checkpoints of
    # sharded state (both raised before the sharded path's second half
    # was ported); each with the bf16 exchange.
    (dict(pipeline_embedding=True, embedding_comm_dtype="bfloat16"),
     "pipelined"),
    (dict(embedding_comm_dtype="bfloat16", checkpoint_every=2),
     "checkpoint"),
])
def test_unported_options_raise(overrides, item, tmp_path):
    import torch_dist_workers as workers

    from keras_rs_tpu_torch.training import checkpoint

    if "checkpoint_every" in overrides:
        overrides = dict(overrides, checkpoint_dir=str(tmp_path))
    pools = workers.Pools()
    try:
        got = pools(2).run("mlperf_case", overrides=dict(
            overrides, num_steps=4, device_preprocessing=True))
    finally:
        pools.close()
    for res in got:
        assert isinstance(res, dict), (item, res)
        assert np.isfinite(res["loss"]), (item, res)
    assert got[0]["loss"] == got[1]["loss"]
    if item == "checkpoint":
        assert checkpoint.CheckpointManager(str(tmp_path)).all_steps() == [
            2, 4]
    # One process runs both (the exchange dtype has no exchange to cast).
    r = mlperf.main("smoke_test", device="cpu", num_steps=4,
                    **{k: v for k, v in overrides.items()
                       if k not in ("checkpoint_every", "checkpoint_dir")})
    assert np.isfinite(r["loss"])


@pytest.mark.parametrize("device_preprocessing", [False, True],
                         ids=["host", "device"])
def test_pipelined_smoke_main_runs_on_the_cpu(device_preprocessing):
    """--pipeline_embedding in both preprocessing modes; with one loader
    thread (the batch order kept) the two modes' losses are equal, as
    unpipelined, and step 0 is the unpipelined step 0."""
    kw = dict(device="cpu", num_steps=5, num_loader_threads=1,
              device_preprocessing=device_preprocessing)
    r = mlperf.main("smoke_test", pipeline_embedding=True, eval_every=4,
                    **kw)
    assert set(r) == {"loss", "throughput", "accuracy", "auc", "auc_curve",
                      "capacities"}
    assert np.isfinite(r["loss"]) and r["throughput"] > 0
    assert 0.0 <= r["auc"] <= 1.0
    other = mlperf.main("smoke_test", pipeline_embedding=True,
                        **dict(kw, device_preprocessing=not
                               device_preprocessing))
    assert other["loss"] == r["loss"]
    first = [mlperf.main("smoke_test", pipeline_embedding=p,
                         **dict(kw, num_steps=1))["loss"]
             for p in (False, True)]
    assert first[0] == first[1]


def test_pipelined_resume_reprimes(tmp_path):
    """JAX tests/test_examples.py::test_ml_perf_checkpoint_resume_pipelined
    on the port, in subprocesses on the CPU: 6 pipelined steps with a
    checkpoint every 3, then a rerun to 9 logs "resumed from checkpoint
    step 6" and trains 3 finite steps through the re-primed state."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    ck = str(tmp_path / "ck")

    def script(steps):
        return (
            "import logging, math; logging.basicConfig(level=logging.INFO)\n"
            "from keras_rs_tpu_torch.examples.ml_perf.main import main\n"
            f"r = main('smoke_test', device='cpu', num_steps={steps}, "
            f"checkpoint_dir={ck!r}, checkpoint_every=3, "
            "pipeline_embedding=True)\n"
            "assert math.isfinite(r['loss']), r\n"
            "print('RESUME_OK')\n")

    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1"}
    runs = [subprocess.run([sys.executable, "-c", script(n)], cwd=root,
                           capture_output=True, text=True, env=env,
                           timeout=300) for n in (6, 9)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
        assert "RESUME_OK" in r.stdout
    assert "resumed" not in runs[0].stderr + runs[0].stdout
    assert "resumed from checkpoint step 6" in runs[1].stderr + runs[1].stdout
    assert sorted(os.listdir(ck)) == ["step_3.pt", "step_6.pt", "step_9.pt"]


def test_pipelined_resume_continues_the_losses(tmp_path):
    """The pipelined rerun to 9 steps restores step 6 and re-primes its
    prefetch from the resumed loader's first batch (dummy batch 0): its
    final loss equals that of one process that trains 6 pipelined steps,
    re-primes from batch 0 and trains on batches 0-2."""
    from keras_rs_tpu_torch.models.dlrm import bce_loss
    from keras_rs_tpu_torch.training import pipelined

    ck = str(tmp_path / "ck")
    kw = dict(device="cpu", checkpoint_dir=ck, checkpoint_every=6,
              num_loader_threads=1, pipeline_embedding=True)
    mlperf.main("smoke_test", num_steps=6, **kw)
    resumed = mlperf.main("smoke_test", num_steps=9, **kw)
    batches = list(criteo.CriteoDataset(
        None, global_batch_size=SMOKE.global_batch_size,
        vocab_sizes=SMOKE.vocab_sizes,
        multi_hot_sizes=SMOKE.multi_hot_sizes).dummy_batches(6))
    model = mlperf.build_model(SMOKE, torch.device("cpu"))
    opt = DenseAdagrad(model.parameters(), SMOKE.learning_rate)
    embed_fn, get_pre, inject = pipelined.dlrm_pipeline_fns()

    def run(state, seq):
        pre = [model.preprocess(b) for b in seq]
        state.prefetched = pipelined.prime(model, get_pre(pre[0]), embed_fn)
        for t, b in enumerate(pre):
            state, loss = step(state, b, get_pre(pre[min(t + 1,
                                                         len(pre) - 1)]))
        return state, loss

    state = pipelined.create_pipelined_train_state(
        model, opt, get_pre(model.preprocess(batches[0])), embed_fn)
    step = pipelined.make_pipelined_train_step(bce_loss, opt, embed_fn,
                                               get_pre, inject)
    state, _ = run(state, batches)
    state, loss = run(state, batches[:3])
    assert resumed["loss"] == float(loss)
    assert state.step == 9


def test_checkpoint_resume(tmp_path):
    """JAX tests/test_examples.py::test_ml_perf_checkpoint_resume on the
    port, in subprocesses on the CPU: a rerun with the same
    checkpoint_dir resumes from the saved step 6 instead of starting
    over."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    script = (
        "import logging; logging.basicConfig(level=logging.INFO)\n"
        "from keras_rs_tpu_torch.examples.ml_perf.main import main\n"
        f"main('smoke_test', device='cpu', num_steps=6, "
        f"checkpoint_dir={str(tmp_path / 'ck')!r}, checkpoint_every=2)\n"
    )
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1"}
    runs = [subprocess.run([sys.executable, "-c", script], cwd=root,
                           capture_output=True, text=True, env=env,
                           timeout=300) for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed" not in runs[0].stderr + runs[0].stdout
    assert "resumed from checkpoint step 6" in runs[1].stderr + runs[1].stdout
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_2.pt", "step_4.pt", "step_6.pt"]


def test_profile_writes_a_trace(tmp_path):
    r = mlperf.main("smoke_test", device="cpu", num_steps=22,
                    do_profile=True, profile_dir=str(tmp_path / "prof"))
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and np.isfinite(r["loss"])
    assert os.path.getsize(tmp_path / "prof" / traces[0]) > 0


def test_profile_without_a_directory_writes_under_tmpdir(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)  # re-read TMPDIR
    name, kw = mlperf.parse_args(["--config", "smoke_test", "--device",
                                  "cpu", "--num_steps", "22", "--profile"])
    assert "profile_dir" not in kw
    mlperf.main(name, **kw)
    traces = os.listdir(tmp_path / "keras_rs_tpu_profile")
    assert len(traces) == 1
    assert mlperf.parse_args(["--profile_dir", "p"])[1] == dict(
        profile_dir="p")


def test_resumed_run_continues_the_losses(tmp_path):
    """6 steps with a checkpoint, then a rerun to 12 steps: it restores
    step 6 (the dense Adagrad accumulators and the stacked tables, slots
    and step counters) and, drawing the dummy batches from the start
    again, trains on batches 0-5. Its final loss equals that of one
    process that trains 6 steps and then the same 6 batches again."""
    ck = str(tmp_path / "ck")
    mlperf.main("smoke_test", device="cpu", num_steps=6, checkpoint_dir=ck,
                checkpoint_every=6, num_loader_threads=1)
    resumed = mlperf.main("smoke_test", device="cpu", num_steps=12,
                          checkpoint_dir=ck, checkpoint_every=6,
                          num_loader_threads=1)
    assert sorted(os.listdir(ck)) == ["step_12.pt", "step_6.pt"]
    batches = list(criteo.CriteoDataset(
        None, global_batch_size=SMOKE.global_batch_size,
        vocab_sizes=SMOKE.vocab_sizes,
        multi_hot_sizes=SMOKE.multi_hot_sizes).dummy_batches(6))
    model = mlperf.build_model(SMOKE, torch.device("cpu"))
    step = make_train_step(model, mlperf.make_loss_fn(False),
                           DenseAdagrad(model.parameters(),
                                        SMOKE.learning_rate))
    losses = [float(step(model.preprocess(b))) for b in batches + batches]
    assert resumed["loss"] == losses[-1]
    assert float(model.embedding_layer.stack_state(0)["step"]) == 12.0


def test_more_than_one_process_raises(monkeypatch):
    # A rank's default device is cuda:LOCAL_RANK; where it does not exist
    # the entry point raises instead of moving to another device.
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="does not exist|No CUDA"):
        mlperf.main("smoke_test")


def test_cli_flags():
    name, kw = mlperf.parse_args([
        "--config", "full_criteo", "--device", "cpu", "--num_steps", "7",
        "--device_preprocessing", "--honest_timing", "--profile"])
    assert name == "full_criteo"
    assert kw == dict(num_steps=7, do_profile=True,
                      device_preprocessing=True, honest_timing=True,
                      device="cpu")
    assert mlperf.parse_args(["--pipeline_embedding"])[1] == dict(
        pipeline_embedding=True)


def test_step_time_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.measure_step_time(lambda b: None, None)


# --- data stack -------------------------------------------------------------


def _per_record_files(tmp_path, n_files=2, n_rec=150):
    """The one-record-per-Example schema (raw little-endian bytes)."""
    rng = np.random.default_rng(0)
    for f in range(n_files):
        records = []
        for _ in range(n_rec):
            feats = {
                "label": np.asarray([rng.integers(0, 2)], "<i4").tobytes(),
                "dense_features": rng.normal(size=13).astype("<f4")
                .tobytes(),
            }
            for i, (v, m) in enumerate(zip(SMOKE.vocab_sizes,
                                           SMOKE.multi_hot_sizes)):
                feats[f"categorical_feature_{i}"] = rng.integers(
                    0, v, size=m).astype("<i8").tobytes()
            records.append(jax_tfrecord.make_example(feats))
        jax_tfrecord.write_tfrecord(str(tmp_path / f"d{f}.tfrecord"),
                                    records)
    return str(tmp_path / "d*.tfrecord")


@pytest.mark.parametrize("schema", ["per_record", "file_batched"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_criteo_files_read_like_jax(tmp_path, monkeypatch, schema, native):
    """Files written by the test, read by the JAX CriteoDataset and the
    port's (native column reader or the Python one) into equal arrays."""
    kw = dict(global_batch_size=64, vocab_sizes=SMOKE.vocab_sizes,
              multi_hot_sizes=SMOKE.multi_hot_sizes)
    if schema == "per_record":
        pattern = _per_record_files(tmp_path)
    else:
        criteo.write_batched_criteo_files(
            str(tmp_path), num_files=3, protos_per_file=2,
            file_batch_size=40, vocab_sizes=SMOKE.vocab_sizes,
            multi_hot_sizes=SMOKE.multi_hot_sizes, seed=1, learnable=True)
        pattern = str(tmp_path / "train-*.tfrecord")
        kw["file_batch_size"] = 40
    if not native:
        monkeypatch.setattr(native_io, "available", lambda: False)
    ours = list(criteo.CriteoDataset(pattern, **kw).batches(epochs=2))
    ref = list(jax_criteo.CriteoDataset(pattern, **kw).batches(epochs=2))
    assert len(ours) == len(ref) >= 4
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_written_files_match_jax_writer(tmp_path):
    kw = dict(num_files=2, protos_per_file=2, file_batch_size=16,
              vocab_sizes=SMOKE.vocab_sizes,
              multi_hot_sizes=SMOKE.multi_hot_sizes, seed=3,
              learnable=True)
    ours = criteo.write_batched_criteo_files(str(tmp_path / "a"), **kw)
    ref = jax_criteo.write_batched_criteo_files(str(tmp_path / "b"), **kw)
    for a, b in zip(ours, ref):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_dummy_batches_match_jax():
    kw = dict(global_batch_size=32, vocab_sizes=SMOKE.vocab_sizes,
              multi_hot_sizes=SMOKE.multi_hot_sizes)
    for learnable in (True, False):
        ours = criteo.CriteoDataset(None, **kw).dummy_batches(
            2, seed=5, learnable=learnable)
        ref = jax_criteo.CriteoDataset(None, **kw).dummy_batches(
            2, seed=5, learnable=learnable)
        for a, b in zip(ours, ref):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _movielens_batches(pkg, drop_remainder):
    data = pkg.movielens_like(num_users=30, num_items=20,
                              num_examples=103, seed=4)
    return list(pkg.batches(data, 16, seed=2,
                            drop_remainder=drop_remainder))


SYNTHETIC_CASES = {
    "movielens_like": lambda pkg: pkg.movielens_like(
        num_users=30, num_items=20, num_examples=500, seed=3),
    "batches_drop_remainder": lambda pkg: _movielens_batches(pkg, True),
    "batches_keep_remainder": lambda pkg: _movielens_batches(pkg, False),
    "implicit_feedback": lambda pkg: pkg.implicit_feedback(
        num_users=40, num_items=60, num_events=900, seed=6),
    "implicit_feedback_with_ratings": lambda pkg: pkg.implicit_feedback(
        num_users=40, num_items=60, num_events=900, seed=6,
        with_ratings=True),
    "markov_sessions": lambda pkg: pkg.markov_sessions(
        num_items=50, num_sessions=64, length=7, seed=8),
    "ctr_labels": lambda pkg: pkg.ctr_labels(
        np.random.default_rng(1).normal(size=(64, 13)),
        {f"cat_{i}": np.random.default_rng(2 + i).integers(
            0, v, size=(64, 3)) for i, v in enumerate(SMOKE.vocab_sizes)},
        SMOKE.vocab_sizes, rng=np.random.default_rng(9)),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC_CASES))
def test_synthetic_data_matches_jax(case):
    """The same seed gives the same arrays in both packages."""
    from keras_rs_tpu.data import synthetic as jax_synthetic
    from keras_rs_tpu_torch.data import synthetic

    ours = SYNTHETIC_CASES[case](synthetic)
    ref = SYNTHETIC_CASES[case](jax_synthetic)
    ours, ref = (x if isinstance(x, list) else [x] for x in (ours, ref))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            pairs = [(a[k], b[k], k) for k in b]
        else:
            pairs = [(a, b, case)]
        for x, y, name in pairs:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_native_reader_error_raises(tmp_path):
    """A file the native reader cannot read raises its error; the file
    is not handed to the Python reader instead."""
    if not native_io.available():
        pytest.skip("the native TFRecord reader cannot be built here")
    (path,) = criteo.write_batched_criteo_files(
        str(tmp_path), num_files=1, protos_per_file=2, file_batch_size=8,
        vocab_sizes=SMOKE.vocab_sizes,
        multi_hot_sizes=SMOKE.multi_hot_sizes)
    ds = criteo.CriteoDataset(
        path, global_batch_size=8, vocab_sizes=SMOKE.vocab_sizes,
        multi_hot_sizes=SMOKE.multi_hot_sizes, file_batch_size=8)
    os.remove(path)
    with pytest.raises(OSError, match="native TFRecord"):
        list(ds.batches())


def test_main_trains_on_tfrecord_files(tmp_path):
    train = tmp_path / "train"
    val = tmp_path / "val"
    train.mkdir()
    val.mkdir()
    _per_record_files(train, n_files=1, n_rec=1024)
    _per_record_files(val, n_files=1, n_rec=512)
    r = mlperf.main("smoke_test", device="cpu", num_steps=2,
                    file_pattern=str(train / "*.tfrecord"),
                    val_file_pattern=str(val / "*.tfrecord"))
    assert np.isfinite(r["loss"])


def test_loader_delivers_every_batch_and_transfers_in_the_consumer():
    consumer = threading.current_thread()
    workers, transfers = set(), []

    def preprocess(x):
        workers.add(threading.current_thread())
        return x * 2

    def transfer(x):
        transfers.append(threading.current_thread())
        return x + 1

    got = sorted(ThreadedDataLoader(range(100), preprocess,
                                    transfer_fn=transfer, num_workers=4))
    assert got == [2 * i + 1 for i in range(100)]
    assert consumer not in workers
    assert set(transfers) == {consumer}


def test_loader_stress_delivers_each_batch_once():
    """More workers than cores, a tiny queue and a shortened switch
    interval: every source item comes out exactly once, in bounded
    time."""
    import sys

    out = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        consumer = threading.Thread(target=lambda: out.extend(
            ThreadedDataLoader(range(2000), lambda x: x, num_workers=16,
                               buffer_size=2)))
        consumer.start()
        consumer.join(timeout=120)
        assert not consumer.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert sorted(out) == list(range(2000))


def test_loader_propagates_errors():
    def boom(x):
        if x == 3:
            raise ValueError("bad batch")
        return x

    with pytest.raises(ValueError, match="bad batch"):
        list(ThreadedDataLoader(range(10), boom, num_workers=2))


def test_loader_stop_returns_once_its_workers_have_exited():
    """On an endless source, with workers waiting on a full queue or
    mid-batch, stop() returns with every worker gone: next() then ends,
    and what preprocess_fn holds is freed with the loader."""
    import gc
    import itertools
    import time
    import weakref

    class Held:
        pass

    held = Held()
    alive = weakref.ref(held)

    def preprocess(x, held=held):
        time.sleep(1e-3)
        return x

    loader = ThreadedDataLoader(itertools.count(), preprocess,
                                num_workers=4, buffer_size=2)
    next(loader)
    loader.stop()
    assert not any(w.is_alive() for w in loader._workers)
    with pytest.raises(StopIteration):
        next(loader)
    del loader, preprocess, held
    gc.collect()
    assert alive() is None


# --- metrics ----------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("num_thresholds", [200, 512])
def test_metrics_match_jax(weighted, num_thresholds):
    rng = np.random.default_rng(num_thresholds + weighted)
    ours = (AUC(num_thresholds, device="cpu"), BinaryAccuracy(device="cpu"))
    ref = (JaxAUC(num_thresholds), JaxBinaryAccuracy())
    for _ in range(3):
        labels = (rng.random(1000) < 0.3).astype(np.float32)
        probs = np.clip(labels * 0.3 + rng.random(1000) * 0.7, 0, 1
                        ).astype(np.float32)
        probs[:5] = 0.5  # on the accuracy threshold: negative
        w = rng.random(1000).astype(np.float32) if weighted else None
        for m in ours:
            m.update_state(labels, torch.from_numpy(probs), w)
        for m in ref:
            m.update_state(labels, probs, w)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(float(a.result()), float(b.result()),
                                   rtol=1e-6)
    auc = ours[0]
    auc.reset_state()
    assert float(auc.result_from_state(auc.init_state())) == 0.0
