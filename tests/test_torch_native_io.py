"""The port's native TFRecord reader (data/native_io.py) and the file
path of its CriteoDataset (data/criteo.py) against the JAX package's, on
files of the file-batched Criteo schema written by either package's
`write_batched_criteo_files` (their bytes are equal: test_torch_mlperf),
and the ml_perf entry point trained from such files.

Bounds: every array, record count and loss equal exactly (the same
native source parses the same bytes; the losses come from the same
batches in the same order on the CPU).
"""

import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.data import criteo as jax_criteo
from keras_rs_tpu.data import native_io as jax_native_io
from keras_rs_tpu_torch.data import criteo, native_io
from keras_rs_tpu_torch.examples.ml_perf import configs
from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    make_train_step,
)

SMOKE = configs.smoke_test()
FBS = 40
WRITERS = {"jax": jax_criteo.write_batched_criteo_files,
           "port": criteo.write_batched_criteo_files}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _native():
    if not native_io.available() or not jax_native_io.available():
        pytest.fail("the native TFRecord reader does not build (g++)")


def _files(directory, writer="port", num_files=3, protos=3, seed=1):
    return WRITERS[writer](
        str(directory), num_files=num_files, protos_per_file=protos,
        file_batch_size=FBS, vocab_sizes=SMOKE.vocab_sizes,
        multi_hot_sizes=SMOKE.multi_hot_sizes, seed=seed, learnable=True)


def _dataset(pkg, pattern, **kw):
    return pkg.CriteoDataset(
        pattern, global_batch_size=64, vocab_sizes=SMOKE.vocab_sizes,
        multi_hot_sizes=SMOKE.multi_hot_sizes, file_batch_size=FBS, **kw)


def _keys():
    return _dataset(criteo, None)._file_keys()


def _batched(mod, path, keys):
    """`mod.parse_file_batched`, its kind-0 columns (views into the
    thread's pooled buffer) copied out before the next parse."""
    n, cols = mod.parse_file_batched(path, keys)
    return n, {k: (kind, np.array(a)) for k, (kind, a) in cols.items()}


def _schema(path, keys):
    """(kind, cell bytes) per key and the record count, as CriteoDataset
    learns them from a generic parse."""
    n, cols = _batched(native_io, path, keys)
    return [(kind, a.shape[1] * a.itemsize)
            for kind, a in (cols[k] for k in keys)], n


def _equal_columns(got, want):
    assert got.keys() == want.keys()
    for k, (kind, a) in want.items():
        assert got[k][0] == kind, k
        assert got[k][1].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k][1], a, err_msg=k)


class _CountingLib:
    """The native library, counting calls by function name."""

    def __init__(self, lib):
        self._lib = lib
        self.calls = Counter()

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*args):
            self.calls[name] += 1
            return fn(*args)

        return call


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("n_cap", ["exact", "undersized"])
def test_parse_file_fixed_equals_jax(tmp_path, writer, n_cap):
    """Arrays and record count equal the JAX function's and the generic
    parse's; an undersized n_cap takes the -3 retry at the exact count."""
    path = _files(tmp_path, writer, num_files=1)[0]
    keys = _keys()
    schema, n = _schema(path, keys)
    cap = n if n_cap == "exact" else 1
    lib = _CountingLib(native_io.get_lib())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_io, "get_lib", lambda: lib)
        got_n, got = native_io.parse_file_fixed(path, keys, schema, cap)
    assert lib.calls["tfrec_parse_file_cols"] == (1 if cap == n else 2)
    want_n, want = jax_native_io.parse_file_fixed(path, keys, schema, cap)
    assert got_n == want_n == n == 3
    _equal_columns(got, want)
    _, generic = _batched(native_io, path, keys)
    for k in keys:
        np.testing.assert_array_equal(
            got[k][1].view(np.uint8).reshape(n, -1),
            generic[k][1].view(np.uint8).reshape(n, -1), err_msg=k)
        assert got[k][1].flags.c_contiguous


def test_schema_deviation_falls_back_to_the_same_arrays(tmp_path):
    """A declared width 8 bytes too wide gives None; the dataset then
    drops its schema, reads the file through the generic path into the
    arrays the fixed path gives, and learns the schema again."""
    path = _files(tmp_path, num_files=1)[0]
    keys = _keys()
    schema, n = _schema(path, keys)
    wrong = list(schema)
    wrong[-1] = (wrong[-1][0], wrong[-1][1] + 8)
    assert native_io.parse_file_fixed(path, keys, wrong, n) is None
    assert jax_native_io.parse_file_fixed(path, keys, wrong, n) is None
    ds = _dataset(criteo, path)
    ds._fixed_schema = (wrong, n)
    fallback = ds._parse_file_arrays(path, keys, True)
    assert ds._fixed_schema == (schema, n)
    fixed = ds._parse_file_arrays(path, keys, True)
    ref = _dataset(jax_criteo, path)._parse_file_arrays(path, keys, True)
    for k in ref:
        np.testing.assert_array_equal(fallback[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(fixed[k], ref[k], err_msg=k)
        assert fixed[k].dtype == fallback[k].dtype == ref[k].dtype, k


def test_parse_file_columns_equals_jax_and_survives_a_second_parse(
        tmp_path):
    a, b = _files(tmp_path, num_files=2)
    keys = _keys()
    got = native_io.parse_file_columns(a, keys)
    want = jax_native_io.parse_file_columns(a, keys)

    def same(got, want):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if isinstance(w[k], list):
                    assert bytes(g[k][0]) == bytes(w[k][0]), k
                else:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)

    same(got, want)
    native_io.parse_file_columns(b, keys)
    native_io.parse_file_batched(b, keys)  # the pooled buffers too
    same(got, want)


def test_estimate_cache_parses_later_files_in_one_pass(tmp_path,
                                                       monkeypatch):
    """The first file of a key set takes a sizing pass and a fill pass,
    the second one pass at the learned estimate, and an estimate that
    falls short retries once at the exact sizes: all give the arrays of
    the JAX reader."""
    a, b = _files(tmp_path, num_files=2)
    keys = _keys()
    lib = _CountingLib(native_io.get_lib())
    monkeypatch.setattr(native_io, "get_lib", lambda: lib)
    monkeypatch.setattr(native_io, "_est_cache", {})
    passes = []
    for path in (a, b):
        before = lib.calls["tfrec_parse_file2"]
        _, got = _batched(native_io, path, keys)
        passes.append(lib.calls["tfrec_parse_file2"] - before)
        _, want = _batched(jax_native_io, path, keys)
        _equal_columns(got, want)
    assert passes == [2, 1]
    native_io._est_cache[tuple(keys)] = (1e-3, 1e-6)  # far too small
    before = lib.calls["tfrec_parse_file2"]
    _, got = _batched(native_io, b, keys)
    assert lib.calls["tfrec_parse_file2"] - before == 2
    _equal_columns(got, want)


def test_fast_contig_equals_ascontiguousarray():
    rng = np.random.default_rng(0)
    wide = rng.integers(0, 255, size=(7, 300), dtype=np.uint8)
    for col in (wide[:, 13:133], wide[2:, ::3], wide.view(np.float32)[:, 5:9],
                wide[3], np.asfortranarray(wide), wide[None]):
        got = native_io.fast_contig(col)
        want = np.ascontiguousarray(col)
        assert got.dtype == want.dtype and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
        if col.ndim == 2:
            assert not np.shares_memory(got, wide)


@pytest.mark.parametrize("opt_out", [False, True], ids=["on", "opt_out"])
def test_tune_malloc_is_idempotent_and_honours_opt_out(opt_out):
    """mallopt is process-wide: each case runs in its own interpreter."""
    env = dict(os.environ)
    env.pop("KRT_MALLOC_TUNING", None)
    if opt_out:
        env["KRT_MALLOC_TUNING"] = "0"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-c",
         "from keras_rs_tpu_torch.data import native_io as n\n"
         "print(n.tune_malloc_for_large_columns(),"
         " n.tune_malloc_for_large_columns(), n._malloc_tuned)"],
        env=env, cwd=str(REPO), capture_output=True, text=True,
        timeout=120, check=True).stdout.split()
    assert out == (["False"] * 3 if opt_out else ["True"] * 3)


@pytest.mark.parametrize("file_prefetch", [1, 2])
def test_dataset_batches_equal_jax_over_two_epochs(tmp_path, monkeypatch,
                                                   file_prefetch):
    """4 files of 120 rows in batches of 64 (batches span files), two
    epochs: the port's batches equal the JAX dataset's. With one prefetch
    worker the files parse in order, so every file after the first takes
    the fixed path; the dataset's pool serves every epoch and every
    `batches()` call until `close()`."""
    _files(tmp_path, num_files=4)
    pattern = str(tmp_path / "train-*.tfrecord")
    fixed_calls = Counter()
    parse_fixed = native_io.parse_file_fixed

    def counted(*args):
        fixed_calls["n"] += 1
        return parse_fixed(*args)

    monkeypatch.setattr(native_io, "parse_file_fixed", counted)
    ds = _dataset(criteo, pattern)
    assert ds._fixed_schema is None
    ours = []
    for b in ds.batches(epochs=2, file_prefetch=file_prefetch):
        ours.append(b)
        if len(ours) == 1:
            pool = ds._pool
            assert ds._fixed_schema is not None
    ref = list(_dataset(jax_criteo, pattern).batches(
        epochs=2, file_prefetch=file_prefetch))
    assert len(ours) == len(ref) == 2 * (4 * 3 * FBS // 64)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if file_prefetch == 1:
        assert fixed_calls["n"] == 2 * 4 - 1
    else:  # the first two files may both parse before a schema exists
        assert fixed_calls["n"] >= 2 * 4 - 2
    assert ds._pool is pool
    next(ds.batches(epochs=1, file_prefetch=file_prefetch))
    assert ds._pool is pool
    ds.close()
    assert ds._pool is None
    again = next(ds.batches(epochs=1, file_prefetch=file_prefetch))
    assert ds._pool is not None and ds._pool is not pool
    for k in again:
        np.testing.assert_array_equal(again[k], ours[0][k], err_msg=k)
    ds.close()


def test_main_trains_from_files_like_batches_fed_by_hand(tmp_path):
    """main("smoke_test") over files of the file-batched schema: after
    1, 2 and 3 steps its loss equals that of the same steps over the
    dataset's batches fed by hand, from the same initial weights."""
    fbs = 256
    criteo.write_batched_criteo_files(
        str(tmp_path), num_files=3, protos_per_file=2, file_batch_size=fbs,
        vocab_sizes=SMOKE.vocab_sizes,
        multi_hot_sizes=SMOKE.multi_hot_sizes, seed=4, learnable=True)
    pattern = str(tmp_path / "train-*.tfrecord")
    ds = criteo.CriteoDataset(
        pattern, global_batch_size=SMOKE.global_batch_size,
        vocab_sizes=SMOKE.vocab_sizes,
        multi_hot_sizes=SMOKE.multi_hot_sizes, file_batch_size=fbs)
    it = ds.batches(epochs=1)
    batches = [next(it) for _ in range(3)]
    ds.close()
    model = mlperf.build_model(SMOKE, torch.device("cpu"))
    step = make_train_step(model, mlperf.make_loss_fn(False),
                           DenseAdagrad(model.parameters(),
                                        SMOKE.learning_rate))
    by_hand = [float(step(model.preprocess(b))) for b in batches]
    finals = [mlperf.main("smoke_test", device="cpu", num_steps=n,
                          num_loader_threads=1, file_pattern=pattern,
                          file_batch_size=fbs)["loss"]
              for n in (1, 2, 3)]
    assert finals == by_hand
    assert by_hand[0] != by_hand[1]
