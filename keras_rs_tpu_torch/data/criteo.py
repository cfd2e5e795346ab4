"""Criteo dataloader: TFRecord files or dummy data.

The port's copy of keras_rs_tpu/data/criteo.py (numpy only: batches are
host arrays, which the consumer moves to the device). With
`process_index` / `process_count` every process reads the same files in
the same seeded order and keeps its rows of each global batch (the JAX
package's per-host slicing, criteo.py:575). Capability parity with the reference's
examples/ml_perf/dataloader.py: 13 dense float features + 26
categorical multi-hot int64 features stored `decode_raw` style (raw
little-endian bytes in a BytesList), a seeded file shuffle per epoch,
and a dummy-data mode (dataloader.py:67-133).
"""

from __future__ import annotations

import glob as globlib
from typing import Iterator, Sequence

import numpy as np

from keras_rs_tpu_torch.data.tfrecord import parse_example, read_tfrecords

NUM_DENSE = 13
NUM_CATEGORICAL = 26


def _ordered_prefetch(pool, items, fn, depth=2):
    """Maps fn over items on `pool`, yielding results IN ORDER with at
    most `depth` in flight."""
    import collections

    pending = collections.deque()
    it = iter(items)
    for _ in range(depth):
        try:
            pending.append(pool.submit(fn, next(it)))
        except StopIteration:
            break
    while pending:
        fut = pending.popleft()
        try:
            pending.append(pool.submit(fn, next(it)))
        except StopIteration:
            pass
        yield fut.result()


class CriteoDataset:
    """Batches of {dense: [B,13] f32, cat_i: [B,mi] i64, label: [B] f32}.

    When `file_pattern` is None, generates dummy data with the right
    shapes.
    """

    def __init__(
        self,
        file_pattern: str | None,
        *,
        global_batch_size: int,
        vocab_sizes: Sequence[int],
        multi_hot_sizes: Sequence[int] | None = None,
        shuffle_seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        dense_key: str = "dense_features",
        label_key: str = "label",
        cat_key_fmt: str = "categorical_feature_{i}",
        file_batch_size: int | None = None,
        dense_keys: Sequence[str] | None = None,
        cat_keys: Sequence[str] | None = None,
    ) -> None:
        """See class docstring.

        `file_batch_size` selects the reference's FILE-BATCHED schema
        (ml_perf/dataloader.py:135-181 + configs/v6e_8_full_dataset.py:
        17-21): one tf.train.Example holds `file_batch_size` logical
        records — label = Int64List[N], each of the 13 dense features a
        FloatList[N] under its own key, each categorical a BytesList of
        N strings of `8 * multi_hot` raw int64 bytes. Default key names
        in that mode mirror the reference ("clicked", "int-feature-1..
        13", "categorical-feature-14..39"); override with `label_key` /
        `dense_keys` / `cat_keys`.

        `process_index` / `process_count` slice each global batch into
        this process's rows (the same shuffle on every process).
        """
        if global_batch_size % process_count:
            raise ValueError(
                "global_batch_size must be divisible by process_count."
            )
        self.process_index = process_index
        self.process_count = process_count
        self.file_batch_size = file_batch_size
        self._pool = None
        self._pool_workers = 0
        if file_batch_size is not None:
            # The fixed path's per-file private arrays come from the
            # reusable heap, not fresh mmaps (see native_io).
            from keras_rs_tpu_torch.data import native_io

            native_io.tune_malloc_for_large_columns()
            n_cat = len(vocab_sizes)
            if label_key == "label":
                label_key = "clicked"
            self.dense_keys = list(
                dense_keys
                if dense_keys is not None
                else [f"int-feature-{i}" for i in range(1, NUM_DENSE + 1)]
            )
            self.cat_keys = list(
                cat_keys
                if cat_keys is not None
                else [
                    f"categorical-feature-{i + NUM_DENSE + 1}"
                    for i in range(n_cat)
                ]
            )
            if len(self.cat_keys) != n_cat:
                raise ValueError(
                    f"cat_keys has {len(self.cat_keys)} entries for "
                    f"{n_cat} vocab_sizes."
                )
        else:
            self.dense_keys = None
            self.cat_keys = None
        self.file_pattern = file_pattern
        self.files = (
            sorted(globlib.glob(file_pattern)) if file_pattern else []
        )
        if file_pattern and not self.files:
            raise FileNotFoundError(file_pattern)
        self.global_batch_size = global_batch_size
        self.vocab_sizes = list(vocab_sizes)
        self.multi_hot_sizes = list(
            multi_hot_sizes or [1] * len(vocab_sizes)
        )
        self.shuffle_seed = shuffle_seed
        self.dense_key = dense_key
        self.label_key = label_key
        self.cat_key_fmt = cat_key_fmt
        # Fixed-width schema learned from the first file the generic
        # native path parsed: (per-key [(kind, cell bytes)], records per
        # file). Later files take native_io.parse_file_fixed, which
        # writes each column straight into its final private array.
        self._fixed_schema: tuple[list[tuple[int, int]], int] | None = (
            None)

    # -- dummy mode ---------------------------------------------------------
    def dummy_batches(
        self,
        num_batches: int,
        seed: int | None = None,
        learnable: bool = True,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Synthetic batches with the right shapes.

        `learnable=True` (default) draws labels from the deterministic
        CTR function in `data.synthetic.ctr_labels` — the same latent
        weights on every host and every batch — so training shows real
        AUC convergence instead of the 0.5 floor that iid random labels
        force (those remain available with learnable=False).
        """
        from keras_rs_tpu_torch.data import synthetic

        rng = np.random.default_rng(
            self.shuffle_seed if seed is None else seed
        )
        B = self.global_batch_size
        for _ in range(num_batches):
            batch = {
                "dense": rng.normal(size=(B, NUM_DENSE)).astype(
                    np.float32
                ),
            }
            for i, (v, m) in enumerate(
                zip(self.vocab_sizes, self.multi_hot_sizes)
            ):
                batch[f"cat_{i}"] = rng.integers(
                    0, v, size=(B, m), dtype=np.int64
                )
            if learnable:
                batch["label"] = synthetic.ctr_labels(
                    batch["dense"], batch, self.vocab_sizes, rng=rng
                )
            else:
                batch["label"] = rng.integers(0, 2, size=(B,)).astype(
                    np.float32
                )
            yield self._host_shard(batch)

    # -- tfrecord mode --------------------------------------------------------
    def _example_to_row(self, payload: bytes) -> dict[str, np.ndarray]:
        return self._parsed_to_row(parse_example(payload))

    def _parsed_to_row(self, ex: dict) -> dict[str, np.ndarray]:
        row: dict[str, np.ndarray] = {}
        dense = ex.get(self.dense_key)
        if isinstance(dense, list):  # decode_raw: bytes of f32
            dense = np.frombuffer(dense[0], dtype="<f4")
        row["dense"] = np.asarray(dense, np.float32)[:NUM_DENSE]
        label = ex.get(self.label_key)
        if isinstance(label, list):
            label = np.frombuffer(label[0], dtype="<i4")
        row["label"] = np.float32(np.asarray(label).reshape(-1)[0])
        for i in range(len(self.vocab_sizes)):
            cat = ex.get(self.cat_key_fmt.format(i=i))
            if isinstance(cat, list):  # decode_raw: bytes of i64
                cat = np.frombuffer(cat[0], dtype="<i8")
            cat = np.asarray(cat, np.int64).reshape(-1)
            m = self.multi_hot_sizes[i]
            if len(cat) < m:
                cat = np.pad(cat, (0, m - len(cat)), mode="edge")
            row[f"cat_{i}"] = cat[:m]
        return row

    def _file_keys(self) -> list[str]:
        if self.file_batch_size is not None:
            return [self.label_key] + self.dense_keys + self.cat_keys
        return [self.dense_key, self.label_key] + [
            self.cat_key_fmt.format(i=i)
            for i in range(len(self.vocab_sizes))
        ]

    def _parse_file_arrays(
        self, path: str, keys: list[str], use_native: bool
    ) -> dict[str, np.ndarray] | None:
        """One file -> the batch-dict column arrays (or None if empty)."""
        if use_native:
            from keras_rs_tpu_torch.data import native_io

            # Steady state of the file-batched schema: once the first
            # file has taught every key's (kind, cell width), one native
            # pass writes each column into its final private array.
            if (self.file_batch_size is not None
                    and self._fixed_schema is not None):
                schema, n_est = self._fixed_schema
                try:
                    res = native_io.parse_file_fixed(path, keys, schema,
                                                     n_est)
                except OSError:
                    res = None
                if res is not None:
                    n, cols = res
                    if not n:
                        return None
                    return self._batched_typed_to_arrays(cols)
                # A deviation or a native failure: drop the schema (the
                # generic path re-learns it from the next conforming
                # file) and go on to the generic path.
                self._fixed_schema = None

            # Column fast path: one native pass per file, then pure
            # array slicing — no per-record Python (data/native_io.py;
            # fixed-width schemas only, which Criteo's decode_raw
            # features are). A native parse error (a corrupt file)
            # raises; a file whose widths vary goes to the Python reader
            # below.
            res = native_io.parse_file_batched(path, keys)
            if res is not None:
                n, cols = res
                if not n:
                    return None
                if self.file_batch_size is not None:
                    out = self._batched_columns_to_arrays(cols)
                    if out is not None:
                        if self._fixed_schema is None:
                            self._fixed_schema = (
                                [(kind, arr.shape[1] * arr.itemsize)
                                 for kind, arr in (cols[k] for k in keys)],
                                n,
                            )
                        return out
                else:
                    return self._columns_to_arrays(cols)
        if self.file_batch_size is not None:
            return self._batched_python_rows(path)
        # Python fallback: materializes the whole file's rows (fine for
        # test-sized files; the native column path holds only compact
        # arrays and is the production route).
        rows = [
            self._example_to_row(payload)
            for payload in read_tfrecords(path)
        ]
        return self._collate(rows) if rows else None

    # -- file-batched schema (reference dataloader.py:135-181) --------------
    def _batched_columns_to_arrays(
        self, cols: dict[str, tuple[int, np.ndarray]]
    ) -> dict[str, np.ndarray] | None:
        """Native columns of the file-batched schema -> flat row arrays.

        Each native row is one proto of `file_batch_size` logical
        records; everything reshapes with zero per-record work.
        Returns None if widths don't match the declared schema (caller
        falls back to the per-proto Python path).
        """
        from keras_rs_tpu_torch.data import native_io

        fbs = self.file_batch_size
        kind, lab = cols[self.label_key]
        if kind != 2 or lab.shape[1] != fbs:
            return None
        out = {"label": lab.reshape(-1).astype(np.float32)}
        dense_cols = []
        for k in self.dense_keys:
            kind, c = cols[k]
            if kind != 1 or c.shape[1] != fbs:
                return None
            dense_cols.append(c)
        # [13, n, fbs] -> [n*fbs, 13]
        out["dense"] = np.ascontiguousarray(
            np.stack(dense_cols, axis=-1).reshape(-1, len(dense_cols)),
            np.float32,
        )
        for i, k in enumerate(self.cat_keys):
            kind, c = cols[k]
            m = self.multi_hot_sizes[i]
            if kind != 0 or c.shape[1] != fbs * m * 8:
                return None
            out[f"cat_{i}"] = (
                native_io.fast_contig(c)
                .view("<i8")
                .reshape(-1, m)
                .astype(np.int64, copy=False)
            )
        return out

    def _batched_typed_to_arrays(
        self, cols: dict[str, tuple[int, np.ndarray]]
    ) -> dict[str, np.ndarray]:
        """Fixed-path typed columns -> flat row arrays.

        `parse_file_fixed` delivered private, contiguous, typed [n,
        elems] columns whose kinds and widths the native pass held to
        the learned schema, so each cat column is a bytes -> i64 view
        and a reshape; only the label cast and the [n * fbs, 13] dense
        interleave allocate.
        """
        _, lab = cols[self.label_key]  # i64 [n, fbs]
        out = {"label": lab.reshape(-1).astype(np.float32)}
        dense_cols = [cols[k][1] for k in self.dense_keys]
        # [n, fbs] x13 -> [n, fbs, 13] (new contiguous) -> [n*fbs, 13]
        out["dense"] = np.stack(dense_cols, axis=-1).reshape(
            -1, len(dense_cols))
        for i, k in enumerate(self.cat_keys):
            _, c = cols[k]  # uint8 [n, fbs * m * 8]
            m = self.multi_hot_sizes[i]
            out[f"cat_{i}"] = c.view("<i8").reshape(-1, m)
        return out

    def _batched_python_rows(
        self, path: str
    ) -> dict[str, np.ndarray] | None:
        """Pure-Python fallback for the file-batched schema."""
        fbs = self.file_batch_size
        parts: list[dict[str, np.ndarray]] = []
        for payload in read_tfrecords(path):
            ex = parse_example(payload)
            lab = np.asarray(ex[self.label_key], np.int64)[:fbs]
            dense = np.stack(
                [
                    np.asarray(ex[k], np.float32)[:fbs]
                    for k in self.dense_keys
                ],
                axis=1,
            )
            part = {
                "label": lab.astype(np.float32),
                "dense": dense,
            }
            for i, k in enumerate(self.cat_keys):
                m = self.multi_hot_sizes[i]
                elems = ex[k]
                blob = (
                    b"".join(bytes(e) for e in elems)
                    if isinstance(elems, list)
                    else bytes(elems)
                )
                part[f"cat_{i}"] = (
                    np.frombuffer(blob, "<i8")
                    .reshape(-1, m)[:fbs]
                    .astype(np.int64)
                )
            parts.append(part)
        if not parts:
            return None
        return {
            k: np.concatenate([p[k] for p in parts])
            for k in parts[0]
        }

    def batches(
        self, epochs: int = 1, file_prefetch: int = 2
    ) -> Iterator[dict[str, np.ndarray]]:
        """Batches of the files, shuffled by file with a seed per epoch.

        `file_prefetch` files are parsed ahead on a thread pool (the
        native reader's C call releases the GIL, so parses genuinely
        overlap) while batches are emitted IN ORDER.
        """
        if not self.files:
            raise ValueError(
                "No files configured; use dummy_batches() instead."
            )
        from keras_rs_tpu_torch.data import native_io

        use_native = native_io.available()
        keys = self._file_keys()
        B = self.global_batch_size
        pool = (
            self._prefetch_pool(max(1, file_prefetch))
            if file_prefetch and len(self.files) > 1
            else None
        )
        for epoch in range(epochs):
            # The same file order for a given seed and epoch.
            rng = np.random.default_rng(self.shuffle_seed + epoch)
            files = list(self.files)
            rng.shuffle(files)
            if pool is not None:
                sources = _ordered_prefetch(
                    pool,
                    files,
                    lambda p: self._parse_file_arrays(
                        p, keys, use_native
                    ),
                    depth=file_prefetch,
                )
            else:
                sources = (
                    self._parse_file_arrays(p, keys, use_native)
                    for p in files
                )
            # Carry of column arrays across file boundaries. Only
            # the BOUNDARY batch is assembled by concatenation —
            # concatenating the pending tail with the whole next
            # file would copy every column of every file once more.
            pending: dict[str, np.ndarray] | None = None
            for file_arrays in sources:
                if file_arrays is None:
                    continue
                lo = 0
                n_rows = len(file_arrays["label"])
                if pending is not None:
                    need = B - len(pending["label"])
                    if n_rows < need:
                        pending = {
                            k: np.concatenate(
                                [pending[k], file_arrays[k]]
                            )
                            for k in file_arrays
                        }
                        continue
                    yield self._host_shard({
                        k: np.concatenate(
                            [pending[k], file_arrays[k][:need]]
                        )
                        for k in file_arrays
                    })
                    lo = need
                    pending = None
                while n_rows - lo >= B:
                    yield self._host_shard({
                        k: v[lo : lo + B]
                        for k, v in file_arrays.items()
                    })
                    lo += B
                pending = (
                    {k: v[lo:] for k, v in file_arrays.items()}
                    if lo < n_rows
                    else None
                )

    def _prefetch_pool(self, workers: int):
        """The dataset's prefetch executor, kept across `batches()`
        calls: a new executor per epoch gives every epoch new threads,
        whose new glibc arenas and empty native_io buffers pay the
        page-fault storm again. Parses in flight when a consumer stops
        finish into private arrays and are dropped. `close()` ends it."""
        import concurrent.futures as cf

        if self._pool is None or self._pool_workers < workers:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool = cf.ThreadPoolExecutor(max_workers=workers)
            self._pool_workers = workers
        return self._pool

    def close(self) -> None:
        """Shuts the prefetch executor down (parses not yet started are
        cancelled); a later `batches()` starts a new one."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            self._pool_workers = 0

    def _columns_to_arrays(
        self, cols: dict[str, tuple[int, np.ndarray]]
    ) -> dict[str, np.ndarray]:
        """Whole-file columns -> the batch dict layout (vectorized
        equivalent of _parsed_to_row over every record at once)."""

        def reinterpret(key: str, dtype: str) -> np.ndarray:
            kind, arr = cols[key]
            if kind == 0:  # decode_raw bytes
                from keras_rs_tpu_torch.data import native_io

                return native_io.fast_contig(arr).view(dtype)
            return arr

        dense = reinterpret(self.dense_key, "<f4")[:, :NUM_DENSE]
        kind, lab = cols[self.label_key]
        if kind == 0:
            lab = np.ascontiguousarray(lab).view("<i4")[:, 0]
        else:
            lab = lab[:, 0]
        out = {
            "dense": np.ascontiguousarray(dense, np.float32),
            "label": lab.astype(np.float32),
        }
        for i, m in enumerate(self.multi_hot_sizes):
            cat = reinterpret(self.cat_key_fmt.format(i=i), "<i8")
            if cat.shape[1] < m:
                cat = np.pad(
                    cat, ((0, 0), (0, m - cat.shape[1])), mode="edge"
                )
            out[f"cat_{i}"] = np.ascontiguousarray(
                cat[:, :m], np.int64
            )
        return out

    def _collate(
        self, rows: list[dict[str, np.ndarray]]
    ) -> dict[str, np.ndarray]:
        out = {
            "dense": np.stack([r["dense"] for r in rows]),
            "label": np.asarray(
                [r["label"] for r in rows], np.float32
            ),
        }
        for i in range(len(self.vocab_sizes)):
            out[f"cat_{i}"] = np.stack([r[f"cat_{i}"] for r in rows])
        return out

    def _host_shard(
        self, batch: dict[str, np.ndarray]
    ) -> dict[str, np.ndarray]:
        """This process's rows of a global batch."""
        if self.process_count == 1:
            return batch
        per_host = self.global_batch_size // self.process_count
        lo = self.process_index * per_host
        return {k: v[lo : lo + per_host] for k, v in batch.items()}


def write_batched_criteo_files(
    directory: str,
    *,
    num_files: int,
    protos_per_file: int,
    file_batch_size: int,
    vocab_sizes: Sequence[int],
    multi_hot_sizes: Sequence[int],
    seed: int = 0,
    learnable: bool = False,
    label_key: str = "clicked",
    dense_keys: Sequence[str] | None = None,
    cat_keys: Sequence[str] | None = None,
) -> list[str]:
    """Writes synthetic Criteo files in the reference's FILE-BATCHED schema.

    Byte-layout parity with the files the reference trains on
    (ml_perf/dataloader.py:135-181: label Int64List[N], 13 per-key
    FloatLists[N], categorical BytesLists of N raw-int64 strings), at
    REAL record size — the loader-benchmark and schema tests read these.
    Returns the file paths.
    """
    import os

    from keras_rs_tpu_torch.data.tfrecord import make_example, write_tfrecord

    n_cat = len(vocab_sizes)
    dense_keys = list(
        dense_keys
        if dense_keys is not None
        else [f"int-feature-{i}" for i in range(1, NUM_DENSE + 1)]
    )
    cat_keys = list(
        cat_keys
        if cat_keys is not None
        else [
            f"categorical-feature-{i + NUM_DENSE + 1}"
            for i in range(n_cat)
        ]
    )
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for f in range(num_files):
        records = []
        for _ in range(protos_per_file):
            feats: dict = {}
            dense = rng.normal(
                size=(file_batch_size, NUM_DENSE)
            ).astype(np.float32)
            cats = {
                f"cat_{i}": rng.integers(
                    0, v, size=(file_batch_size, m), dtype=np.int64
                )
                for i, (v, m) in enumerate(
                    zip(vocab_sizes, multi_hot_sizes)
                )
            }
            if learnable:
                from keras_rs_tpu_torch.data import synthetic

                labels = synthetic.ctr_labels(
                    dense, cats, list(vocab_sizes), rng=rng
                ).astype(np.int64)
            else:
                labels = rng.integers(
                    0, 2, size=(file_batch_size,), dtype=np.int64
                )
            feats[label_key] = labels
            for d, k in enumerate(dense_keys):
                feats[k] = dense[:, d].copy()
            for i, k in enumerate(cat_keys):
                rows = cats[f"cat_{i}"]
                feats[k] = [
                    rows[r].astype("<i8").tobytes()
                    for r in range(file_batch_size)
                ]
            records.append(make_example(feats))
        path = os.path.join(
            directory,
            f"train-{f:05d}-of-{num_files:05d}.tfrecord",
        )
        write_tfrecord(path, records)
        paths.append(path)
    return paths
