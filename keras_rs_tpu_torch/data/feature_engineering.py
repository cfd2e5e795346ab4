"""Feature engineering: the FeatureSpace subset recommenders actually use.

Counterpart of keras_rs_tpu/data/feature_engineering.py (numpy only, the
same ids and hashes bit for bit): discretized floats, integer and string
categoricals, hashed feature crosses (64-bit FNV-1a) and a small
TextVectorization. Host-side transforms whose integer ids feed
EmbedReduce / DistributedEmbedding.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

_FNV_PRIME = np.uint64(1099511628211)
_FNV_OFFSET = np.uint64(14695981039346656037)


def bucketize(values, boundaries) -> np.ndarray:
    """Discretization parity: float -> bucket id in [0, len(boundaries)].

    `side="right"` matches keras Discretization / tf Bucketize: a value
    EQUAL to a boundary falls in the upper bucket.
    """
    return np.searchsorted(
        np.asarray(boundaries), np.asarray(values), side="right"
    ).astype(np.int64)


def _fnv_mix(h: np.ndarray, x: np.ndarray) -> np.ndarray:
    # Vectorized FNV-1a over one integer feature column.
    with np.errstate(over="ignore"):
        h = (h ^ x.astype(np.uint64)) * _FNV_PRIME
        h = (h ^ (x.astype(np.uint64) >> np.uint64(32))) * _FNV_PRIME
    return h


def hash_cross(features: Sequence[np.ndarray], num_bins: int) -> np.ndarray:
    """Crossed-feature parity: hash a tuple of int features into bins.

    Equivalent to FeatureSpace.cross(crossing_dim=num_bins): the cross of
    (f1, f2, ...) is a single categorical with `num_bins` hashed values,
    to be embedded by one table.
    """
    if not features:
        raise ValueError("hash_cross needs at least one feature.")
    arrs = [np.asarray(f) for f in features]
    shape = np.broadcast_shapes(*[a.shape for a in arrs])
    h = np.full(shape, _FNV_OFFSET, np.uint64)
    for a in arrs:
        h = _fnv_mix(h, np.broadcast_to(a, shape))
    return (h % np.uint64(num_bins)).astype(np.int64)


def hash_strings(values: Iterable[str], num_bins: int) -> np.ndarray:
    """String hashing (StringLookup-with-hash parity)."""
    vals = list(values)
    out = np.empty(len(vals), np.int64)
    for i, v in enumerate(vals):
        h = _FNV_OFFSET
        for b in str(v).encode("utf-8"):
            with np.errstate(over="ignore"):
                h = (h ^ np.uint64(b)) * _FNV_PRIME
        out[i] = int(h % np.uint64(num_bins))
    return out


class Vocabulary:
    """StringLookup/IntegerLookup parity: adapt a vocabulary, map to ids.

    id 0 is reserved for OOV (mask/“[UNK]”), like keras lookup layers.
    """

    def __init__(self, tokens: Iterable = ()) -> None:
        self._index: dict = {}
        self.adapt(tokens)

    def adapt(self, tokens: Iterable) -> "Vocabulary":
        for t in tokens:
            if t not in self._index:
                self._index[t] = len(self._index) + 1  # 0 = OOV
        return self

    @property
    def size(self) -> int:
        return len(self._index) + 1

    def lookup(self, tokens) -> np.ndarray:
        flat = np.asarray(tokens, dtype=object).reshape(-1)
        out = np.asarray(
            [self._index.get(t, 0) for t in flat], np.int64
        )
        return out.reshape(np.shape(tokens))


class TextVectorizer:
    """TextVectorization-lite: whitespace-split, vocab lookup, pad/trunc.

    Parameter names FOLLOW keras.layers.TextVectorization:
    `max_tokens` caps the VOCABULARY size (0/None = unbounded) and
    `output_sequence_length` is the padded width. Produces
    (ids [B, output_sequence_length], weights [...]) — the padded ragged
    form every embedding layer here consumes.
    """

    def __init__(
        self,
        max_tokens: int | None = None,
        output_sequence_length: int = 16,
    ) -> None:
        self.max_tokens = max_tokens
        self.output_sequence_length = output_sequence_length
        self.vocab = Vocabulary()

    @staticmethod
    def _split(text: str) -> list[str]:
        return str(text).lower().split()

    def adapt(self, texts: Iterable[str]) -> "TextVectorizer":
        for t in texts:
            for tok in self._split(t):
                if (
                    self.max_tokens is not None
                    and self.vocab.size >= self.max_tokens
                ):
                    break
                self.vocab.adapt([tok])
        return self

    @property
    def vocabulary_size(self) -> int:
        return self.vocab.size

    def __call__(self, texts: Sequence[str]):
        L = self.output_sequence_length
        B = len(texts)
        ids = np.zeros((B, L), np.int64)
        weights = np.zeros((B, L), np.float32)
        for i, t in enumerate(texts):
            toks = self._split(t)[:L]
            if toks:
                ids[i, : len(toks)] = self.vocab.lookup(toks)
                weights[i, : len(toks)] = 1.0
        return ids, weights
