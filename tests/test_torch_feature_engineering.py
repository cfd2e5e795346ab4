"""keras_rs_tpu_torch.data.feature_engineering against the JAX package's
module: the cases of tests/test_feature_engineering.py, each output
bit-exact (ids and hashes are integers; tolerance 0)."""

import numpy as np
import pytest

from keras_rs_tpu.data import feature_engineering as ref
from keras_rs_tpu_torch.data import feature_engineering as port


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_bucketize():
    got = port.bucketize([1.0, 25.0, 99.0, 10.0, 50.0], [10, 50])
    _same(got, ref.bucketize([1.0, 25.0, 99.0, 10.0, 50.0], [10, 50]))
    np.testing.assert_array_equal(got, [0, 1, 2, 1, 2])


@pytest.mark.parametrize("num_bins", [64, 1 << 20, 2**63 - 25])
def test_hash_cross_bit_exact(num_bins):
    rng = np.random.default_rng(0)
    a = np.arange(1000)
    b = (a * 7) % 13
    c = rng.integers(-(2**40), 2**40, size=1000)  # high 32 bits mixed in
    for feats in ([a, b], [b, a], [a, b, c], [c[:, None], b[None, :10]]):
        _same(port.hash_cross(feats, num_bins),
              ref.hash_cross(feats, num_bins))
    h1 = port.hash_cross([a, b], num_bins=64 if num_bins == 64 else num_bins)
    assert h1.min() >= 0 and h1.max() < num_bins
    if num_bins == 64:
        assert (h1 != port.hash_cross([b, a], 64)).any()
        counts = np.bincount(h1, minlength=64)
        assert counts.max() < 4 * counts.mean()


def test_hash_cross_needs_a_feature():
    with pytest.raises(ValueError, match="at least one"):
        port.hash_cross([], 8)


def test_hash_strings():
    words = ["action", "comedy", "action", "", "日本語", "x" * 300]
    for bins in (100, 1 << 31):
        _same(port.hash_strings(words, bins), ref.hash_strings(words, bins))
    h = port.hash_strings(["action", "comedy", "action"], 100)
    assert h[0] == h[2] and h[0] != h[1]
    assert 0 <= h.min() and h.max() < 100


def test_vocabulary_oov():
    v, r = port.Vocabulary(["a", "b", "c"]), ref.Vocabulary(["a", "b", "c"])
    for tokens in (["b", "zzz", "a"], [["a", "q"], ["c", "b"]]):
        _same(v.lookup(tokens), r.lookup(tokens))
    np.testing.assert_array_equal(v.lookup(["b", "zzz", "a"]), [2, 0, 1])
    assert v.size == r.size == 4


def test_text_vectorizer_padded_output():
    texts = ["The Matrix", "Toy Story", "The Lion King"]
    tv = port.TextVectorizer(output_sequence_length=4).adapt(texts)
    rv = ref.TextVectorizer(output_sequence_length=4).adapt(texts)
    queries = ["the lion king", "matrix unknownword", ""]
    for got, want in zip(tv(queries), rv(queries)):
        _same(got, want)
    ids, w = tv(["the lion king", "matrix unknownword"])
    assert ids.shape == (2, 4) and w.shape == (2, 4)
    np.testing.assert_array_equal(w[0], [1, 1, 1, 0])
    assert ids[0, 0] == tv.vocab.lookup(["the"])[0]
    assert ids[1, 1] == 0  # OOV


def test_text_vectorizer_vocab_cap():
    # keras semantics: max_tokens caps the VOCABULARY (incl. OOV id 0).
    tv = port.TextVectorizer(max_tokens=3, output_sequence_length=4)
    rv = ref.TextVectorizer(max_tokens=3, output_sequence_length=4)
    tv.adapt(["a b c d e f"])
    rv.adapt(["a b c d e f"])
    assert tv.vocabulary_size == rv.vocabulary_size == 3
    ids, _ = tv(["a b c"])
    _same(ids, rv(["a b c"])[0])
    assert ids[0, 2] == 0  # "c" fell past the cap -> OOV
