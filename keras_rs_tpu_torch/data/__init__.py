from keras_rs_tpu_torch.data.feature_engineering import (
    TextVectorizer,
    Vocabulary,
    bucketize,
    hash_cross,
    hash_strings,
)
from keras_rs_tpu_torch.data.loader import ThreadedDataLoader
from keras_rs_tpu_torch.data.ragged import Ragged

__all__ = [
    "Ragged",
    "TextVectorizer",
    "ThreadedDataLoader",
    "Vocabulary",
    "bucketize",
    "hash_cross",
    "hash_strings",
]
