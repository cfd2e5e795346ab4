"""The package version (counterpart of keras_rs_tpu/version.py)."""

__version__ = "0.1.0"


def version() -> str:
    return __version__
