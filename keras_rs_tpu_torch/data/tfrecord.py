"""Minimal TFRecord + tf.train.Example reader (no TensorFlow dependency).

The port's copy of keras_rs_tpu/data/tfrecord.py (numpy only). The
Criteo dataloader reads TFRecord files of tf.train.Example protos; this
module parses both formats directly:

  * TFRecord framing: <u64 length> <u32 masked-crc(length)> <payload>
    <u32 masked-crc(payload)> (crcs are not verified here).
  * tf.train.Example wire format: Example{features: Features{feature:
    map<string, Feature>}}, Feature = oneof {BytesList, FloatList,
    Int64List} — a ~100-line protobuf subset parser.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator

import numpy as np


def read_tfrecords(path: str) -> Iterator[bytes]:
    """Yields raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            f.read(4)  # payload crc
            if len(payload) < length:
                return
            yield payload


def write_tfrecord(path: str, records: list[bytes]) -> None:
    """Writes records with zeroed crcs (reader does not verify)."""
    with open(path, "wb") as f:
        for rec in records:
            f.write(struct.pack("<Q", len(rec)))
            f.write(b"\x00\x00\x00\x00")
            f.write(rec)
            f.write(b"\x00\x00\x00\x00")


# --- protobuf wire-format subset -------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yields (field_number, wire_type, value) triples."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"Unsupported wire type {wire}")
        yield field, wire, value


def _parse_packed_varints(buf: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        # Signed int64 two's complement.
        if v >= 1 << 63:
            v -= 1 << 64
        out.append(v)
    return out


def parse_example(payload: bytes) -> dict[str, Any]:
    """Parses a tf.train.Example into {name: np.ndarray | list[bytes]}."""
    out: dict[str, Any] = {}
    for field, _, value in _fields(payload):
        if field != 1:  # Example.features
            continue
        for f2, _, feat_entry in _fields(value):
            if f2 != 1:  # Features.feature (map entry)
                continue
            name = None
            feature_bytes = None
            for f3, _, v3 in _fields(feat_entry):
                if f3 == 1:
                    name = v3.decode()
                elif f3 == 2:
                    feature_bytes = v3
            if name is None or feature_bytes is None:
                continue
            out[name] = _parse_feature(feature_bytes)
    return out


def _parse_feature(buf: bytes) -> Any:
    for field, wire, value in _fields(buf):
        if field == 1:  # BytesList
            items = [
                v for f, _, v in _fields(value) if f == 1
            ]
            return items
        if field == 2:  # FloatList
            floats: list[float] = []
            for f, w, v in _fields(value):
                if f != 1:
                    continue
                if w == 2:  # packed
                    floats.extend(
                        np.frombuffer(v, dtype="<f4").tolist()
                    )
                else:  # fixed32
                    floats.append(struct.unpack("<f", v)[0])
            return np.asarray(floats, np.float32)
        if field == 3:  # Int64List
            ints: list[int] = []
            for f, w, v in _fields(value):
                if f != 1:
                    continue
                if w == 2:  # packed
                    ints.extend(_parse_packed_varints(v))
                else:
                    ints.append(v)
            return np.asarray(ints, np.int64)
    return None


# --- writer helpers (for tests / synthetic data) ----------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def make_example(features: dict[str, Any]) -> bytes:
    """Builds a tf.train.Example payload from numpy arrays / bytes."""
    entries = b""
    for name, value in features.items():
        if isinstance(value, bytes):
            feature = _len_delimited(1, _len_delimited(1, value))
        elif isinstance(value, (list, tuple)) and value and all(
            isinstance(v, bytes) for v in value
        ):
            # Multi-element BytesList (the reference's file-batched
            # Criteo schema stores file_batch_size strings per feature,
            # ml_perf/dataloader.py:150).
            payload = b"".join(_len_delimited(1, v) for v in value)
            feature = _len_delimited(1, payload)
        elif isinstance(value, np.ndarray) and value.dtype == np.float32:
            packed = value.astype("<f4").tobytes()
            feature = _len_delimited(2, _len_delimited(1, packed))
        else:
            arr = np.asarray(value, np.int64)
            packed = b"".join(
                _varint(int(v) & ((1 << 64) - 1)) for v in arr
            )
            feature = _len_delimited(3, _len_delimited(1, packed))
        entry = _len_delimited(1, name.encode()) + _len_delimited(
            2, feature
        )
        entries += _len_delimited(1, entry)
    return _len_delimited(1, entries)
