# encodermap_tpu_torch/misc/event_file.py
"""TensorBoard event files written without TensorFlow or TensorBoard.

The JAX package writes its events through ``tf.summary``
(``encodermap_tpu/misc/summaries.py:30-88``). The port writes the same
records itself, so ``tensorboard=True`` needs no optional package:

* a file ``events.out.tfevents.<time>.<hostname>.<pid>.<n>`` of TFRecords,
  each ``uint64 length``, ``uint32 masked_crc32c(length)``, the payload and
  ``uint32 masked_crc32c(payload)``;
* a first ``Event`` holding ``file_version = "brain.Event:2"``;
* one ``Event`` a scalar row, its ``Summary`` holding a float32 tensor per
  tag with the ``scalars`` plugin's metadata, as ``tf.summary.scalar``
  writes it;
* one ``Event`` an image, a string tensor ``[width, height, png]`` with the
  ``images`` plugin's metadata, as ``tf.summary.image`` writes it. The PNG
  bytes go in as they are; width and height come from its IHDR chunk.

The protobuf messages (``Event``, ``Summary``, ``TensorProto``,
``SummaryMetadata``) are encoded by hand: a field is a varint key
``(number << 3) | wire_type`` and either a varint or a length-delimited
body. The field numbers and enum values below are TensorBoard's
(``tensorboard/compat/proto``).
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from pathlib import Path
from typing import Union

import numpy as np

__all__ = ["EventFileWriter", "crc32c", "masked_crc32c", "png_size"]

# Event
_EVENT_WALL_TIME, _EVENT_STEP, _EVENT_FILE_VERSION, _EVENT_SUMMARY = 1, 2, 3, 5
# Summary / Summary.Value
_SUMMARY_VALUE = 1
_VALUE_TAG, _VALUE_TENSOR, _VALUE_METADATA = 1, 8, 9
# TensorProto / TensorShapeProto / TensorShapeProto.Dim
_TENSOR_DTYPE, _TENSOR_SHAPE, _TENSOR_CONTENT, _TENSOR_STRING_VAL = 1, 2, 4, 8
_SHAPE_DIM, _DIM_SIZE = 2, 1
# SummaryMetadata / PluginData
_META_PLUGIN_DATA, _META_DATA_CLASS = 1, 4
_PLUGIN_NAME = 1
# enums: tensorflow DataType, tensorboard DataClass
DT_FLOAT, DT_STRING = 1, 7
DATA_CLASS_SCALAR, DATA_CLASS_BLOB_SEQUENCE = 1, 3

_WIRE_VARINT, _WIRE_FIXED64, _WIRE_BYTES = 0, 1, 2
#: the last field of a file name: files opened in one second by one
#: process get distinct names
_FILE_NUMBER = itertools.count(1)


def _crc32c_table() -> list:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven."""
    table = _CRC_TABLE
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15, add a constant."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int_field(field: int, n: int) -> bytes:
    return _key(field, _WIRE_VARINT) + _varint(n)


def _bytes_field(field: int, body: bytes) -> bytes:
    return _key(field, _WIRE_BYTES) + _varint(len(body)) + body


def _metadata(plugin: str, data_class: int) -> bytes:
    plugin_data = _bytes_field(_PLUGIN_NAME, plugin.encode())
    return (_bytes_field(_META_PLUGIN_DATA, plugin_data)
            + _int_field(_META_DATA_CLASS, data_class))


_SCALAR_METADATA = _metadata("scalars", DATA_CLASS_SCALAR)
_IMAGE_METADATA = _metadata("images", DATA_CLASS_BLOB_SEQUENCE)


def _scalar_value(tag: str, value: float) -> bytes:
    tensor = (_int_field(_TENSOR_DTYPE, DT_FLOAT)
              + _bytes_field(_TENSOR_SHAPE, b"")
              + _bytes_field(_TENSOR_CONTENT, np.asarray(value, "<f4").tobytes()))
    return (_bytes_field(_VALUE_TAG, tag.encode())
            + _bytes_field(_VALUE_TENSOR, tensor)
            + _bytes_field(_VALUE_METADATA, _SCALAR_METADATA))


def png_size(png: bytes) -> tuple[int, int]:
    """``(width, height)`` from a PNG's IHDR chunk."""
    if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR":
        raise ValueError("not a PNG file (no signature and IHDR chunk)")
    return struct.unpack(">II", png[16:24])


def _image_value(tag: str, png: bytes) -> bytes:
    width, height = png_size(png)
    shape = _bytes_field(_SHAPE_DIM, _int_field(_DIM_SIZE, 3))
    tensor = (_int_field(_TENSOR_DTYPE, DT_STRING)
              + _bytes_field(_TENSOR_SHAPE, shape)
              + _bytes_field(_TENSOR_STRING_VAL, str(width).encode())
              + _bytes_field(_TENSOR_STRING_VAL, str(height).encode())
              + _bytes_field(_TENSOR_STRING_VAL, png))
    return (_bytes_field(_VALUE_TAG, tag.encode())
            + _bytes_field(_VALUE_TENSOR, tensor)
            + _bytes_field(_VALUE_METADATA, _IMAGE_METADATA))


def _event(wall_time: float, step: int = 0, summary_values: tuple = (),
           file_version: str = "") -> bytes:
    out = _key(_EVENT_WALL_TIME, _WIRE_FIXED64) + struct.pack("<d", wall_time)
    if step:
        out += _int_field(_EVENT_STEP, step)
    if file_version:
        out += _bytes_field(_EVENT_FILE_VERSION, file_version.encode())
    if summary_values:
        summary = b"".join(_bytes_field(_SUMMARY_VALUE, v) for v in summary_values)
        out += _bytes_field(_EVENT_SUMMARY, summary)
    return out


def _record(payload: bytes) -> bytes:
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


class EventFileWriter:
    """Append TensorBoard events to a new file in ``logdir``; each write is
    flushed, so a reader sees every row as soon as it is written."""

    def __init__(self, logdir: Union[str, Path]) -> None:
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        self.path = logdir / (f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
                              f".{os.getpid()}.{next(_FILE_NUMBER)}")
        self._fh = open(self.path, "ab")
        self._write(_event(now, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._fh.write(_record(event))
        self._fh.flush()

    def add_scalars(self, step: int, scalars: dict) -> None:
        """One event at ``step`` holding a float32 scalar per tag."""
        self._write(_event(time.time(), int(step), tuple(
            _scalar_value(tag, float(v)) for tag, v in scalars.items())))

    def add_image(self, step: int, tag: str, png: bytes) -> None:
        """One event at ``step`` holding a PNG image under ``tag``."""
        self._write(_event(time.time(), int(step), (_image_value(tag, bytes(png)),)))

    def close(self) -> None:
        """Close the file."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
