"""Minimal TensorBoard event-file writer (no TensorFlow, no protobuf).

A copy of ``deepgrp_tpu/utils/tb_events.py``: the same file format, byte
for byte.  The reference DeepGRP always writes TensorBoard event files (its
TensorBoard callback, ``training.py:40-45``, and the HPO trial's MCC
summary, ``optimization.py:54,82-88``).  Scalar summaries need a small,
stable part of two on-disk formats:

  * TFRecord framing: ``len(uint64 LE) | masked_crc32c(len) | payload |
    masked_crc32c(payload)``.
  * ``Event`` protobuf: ``wall_time``(1, double), ``step``(2, int64),
    ``file_version``(3, string) or ``summary``(5, message).
  * ``Summary.Value``: ``tag``(1, string), ``simple_value``(2, float).

Both are frozen (TensorBoard reads files written by TF 1.x), so they are
encoded by hand.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (0x82F63B78 ^ (_c >> 1)) if (_c & 1) else (_c >> 1)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_bytes(number: int, payload: bytes) -> bytes:
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def _field_double(number: int, value: float) -> bytes:
    return _varint((number << 3) | 1) + struct.pack("<d", value)


def _field_float(number: int, value: float) -> bytes:
    return _varint((number << 3) | 5) + struct.pack("<f", value)


def _field_varint(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    summary_value = (_field_bytes(1, tag.encode()) +
                     _field_float(2, float(value)))
    summary = _field_bytes(1, summary_value)
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, summary))


class EventFileWriter:
    """Append scalar summaries to a ``events.out.tfevents.*`` file."""

    def __init__(self, logdir: os.PathLike):
        self.logdir = os.fspath(logdir)
        os.makedirs(self.logdir, exist_ok=True)
        name = "events.out.tfevents.{:.0f}.{}.{}".format(
            time.time(), socket.gethostname(), os.getpid())
        self._file = open(os.path.join(self.logdir, name), "ab")
        # Version header event, as TF writes it.
        self._write_record(_field_double(1, time.time()) +
                           _field_bytes(3, b"brain.Event:2"))
        self._file.flush()

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write_record(_scalar_event(
            tag, value, step,
            time.time() if wall_time is None else wall_time))
        self._file.flush()

    def close(self) -> None:
        self._file.close()
