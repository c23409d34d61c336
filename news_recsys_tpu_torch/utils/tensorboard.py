"""Dependency-free TensorBoard scalar event writer.

The port's own copy of :mod:`news_recsys_tpu.utils.tensorboard`
(``tests/test_torch_shared.py`` holds its records to the original's).

The reference logs scalars through Lightning's ``TensorBoardLogger``
(``deep/train.py:31-36``). The package does not depend on tensorboard, so
this module writes the TFRecord/Event wire format directly (hand-rolled protobuf
encoding of ``Event{wall_time, step, summary{value{tag, simple_value}}}``
plus the masked-CRC32C record framing) — the files load in standard
TensorBoard. Scalars only, which is all the reference logs.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_string(field: int, s: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(s)) + s


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(step: int, tag: str, value: float, wall_time: Optional[float] = None) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    sval = _pb_string(1, tag.encode()) + _pb_float(2, float(value))
    # Summary: value=1 (repeated message)
    summary = _pb_string(1, sval)
    # Event: wall_time=1 (double), step=2 (int64), summary=5 (message)
    return (_pb_double(1, wall_time if wall_time is not None else time.time())
            + _pb_int64(2, int(step))
            + _pb_string(5, summary))


def _file_version_event() -> bytes:
    # Event.file_version = field 3 (string)
    return _pb_double(1, time.time()) + _pb_string(3, b"brain.Event:2")


class SummaryWriter:
    """Append-only scalar event file: ``events.out.tfevents.<ts>.<host>``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_file_version_event())

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_event(step, tag, value))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
