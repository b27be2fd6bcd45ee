"""Dependency-free TensorBoard scalar event writer.

A copy of ``pna_tpu/utils/tb_writer.py`` (which imports no JAX).  The
event-file format is produced directly, so the port needs neither
tensorboard nor tensorboardX:

* a TB events file is a TFRecord stream: for each record,
  ``uint64 length | uint32 masked_crc32c(length) | payload |
  uint32 masked_crc32c(payload)`` (little-endian);
* each payload is a serialized ``tensorflow.Event`` protobuf — only three
  fields matter for scalars: wall_time (field 1, double), step (field 2,
  int64), summary (field 5) holding repeated ``Summary.Value`` with tag
  (field 1, string) and simple_value (field 2, float);
* the first record carries ``file_version = "brain.Event:2"`` (field 3).

Protobuf wire encoding and (masked) CRC32C are hand-rolled below — ~80 lines
replace the tensorboard dependency; files open in any stock TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---- CRC32C (Castagnoli), table-driven ----
_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_POLY if _c & 1 else 0)
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal protobuf wire encoding ----

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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack('<d', v)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack('<f', v)


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _scalar_event(step: int, wall_time: float, scalars) -> bytes:
    values = b''.join(
        _bytes(1, _bytes(1, tag.encode()) + _float(2, float(v)))
        for tag, v in scalars)
    return _double(1, wall_time) + _int64(2, step) + _bytes(5, values)


class TBEventWriter:
    """Append-only scalar event file, tensorboardX-add_scalar compatible."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = 'events.out.tfevents.%010d.%s' % (time.time(),
                                                  socket.gethostname())
        self._f = open(os.path.join(logdir, fname), 'ab')
        self._write(_double(1, time.time())
                    + _bytes(3, b'brain.Event:2'))     # file_version header

    def _write(self, payload: bytes) -> None:
        hdr = struct.pack('<Q', len(payload))
        self._f.write(hdr + struct.pack('<I', _masked_crc(hdr)) + payload
                      + struct.pack('<I', _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_scalar_event(step, time.time(), [(tag, value)]))

    def add_scalars(self, step: int, **scalars: float) -> None:
        self._write(_scalar_event(step, time.time(),
                                  list(scalars.items())))

    def close(self) -> None:
        self._f.close()
