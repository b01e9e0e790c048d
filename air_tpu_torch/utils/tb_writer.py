"""Pure-Python TensorBoard event-file writer (no TensorFlow dependency).

The port's own copy of ``air_tpu/utils/tb_writer.py``: the same bytes for
the same events.

The reference relies on TF's C++ summary machinery (``tf.summary.FileWriter``
at reference training.py:140, histogram summaries at reference
air/air_model.py:643-687). This is the TPU-framework equivalent promised in
SURVEY.md §5: a tensorboardX-style writer that hand-encodes the two protos
TensorBoard needs — ``Event`` and ``Summary`` (with ``HistogramProto``) —
and frames them as TFRecords with masked CRC32C checksums.

Format notes (stable since TF 1.x):
  record   = len:uint64le | masked_crc32c(len):uint32le
           | data:bytes   | masked_crc32c(data):uint32le
  Event    = 1: wall_time (double), 2: step (int64),
             3: file_version (string, first record only, "brain.Event:2"),
             5: summary (Summary)
  Summary  = 1: repeated Value;  Value = 1: tag, 2: simple_value (float),
             5: histo (HistogramProto)
  HistogramProto = 1..5: min/max/num/sum/sum_squares (double),
             6: bucket_limit (packed double), 7: bucket (packed double)

Validated in tests/test_tb_writer.py by loading the files with the
``tensorboard`` package's own EventAccumulator; tests/test_torch_tb_writer.py
holds this copy's bytes against the original's.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

# ---- CRC32C (Castagnoli, reflected poly 0x82F63B78) ------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal protobuf wire encoding ----------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF            # two's-complement for negatives
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _f_int64(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(int(value))


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _f_string(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode("utf-8"))


def _f_packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _f_bytes(field, payload)


# ---- proto builders ---------------------------------------------------------

def _histogram_proto(values: np.ndarray, bins: int = 30) -> bytes:
    """HistogramProto from raw values (uniform bins, TB-compatible)."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros(1)
    counts, edges = np.histogram(v, bins=bins)
    # TB convention: bucket_limit[i] is the RIGHT edge of bucket i
    msg = (_f_double(1, float(v.min())) + _f_double(2, float(v.max()))
           + _f_double(3, float(v.size)) + _f_double(4, float(v.sum()))
           + _f_double(5, float(np.square(v).sum()))
           + _f_packed_doubles(6, edges[1:])
           + _f_packed_doubles(7, counts.astype(np.float64)))
    return msg


def _summary_value_scalar(tag: str, value: float) -> bytes:
    return _f_bytes(1, _f_string(1, tag) + _f_float(2, float(value)))


def _summary_value_histo(tag: str, values, bins: int) -> bytes:
    return _f_bytes(1, _f_string(1, tag)
                    + _f_bytes(5, _histogram_proto(values, bins)))


def _event(step: int | None, summary: bytes | None,
           file_version: str | None = None,
           wall_time: float | None = None) -> bytes:
    msg = _f_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        msg += _f_int64(2, step)
    if file_version is not None:
        msg += _f_string(3, file_version)
    if summary is not None:
        msg += _f_bytes(5, summary)
    return msg


# ---- the writer --------------------------------------------------------------

class EventWriter:
    """Append-only TensorBoard event file in ``logdir``.

    Usage::
        w = EventWriter(logdir)
        w.add_scalar("train/loss", 1.23, step=100)
        w.add_histogram("var/lstm_kernel", np_array, step=100)
        w.flush()
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "ab")
        self._write_record(_event(None, None, file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._file.write(header
                         + struct.pack("<I", masked_crc32c(header))
                         + data
                         + struct.pack("<I", masked_crc32c(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_event(step, _summary_value_scalar(tag, value)))

    def add_scalars(self, scalars: dict, step: int):
        """One event carrying every (tag, value) in ``scalars``."""
        summary = b"".join(_summary_value_scalar(t, v)
                           for t, v in scalars.items())
        self._write_record(_event(step, summary))

    def add_histogram(self, tag: str, values, step: int, bins: int = 30):
        self._write_record(_event(
            step, _summary_value_histo(tag, values, bins)))

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.close()
