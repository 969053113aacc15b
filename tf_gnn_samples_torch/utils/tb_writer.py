"""Dependency-free TensorBoard event-file writer (a copy of
tf_gnn_samples_tpu/utils/tb_writer.py, which the port does not import).

The reference logs scalar summaries through tf.summary FileWriters
(models/sparse_graph_model.py:142-151, 321-326: separate train/valid
writers, per-batch scalars keyed by a cumulative graph counter). This
module reproduces that output format — TFRecord-framed `Event` protocol
buffers readable by TensorBoard — without a TensorFlow dependency, by
hand-encoding the two tiny messages involved:

    Event   { 1: wall_time (double)  2: step (int64)
              3: file_version (string)  5: summary (Summary) }
    Summary { 1: repeated Value { 1: tag (string)
                                  2: simple_value (float) } }

TFRecord framing: u64-LE length, masked CRC32C of the length, payload,
masked CRC32C of the payload (the standard TFRecord layout).
"""

import os
import socket
import struct
import time
from typing import Dict

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; TFRecord uses the "masked" variant.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag_bytes(field: int, value: bytes) -> bytes:  # wiretype 2
    return _varint(field << 3 | 2) + _varint(len(value)) + value


def _tag_double(field: int, value: float) -> bytes:  # wiretype 1
    return _varint(field << 3 | 1) + struct.pack("<d", value)


def _tag_float(field: int, value: float) -> bytes:  # wiretype 5
    return _varint(field << 3 | 5) + struct.pack("<f", value)


def _tag_varint(field: int, value: int) -> bytes:  # wiretype 0
    return _varint(field << 3 | 0) + _varint(value & (2**64 - 1))


def _event(wall_time: float, step: int = 0, file_version: str = "",
           scalars: Dict[str, float] = ()) -> bytes:
    body = _tag_double(1, wall_time)
    if step:
        body += _tag_varint(2, step)
    if file_version:
        body += _tag_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _tag_bytes(1, _tag_bytes(1, tag.encode()) + _tag_float(2, float(v)))
            for tag, v in scalars.items()
        )
        body += _tag_bytes(5, summary)
    return body


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TensorBoardWriter:
    """One `events.out.tfevents.*` file of scalar summaries."""

    def __init__(self, log_dir: str, suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s%s" % (
            int(time.time()), socket.gethostname(), suffix
        )
        self._path = os.path.join(log_dir, name)
        with open(self._path, "wb") as f:
            f.write(_record(_event(time.time(), file_version="brain.Event:2")))

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        with open(self._path, "ab") as f:
            f.write(_record(_event(time.time(), step=step, scalars=scalars)))

    @property
    def path(self) -> str:
        return self._path


class FoldedTensorBoardWriter:
    """Train/valid sub-writers, mirroring the reference's two FileWriters
    (sparse_graph_model.py:321-326: `{dir}/{run}_train` and `_valid`)."""

    def __init__(self, root: str, run_id: str):
        self._writers: Dict[str, TensorBoardWriter] = {}
        self._root = root
        self._run_id = run_id

    def write(self, fold: str, step: int, scalars: Dict[str, float]) -> None:
        writer = self._writers.get(fold)
        if writer is None:
            writer = TensorBoardWriter(
                os.path.join(self._root, "%s_%s" % (self._run_id, fold))
            )
            self._writers[fold] = writer
        writer.add_scalars(step, {k: float(v) for k, v in scalars.items()})
