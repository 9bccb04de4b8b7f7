"""Writer of TensorFlow event files, in pure Python (the port's copy of the
writer half of the JAX package's ``utils/tfevents.py``).

``fit`` writes its validation scalars into an ``events.out.tfevents.*``
file beside ``summaries.jsonl``, which tensorflow's ``summary_iterator``
(and so the reference's ``get_summary`` and notebooks) read directly.

- TFRecord framing (tensorflow/core/lib/io/record_writer.cc):
  [uint64 length][uint32 masked-crc32c(length)][data][uint32 masked-crc32c
  (data)].
- Event proto (tensorflow/core/util/event.proto): wall_time(1, double),
  step(2, int64), summary(5, message); Summary.value(1) is a repeated
  message with tag(1, string) and simple_value(2, float).

With the same ``wall_time`` the bytes equal the JAX package's writer's.
"""

import os
import socket
import struct
import time


def _make_crc32c_table():
    # Castagnoli polynomial, reflected (0x82F63B78): the CRC TFRecord uses
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def _crc32c(data):
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC32C_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(value):
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _ld(field, payload):
    """Length-delimited protobuf field."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _frame_record(payload):
    """TFRecord framing: length + masked CRC of length + data + CRC."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


def encode_scalar_event(wall_time, step, scalars):
    """One framed TFRecord holding an Event with simple_value summaries.

    Args:
        scalars: dict {tag: float}.
    """
    summary = b"".join(
        _ld(1, _ld(1, tag.encode("utf8"))
            + _varint(2 << 3 | 5) + struct.pack("<f", float(value)))
        for tag, value in scalars.items())
    event = (_varint(1 << 3 | 1) + struct.pack("<d", float(wall_time))
             + _varint(2 << 3 | 0) + _varint(int(step))
             + _ld(5, summary))
    return _frame_record(event)


class EventWriter:
    """Append-only event-file writer.

    Writes ``events.out.tfevents.<int(wall_time)>.<host>`` in ``logdir``;
    the first record is the conventional ``brain.Event:2`` file-version
    event.
    """

    def __init__(self, logdir, wall_time=None):
        wall_time = time.time() if wall_time is None else wall_time
        name = (f"events.out.tfevents.{int(wall_time)}."
                f"{socket.gethostname()}")
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "ab")
        version = (_varint(1 << 3 | 1) + struct.pack("<d", float(wall_time))
                   + _ld(3, b"brain.Event:2"))
        self._file.write(_frame_record(version))

    def add_scalars(self, step, scalars, wall_time=None):
        wall_time = time.time() if wall_time is None else wall_time
        self._file.write(encode_scalar_event(wall_time, step, scalars))
        self._file.flush()

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
