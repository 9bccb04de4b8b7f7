"""Reader and writer of TensorFlow event files, in pure Python (the port's
copy of the JAX package's ``utils/tfevents.py``).

``fit`` writes its validation scalars into an ``events.out.tfevents.*``
file beside ``summaries.jsonl``, which tensorflow's ``summary_iterator``
(and so the reference's ``get_summary`` and notebooks) read directly.
``iter_scalar_events`` reads such files back without TensorFlow, for
``ExperimentData.get_summary`` on runs that have no ``summaries.jsonl``.

- TFRecord framing (tensorflow/core/lib/io/record_writer.cc):
  [uint64 length][uint32 masked-crc32c(length)][data][uint32 masked-crc32c
  (data)]. The reader checks the framing's lengths, not its CRCs.
- Event proto (tensorflow/core/util/event.proto): wall_time(1, double),
  step(2, int64), summary(5, message); Summary.value(1) is a repeated
  message with tag(1, string) and simple_value(2, float).

Only scalar summaries are decoded. With the same ``wall_time`` the bytes
written equal the JAX package's writer's.
"""

import os
import socket
import struct
import time
from collections import namedtuple

ScalarEvent = namedtuple("ScalarEvent", ["wall_time", "step", "tag",
                                         "simple_value"])


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------

def _read_varint(buf, pos):
    result, shift = 0, 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf):
    """Yield (field_number, wire_type, value) over a protobuf message:
    an int for a varint, bytes for a length-delimited field, the raw 4 or
    8 bytes of a fixed32 or fixed64."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_summary_value(buf):
    """Summary.Value: tag=1 (string), simple_value=2 (float, fixed32)."""
    tag, simple_value = None, None
    for field, wire, value in _iter_fields(buf):
        if field == 1 and wire == 2:
            tag = value.decode("utf8")
        elif field == 2 and wire == 5:
            simple_value = struct.unpack("<f", value)[0]
    return tag, simple_value


def _parse_event(buf):
    """Event: wall_time=1 (double), step=2 (int64), summary=5 (Summary)."""
    wall_time, step, values = 0.0, 0, []
    for field, wire, value in _iter_fields(buf):
        if field == 1 and wire == 1:
            wall_time = struct.unpack("<d", value)[0]
        elif field == 2 and wire == 0:
            # a negative int64 is a 10-byte varint: two's complement
            step = value - (1 << 64) if value >= 1 << 63 else value
        elif field == 5 and wire == 2:
            for f2, w2, v2 in _iter_fields(value):
                if f2 == 1 and w2 == 2:  # repeated Summary.Value
                    values.append(_parse_summary_value(v2))
    return wall_time, step, values


def _records(data):
    """Yield the payload of each TFRecord in ``data``; a truncated last
    record (a writer that crashed) ends the file."""
    pos, end = 0, len(data)
    while pos + 12 <= end:
        (length,) = struct.unpack("<Q", data[pos:pos + 8])
        payload_start = pos + 12
        payload_end = payload_start + length
        if payload_end + 4 > end:
            break
        yield data[payload_start:payload_end]
        pos = payload_end + 4


def iter_scalar_events(source):
    """Yield a ScalarEvent for every scalar summary in an event file.

    Args:
        source: path, bytes, or file-like object of an
            ``events.out.tfevents`` file.
    """
    if isinstance(source, bytes):
        data = source
    elif hasattr(source, "read"):
        data = source.read()
    else:
        with open(source, "rb") as f:
            data = f.read()
    for record in _records(data):
        wall_time, step, values = _parse_event(record)
        for tag, simple_value in values:
            if tag is not None and simple_value is not None:
                yield ScalarEvent(wall_time, step, tag, simple_value)


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------


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
