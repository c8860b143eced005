"""Dependency-free TensorBoard event-file writer.

The reference experiment dirs were TensorBoard-readable (SURVEY.md §6:
`nm/learning_utils.py` wrote scalar/image summaries through
`tf.summary.FileWriter`). This module recreates that surface without
TensorFlow: it hand-encodes the two protobuf messages TensorBoard
actually reads (Event, Summary) and frames them in the TFRecord format
(length + masked-CRC32C framing), so `tensorboard --logdir <output>`
works on our experiment dirs unchanged.

Wire formats implemented:

- TFRecord: ``uint64 length | uint32 masked_crc(length) | data |
  uint32 masked_crc(data)`` with CRC32-Castagnoli and the TF mask
  ``((crc >> 15 | crc << 17) + 0xa282ead8)``.
- Event proto (tensorflow/core/util/event.proto): wall_time (field 1,
  double), step (field 2, int64), file_version (field 3, string),
  summary (field 5, message).
- Summary proto (tensorflow/core/framework/summary.proto): repeated
  Value (field 1) with tag (field 1, string) and either simple_value
  (field 2, float) or image (field 4: height/width/colorspace/
  encoded_image_string).

A minimal reader (`read_events`) lives here too so tests can verify
CRC integrity and round-trip the values without TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------- CRC32C

_CRC_TABLE: List[int] = []


def _build_table() -> None:
    poly = 0x82F63B78  # Castagnoli, reflected
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

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


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _string_field(field: int, text: str) -> bytes:
    return _bytes_field(field, text.encode("utf-8"))


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & (1 << 64) - 1)


def _scalar_value(tag: str, value: float) -> bytes:
    return _string_field(1, tag) + _float_field(2, value)


def _image_value(tag: str, png_bytes: bytes, height: int, width: int,
                 colorspace: int = 3) -> bytes:
    image = (_varint_field(1, height) + _varint_field(2, width)
             + _varint_field(3, colorspace)
             + _bytes_field(4, png_bytes))
    return _string_field(1, tag) + _bytes_field(4, image)


def _event(step: int, summary_values: List[bytes],
           wall_time: Optional[float] = None,
           file_version: Optional[str] = None) -> bytes:
    body = _double_field(1, time.time() if wall_time is None
                         else wall_time)
    if file_version is not None:
        body += _string_field(3, file_version)
    else:
        body += _varint_field(2, step)
        summary = b"".join(_bytes_field(1, v) for v in summary_values)
        body += _bytes_field(5, summary)
    return body


# --------------------------------------------------------------- writer

class EventFileWriter:
    """Appends TFRecord-framed Event protos to one events file."""

    def __init__(self, logdir: str) -> None:
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self.path = os.path.join(logdir, name)
        self._write_record(_event(0, [], file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        record = (header + struct.pack("<I", _masked_crc(header))
                  + data + struct.pack("<I", _masked_crc(data)))
        with open(self.path, "ab") as f:
            f.write(record)

    def add_scalars(self, step: int, values: Dict[str, float],
                    wall_time: Optional[float] = None) -> None:
        if not values:
            return
        summary = [_scalar_value(tag, float(v))
                   for tag, v in sorted(values.items())]
        self._write_record(_event(step, summary, wall_time))

    def add_image(self, step: int, tag: str, png_bytes: bytes,
                  height: int, width: int) -> None:
        self._write_record(
            _event(step, [_image_value(tag, png_bytes, height, width)]))


# --------------------------------------------------------------- reader

def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _parse_message(data: bytes) -> List[Tuple[int, int, object]]:
    """Returns (field, wire, raw value) triples."""
    fields = []
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value = struct.unpack("<d", data[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(data, pos)
            value = data[pos:pos + length]
            pos += length
        elif wire == 5:
            value = struct.unpack("<f", data[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.append((field, wire, value))
    return fields


def read_events(path: str) -> Iterator[Dict]:
    """Parse an events file, verifying all masked CRCs.

    Yields dicts: {"step": int, "scalars": {tag: value},
    "images": {tag: png_bytes}, "file_version": str | None}."""
    with open(path, "rb") as f:
        blob = f.read()
    pos = 0
    while pos < len(blob):
        header = blob[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (header_crc,) = struct.unpack("<I", blob[pos + 8:pos + 12])
        if header_crc != _masked_crc(header):
            raise ValueError(f"bad header CRC at offset {pos}")
        data = blob[pos + 12:pos + 12 + length]
        (data_crc,) = struct.unpack(
            "<I", blob[pos + 12 + length:pos + 16 + length])
        if data_crc != _masked_crc(data):
            raise ValueError(f"bad data CRC at offset {pos}")
        pos += 16 + length

        event = {"step": 0, "scalars": {}, "images": {},
                 "file_version": None}
        for field, _, value in _parse_message(data):
            if field == 2:
                event["step"] = value
            elif field == 3:
                event["file_version"] = value.decode("utf-8")
            elif field == 5:
                for vfield, _, vvalue in _parse_message(value):
                    if vfield != 1:
                        continue
                    tag = simple = image = None
                    for sfield, _, svalue in _parse_message(vvalue):
                        if sfield == 1:
                            tag = svalue.decode("utf-8")
                        elif sfield == 2:
                            simple = svalue
                        elif sfield == 4:
                            image = svalue
                    if tag is None:
                        continue
                    if simple is not None:
                        event["scalars"][tag] = simple
                    if image is not None:
                        for ifield, _, ivalue in _parse_message(image):
                            if ifield == 4:
                                event["images"][tag] = ivalue
        yield event
