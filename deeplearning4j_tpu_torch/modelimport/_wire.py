"""Protobuf wire-format primitives shared by the stdlib codecs of
:mod:`.tf_proto` (TensorFlow GraphDefs) and :mod:`.onnx_proto` (ONNX
ModelProtos): varints, the field iterator, repeated fields packed or not,
and the varint and tag writers."""

from __future__ import annotations

import struct
from typing import Tuple

# ----------------------------------------------------------------- decoding


def read_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def fields(buf):
    """Yield (field_number, wire_type, value) over a message's bytes; a
    length-delimited value is a zero-copy ``memoryview`` slice."""
    buf = memoryview(buf)
    pos, n = 0, len(buf)
    while pos < n:
        tag_, pos = read_varint(buf, pos)
        fnum, wt = tag_ >> 3, tag_ & 7
        if wt == 0:
            v, pos = read_varint(buf, pos)
        elif wt == 1:
            v = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fnum, wt, v


def s64(v: int) -> int:
    """varint -> signed int64 (two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def utf8(v) -> str:
    return bytes(v).decode("utf-8")


def varints(wt: int, v, out: list, signed: bool = True) -> None:
    """A repeated varint field, packed (one length-delimited run) or not
    (one value a tag): both occur."""
    if wt == 0:
        out.append(s64(v) if signed else v)
        return
    p = 0
    while p < len(v):
        d, p = read_varint(v, p)
        out.append(s64(d) if signed else d)


def fixed(wt: int, v, out: list, fmt: str, width: int) -> None:
    """A repeated fixed32/fixed64 field, packed or not."""
    if wt == 2:
        out.extend(struct.unpack(f"<{len(v) // width}{fmt}", v))
    else:
        out.append(struct.unpack(f"<{fmt}", v)[0])


# ----------------------------------------------------------------- encoding

def varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(fnum: int, wt: int) -> bytes:
    return varint((fnum << 3) | wt)
