"""Minimal .caffemodel reader: protobuf wire format with numpy, no protoc,
no caffe.proto (the port's own copy of ``islx/core/caffe_reader.py``).

The reference converts caffemodels by downloading caffe.proto, running
protoc and walking the generated classes (reference caffemodel2pytorch/
caffemodel2pytorch.py:30-52,378-402). A caffemodel is protobuf wire format,
and only three message types are needed (NetParameter -> LayerParameter ->
BlobProto), so this module decodes the wire format directly: new-style
``layer`` (field 100) and V1 ``layers`` (field 2) entries, packed and
unpacked floats, ``BlobShape`` dims and the legacy num/channels/height/
width dims.

Output: a flat ``{layer_name}.weight`` / ``{layer_name}.bias`` ->
np.ndarray dict, the reference converter's .pt payload
(caffemodel2pytorch.py:388: blob 0 = weight, blob 1 = bias; a PReLU layer
has a single blob, stored as ``.weight``).
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, raw value) for a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == _I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")
        yield field, wt, val


def _blob_to_array(blob: memoryview) -> np.ndarray:
    """BlobProto: data (packed float) 5, shape.dim 7/1, legacy NCHW dims
    1..4."""
    data_chunks: List[np.ndarray] = []
    shape: List[int] = []
    legacy = {}
    for field, wt, val in _fields(blob):
        if field == 5:  # data
            if wt == _LEN:
                data_chunks.append(np.frombuffer(bytes(val), dtype="<f4"))
            elif wt == _I32:
                data_chunks.append(np.array(
                    [struct.unpack("<f", bytes(val))[0]], dtype=np.float32))
        elif field == 7 and wt == _LEN:  # BlobShape
            for f2, wt2, v2 in _fields(val):
                if f2 == 1:
                    if wt2 == _LEN:  # packed int64
                        p = 0
                        mv = v2
                        while p < len(mv):
                            d, p = _read_varint(mv, p)
                            shape.append(d)
                    else:
                        shape.append(int(v2))
        elif field in (1, 2, 3, 4) and wt == _VARINT:  # legacy num/ch/h/w
            legacy[field] = int(val)
    arr = (np.concatenate(data_chunks) if data_chunks
           else np.zeros((0,), np.float32))
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


def _layer(buf: memoryview, v1: bool) -> Tuple[str, List[np.ndarray]]:
    """LayerParameter: name=1, blobs=7.  V1LayerParameter: name=4, blobs=6."""
    name_field = 4 if v1 else 1
    blob_field = 6 if v1 else 7
    name = ""
    blobs: List[np.ndarray] = []
    for field, wt, val in _fields(buf):
        if field == name_field and wt == _LEN:
            name = bytes(val).decode("utf-8", errors="replace")
        elif field == blob_field and wt == _LEN:
            blobs.append(_blob_to_array(val))
    return name, blobs


def read_caffemodel(path: str) -> Dict[str, np.ndarray]:
    """Parse a .caffemodel into a flat {layer.weight/.bias: array} dict."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    out: Dict[str, np.ndarray] = {}
    for field, wt, val in _fields(buf):
        # NetParameter: layer=100 (new), layers=2 (V1)
        if wt == _LEN and field in (100, 2):
            name, blobs = _layer(val, v1=(field == 2))
            if not name or not blobs:
                continue
            # blob 0 -> weight, blob 1 -> bias (PReLU has a single blob: the
            # slope, which the reference also stores as `.weight`).
            out[f"{name}.weight"] = blobs[0]
            if len(blobs) > 1:
                out[f"{name}.bias"] = blobs[1]
    return out
