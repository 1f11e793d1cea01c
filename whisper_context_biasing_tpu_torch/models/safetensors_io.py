"""The safetensors file format, read and written with numpy and the standard
library (no ``safetensors`` package).

Layout: an 8-byte little-endian header length N; N bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` with an optional
``"__metadata__"`` map of strings (read past, never written), padded with spaces to a multiple of 8;
then the tensors' raw little-endian bytes, each at its offsets counted from
the end of the header. The writer lays tensors out as the ``safetensors``
package does (widest dtype first, then by name; compact JSON), so the two
write the same bytes for the same tensors. F64, F32 and F16 are read and
written; any other dtype raises ``ValueError`` naming it. The reader refuses
a truncated file, offsets outside the data, overlapping tensors and a size
that does not match the shape.
"""

from __future__ import annotations

import json
import math

import numpy as np

_DTYPES = {"F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2")}
_NAMES = {dt.newbyteorder("="): name for name, dt in _DTYPES.items()}
_MAX_HEADER = 100 * 2**20


def _dtype_name(a: np.ndarray) -> str:
    name = _NAMES.get(a.dtype.newbyteorder("="))
    if name is None:
        raise ValueError(f"safetensors dtype {a.dtype} is not supported (F64, F32, F16)")
    return name


def serialize(tensors: dict[str, np.ndarray]) -> bytes:
    """The file's bytes for ``tensors`` (name -> array)."""
    arrays = {k: np.asarray(v) for k, v in tensors.items()}
    order = sorted(arrays, key=lambda k: (-arrays[k].dtype.itemsize, k))
    header: dict = {}
    chunks, offset = [], 0
    for name in order:
        a = arrays[name]
        dtype = _dtype_name(a)
        data = np.ascontiguousarray(a, dtype=_DTYPES[dtype]).tobytes()
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    return len(text).to_bytes(8, "little") + text + b"".join(chunks)


def write_safetensors(tensors: dict[str, np.ndarray], path: str) -> None:
    with open(path, "wb") as f:
        f.write(serialize(tensors))


def deserialize(buf: bytes) -> dict[str, np.ndarray]:
    """name -> array from a file's bytes (the ``__metadata__`` map is
    skipped); arrays in native byte order, each a copy that owns its
    memory."""
    if len(buf) < 8:
        raise ValueError(f"not a safetensors file: {len(buf)} bytes, no header length")
    n = int.from_bytes(buf[:8], "little")
    if n > _MAX_HEADER or 8 + n > len(buf):
        raise ValueError(f"safetensors header of {n} bytes does not fit a {len(buf)}-byte "
                         "file (truncated?)")
    try:
        header = json.loads(buf[8:8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"safetensors header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ValueError("safetensors header is not a JSON object")
    header.pop("__metadata__", None)
    data = memoryview(buf)[8 + n:]
    spans, out = [], {}
    for name, info in header.items():
        dtype = _DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ValueError(f"safetensors dtype {info.get('dtype')!r} of {name!r} is not "
                             "supported (F64, F32, F16)")
        shape = info.get("shape")
        begin, end = info.get("data_offsets", (None, None))
        if (not isinstance(shape, list) or not all(isinstance(d, int) and d >= 0 for d in shape)
                or not all(isinstance(o, int) for o in (begin, end))):
            raise ValueError(f"safetensors entry {name!r} has a malformed shape or offsets")
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"safetensors tensor {name!r} at bytes [{begin}, {end}) lies "
                             f"outside the {len(data)} bytes of data (truncated?)")
        if end - begin != math.prod(shape) * dtype.itemsize:
            raise ValueError(f"safetensors tensor {name!r}: {end - begin} bytes for shape "
                             f"{shape} of {info['dtype']}")
        spans.append((begin, end, name))
        out[name] = np.frombuffer(data[begin:end], dtype=dtype).reshape(shape).astype(
            dtype.newbyteorder("="))
    spans.sort()
    for (_, prev_end, prev), (begin, _, name) in zip(spans, spans[1:]):
        if begin < prev_end:
            raise ValueError(f"safetensors tensors {prev!r} and {name!r} overlap")
    return out


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return deserialize(f.read())
