"""Checkpoint files in the JAX package's flax msgpack layout, without flax.

``forest_tpu.training.checkpointing.save_state`` writes
``flax.serialization.to_bytes(state)`` plus a ``<name>.json`` sidecar of
metadata. The bytes are msgpack: nested maps with string keys, and each
array as ext type 1 holding the msgpack array ``(shape, dtype name,
C-order bytes)`` (ext type 3 is the same for a numpy scalar). This module
reads and writes that subset of msgpack in pure Python, so the port needs
neither ``flax`` nor the ``msgpack`` package. Arrays above flax's 1 GiB
chunking threshold (written as ``__msgpack_chunked_array__`` maps) are not
supported.
"""
from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNK_LIMIT = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE


# ---------------------------------------------------------------------------
# msgpack subset: nil, bool, int, float64, str, bin, array, map, ext
# ---------------------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int,
              codes: Tuple[int, int, int]) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 2 ** 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 2 ** 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">BB", 2 ** 8), (0xcd, ">BH", 2 ** 16),
                               (0xce, ">BI", 2 ** 32), (0xcf, ">BQ", 2 ** 64)):
            if v < top:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lo in ((0xd0, ">Bb", -2 ** 7), (0xd1, ">Bh", -2 ** 15),
                              (0xd2, ">Bi", -2 ** 31), (0xd3, ">Bq", -2 ** 63)):
            if v >= lo:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out += struct.pack(">Bb", fixed[n], code)
    elif n < 2 ** 8:
        out += struct.pack(">BBb", 0xc7, n, code)
    elif n < 2 ** 16:
        out += struct.pack(">BHb", 0xc8, n, code)
    else:
        out += struct.pack(">BIb", 0xc9, n, code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot serialise dtype {arr.dtype}")
    if arr.nbytes > _CHUNK_LIMIT:
        raise ValueError(f"array of {arr.nbytes} bytes exceeds the 1 GiB "
                         "that unchunked flax msgpack holds")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xcb, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, -1, (0xc4, 0xc5, 0xc6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        # string keys in sorted order, as flax's tree traversal writes them
        items = (sorted(obj.items()) if all(isinstance(k, str) for k in obj)
                 else obj.items())
        _pack_len(out, len(obj), 0x80, 15, (None, 0xde, 0xdf))
        for k, v in items:
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack-encode nested dict/list/scalars with ndarray leaves as flax
    does (``flax.serialization.msgpack_serialize``)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        v = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v[0] if len(v) == 1 else v

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_unpack(code, self.take(n))

    def obj(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map_(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.obj() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return self.str_(t & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if t in simple:
            return simple[t]
        nums = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if t in nums:
            return self.unpack(nums[t])
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xc7: ">B", 0xc8: ">H",
                0xc9: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H",
                0xdd: ">I", 0xde: ">H", 0xdf: ">I"}
        if t in lens:
            n = self.unpack(lens[t])
            if t <= 0xc6:
                return self.take(n)
            if t <= 0xc9:
                return self.ext(n)
            if t <= 0xdb:
                return self.str_(n)
            if t <= 0xdd:
                return [self.obj() for _ in range(n)]
            return self.map_(n)
        if 0xd4 <= t <= 0xd8:
            return self.ext(1 << (t - 0xd4))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ext_unpack(code: int, data: bytes) -> Any:
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, buf = unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else \
        dtype_name
    if name == "bfloat16":
        import torch  # numpy has no bfloat16: widen through torch, exactly
        u16 = np.frombuffer(buf, np.uint16).reshape(shape)
        arr = torch.from_numpy(u16.astype(np.int16)).view(
            torch.bfloat16).float().numpy()
    else:
        arr = np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()
    return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode msgpack bytes written by :func:`packb` or by flax."""
    r = _Reader(data, raw)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def save_state(path: Path, state: Dict[str, Any],
               meta: Dict[str, Any]) -> None:
    """Write ``state`` (nested dict of numpy arrays / scalars) as flax
    msgpack and ``meta`` as the ``.json`` sidecar, each via a temp file."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(packb(state))
    os.replace(tmp, path)
    mp = path.with_suffix(path.suffix + ".json")
    tmp2 = mp.with_name(mp.name + ".tmp")
    tmp2.write_text(json.dumps(_jsonable(meta), indent=1))
    os.replace(tmp2, mp)


def load_state_raw(path: Path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (nested dict of numpy arrays, sidecar metadata or {})."""
    path = Path(path)
    state = unpackb(path.read_bytes())
    mp = path.with_suffix(path.suffix + ".json")
    meta = json.loads(mp.read_text()) if mp.exists() else {}
    return state, meta


__all__ = ["save_state", "load_state_raw", "packb", "unpackb"]
