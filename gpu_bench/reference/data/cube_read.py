"""A plain read of a batch of patches from a zarr v2 cube's files, as the
training CLI's dataset hands them to the step.

Written from the zarr v2 and blosc1 format descriptions and the dataset's
contract (``forest_dataset_v2.py``, SURVEY.md §2.3), for the cubes the
benchmark writes: C-order chunks, no filters, blosc1 with LZ4 (its own
decoder of the LZ4 block format) and byte shuffle. A patch is
kept where its ``aoi`` cover is at least ``min_aoi``, in the row-major
order of the grid. Each group is [B, (T,) H, W, C] float32, its channels in
the bindings' order: a source's values, NaN where they equal the channel's
``fill_value``, then its ``ok_if`` test as 0 / 1 (0 where not finite); a
``temporal_position`` channel is t / (T - 1); years of the window the cube
lacks are NaN. ``__window__`` is the patches' top-left corners [B, 2]
int64 and ``__sample_valid__`` [B] bool, all true.
"""
from __future__ import annotations

import json
import operator
import struct
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

OK_IF = {">=": operator.ge, ">": operator.gt, "<=": operator.le,
         "<": operator.lt, "==": operator.eq, "!=": operator.ne}


def lz4(src: bytes, n: int) -> bytes:
    """An LZ4 block decoded into its ``n`` bytes: sequences of a token
    (literal count, match length less 4, each nibble 15 continued by bytes
    that add up to one under 255), literals, a 2-byte offset back into what
    was decoded and the match, which repeats its last ``offset`` bytes
    where it overlaps itself; the last sequence holds literals only."""
    out = bytearray()
    i, end = 0, len(src)
    while True:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while src[i] == 255:
                lit += 255
                i += 1
            lit += src[i]
            i += 1
        out += src[i:i + lit]
        i += lit
        if i == end:
            break
        offset = src[i] | src[i + 1] << 8
        i += 2
        length = token & 15
        if length == 15:
            while src[i] == 255:
                length += 255
                i += 1
            length += src[i]
            i += 1
        length += 4
        if not 0 < offset <= len(out):
            raise ValueError("an LZ4 match before the start")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:
            out += (out[start:] * (length // offset + 1))[:length]
    if len(out) != n:
        raise ValueError(f"an LZ4 block of {len(out)} bytes, not {n}")
    return bytes(out)


def blosc(buf: bytes) -> bytes:
    """The bytes of a blosc1 chunk with LZ4: after the 16-byte header
    either the raw bytes (flag 0x02) or the blocks' offsets and the blocks,
    each split into ``typesize`` streams where the split flag (0x10) is
    clear, typesize is at most 16 and a stream holds 128 elements or more;
    each stream after its int32 length, stored where that is its raw
    length, else LZ4. Byte shuffle (0x01) stores a block's byte j of every
    element together."""
    _, _, flags, ts, nbytes, block, _ = struct.unpack_from(
        "<BBBBIII", buf, 0)
    if flags & 0x04 or flags >> 5 != 1:
        raise ValueError("a blosc chunk that is not byte-shuffled LZ4")
    if flags & 0x02:
        return bytes(buf[16:16 + nbytes])
    nblocks = nbytes // block
    if nblocks * block != nbytes:
        raise ValueError("a blosc chunk with a short last block")
    split = not flags & 0x10 and ts <= 16 and block // ts >= 128
    streams = ts if split else 1
    n = block // streams
    starts = struct.unpack_from(f"<{nblocks}i", buf, 16)
    out = []
    for b in range(nblocks):
        i = starts[b]
        for _ in range(streams):
            size, = struct.unpack_from("<i", buf, i)
            i += 4
            part = buf[i:i + size]
            out.append(part if size == n else lz4(part, n))
            i += size
    raw = np.frombuffer(b"".join(out), np.uint8)
    if flags & 0x01 and ts > 1:         # byte shuffle
        raw = raw.reshape(nblocks, ts, -1).transpose(0, 2, 1)
    return np.ascontiguousarray(raw).tobytes()


class Array:
    """A zarr v2 array; chunks that had LZ4 streams are kept once
    decoded, since a batch's patches come back in later batches."""

    def __init__(self, path: Path):
        meta = json.loads((path / ".zarray").read_text())
        self.path = path
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.codec = meta["compressor"]
        self.decoded: Dict[Tuple[int, ...], np.ndarray] = {}

    def chunk(self, key: Sequence[int]) -> np.ndarray:
        key = tuple(key)
        if key in self.decoded:
            return self.decoded[key]
        buf = (self.path / ".".join(map(str, key))).read_bytes()
        if (self.codec or {}).get("id") != "blosc":
            raise ValueError(f"no plain read of {self.codec!r}")
        out = np.frombuffer(blosc(buf), self.dtype).reshape(self.chunks)
        if not buf[2] & 0x02:
            self.decoded[key] = out
        return out

    def read(self, rows: slice, cols: slice) -> np.ndarray:
        """[..., rows, cols], chunk by chunk; chunks of one along every
        axis but the last two."""
        if any(n != 1 for n in self.chunks[:-2]):
            raise ValueError("the plain read takes chunks of one year")
        ch, cw = self.chunks[-2:]
        out = np.empty(self.shape[:-2] + (rows.stop - rows.start,
                                          cols.stop - cols.start),
                       self.dtype)
        for lead in np.ndindex(*self.shape[:-2]):
            for i in range(rows.start // ch, -(-rows.stop // ch)):
                for j in range(cols.start // cw, -(-cols.stop // cw)):
                    block = self.chunk(lead + (i, j)).reshape(ch, cw)
                    r = slice(max(i * ch, rows.start),
                              min((i + 1) * ch, rows.stop))
                    c = slice(max(j * cw, cols.start),
                              min((j + 1) * cw, cols.stop))
                    out[lead + (slice(r.start - rows.start,
                                      r.stop - rows.start),
                                slice(c.start - cols.start,
                                      c.stop - cols.start))] = \
                        block[r.start - i * ch:r.stop - i * ch,
                              c.start - j * cw:c.stop - j * cw]
        return out


class Cube:
    def __init__(self, path: Path, bindings: Dict, patch: int,
                 min_aoi: float):
        self.path = Path(path)
        self.bindings = bindings
        self.patch = patch
        self.arrays: Dict[str, Array] = {}
        attrs = json.loads((self.path / ".zattrs").read_text())
        self.years = [int(y) for y in attrs["time_coords"]]
        tw = bindings["time_window"]
        self.window = list(range(int(tw["start"]), int(tw["end"]) + 1))
        aoi = Array(self.path / "aoi")
        h, w = aoi.shape
        cover = aoi.read(slice(0, h), slice(0, w)) > 0
        self.patches: List[Tuple[int, int]] = [
            (r, c) for r in range(0, h, patch) for c in range(0, w, patch)
            if cover[r:r + patch, c:c + patch].mean() >= min_aoi]
        if any(r + patch > h or c + patch > w for r, c in self.patches):
            raise ValueError("the plain read takes whole patches only")

    def array(self, source: str) -> Array:
        if source not in self.arrays:
            self.arrays[source] = Array(self.path.joinpath(
                *source.split("/")))
        return self.arrays[source]

    def channel(self, ch: Dict, timed: bool, r: int, c: int) -> np.ndarray:
        p, t = self.patch, len(self.window)
        if ch.get("formula") == "temporal_position":
            tpos = np.arange(t, dtype=np.float32) / np.float32(max(t - 1, 1))
            return np.broadcast_to(tpos[:, None, None], (t, p, p))
        if ch.get("formula") or ch.get("year") is not None \
                or ch.get("reducer"):
            raise ValueError(f"no plain read of channel {ch['name']!r}")
        a = self.array(ch["source"])
        x = a.read(slice(r, r + p), slice(c, c + p)).astype(np.float32)
        if ch.get("fill_value") is not None:
            x = np.where(x == ch["fill_value"], np.float32(np.nan), x)
        if ch.get("ok_if"):
            test = OK_IF[ch["ok_if"]["op"]](x, ch["ok_if"]["value"])
            x = np.where(np.isfinite(x), test.astype(np.float32),
                         np.float32(0.0))
        if x.ndim == 3:
            full = np.full((t, p, p), np.nan, np.float32)
            for k, y in enumerate(self.years):
                if y in self.window:
                    full[self.window.index(y)] = x[k]
            x = full
        if timed and x.ndim == 2:
            x = np.broadcast_to(x, (t, p, p))
        return x

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """The patches ``indices`` (into :attr:`patches`) as one batch."""
        corners = [self.patches[i] for i in indices]
        out = {}
        for name, g in self.bindings["dataset"].items():
            timed = "T" in g["dim"]
            out[name] = np.stack([
                np.stack([self.channel(ch, timed, r, c)
                          for ch in g["channels"]], axis=-1)
                for r, c in corners])
        out["__window__"] = np.asarray(corners, np.int64)
        out["__sample_valid__"] = np.ones(len(corners), bool)
        return out
