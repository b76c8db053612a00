"""A zarr v2 cube of the bindings' sources, drawn on the device from a
generator and written at set-up, and the order in which a training epoch
visits its patches.

The cube holds every array that a channel of the bindings' dataset groups
names as its ``source``, at ``cube_hw``² pixels, with the time axis of the
bindings' window for the channels of a group with one. Values follow
``traffic/frl.py``: a channel of a ``uint8`` group is a mask, 1 with
probability ``mask_keep`` (``annual_keep`` with a time axis); an ``int16``
channel holds one of ``evt_codes``; in a float group a channel named
``ysfc`` is a whole number in [0, ``ysfc_max``) and every other is standard
normal. Float groups are stored as float16, ``uint8`` and ``int16`` groups
in their own type, in chunks of one year by ``chunk``² pixels. A bindings
without an ``aoi`` source gets an ``aoi`` of ones.

``codec``, the ``.zarray`` compressor, is blosc: LZ4 at clevel 3, byte
shuffle, blocks of 16 KiB as c-blosc 1.x picks them there, each block split
into its ``typesize`` byte streams. Each stream is LZ4-encoded by the
benchmark's own greedy encoder (``lz4_encode.c``, acceleration ``10 -
clevel`` as c-blosc 1.x sets it) and kept where that is shorter, else
stored; a chunk whose streams would not fit in its raw size and header is
written whole after its header (blosc's memcpyed form), as c-blosc does.
The encoder is built with the C compiler (``CC``, else ``cc``) into the
checkout's ``.bench_cache/lz4``, once. Every chunk is encoded and written
by min(8, cpu_count) threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

BLOSC = {"id": "blosc", "cname": "lz4", "clevel": 3, "shuffle": 1,
         "blocksize": 0}
BLOSC_BLOCK = 16384
BLOSC_SHUFFLE, BLOSC_MEMCPYED, BLOSC_LZ4 = 0x01, 0x02, 1 << 5
LZ4_SOURCE = Path(__file__).with_name("lz4_encode.c")
LZ4_BUILD = Path(__file__).resolve().parents[2] / ".bench_cache" / "lz4"
_lz4_lock = threading.Lock()
_lz4_lib = None


def years(bindings: Dict) -> List[int]:
    tw = bindings["time_window"]
    return list(range(int(tw["start"]), int(tw["end"]) + 1))


def _draw(gen: torch.Generator, bindings: Dict, hw: int, traffic: Dict
          ) -> Dict[str, np.ndarray]:
    """Every source's values on the host in its stored type: one draw a
    group on the generator's device."""
    dev, t = gen.device, len(years(bindings))
    out: Dict[str, np.ndarray] = {}
    for group in bindings["dataset"].values():
        chans = [c for c in group["channels"] if c.get("source")]
        if not chans:
            continue
        timed = "T" in group["dim"]
        shape = (len(chans),) + ((t,) if timed else ()) + (hw, hw)
        kind = group["type"]
        if kind == "uint8":
            keep = traffic["annual_keep" if timed else "mask_keep"]
            x = (torch.rand(shape, generator=gen, device=dev) < keep
                 ).to(torch.uint8)
        elif kind == "int16":
            codes = torch.tensor(traffic["evt_codes"], dtype=torch.int16,
                                 device=dev)
            x = codes[torch.randint(0, len(codes), shape, generator=gen,
                                    device=dev)]
        else:
            x = torch.randn(shape, generator=gen, device=dev)
            for i, ch in enumerate(chans):
                if ch["name"] == "ysfc":
                    x[i] = torch.randint(0, traffic["ysfc_max"], shape[1:],
                                         generator=gen, device=dev).float()
            x = x.to(torch.float16)
        host = x.cpu().numpy()
        for i, ch in enumerate(chans):
            out.setdefault(ch["source"], host[i])
    return out


def lz4_library() -> ctypes.CDLL:
    """The encoder of ``lz4_encode.c``, built on first use at a path named
    by the source's hash, so that a changed source builds anew."""
    global _lz4_lib
    with _lz4_lock:
        if _lz4_lib is None:
            digest = hashlib.sha256(LZ4_SOURCE.read_bytes()).hexdigest()
            lib = LZ4_BUILD / f"lz4_encode-{digest[:16]}.so"
            if not lib.exists():
                LZ4_BUILD.mkdir(parents=True, exist_ok=True)
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                subprocess.run([os.environ.get("CC", "cc"), "-O2",
                                "-shared", "-fPIC", "-o", str(tmp),
                                str(LZ4_SOURCE)], check=True,
                               capture_output=True)
                os.replace(tmp, lib)
            _lz4_lib = ctypes.CDLL(str(lib))
            _lz4_lib.lz4_streams.restype = ctypes.c_int
            _lz4_lib.lz4_streams.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p]
        return _lz4_lib


def blosc_lz4(raw: np.ndarray, clevel: int) -> bytes:
    """One chunk as a blosc1 buffer: a 16-byte header, the blocks'
    offsets, then each block's byte streams (``typesize`` of them: byte j
    of every element), each after its int32 length and LZ4-encoded where
    that is shorter; or the header and the raw bytes where the streams
    would not fit in the raw size."""
    ts = raw.dtype.itemsize
    data = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    nbytes = data.size
    block = min(BLOSC_BLOCK, nbytes)
    if nbytes % block or block % ts or block // ts < 128:
        raise ValueError(f"a chunk of {nbytes} bytes does not split into "
                         f"blocks of {block}")
    nblocks, n = nbytes // block, block // ts
    streams = np.ascontiguousarray(
        data.reshape(nblocks, n, ts).transpose(0, 2, 1))
    coded = np.empty_like(streams)
    sizes = np.empty(nblocks * ts, np.int32)
    lz4_library().lz4_streams(streams.ctypes.data, nblocks * ts, n,
                              10 - clevel, coded.ctypes.data,
                              sizes.ctypes.data)
    lengths = np.where(sizes > 0, sizes, n).reshape(nblocks, ts)
    start = 16 + 4 * nblocks
    cbytes = start + int((4 + lengths).sum())
    if cbytes > nbytes + 16:
        return struct.pack("<BBBBIII", 2, 1,
                           BLOSC_SHUFFLE | BLOSC_MEMCPYED | BLOSC_LZ4, ts,
                           nbytes, block, nbytes + 16) + data.tobytes()
    starts = start + np.concatenate(
        [[0], np.cumsum((4 + lengths).sum(1))[:-1]]).astype("<i4")
    parts = [struct.pack("<BBBBIII", 2, 1, BLOSC_SHUFFLE | BLOSC_LZ4, ts,
                         nbytes, block, cbytes), starts.tobytes()]
    for b in range(nblocks):
        for j in range(ts):
            size = int(sizes[b * ts + j])
            parts.append(struct.pack("<i", size or n))
            parts.append((coded[b, j, :size] if size else streams[b, j])
                         .tobytes())
    return b"".join(parts)


def _zarray(shape, chunks, dtype, codec: Dict) -> str:
    return json.dumps({"zarr_format": 2, "shape": list(shape),
                       "chunks": list(chunks), "dtype": np.dtype(dtype).str,
                       "compressor": codec, "fill_value": 0, "order": "C",
                       "filters": None})


def write(path: Path, gen: torch.Generator, bindings: Dict, traffic: Dict
          ) -> Dict[str, float]:
    """Write the cube at ``path``. -> its raw and stored bytes, the count
    of chunks and of those written whole."""
    hw, c = traffic["cube_hw"], traffic["chunk"]
    codec = traffic["codec"]
    if codec != BLOSC:
        raise ValueError(f"the cube is written with {BLOSC}, not {codec}")
    arrays = _draw(gen, bindings, hw, traffic)
    if "aoi" not in arrays:
        arrays["aoi"] = np.ones((hw, hw), np.uint8)
    path = Path(path)
    groups = {path: None}
    for src in arrays:
        parts = src.split("/")
        groups.update((path.joinpath(*parts[:i]), None)
                      for i in range(1, len(parts)))
    for d in groups:                    # parents before their children
        d.mkdir(parents=d == path)
        (d / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    (path / ".zattrs").write_text(json.dumps(
        {"time_coords": years(bindings)}))
    jobs = []
    for src, a in arrays.items():
        d = path.joinpath(*src.split("/"))
        d.mkdir()
        chunks = (1, c, c) if a.ndim == 3 else (c, c)
        (d / ".zarray").write_text(_zarray(a.shape, chunks, a.dtype, codec))
        for t in range(a.shape[0] if a.ndim == 3 else 1):
            for i in range(hw // c):
                for j in range(hw // c):
                    key = f"{t}.{i}.{j}" if a.ndim == 3 else f"{i}.{j}"
                    jobs.append((d / key, a, t, i, j))

    lz4_library()

    def one(job) -> bytes:
        f, a, t, i, j = job
        plane = a[t] if a.ndim == 3 else a
        buf = blosc_lz4(plane[i * c:(i + 1) * c, j * c:(j + 1) * c],
                        codec["clevel"])
        f.write_bytes(buf)
        return buf[:16]

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        heads = list(pool.map(one, jobs))
    return {"raw_bytes": float(sum(a.nbytes for a in arrays.values())),
            "stored_bytes": float(sum(struct.unpack_from("<I", h, 12)[0]
                                      for h in heads)),
            "chunks": float(len(jobs)),
            "whole_chunks": float(sum(h[2] & BLOSC_MEMCPYED > 0
                                      for h in heads))}


def visits(seed: int, epoch: int, n: int, batch: int, batches: int
           ) -> List[int]:
    """The patch indices an epoch visits, ``batches`` batches of
    ``batch``: whole batches cut from seeded permutations of the ``n``
    patches, so that a patch repeats across batches but never inside
    one."""
    if batch > n:
        raise ValueError(f"a batch of {batch} from {n} patches repeats")
    rng = np.random.default_rng([seed, epoch])
    per = n // batch
    out: List[int] = []
    while len(out) < batches * batch:
        out += rng.permutation(n)[:per * batch].tolist()
    return out[:batches * batch]

