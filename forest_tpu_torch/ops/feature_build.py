"""One FeatureBuilder build in one launch, and its plain version.

:class:`~forest_tpu_torch.data.feature_builder.FeatureBuilder` turns a
feature's bindings and stats into a parameter table once per feature and
device, then builds each batch through :func:`feature_build`, the
``torch.library`` op ``forest_tpu_torch::feature_build``:

- a CUDA tensor launches the hand-written kernel of ``csrc/
  feature_build.cu``, one launch a build: every channel read from its
  group's own storage (channel-last, any leading dims, any of
  :data:`DTYPE_CODES`), masked, transformed, normalised and zeroed, then
  whitened in registers where the feature asks for it, written once as
  ``x`` and its bool mask; a build beyond the kernel's limits
  (:func:`kernel_args`) raises. ``feature_build.launches`` counts the
  launches;
- a CPU tensor runs the plain version, :func:`compose` over the table read
  back (:func:`channels_of`): the same PyTorch operations the builder has
  always run, one channel at a time.

With ``coords`` [B, N, 2] (row, col) the build reads each channel at those
pixels directly and returns [B, N, C] or, for a temporal feature, [B, N, T,
C]: what indexing the full-grid build at ``coords`` gives. A negative
coordinate counts from the end, as a tensor index does; a pixel outside the
grid gives an invalid row (x 0, mask False) on every device.

The table (:func:`table`): ``itab`` [C, 6] int32 holds, per channel, the
value's group slot and channel, the mask's group slot (-1: none) and
channel, the transform's id (:data:`TRANSFORM_IDS`) and the normalisation's
flags (:data:`AFFINE`, :data:`RESCALE`, :data:`LO`, :data:`HI`); ``ftab``
[C, 8] float32 the log's epsilon, the offset and scale (x - off) / scale,
the rescale's product and sum, and the clamp's bounds. The whitening
matrix W [C, C] and mean [C] travel beside it.

A transform added or replaced by ``data.transforms.register`` has no id:
the builder keeps :func:`compose` for such a feature, on every device, and
``feature_build.builds`` counts the builds of each path ("kernel": the op,
"composed": the rest), which is the op's hit share. The op's FLOP formula
is its declared cost, :func:`feature_build_cost`: the whitening product's
2 rows C^2, what ``FlopCounterMode`` counted for the einsum it replaces.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from forest_tpu_torch.data.transforms import (LOG_DEFAULT_EPSILON,
                                              TransformSpec, apply_transform,
                                              is_builtin,
                                              parse_transform_spec)
from forest_tpu_torch.ops import _library
from forest_tpu_torch.ops._cuda_build import load_library
from forest_tpu_torch.ops.whitening import apply_whitening
from forest_tpu_torch.utils.flops import KernelCost

# the kernel's codes (csrc/feature_build.cu)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3, torch.uint8: 4, torch.int8: 5,
               torch.int16: 6, torch.int32: 7, torch.int64: 8, torch.bool: 9}
TRANSFORM_IDS = {"none": 0, "identity": 0, "log1p": 1, "log10": 2,
                 "sqrt": 3, "cbrt": 4, "neg": 5, "log": 6}
AFFINE, RESCALE, LO, HI = 1, 2, 4, 8
MAX_GROUPS, MAX_DIMS = 8, 6
# the widest features the kernel takes: a block stages its 256 rows in
# shared memory (and W, where whitened)
MAX_CHANNELS, MAX_WHITENED_CHANNELS = 96, 64

_NAMES = {i: n for n, i in TRANSFORM_IDS.items() if n != "identity"}


class Norm(NamedTuple):
    """A channel's normalisation, in float32 values: ``(x - off) / scale``
    where ``flags & AFFINE``, then ``x * mul + add`` where ``RESCALE``, then
    the clamp to ``lo`` / ``hi`` where ``LO`` / ``HI``."""
    flags: int = 0
    off: float = 0.0
    scale: float = 1.0
    mul: float = 1.0
    add: float = 0.0
    lo: float = 0.0
    hi: float = 0.0


class Channel(NamedTuple):
    """One channel of a feature: (group slot, channel) of its value and of
    its mask (None: finiteness alone), its transform (a spec, None for none)
    and its :class:`Norm`."""
    value: Tuple[int, int]
    mask: Optional[Tuple[int, int]]
    transform: TransformSpec
    norm: Norm


def f32(v: float) -> float:
    """``v`` rounded to float32, as PyTorch rounds a Python scalar against
    a float32 tensor."""
    return float(np.float32(v))


def kernel_takes(transform: TransformSpec) -> bool:
    """Whether the kernel computes ``transform`` itself."""
    return not transform or is_builtin(transform)


def table(channels: Sequence[Channel]) -> Tuple[np.ndarray, np.ndarray]:
    """-> (itab [C, 6] int32, ftab [C, 8] float32) of ``channels``, whose
    transforms must all be the kernel's (:func:`kernel_takes`)."""
    c = len(channels)
    itab = np.zeros((c, 6), np.int32)
    ftab = np.zeros((c, 8), np.float32)
    for i, ch in enumerate(channels):
        if not kernel_takes(ch.transform):
            raise ValueError(f"transform {ch.transform!r} has no kernel id")
        name, params = parse_transform_spec(ch.transform or None)
        m_slot, m_ch = ch.mask if ch.mask is not None else (-1, 0)
        itab[i] = (*ch.value, m_slot, m_ch,
                   TRANSFORM_IDS[name] if name else 0, ch.norm.flags)
        eps = params.get("epsilon", LOG_DEFAULT_EPSILON)
        ftab[i] = (eps if name == "log" else 0.0, *ch.norm[1:], 0.0)
    return itab, ftab


def channels_of(itab: torch.Tensor, ftab: torch.Tensor) -> List[Channel]:
    """The channels a table was made from (transforms by their built-in
    names, values as float32 holds them)."""
    out = []
    for (vs, vc, ms, mc, tid, flags), fr in zip(itab.tolist(),
                                                ftab.tolist()):
        name = _NAMES[tid] if tid else None
        spec = {"name": "log", "epsilon": fr[0]} if name == "log" else name
        out.append(Channel((vs, vc), None if ms < 0 else (ms, mc), spec,
                           Norm(flags, *fr[1:7])))
    return out


def normalize(x: torch.Tensor, norm: Norm) -> torch.Tensor:
    if norm.flags & AFFINE:
        x = (x - norm.off) / norm.scale
    if norm.flags & RESCALE:
        x = x * norm.mul + norm.add
    if norm.flags & (LO | HI):
        x = torch.clamp(x, norm.lo if norm.flags & LO else None,
                        norm.hi if norm.flags & HI else None)
    return x


def _at(a: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
        ) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, 1, C], [B, T, H, W, C] -> [B, T, N, 1, C]:
    the group at (``rows``, ``cols``) [B, N] on a fake grid of one
    column."""
    bidx = torch.arange(a.shape[0], device=a.device)[:, None]
    if a.dim() == 4:
        return a[bidx, rows, cols][:, :, None, :]
    picked = a.permute(0, 2, 3, 1, 4)[bidx, rows, cols]     # [B, N, T, C]
    return picked.permute(0, 2, 1, 3)[:, :, :, None, :]


def compose(groups: Sequence[torch.Tensor], channels: Sequence[Channel],
            w: Optional[torch.Tensor], mu: Optional[torch.Tensor],
            temporal: bool, clip: float,
            coords: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The build in PyTorch operations, a channel at a time: the op's plain
    version, and the builder's path for a transform the kernel lacks."""
    inside = None
    if coords is not None:
        h, w_ = groups[0].shape[-3:-1]
        coords = coords.to(groups[0].device).long()
        rows, cols = coords[..., 0], coords[..., 1]
        inside = (rows >= -h) & (rows < h) & (cols >= -w_) & (cols < w_)
        rows, cols = torch.where(inside, rows, 0), torch.where(inside, cols, 0)
        groups = [_at(g, rows, cols) for g in groups]
        # as a channel's x: [B, N, 1], or [B, 1, N, 1] over T
        inside = inside[:, None, :, None] if temporal else inside[..., None]
    chans, masks = [], []
    for ch in channels:
        x = groups[ch.value[0]][..., ch.value[1]].float()
        valid = torch.isfinite(x)
        if inside is not None:
            valid = valid & inside
        if ch.mask is not None:
            m = groups[ch.mask[0]][..., ch.mask[1]].float()
            # spatial -> temporal broadcast when needed
            if temporal and m.dim() == x.dim() - 1:
                m = m.unsqueeze(-3).expand(x.shape)
            elif temporal and m.dim() == x.dim() and m.shape != x.shape:
                m = m.expand(x.shape)
            valid = valid & (m > 0)
        if ch.transform:
            x = apply_transform(ch.transform, x)
            valid = valid & torch.isfinite(x)
        zero = torch.zeros_like(x)
        x = normalize(torch.where(valid, x, zero), ch.norm)
        chans.append(torch.where(valid, x, zero))
        masks.append(valid)
    x = torch.stack(chans, dim=-1)
    mask = torch.stack(masks, dim=-1)
    if w is not None:
        x = apply_whitening(x, w, mu, mask, clip=clip)
    if coords is None:
        return x, mask
    if temporal:
        return (x[:, :, :, 0, :].permute(0, 2, 1, 3),
                mask[:, :, :, 0, :].permute(0, 2, 1, 3))
    return x[:, :, 0, :], mask[:, :, 0, :]


def feature_build_cost(read_bytes: int, rows: int, c: int,
                       whitened: bool) -> KernelCost:
    """One build of ``rows`` output rows of ``c`` channels that reads
    ``read_bytes`` of its groups: the whitening product's 2 rows c^2 FLOPs
    (nothing for the elementwise work, as ``FlopCounterMode`` counts it),
    the groups read once, x (float32) and its mask (bool) written once."""
    return KernelCost(flops=2 * rows * c * c if whitened else 0,
                      bytes_accessed=read_bytes + 5 * rows * c)


def _plain(groups, itab, ftab, w, mu, coords, temporal, clip):
    return compose(groups, channels_of(itab, ftab), w, mu, temporal, clip,
                   coords)


class _Group(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p),
                ("stride", ctypes.c_longlong * MAX_DIMS),
                ("sh", ctypes.c_longlong), ("sw", ctypes.c_longlong),
                ("sc", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("group", _Group * MAX_GROUPS),
                ("size", ctypes.c_longlong * MAX_DIMS),
                ("cstride", ctypes.c_longlong * MAX_DIMS),
                ("cstride_last", ctypes.c_longlong),
                ("rows", ctypes.c_longlong),
                ("h", ctypes.c_longlong), ("w", ctypes.c_longlong),
                ("coords", ctypes.c_void_p), ("itab", ctypes.c_void_p),
                ("ftab", ctypes.c_void_p), ("wmat", ctypes.c_void_p),
                ("mu", ctypes.c_void_p), ("out_x", ctypes.c_void_p),
                ("out_m", ctypes.c_void_p), ("clip", ctypes.c_float),
                ("ndim", ctypes.c_int), ("n_groups", ctypes.c_int),
                ("c", ctypes.c_int), ("coords_i64", ctypes.c_int)]


@functools.cache
def _kernel():
    """The C function of ``csrc/feature_build.cu``, built at first use."""
    lib = load_library("feature_build")
    if lib.sizeof_args() != ctypes.sizeof(_Args):
        raise RuntimeError(f"feature_build: the C arguments take "
                           f"{lib.sizeof_args()} bytes, ctypes' "
                           f"{ctypes.sizeof(_Args)}")
    fn = lib.feature_build
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _grid_strides(g: torch.Tensor, shape: Sequence[int],
                  temporal: bool) -> List[int]:
    """Element strides of group ``g`` [..., Cg] over the data shape
    ``shape`` (x's without C), broadcast as the plain version broadcasts a
    mask: a spatial group of a temporal feature over T, then from the
    right; 0 where broadcast."""
    gs, st = list(g.shape[:-1]), list(g.stride()[:-1])
    if temporal and len(gs) == len(shape) - 1:
        gs.insert(len(gs) - 2, 1)
        st.insert(len(st) - 2, 0)
    if len(gs) > len(shape):
        raise ValueError(f"feature_build: group {tuple(g.shape)} does not "
                         f"broadcast to {tuple(shape)}")
    k = len(shape) - len(gs)
    out = []
    for n, s, want in zip([1] * k + gs, [0] * k + st, shape):
        if n != want and n != 1:
            raise ValueError(f"feature_build: group {tuple(g.shape)} does "
                             f"not broadcast to {tuple(shape)}")
        out.append(s if n == want and want != 1 else 0)
    return out


def _merge(sizes: List[int], strides: List[List[int]]
           ) -> Tuple[List[int], List[List[int]]]:
    """Drop dims of size 1 and merge neighbours wherever every group's
    strides allow, so that contiguous groups index by one dim."""
    keep = [d for d, n in enumerate(sizes) if n != 1]
    out_n: List[int] = []
    out_s: List[List[int]] = [[] for _ in strides]
    for d in keep:
        if out_n and all(s[d] * sizes[d] == o[-1]
                         for s, o in zip(strides, out_s)):
            out_n[-1] *= sizes[d]
            for s, o in zip(strides, out_s):
                o[-1] = s[d]
        else:
            out_n.append(sizes[d])
            for s, o in zip(strides, out_s):
                o.append(s[d])
    return out_n, out_s


def _out_shape(groups, c, coords, temporal) -> Tuple[int, ...]:
    data = tuple(groups[0].shape[:-1])
    if coords is None:
        return data + (c,)
    b, n = coords.shape[:2]
    return (b, n, data[1], c) if temporal else (b, n, c)


def _launch(groups, itab, ftab, w, mu, coords, temporal, clip):
    dev = groups[0].device
    for t_ in (*groups, itab, ftab, w, mu, coords):
        if t_ is not None and t_.device != dev:
            raise ValueError(f"feature_build: a tensor on {t_.device}, the "
                             f"first group on {dev}")
    a, x, mask = kernel_args(groups, itab, ftab, w, mu, coords, temporal,
                             clip)
    if a is None:
        return x, mask
    # the device guard is entered only where it changes the device
    guard = (contextlib.nullcontext()
             if dev.index == torch.cuda.current_device()
             else torch.cuda.device(dev))
    with guard:
        err = _kernel()(ctypes.byref(a),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"feature_build launch failed: cudaError {err}")
    feature_build.launches += 1
    return x, mask


def kernel_args(groups, itab, ftab, w, mu, coords, temporal, clip):
    """-> (the kernel's arguments, x, mask): the outputs allocated on the
    groups' device, every group's strides over the output's rows; the
    arguments None where there is no row. Raises where the kernel cannot
    take the build: more than :data:`MAX_GROUPS` groups, a group dtype
    outside :data:`DTYPE_CODES`, more than :data:`MAX_CHANNELS` channels
    (:data:`MAX_WHITENED_CHANNELS` whitened), coords not int32 or int64."""
    c = itab.shape[0]
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"feature_build: {len(groups)} groups, the kernel "
                         f"takes {MAX_GROUPS}")
    if c > (MAX_CHANNELS if w is None else MAX_WHITENED_CHANNELS):
        raise ValueError(f"feature_build: {c} channels, the kernel takes "
                         f"{MAX_CHANNELS}, {MAX_WHITENED_CHANNELS} whitened")
    for g in groups:
        if g.dtype not in DTYPE_CODES:
            raise TypeError(f"feature_build: no kernel for {g.dtype}")
    if itab.dtype != torch.int32 or ftab.dtype != torch.float32 or \
            not (itab.is_contiguous() and ftab.is_contiguous()) or \
            (w is not None and (w.dtype != torch.float32 or mu is None
                                or mu.dtype != torch.float32
                                or not w.is_contiguous()
                                or not mu.is_contiguous())):
        raise TypeError("feature_build: the table is int32 / float32, "
                        "contiguous")
    if coords is not None and coords.dtype not in (torch.int32,
                                                   torch.int64):
        raise TypeError(f"feature_build: coords are {coords.dtype}")
    dev = groups[0].device
    data = list(groups[0].shape[:-1])
    grid = [_grid_strides(g, data, temporal) for g in groups]
    shape = _out_shape(groups, c, coords, temporal)
    x = torch.empty(shape, dtype=torch.float32, device=dev)
    mask = torch.empty(shape, dtype=torch.bool, device=dev)
    rows = math.prod(shape[:-1])
    if rows == 0:
        return None, x, mask
    a = _Args()
    if coords is None:
        sizes, strides = _merge(data, grid)
        cstrides = [0] * len(sizes)
    else:
        if len(data) != (4 if temporal else 3) or coords.dim() != 3 or \
                coords.shape[0] != data[0] or coords.shape[2] != 2:
            raise ValueError(f"feature_build: coords {tuple(coords.shape)} "
                             f"on groups {tuple(groups[0].shape)}")
        cs = coords.stride()
        sizes = list(shape[:-1])
        # rows (b, n[, t]); the grid's own rows and cols through coords
        strides = [[s[0], 0, s[1]] if temporal else [s[0], 0] for s in grid]
        cstrides = [cs[0], cs[1], 0][:len(sizes)]
        for gi, s in enumerate(grid):
            a.group[gi].sh, a.group[gi].sw = s[-2], s[-1]
        a.coords = coords.data_ptr()
        a.coords_i64 = int(coords.dtype == torch.int64)
        a.cstride_last = cs[2]
        a.h, a.w = data[-2], data[-1]
    if len(sizes) > MAX_DIMS:
        raise ValueError(f"feature_build: {len(sizes)} row dims after "
                         f"merging, the kernel takes {MAX_DIMS}")
    for gi, (g, s) in enumerate(zip(groups, strides)):
        ag = a.group[gi]
        ag.ptr = g.data_ptr()
        ag.stride[:len(s)] = s
        ag.sc = g.stride(-1)
        ag.dtype = DTYPE_CODES[g.dtype]
    a.size[:len(sizes)] = sizes
    a.cstride[:len(cstrides)] = cstrides
    a.rows, a.ndim, a.n_groups, a.c = rows, len(sizes), len(groups), c
    a.itab, a.ftab = itab.data_ptr(), ftab.data_ptr()
    if w is not None:
        a.wmat, a.mu = w.data_ptr(), mu.data_ptr()
    a.out_x, a.out_m = x.data_ptr(), mask.data_ptr()
    a.clip = clip
    return a, x, mask


def _fake(groups, itab, ftab, w, mu, coords, temporal, clip):
    shape = _out_shape(groups, itab.shape[0], coords, temporal)
    return (groups[0].new_empty(shape, dtype=torch.float32),
            groups[0].new_empty(shape, dtype=torch.bool))


def _flops(groups, itab, ftab, w, mu, coords, temporal, clip,
           out_shape=None):
    return feature_build_cost(0, math.prod(out_shape[0][:-1]), itab[0],
                              w is not None).flops


_library.define(
    "feature_build", "(Tensor[] groups, Tensor itab, Tensor ftab, Tensor? w, "
    "Tensor? mu, Tensor? coords, bool temporal, float clip) "
    "-> (Tensor, Tensor)", cpu=_plain, cuda=_launch, fake=_fake,
    flops=_flops)


def feature_build(groups: Sequence[torch.Tensor], itab: torch.Tensor,
                  ftab: torch.Tensor, w: Optional[torch.Tensor],
                  mu: Optional[torch.Tensor],
                  coords: Optional[torch.Tensor], temporal: bool,
                  clip: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One build: ``groups`` in slot order (the value group of the first
    channel first; it gives x's shape), the table of :func:`table` and, for
    a whitened feature, W [C, C] and its mean [C] on the groups' device,
    ``coords`` [B, N, 2] or None. -> (x float32, mask bool), [..., C] or at
    ``coords`` [B, N(, T), C]. The op ``forest_tpu_torch::feature_build``."""
    return torch.ops.forest_tpu_torch.feature_build(
        list(groups), itab, ftab, w, mu, coords, bool(temporal),
        float(clip))


feature_build.launches = 0
feature_build.builds = {"kernel": 0, "composed": 0}

__all__ = ["feature_build", "feature_build_cost", "compose", "table",
           "channels_of", "kernel_takes", "normalize", "f32", "Channel",
           "Norm", "DTYPE_CODES", "TRANSFORM_IDS", "AFFINE", "RESCALE", "LO",
           "HI"]
