"""Compact host-to-device wire format for training batches.

Port of ``forest_tpu/data/wire.py``. The encoder runs on the host loader's
side and shrinks a batch before its copy to the device:

- float32 / float64 arrays travel as bfloat16 (half the bytes; the inputs
  are z-scored features, so bfloat16's rounding is far below their noise);
- ``*_nan_mask`` uint8 validity planes whose companion data array has more
  than two dimensions travel bit-packed (``np.packbits`` along axis 1,
  big-endian bit order: 8x fewer bytes);
- integer id arrays named in ``int_bounds`` travel as uint8 / uint16 (or
  int8 / int16 when a sentinel such as IGNORE_INDEX = -100 rides along),
  by the caller's schema-derived bound;
- keys in ``skip``, and keys whose group name contains ``"categorical"``,
  travel as they are (class codes such as EVT 7000+ in float arrays are not
  exact in bfloat16);
- a loader may assemble a channel-stacked group channel-major,
  [B, C, (T,) H, W] under ``<name>__cm`` (``ForestDatasetV2.
  set_wire_layout``): each source channel is then one contiguous copy
  into the batch buffer.

A bfloat16 leaf is a CPU ``torch.bfloat16`` tensor (numpy has no bfloat16),
rounded to nearest even by torch, with NaN made ``sign | 0x7FC0`` as
``ml_dtypes`` makes it; every other leaf stays a numpy array. So an
encoded batch equals the JAX package's key for key, dtype for dtype and bit
for bit, its bfloat16 leaves compared as uint16.

:func:`decode_wire_batch` runs on the device at the top of every train and
eval step and is the identity on a batch that never went through the
encoder: bfloat16 -> float32, packed masks unpacked against the
companion's shape, ``<name>__cm`` moved back to channel-last ``<name>`` as a
contiguous tensor (the kernels' wrappers and the step's gathers take dense
channel-last tensors). One deliberate difference from the JAX decode,
which leaves narrow ints as they are: torch's uint16, int8 and int16 lack
the indexing kernels that embeddings, one-hots and the loss's
``ignore_index`` need, so an id narrowed by the wire (a uint8, uint16, int8
or int16 leaf that is not a ``*_nan_mask``) is widened back on the device
to int32, the dtype the plain batch carries ids in. The values are
unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_MASK_SUFFIX = "_nan_mask"
# "<name>__cm" holds [B, C, (T,) H, W]; decode moves C last and strips it
_CM_SUFFIX = "__cm"
# ml_dtypes' bfloat16 NaN: the sign kept, the quiet bit set
_BF16_NAN = 0x7FC0
# the wire's other narrow id dtypes (uint16 is widened through int16's bits)
_NARROW_INTS = (torch.uint8, torch.int8, torch.int16)


def _pack_mask(mask: np.ndarray) -> np.ndarray:
    """[B, ...] uint8 0/1 -> [B, ceil(S/8)] uint8 (bitorder big)."""
    b = mask.shape[0]
    return np.packbits(np.asarray(mask, np.uint8).reshape(b, -1), axis=1)


def _companion_ndim(batch: Dict[str, Any], mask_key: str) -> int:
    """ndim of the data array a ``*_nan_mask`` key annotates (0 if absent).
    A companion stored under ``<name>__cm`` is not found, as in the JAX
    package, so its mask travels unpacked."""
    data = batch.get(mask_key[:-len(_MASK_SUFFIX)])
    return np.ndim(data) if data is not None else 0


def to_bfloat16(a: np.ndarray) -> torch.Tensor:
    """float32 / float64 numpy -> CPU bfloat16 tensor with ml_dtypes' bits:
    round to nearest even from float32 (float64 goes through float32 first,
    as ml_dtypes' cast does), NaN as sign | 0x7FC0."""
    a32 = np.ascontiguousarray(a, np.float32)
    out = torch.from_numpy(a32).to(torch.bfloat16)
    nan = np.isnan(a32)
    if nan.any():
        bits = out.view(torch.int16)
        neg = torch.from_numpy(np.signbit(a32) & nan)
        bits[torch.from_numpy(nan)] = _BF16_NAN
        bits[neg] = (_BF16_NAN | 0x8000) - 0x10000      # 0xFFC0 as int16
    return out


def _narrow(a: np.ndarray, spec) -> np.ndarray:
    lo, hi = ((int(spec[0]), int(spec[1]))
              if isinstance(spec, (tuple, list)) else (0, int(spec)))
    if lo >= 0:
        if hi <= 2 ** 8:
            return a.astype(np.uint8)
        if hi <= 2 ** 16:
            return a.astype(np.uint16)
        return a
    if lo >= -2 ** 7 and hi <= 2 ** 7:
        return a.astype(np.int8)
    if lo >= -2 ** 15 and hi <= 2 ** 15:
        return a.astype(np.int16)
    return a


def encode_wire_batch(batch: Dict[str, Any], skip: tuple = (),
                      int_bounds: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """Host side: shrink a loader batch (one level of nested dicts) for the
    copy to the device, by the rules of the module docstring.

    ``int_bounds`` maps id-array keys (matched at any nesting level) to an
    exclusive upper bound ``hi`` (the array is non-negative) or an
    ``(lo, hi)`` pair (lo inclusive). The bound is a dataset property the
    caller asserts, from the schema, never a per-batch maximum."""
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = encode_wire_batch(v, skip, int_bounds)
            continue
        a = np.asarray(v)
        # the skip rules match the group name, not the layout-decorated key
        base = k[:-len(_CM_SUFFIX)] if k.endswith(_CM_SUFFIX) else k
        if base in skip or "categorical" in base:
            out[k] = a
        elif k.endswith(_MASK_SUFFIX) and a.dtype == np.uint8 \
                and a.ndim >= 2 and _companion_ndim(batch, k) > 2:
            # pack only what decode can unpack: decode knows a packed mask
            # by (mask.ndim == 2, companion.ndim > 2)
            out[k] = _pack_mask(a)
        elif a.dtype in (np.float32, np.float64):
            out[k] = to_bfloat16(a)
        elif int_bounds and base in int_bounds \
                and a.dtype in (np.int32, np.int64):
            out[k] = _narrow(a, int_bounds[base])
        else:
            out[k] = a
    return out


def stack_batches(batches) -> Dict[str, Any]:
    """Host side: K same-shaped batches -> one batch whose every leaf is an
    owning, contiguous array or tensor with a leading K axis (the block of
    ``vqvae_step.make_scan_train_step``, copied to the device in one pinned
    copy per leaf)."""
    out: Dict[str, Any] = {}
    for k, v in batches[0].items():
        if isinstance(v, dict):
            out[k] = stack_batches([b[k] for b in batches])
        elif isinstance(v, torch.Tensor):
            out[k] = torch.stack([b[k] for b in batches])
        else:
            out[k] = np.stack([np.asarray(b[k]) for b in batches])
    return out


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def _unpack_mask(v: torch.Tensor, shape) -> torch.Tensor:
    """[B, ceil(S/8)] packed uint8 -> ``shape`` uint8 0/1."""
    b = v.shape[0]
    s = int(np.prod(shape[1:]))
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=v.device)
    bits = (v[:, :, None] >> shifts) & 1
    return bits.reshape(b, -1)[:, :s].reshape(shape)


def decode_wire_batch(batch: Dict[str, Any],
                      device=None) -> Dict[str, Any]:
    """Device side: the inverse of :func:`encode_wire_batch` (module
    docstring); the identity on a plain batch. With ``device``, a tensor
    leaf on another device raises ``ValueError``: nothing falls back to
    the host."""
    dev = torch.device(device) if device is not None else None
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = decode_wire_batch(v, device)
            continue
        if not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        if dev is not None and not _on(v, dev):
            raise ValueError(f"batch leaf {k!r} is on {v.device}, the step "
                             f"runs on {dev}")
        if k.endswith(_CM_SUFFIX):
            x = v.float() if v.dtype == torch.bfloat16 else v
            out[k[:-len(_CM_SUFFIX)]] = torch.movedim(x, 1, -1).contiguous()
            continue
        if k.endswith(_MASK_SUFFIX):
            data = batch.get(k[:-len(_MASK_SUFFIX)])
            if data is not None and v.ndim == 2 and data.ndim > 2:
                out[k] = _unpack_mask(v, tuple(data.shape))
                continue
            out[k] = v
        elif v.dtype == torch.bfloat16:
            out[k] = v.float()
        elif v.dtype == torch.uint16:
            # through int16's bits: uint16 has no conversion kernels
            out[k] = v.view(torch.int16).to(torch.int32) & 0xFFFF
        elif v.dtype in _NARROW_INTS:
            out[k] = v.to(torch.int32)
        else:
            out[k] = v
    return out


def wire_bytes(batch: Dict[str, Any]) -> int:
    """Bytes of every leaf of a host batch, as they cross to the device."""
    n = 0
    for v in batch.values():
        if isinstance(v, dict):
            n += wire_bytes(v)
        elif isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
        else:
            n += np.asarray(v).nbytes
    return n


__all__ = ["encode_wire_batch", "decode_wire_batch", "stack_batches",
           "to_bfloat16", "wire_bytes"]
