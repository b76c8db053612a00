"""Row extraction from a [B, R, C] grid and its backward, a row scatter-add.

Port of ``forest_tpu/ops/scatter.py``. The FRL step extracts ~2k rows per
sample from the [B, H*W, C] type-embedding grid (anchors, positive
neighbours and the shared negative pool); the gradient of that gather is

    out[b, p, c] = sum over j with idx[b, j] == p of dz[b, j, c]

- :func:`scatter_add_rows` is the wrapper of the hand-written CUDA kernel
  in ``csrc/scatter_add_rows.cu``, one launch: a block owns a tile of
  output rows of one sample, scans that sample's indices itself, adds the
  rows that land in its tile in ascending j in registers and stores the
  tile once, zeros included. No atomic, no scratch memory, ``out`` from
  ``torch.empty`` and never read: the bytes moved to device memory are the
  bound's (``out`` once, ``dz`` and the indices once), and the result is
  the same bit for bit in every run. The scan is cheap while N is a few
  thousand (the source says where it stops). A CPU tensor goes to the plain
  version :func:`scatter_add_rows_reference` (``index_add_`` per sample,
  which on the CPU adds in ascending j too); a CUDA tensor launches the
  kernel or raises. ``scatter_add_rows.launches`` counts the launches. It
  is the ``torch.library`` op ``forest_tpu_torch::scatter_add_rows``,
  whose FLOP formula is its declared cost, :func:`scatter_add_rows_cost`
  (``utils/flops.py``); the op returns the kernel's flag of bad indices
  beside the sum, and the wrapper reads it outside the op.
- :func:`extract_rows` is the op ``forest_tpu_torch::extract_rows``: the
  forward is a plain gather, the registered gradient is
  :func:`scatter_add_rows` without its host check of the indices (they
  passed the forward's gather), cast back to the grid's dtype.
- :func:`extract_at_coords` takes a [B, H, W, C] grid and (row, col)
  coordinates.

The tile grouping, one-hot permutation and per-tile capacity of the JAX
package's version exist only for the TPU's matrix unit and are not here.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from forest_tpu_torch.ops import _library
from forest_tpu_torch.ops._cuda_build import load_library
from forest_tpu_torch.utils.flops import KernelCost


@functools.cache
def _kernel():
    """The C function of ``csrc/scatter_add_rows.cu``, built at first use."""
    fn = load_library("scatter_add_rows").scatter_add_rows_f32
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_index(flat_idx: torch.Tensor, n_rows: int) -> None:
    if flat_idx.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.stack(flat_idx.aminmax()).tolist())
    if lo < 0 or hi >= n_rows:
        raise IndexError(f"scatter_add_rows: indices span [{lo}, {hi}], "
                         f"outside [0, {n_rows})")


def scatter_add_rows_reference(dz: torch.Tensor, flat_idx: torch.Tensor,
                               n_rows: int) -> torch.Tensor:
    """Plain version: ``index_add_`` per sample, in float32."""
    dz = dz.float()
    bsz, _, c = dz.shape
    _check_index(flat_idx, n_rows)
    out = torch.zeros(bsz, n_rows, c, dtype=torch.float32, device=dz.device)
    for i in range(bsz):
        out[i].index_add_(0, flat_idx[i].long(), dz[i])
    return out


def scatter_add_rows_cost(dz_shape, n_rows: int) -> KernelCost:
    """One call of ``scatter_add_rows`` on dz [B, N, C]: one add per
    scattered element; dz (float32) and the indices (int32, as the training
    step passes them) read once, the [B, n_rows, C] float32 output written
    once (the B words of the index flag are left out).

    The Pallas estimate (``forest_tpu/ops/scatter.py:146``) counts the
    one-hot product of every tile of rows with its capacity of dz rows, 2
    B n_rows cap C FLOPs, and reads each tile's slice of dz again."""
    b, n, c = dz_shape
    return KernelCost(flops=b * n * c,
                      bytes_accessed=4 * b * n * c + 4 * b * n
                      + 4 * b * n_rows * c)


def _plain(dz, flat_idx, n_rows):
    out = scatter_add_rows_reference(dz, flat_idx, n_rows)
    return out, torch.zeros(dz.shape[0], dtype=torch.int32)


def _launch(dz, flat_idx, n_rows):
    """-> (out, one int32 flag per sample, set where an index lay outside
    [0, n_rows)): the kernel on the current stream."""
    bsz, n, c = dz.shape
    if n_rows < 1 or n_rows > 2 ** 31 - 1:
        raise ValueError(f"scatter_add_rows: n_rows={n_rows}")
    if dz.numel() == 0:
        return (torch.zeros(bsz, n_rows, c, dtype=torch.float32,
                            device=dz.device),
                torch.zeros(bsz, dtype=torch.int32, device=dz.device))
    dz = dz.float().contiguous()
    idx = flat_idx.contiguous()
    out = torch.empty(bsz, n_rows, c, dtype=torch.float32, device=dz.device)
    bad = torch.empty(bsz, dtype=torch.int32, device=dz.device)
    # this wrapper's time on the host is part of every call's: the device
    # guard is entered only where it changes the device
    guard = (contextlib.nullcontext()
             if dz.device.index == torch.cuda.current_device()
             else torch.cuda.device(dz.device))
    with guard:
        stream = torch.cuda.current_stream(dz.device).cuda_stream
        err = _kernel()(dz.data_ptr(), idx.data_ptr(),
                        int(idx.dtype == torch.int64), out.data_ptr(),
                        bad.data_ptr(), bsz, n, n_rows, c, stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows launch failed: cudaError {err}")
    scatter_add_rows.launches += 1
    return out, bad


_library.define(
    "scatter_add_rows", "(Tensor dz, Tensor flat_idx, int n_rows) "
    "-> (Tensor, Tensor)", cpu=_plain, cuda=_launch,
    fake=lambda dz, flat_idx, n_rows: (
        dz.new_empty(dz.shape[0], n_rows, dz.shape[2], dtype=torch.float32),
        dz.new_empty(dz.shape[0], dtype=torch.int32)),
    flops=lambda dz, flat_idx, n_rows, out_shape=None: scatter_add_rows_cost(
        dz, n_rows).flops)


def scatter_add_rows(dz: torch.Tensor, flat_idx: torch.Tensor,
                     n_rows: int, *, check_index: bool = True
                     ) -> torch.Tensor:
    """out[b, p, c] = sum over j with flat_idx[b, j] == p of dz[b, j, c].

    dz [B, N, C] (taken in float32), flat_idx [B, N] int32 or int64 in
    [0, n_rows); out [B, n_rows, C] float32. The op
    ``forest_tpu_torch::scatter_add_rows``.

    An index outside the range never writes outside ``out``. What the
    caller learns of it depends on ``check_index``:

    - ``True`` (the default, for direct callers): ``IndexError``. On a CPU
      tensor it is raised before anything is computed; on a CUDA tensor the
      kernel leaves the row out and raises a flag on the device, which
      this function reads back after the launch (one host synchronise).
    - ``False`` (the backward of :func:`extract_rows`): on a CUDA tensor the
      flag is not read, nothing synchronises, and a row with a bad index is
      left out of the sum silently. A CPU tensor is checked all the same.
    """
    if dz.dim() != 3 or flat_idx.shape != dz.shape[:2]:
        raise ValueError(f"scatter_add_rows: dz {tuple(dz.shape)} must be "
                         f"[B, N, C] and flat_idx {tuple(flat_idx.shape)} "
                         f"[B, N]")
    if flat_idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"scatter_add_rows: flat_idx is {flat_idx.dtype}, "
                        f"must be int32 or int64")
    if flat_idx.device != dz.device:
        raise ValueError(f"scatter_add_rows: flat_idx on {flat_idx.device}, "
                         f"dz on {dz.device}")
    if dz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scatter_add_rows: no kernel for device "
                         f"{dz.device}")
    out, bad = torch.ops.forest_tpu_torch.scatter_add_rows(dz, flat_idx,
                                                           n_rows)
    if check_index and dz.device.type == "cuda" and bad.any().item():
        raise IndexError(f"scatter_add_rows: an index lies outside "
                         f"[0, {n_rows})")
    return out


scatter_add_rows.launches = 0


def _gather(grid, flat_idx):
    idx = flat_idx.long()[:, :, None].expand(-1, -1, grid.shape[2])
    return torch.take_along_dim(grid, idx, dim=1)


_library.define(
    "extract_rows", "(Tensor grid, Tensor flat_idx) -> Tensor", cpu=_gather,
    cuda=_gather, fake=lambda grid, flat_idx: grid.new_empty(
        grid.shape[0], flat_idx.shape[1], grid.shape[2]))


def _save_index(ctx, inputs, output):
    grid, flat_idx = inputs
    ctx.save_for_backward(flat_idx)
    ctx.n_rows = grid.shape[1]
    ctx.grid_dtype = grid.dtype


def _extract_rows_backward(ctx, ct):
    """The gradient of the gather: :func:`scatter_add_rows` (the op) without
    its host check of the indices (they passed the forward's gather), cast
    back to the grid's dtype."""
    (flat_idx,) = ctx.saved_tensors
    dg = scatter_add_rows(ct, flat_idx, ctx.n_rows, check_index=False)
    return dg.to(ctx.grid_dtype), None


_library.register_autograd("extract_rows", _extract_rows_backward,
                           _save_index)


def extract_rows(grid: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """grid [B, R, C], flat_idx [B, N] -> [B, N, C]; the op
    ``forest_tpu_torch::extract_rows``, whose gradient is
    :func:`scatter_add_rows` with ``check_index=False``: on a CUDA tensor it
    makes no host synchronise."""
    return torch.ops.forest_tpu_torch.extract_rows(grid, flat_idx)


def extract_at_coords(grid: torch.Tensor,
                      coords: torch.Tensor) -> torch.Tensor:
    """grid [B, H, W, C], coords [B, N, 2] (row, col) -> [B, N, C]."""
    b, h, w, c = grid.shape
    flat = coords[..., 0] * w + coords[..., 1]
    return extract_rows(grid.reshape(b, h * w, c), flat)


__all__ = ["scatter_add_rows", "scatter_add_rows_reference",
           "scatter_add_rows_cost", "extract_rows", "extract_at_coords"]
