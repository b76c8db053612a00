"""One gated residual block of the phase TCN in one launch, and its plain
version.

:class:`~forest_tpu_torch.models.representation.RepresentationModel` runs
its phase TCN's blocks through :func:`tcn_block` (``TCNEncoder.
run_kernel``), the ``torch.library`` op ``forest_tpu_torch::tcn_block``,
in inference on a card (:func:`kernel_takes`: a CUDA float32 input,
autograd off; and no dropout); elsewhere it runs the modules as before:

- a CUDA tensor launches a hand-written kernel of ``csrc/tcn_block.cu``,
  one launch a block, in float32 multiply-adds: the dilated conv, the
  GroupNorm, the gate, the residual (or its projection) and the mix, with
  the head (a Linear) and the FiLM modulation gamma z + beta in the last
  block's epilogue. The v1 model's blocks (3 taps at dilation 1, 2 or 4,
  1-15 steps, 64 outputs in 8 groups, an input of 64 or at most 24
  projected channels, a head of at most 8) run the tiled kernel; every
  other block a general one, a series a thread block. A block neither
  takes (:func:`kernel_args`: its series too long for shared memory, an
  even kernel size, a width without its projection) raises.
  ``tcn_block.launches`` counts the launches;
- a CPU tensor runs the plain version, :func:`compose`: the block's PyTorch
  operations, as ``GatedResidualBlock`` runs them.

Layouts: x is [N, T, C] (series, steps, channels) or [B, T, H, W, C], read
in place through its strides. The output has x's rank: [N, T, C_out], or
[B, T, H, W, C_out] stored series-major ([B, H, W, T, C_out], a permuted
view) so that the next block reads each series at once; with a head, [N, T,
Z] or [B, T, H, W, Z], contiguous.

``tcn_block.calls`` counts the blocks the TCN ran by path ("kernel": the op,
"composed": the modules). The op's FLOP formula is its declared cost,
:func:`tcn_block_cost`: what ``FlopCounterMode`` counts for the composed
block's convolutions and head (every tap, the padding's too).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from forest_tpu_torch.ops import _library
from forest_tpu_torch.ops._cuda_build import load_library
from forest_tpu_torch.utils.flops import KernelCost

# the shared memory a thread block may ask for (csrc/tcn_block.cu)
MAX_SMEM = 227 * 1024


def any_smem_bytes(steps: int, in_width: int, out_width: int,
                   num_groups: int, head: bool) -> int:
    """The general kernel's shared memory for a series (csrc/tcn_block.cu's
    ``any_smem_bytes``): x, h and with a head y, each group's mean and
    rstd. The tiled kernel asks for less wherever it runs."""
    return 4 * (steps * in_width + steps * out_width * (2 if head else 1)
                + 2 * num_groups)


def kernel_takes(x: torch.Tensor) -> bool:
    """Whether a block on ``x`` runs on the op's kernel now: a CUDA float32
    input, autograd off (the caller rules out dropout). The op then
    launches a kernel, or raises (:func:`kernel_args`): it never gives way
    to the modules on the card."""
    return (x.is_cuda and x.dtype == torch.float32
            and not torch.is_grad_enabled())


def _series(x: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """-> ((B, H, W), their strides) of the series of x [N, T, C] (B = H =
    1) or [B, T, H, W, C]."""
    if x.dim() == 3:
        return (1, 1, x.shape[0]), (0, 0, x.stride(0))
    return ((x.shape[0], x.shape[2], x.shape[3]),
            (x.stride(0), x.stride(2), x.stride(3)))


def _out(x: torch.Tensor, width: int, series_major: bool) -> torch.Tensor:
    """The output for x at ``width`` channels (see the module's note)."""
    if x.dim() == 3:
        return x.new_empty((x.shape[0], x.shape[1], width))
    b, t, h, w, _ = x.shape
    if series_major:
        return x.new_empty((b, h, w, t, width)).permute(0, 3, 1, 2, 4)
    return x.new_empty((b, t, h, w, width))


def compose(x, conv_w, conv_b, norm_w, norm_b, gate_w, gate_b, proj_w,
            proj_b, head_w, head_b, gamma, beta, dilation: int,
            num_groups: int, eps: float) -> torch.Tensor:
    """The block in PyTorch operations, as ``GatedResidualBlock`` (and then
    ``phase_head`` and ``FiLMLayer.modulate``) compute it: the op's plain
    version."""
    if x.dim() == 5:
        b, t, h, w, c = x.shape
        flat = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    else:
        flat = x
    xc = flat.transpose(1, 2)                                 # [N, C, T]
    res = xc if proj_w is None else F.conv1d(xc, proj_w, proj_b)
    pad = (conv_w.shape[-1] - 1) * dilation // 2
    u = F.conv1d(xc, conv_w, conv_b, padding=pad, dilation=dilation)
    hn = F.group_norm(u, num_groups, norm_w, norm_b, eps)
    g = torch.sigmoid(F.conv1d(hn, gate_w, gate_b))
    y = (g * torch.relu(hn) + (1.0 - g) * res).transpose(1, 2)
    if head_w is not None:
        y = F.linear(y, head_w, head_b)
        if gamma is not None:
            y = gamma[:, None, :] * y + beta[:, None, :]
    if x.dim() == 3:
        return y
    out = y.reshape(b, h, w, t, -1).permute(0, 3, 1, 2, 4)
    return out.contiguous() if head_w is not None else out


def tcn_block_cost(rows: int, in_width: int, out_width: int, taps: int,
                   projected: bool, head: int) -> KernelCost:
    """One block over ``rows`` series steps: 2 FLOPs a multiply-add of the
    conv (every one of its ``taps``), the gate, the projection and the
    head, as ``FlopCounterMode`` counts the composed block's convolutions
    and Linear; the input read once and the output (``head`` wide, or
    ``out_width``) written once, float32."""
    macs = (taps * in_width * out_width + out_width * out_width
            + (in_width * out_width if projected else 0)
            + head * out_width)
    return KernelCost(flops=2 * rows * macs,
                      bytes_accessed=4 * rows * (in_width
                                                 + (head or out_width)))


class _Args(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "x", "conv_w", "conv_b", "norm_w", "norm_b", "gate_w", "gate_b",
        "proj_w", "proj_b", "head_w", "head_b", "gamma", "beta", "out")] + \
        [(f, ctypes.c_longlong) for f in (
            "n0", "n1", "n2", "xs0", "xs1", "xs2", "xst", "xsc", "os0",
            "os1", "os2", "ost", "n")] + \
        [(f, ctypes.c_int) for f in ("t", "cin", "z", "dilation", "c",
                                     "groups", "ksize")] + \
        [("eps", ctypes.c_float), ("x_vec", ctypes.c_int),
         ("out_vec", ctypes.c_int)]


@functools.cache
def _kernel():
    """The C function of ``csrc/tcn_block.cu``, built at first use."""
    lib = load_library("tcn_block")
    if lib.sizeof_args() != ctypes.sizeof(_Args):
        raise RuntimeError(f"tcn_block: the C arguments take "
                           f"{lib.sizeof_args()} bytes, ctypes' "
                           f"{ctypes.sizeof(_Args)}")
    fn = lib.tcn_block
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor, strides: Sequence[int]) -> bool:
    """Whether every row of t starts 16 bytes aligned."""
    return t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in strides)


def kernel_args(x, conv_w, conv_b, norm_w, norm_b, gate_w, gate_b, proj_w,
                proj_b, head_w, head_b, gamma, beta, dilation, num_groups,
                eps):
    """-> (the kernel's arguments, out): the output allocated on x's
    device; the arguments None where there is no series. Raises where the
    kernel cannot take the block."""
    if x.dim() not in (3, 5):
        raise ValueError(f"tcn_block: x {tuple(x.shape)} is neither [N, T, "
                         f"C] nor [B, T, H, W, C]")
    c_out, c_in, k = conv_w.shape
    steps = x.shape[1]
    z = 0 if head_w is None else head_w.shape[0]
    if not (x.shape[-1] == c_in and k % 2 == 1 and dilation >= 1
            and c_out % num_groups == 0
            and (proj_w is not None or c_in == c_out)
            and any_smem_bytes(steps, c_in, c_out, num_groups,
                               head_w is not None) <= MAX_SMEM):
        raise ValueError(f"tcn_block: no kernel for x {tuple(x.shape)}, "
                         f"conv {tuple(conv_w.shape)}, dilation {dilation}, "
                         f"{num_groups} groups, head {z}")
    weights = [conv_w, conv_b, norm_w, norm_b, gate_w, gate_b, proj_w,
               proj_b, head_w, head_b, gamma, beta]
    for t_ in [x] + weights:
        if t_ is None:
            continue
        if t_.dtype != torch.float32 or t_.device != x.device:
            raise TypeError("tcn_block: every tensor float32 on x's device")
    for t_ in weights:
        if t_ is not None and not t_.is_contiguous():
            raise ValueError("tcn_block: the weights are contiguous")
    if (gamma is None) != (beta is None) or \
            (gamma is not None and head_w is None):
        raise ValueError("tcn_block: FiLM takes gamma and beta, and a head")
    out = _out(x, z or c_out, series_major=head_w is None)
    sizes, strides = _series(x)
    n = math.prod(sizes)
    if gamma is not None and tuple(gamma.shape) != (n, z):
        raise ValueError(f"tcn_block: gamma {tuple(gamma.shape)}, want "
                         f"{(n, z)}")
    if n == 0 or steps == 0:
        return None, out
    _, ostrides = _series(out)
    a = _Args()
    for f, t_ in zip(("x", "conv_w", "conv_b", "norm_w", "norm_b", "gate_w",
                      "gate_b", "proj_w", "proj_b", "head_w", "head_b",
                      "gamma", "beta", "out"), [x] + weights + [out]):
        setattr(a, f, None if t_ is None else t_.data_ptr())
    a.n0, a.n1, a.n2 = sizes
    a.xs0, a.xs1, a.xs2 = strides
    a.xst, a.xsc = x.stride(-4 if x.dim() == 5 else 1), x.stride(-1)
    a.os0, a.os1, a.os2 = ostrides
    a.ost = out.stride(-4 if out.dim() == 5 else 1)
    a.n, a.t, a.cin, a.z, a.dilation = n, steps, c_in, z, dilation
    a.c, a.groups, a.ksize = c_out, num_groups, k
    a.eps = eps
    a.x_vec = int(c_in % 4 == 0 and a.xsc == 1
                  and _aligned(x, (*strides, a.xst)))
    a.out_vec = int(_aligned(out, (*ostrides, a.ost)))
    return a, out


def _launch(x, conv_w, conv_b, norm_w, norm_b, gate_w, gate_b, proj_w,
            proj_b, head_w, head_b, gamma, beta, dilation, num_groups, eps):
    a, out = kernel_args(x, conv_w, conv_b, norm_w, norm_b, gate_w, gate_b,
                         proj_w, proj_b, head_w, head_b, gamma, beta,
                         dilation, num_groups, eps)
    if a is None:
        return out
    dev = x.device
    # the device guard is entered only where it changes the device
    guard = (contextlib.nullcontext()
             if dev.index == torch.cuda.current_device()
             else torch.cuda.device(dev))
    with guard:
        err = _kernel()(ctypes.byref(a),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tcn_block launch failed: cudaError {err}")
    tcn_block.launches += 1
    return out


def _fake(x, conv_w, conv_b, norm_w, norm_b, gate_w, gate_b, proj_w,
          proj_b, head_w, head_b, gamma, beta, dilation, num_groups, eps):
    return _out(x, conv_w.shape[0] if head_w is None else head_w.shape[0],
                series_major=head_w is None)


def _flops(x, conv_w, conv_b, norm_w, norm_b, gate_w, gate_b, proj_w,
           proj_b, head_w, head_b, gamma, beta, dilation, num_groups, eps,
           out_shape=None):
    c_out, c_in, k = conv_w
    rows = math.prod(x[:-1])
    return tcn_block_cost(rows, c_in, c_out, k, proj_w is not None,
                          0 if head_w is None else head_w[0]).flops


_library.define(
    "tcn_block", "(Tensor x, Tensor conv_w, Tensor conv_b, Tensor norm_w, "
    "Tensor norm_b, Tensor gate_w, Tensor gate_b, Tensor? proj_w, "
    "Tensor? proj_b, Tensor? head_w, Tensor? head_b, Tensor? gamma, "
    "Tensor? beta, int dilation, int num_groups, float eps) -> Tensor",
    cpu=compose, cuda=_launch, fake=_fake, flops=_flops)


def tcn_block(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
              norm_w: torch.Tensor, norm_b: torch.Tensor,
              gate_w: torch.Tensor, gate_b: torch.Tensor,
              proj_w: Optional[torch.Tensor], proj_b: Optional[torch.Tensor],
              head_w: Optional[torch.Tensor] = None,
              head_b: Optional[torch.Tensor] = None,
              gamma: Optional[torch.Tensor] = None,
              beta: Optional[torch.Tensor] = None, *, dilation: int,
              num_groups: int, eps: float) -> torch.Tensor:
    """One block on x [N, T, C_in] or [B, T, H, W, C_in]: the conv's
    weight [C_out, C_in, 3] and bias, GroupNorm's, the gate's [C_out,
    C_out, 1], the projection's [C_out, C_in, 1] or None, and for the
    last block the head's [Z, C_out] and FiLM's gamma and beta [N, Z] (N
    the series, in (b, h, w) order) or None. The op ``forest_tpu_torch::
    tcn_block``; the output's layout is in the module's note."""
    return torch.ops.forest_tpu_torch.tcn_block(
        x, conv_w, conv_b, norm_w, norm_b, gate_w, gate_b, proj_w, proj_b,
        head_w, head_b, gamma, beta, int(dilation), int(num_groups),
        float(eps))


tcn_block.launches = 0
tcn_block.calls = {"kernel": 0, "composed": 0}

__all__ = ["tcn_block", "tcn_block_cost", "compose", "kernel_takes",
           "kernel_args", "any_smem_bytes", "MAX_SMEM"]
