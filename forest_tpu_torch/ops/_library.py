"""The ``torch.library`` namespace ``forest_tpu_torch`` of the port's kernels.

Each hand-written kernel is an op there: its plain version runs for CPU
tensors, its launch for CUDA tensors, a fake gives the output shapes, and
its FLOP formula is its declared cost (``utils/flops.KernelCost``), which is
what ``torch.utils.flop_counter.FlopCounterMode`` counts for the op in place
of anything its body runs.

The ops are defined with ``torch.library.Library.define`` and ``impl``, not
``torch.library.custom_op``: ``custom_op`` runs each kernel inside
``torch._dynamo.disable``, which imports ``torch._dynamo`` (some 800
modules) at the first call of an op and switches the frame evaluator at
every call. The port compiles nothing, and the training step is host-bound.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "forest_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


def define(name: str, schema: str, *, cpu: Callable, cuda: Callable,
           fake: Callable, flops: Optional[Callable] = None):
    """Define the op ``forest_tpu_torch::<name>`` with ``schema`` (its
    arguments and returns, as in ``"(Tensor x) -> Tensor"``): ``cpu`` runs
    for CPU tensors, ``cuda`` for CUDA tensors, ``fake`` for shapes alone;
    ``flops(*args, out_shape=...)``, with every tensor argument replaced by
    its shape, is its FLOP formula. -> the op (``torch.ops.forest_tpu_torch.
    <name>``)."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name)
    if flops is not None:
        register_flop_formula(op)(flops)
    return op


def register_autograd(name: str, backward: Callable,
                      setup_context: Callable) -> None:
    """The gradient of ``forest_tpu_torch::<name>``, as
    ``torch.library.register_autograd`` takes it."""
    torch.library.register_autograd(f"{NAMESPACE}::{name}", backward,
                                    setup_context=setup_context, lib=_LIB)
