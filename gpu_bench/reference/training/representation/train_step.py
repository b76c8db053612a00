# Frozen copy of forest_tpu_torch/training/representation/train_step.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""FRL train step: gradients, non-finite containment, clipped AdamW.

The port's ``training/representation/train_step.py`` without its checkpoint
layout, data parallelism and compact wire: the total loss's gradients,
clipped by their global norm, then AdamW in optax's formulation (the
weight decay added to the Adam direction; clipping by
``clip / max(norm, clip)``). A non-finite loss or gradient norm skips the
update.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple, Union

import torch
from torch import nn

LearningRate = Union[float, Callable[[int], float]]

# Adam's decay rates and epsilon: optax.adamw's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamW:
    """Global-norm clipping followed by AdamW, in optax's formulation.
    Parameters named in ``no_decay`` get no weight decay."""
    learning_rate: LearningRate
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    no_decay: Tuple[str, ...] = ()


@dataclass
class FRLTrainState:
    """The model, AdamW's moments by parameter name, the updates applied
    (``count``) and the steps taken (``step``)."""
    model: nn.Module
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)
    count: int = 0
    step: int = 0


def init_train_state(model: nn.Module) -> FRLTrainState:
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return FRLTrainState(model, zeros,
                         {n: torch.zeros_like(p) for n, p in zeros.items()})


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (float32)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def apply_update(state: FRLTrainState, optimizer: AdamW,
                 grads: Dict[str, torch.Tensor],
                 gnorm: torch.Tensor) -> None:
    """One clipped AdamW update in place on ``state``. Written with the
    multi-tensor ``torch._foreach_*`` ops: a handful of launches for all
    parameters instead of a dozen for each."""
    o = optimizer
    lr = o.learning_rate(state.count) if callable(o.learning_rate) \
        else o.learning_rate
    # clip_by_global_norm: g unchanged below the limit, else g / norm * clip
    scale = torch.where(gnorm < o.grad_clip, torch.ones_like(gnorm),
                        o.grad_clip / gnorm)
    state.count += 1
    c1 = 1.0 - B1 ** state.count
    c2 = 1.0 - B2 ** state.count
    names, params = zip(*state.model.named_parameters())
    g = torch._foreach_mul([grads[n] for n in names], scale)
    mu = [state.mu[n] for n in names]
    nu = [state.nu[n] for n in names]
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, g, alpha=1.0 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
    # direction = (mu / c1) / (sqrt(nu / c2) + eps) + weight_decay * p
    denom = torch._foreach_div(nu, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    direction = torch._foreach_div(mu, c1)
    torch._foreach_div_(direction, denom)
    decayed = [i for i, n in enumerate(names) if n not in o.no_decay]
    torch._foreach_add_([direction[i] for i in decayed],
                        [params[i] for i in decayed], alpha=o.weight_decay)
    torch._foreach_add_(params, direction, alpha=-lr)


def make_train_step(process_batch: Callable, optimizer: AdamW) -> Callable:
    """Returns fn(state, batch, generator, weights, curriculum, draws=None)
    -> (state, metrics); ``state`` is updated in place and returned.
    ``metrics`` gains ``grad_norm`` and ``skipped``."""
    def train_step(state: FRLTrainState, batch, generator, weights,
                   curriculum, draws=None):
        names, params = zip(*state.model.named_parameters())
        loss, metrics = process_batch(batch, generator, weights, curriculum,
                                      True, draws)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        grads = dict(zip(names, grads))
        gnorm = global_norm(grads.values())
        finite = bool(torch.isfinite(loss.detach()) & torch.isfinite(gnorm))
        if finite:
            apply_update(state, optimizer, grads, gnorm)
        state.step += 1
        metrics["grad_norm"] = gnorm
        metrics["skipped"] = torch.as_tensor(int(not finite),
                                             device=gnorm.device)
        return state, metrics

    return train_step
