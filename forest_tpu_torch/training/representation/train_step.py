"""FRL train / eval step: gradients, non-finite containment, optimizer.

Port of ``forest_tpu/training/representation/train_step.py``. A step runs
``process_batch``, takes the gradients of the total loss, clips them by
their global norm and applies AdamW. A non-finite loss or gradient norm
skips the update: parameters and optimizer state stay as they were,
``skipped`` is 1 and ``step`` still advances.

The optimizer is written out here with optax's arithmetic, which is what the
JAX package trains with, and not ``torch.optim.AdamW`` /
``clip_grad_norm_``, which differ from it: optax adds ``weight_decay * p``
to the Adam direction and scales the sum by the learning rate, where
``torch.optim.AdamW`` shrinks the parameter by ``lr * weight_decay`` first;
optax clips by ``clip / max(norm, clip)``, ``clip_grad_norm_`` by
``clip / (norm + 1e-6)``. The state (``mu``, ``nu``, ``count``) is optax's,
so ``utils.flax_bridge`` carries it across.

With ``group`` (a ``torch.distributed`` process group, one rank per
replica; ``parallel.dp.make_dp_frl_step``), the JAX step's ``axis_name``
reductions are written out: the loss and the gradients are averaged across
the ranks in one all-reduce, the metrics synced (counts summed, the rest
averaged), and the non-finite test reads the averaged loss and gradient
norm, so every rank takes the same skip decision.

Both steps decode a compact-wire batch first (``data.wire.
decode_wire_batch``, the identity on a plain batch); a batch on another
device than the model's raises. Not here: the JAX package's microbatched
gradient accumulation (it exists for a TPU kernel's batch limit).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from forest_tpu_torch.data.wire import decode_wire_batch
from forest_tpu_torch.parallel import dp
from forest_tpu_torch.utils import flax_bridge

LearningRate = Union[float, Callable[[int], float]]

# Adam's decay rates and epsilon: optax.adamw's defaults, which the JAX
# package trains with
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamW:
    """Global-norm clipping followed by AdamW, in optax's formulation.
    Parameters named in ``no_decay`` get no weight decay (optax's mask)."""
    learning_rate: LearningRate
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    no_decay: Tuple[str, ...] = ()


def make_optimizer(learning_rate: LearningRate, weight_decay: float = 1e-4,
                   grad_clip: float = 1.0) -> AdamW:
    return AdamW(learning_rate, weight_decay, grad_clip)


@dataclass
class FRLTrainState:
    """The model (its parameters are the trained state), AdamW's first and
    second moments by parameter name, the number of updates applied
    (``count``; it also indexes the learning-rate schedule) and the number
    of steps taken (``step``; it also counts skipped ones).
    :meth:`state_dict` / :meth:`load_state_dict` speak the JAX package's
    checkpoint layout of its ``FRLTrainState`` (``params``, ``opt_state``,
    ``step``), so either package resumes the other's checkpoints."""
    model: nn.Module
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)
    count: int = 0
    step: int = 0
    scheduled: bool = True      # the learning rate is a schedule

    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": flax_bridge.params_to_flax(
                dict(self.model.named_parameters())),
            "opt_state": flax_bridge.opt_state_to_flax(
                self.mu, self.nu, self.count, self.scheduled),
            "step": np.asarray(self.step, np.int32),
        }

    def load_state_dict(self, tree: Dict[str, Any]) -> "FRLTrainState":
        """Restore in place from a tree of :meth:`state_dict`'s layout, as
        either package wrote it; tensors keep their device."""
        dev = next(self.model.parameters()).device
        params = flax_bridge.params_from_flax(tree["params"])
        mu, nu, count = flax_bridge.opt_state_from_flax(tree["opt_state"])
        if set(mu) != set(self.mu) or set(nu) != set(self.mu):
            raise ValueError("optimizer state does not match the model: "
                             f"{sorted(set(mu) ^ set(self.mu))}")
        self.model.load_state_dict(params, strict=True)
        self.mu = {n: v.to(dev) for n, v in mu.items()}
        self.nu = {n: v.to(dev) for n, v in nu.items()}
        self.count = count
        self.step = int(np.asarray(tree["step"]))
        return self


def init_train_state(model: nn.Module, optimizer: AdamW) -> FRLTrainState:
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return FRLTrainState(model, zeros,
                         {n: torch.zeros_like(p) for n, p in zeros.items()},
                         scheduled=callable(optimizer.learning_rate))


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


def make_train_step(process_batch: Callable, optimizer: AdamW,
                    group=None) -> Callable:
    """Returns fn(state, batch, generator, weights, curriculum, draws=None)
    -> (state, metrics); ``state`` is updated in place and returned.
    ``metrics`` gains ``grad_norm`` and ``skipped``. With ``group``, the
    reductions of the module docstring run across its ranks."""
    def train_step(state: FRLTrainState, batch, generator, weights,
                   curriculum, draws=None):
        names, params = zip(*state.model.named_parameters())
        batch = decode_wire_batch(batch, params[0].device)
        loss, metrics = process_batch(batch, generator, weights, curriculum,
                                      True, draws)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if group is not None:
            # the loss rides in the gradients' buffer: one all-reduce
            *grads, loss = dp.all_reduce_mean(grads + [loss.detach()], group)
            metrics = dp.sync_metrics(metrics, group)
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


def make_eval_step(process_batch: Callable, group=None) -> Callable:
    def eval_step(batch, generator, weights, curriculum,
                  draws: Optional[object] = None):
        batch = decode_wire_batch(batch, getattr(process_batch, "device",
                                                 None))
        with torch.no_grad():
            _, metrics = process_batch(batch, generator, weights,
                                       curriculum, False, draws)
        return dp.sync_metrics(metrics, group)

    return eval_step


__all__ = ["AdamW", "FRLTrainState", "make_optimizer", "init_train_state",
           "make_train_step", "make_eval_step", "apply_update",
           "global_norm"]
