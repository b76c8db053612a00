"""VQ-VAE train / eval step.

Port of ``forest_tpu/training/vqvae_step.py``: total loss = lambda_cont *
NaN-safe MSE(cont) + lambda_cat * sum over heads of weighted CE (ignore
-100) + lambda_canopy * NaN-safe MSE(canopy) + lambda_vq(step) * vq_loss;
AdamW with weight decay 0 on the codebook; gradient clipping by the global
norm; in "ema" mode the codebook is then overwritten with the EMA update
(and dead codes optionally reseeded), in "st" mode only the cumulative code
usage is counted.

The optimizer is optax's arithmetic as
``training.representation.train_step.apply_update`` writes it. Loss weights
arrive as plain numbers, one dict per step, from the annealer. Not here: the
cross-replica ``axis_name`` reductions (the multi-GPU slice adds them), the
compact-wire batch decoding and the K-steps-per-dispatch scan.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from forest_tpu_torch.losses.categorical import (IGNORE_INDEX,
                                                 categorical_loss)
from forest_tpu_torch.losses.reconstruction import reconstruction_loss
from forest_tpu_torch.models.vqvae import VQVAE, VQVAEOutput
from forest_tpu_torch.ops import vq as vq_ops
from forest_tpu_torch.training.representation.train_step import (
    AdamW, LearningRate, apply_update, global_norm)
from forest_tpu_torch.utils import flax_bridge


def make_optimizer(learning_rate: LearningRate, weight_decay: float = 1e-4,
                   grad_clip: float = 1.0) -> AdamW:
    """Clipped AdamW with the codebook excluded from weight decay."""
    return AdamW(learning_rate, weight_decay, grad_clip,
                 no_decay=("codebook",))


@dataclass
class VQVAETrainState:
    """The model (its parameters are the trained state), AdamW's moments by
    parameter name and its update count, the EMA codebook state and the
    number of steps taken. :meth:`state_dict` / :meth:`load_state_dict`
    speak the JAX package's checkpoint layout (``params``, ``opt_state``,
    ``vq_stats``, ``step``)."""
    model: VQVAE
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)
    count: int = 0
    vq_stats: Optional[vq_ops.VQStats] = None
    step: int = 0
    scheduled: bool = True      # the learning rate is a schedule

    @property
    def params(self) -> Dict[str, Any]:
        """The parameters as a flax-layout tree of numpy arrays."""
        return flax_bridge.params_to_flax(dict(self.model.named_parameters()))

    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": self.params,
            "opt_state": flax_bridge.opt_state_to_flax(
                self.mu, self.nu, self.count, self.scheduled, masked=True),
            "vq_stats": flax_bridge.vq_stats_to_flax(self.vq_stats),
            "step": np.asarray(self.step, np.int32),
        }

    def load_state_dict(self, tree: Dict[str, Any]) -> "VQVAETrainState":
        """Restore in place from a tree of :meth:`state_dict`'s layout, as
        either package wrote it; tensors keep their device."""
        dev = next(self.model.parameters()).device
        self.model.load_state_dict(
            flax_bridge.params_from_flax(tree["params"]), strict=True)
        mu, nu, count = flax_bridge.opt_state_from_flax(
            tree["opt_state"])
        if set(mu) != set(self.mu):
            raise ValueError("optimizer state does not match the model: "
                             f"{sorted(set(mu) ^ set(self.mu))}")
        self.mu = {n: v.to(dev) for n, v in mu.items()}
        self.nu = {n: v.to(dev) for n, v in nu.items()}
        self.count = count
        self.vq_stats = vq_ops.VQStats(*(
            v.to(dev) for v in flax_bridge.vq_stats_from_flax(
                tree["vq_stats"])))
        self.step = int(np.asarray(tree["step"]))
        return self


def init_train_state(model: VQVAE, optimizer: AdamW) -> VQVAETrainState:
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return VQVAETrainState(
        model, zeros, {n: torch.zeros_like(p) for n, p in zeros.items()},
        # codebook-seeded EMA state: unassigned codes keep their initial
        # vectors instead of collapsing to zero on the first update
        vq_stats=vq_ops.VQStats.init(model.codebook_size, model.emb_dim,
                                     codebook=model.codebook),
        scheduled=callable(optimizer.learning_rate))


def vqvae_loss(out: VQVAEOutput, batch: Dict[str, Any],
               class_weights: Dict[str, torch.Tensor],
               loss_weights: Dict[str, float]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-batch loss. ``loss_weights`` keys: cont, cat, canopy, vq."""
    cont_l = reconstruction_loss(out.cont_pred, batch["cont"],
                                 batch.get("cont_nan_mask"), kind="l2")
    cat_l = torch.zeros((), dtype=torch.float32, device=cont_l.device)
    cat_metrics = {}
    for name in sorted(out.cat_logits):
        # weight_sum: zero-weight MISS / UNK targets neither count nor dilute
        l = categorical_loss(out.cat_logits[name], batch["cat_target"][name],
                             class_weights.get(name),
                             ignore_index=IGNORE_INDEX,
                             normalization="weight_sum")
        cat_metrics[f"cat/{name}"] = l
        cat_l = cat_l + l
    canopy_l = reconstruction_loss(out.canopy_pred, batch["canopy"],
                                   kind="l2")
    total = (loss_weights["cont"] * cont_l
             + loss_weights["cat"] * cat_l
             + loss_weights["canopy"] * canopy_l
             + loss_weights["vq"] * out.vq_loss)
    metrics = {"loss/total": total, "loss/cont": cont_l, "loss/cat": cat_l,
               "loss/canopy": canopy_l, "loss/vq": out.vq_loss,
               "perplexity": out.perplexity, **cat_metrics}
    return total, metrics


def make_train_step(model: VQVAE, optimizer: AdamW,
                    class_weights: Optional[Dict[str, torch.Tensor]] = None,
                    reseed_dead: bool = False,
                    reseed_threshold: float = 1e-3) -> Callable:
    """Returns ``train_step(state, batch, loss_weights, generator=None,
    pick=None) -> (state, metrics)``; ``state`` is updated in place and
    returned. ``generator`` (or the raw draw ``pick`` [K]) is used only by
    the dead-code reseed."""
    cw = class_weights or {}

    def train_step(state: VQVAETrainState, batch: Dict[str, Any],
                   loss_weights: Dict[str, float],
                   generator: Optional[torch.Generator] = None,
                   pick: Optional[torch.Tensor] = None):
        names, params = zip(*model.named_parameters())
        out = model(batch)
        total, metrics = vqvae_loss(out, batch, cw, loss_weights)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g)
                 for n, p, g in zip(names, params, grads)}
        gnorm = global_norm(grads.values())
        apply_update(state, optimizer, grads, gnorm)

        with torch.no_grad():
            if model.quantizer == "ema":
                vq_stats, new_cb = vq_ops.ema_codebook_update(
                    state.vq_stats, model.codebook, out.counts, out.sums,
                    decay=model.ema_decay, eps=model.ema_eps)
                if reseed_dead:
                    new_cb, vq_stats = vq_ops.reseed_dead_codes(
                        new_cb, vq_stats, out.z_e, pick=pick,
                        generator=generator, threshold=reseed_threshold)
                model.codebook.copy_(new_cb)
                state.vq_stats = vq_stats
            else:
                state.vq_stats = state.vq_stats._replace(
                    code_usage=state.vq_stats.code_usage + out.counts)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return state, metrics

    return train_step


def make_eval_step(model: VQVAE,
                   class_weights: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Callable:
    """Returns ``eval_step(batch, loss_weights) -> metrics`` on the model's
    current parameters."""
    cw = class_weights or {}

    def eval_step(batch, loss_weights):
        with torch.no_grad():
            _, metrics = vqvae_loss(model(batch), batch, cw, loss_weights)
        return metrics

    return eval_step


__all__ = ["VQVAETrainState", "make_optimizer", "init_train_state",
           "vqvae_loss", "make_train_step", "make_eval_step"]
