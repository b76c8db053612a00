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
arrive as plain numbers, one dict per step, from the annealer.

With ``group`` (a ``torch.distributed`` process group, one rank per
replica; ``parallel.dp.make_dp_train_step``), every rank runs the step on
its own rows and the JAX step's ``axis_name`` reductions are written out:
gradients averaged before the update, the EMA counts and sums summed,
the reseed candidates gathered from every rank (the same ``pick`` or
generator seed on every rank), the cumulative code usage summed when the
quantiser is not EMA, every metric averaged.

Both steps decode a compact-wire batch first (``data.wire.
decode_wire_batch``, the identity on a plain batch); a batch on another
device than the model's raises. :func:`make_scan_train_step` runs a block
of K steps, stacked on a leading axis, as K sequential steps; the CLI
(``train_vqvae``) runs one step at a time whatever ``steps_per_dispatch``
says.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from forest_tpu_torch.data.wire import decode_wire_batch
from forest_tpu_torch.losses.categorical import (IGNORE_INDEX,
                                                 categorical_loss)
from forest_tpu_torch.losses.reconstruction import reconstruction_loss
from forest_tpu_torch.models.vqvae import VQVAE, VQVAEOutput
from forest_tpu_torch.ops import vq as vq_ops
from forest_tpu_torch.parallel import dp
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
                    reseed_threshold: float = 1e-3,
                    group=None) -> Callable:
    """Returns ``train_step(state, batch, loss_weights, generator=None,
    pick=None) -> (state, metrics)``; ``state`` is updated in place and
    returned. ``generator`` (or the raw draw ``pick`` [K]) is used only by
    the dead-code reseed. With ``group``, the step's reductions run across
    its ranks (module docstring); ``grad_norm`` is that of the averaged
    gradients."""
    cw = class_weights or {}

    def train_step(state: VQVAETrainState, batch: Dict[str, Any],
                   loss_weights: Dict[str, float],
                   generator: Optional[torch.Generator] = None,
                   pick: Optional[torch.Tensor] = None):
        names, params = zip(*model.named_parameters())
        batch = decode_wire_batch(batch, params[0].device)
        out = model(batch)
        total, metrics = vqvae_loss(out, batch, cw, loss_weights)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        grads = dict(zip(names, dp.all_reduce_mean(grads, group)))
        gnorm = global_norm(grads.values())
        apply_update(state, optimizer, grads, gnorm)

        with torch.no_grad():
            if model.quantizer == "ema":
                vq_stats, new_cb = vq_ops.ema_codebook_update(
                    state.vq_stats, model.codebook, out.counts, out.sums,
                    decay=model.ema_decay, eps=model.ema_eps, group=group)
                if reseed_dead:
                    new_cb, vq_stats = vq_ops.reseed_dead_codes(
                        new_cb, vq_stats,
                        dp.all_gather_rows(out.z_e, group), pick=pick,
                        generator=generator, threshold=reseed_threshold)
                model.codebook.copy_(new_cb)
                state.vq_stats = vq_stats
            else:
                counts, = dp.all_reduce_sum([out.counts], group)
                state.vq_stats = state.vq_stats._replace(
                    code_usage=state.vq_stats.code_usage + counts)
        state.step += 1
        metrics = dp.sync_metrics({k: v.detach() for k, v in metrics.items()},
                                  group)
        metrics["grad_norm"] = gnorm
        return state, metrics

    return train_step


def make_scan_train_step(train_step: Callable) -> Callable:
    """Wrap ``train_step(state, batch, loss_weights, generator=None,
    pick=None)`` into ``multi_step(state, stacked_batch, stacked_weights,
    draws=None) -> (state, metrics)``, which runs the K slices of a block
    (every leaf of ``stacked_batch`` has a leading K axis, as
    ``data.wire.stack_batches`` makes it) as K sequential ``train_step``
    calls. ``stacked_weights`` maps
    each loss weight to its K per-step values; the metrics come back with a
    leading K axis.

    The result is bit for bit that of the K separate calls on the same
    slices, weights and reseed draws. ``draws`` is one of: None (each step
    draws as ``train_step`` does without a generator); a
    ``torch.Generator``, which step k draws from after steps 0..k-1, so a
    block starting at global step g draws what the sequential loop with
    that generator draws at steps g..g+K-1; or the raw reseed draws
    ``pick`` [K, codebook_size], one row a step. This differs from the JAX
    package, whose block keys its reseed as ``split(key(g), K)`` where its
    plain loop uses ``key(g)``, ``key(g + 1)``, ...: only the dead-code
    reseed's draw depends on it."""
    def multi_step(state, stacked_batch: Dict[str, Any],
                   stacked_weights: Dict[str, Any], draws=None):
        leaves = [v for v in stacked_batch.values()
                  if not isinstance(v, dict)]
        k = leaves[0].shape[0]
        weights = {n: [float(x) for x in
                       (v.tolist() if isinstance(v, torch.Tensor) else v)]
                   for n, v in stacked_weights.items()}
        per_step = []
        for i in range(k):
            batch = {n: ({m: a[i] for m, a in v.items()}
                         if isinstance(v, dict) else v[i])
                     for n, v in stacked_batch.items()}
            w = {n: v[i] for n, v in weights.items()}
            if isinstance(draws, torch.Generator):
                state, m = train_step(state, batch, w, generator=draws)
            else:
                state, m = train_step(
                    state, batch, w,
                    pick=None if draws is None else draws[i])
            per_step.append(m)
        return state, {n: torch.stack([m[n] for m in per_step])
                       for n in per_step[0]}

    return multi_step


def make_eval_step(model: VQVAE,
                   class_weights: Optional[Dict[str, torch.Tensor]] = None,
                   group=None) -> Callable:
    """Returns ``eval_step(batch, loss_weights) -> metrics`` on the model's
    current parameters; with ``group``, each rank's metric means are
    averaged across its ranks."""
    cw = class_weights or {}

    def eval_step(batch, loss_weights):
        batch = decode_wire_batch(batch, model.codebook.device)
        with torch.no_grad():
            _, metrics = vqvae_loss(model(batch), batch, cw, loss_weights)
        return dp.sync_metrics(metrics, group)

    return eval_step


__all__ = ["VQVAETrainState", "make_optimizer", "init_train_state",
           "vqvae_loss", "make_train_step", "make_scan_train_step",
           "make_eval_step"]
