"""Mini-batch SGD linear probe trained on a frozen encoder.

Port of ``forest_tpu/eval/train_probe.py``: a linear head on frozen pixel
embeddings predicts target metrics; per epoch a train pass (batch SGD,
masked squared error summed over metrics), then a validation pass with
POOLED per-metric MSE / R^2 and Spearman rho^2 over the split, a
per-metric table, the best parameters by val R^2, optional early stopping
and the final artifacts (``probe_best.npz``, ``probe_final.npz``,
``probe_history.json``, the JAX package's layouts).

A train step is one function on the device: the frozen encode and the
target build under ``torch.inference_mode()``, the probe's forward, its
gradient in closed form, AdamW in optax's arithmetic
(``train_step.apply_update``, no clipping, as ``optax.adamw``) on optax's
``warmup_cosine_decay_schedule``. Its metric sums come to the host in one
copy per batch.

Run: python -m forest_tpu_torch.eval.train_probe --checkpoint CKPT \
        --bindings B.yaml [--target-feature F] [--epochs 20] [--lr 0.05] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from forest_tpu_torch.eval.frozen import batch_to_device
from forest_tpu_torch.eval.linear_probe import squared_error_grads
from forest_tpu_torch.training.representation.train_step import (
    AdamW, FRLTrainState, apply_update, init_train_state)
from forest_tpu_torch.training.scheduler import warmup_cosine_decay_schedule

SPEARMAN_CAP = 200_000  # max pooled rows per metric for rank correlation


@dataclass
class ProbeMetrics:
    """Per-epoch probe evaluation."""
    mse_per_metric: Dict[str, float] = field(default_factory=dict)
    r2_per_metric: Dict[str, float] = field(default_factory=dict)
    spearman_rho2_per_metric: Dict[str, float] = field(default_factory=dict)
    mse_total: float = 0.0
    r2_total: float = 0.0
    spearman_rho2_total: float = 0.0
    n_samples: int = 0


def spearman_rho2(pred: np.ndarray, target: np.ndarray) -> float:
    """Rank correlation squared of two 1-D arrays."""
    n = len(pred)
    if n < 2:
        return 0.0
    pr = np.argsort(np.argsort(pred)).astype(np.float64)
    tr = np.argsort(np.argsort(target)).astype(np.float64)
    p = pr - pr.mean()
    t = tr - tr.mean()
    den = np.sqrt((p * p).sum() * (t * t).sum())
    if den < 1e-12:
        return 0.0
    return float(((p * t).sum() / den) ** 2)


def make_probe_fns(encode_fn: Callable, fb, target_feature: str,
                   lr: float, weight_decay: float = 0.0,
                   schedule: str = "cosine", total_steps: int = 1000,
                   warmup_steps: int = 0,
                   mask_channels: Tuple[str, ...] = (), device="cuda"):
    """-> (init, train_step, eval_step):

    ``init(d, k)`` -> the probe's state (zero weights, AdamW moments);
    ``train_step(state, batch)`` -> (state, {sse, sum_y, sum_y2 [K], n,
    loss} on the host), the state updated in place;
    ``eval_step(params, batch)`` -> (the same sums on the device, pred,
    target, valid).
    """
    if schedule == "cosine":
        sched = warmup_cosine_decay_schedule(
            0.0, lr, max(warmup_steps, 1), max(total_steps, 2))
    elif schedule == "constant":
        sched = lr
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    opt = AdamW(sched, weight_decay, grad_clip=float("inf"))
    masks = []
    for ref in mask_channels:
        g, c = ref.split(".")
        masks.append((g, fb.bindings.dataset[g].channel_index(c)))

    @torch.inference_mode()
    def build(batch):
        z = encode_fn(batch)                             # [B, H, W, D]
        y, ym = fb.build_feature(target_feature, batch)  # [B, H, W, K]
        if y.dim() == z.dim() + 1:
            # Temporal target [B, T, H, W, K]: the probe is static (one row
            # per pixel on z_type), so it predicts the masked mean over the
            # valid timesteps.
            cnt = ym.sum(1)
            y = torch.where(cnt > 0,
                            torch.where(ym, y, 0.0).sum(1)
                            / torch.clamp(cnt, min=1), 0.0)
            ym = cnt > 0
        valid = ym.all(-1)
        for g, ci in masks:
            valid = valid & (batch[g][..., ci].float() > 0)
        valid = valid & torch.isfinite(z).all(-1) & torch.isfinite(y).all(-1)
        return (z.reshape(-1, z.shape[-1]),
                torch.where(valid[..., None], y, 0.0).reshape(
                    -1, y.shape[-1]),
                valid.reshape(-1))

    def metrics_acc(pred, y, v):
        """Per-metric SSE and target sums for pooled R^2."""
        vf = v.float()[:, None]
        return {"sse": (((pred - y) ** 2) * vf).sum(0),
                "sum_y": (y * vf).sum(0), "sum_y2": (y * y * vf).sum(0),
                "n": v.sum()}

    def train_step(state: FRLTrainState, batch):
        z, y, v = build(batch)
        with torch.no_grad():
            params = state.model
            pred = z @ params["w"] + params["b"]
            vf = v.float()
            loss = (((pred - y) ** 2).sum(-1) * vf).sum() \
                / torch.clamp(vf.sum(), min=1.0)
            acc = metrics_acc(pred, y, v)
            apply_update(state, opt, squared_error_grads(params, z, y, vf),
                         torch.zeros((), device=pred.device))
            k = y.shape[-1]
            flat = torch.cat([acc["sse"], acc["sum_y"], acc["sum_y2"],
                              acc["n"].float()[None], loss[None]]).double()
        host = flat.cpu().numpy()                        # the batch's fetch
        return state, {"sse": host[:k], "sum_y": host[k:2 * k],
                       "sum_y2": host[2 * k:3 * k], "n": int(host[3 * k]),
                       "loss": host[3 * k + 1]}

    @torch.no_grad()
    def eval_step(params, batch):
        z, y, v = build(batch)
        pred = z @ params["w"] + params["b"]
        return metrics_acc(pred, y, v), pred, y, v

    def init(d: int, k: int) -> FRLTrainState:
        probe = nn.ParameterDict({
            "w": nn.Parameter(torch.zeros(d, k, device=device)),
            "b": nn.Parameter(torch.zeros(k, device=device))})
        return init_train_state(probe, opt)

    return init, train_step, eval_step


def _iter_batches(dataset, batch_size: int, max_batches: Optional[int],
                  shuffle: bool = False, seed: int = 0, device="cuda"):
    """Batches of group tensors on ``device``, in an order shuffled by
    ``np.random.default_rng(seed)`` when asked (the JAX package's order)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for count, i in enumerate(range(0, n, batch_size)):
        if max_batches and count >= max_batches:
            break
        idx = [int(j) for j in order[i:i + batch_size]]
        yield batch_to_device(dataset.load_batch(idx), device)


def _finalize(acc: Dict[str, np.ndarray], names: List[str],
              pooled: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]]
              ) -> ProbeMetrics:
    """Pooled per-metric MSE / R^2 (+ Spearman when pooled rows given)."""
    n = int(acc["n"])
    m = ProbeMetrics(n_samples=n)
    for j, name in enumerate(names):
        sse = float(acc["sse"][j])
        mean = float(acc["sum_y"][j]) / max(n, 1)
        sst = float(acc["sum_y2"][j]) - n * mean * mean
        m.mse_per_metric[name] = sse / max(n, 1)
        m.r2_per_metric[name] = (1.0 - sse / sst) if sst > 1e-8 else 0.0
        if pooled is not None and name in pooled:
            m.spearman_rho2_per_metric[name] = spearman_rho2(*pooled[name])
        else:
            m.spearman_rho2_per_metric[name] = 0.0
    k = max(len(names), 1)
    m.mse_total = sum(m.mse_per_metric.values()) / k
    m.r2_total = sum(m.r2_per_metric.values()) / k
    m.spearman_rho2_total = sum(m.spearman_rho2_per_metric.values()) / k
    return m


def validate_probe(params, eval_step, dataset, names: List[str],
                   batch_size: int = 4, max_batches: Optional[int] = None,
                   device="cuda") -> ProbeMetrics:
    """Pooled validation over the whole split: exact pooled MSE / R^2 from
    the device's sums; Spearman over up to SPEARMAN_CAP pooled rows per
    metric."""
    total: Optional[Dict[str, np.ndarray]] = None
    preds: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    kept = 0
    for batch in _iter_batches(dataset, batch_size, max_batches,
                               device=device):
        acc, pred, y, v = eval_step(params, batch)
        acc = {k: a.double().cpu().numpy() for k, a in acc.items()}
        total = acc if total is None else \
            {k: total[k] + acc[k] for k in total}
        if kept < SPEARMAN_CAP:
            preds.append(pred[v].cpu().numpy())
            ys.append(y[v].cpu().numpy())
            kept += len(preds[-1])
    if total is None:
        return ProbeMetrics()
    pooled = None
    if preds:
        p = np.concatenate(preds)[:SPEARMAN_CAP]
        t = np.concatenate(ys)[:SPEARMAN_CAP]
        pooled = {name: (p[:, j], t[:, j]) for j, name in enumerate(names)}
    return _finalize(total, names, pooled)


def log_metrics(m: ProbeMetrics, prefix: str = "", echo=print) -> None:
    """Per-metric table."""
    echo(f"{prefix} per-metric results ({m.n_samples} px):")
    echo(f"{'metric':<30} {'MSE':>10} {'R2':>10} {'rho2':>10}")
    for name in m.mse_per_metric:
        echo(f"{name:<30} {m.mse_per_metric[name]:>10.4f} "
             f"{m.r2_per_metric[name]:>10.4f} "
             f"{m.spearman_rho2_per_metric[name]:>10.4f}")
    echo(f"{'average':<30} {m.mse_total:>10.4f} {m.r2_total:>10.4f} "
         f"{m.spearman_rho2_total:>10.4f}")


def _params_np(state: FRLTrainState) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state.model.items()}


def train_probe_pipeline(encode_fn: Callable, fb, ds_train, ds_val,
                         target_feature: str, epochs: int = 20,
                         lr: float = 5e-2, weight_decay: float = 0.0,
                         schedule: str = "cosine", warmup_frac: float = 0.05,
                         batch_size: int = 4,
                         max_batches: Optional[int] = None,
                         patience: Optional[int] = None,
                         mask_channels: Tuple[str, ...] = (),
                         out_dir: Optional[Path] = None,
                         seed: int = 0, echo=print, device="cuda") -> Dict:
    """Epochs of batch SGD and pooled validation, best-by-val-R^2
    tracking, optional early stopping, the artifacts in ``out_dir``.

    Returns {params, best_params, best_val_r2, best_epoch, history,
    final_val (ProbeMetrics), names}; parameters as numpy arrays.
    """
    names = list(fb.bindings.get_feature(target_feature).channels.keys())
    n_train_batches = max_batches or -(-len(ds_train) // batch_size)
    total_steps = max(epochs * n_train_batches, 2)
    init, train_step, eval_step = make_probe_fns(
        encode_fn, fb, target_feature, lr, weight_decay, schedule,
        total_steps, int(warmup_frac * total_steps), mask_channels, device)

    first = next(_iter_batches(ds_train, batch_size, 1, device=device))
    state = init(int(encode_fn(first).shape[-1]), len(names))

    best = {"r2": -np.inf, "epoch": -1, "params": None}
    history: List[Dict] = []
    bad_epochs = 0
    val_m = ProbeMetrics()
    for epoch in range(epochs):
        if hasattr(ds_train, "on_epoch_start"):
            ds_train.on_epoch_start()
        tr_total: Optional[Dict[str, np.ndarray]] = None
        for batch in _iter_batches(ds_train, batch_size, max_batches,
                                   shuffle=True, seed=seed + epoch,
                                   device=device):
            state, acc = train_step(state, batch)
            acc.pop("loss")
            tr_total = acc if tr_total is None else \
                {k: tr_total[k] + acc[k] for k in tr_total}
        tr_m = (_finalize(tr_total, names, None) if tr_total
                else ProbeMetrics())
        val_m = validate_probe(state.model, eval_step, ds_val, names,
                               batch_size, max_batches, device)
        echo(f"probe epoch {epoch + 1}/{epochs} | train MSE "
             f"{tr_m.mse_total:.4f} | val MSE {val_m.mse_total:.4f} | "
             f"val R2 {val_m.r2_total:.4f}")
        history.append({"epoch": epoch + 1,
                        "train_mse": tr_m.mse_total,
                        "val_mse": val_m.mse_total,
                        "val_r2": val_m.r2_total,
                        "val_spearman_rho2": val_m.spearman_rho2_total})
        if val_m.r2_total > best["r2"]:
            best = {"r2": val_m.r2_total, "epoch": epoch + 1,
                    "params": _params_np(state), "metrics": val_m}
            bad_epochs = 0
            if out_dir is not None:
                _save_probe(out_dir / "probe_best.npz", best["params"],
                            val_m, names, epoch + 1)
        else:
            bad_epochs += 1
            if patience is not None and bad_epochs >= patience:
                echo(f"early stop at epoch {epoch + 1} "
                     f"(no val R2 gain for {patience} epochs)")
                break

    log_metrics(val_m, prefix="final", echo=echo)
    params = _params_np(state)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        _save_probe(out_dir / "probe_final.npz", params, val_m, names,
                    len(history))
        (out_dir / "probe_history.json").write_text(json.dumps({
            "history": history, "best_epoch": best["epoch"],
            "best_val_r2": float(best["r2"]),
            "target_metrics": names,
            "final": asdict(val_m)}, indent=2))
    return {"params": params, "best_params": best["params"],
            "best_val_r2": float(best["r2"]),
            "best_epoch": best["epoch"], "history": history,
            "final_val": val_m, "names": names}


def _save_probe(path: Path, params: Dict[str, np.ndarray], m: ProbeMetrics,
                names: List[str], epoch: int) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, w=params["w"], b=params["b"], epoch=epoch,
             target_metrics=np.asarray(names),
             val_mse=m.mse_total, val_r2=m.r2_total,
             val_spearman_rho2=m.spearman_rho2_total,
             val_mse_per_metric=np.asarray(
                 [m.mse_per_metric[n] for n in names]),
             val_r2_per_metric=np.asarray(
                 [m.r2_per_metric[n] for n in names]))


def main(argv=None):
    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--bindings", required=True)
    ap.add_argument("--target-feature", default="target_metrics")
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--patch-size", type=int, default=128)
    ap.add_argument("--split-block-size", type=int, nargs=2, default=(4, 4))
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "constant"])
    ap.add_argument("--patience", type=int, default=None)
    ap.add_argument("--mask-channels", nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the encoder and the probe run "
                         "(default: cuda)")
    a = ap.parse_args(argv)

    device = frozen.resolve_device(a.device)
    bindings = parse_bindings(a.bindings)
    fb = FeatureBuilder(bindings)
    mk = dict(patch_size=a.patch_size,
              split_block_size=tuple(a.split_block_size), min_aoi=0.3)
    ds_train = ForestDatasetV2(bindings, split="train", **mk)
    ds_val = ForestDatasetV2(bindings, split="val", **mk)
    frozen.require_patches(ds_train, "train", a.patch_size, a.split_block_size)
    frozen.require_patches(ds_val, "val", a.patch_size, a.split_block_size)
    model = frozen.load_frozen_model(a.checkpoint, device)
    enc_t, _, _ = frozen.make_encode_fns(model, fb)

    out_dir = Path(a.output_dir) if a.output_dir else \
        Path(a.checkpoint).parent / "linear_probe"
    res = train_probe_pipeline(
        enc_t, fb, ds_train, ds_val, a.target_feature, a.epochs, a.lr,
        a.weight_decay, a.schedule, batch_size=a.batch_size,
        max_batches=a.max_batches, patience=a.patience,
        mask_channels=tuple(a.mask_channels), out_dir=out_dir,
        seed=a.seed, device=device)
    print(f"best val R2 {res['best_val_r2']:.4f} "
          f"(epoch {res['best_epoch']}); wrote {out_dir}")
    return res


if __name__ == "__main__":
    main()


__all__ = ["ProbeMetrics", "spearman_rho2", "make_probe_fns",
           "validate_probe", "train_probe_pipeline", "log_metrics",
           "main"]
