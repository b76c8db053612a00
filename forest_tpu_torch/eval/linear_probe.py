"""Closed-form streaming ridge probes and the SGD variant on frozen encoders.

Port of ``forest_tpu/eval/linear_probe.py``:

- :class:`StreamingRidge` accumulates X^T X and X^T Y of ridge regression
  with a bias column over valid rows, never holding the design matrix;
- :func:`fit_linear_probe`: stream the train split through the frozen
  encoder, solve the ridge in closed form, report per-metric R^2 and MSE on
  train and val;
- :func:`fit_phase_linear_probe`: the probe input is ``[z_type, z_phase,
  z_type (x) z_phase]`` at strided anchor pixels against a temporal target;
- :func:`train_linear_probe`: the SGD variant, AdamW in optax's arithmetic
  (``training.representation.train_step.apply_update``).

The sums live on the device of the rows, in float64; only ``solve`` takes
them to the host.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from forest_tpu_torch.eval.frozen import batch_to_device
from forest_tpu_torch.losses.phase_neighborhood import full_float32
from forest_tpu_torch.training.representation.train_step import (
    AdamW, apply_update, init_train_state)


class StreamingRidge:
    """Sufficient statistics of ridge regression with a bias column.

    By default each block's Gram is a float32 product on the rows' device
    (full float32: no TF32 on a card), added into float64 sums, as the JAX
    package takes it. ``f64_blocks=True`` takes the block's product in
    float64 (the reference's ``Xaug.astype(np.float64)`` before ``Xaug.T @
    Xaug``, fit_phase_linear_probe.py:668-675), on the device as well.
    Invalid rows are zeroed, which leaves every sum as it would be without
    them."""

    def __init__(self, in_dim: int, out_dim: int, f64_blocks: bool = False):
        self.dims = (in_dim + 1, out_dim)          # bias column
        self.f64_blocks = f64_blocks
        self._xtx = self._xty = self._n = None

    def update(self, x, y, valid=None) -> None:
        """x [N, D]; y [N, K]; valid [N] (default: rows finite in x and y).
        Tensors stay on their device; numpy arrays are taken to the CPU."""
        x, y = torch.as_tensor(x), torch.as_tensor(y, device=x.device)
        x, y = (x.double(), y.double()) if self.f64_blocks else \
            (x.float(), y.float())
        if valid is None:
            valid = torch.isfinite(y).all(1) & torch.isfinite(x).all(1)
        v = torch.as_tensor(valid, device=x.device).bool()[:, None]
        xb = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        xb = torch.where(v, xb, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
        y = torch.where(v, y, torch.zeros((), dtype=y.dtype,
                                          device=y.device))
        if self._xtx is None:
            d, k = self.dims
            f64 = dict(dtype=torch.float64, device=x.device)
            self._xtx = torch.zeros((d, d), **f64)
            self._xty = torch.zeros((d, k), **f64)
            self._n = torch.zeros((), **f64)
        with full_float32():
            self._xtx += (xb.T @ xb).double()
            self._xty += (xb.T @ y.to(xb.dtype)).double()
        self._n += v.sum()

    @property
    def xtx(self) -> np.ndarray:
        return (np.zeros((self.dims[0],) * 2) if self._xtx is None
                else self._xtx.cpu().numpy())

    @property
    def xty(self) -> np.ndarray:
        return (np.zeros(self.dims) if self._xty is None
                else self._xty.cpu().numpy())

    @property
    def n(self) -> int:
        return 0 if self._n is None else int(self._n.item())

    def solve(self, lam: float = 1e-3) -> np.ndarray:
        """-> W [D+1, K], the bias in the last row (not penalised)."""
        d = self.dims[0]
        reg = lam * np.eye(d)
        reg[-1, -1] = 0.0
        return np.linalg.solve(self.xtx + reg, self.xty)


def predict(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    return x @ w[:-1] + w[-1]


def masked_r2(pred: np.ndarray, y: np.ndarray,
              valid: np.ndarray) -> np.ndarray:
    """Per-column R^2 over valid rows."""
    out = np.zeros(y.shape[1])
    for k in range(y.shape[1]):
        v = valid & np.isfinite(y[:, k]) & np.isfinite(pred[:, k])
        if v.sum() < 2:
            out[k] = np.nan
            continue
        yy, pp = y[v, k], pred[v, k]
        ss_res = np.sum((yy - pp) ** 2)
        ss_tot = np.sum((yy - yy.mean()) ** 2)
        out[k] = 1.0 - ss_res / max(ss_tot, 1e-12)
    return out


def _load_batches(dataset, batch_size: int, max_batches: Optional[int],
                  device):
    """Consecutive batches of ``dataset`` as group tensors on ``device``."""
    n = len(dataset)
    for count, i in enumerate(range(0, n, batch_size)):
        if max_batches and count >= max_batches:
            break
        idx = list(range(i, min(i + batch_size, n)))
        yield batch_to_device(dataset.load_batch(idx), device)


def _iter_embeddings(encode_fn: Callable, dataset, fb, target_feature: str,
                     max_batches: Optional[int], batch_size: int, device):
    """Yield (z [N, D], targets [N, K], valid [N]) tensors per batch."""
    for batch in _load_batches(dataset, batch_size, max_batches, device):
        z = encode_fn(batch)                               # [B, H, W, D]
        with torch.inference_mode():
            y, ym = fb.build_feature(target_feature, batch)
        yield (z.reshape(-1, z.shape[-1]), y.reshape(-1, y.shape[-1]),
               ym.all(-1).reshape(-1))


def _host(*tensors):
    return [t.float().cpu().numpy() if t.is_floating_point()
            else t.cpu().numpy() for t in tensors]


def fit_linear_probe(encode_fn: Callable, fb, ds_train, ds_val,
                     target_feature: str, ridge_lambda: float = 1e-3,
                     max_batches_train: Optional[int] = None,
                     max_batches_eval: Optional[int] = None,
                     batch_size: int = 4, device="cuda"
                     ) -> Dict[str, np.ndarray]:
    """Closed-form probe on ``encode_fn(batch) -> [B, H, W, D]`` (frozen).
    Returns the weights and per-metric train / val R^2 and MSE, in the
    target feature's channel order."""
    ridge = None
    for z, y, v in _iter_embeddings(encode_fn, ds_train, fb, target_feature,
                                    max_batches_train, batch_size, device):
        if ridge is None:
            ridge = StreamingRidge(z.shape[1], y.shape[1])
        ridge.update(z, y, v)
    if ridge is None:
        raise ValueError("train dataset yielded no patches -- check the "
                         "split / split_block_size geometry")
    w = ridge.solve(ridge_lambda)

    out = {"weights": w, "n_train_pixels": ridge.n}
    for name, ds in (("train", ds_train), ("val", ds_val)):
        zs, ys, vs = zip(*(_host(*b) for b in _iter_embeddings(
            encode_fn, ds, fb, target_feature, max_batches_eval, batch_size,
            device)))
        z, y, v = np.concatenate(zs), np.concatenate(ys), np.concatenate(vs)
        pred = predict(w, z)
        out[f"r2_{name}"] = masked_r2(pred, y, v)
        err = np.where(v[:, None], (pred - y) ** 2, 0.0)
        out[f"mse_{name}"] = err.sum(0) / np.maximum(v.sum(), 1)
    return out


def phase_probe_inputs(z_type: torch.Tensor,
                       z_phase: torch.Tensor) -> torch.Tensor:
    """[N, zt], [N, zp] -> [N, zt + zp + zt*zp]: [z_type, z_phase,
    z_type (x) z_phase]."""
    outer = (z_type[:, :, None] * z_phase[:, None, :]).reshape(
        z_type.shape[0], -1)
    return torch.cat([z_type, z_phase, outer], dim=1)


def strided_coords(h: int, w: int, stride: int, halo: int = 0,
                   device=None) -> torch.Tensor:
    """(row, col) [A, 2] of a strided grid inside a ``halo`` border."""
    rr, cc = torch.meshgrid(torch.arange(halo, h - halo, stride,
                                         device=device),
                            torch.arange(halo, w - halo, stride,
                                         device=device), indexing="ij")
    return torch.stack([rr.reshape(-1), cc.reshape(-1)], 1)


def fit_phase_linear_probe(encode_type_fn: Callable,
                           encode_phase_fn: Callable, fb, ds_train, ds_val,
                           target_feature: str, anchor_stride: int = 4,
                           ridge_lambda: float = 1e-3,
                           max_batches: Optional[int] = None,
                           batch_size: int = 2, device="cuda"
                           ) -> Dict[str, np.ndarray]:
    """Probe [z_type, z_phase, outer] at strided anchor pixels against a
    temporal target feature. ``encode_phase_fn(batch, coords)`` -> (z_phase
    [B, A, T, zp], target, target mask)."""

    def batches(ds):
        for batch in _load_batches(ds, batch_size, max_batches, device):
            zt = encode_type_fn(batch)                     # [B, H, W, zt]
            coords = strided_coords(zt.shape[1], zt.shape[2], anchor_stride,
                                    device=zt.device)
            zp, ta, tm = encode_phase_fn(batch, coords)    # [B, A, T, zp]
            t = zp.shape[2]
            zt_a = zt[:, coords[:, 0], coords[:, 1]]       # [B, A, zt]
            zt_rep = zt_a[:, :, None, :].expand(-1, -1, t, -1)
            x = phase_probe_inputs(zt_rep.reshape(-1, zt_a.shape[-1]),
                                   zp.reshape(-1, zp.shape[-1]))
            yield (x, ta.reshape(x.shape[0], -1),
                   tm.reshape(x.shape[0], -1).all(1))

    ridge = None
    for x, y, v in batches(ds_train):
        if ridge is None:
            ridge = StreamingRidge(x.shape[1], y.shape[1])
        ridge.update(x, y, v)
    w = ridge.solve(ridge_lambda)
    out = {"weights": w, "n_train_pixels": ridge.n}
    for name, ds in (("train", ds_train), ("val", ds_val)):
        xs, ys, vs = zip(*(_host(*b) for b in batches(ds)))
        out[f"r2_{name}"] = masked_r2(predict(w, np.concatenate(xs)),
                                      np.concatenate(ys), np.concatenate(vs))
    return out


def train_linear_probe(x: np.ndarray, y: np.ndarray, valid: np.ndarray,
                       lr: float = 1e-2, steps: int = 500,
                       weight_decay: float = 1e-4,
                       batch_size: int = 4096, seed: int = 0,
                       indices: Optional[np.ndarray] = None,
                       device="cuda") -> np.ndarray:
    """SGD probe: AdamW (optax's, no clipping) on the masked squared error,
    one minibatch of rows a step. Returns W [D+1, K], the bias last.

    The rows of step i are ``indices[i]`` when given ([steps, batch]), else
    drawn uniformly with replacement from a ``torch.Generator`` seeded with
    ``seed``."""
    n, d = x.shape
    k = y.shape[1]
    bs = min(batch_size, n)
    if indices is None:
        indices = torch.randint(0, n, (steps, bs),
                                generator=torch.Generator().manual_seed(seed))
    idx_all = torch.as_tensor(indices, device=device).long()
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    vt = torch.as_tensor(valid, device=device).bool()
    yt = torch.where(vt[:, None],
                     torch.as_tensor(y, dtype=torch.float32, device=device),
                     torch.zeros((), device=device))
    vf = vt.float()
    params = nn.ParameterDict({
        "w": nn.Parameter(torch.zeros(d, k, device=device)),
        "b": nn.Parameter(torch.zeros(k, device=device))})
    opt = AdamW(lr, weight_decay, grad_clip=float("inf"))
    state = init_train_state(params, opt)
    no_clip = torch.zeros((), device=device)
    with torch.no_grad():
        for i in range(steps):
            idx = idx_all[i]
            grads = squared_error_grads(params, xt[idx], yt[idx], vf[idx])
            apply_update(state, opt, grads, no_clip)
    return np.concatenate([params["w"].detach().cpu().numpy(),
                           params["b"].detach().cpu().numpy()[None, :]], 0)


def squared_error_grads(params, x: torch.Tensor, y: torch.Tensor,
                         vf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gradients of sum_rows(vf * |x w + b - y|^2) / max(sum vf, 1) by w
    and b, in closed form."""
    pred = x @ params["w"] + params["b"]
    dpred = 2.0 * (pred - y) * (vf / torch.clamp(vf.sum(), min=1.0))[:, None]
    return {"w": x.T @ dpred, "b": dpred.sum(0)}


__all__ = ["StreamingRidge", "fit_linear_probe", "fit_phase_linear_probe",
           "train_linear_probe", "masked_r2", "predict",
           "phase_probe_inputs", "strided_coords", "squared_error_grads"]
