"""Phase linear probe: whitened targets, per-metric reports.

Port of ``forest_tpu/eval/phase_probe.py`` (the reference's
fit_phase_linear_probe.py):

- design matrices ``full`` ([z_type, z_phase, z_type (x) z_phase]),
  ``additive``, ``type-only``, ``phase-only``;
- :class:`PhaseProbePreprocessor`: per-column standardisation and top-k PCA
  of the interaction block, from streamed sums (pass 1);
- :func:`fit_phase_probe`: two-pass streaming ridge, normal equations in
  float64;
- :func:`inverse_normalization_fn`: un-whiten, undo the preset's affine,
  invert the channel's transform, back to the data's scale;
- :func:`evaluate_phase_probe`: per-channel and total MSE / R^2 /
  Spearman rho^2 in the normalised and the original scale, the temporal
  (within-pixel) R^2 and the share of target variance within pixels.

Where the JAX package builds the design matrix and its sums in numpy on the
host, the port keeps them on the model's device: both passes' sums, the
ridge's float64 Gram and the evaluation's accumulators are float64 tensors
there, and only the [D] and [D, D] sums (and Spearman's subsample) come to
the host. Rows are masked by zeroing, which adds exact zeros to every sum.
The interaction PCA's ``eigh`` runs on the host in numpy, as in JAX: the
sign of an eigenvector is arbitrary, so its components are comparable only
up to sign, while the predictions do not depend on it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from forest_tpu_torch.data.samplers import ReservoirSampler
from forest_tpu_torch.data.transforms import get_transform
from forest_tpu_torch.eval.frozen import batch_to_device
from forest_tpu_torch.eval.linear_probe import StreamingRidge, strided_coords

DESIGN_CHOICES = ("full", "additive", "type-only", "phase-only")

_SPEARMAN_CAP = 200_000  # rows kept per split for rho^2


def build_design_matrix(zt: torch.Tensor, zp: torch.Tensor,
                        design: str) -> torch.Tensor:
    """[N, dt], [N, dp] -> [N, D_raw] per the design choice."""
    if design == "type-only":
        return zt
    if design == "phase-only":
        return zp
    if design == "additive":
        return torch.cat([zt, zp], dim=1)
    if design == "full":
        inter = (zt[:, :, None] * zp[:, None, :]).reshape(zt.shape[0], -1)
        return torch.cat([zt, zp, inter], dim=1)
    raise ValueError(f"unknown design {design!r} (choices {DESIGN_CHOICES})")


def design_dim(design: str, d_type: int, d_phase: int) -> int:
    return {"type-only": d_type, "phase-only": d_phase,
            "additive": d_type + d_phase,
            "full": d_type + d_phase + d_type * d_phase}[design]


@dataclass
class PhaseProbePreprocessor:
    """Column standardisation + optional interaction-block PCA."""
    design: str
    d_type: int
    d_phase: int
    mean: np.ndarray                    # [D_raw]
    std: np.ndarray                     # [D_raw]
    pca_components: Optional[np.ndarray] = None   # [d_int, k]

    @property
    def output_dim(self) -> int:
        if self.design == "full" and self.pca_components is not None:
            return (self.d_type + self.d_phase
                    + self.pca_components.shape[1])
        return design_dim(self.design, self.d_type, self.d_phase)

    def transform(self, x_raw: torch.Tensor) -> torch.Tensor:
        """[N, D_raw] -> [N, output_dim] float64, on x_raw's device."""
        f64 = dict(dtype=torch.float64, device=x_raw.device)
        z = (x_raw.double() - torch.as_tensor(self.mean, **f64)) \
            / torch.as_tensor(self.std, **f64)
        if self.design == "full" and self.pca_components is not None:
            d_main = self.d_type + self.d_phase
            return torch.cat([z[:, :d_main], z[:, d_main:]
                              @ torch.as_tensor(self.pca_components, **f64)],
                             dim=1)
        return z

    def to_dict(self) -> dict:
        return {"design": self.design, "d_type": self.d_type,
                "d_phase": self.d_phase, "mean": self.mean.tolist(),
                "std": self.std.tolist(),
                "pca_components": (self.pca_components.tolist()
                                   if self.pca_components is not None
                                   else None)}

    @classmethod
    def from_dict(cls, d: dict) -> "PhaseProbePreprocessor":
        pca = d.get("pca_components")
        return cls(d["design"], d["d_type"], d["d_phase"],
                   np.asarray(d["mean"]), np.asarray(d["std"]),
                   np.asarray(pca) if pca is not None else None)


def make_probe_mask_fn(fb, type_feature: str = "type_encoder_input",
                       phase_feature: str = "phase_ccdc",
                       static_masks: Tuple[str, ...] = ("static_mask.aoi",
                                                        "static_mask.forest")
                       ) -> Callable:
    """mask(batch, coords [A, 2]) -> [B, A] bool: the anchor's encoder-input
    mask, its phase-input mask over all T and the aoi / forest masks, so the
    ridge never fits on out-of-AOI, non-forest or masked-input pixels (whose
    features are zero-filled). Missing mask channels are skipped."""
    refs = []
    for ref in static_masks:
        g, c = ref.split(".")
        if g in fb.bindings.dataset:
            try:
                refs.append((g, fb.bindings.dataset[g].channel_index(c)))
            except (KeyError, ValueError):
                pass

    @torch.inference_mode()
    def mask(batch, coords):
        any_group = next(v for k, v in batch.items()
                         if not k.startswith("__"))
        b = any_group.shape[0]
        cb = torch.as_tensor(coords, device=any_group.device).long() \
            .expand(b, -1, -1)                                  # [B, A, 2]
        bidx = torch.arange(b, device=cb.device)[:, None]
        ok = torch.ones(cb.shape[:2], dtype=torch.bool, device=cb.device)
        for g, ci in refs:
            ok = ok & (batch[g][..., ci][bidx, cb[..., 0], cb[..., 1]] > 0)
        _, mt = fb.build_feature_at_locations(type_feature, batch, cb)
        ok = ok & mt.reshape(b, cb.shape[1], -1).all(-1)
        _, mp = fb.build_feature_at_locations(phase_feature, batch, cb)
        return ok & mp.reshape(b, cb.shape[1], -1).all(-1)

    return mask


def iter_phase_blocks(encode_type_fn: Callable, encode_phase_fn: Callable,
                      ds, anchor_stride: int, halo: int, batch_size: int,
                      max_batches: Optional[int],
                      mask_fn: Optional[Callable] = None,
                      keep_groups: Optional[set] = None, device="cuda"
                      ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Yield (zt [B,A,dt], zp [B,A,T,dp], y [B,A,T,C], valid [B,A,T]), all
    on ``device``. Anchors lie on a strided grid inside a ``halo`` border;
    ``mask_fn(batch, coords) -> [B, A]`` ANDs into the target's validity;
    ``keep_groups`` restricts the copy to the device to the groups the
    probe reads."""
    n = len(ds)
    for count, i in enumerate(range(0, n, batch_size)):
        if max_batches and count >= max_batches:
            break
        idx = list(range(i, min(i + batch_size, n)))
        batch = batch_to_device(ds.load_batch(idx), device, keep_groups)
        zt = encode_type_fn(batch)                       # [B, H, W, dt]
        coords = strided_coords(zt.shape[1], zt.shape[2], anchor_stride,
                                halo, device=zt.device)
        zp, ta, tm = encode_phase_fn(batch, coords)      # [B,A,T,dp], tgt
        zt_a = zt[:, coords[:, 0], coords[:, 1]]         # [B, A, dt]
        valid = tm.all(-1)
        if mask_fn is not None:
            valid = valid & mask_fn(batch, coords)[:, :, None]
        yield zt_a, zp, ta, valid


def _flat_design(zt, zp, valid, design: str):
    """Blocks -> (design rows [B*A*T, D_raw] float64, zeroed where invalid;
    the row mask [B*A*T]). The design is built in the embeddings' float32,
    then widened, as the JAX package builds it."""
    b, a, t, dp = zp.shape
    zt_rep = zt[:, :, None, :].expand(b, a, t, zt.shape[-1])
    x = build_design_matrix(zt_rep.reshape(-1, zt.shape[-1]),
                            zp.reshape(-1, dp), design).double()
    m = valid.reshape(-1)
    return torch.where(m[:, None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device)), m


def fit_phase_probe(encode_type_fn: Callable, encode_phase_fn: Callable,
                    ds_train, *, design: str = "full",
                    interaction_pca_k: int = 20,
                    ridge_lambda: float = 1e-3, anchor_stride: int = 4,
                    halo: int = 8, batch_size: int = 2,
                    max_batches: Optional[int] = None,
                    mask_fn: Optional[Callable] = None,
                    keep_groups: Optional[set] = None, device="cuda"
                    ) -> Tuple[np.ndarray, PhaseProbePreprocessor]:
    """Two-pass streaming ridge. Returns (W [D_out+1, C], preprocessor);
    W's last row is the bias."""

    def blocks():
        return iter_phase_blocks(encode_type_fn, encode_phase_fn, ds_train,
                                 anchor_stride, halo, batch_size,
                                 max_batches, mask_fn=mask_fn,
                                 keep_groups=keep_groups, device=device)

    # ---- pass 1: column sums and the interaction block's Gram ----------
    sums = None
    for zt, zp, _, valid in blocks():
        if sums is None:   # dims from the first block: no extra pass
            d_type, d_phase = zt.shape[-1], zp.shape[-1]
            d_main = d_type + d_phase
            d_int = d_type * d_phase
            need_pca = design == "full" and 0 < interaction_pca_k < d_int
            f64 = dict(dtype=torch.float64, device=zt.device)
            d_raw = design_dim(design, d_type, d_phase)
            sums = {"x": torch.zeros(d_raw, **f64),
                    "x2": torch.zeros(d_raw, **f64),
                    "n": torch.zeros((), **f64)}
            if need_pca:
                sums["ii"] = torch.zeros((d_int, d_int), **f64)
        x_raw, m = _flat_design(zt, zp, valid, design)
        sums["x"] += x_raw.sum(0)
        sums["x2"] += (x_raw ** 2).sum(0)
        if need_pca:
            xi = x_raw[:, d_main:]
            sums["ii"] += xi.T @ xi
        sums["n"] += m.sum()
    host = {k: v.cpu().numpy() for k, v in (sums or {}).items()}
    n_obs = float(host.get("n", 0.0))
    if n_obs == 0:
        raise ValueError("no valid probe observations (check halo/stride)")
    mean = host["x"] / n_obs
    std = np.sqrt(np.maximum(host["x2"] / n_obs - mean ** 2, 1e-12))
    pca = None
    if need_pca:
        mi, si = mean[d_main:], std[d_main:]
        cov = (host["ii"] / n_obs - np.outer(mi, mi)) / np.outer(si, si)
        _, evecs = np.linalg.eigh(cov)
        pca = np.ascontiguousarray(                  # [d_int, k], desc
            evecs[:, ::-1][:, :interaction_pca_k])
    pre = PhaseProbePreprocessor(design, d_type, d_phase, mean, std, pca)

    # ---- pass 2: ridge on the preprocessed rows ------------------------
    ridge = None
    for zt, zp, y, valid in blocks():
        x_raw, m = _flat_design(zt, zp, valid, design)
        x, y_f = pre.transform(x_raw), y.reshape(-1, y.shape[-1])
        if ridge is None:
            ridge = StreamingRidge(pre.output_dim, y_f.shape[1],
                                   f64_blocks=True)
        ridge.update(x, y_f, m & torch.isfinite(y_f).all(1)
                     & torch.isfinite(x).all(1))
    return ridge.solve(ridge_lambda), pre


def predict_phase_probe(w: np.ndarray, pre: PhaseProbePreprocessor,
                        zt: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """The fitted probe on rows [N, dt], [N, dp] -> [N, C] float64, on zt's
    device: the design in the embeddings' float32, then the preprocessor
    and W (its last row the bias) in float64."""
    w_t = torch.as_tensor(w, dtype=torch.float64, device=zt.device)
    x = pre.transform(build_design_matrix(zt, zp, pre.design))
    return x @ w_t[:-1] + w_t[-1]


def inverse_normalization_fn(fb, feature_name: str) -> Callable:
    """Map normalised values [N, C] (a float64 numpy array or a tensor)
    back to the data's scale: un-whiten, invert the preset's affine, invert
    the channel's transform. Answers in kind, in float64."""
    fc = fb.bindings.get_feature(feature_name)
    wm = fb._whitening_for(feature_name)
    inv_w = w_mean = None
    if wm is not None:
        w, w_mean = wm
        inv_w = np.linalg.inv(np.asarray(w, np.float64))
        w_mean = np.asarray(w_mean, np.float64)
    scales, offsets, tnames = [], [], []
    for ref, spec in fc.channels.items():
        preset = fb.bindings.get_normalization_preset(spec.norm)
        st = fb.channel_stats(feature_name, ref)
        t = preset.type
        if t == "zscore":
            sd = st.get("sd", 1.0)
            scale, off = (sd if sd and sd > 1e-8 else 1.0), st.get("mean", 0.0)
        elif t == "robust_iqr":
            iqr = st.get("q75", 1.0) - st.get("q25", 0.0)
            scale, off = (iqr if iqr > 1e-8 else 1.0), st.get("q50", 0.0)
        elif t == "linear_rescale":
            in_min = preset.in_min if preset.in_min is not None \
                else st.get("min", 0.0)
            in_max = preset.in_max if preset.in_max is not None \
                else st.get("max", 1.0)
            rng = in_max - in_min
            rng = rng if rng > 1e-8 else 1.0
            out_min = preset.out_min if preset.out_min is not None else 0.0
            out_max = preset.out_max if preset.out_max is not None else 1.0
            orng = (out_max - out_min) or 1.0
            scale, off = rng / orng, in_min - out_min * rng / orng
        else:
            scale, off = 1.0, 0.0
        scales.append(scale)
        offsets.append(off)
        tnames.append(spec.transform)
    scales = np.asarray(scales, np.float64)
    offsets = np.asarray(offsets, np.float64)

    def inverse(y_norm):
        if isinstance(y_norm, torch.Tensor):
            p = y_norm.double()
            f64 = dict(dtype=torch.float64, device=p.device)
            as_arr = lambda a: torch.as_tensor(a, **f64)   # noqa: E731
            stack = torch.stack
        else:
            p = np.asarray(y_norm, np.float64)
            as_arr, stack = np.asarray, np.stack
        if inv_w is not None:
            p = p @ as_arr(inv_w).T + as_arr(w_mean)
        p = p * as_arr(scales) + as_arr(offsets)
        cols = []
        for c, tn in enumerate(tnames):
            col = p[:, c]
            if tn:
                col = get_transform(tn).inverse(col)
            cols.append(col)
        return stack(cols, 1)

    return inverse


def _spearman_rho2(pred: np.ndarray, y: np.ndarray) -> float:
    """Squared Spearman rank correlation."""
    n = pred.shape[0]
    if n < 3:
        return float("nan")

    def rank(v):
        order = np.argsort(v, kind="stable")
        r = np.empty(n, np.float64)
        r[order] = np.arange(n, dtype=np.float64)
        return r

    rp, ry = rank(pred), rank(y)
    rp -= rp.mean()
    ry -= ry.mean()
    denom = np.sqrt((rp ** 2).sum() * (ry ** 2).sum())
    if denom < 1e-12:
        return float("nan")
    rho = float((rp * ry).sum() / denom)
    return rho * rho


def _nanmean(d: Dict[str, float]) -> float:
    vals = np.asarray(list(d.values()), np.float64)
    return float(np.nanmean(vals)) if vals.size else float("nan")


def _scale_metrics(sse, sum_y, sum_y2, n, names, suffix=""):
    out_mse, out_r2 = {}, {}
    for c, name in enumerate(names):
        if n[c] < 2:
            out_mse[name] = out_r2[name] = float("nan")
            continue
        ss_tot = max(sum_y2[c] - sum_y[c] ** 2 / n[c], 1e-12)
        out_mse[name] = sse[c] / n[c]
        out_r2[name] = 1.0 - sse[c] / ss_tot
    tot_n = float(n.sum())
    # Totals are the MEAN OF PER-CHANNEL values (the reference's
    # definition), not pooled sums: pooled totals let a high-variance
    # channel dominate.
    return {f"mse_per_channel{suffix}": out_mse,
            f"r2_per_channel{suffix}": out_r2,
            f"mse_total{suffix}": float(sse.sum()) / max(tot_n, 1.0),
            f"r2_total{suffix}": _nanmean(out_r2)}


_ACC_KEYS = ("sse", "sum_y", "sum_y2", "sse_o", "sum_yo", "sum_yo2",
             "sse_t", "ss_t", "sse_to", "ss_to", "n_obs")


def evaluate_phase_probe(encode_type_fn: Callable,
                         encode_phase_fn: Callable, ds, w: np.ndarray,
                         pre: PhaseProbePreprocessor, fb,
                         target_feature: str, *, anchor_stride: int = 4,
                         halo: int = 8, batch_size: int = 2,
                         max_batches: Optional[int] = None,
                         rng_seed: int = 0,
                         mask_fn: Optional[Callable] = None,
                         keep_groups: Optional[set] = None,
                         device="cuda") -> Dict:
    """Streamed evaluation: per-channel and total MSE / R^2 / Spearman
    rho^2 in the normalised and the original scale, temporal (within-pixel)
    R^2 and the within-pixel variance share. The sums are float64 on the
    device; Spearman's rows are drawn on the host by ``rng_seed``'s
    generator from the valid rows, as the JAX package draws them."""
    names: List[str] = list(fb.bindings.get_feature(target_feature)
                            .channels.keys())
    c_dim = len(names)
    inverse = inverse_normalization_fn(fb, target_feature)
    rng = np.random.default_rng(rng_seed)
    acc = None
    n_pixels = 0
    # uniform (pred, y) reservoirs per channel x scale
    reservoirs = [ReservoirSampler(_SPEARMAN_CAP, seed=rng_seed + j)
                  for j in range(2 * c_dim)]

    for zt, zp, y, valid in iter_phase_blocks(
            encode_type_fn, encode_phase_fn, ds, anchor_stride, halo,
            batch_size, max_batches, mask_fn=mask_fn,
            keep_groups=keep_groups, device=device):
        b, a, t, _ = zp.shape
        x_raw, m = _flat_design(zt, zp, valid, pre.design)
        f64 = dict(dtype=torch.float64, device=x_raw.device)
        if acc is None:
            acc = {k: torch.zeros(c_dim, **f64) for k in _ACC_KEYS}
            w_t = torch.as_tensor(w, **f64)
            zero = torch.zeros((), **f64)
        mc = m[:, None]
        pred_f = pre.transform(x_raw) @ w_t[:-1] + w_t[-1]   # [M, C]
        y_f = y.reshape(-1, c_dim).double()
        pred = torch.where(mc, pred_f, zero)
        yo = torch.where(mc, inverse(torch.where(mc, y_f, zero)), zero)
        po = torch.where(mc, inverse(pred_f), zero)
        pred, yb, yo, po = (v.reshape(b, a, t, c_dim)
                            for v in (pred, y_f, yo, po))

        v = valid[..., None].double()                       # [B,A,T,1]
        acc["n_obs"] += v.sum((0, 1, 2))
        for sse_k, sy_k, sy2_k, p_, y_ in (
                ("sse", "sum_y", "sum_y2", pred, yb),
                ("sse_o", "sum_yo", "sum_yo2", po, yo)):
            acc[sse_k] += ((p_ - y_) ** 2 * v).sum((0, 1, 2))
            acc[sy_k] += (y_ * v).sum((0, 1, 2))
            acc[sy2_k] += (y_ ** 2 * v).sum((0, 1, 2))

        # temporal decomposition: demean each pixel's valid time series
        cnt_px = torch.clamp(v.sum(2), min=1.0)              # [B,A,1]
        px_valid = v.sum(2)[..., 0] >= 2                     # [B,A]
        vv = v * px_valid[..., None, None]
        for sse_k, ss_k, p_, y_ in (("sse_t", "ss_t", pred, yb),
                                    ("sse_to", "ss_to", po, yo)):
            y_mu = (y_ * v).sum(2, keepdim=True) / cnt_px[:, :, None]
            p_mu = (p_ * v).sum(2, keepdim=True) / cnt_px[:, :, None]
            acc[sse_k] += (((p_ - p_mu) - (y_ - y_mu)) ** 2
                           * vv).sum((0, 1, 2))
            # ss_t doubles as the within-pixel variance accumulator
            acc[ss_k] += ((y_ - y_mu) ** 2 * vv).sum((0, 1, 2))

        # bounded uniform subsample of the valid rows for Spearman
        mm = np.flatnonzero(m.cpu().numpy())
        n_pixels += int(px_valid.sum())
        take = min(len(mm), 4096)
        sel = rng.choice(mm, size=take, replace=False) if take else mm
        if len(sel):
            sel_t = torch.as_tensor(sel, device=m.device)
            rows = [r.reshape(-1, c_dim)[sel_t].cpu().numpy()
                    for r in (pred, yb, po, yo)]
            for c in range(c_dim):
                for off, (p_, y_) in enumerate(((rows[0], rows[1]),
                                                (rows[2], rows[3]))):
                    reservoirs[off * c_dim + c].add(
                        np.stack([p_[:, c], y_[:, c]], axis=1))

    a_h = ({k: v.cpu().numpy() for k, v in acc.items()} if acc is not None
           else {k: np.zeros(c_dim) for k in _ACC_KEYS})
    n_obs = a_h["n_obs"]
    out: Dict = {"n_observations": int(n_obs.max(initial=0)),
                 "n_pixels": n_pixels, "channels": names}
    out.update(_scale_metrics(a_h["sse"], a_h["sum_y"], a_h["sum_y2"],
                              n_obs, names))
    out.update(_scale_metrics(a_h["sse_o"], a_h["sum_yo"], a_h["sum_yo2"],
                              n_obs, names, suffix="_original"))
    for suffix, sse_t, ss_t in (("", a_h["sse_t"], a_h["ss_t"]),
                                ("_original", a_h["sse_to"], a_h["ss_to"])):
        per = {nm: (1.0 - sse_t[c] / max(ss_t[c], 1e-12)) if ss_t[c] > 0
               else float("nan") for c, nm in enumerate(names)}
        out[f"r2_temporal_per_channel{suffix}"] = per
        out[f"r2_temporal_total{suffix}"] = _nanmean(per)
    ss_tot = np.maximum(a_h["sum_y2"] - a_h["sum_y"] ** 2
                        / np.maximum(n_obs, 1.0), 1e-12)
    out["variance_fraction_temporal"] = {
        nm: float(a_h["ss_t"][c] / ss_tot[c]) for c, nm in enumerate(names)}
    out["variance_fraction_temporal_total"] = \
        _nanmean(out["variance_fraction_temporal"])
    for suffix, off in (("", 0), ("_original", 1)):
        per = {}
        for c, nm in enumerate(names):
            r = reservoirs[off * c_dim + c]
            buf = r.sample() if r.n_seen else np.zeros((0, 2))
            per[nm] = _spearman_rho2(buf[:, 0], buf[:, 1])
        out[f"spearman_rho2_per_channel{suffix}"] = per
        out[f"spearman_rho2_total{suffix}"] = _nanmean(per)
    return out


def format_phase_probe_report(m: Dict, prefix: str = "") -> str:
    """Per-metric table block."""
    names = m["channels"]
    lines = [f"===== phase probe {prefix} "
             f"(n_obs={m['n_observations']:,}, n_pixels={m['n_pixels']:,}) "
             "=====",
             f"  {'channel':<22s} {'R2':>8} {'R2 orig':>8} {'R2 temp':>8} "
             f"{'rho2':>8} {'MSE':>10} {'var_t%':>7}"]
    for nm in names:
        lines.append(
            f"  {nm:<22s} {m['r2_per_channel'][nm]:>8.4f} "
            f"{m['r2_per_channel_original'][nm]:>8.4f} "
            f"{m['r2_temporal_per_channel'][nm]:>8.4f} "
            f"{m['spearman_rho2_per_channel'][nm]:>8.4f} "
            f"{m['mse_per_channel'][nm]:>10.4g} "
            f"{100 * m['variance_fraction_temporal'][nm]:>6.1f}%")
    lines.append(
        f"  {'TOTAL':<22s} {m['r2_total']:>8.4f} "
        f"{m['r2_total_original']:>8.4f} {m['r2_temporal_total']:>8.4f} "
        f"{m.get('spearman_rho2_total', float('nan')):>8.4f} "
        f"{m['mse_total']:>10.4g} "
        f"{100 * m['variance_fraction_temporal_total']:>6.1f}%")
    return "\n".join(lines)


def main(argv=None):
    """Fit the phase probe from a trained checkpoint, report train / val
    metrics, optionally save the fitted probe (weights + preprocessor) as
    JSON.

    python -m forest_tpu_torch.eval.phase_probe --checkpoint CKPT
        --bindings B.yaml [--design full] [--interaction-pca-k 20]
        [--halo 16] [--device cuda] ...
    """
    import argparse
    import json
    import sys
    from pathlib import Path

    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--bindings", required=True)
    ap.add_argument("--target-feature", default=None,
                    help="defaults to the phase loss's neighborhood_target "
                         "feature from the bindings; falls back to the "
                         "phase INPUT feature with a warning, which "
                         "measures reconstruction, not prediction")
    ap.add_argument("--patch-size", type=int, default=256)
    ap.add_argument("--split-block-size", type=int, nargs=2, default=(4, 4))
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--ridge-lambda", type=float, default=1e-3)
    ap.add_argument("--halo", type=int, default=16)
    ap.add_argument("--anchor-stride", type=int, default=4)
    ap.add_argument("--max-batches", type=int, default=0)
    ap.add_argument("--design", default="full", choices=DESIGN_CHOICES)
    ap.add_argument("--interaction-pca-k", type=int, default=20)
    ap.add_argument("--output", default=None,
                    help="save fitted probe (weights+preprocessor) JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the encoder and the probe's sums run "
                         "(default: cuda)")
    a = ap.parse_args(argv)

    device = frozen.resolve_device(a.device)
    bindings = parse_bindings(a.bindings)
    fb = FeatureBuilder(bindings)
    model = frozen.load_frozen_model(a.checkpoint, device)
    enc_t, enc_p, _ = frozen.make_encode_fns(model, fb)
    type_feature, phase_feature = "type_encoder_input", "phase_ccdc"
    target_feature = a.target_feature
    if target_feature is None:
        ph = (bindings.losses or {}).get("phase_neighborhood") or {}
        nt = ph.get("neighborhood_target")
        if isinstance(nt, str):
            target_feature = nt.split(".", 1)[1] \
                if nt.startswith("features.") else nt
        if target_feature is None or target_feature not in bindings.features:
            target_feature = phase_feature
            print(f"[phase_probe] warning: no phase neighborhood_target in "
                  f"the bindings; probing against the phase INPUT feature "
                  f"{target_feature!r} measures reconstruction, not "
                  "prediction (pass --target-feature to override)",
                  file=sys.stderr)
    targets = frozen.make_phase_target_fn(fb, target_feature)
    mask_fn = make_probe_mask_fn(fb, type_feature, phase_feature)
    keep = set(bindings.groups_for_features(
        [type_feature, phase_feature, target_feature])) | {"static_mask"}

    def enc_phase_fn(batch, coords):
        zp = enc_p(batch, coords)
        ta, tm = targets(batch, coords)
        return zp, ta, tm

    mb = a.max_batches or None
    ds = {split: ForestDatasetV2(
        bindings, split=split, patch_size=a.patch_size,
        split_block_size=tuple(a.split_block_size))
        for split in ("train", "val")}
    for split, d in ds.items():
        frozen.require_patches(d, split, a.patch_size, a.split_block_size)
    common = dict(anchor_stride=a.anchor_stride, halo=a.halo,
                  batch_size=a.batch_size, max_batches=mb, mask_fn=mask_fn,
                  keep_groups=keep, device=device)
    w, pre = fit_phase_probe(
        enc_t, enc_phase_fn, ds["train"], design=a.design,
        interaction_pca_k=a.interaction_pca_k,
        ridge_lambda=a.ridge_lambda, **common)
    metrics = {}
    for split in ("train", "val"):
        metrics[split] = evaluate_phase_probe(
            enc_t, enc_phase_fn, ds[split], w, pre, fb, target_feature,
            **common)
        print(format_phase_probe_report(metrics[split], split))
    if a.output:
        Path(a.output).write_text(json.dumps(
            {"weights": w.tolist(), "preprocessor": pre.to_dict(),
             "target_feature": target_feature}))
        print(f"saved probe to {a.output}")
    return {"weights": w, "preprocessor": pre, "metrics": metrics,
            "target_feature": target_feature}


if __name__ == "__main__":
    main()


__all__ = ["DESIGN_CHOICES", "PhaseProbePreprocessor",
           "build_design_matrix", "design_dim", "fit_phase_probe",
           "evaluate_phase_probe", "inverse_normalization_fn",
           "iter_phase_blocks", "make_probe_mask_fn", "predict_phase_probe",
           "format_phase_probe_report", "main"]
