"""Runnable demos for every loss family on synthetic tensors, on the port.

The PyTorch counterpart of ``examples/example_losses.py``: the same demos,
the same inputs (one ``np.random.default_rng(0)`` drawn in the same order)
and the same printed lines, through ``forest_tpu_torch``. On a card
``demo_vq`` runs the hand-written VQ kernel (``ops.vq.vq_core``).

Run: python examples/torch_example_losses.py [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # run from a checkout, not installed
    sys.path.insert(0, str(ROOT))
from forest_tpu_torch.data.loader import resolve_device  # noqa: E402

LINES = {
    "vq": "vq: vq_loss={vq_loss:.4f} perplexity={perplexity:.1f} "
          "codebook moved {moved:.4f}",
    "contrastive": "contrastive: loss={loss:.4f} anchors={anchors}",
    "grouped": "grouped infonce: loss={loss:.4f} anchors={anchors} "
               "pos_sim={pos_sim:.3f} neg_sim={neg_sim:.3f}",
    "vicreg": "vicreg: total={total:.4f} var={var:.4f} cov={cov:.4f}",
    "soft_neighborhood": "soft_neighborhood: loss={loss:.4f} rows={rows}",
    "pairs_knn": "pairs knn: {valid} valid of {size}",
    "pairs_mutual": "pairs mutual-knn: {valid} valid",
    "pairs_adj": "pairs quantile(0.1): {quantile} edges; radius: {radius} "
                 "edges",
    "phase": "phase pairs: {pairs} -> neighborhood loss={loss:.4f} "
             "(self {self:.3f} / cross {cross:.3f})",
    "spread": "phase spread: loss={loss:.4f} "
              "frac_satisfied={frac_satisfied:.3f}",
    "triplet": "triplet: loss={loss:.4f} constraints={constraints}",
    "recovery": "recovery_disc: loss={loss:.4f} pixels={pixels}",
    "evt": "evt soft-neighborhood: loss={loss:.4f} anchors={anchors}",
    "reconstruction": "reconstruction={reconstruction:.4f} "
                      "categorical={categorical:.4f} count={count:.4f}",
    "demean": "type-local demean: |spec|={spec:.3f} -> "
              "|demeaned|={demeaned:.3f}",
}


def say(out: dict, key: str, **values) -> None:
    """Print ``LINES[key]`` filled with ``values`` and keep the values."""
    print(LINES[key].format(**values))
    out[key] = values


class Demo:
    """The numpy draws of one run, turned into tensors on one device."""

    def __init__(self, rng: np.random.Generator, device: torch.device):
        self.rng, self.device = rng, device

    def t(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def normal(self, *shape) -> torch.Tensor:
        return self.t(self.rng.normal(size=shape))


def demo_contrastive(d: Demo, out: dict):
    from forest_tpu_torch.losses.contrastive import contrastive_loss

    za, zo = d.normal(8, 16), d.normal(8, 16)
    aid = d.t([0, 0, 0, 0, 1, 1, 1, 1], torch.int64)
    is_pos = d.t([1, 1, 0, 0, 1, 0, 0, 0], torch.bool)
    loss, aux = contrastive_loss(za, zo, aid, is_pos, 2)
    say(out, "contrastive", loss=float(loss),
        anchors=int(aux["n_anchors_used"]))


def demo_vicreg(d: Demo, out: dict):
    from forest_tpu_torch.losses.variance_covariance import (
        variance_covariance_loss)

    total, v, c = variance_covariance_loss(d.normal(256, 16))
    say(out, "vicreg", total=float(total), var=float(v), cov=float(c))


def demo_soft_neighborhood(d: Demo, out: dict):
    from forest_tpu_torch.losses.soft_neighborhood import (
        pairwise_sq_distances, soft_neighborhood_matching_loss)

    x = d.normal(2, 6, 4)
    dist = torch.sqrt(pairwise_sq_distances(x))
    mask = ~torch.eye(6, dtype=torch.bool, device=d.device)[None].repeat(
        2, 1, 1)
    loss, stats = soft_neighborhood_matching_loss(dist, dist * 1.3, mask)
    say(out, "soft_neighborhood", loss=float(loss),
        rows=int(stats["n_rows_valid"]))


def phase_inputs(d: Demo, n: int, t: int):
    from forest_tpu_torch.losses.phase_pairs import build_phase_pairs

    spec2d = d.normal(n, 4)
    spec = d.normal(n, t, 4)
    phase = d.normal(n, t, 3)
    ysfc = d.t(d.rng.integers(0, 6, size=(n, t)))
    pairs, w, valid, stats = build_phase_pairs(spec2d, ysfc, k=4,
                                               min_overlap=2, min_pairs=1)
    return spec, phase, ysfc, pairs, w, valid, stats


def neighborhood_batch(spec, phase, ysfc, pairs, valid):
    """The JAX demo's one sample of N anchors as the port's [S = 1] batch."""
    from forest_tpu_torch.losses.phase_neighborhood import (
        build_phase_neighborhood_batch)

    return build_phase_neighborhood_batch(spec[None], phase[None],
                                          ysfc[None], pairs[None],
                                          valid[None], 2)


def demo_phase(d: Demo, out: dict):
    from forest_tpu_torch.losses.phase_neighborhood import (
        phase_neighborhood_loss)

    spec, phase, ysfc, pairs, w, valid, stats = phase_inputs(d, 12, 8)
    loss, pstats = phase_neighborhood_loss(
        neighborhood_batch(spec, phase, ysfc, pairs, valid), w)
    say(out, "phase", pairs=int(stats["n_total_pairs"]), loss=float(loss),
        self=float(pstats["loss_self"]), cross=float(pstats["loss_cross"]))


def demo_triplet(d: Demo, out: dict):
    from forest_tpu_torch.losses.triplet_phase import (
        phase_recovery_discrimination_loss, phase_triplet_loss)

    n, t, dim = 16, 8, 4
    e = [d.normal(n, dim) for _ in range(3)]
    ysfc = d.t(d.rng.integers(0, 8, size=(n, t)))
    loss, stats = phase_triplet_loss(*e, ysfc, 0, 4, 7)
    say(out, "triplet", loss=float(loss),
        constraints=int(stats["n_constraints"]))
    rd, rstats = phase_recovery_discrimination_loss(d.normal(n, t, dim),
                                                    ysfc)
    say(out, "recovery", loss=float(rd),
        pixels=int(rstats["n_active_pixels"]))


def demo_vq(d: Demo, out: dict):
    from forest_tpu_torch.ops import vq

    x, cb = d.normal(512, 32), d.normal(64, 32)
    r = vq.quantize(x, cb, mode="ema")
    stats = vq.VQStats.init(64, 32, device=d.device)
    stats, new_cb = vq.ema_codebook_update(stats, cb, r.counts, r.sums)
    say(out, "vq", vq_loss=float(r.vq_loss), perplexity=float(r.perplexity),
        moved=float((new_cb - cb).abs().mean()))
    out["vq_indices"] = r.indices.cpu().numpy()


def demo_grouped_infonce(d: Demo, out: dict):
    """Weighted anchor-grouped InfoNCE in the dense [S, K] layout of the FRL
    step."""
    from forest_tpu_torch.losses.contrastive import contrastive_loss_grouped

    s, k, dim = 32, 6, 16
    za, zo = d.normal(s, dim), d.normal(s, k, dim)
    is_pos = d.t(d.rng.random(size=(s, k)) < 0.4, torch.bool)
    w = d.t(d.rng.uniform(0.05, 1.0, size=(s, k)))
    pv = d.t(d.rng.random(size=(s, k)) < 0.9, torch.bool)
    loss, aux = contrastive_loss_grouped(za, zo, is_pos, weights=w,
                                         pair_valid=pv)
    say(out, "grouped", loss=float(loss), anchors=int(aux["n_anchors_used"]),
        pos_sim=float(aux["mean_pos_sim"]),
        neg_sim=float(aux["mean_neg_sim"]))


def demo_pairs(d: Demo, out: dict):
    """Pair construction strategies."""
    from forest_tpu_torch.losses import pairs as pm

    x = d.normal(64, 8)
    dist = torch.linalg.norm(x[:, None] - x[None], dim=-1)
    _, valid = pm.pairs_knn(dist, k=4)
    say(out, "pairs_knn", valid=int(valid.sum()), size=valid.numel())
    _, mvalid = pm.pairs_mutual_knn(dist, k=4)
    say(out, "pairs_mutual", valid=int(mvalid.sum()))
    adj_q = pm.pairs_quantile(dist, 0.1)
    adj_r = pm.pairs_radius(dist, float(torch.quantile(dist, 0.1)))
    say(out, "pairs_adj", quantile=int(adj_q.sum()), radius=int(adj_r.sum()))


def demo_evt(d: Demo, out: dict):
    """EVT diffusion-metric soft neighborhood (the loss check_evt_tau
    calibrates)."""
    from forest_tpu_torch.losses.evt_soft_neighborhood import (
        evt_soft_neighborhood_loss)

    n, dim, ktypes = 48, 16, 5
    z = d.normal(n, dim)
    sim = d.rng.uniform(0.1, 1.0, size=(ktypes, ktypes))
    sim = d.t((sim + sim.T) / 2 + np.eye(ktypes))
    e_idx = d.t(d.rng.integers(0, ktypes, size=(n,)), torch.int32)
    e_valid = d.t(d.rng.random(n) < 0.9, torch.bool)
    e_w = torch.ones(n, device=d.device)
    loss, stats = evt_soft_neighborhood_loss(z, e_idx, e_valid, e_w, sim,
                                             e_idx, 0.5, 0.5, 4)
    say(out, "evt", loss=float(loss), anchors=int(stats["n_anchors_valid"]))


def demo_spread(d: Demo, out: dict):
    """Phase spread ranking on a neighborhood batch."""
    from forest_tpu_torch.losses.phase_neighborhood import (
        compute_phase_spread_ranking)

    spec, phase, ysfc, pairs, _, valid, _ = phase_inputs(d, 24, 10)
    batch = neighborhood_batch(spec, phase, ysfc, pairs, valid)
    dyn = spec.std(dim=1, correction=0).mean(-1)
    loss, stats = compute_phase_spread_ranking(batch, batch["pair_index"],
                                               dyn)
    say(out, "spread", loss=float(loss),
        frac_satisfied=float(stats["frac_satisfied"]))


def demo_reconstruction(d: Demo, out: dict):
    """Element-wise VQ-VAE losses: masked reconstruction, categorical and
    count."""
    from forest_tpu_torch.losses.categorical import categorical_loss
    from forest_tpu_torch.losses.count import count_loss
    from forest_tpu_torch.losses.reconstruction import reconstruction_loss

    b, t, c = 16, 5, 6
    pred = d.normal(b, t, c)
    tgt = pred + 0.1 * d.normal(b, t, c)
    tgt[0, 0, 0] = float("nan")  # missing data stays masked
    rec = reconstruction_loss(pred, tgt)
    logits = d.normal(b, t, 7)
    labels = d.rng.integers(-1, 7, size=(b, t))
    labels = d.t(np.where(labels < 0, -100, labels), torch.int32)
    cat = categorical_loss(logits, labels)
    cnt = count_loss(d.normal(b), d.t(d.rng.integers(0, 9, size=(b,))))
    say(out, "reconstruction", reconstruction=float(rec),
        categorical=float(cat), count=float(cnt))


def demo_type_local_demean(d: Demo, out: dict):
    """Cross-batch type-local spectral baseline feeding the phase losses."""
    from forest_tpu_torch.losses.phase_neighborhood import (
        type_local_spectral_demean)

    n, t, c, zt = 40, 8, 6, 16
    z_type = d.normal(n, zt)
    spec = d.normal(n, t, c)
    valid = d.t(d.rng.random(n) < 0.9, torch.bool)
    dm, _ = type_local_spectral_demean(z_type, spec, valid, 8, 5)
    say(out, "demean", spec=float(spec.abs().mean()),
        demeaned=float(dm.abs().mean()))


DEMOS = (demo_vq, demo_contrastive, demo_grouped_infonce, demo_vicreg,
         demo_soft_neighborhood, demo_pairs, demo_phase, demo_spread,
         demo_triplet, demo_evt, demo_reconstruction, demo_type_local_demean)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    d = Demo(np.random.default_rng(0), resolve_device(a.device))
    out: dict = {}
    for demo in DEMOS:
        demo(d, out)
    return out


if __name__ == "__main__":
    main()
