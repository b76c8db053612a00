"""process_batch: the FRL per-batch algorithm, every stage and loss.

Port of ``forest_tpu/training/representation/step.py``:

  1. type features -> z_type (+ smoothing gate) for the full batch;
  2. per-sample jittered-grid + supplement anchors, per-sample numerical
     containment (a sample with a non-finite built feature is zeroed at the
     input and its anchors are invalidated);
  3. spatial InfoNCE: offset-grid kNN positives (spectral-similarity
     weighted exp(-d/sigma)) + distance-ring negatives from a shared pool,
     one grouped InfoNCE over B*A anchors;
  4. VICReg on z_type anchors;
  5. the phase pathway: ysfc at the anchors (raw, NaN kept), phase anchors
     valid only where ysfc is finite at every timestep, the phase forward
     on stop-gradient z_type, per-sample phase pairs, the type-local
     spectral demean, the phase neighbourhood KL, the spread ranking,
     recovery discrimination, phase VICReg and the Frobenius type leakage;
  6. cross-batch spectral InfoNCE: chunked mutual-kNN positives over the
     pooled anchors + random cross-patch negatives weighted 1 - exp(-d/tau);
  7. the EVT soft neighbourhood on z_type anchors (``cfg.evt_enabled``,
     with the tables of :func:`build_evt_tables`);
  7b. with ``diag=True``, the diagnostics of ``diagnostics.py``;
  8. the weighted total over all nine loss weights.

All anchor rows (anchors, positive neighbours, the negative pool) leave
z_type through ONE :func:`~forest_tpu_torch.ops.scatter.extract_at_coords`,
whose backward is the row scatter-add kernel; anchors then reach their
negatives by a plain gather from the pool rows.

Host synchronisations of the stages here: three a step on a card, each a
copy in ``aten::to`` (read by the spans of ``utils.spans`` and the Python
frames of a traced step): one in the type encoder (``model.type_encoder``:
the Sobel templates of ``ops.smoothing.sobel_grads``), one in
``utils.spatial.spatial_knn_pairs`` (its kNN offsets) and one in the
demean (its [D, D] Gram to the host for ``eigh``,
``type_local_spectral_demean``). The feature builds (``data.features``)
make none: each is one kernel launch, its parameter table and whitening
matrix kept on the card from the first build. The train step adds two:
its finite test and its ``skipped`` flag.

Randomness: a step makes six kinds of draws (anchor jitter and supplement,
negative pool and picks, cross-batch negatives, the encoder's input and
layer dropout, the phase TCN's dropout). :func:`draw_step_randoms` makes
them all from one ``torch.Generator`` as raw uniform / integer tensors
(:class:`StepDraws`); ``process_batch`` takes ready-made draws instead when
given, which is how a test feeds it another framework's numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from forest_tpu_torch.data.anchor_sampling import (AnchorSampler,
                                                   draw_grid_jitter)
from forest_tpu_torch.data.feature_builder import FeatureBuilder
from forest_tpu_torch.losses import pairs as pairs_mod
from forest_tpu_torch.losses.contrastive import contrastive_loss_grouped
from forest_tpu_torch.losses.evt_soft_neighborhood import \
    evt_soft_neighborhood_loss
from forest_tpu_torch.losses.phase_neighborhood import (
    build_phase_neighborhood_batch, compute_phase_spread_ranking,
    phase_neighborhood_loss, type_local_spectral_demean)
from forest_tpu_torch.losses.phase_pairs import build_phase_pairs
from forest_tpu_torch.losses.triplet_phase import \
    phase_recovery_discrimination_loss
from forest_tpu_torch.losses.variance_covariance import \
    variance_covariance_loss
from forest_tpu_torch.models.conv2d_encoder import EncoderDraws
from forest_tpu_torch.ops.scatter import extract_at_coords
from forest_tpu_torch.training.representation import diagnostics as dg
from forest_tpu_torch.utils import spatial as sp
from forest_tpu_torch.utils.draws import randint, uniform

#: size of the shared per-sample negative pool (spatial_negative_slots)
NEG_POOL_SIZE = 512


@dataclass(frozen=True)
class StepConfig:
    """Static configuration of the step -- the config_builders output, with
    the JAX package's fields."""
    # feature names (bindings)
    type_feature: str = "type_encoder_input"
    spectral_feature: str = "infonce_type_spectral"
    phase_feature: str = "phase_ccdc"
    ysfc_source: str = "annual.ysfc"
    # spatial InfoNCE
    knn_k: int = 4
    knn_max_radius: int = 8
    neg_min_distance: float = 16.0
    neg_max_distance: Optional[float] = None
    neg_per_anchor: int = 4
    spectral_sigma: float = 2.0
    min_pair_weight: float = 0.05
    temperature: float = 0.07
    similarity: str = "l2"
    # VICReg
    vcr_std_target: float = 1.0
    vcr_variance_weight: float = 1.0
    vcr_covariance_weight: float = 1.0
    # phase
    phase_k: int = 16
    phase_min_overlap: int = 3
    phase_min_pairs: int = 5
    phase_sigma: float = 5.0
    phase_tau_ref: float = 0.1
    phase_tau_learned: float = 0.1
    phase_self_weight: float = 1.0
    phase_cross_weight: float = 1.0
    num_ysfc_classes: int = 64
    spread_margin: float = 0.1
    spread_delta: float = 0.5
    dynamism_feature: Optional[str] = None
    rd_margin: float = 0.5
    rd_low_ysfc_max: float = 1.0
    rd_high_ysfc_min: float = 5.0
    # cross-batch spectral
    xb_knn_k: int = 10
    xb_chunk_size: int = 128
    xb_pos_min_spatial: float = 4.0
    xb_neg_per_anchor: int = 4
    xb_neg_tau: float = 1.0
    xb_neg_min_weight: float = 0.05
    xb_temperature: float = 0.07
    # type-local spectral demean of the phase losses
    xb_phase_pca_dim: int = 8
    xb_phase_knn_k: int = 20
    # EVT (optional)
    evt_enabled: bool = False
    evt_feature: str = "static_categorical.evt"
    evt_tau_ref: float = 0.5
    evt_tau_learned: float = 0.5
    evt_min_valid_anchors: int = 4


def wire_exact_groups(cfg: StepConfig) -> tuple:
    """Batch groups this step compares by exact value, which must never
    ride the compact wire's bfloat16 (``data.wire``): EVT codes 7000+ are
    not exact in bfloat16, and a rounded code merges or splits classes in
    the soft-neighbourhood grouping. The group's name comes from the
    configuration (``losses.evt.feature``), so the wire's name-based
    "categorical" rule is not enough; ``run_epoch(wire_skip=...)`` takes
    this set. ysfc values are small integers, exact in bfloat16."""
    return (cfg.evt_feature.split(".")[0],) if cfg.evt_enabled else ()


DEFAULT_WEIGHTS = {
    "spatial_infonce": 1.0,
    "spectral_infonce": 1.0,
    "vicreg_type": 1.0,
    "vicreg_phase": 0.1,
    "phase_neighborhood": 1.0,
    "phase_spread": 0.1,
    "recovery_disc": 0.1,
    "type_leakage": 0.01,
    "evt": 0.0,
}


def _masked_mean_rows(x: torch.Tensor, valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    v = valid.to(x.dtype)[:, None]
    cnt = torch.clamp(v.sum(), min=1.0)
    return (x * v).sum(0) / cnt, cnt


def frobenius_type_leakage(h_pre: torch.Tensor, z_type_sg: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """||cov(mean_T h_pre, sg(z_type))||_F over the valid anchors: the
    Frobenius NORM (its square's gradient vanishes where the penalty should
    still push); the 1e-12 floor keeps the gradient of the square root
    finite at zero covariance."""
    h = h_pre.mean(1)                                          # [N, zp]
    mu_h, cnt = _masked_mean_rows(h, valid)
    mu_z, _ = _masked_mean_rows(z_type_sg, valid)
    v = valid.to(h.dtype)[:, None]
    hc = (h - mu_h) * v
    zc = (z_type_sg - mu_z) * v
    cross = (hc.t() @ zc) / torch.clamp(cnt - 1.0, min=1.0)
    return torch.sqrt((cross * cross).sum() + 1e-12)


@dataclass
class StepDraws:
    """The raw random draws of one ``process_batch`` call.

    ``anchor_jitter`` int [B, 2]; ``anchor_supplement_u`` uniform [B, H*W]
    (None for the plain grid strategy); ``neg_pool_u`` uniform [B, H*W];
    ``neg_pick_u`` uniform [B, A, P]; ``xb_neg_j`` int [B*A, n] in
    [0, B*A); ``encoder`` the encoder's dropout draws and ``phase`` the
    phase TCN's (one uniform [B*A, 1, C_in] per block, empty at dropout 0;
    both None when not training)."""
    anchor_jitter: torch.Tensor
    anchor_supplement_u: Optional[torch.Tensor]
    neg_pool_u: torch.Tensor
    neg_pick_u: torch.Tensor
    xb_neg_j: torch.Tensor
    encoder: Optional[EncoderDraws] = None
    phase: Optional[Tuple[torch.Tensor, ...]] = None


def draw_step_randoms(generator: Optional[torch.Generator], batch_size: int,
                      patch_size: int, sampler: AnchorSampler,
                      cfg: StepConfig, model=None, train: bool = True,
                      device="cuda") -> StepDraws:
    """All draws of one step from ``generator`` (on the generator's device,
    then moved to ``device``: the card unless the caller asks for the CPU).
    ``model`` is needed for the dropout draws when ``train``."""
    h = w = patch_size
    a = sampler.n_anchors(h, w)
    p = min(NEG_POOL_SIZE, h * w)
    n_flat = batch_size * a
    supp = sampler.cfg.strategy == "grid-plus-supplement"
    return StepDraws(
        anchor_jitter=draw_grid_jitter(batch_size, sampler.cfg.jitter_radius,
                                       generator, device),
        anchor_supplement_u=(uniform((batch_size, h * w), generator, device)
                             if supp else None),
        neg_pool_u=uniform((batch_size, h * w), generator, device),
        neg_pick_u=uniform((batch_size, a, p), generator, device),
        xb_neg_j=randint(0, n_flat, (n_flat, cfg.xb_neg_per_anchor),
                         generator, device),
        encoder=(model.encoder.draw(batch_size, generator, device)
                 if train else None),
        phase=(model.phase_tcn.draw(n_flat, generator, device)
               if train else None))


def make_process_batch(model, feature_builder: FeatureBuilder,
                       sampler: AnchorSampler, cfg: StepConfig,
                       patch_size: int,
                       evt_tables: Optional[Dict[str, np.ndarray]] = None,
                       diag: bool = False, device="cuda") -> Callable:
    """Returns fn(batch, generator, weights, curriculum, train=True,
    draws=None) -> (total_loss, metrics).

    The model is moved to ``device`` (the card unless the caller asks for
    the CPU) and every tensor of a step lives there. ``batch`` is the dict
    of group arrays [B, ...] from ``ForestDatasetV2.load_batch`` (numpy or
    tensors; moved to ``device``); ``weights`` a dict with the
    DEFAULT_WEIGHTS keys; ``curriculum`` a dict with ``input_dropout_rate``
    / ``min_gate``. ``evt_tables`` (:func:`build_evt_tables`) is required
    when ``cfg.evt_enabled``; ``diag`` adds the diagnostics to the metrics.
    ``total_loss`` carries the graph to the model's parameters; ``metrics``
    are detached 0-d tensors on the device."""
    if cfg.evt_enabled and evt_tables is None:
        raise ValueError("cfg.evt_enabled needs evt_tables "
                         "(build_evt_tables of an EvtDiffusionMetric)")
    fb = feature_builder
    h = w = patch_size
    n_anchors = sampler.n_anchors(h, w)
    device = torch.device(device)
    model.to(device)
    evt_tables_t = None
    if cfg.evt_enabled:
        evt_tables_t = {
            k: (int(v) if k == "code_offset"
                else torch.as_tensor(np.asarray(v)).to(device))
            for k, v in evt_tables.items()}

    def group_channel(batch, ref):
        gname, cname = ref.split(".")
        ci = fb.bindings.dataset[gname].channel_index(cname)
        return batch[gname][..., ci].float()

    def process_batch(batch, generator, weights, curriculum,
                      train: bool = True,
                      draws: Optional[StepDraws] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        bsz = next(v for k, v in batch.items()
                   if not k.startswith("__")).shape[0]
        if draws is None:
            draws = draw_step_randoms(generator, bsz, patch_size, sampler,
                                      cfg, model, train, device)
        metrics: Dict[str, torch.Tensor] = {}
        bidx = torch.arange(bsz, device=device)

        # ---- 1. type pathway -------------------------------------------
        x_type, m_type = fb.build_feature(cfg.type_feature, batch)
        # Per-sample containment: a sample whose built features are
        # non-finite is zeroed at the INPUT and its anchors invalidated
        # below. Masking only at the loss cannot keep NaN activations out of
        # the parameter gradients (0 * NaN = NaN).
        ok_type = torch.isfinite(x_type).all(dim=(1, 2, 3))          # [B]
        x_type = torch.where(ok_type[:, None, None, None], x_type,
                             torch.zeros_like(x_type))
        z_type, gate = model(
            x_type, return_gate=True,
            input_dropout_rate=curriculum.get("input_dropout_rate", 0.0),
            min_gate=curriculum.get("min_gate", 0.0),
            deterministic=not train, draws=draws.encoder)
        metrics["gate_mean"] = gate.mean()

        # ---- 2. anchors -------------------------------------------------
        grids = {ref: torch.nan_to_num(group_channel(batch, ref))
                 for ref in sampler.grid_names()}
        coords, a_valid = sampler(
            grids, bsz, h, w, device, jitter=draws.anchor_jitter,
            supplement_u=draws.anchor_supplement_u)           # [B, A, 2]
        spec_a, spec_m = fb.build_feature_at_locations(
            cfg.spectral_feature, batch, coords)
        pixel_mask = m_type.any(-1)                           # [B, H, W]
        a_valid = a_valid & spec_m.any(-1)
        a_valid = a_valid & pixel_mask[bidx[:, None], coords[..., 0],
                                       coords[..., 1]]
        # Phase features are built here (rather than in stage 5) so that
        # the containment test covers every network input in one place.
        phase_x, _ = fb.build_feature_at_locations(
            cfg.phase_feature, batch, coords)
        ok_spec = torch.isfinite(spec_a).all(dim=(1, 2))
        ok_phase = torch.isfinite(phase_x).all(dim=(1, 2, 3))
        sample_fin = ok_type & ok_spec & ok_phase                    # [B]
        # Ragged-tail padding of an epoch loop: repeated rows are valid
        # data but must not contribute twice.
        pad_valid = batch.get("__sample_valid__")
        pad_valid = (torch.ones(bsz, dtype=torch.bool, device=device)
                     if pad_valid is None else pad_valid.bool())
        metrics["samples_skipped"] = (~sample_fin & pad_valid).sum()
        sample_ok = sample_fin & pad_valid
        spec_a = torch.where(sample_ok[:, None, None], spec_a,
                             torch.zeros_like(spec_a))
        phase_x = torch.where(sample_ok[:, None, None, None], phase_x,
                              torch.zeros_like(phase_x))
        a_valid = a_valid & sample_ok[:, None]
        metrics["n_anchors_valid"] = a_valid.sum()

        a = n_anchors
        n_flat = bsz * a
        flat_valid = a_valid.reshape(-1)                      # [B*A]
        spec_flat = spec_a.reshape(n_flat, -1)
        patch_ids = bidx.repeat_interleave(a)
        coords_flat = coords.reshape(-1, 2)

        # ---- 3. within-patch spatial InfoNCE ---------------------------
        # Pair construction uses the DATA-validity mask: zero-padded
        # boundary regions and nodata pixels never become neighbours or
        # negatives.
        nbr_p, v_p = sp.spatial_knn_pairs(coords, pixel_mask, cfg.knn_k,
                                          cfg.knn_max_radius)
        pool, _pool_ok, sel, sel_ok = sp.spatial_negative_slots(
            coords, pixel_mask, cfg.neg_min_distance, cfg.neg_max_distance,
            cfg.neg_per_anchor, NEG_POOL_SIZE, pool_u=draws.neg_pool_u,
            pick_u=draws.neg_pick_u)
        k1 = v_p.shape[-1]
        kn = sel.shape[-1]
        k_tot = k1 + kn
        is_pos = (torch.arange(k_tot, device=device) < k1).expand(
            bsz, a, k_tot)
        # One extraction for anchors + positive neighbours + the SHARED
        # negative pool, so that one scatter-add carries the whole backward.
        nbr_p_flat = nbr_p.reshape(bsz, a * k1, 2)
        all_coords = torch.cat([coords, nbr_p_flat, pool], dim=1)
        z_all = extract_at_coords(z_type, all_coords)
        z_a = z_all[:, :a]                                    # [B, A, zt]
        d_z = z_a.shape[-1]
        z_pos = z_all[:, a:a + a * k1].reshape(bsz, a, k1, d_z)
        z_pool = z_all[:, a + a * k1:]                        # [B, P, zt]
        z_a_flat = z_a.reshape(n_flat, d_z)
        z_neg = z_pool[bidx[:, None, None], sel]              # [B, A, kn, zt]
        z_nbr = torch.cat([z_pos, z_neg], dim=2)              # [B, A, K, zt]
        # Spectral pair weights:
        #   positives: clip(exp(-d/sigma), min_w, 1)
        #   negatives: clip(1 - exp(-d/sigma), min_w, 1)
        ext_coords = torch.cat([nbr_p_flat, pool], dim=1)
        spec_ext, spec_ext_m = fb.build_feature_at_locations(
            cfg.spectral_feature, batch, ext_coords)
        spec_pos = spec_ext[:, :a * k1].reshape(bsz, a, k1, -1)
        spec_pos_ok = spec_ext_m[:, :a * k1].reshape(
            bsz, a, k1, -1).any(-1)
        spec_pool = spec_ext[:, a * k1:]                      # [B, P, C]
        spec_pool_ok = spec_ext_m[:, a * k1:].any(-1)         # [B, P]
        spec_neg = spec_pool[bidx[:, None, None], sel]
        neg_spec_ok = spec_pool_ok[bidx[:, None, None], sel]
        pv = (torch.cat([v_p & spec_pos_ok, sel_ok & neg_spec_ok], dim=2)
              & a_valid[:, :, None])
        spec_nbr = torch.cat([spec_pos, spec_neg], dim=2)
        d_spec = torch.linalg.norm(spec_a[:, :, None, :] - spec_nbr, dim=-1)
        e = torch.exp(-d_spec / cfg.spectral_sigma)
        pw = torch.clamp(torch.where(is_pos, e, 1.0 - e),
                         cfg.min_pair_weight, 1.0)

        spatial_loss, sp_aux = contrastive_loss_grouped(
            z_a_flat, z_nbr.reshape(n_flat, k_tot, d_z),
            is_pos.reshape(n_flat, k_tot),
            weights=pw.reshape(n_flat, k_tot),
            pair_valid=pv.reshape(n_flat, k_tot),
            similarity=cfg.similarity, temperature=cfg.temperature)
        metrics["loss_spatial_infonce"] = spatial_loss
        metrics["spatial_pos_sim"] = sp_aux["mean_pos_sim"]
        metrics["spatial_neg_sim"] = sp_aux["mean_neg_sim"]

        # ---- 4. VICReg on z_type anchors -------------------------------
        vcr, vcr_v, vcr_c = variance_covariance_loss(
            z_a_flat, flat_valid, cfg.vcr_std_target,
            cfg.vcr_variance_weight, cfg.vcr_covariance_weight)
        metrics["loss_vicreg_type"] = vcr
        metrics["vicreg_type_var"] = vcr_v
        metrics["vicreg_type_cov"] = vcr_c

        # ---- 5. phase pathway (phase_x built + contained in stage 2) ---
        # ysfc from the RAW group channel, NaN kept: ysfc == 0 is the
        # disturbance year, which the feature builder's masking to 0 would
        # fake.
        ysfc = sp.extract_temporal_at_locations(
            group_channel(batch, cfg.ysfc_source)[..., None],
            coords)[..., 0]                                   # [B, A, T]
        t_dim = phase_x.shape[2]
        phase_flat = phase_x.reshape(n_flat, t_dim, -1)
        ysfc_flat = ysfc.reshape(n_flat, t_dim)
        z_type_sg = z_a_flat.detach()
        # Phase anchors need a finite ysfc at EVERY timestep: a missing year
        # breaks the recovery-sequence alignment.
        phase_a_valid = a_valid & torch.isfinite(ysfc).all(-1)  # [B, A]
        phase_valid_flat = phase_a_valid.reshape(-1)
        z_phase, gamma, beta, h_pre = model.forward_phase_at_locations(
            phase_flat, z_type_sg, return_film=True, return_pre_film=True,
            deterministic=not train, draws=draws.phase)
        metrics["film_gamma_mean"] = gamma.mean()
        metrics["film_beta_mean"] = beta.mean()

        # Per-sample phase pairs; invalid phase anchors are kept out of the
        # kNN candidate lists, not only masked afterwards.
        pp, pwts, pvalid, _ = build_phase_pairs(
            spec_a, ysfc, cfg.phase_k, cfg.phase_min_overlap,
            cfg.phase_min_pairs, True, cfg.phase_sigma,
            num_ysfc_classes=cfg.num_ysfc_classes,
            valid_anchors=phase_a_valid)
        pvalid = (pvalid & torch.gather(phase_a_valid, 1, pp[..., 0])
                  & torch.gather(phase_a_valid, 1, pp[..., 1]))
        # The phase losses see the spectral features demeaned by a
        # type-local baseline, so that "phase" cannot re-learn type.
        spec_dm, _ = type_local_spectral_demean(
            z_type_sg, phase_flat, phase_valid_flat, cfg.xb_phase_pca_dim,
            cfg.xb_phase_knn_k)
        phase_batch = build_phase_neighborhood_batch(
            spec_dm.reshape(bsz, a, t_dim, -1),
            z_phase.reshape(bsz, a, t_dim, -1), ysfc, pp, pvalid,
            cfg.phase_min_overlap, cfg.num_ysfc_classes)
        ph_loss, ph_stats = phase_neighborhood_loss(
            phase_batch, pwts.reshape(-1), cfg.phase_tau_ref,
            cfg.phase_tau_learned, 2, cfg.phase_self_weight,
            cfg.phase_cross_weight)
        metrics["loss_phase_neighborhood"] = ph_loss
        metrics["phase_loss_self"] = ph_stats["loss_self"]
        metrics["phase_loss_cross"] = ph_stats["loss_cross"]
        metrics["phase_pairs_valid"] = ph_stats[
            "n_pairs_sufficient_overlap"]

        # Spread-ranking dynamism: the configured supervision feature
        # averaged over its channels, else the mean temporal std of the
        # phase features.
        if cfg.dynamism_feature:
            dyn_a, _ = fb.build_feature_at_locations(
                cfg.dynamism_feature, batch, coords)
            dyn = dyn_a.reshape(n_flat, -1).mean(-1)
        else:
            dyn = phase_flat.std(1, correction=0).mean(-1)
        spread_loss, spread_stats = compute_phase_spread_ranking(
            phase_batch, phase_batch["pair_index"], dyn, cfg.spread_margin,
            cfg.spread_delta)
        metrics["loss_phase_spread"] = spread_loss
        metrics["spread_frac_satisfied"] = spread_stats["frac_satisfied"]

        pv3 = phase_valid_flat[:, None, None]
        rd_loss, _ = phase_recovery_discrimination_loss(
            torch.where(pv3, z_phase, torch.zeros_like(z_phase)),
            torch.where(phase_valid_flat[:, None], ysfc_flat,
                        torch.full_like(ysfc_flat, float("nan"))),
            cfg.rd_margin, cfg.rd_low_ysfc_max, cfg.rd_high_ysfc_min)
        metrics["loss_recovery_disc"] = rd_loss

        pvcr, _, _ = variance_covariance_loss(
            z_phase.reshape(-1, z_phase.shape[-1]),
            phase_valid_flat.repeat_interleave(t_dim), cfg.vcr_std_target,
            cfg.vcr_variance_weight, cfg.vcr_covariance_weight)
        metrics["loss_vicreg_phase"] = pvcr

        leak = frobenius_type_leakage(h_pre, z_type_sg, phase_valid_flat)
        metrics["loss_type_leakage"] = leak

        # ---- 6. cross-batch spectral InfoNCE ---------------------------
        big = 1e6
        spec_guard = torch.where(
            flat_valid[:, None], spec_flat,
            big * (1.0 + torch.arange(n_flat, device=device)
                   )[:, None].float())
        knn_idx, knn_valid = pairs_mod.mutual_knn_grouped(
            spec_guard, cfg.xb_knn_k, patch_ids, coords_flat,
            cfg.xb_pos_min_spatial, cfg.xb_chunk_size)
        pos_valid = knn_valid & flat_valid[:, None] & flat_valid[knn_idx]
        # random cross-patch negatives
        neg_j = draws.xb_neg_j.long()
        neg_valid = (patch_ids[:, None] != patch_ids[neg_j]) \
            & flat_valid[:, None] & flat_valid[neg_j]
        d_neg = torch.linalg.norm(spec_flat[:, None, :] - spec_flat[neg_j],
                                  dim=-1)
        # mutual-kNN positives are UNWEIGHTED; negatives get
        # clip(1 - exp(-d/tau), min_w, 1)
        w_neg = torch.clamp(1.0 - torch.exp(-d_neg / cfg.xb_neg_tau),
                            cfg.xb_neg_min_weight, 1.0)
        kp = knn_idx.shape[1]
        xb_idx = torch.cat([knn_idx, neg_j], dim=1)           # [N, kp+nk]
        xb_pos = (torch.arange(xb_idx.shape[1], device=device) < kp
                  ).expand(xb_idx.shape)
        xb_v = torch.cat([pos_valid, neg_valid], dim=1)
        xb_w = torch.cat([torch.ones(knn_idx.shape, device=device), w_neg],
                         dim=1)
        xb_loss, xb_aux = contrastive_loss_grouped(
            z_a_flat, z_a_flat[xb_idx], xb_pos, weights=xb_w,
            pair_valid=xb_v, similarity=cfg.similarity,
            temperature=cfg.xb_temperature)
        metrics["loss_spectral_infonce"] = xb_loss
        metrics["spectral_pos_sim"] = xb_aux["mean_pos_sim"]
        metrics["spectral_neg_sim"] = xb_aux["mean_neg_sim"]
        metrics["spectral_n_anchors"] = xb_aux["n_anchors_used"]
        metrics["spectral_gap_over_T"] = (
            (xb_aux["mean_pos_sim"] - xb_aux["mean_neg_sim"])
            / cfg.xb_temperature)

        # ---- 7. optional EVT -------------------------------------------
        if cfg.evt_enabled:
            # codes arrive as float32; 7000+ codes are exact there
            evt_codes = sp.extract_at_locations(
                group_channel(batch, cfg.evt_feature)[..., None],
                coords)[..., 0].reshape(-1)
            tabs = evt_tables_t
            lut_len = tabs["idx_lut"].shape[0]
            rel = torch.clamp(evt_codes.int() - tabs["code_offset"], 0,
                              lut_len - 1).long()
            in_range = ((evt_codes >= tabs["code_offset"])
                        & (evt_codes < tabs["code_offset"] + lut_len))
            evt_loss, evt_stats = evt_soft_neighborhood_loss(
                z_a_flat, tabs["idx_lut"][rel],
                tabs["valid_lut"][rel] & in_range & flat_valid,
                tabs["weight_lut"][rel], tabs["similarity"],
                evt_codes.int(), cfg.evt_tau_ref, cfg.evt_tau_learned,
                cfg.evt_min_valid_anchors)
            metrics["loss_evt"] = evt_loss
            metrics["evt_anchors_valid"] = evt_stats["n_anchors_valid"]
        else:
            evt_loss = torch.zeros((), device=device)
            metrics["loss_evt"] = evt_loss

        # ---- 7b. optional diagnostics ----------------------------------
        if diag:
            with torch.no_grad():
                pos_m = pv & is_pos
                neg_m = pv & ~is_pos
                # the gate on a stride-8 grid, as the JAX step samples it
                metrics.update(dg.masked_stats(
                    gate[:, ::8, ::8, :], pixel_mask[:, ::8, ::8, None],
                    "diag_gate"))
                metrics.update(dg.masked_stats(pw, pos_m, "diag_pos_weight"))
                metrics.update(dg.masked_stats(pw, neg_m, "diag_neg_weight"))
                metrics.update(dg.masked_stats(d_spec, pos_m,
                                               "diag_pos_spec_dist"))
                metrics.update(dg.masked_stats(d_spec, neg_m,
                                               "diag_neg_spec_dist"))
                # similarities in the -||a - b||^2 / D units of the softmax
                sim_sp = -((z_a[:, :, None, :] - z_nbr) ** 2).sum(-1) / d_z
                metrics.update(dg.masked_stats(sim_sp, pos_m,
                                               "diag_pos_sim"))
                metrics.update(dg.masked_stats(sim_sp, neg_m,
                                               "diag_neg_sim"))
                sim_xb = -((z_a_flat[:, None, :] - z_a_flat[knn_idx]) ** 2
                           ).sum(-1) / d_z
                metrics.update(dg.masked_stats(sim_xb, pos_valid,
                                               "diag_spectral_pos_sim"))
                metrics.update(dg.tau_sweep_stats(
                    d_spec, pos_m, cfg.min_pair_weight, "diag_tau_pos",
                    False))
                metrics.update(dg.tau_sweep_stats(
                    d_spec, neg_m, cfg.min_pair_weight, "diag_tau_neg",
                    True))
                metrics.update(dg.tau_sweep_stats(
                    d_neg, neg_valid, cfg.min_pair_weight,
                    "diag_tau_spectral_neg", True))
                # the leakage loss's rows: phase-valid anchors
                metrics.update(dg.type_leakage_ridge(
                    h_pre.mean(1), z_type_sg, phase_valid_flat))

        # ---- 8. total ---------------------------------------------------
        total = (weights["spatial_infonce"] * spatial_loss
                 + weights["spectral_infonce"] * xb_loss
                 + weights["vicreg_type"] * vcr
                 + weights["vicreg_phase"] * pvcr
                 + weights["phase_neighborhood"] * ph_loss
                 + weights["phase_spread"] * spread_loss
                 + weights["recovery_disc"] * rd_loss
                 + weights["type_leakage"] * leak
                 + weights["evt"] * evt_loss)
        metrics["loss_total"] = total
        return total, {k: v.detach() for k, v in metrics.items()}

    # the train and eval steps hold their batches to this device
    process_batch.device = device
    return process_batch


def build_evt_tables(metric) -> Dict[str, np.ndarray]:
    """An EvtDiffusionMetric as lookup tables over the code range:
    ``similarity`` [K, K], ``idx_lut`` / ``valid_lut`` / ``weight_lut``
    [max code - min code + 1] and ``code_offset`` (the smallest code)."""
    codes = metric.codes
    off = int(codes.min())
    rng = int(codes.max()) - off + 1
    idx_lut = np.zeros(rng, np.int32)
    valid_lut = np.zeros(rng, bool)
    weight_lut = np.zeros(rng, np.float32)
    for c, i in metric.code_to_idx.items():
        idx_lut[c - off] = i
        valid_lut[c - off] = True
        weight_lut[c - off] = metric.freq_weights[i]
    return {"similarity": metric.similarity, "idx_lut": idx_lut,
            "valid_lut": valid_lut, "weight_lut": weight_lut,
            "code_offset": off}


__all__ = ["StepConfig", "StepDraws", "draw_step_randoms",
           "make_process_batch", "build_evt_tables", "DEFAULT_WEIGHTS",
           "NEG_POOL_SIZE", "frobenius_type_leakage", "wire_exact_groups"]
