"""The training step of forest_tpu_torch, every loss, against the JAX step.

The tiny model of tests/frl_tiny.py (32 x 32 patches, T = 15, B = 2) with
seeded, perturbed parameters runs through ``make_process_batch`` of both
packages on the same synthetic batch, with ``DEFAULT_WEIGHTS`` (every loss
but EVT), with each phase / EVT weight alone on top of the type weights,
and with EVT and the diagnostics on. The port gets the raw random draws
that the JAX step makes, recomputed from the keys it derives (``step.py``:
rng -> (k_anchor, k_neg, k_drop); anchors from split(k_anchor, B),
negatives from split(k_neg, B), cross-batch negatives from fold_in(k_neg,
7)); the dropout draws (the encoder's, then the phase TCN's blocks) are
recorded from the ``jax.random.bernoulli`` calls of the flax modules. The
JAX step runs jitted, once per configuration.

Tolerance: float32, 1e-4 relative -- of each value for the scalars, of the
tensor's largest magnitude for the gradients (sums of ~50 anchor terms in
another order, GroupNorm variance as E[x^2] - E[x]^2 in flax), that
magnitude floored at 1e-2 of the largest gradient of the model: some exact
gradients are zero (the FiLM beta bias: every phase loss is invariant to a
common shift of z_phase; the phase head's bias under the type leakage,
which centres h), and both packages give rounding noise there.
"""
import jax
import numpy as np
import pytest
import torch

from forest_tpu.data.cube_v2 import synthetic_frl_batch
from forest_tpu_torch.models.conv2d_encoder import EncoderDraws
from forest_tpu_torch.utils.flax_bridge import params_from_flax
from torch_parity import (TINY_B as B, TINY_HW as HW, TINY_T as T,
                          build_tiny_steps as build, full_weights,
                          jax_evt_tables, jax_step,
                          tiny_step_draws as step_draws, type_weights)

REL = 1e-4
N_PARAMS = 40   # type pathway 16 (2 convs + 2 norms x 2, 5 convs x 2 of
#                 the smoothing block), phase pathway 24 (TCN 14, head 2,
#                 FiLM 8)
# The FiLM shift (beta) and the phase head's bias only shift z_phase; where
# the losses of a case are blind to that shift their exact gradient is zero,
# and both packages return rounding noise for it, well under NOISE times the
# model's largest gradient.
NOISE = 1e-6
ZERO_GRAD = ("phase_film.beta_", "phase_head.bias")


def compare(jloss, jmetrics, jgrads, tloss, tmetrics, tm):
    """Every metric key of the JAX step, the total, and the gradient of
    every parameter tensor (None in the port where JAX's is all zero),
    each held at REL of its own largest magnitude."""
    assert set(tmetrics) == set(jmetrics), \
        set(tmetrics) ^ set(jmetrics)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[name]), float(ref),
                                   rtol=REL, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=REL)
    tgrads = torch.autograd.grad(tloss, list(tm.parameters()),
                                 allow_unused=True)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    gmax = max(np.abs(r.numpy()).max() for r in ref.values())
    noise = NOISE * gmax
    checked = 0
    for (name, _), g in zip(tm.named_parameters(), tgrads):
        r = ref[name].numpy()
        if g is None:
            assert not r.any(), name
            continue
        g = g.numpy()
        if 0 < np.abs(r).max() < noise:
            # an exactly-zero gradient that JAX returns as rounding noise:
            # the port's must be noise too
            assert name.startswith(ZERO_GRAD), name
            assert np.abs(g).max() < noise, name
        else:
            np.testing.assert_allclose(g, r, rtol=REL,
                                       atol=REL * np.abs(r).max(),
                                       err_msg=name)
        checked += 1
    assert checked == N_PARAMS


def run_both(jproc, params, tproc, jsampler, batch, rng, weights, cur,
             train):
    (jloss, jmetrics), jgrads, _ = jax_step(jproc, params, batch, rng,
                                            weights, cur, train)
    tloss, tmetrics = tproc(batch, None, weights, cur, train=train,
                            draws=step_draws(rng, jsampler))
    return jloss, jmetrics, jgrads, tloss, tmetrics


@pytest.mark.parametrize("strategy,seed", [(None, 0), ("grid", 1)])
def test_process_batch_eval_matches_jax(strategy, seed):
    jproc, params, tproc, tm, jsampler = build(strategy=strategy, seed=seed)
    batch = synthetic_frl_batch(np.random.default_rng(seed), B, HW, T)
    out = run_both(jproc, params, tproc, jsampler, batch,
                   jax.random.key(seed + 5), full_weights(),
                   {"input_dropout_rate": 0.0, "min_gate": 0.1}, False)
    jmetrics = out[1]
    assert int(jmetrics["n_anchors_valid"]) > 10
    assert int(jmetrics["phase_pairs_valid"]) > 10
    compare(*out, tm)


def test_process_batch_train_matches_jax_with_injected_dropout():
    """Encoder dropout 0.25, input dropout 0.3 and phase TCN dropout 0.3,
    with flax's draws in the order the step makes them."""
    jproc, params, tproc, tm, jsampler = build(encoder_dropout=0.25,
                                               phase_dropout=0.3)
    batch = synthetic_frl_batch(np.random.default_rng(3), B, HW, T)
    rng = jax.random.key(11)
    weights = full_weights()
    cur = {"input_dropout_rate": 0.3, "min_gate": 0.0}
    (jloss, jmetrics), jgrads, draws = jax_step(jproc, params, batch, rng,
                                                weights, cur, True)
    # flax draws: the encoder's input dropout, its one layer dropout, then
    # the TCN's two blocks over the B * A phase anchors
    n = B * jsampler.n_anchors(HW, HW)
    assert [tuple(d.shape) for d in draws] == [
        (B, 1, 1, 4), (B, 1, 1, 16), (n, 1, 3), (n, 1, 12)]
    assert (draws[0] >= 0.7).any() and (draws[1] >= 0.75).any()
    assert (draws[2] >= 0.7).any() and (draws[3] >= 0.7).any()
    enc = EncoderDraws(draws[0], (draws[1],))
    assert [tuple(d.shape) for d in tm.phase_tcn.draw(n, None, "cpu")] == [
        (n, 1, 3), (n, 1, 12)]
    tloss, tmetrics = tproc(batch, None, weights, cur, train=True,
                            draws=step_draws(rng, jsampler, encoder=enc,
                                             phase=tuple(draws[2:])))
    compare(jloss, jmetrics, jgrads, tloss, tmetrics, tm)


def test_non_finite_sample_is_contained_as_in_jax():
    """A built type feature that overflows in one sample (a huge input
    divided by a tiny sd) skips that sample in both packages: its input is
    zeroed, its anchors are invalid and the loss stays finite. NaN inputs
    alone never get that far: the feature builder masks them to 0, and the
    whitened features come out finite whatever goes in."""
    def tiny_sd(stats):
        stats["type_encoder_input"]["static.elevation"]["sd"] = 1e-7

    jproc, params, tproc, tm, jsampler = build(edit_stats=tiny_sd)
    batch = synthetic_frl_batch(np.random.default_rng(4), B, HW, T)
    batch["static"][0, :, :, 0] *= 1e-7           # O(1) after the zscore
    batch["static"][1, :, :, 0] = 1e32            # inf after the zscore
    batch["annual"][0, :3, :, :, 1] = np.nan      # masked, not skipped
    rng = jax.random.key(2)
    weights = full_weights()
    cur = {"input_dropout_rate": 0.0, "min_gate": 0.0}
    (jloss, jmetrics), _, _ = jax_step(jproc, params, batch, rng, weights,
                                       cur, False, grad=False)
    tloss, tmetrics = tproc(batch, None, weights, cur, train=False,
                            draws=step_draws(rng, jsampler))
    assert int(jmetrics["samples_skipped"]) == 1
    for name in ("samples_skipped", "n_anchors_valid", "loss_total",
                 "loss_spatial_infonce", "loss_spectral_infonce",
                 "loss_phase_neighborhood", "loss_recovery_disc"):
        np.testing.assert_allclose(float(tmetrics[name]),
                                   float(jmetrics[name]), rtol=REL,
                                   err_msg=name)
    assert np.isfinite(tloss.item())


@pytest.mark.parametrize("key", ["vicreg_phase", "phase_neighborhood",
                                 "phase_spread", "recovery_disc",
                                 "type_leakage", "evt"])
def test_loss_weight_alone_matches_jax(key, tmp_path):
    """Each phase / EVT loss at weight 0.5 on top of the type weights: the
    total, every metric and every gradient as in JAX."""
    tables = jax_evt_tables(tmp_path) if key == "evt" else None
    jproc, params, tproc, tm, jsampler = build(evt_tables=tables)
    batch = synthetic_frl_batch(np.random.default_rng(6), B, HW, T)
    weights = dict(type_weights(), **{key: 0.5})
    out = run_both(jproc, params, tproc, jsampler, batch, jax.random.key(8),
                   weights, {"input_dropout_rate": 0.0, "min_gate": 0.1},
                   False)
    compare(*out, tm)


def test_evt_and_diagnostics_match_jax(tmp_path):
    """EVT on (weight 0.1) with ``diag=True``: the EVT loss, its anchor
    count and every diagnostic as in JAX."""
    tables = jax_evt_tables(tmp_path)
    jproc, params, tproc, tm, jsampler = build(evt_tables=tables, diag=True)
    batch = synthetic_frl_batch(np.random.default_rng(7), B, HW, T)
    weights = dict(full_weights(), evt=0.1)
    out = run_both(jproc, params, tproc, jsampler, batch, jax.random.key(9),
                   weights, {"input_dropout_rate": 0.0, "min_gate": 0.1},
                   False)
    jmetrics = out[1]
    assert float(jmetrics["loss_evt"]) > 0
    diag = [k for k in jmetrics if k.startswith(("diag_", "leak_"))]
    assert len(diag) == 8 * 5 + 3 * 7 * 3 + 3   # masked_stats, tau sweeps,
    #                                             leakage
    compare(*out, tm)


def test_config_builders_match_jax():
    from dataclasses import asdict

    from forest_tpu.data.bindings import parse_bindings as jparse
    from forest_tpu.data.cube_v2 import synthetic_bindings
    from forest_tpu.training.representation import config_builders as jcb
    from forest_tpu_torch.data import parse_bindings as tparse
    from forest_tpu_torch.training.representation import \
        config_builders as tcb
    raw = synthetic_bindings("/dev/null", "/dev/null")
    raw["losses"]["infonce_type_spectral"] = {"knn_k": 7, "weight": 0.5,
                                              "spectral_neg_tau": 2.0}
    raw["losses"]["variance_covariance_type"] = {"variance_target": 0.8}
    raw["losses"]["phase_spread_ranking"] = {"margin": 0.2, "delta": 0.3}
    raw["losses"]["phase_recovery_discrimination"] = {"margin": 0.7}
    raw["losses"]["evt_soft_neighborhood"] = {
        "feature": "static_categorical.evt", "tau_ref": 0.4}
    jb, tb = jparse(raw), tparse(raw)
    tcfg = {"step": {"knn_k": 6, "neg_per_anchor": 3},
            "loss_weights": {"vicreg_type": 2.0, "evt": 0.3},
            "model": {"type_encoder_feature": "type_encoder_input"}}
    assert asdict(tcb.build_step_config(tb, tcfg)) == asdict(
        jcb.build_step_config(jb, tcfg))
    assert tcb.build_step_config(tb, tcfg).evt_enabled
    assert tcb.build_loss_weights(tcfg, tb) == jcb.build_loss_weights(
        tcfg, jb)
    for cfg in ({}, {"sampling_strategy": "grid"},
                {"sampling_strategy": "absent"}):
        assert asdict(tcb.build_sampler(tb, cfg).cfg) == asdict(
            jcb.build_sampler(jb, cfg).cfg)


def test_draws_from_a_generator_are_reproducible():
    _, _, tproc, tm, _ = build(phase_dropout=0.2)
    batch = synthetic_frl_batch(np.random.default_rng(0), B, HW, T)
    cur = {"input_dropout_rate": 0.2, "min_gate": 0.0}
    out = [tproc(batch, torch.Generator().manual_seed(s), full_weights(),
                 cur)[0].item() for s in (7, 7, 8)]
    assert out[0] == out[1] and out[0] != out[2]
    assert np.isfinite(out).all()
