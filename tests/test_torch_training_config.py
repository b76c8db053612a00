"""The port's training config, curricula, epoch log and profiling hooks
against the JAX package's.

- ``parse_training_config`` on ``configs/frl_training_v1.yaml`` and on the
  dict of ``tests/test_train_representation_e2e.py``: the same
  ``dataclasses.asdict``, ``as_builder_dict()`` and ``summary()``;
- every curriculum function and ``build_curricula`` over epochs 0-80 of the
  v1 curricula (and the other input-dropout schedules), exactly;
- ``format_epoch_block`` and ``checkpoint_metrics`` on the same dicts,
  character for character;
- ``profiling.maybe_trace`` writes a Chrome trace of the block when on.
"""
import dataclasses
import json
import warnings
from pathlib import Path

import pytest

from forest_tpu.data.bindings import parse_bindings as jparse
from forest_tpu.data.cube_v2 import synthetic_bindings
from forest_tpu.training.representation import config_builders as jcb
from forest_tpu.training.representation import curriculum as jcur
from forest_tpu.training.representation import epoch_logging as jlog
from forest_tpu.training.representation import training_config as jtc
from forest_tpu_torch.data import parse_bindings as tparse
from forest_tpu_torch.training.representation import config_builders as tcb
from forest_tpu_torch.training.representation import curriculum as tcur
from forest_tpu_torch.training.representation import epoch_logging as tlog
from forest_tpu_torch.training.representation import profiling
from forest_tpu_torch.training.representation import training_config as ttc

ROOT = Path(__file__).resolve().parents[1]
V1 = ROOT / "configs" / "frl_training_v1.yaml"
E2E = {
    "name": "synthetic_e2e",
    "run": {"experiment_name": "exp0", "run_root": "runs",
            "checkpoint": {"save_top_k": 1, "save_every_n_epochs": 1}},
    "training": {"epoch": {"num_epochs": 2, "mode": "full",
                           "batch_size": 4}},
    "optimizer": {"lr": 1e-3},
    "scheduler": {"warmup_epochs": 0, "phase_rewarmup": False},
    "spatial_domain": {"patch_size": 32, "split_block_size": [1, 1]},
    "curriculum": {"input_dropout": 0.05, "smoothing_freeze_until": 1,
                   "smoothing_ramp_epochs": 1, "phase_start_epoch": 0,
                   "phase_ramp_epochs": 1},
    "hardware": {"num_workers": 2},
}
# the original project's placements: the smoothing curriculum in its own
# section, mixed precision, the model-input keys under model
ORIGINAL = {
    "spatial_smoothing_curriculum": {"enabled": True,
                                     "freeze_until_epoch": 7,
                                     "ramp_epochs": 3},
    "hardware": {"mixed_precision": {"enabled": True}},
    "model": {"type_encoder_feature": "type_encoder_input"},
    "training": {"gradient_clip": {"max_norm": 0.5}, "diagnostics": False,
                 "validation": {"val_every_n_epochs": 2},
                 "early_stopping": {"enabled": True, "patience": 3}},
}


@pytest.mark.parametrize("source", [V1, E2E, ORIGINAL],
                         ids=["frl_training_v1.yaml", "e2e", "original"])
def test_parse_training_config_matches_jax(source):
    j, t = jtc.parse_training_config(source), ttc.parse_training_config(
        source)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.as_builder_dict() == j.as_builder_dict()
    assert t.summary() == j.summary()
    assert t.run.experiment_dir == j.run.experiment_dir


@pytest.mark.parametrize("bad", [
    {"training": {"epoch": {"batch_size": 0}}},
    {"training": {"epoch": {"mode": "most"}}},
    {"optimizer": {"lr": 0.0}}])
def test_invalid_config_raises(bad):
    with pytest.raises(ValueError, match="do not hold"):
        ttc.parse_training_config(bad)


V1_CUR = ttc.parse_training_config(V1).curriculum
EPOCHS = range(81)


@pytest.mark.parametrize("schedule", [
    V1_CUR["input_dropout"], 0.05, {"schedule": "constant", "rate": 0.2},
    {"schedule": "cosine", "start": 0.1, "end": 0.0, "epochs": 30},
    {"schedule": "linear"}])
def test_input_dropout_rate_matches_jax(schedule):
    for e in EPOCHS:
        assert tcur.compute_input_dropout_rate(schedule, e, 400) == \
            jcur.compute_input_dropout_rate(schedule, e, 400), e


def test_ramp_and_min_gate_match_jax():
    for e in EPOCHS:
        assert tcur.ramp_weight(e, V1_CUR["phase_start_epoch"],
                                V1_CUR["phase_ramp_epochs"]) == \
            jcur.ramp_weight(e, V1_CUR["phase_start_epoch"],
                             V1_CUR["phase_ramp_epochs"])
        assert tcur.compute_smoothing_min_gate(
            e, V1_CUR["smoothing_freeze_until"],
            V1_CUR["smoothing_ramp_epochs"]) == \
            jcur.compute_smoothing_min_gate(
                e, V1_CUR["smoothing_freeze_until"],
                V1_CUR["smoothing_ramp_epochs"])
    with pytest.raises(ValueError, match="schedule"):
        tcur.compute_input_dropout_rate({"schedule": "step"}, 0, 10)


def _bindings_with_phase_curricula(divergent: bool):
    raw = synthetic_bindings("/dev/null", "/dev/null")
    raw["losses"]["phase_neighborhood"]["curriculum"] = {
        "start_epoch": 12, "ramp_epochs": 6}
    raw["losses"]["phase_spread_ranking"] = {
        "curriculum": {"start_epoch": 9 if divergent else 12,
                       "ramp_epochs": 4 if divergent else 6}}
    return raw


@pytest.mark.parametrize("training", [V1, E2E, {}],
                         ids=["v1", "e2e", "empty"])
@pytest.mark.parametrize("bindings", ["synthetic", "blocks", "divergent"])
def test_build_curricula_matches_jax(training, bindings):
    raw = (synthetic_bindings("/dev/null", "/dev/null")
           if bindings == "synthetic"
           else _bindings_with_phase_curricula(bindings == "divergent"))
    builder = ttc.parse_training_config(training).as_builder_dict()
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jcb.build_curricula(builder, jparse(raw))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tcb.build_curricula(builder, tparse(raw))
    assert got == want
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert tcb.build_curricula(builder) == jcb.build_curricula(builder)


def _metrics(seed: int, diag: bool):
    import numpy as np
    rng = np.random.default_rng(seed)
    keys = ["loss_total", "loss_spatial_infonce", "loss_evt", "gate_mean",
            "grad_norm", "skipped", "phase_pairs_valid", "n_anchors_valid",
            "spatial_pos_sim", "n_steps", "epoch_time_s", "wait_s",
            "step_s", "custom_metric", "tiny"]
    m = {k: float(rng.normal()) for k in keys}
    m["tiny"] = 3e-5
    m["n_steps"] = 2
    if diag:
        for p in ("diag_gate", "diag_pos_weight", "diag_spectral_pos_sim"):
            for s in ("mean", "std", "p05", "p50", "p95"):
                m[f"{p}_{s}"] = float(rng.random())
        for t in (0.5, 1.0, 2.0):
            for s in ("mean", "q25", "q50"):
                m[f"diag_tau_pos_{t:g}_{s}"] = float(rng.random())
        m.update(leak_r2_mean=0.1, leak_r2_max=0.3, leak_cross_cov_frob=2.5)
    return m


@pytest.mark.parametrize("epoch", [0, 3])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("with_val", [False, True])
def test_epoch_block_and_checkpoint_metrics_match_jax(epoch, diag,
                                                      with_val):
    train = _metrics(epoch, diag)
    val = _metrics(epoch + 10, False) if with_val else None
    for lr in (None, 3.2e-5):
        assert tlog.format_epoch_block(epoch, train, val, lr) == \
            jlog.format_epoch_block(epoch, train, val, lr)
    assert tlog.checkpoint_metrics(train, val) == \
        jlog.checkpoint_metrics(train, val)


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    import torch
    out = tmp_path / "trace"
    try:
        with profiling.maybe_trace(str(out)):   # profiling off: no trace
            torch.ones(3).sum()
        assert not out.exists()
        profiling.set_profile(True)
        assert profiling.is_profiling()
        with profiling.maybe_trace(str(out)):
            torch.ones(3).sum()
    finally:
        profiling.set_profile(False)
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)
    summary = profiling.print_device_summary()
    if not torch.cuda.is_available():
        assert summary == "cuda: none"
