"""The port's figure sheets against the JAX package's, on the CPU.

``forest_tpu_torch.eval.visualize`` and ``forest_tpu.eval.visualize`` on
one tiny float32 checkpoint over the 96 x 96 synthetic cube
(``torch_parity.write_eval_fixture``): the records behind the sheets from
the same probe weights within rtol / atol 1e-5 (serving's bound: XLA's
reordered sums on the JAX side), the gate forward within the same bound,
the host numpy (patch ranking, PCA colours) equal. The CLI draws its
figures here, where matplotlib imports, and writes none but exits where it
does not.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.data.bindings import parse_bindings as jparse
from forest_tpu.data.feature_builder import FeatureBuilder as JFB
from forest_tpu.data.frl_dataset import ForestDatasetV2 as JDS
from forest_tpu.eval import frozen as jfrozen
from forest_tpu.eval import phase_probe as jpp
from forest_tpu.eval import visualize as jvis
from forest_tpu_torch.data import parse_bindings as tparse
from forest_tpu_torch.data.feature_builder import FeatureBuilder as TFB
from forest_tpu_torch.data.frl_dataset import ForestDatasetV2 as TDS
from forest_tpu_torch.eval import frozen as tfrozen
from forest_tpu_torch.eval import phase_probe as tpp
from forest_tpu_torch.eval import visualize as tvis
from torch_parity import EVAL_PATCH, write_eval_fixture

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_eval_fixture(tmp_path_factory.mktemp("torch_visualize"))


@pytest.fixture(scope="module")
def env(files):
    """Both packages' models, feature builders and test splits (blocks of
    one patch: 2 test patches of 32)."""
    bp = str(files["bindings"])
    jfb, tfb = JFB(jparse(bp)), TFB(tparse(bp))
    jm, jp = jfrozen.load_frozen_model(files["ckpt"])
    tm = tfrozen.load_frozen_model(files["ckpt"], "cpu")
    kw = dict(split="test", patch_size=EVAL_PATCH, split_block_size=(1, 1))
    return {"j": (jm, jp, jfb, JDS(jfb.bindings, **kw)),
            "t": (tm, tfb, TDS(tfb.bindings, **kw))}


def _same_records(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray) and v.dtype == bool:
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            elif isinstance(v, np.ndarray):
                assert g[k].shape == v.shape, k
                np.testing.assert_allclose(g[k], v, err_msg=k, **TOL)
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("probe", [False, True])
def test_collect_patch_records_match_jax(env, probe):
    """Original-scale targets (the spectral feature through its inverse
    normalisation) and, with seeded probe weights, the predictions."""
    jm, jp, jfb, jds = env["j"]
    tm, tfb, tds = env["t"]
    feat = "infonce_type_spectral"
    c = len(tfb.bindings.get_feature(feat).channels)
    w = (np.random.default_rng(4).normal(scale=0.3, size=(9, c))
         if probe else None)
    ref = jvis.collect_patch_records(jfrozen.make_encode_fns(jm, jp, jfb)[0],
                                     jfb, jds, feat, w, n_patches=2)
    got = tvis.collect_patch_records(tfrozen.make_encode_fns(tm, tfb)[0],
                                     tfb, tds, feat, w, n_patches=2,
                                     device="cpu")
    _same_records(got, ref)
    assert ("pred_" + next(iter(tfb.bindings.get_feature(feat).channels))
            in got[0]) == probe


def test_collect_forest_diag_records_match_jax(env):
    """Every pixel of two patches through the phase pathway and a seeded
    phase probe (``full`` design, interaction PCA to 4) against the
    temporal target, back to the original scale: observed and predicted
    [T, H, W] maps within 1e-5, the masks and ysfc_min equal."""
    jm, jp, jfb, jds = env["j"]
    tm, tfb, tds = env["t"]
    rng = np.random.default_rng(6)
    d_raw, d_int, k = 8 + 3 + 24, 24, 4
    args = ("full", 8, 3, rng.normal(scale=0.2, size=d_raw),
            0.5 + rng.random(d_raw),
            np.linalg.qr(rng.normal(size=(d_int, k)))[0])
    w = rng.normal(scale=0.05, size=(8 + 3 + k + 1, 2))
    ref = jvis.collect_forest_diag_records(
        jfrozen.make_encode_fns(jm, jp, jfb)[0],
        jfrozen.make_encode_fns(jm, jp, jfb)[1], jfb, jds, [1, 0], w,
        jpp.PhaseProbePreprocessor(*args), "phase_target")
    tfns = tfrozen.make_encode_fns(tm, tfb)
    got = tvis.collect_forest_diag_records(
        tfns[0], tfns[1], tfb, tds, [1, 0], w,
        tpp.PhaseProbePreprocessor(*args), "phase_target", device="cpu")
    _same_records(got, ref)
    assert got[0]["target_annual.nbr"].shape == (15, EVAL_PATCH, EVAL_PATCH)


def test_gate_forward_matches_flax(env):
    """``make_encode_gate`` against ``model.apply(..., return_gate=True)``:
    z_type and the gate within 1e-5."""
    jm, jp, jfb, jds = env["j"]
    tm, tfb, tds = env["t"]
    host = jds.load_batch([0, 1])
    x, _ = jfb.build_feature("type_encoder_input",
                             {k: jnp.asarray(v) for k, v in host.items()})
    ref = jm.apply({"params": jp}, x, return_gate=True)
    got = tvis.make_encode_gate(tm, tfb)(tfrozen.batch_to_device(host,
                                                                 "cpu"))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape) == (2, EVAL_PATCH,
                                                    EVAL_PATCH, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_patch_ranking_and_pca_colours_equal_jax(files):
    """The host numpy: ``rank_patches_by_ysfc`` over every patch and
    ``_pca_rgb`` of a seeded embedding, equal."""
    bp = str(files["bindings"])
    jds = JDS(jparse(bp), split=None, patch_size=EVAL_PATCH)
    tds = TDS(tparse(bp), split=None, patch_size=EVAL_PATCH)
    ranked = tvis.rank_patches_by_ysfc(tds, threshold=12.0)
    assert ranked == jvis.rank_patches_by_ysfc(jds, threshold=12.0)
    assert len(ranked) == 9 and ranked[0][1] > 0
    z = np.random.default_rng(7).normal(size=(20, 24, 8)).astype(np.float32)
    np.testing.assert_array_equal(tvis._pca_rgb(z), jvis._pca_rgb(z))


@pytest.mark.parametrize("fn", ["plot_variable_timeseries",
                                "plot_variable_anomaly"])
def test_temporal_channel_sheets(files, tmp_path, capsys, monkeypatch, fn):
    """One temporal channel of one patch, built on the host: the values
    equal the JAX package's within 1e-5 (float32 features); the sheet is
    drawn where matplotlib imports and skipped, with a log line, where it
    does not."""
    bp = str(files["bindings"])
    tfb, jfb = TFB(tparse(bp)), JFB(jparse(bp))
    kw = dict(split=None, patch_size=EVAL_PATCH)
    tds, jds = TDS(tfb.bindings, **kw), JDS(jfb.bindings, **kw)
    args = ("phase_target", "annual.nbr", 3)
    for g, r in zip(tvis._load_temporal_channel(tfb, tds, *args),
                    jvis._load_temporal_channel(jfb, jds, *args)):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    name = ("timeseries" if fn.endswith("timeseries") else "anomaly") + \
        "_annual_nbr.png"
    assert getattr(tvis, fn)(tfb, tds, "phase_target", "annual.nbr",
                             tmp_path, patch_idx=3) == [tmp_path / name]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert getattr(tvis, fn)(tfb, tds, "phase_target", "annual.nbr",
                             tmp_path / "none", patch_idx=3) == []
    assert f"skipped the figure {name}" in capsys.readouterr().out


def _argv(files, out):
    return ["--checkpoint", str(files["ckpt"]), "--bindings",
            str(files["bindings"]), "--out", str(out), "--patch-size",
            str(EVAL_PATCH), "--split-block-size", "1", "1", "--n", "2",
            "--probe", "--forest-diag", "--device", "cpu"]


FIGURES = ["test_patch_000.png", "test_patch_001.png", "diagnostics_000.png",
           "diagnostics_001.png", "gate_channels.png", "ysfc_map.png",
           "forest_diag_ysfc_min.png"]


def test_cli_writes_the_figures(files, tmp_path, capsys):
    """``--probe --forest-diag`` on the 2 test patches: every figure family
    of the JAX CLI's inventory."""
    tvis.main(_argv(files, tmp_path))
    out = capsys.readouterr().out
    assert "probe r2 (val):" in out
    names = {p.name for p in tmp_path.iterdir()}
    assert set(FIGURES) <= names
    for ch in ("annual_ysfc", "annual_nbr"):
        assert {f"forest_diag_{ch}.png",
                f"forest_diag_{ch}_anomaly.png"} <= names
    assert any(n.startswith("sheet_") for n in names)
    assert f"wrote {len(names)} figures" in out


def test_cli_without_matplotlib_writes_no_figure(files, tmp_path, capsys,
                                                 monkeypatch):
    """Where matplotlib does not import, the same run logs each figure it
    skipped, writes none, and returns."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tvis.main(_argv(files, tmp_path))
    out = capsys.readouterr().out
    for fig in FIGURES + ["forest_diag_annual_nbr_anomaly.png"]:
        assert f"skipped the figure {fig}" in out, fig
    assert "wrote 0 figures" in out
    assert not list(tmp_path.glob("*.png"))


def test_cli_asked_for_cuda_without_a_card_raises(files):
    """The default device is ``cuda``; without a card the CLI raises before
    it reads a patch (on a machine with a card this case does not apply)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.main(["--checkpoint", str(files["ckpt"]), "--bindings",
                   str(files["bindings"]), "--out", "x"])
