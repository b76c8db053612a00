"""The port's phase diagnostics against the JAX package's, on the CPU.

``collect_phase_samples(_full)`` of ``forest_tpu_torch.eval.
phase_diagnostics`` and ``forest_tpu.eval.phase_diagnostics`` on one tiny
float32 checkpoint over the 96 x 96 synthetic cube
(``torch_parity.write_eval_fixture``): the embeddings within rtol / atol
1e-5 (serving's bound: XLA's reordered sums on the JAX side), the data
gathers equal. The reports are the JAX package's numpy code, so on the same
seeded inputs every CSV cell agrees (floats within 1e-9) and the JSON
summaries are equal. Both CLIs with ``--probe`` write the same files.
"""
import json
import sys

import numpy as np
import pytest
import torch

from forest_tpu.data.bindings import parse_bindings as jparse
from forest_tpu.data.feature_builder import FeatureBuilder as JFB
from forest_tpu.data.frl_dataset import ForestDatasetV2 as JDS
from forest_tpu.eval import frozen as jfrozen
from forest_tpu.eval import phase_diagnostics as jpd
from forest_tpu_torch.data import parse_bindings as tparse
from forest_tpu_torch.data.feature_builder import FeatureBuilder as TFB
from forest_tpu_torch.data.frl_dataset import ForestDatasetV2 as TDS
from forest_tpu_torch.eval import frozen as tfrozen
from forest_tpu_torch.eval import phase_diagnostics as tpd
from torch_parity import EVAL_PATCH, read_csv, write_eval_fixture

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_eval_fixture(tmp_path_factory.mktemp("torch_phase_diag"))


def _closures(files):
    bp = str(files["bindings"])
    jfb, tfb = JFB(jparse(bp)), TFB(tparse(bp))
    jm, jp = jfrozen.load_frozen_model(files["ckpt"])
    tm = tfrozen.load_frozen_model(files["ckpt"], "cpu")
    jds = JDS(jfb.bindings, split=None, patch_size=EVAL_PATCH)
    tds = TDS(tfb.bindings, split=None, patch_size=EVAL_PATCH)
    return ((jfrozen.make_encode_fns(jm, jp, jfb)[0],
             jfrozen.make_encode_phase_film(jm, jp, jfb), jfb, jds),
            (tfrozen.make_encode_fns(tm, tfb)[0],
             tfrozen.make_encode_phase_film(tm, tfb), tfb, tds))


@pytest.mark.parametrize("full", [False, True])
def test_collect_phase_samples_match_jax(files, full):
    """Three patches of 32, anchors every 4 pixels inside a border of 2:
    z_phase, gamma, z_type and the target within 1e-5, ysfc and EVT equal
    (the target's masked entries NaN on both sides)."""
    jargs, targs = _closures(files)
    src = ("static_categorical.evt", "annual.ysfc")
    if full:
        ref = jpd.collect_phase_samples_full(*jargs, *src, "phase_target",
                                             n_patches=3)
        got = tpd.collect_phase_samples_full(*targs, *src, "phase_target",
                                             n_patches=3, device="cpu")
    else:
        keys = ("z_phase", "gamma", "ysfc", "evt")
        ref = dict(zip(keys, jpd.collect_phase_samples(*jargs, *src,
                                                       n_patches=3)))
        got = dict(zip(keys, tpd.collect_phase_samples(
            *targs, *src, n_patches=3, device="cpu")))
    assert set(got) == set(ref)
    assert got["z_phase"].shape == (3 * 49, 15, 3)
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].shape == r.shape, k
        if k in ("ysfc", "evt"):
            np.testing.assert_array_equal(got[k], r, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], r, err_msg=k, **TOL)
    if full:
        assert np.isnan(got["target"]).any() and np.isfinite(
            got["target"]).any()


def _report_inputs(seed=3):
    """Seeded pixel-level embeddings over four EVT codes (a NaN code
    among them) and (pixel x timestep)-level probe rows with masked
    targets."""
    rng = np.random.default_rng(seed)
    n, t, zp, c = 400, 15, 3, 2
    evt = rng.choice([7001.0, 7002.0, 7003.0, 7010.0], n,
                     p=[0.4, 0.3, 0.2, 0.1])
    evt[:5] = np.nan
    z = rng.normal(size=(n, t, zp)).astype(np.float32)
    gamma = (1 + 0.3 * rng.normal(size=(n, zp))).astype(np.float32)
    ysfc = rng.integers(0, 35, (n, t)).astype(np.float32)
    ysfc[rng.random((n, t)) < 0.05] = np.nan
    target = rng.normal(size=(n * t, c)).astype(np.float32)
    target[rng.random((n * t, c)) < 0.1] = np.nan
    pred = target + 0.5 * rng.normal(size=(n * t, c))
    pred[np.isnan(pred)] = rng.normal(size=np.isnan(pred).sum())
    return {"z": z, "gamma": gamma, "evt": evt, "ysfc": ysfc,
            "target": target, "pred": pred, "names": ["ysfc", "nbr"]}


def _run_report(mod, name, d, out):
    t = d["ysfc"].shape[1]
    evt_t = np.repeat(d["evt"], t)
    if name == "evt_phase":
        return mod.evt_phase_report(
            d["z"], d["gamma"], d["evt"], out, top_k=3,
            evt_names={7001: "Forest A", 7002: "Shrub"},
            probe_pred=d["pred"], probe_target=d["target"],
            probe_evt=evt_t, target_names=d["names"])
    if name == "recovery":
        return mod.recovery_report(evt_t, d["ysfc"].ravel(),
                                   d["pred"][:, 1], d["target"][:, 1], out,
                                   top_k=3)
    if name == "ysfc":
        return mod.ysfc_report(evt_t, d["ysfc"].ravel(), out, top_k=3)
    rng = np.random.default_rng(5)
    for part, labels in (("a", ["7001", "7002", "7010"]),
                         ("b", ["7002", "7003"])):
        with open(out / f"{part}.csv", "w") as f:
            f.write("," + ",".join(labels) + "\n")
            for r in labels:
                f.write(r + "," + ",".join(
                    str(v) for v in rng.integers(0, 50, len(labels)))
                        + "\n")
    return mod.combine_evt_contingency_tables(out / "a.csv", out / "b.csv",
                                              out / "combined.csv")


def _same_csv(got, ref):
    gcols, grows = read_csv(got)
    rcols, rrows = read_csv(ref)
    assert gcols == rcols and len(grows) == len(rrows) > 0, got.name
    for g, r in zip(grows, rrows):
        for k in rcols:
            try:
                rv = float(r[k])
            except ValueError:
                assert g[k] == r[k], (got.name, k)
                continue
            np.testing.assert_allclose(float(g[k]), rv, rtol=1e-9,
                                       atol=1e-9, err_msg=f"{got.name} {k}")


@pytest.mark.parametrize("name", ["evt_phase", "recovery", "ysfc",
                                  "combine"])
def test_reports_equal_jax(tmp_path, name):
    """Each report family on the same seeded inputs: the same files, every
    CSV cell equal (floats within 1e-9), summary.json equal."""
    d = _report_inputs()
    outs = {}
    for tag, mod in (("j", jpd), ("t", tpd)):
        (tmp_path / tag).mkdir()
        outs[tag] = _run_report(mod, name, d, tmp_path / tag)
    if name == "evt_phase":
        assert outs["t"] == outs["j"]
        assert outs["t"]["n_evt_classes"] == 4
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    for fn in names:
        if fn.endswith(".csv"):
            _same_csv(tmp_path / "t" / fn, tmp_path / "j" / fn)
        elif fn.endswith(".json"):
            assert json.loads((tmp_path / "t" / fn).read_text()) == \
                json.loads((tmp_path / "j" / fn).read_text())


def test_reports_without_matplotlib_write_every_table(tmp_path, capsys,
                                                      monkeypatch):
    """Where matplotlib does not import, every figure is skipped with a
    log line naming it and no figure is written; the CSVs and
    summary.json are written all the same."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    d = _report_inputs()
    for name in ("evt_phase", "recovery", "ysfc"):
        _run_report(tpd, name, d, tmp_path)
    tpd.phase_evt_diagnostics(d["z"], d["gamma"], d["evt"],
                              tmp_path / "phase_evt.png")
    tpd.phase_recovery_curves(d["z"], d["ysfc"], d["evt"],
                              tmp_path / "recovery_compact.png")
    tpd.ysfc_evt_histograms(d["ysfc"], d["evt"], tmp_path / "ysfc_compact.png")
    out = capsys.readouterr().out
    for fig in ("gamma_heatmap.png", "temporal_frac_heatmap.png",
                "gamma_ranking.png", "probe_r2_heatmap.png",
                "recovery_curves.png", "ysfc_histograms.png",
                "phase_evt.png", "recovery_compact.png", "ysfc_compact.png"):
        assert f"skipped the figure {fig}" in out, fig
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["gamma_by_evt.csv", "temporal_frac_by_evt.csv",
         "probe_r2_by_evt.csv", "summary.json", "nbr_by_ysfc_by_evt.csv",
         "ysfc_by_evt.csv"])


def test_cli_with_probe_matches_jax(files, tmp_path, capsys):
    """Both CLIs with ``--probe`` on every patch of 32 (the probe fit on 2
    batches): the same CSV, JSON and figure files, the same summary counts,
    the per-EVT gamma means within 1e-5."""
    argv = ["--checkpoint", str(files["ckpt"]), "--bindings",
            str(files["bindings"]), "--patch-size", str(EVAL_PATCH),
            "--split-block-size", "1", "1", "--n-patches", "4", "--probe",
            "--probe-max-batches", "2"]
    jpd.main(argv + ["--out", str(tmp_path / "j")])
    tpd.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert capsys.readouterr().out.count("diagnostic artifacts") == 2
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    assert {"probe_r2_by_evt.csv", "nbr_by_ysfc_by_evt.csv",
            "ysfc_by_evt.csv", "summary.json"} <= set(names)
    js, ts = (json.loads((tmp_path / k / "summary.json").read_text())
              for k in ("j", "t"))
    for k in ("n_evt_classes", "n_pixels_total", "d_phase",
              "top_evt_codes"):
        assert ts[k] == js[k], k
    _, jr = read_csv(tmp_path / "j" / "gamma_by_evt.csv")
    _, tr = read_csv(tmp_path / "t" / "gamma_by_evt.csv")
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(float(a["gamma_mean_agg"]),
                                   float(b["gamma_mean_agg"]), **TOL)


def test_cli_asked_for_cuda_without_a_card_raises(files):
    """The default device is ``cuda``; without a card the CLI raises before
    it reads a patch (on a machine with a card this case does not apply)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpd.main(["--checkpoint", str(files["ckpt"]), "--bindings",
                  str(files["bindings"]), "--out", "x"])
