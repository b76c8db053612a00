"""The port's ``eval.gmm``, ``eval.landscape_categories``,
``eval.tau_calibration`` and ``utils.log`` against the JAX package's, on
the CPU.

The JAX tests' own scenarios (``tests/test_eval_tools.py`` TestGMM and
TestLandscapeCategories, ``tests/test_scheduler_and_misc.py``
TestTauCalibration) go through both packages, and the two CLIs run end to
end on the 96 x 96 cube and JAX-written checkpoint of
``torch_parity.write_eval_fixture``. The JAX package fits with scikit-learn,
in float32 where its input is float32; the port fits in float64 on the
device from its own k-means++ start. So numpy-only code is held bit for
bit, ``phase_summary`` to 1e-6, fits by their partition up to a
permutation of labels where the optimum is unambiguous, and their scores
there: BIC to 1e-6 relative on float64 data and 1e-5 on float32 data,
silhouettes and the other floats of ``taxonomy.json`` to 1e-4.
"""
import json
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.data.samplers import ReservoirSampler as JReservoir
from forest_tpu.eval import gmm as jgmm
from forest_tpu.eval import landscape_categories as jlc
from forest_tpu.eval import tau_calibration as jtc
from forest_tpu.utils import log as jlog
from forest_tpu_torch.data.samplers import ReservoirSampler as TReservoir
from forest_tpu_torch.eval import gmm as tgmm
from forest_tpu_torch.eval import landscape_categories as tlc
from forest_tpu_torch.eval import tau_calibration as ttc
from forest_tpu_torch.eval.cluster import normalized_mutual_info_score
from forest_tpu_torch.utils import log as tlog
from torch_parity import EVAL_PATCH, write_eval_fixture

TAX_RTOL = 1e-4


def same_partition(a, b) -> bool:
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return (len(pairs) == len({p[0] for p in pairs})
            == len({p[1] for p in pairs}))


def label_map(a, b) -> dict:
    """The permutation taking labels ``a`` to labels ``b``."""
    assert same_partition(a, b)
    return {int(x): int(y) for x, y in set(zip(np.asarray(a).tolist(),
                                               np.asarray(b).tolist()))}


# --- tau_calibration and utils.log ----------------------------------------

@pytest.mark.parametrize("case", ["infonce", "entropy", "gap"])
def test_tau_calibration_equals_jax(case):
    rng = np.random.default_rng(0)
    pos = rng.normal(loc=-0.2, scale=0.05, size=200)
    neg = rng.normal(loc=-2.0, scale=0.3, size=2000)
    d = np.abs(rng.normal(size=(50, 10)))
    got, ref = [{"infonce": lambda m: m.infonce_tau_sweep(pos, neg),
                 "entropy": lambda m: m.entropy_tau_sweep(d),
                 "gap": lambda m: m.similarity_gap_report(pos, neg, 0.2)}[
                     case](m) for m in (ttc, jtc)]
    assert got == ref
    assert ttc.DEFAULT_TAUS == jtc.DEFAULT_TAUS


def test_log_matches_jax(capsys, monkeypatch):
    for m in (tlog, jlog):
        monkeypatch.setattr(m, "_stamp", lambda: "STAMP")
    outs = []
    for m in (tlog, jlog):
        m.log("a", 1)
        m.warn("b")
        m.ensure(True, "never")
        with pytest.raises(SystemExit) as e:
            m.ensure(False, "c", 2)
        assert e.value.code == 1
        with m.timeit("t"):
            pass
        outs.append(capsys.readouterr())
    assert outs[0].out.replace("0.00s", "") == outs[1].out.replace(
        "0.00s", "")
    assert outs[0].err == outs[1].err


def test_pyplot_logs_the_skipped_figure(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tlog.pyplot("fig.png") is None
    assert "skipped the figure fig.png" in capsys.readouterr().out


# --- gmm ------------------------------------------------------------------

def test_reservoir_draws_as_jax():
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(100 + 7 * i, 3)).astype(np.float32),
                rng.random(100 + 7 * i) < 0.8) for i in range(6)]
    got = tgmm.reservoir_sample_embeddings(batches, capacity=120, seed=3)
    np.testing.assert_array_equal(
        got, jgmm.reservoir_sample_embeddings(batches, capacity=120, seed=3))
    a, b = TReservoir(50, seed=5), JReservoir(50, seed=5)
    for z, _ in batches:
        a.add(z)
        b.add(z)
    np.testing.assert_array_equal(a.sample(), b.sample())
    assert a.n_seen == b.n_seen


def test_fit_gmm_clusters_matches_jax():
    """TestGMM's BIC scenario (float64): the same best k, the same
    partition and its BIC to 1e-6."""
    rng = np.random.default_rng(2)
    centers = rng.normal(scale=8.0, size=(4, 3))
    z = np.concatenate([centers[i] + rng.normal(size=(200, 3))
                        for i in range(4)])
    ref = jgmm.fit_gmm_clusters(z, n_components_range=(2, 4, 8), seed=0)
    got = tgmm.fit_gmm_clusters(z, n_components_range=(2, 4, 8), seed=0,
                                device="cpu")
    assert got["best"]["k"] == ref["best"]["k"] == 4
    assert got["n_samples"] == ref["n_samples"]
    np.testing.assert_allclose(got["best"]["bic"], ref["best"]["bic"],
                               rtol=1e-6)
    assert same_partition(got["best"]["model"].predict(z),
                          ref["best"]["model"].predict(z))


@pytest.mark.parametrize("case", ["perfect", "random", "with_negative_evt"])
def test_compare_gmm_evt_matches_jax(case):
    rng = np.random.default_rng(3)
    labels, evt = {
        "perfect": (np.repeat(np.arange(3), 50),
                    np.repeat([7001, 7002, 7003], 50)),
        "random": (rng.integers(0, 3, 300), rng.integers(0, 3, 300) + 7000),
        "with_negative_evt": (rng.integers(0, 4, 300),
                              rng.integers(-1, 3, 300) + 7000 * (
                                  rng.random(300) < 0.8))}[case]
    got, ref = tgmm.compare_gmm_evt(labels, evt), \
        jgmm.compare_gmm_evt(labels, evt)
    assert got["purity"] == ref["purity"]
    np.testing.assert_allclose(got["nmi"], ref["nmi"], rtol=0, atol=1e-10)
    for k in ("contingency", "cluster_ids", "evt_codes"):
        np.testing.assert_array_equal(got[k], ref[k])


def test_fit_landscape_categories_matches_jax():
    rng = np.random.default_rng(4)
    z_type = np.concatenate([np.zeros((100, 4)), np.ones((100, 4)) * 9]) \
        + 0.1 * rng.normal(size=(200, 4))
    z_phase = rng.normal(size=(200, 2))
    z_phase[:50] += 5
    ysfc = np.concatenate([np.full(50, 1.0), np.full(150, 20.0)])
    ref = jgmm.fit_landscape_categories(z_type, z_phase, ysfc,
                                        n_type_clusters=2)
    got = tgmm.fit_landscape_categories(z_type, z_phase, ysfc,
                                        n_type_clusters=2, device="cpu")
    perm = label_map(got["type_labels"], ref["type_labels"])
    for t, e in got["per_type"].items():
        r = ref["per_type"][perm[t]]
        assert e["n"] == r["n"]
        assert same_partition(e["phase_labels"], r["phase_labels"])
        for k in ("disturbed_centroid", "recovered_centroid"):
            if r[k] is None:
                assert e[k] is None
            else:
                np.testing.assert_array_equal(e[k], r[k])


# --- landscape_categories --------------------------------------------------

def test_phase_summary_matches_jax():
    rng = np.random.default_rng(5)
    zp = rng.normal(size=(40, 10, 4)).astype(np.float32)
    ysfc = rng.integers(0, 12, size=(40, 10)).astype(np.float32)
    ysfc[rng.random((40, 10)) < 0.3] = np.nan
    ysfc[0] = np.nan                         # nothing observed: the mean
    ref = jlc.phase_summary(jnp.asarray(zp), jnp.asarray(ysfc))
    got = tlc.phase_summary(torch.as_tensor(zp), torch.as_tensor(ysfc))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def taxonomy_data(rng):
    """TestLandscapeCategories' scenario: 3 type clusters, the third
    dynamic with two phase sub-groups."""
    zp_dim = 3
    zt = np.concatenate([c + 0.05 * rng.normal(size=(400, 4))
                         for c in (np.zeros(4), np.full(4, 6.0),
                                   np.full(4, -6.0))]).astype(np.float32)
    summary = 0.05 * rng.normal(size=(1200, 3 * zp_dim)).astype(np.float32)
    summary[800:1000] += 4.0
    summary[1000:1200] -= 4.0
    tvar = np.full(1200, 0.01, np.float32)
    tvar[800:] = 1.0
    return zt, summary, tvar, zp_dim


def assert_taxonomy_matches(got: dict, ref: dict, perm: dict) -> None:
    """taxonomy.json: integers and flags equal, floats to TAX_RTOL, the
    clusters matched through the type labels' permutation."""
    assert set(got) == set(ref)
    for key, val in got.items():
        if key == "clusters":
            assert len(val) == len(ref[key])
            for k, entry in val.items():
                r = ref[key][str(perm[int(k)])]
                assert set(entry) == set(r)
                for f, v in entry.items():
                    if isinstance(v, float):
                        np.testing.assert_allclose(v, r[f], rtol=TAX_RTOL,
                                                   err_msg=f)
                    else:
                        assert v == r[f], f
        elif key != "encoder_checkpoint":
            assert val == ref[key], key


def test_fit_taxonomy_matches_jax(tmp_path):
    """fit_taxonomy and taxonomy_json through both packages: the type
    partition, the taxonomy, the variability statistics, the artifacts
    (the pickles under the JAX pickles' keys)."""
    zt, summary, tvar, zp_dim = taxonomy_data(np.random.default_rng(6))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    ref = jlc.fit_taxonomy(zt, summary, tvar, zp_dim, [2, 3, 4],
                           min_cluster_pixels=50, seed=0,
                           out_dir=tmp_path / "j")
    got = tlc.fit_taxonomy(zt, summary, tvar, zp_dim, [2, 3, 4],
                           min_cluster_pixels=50, seed=0,
                           out_dir=tmp_path / "t", device="cpu")
    assert got["k_type"] == ref["k_type"] == 3
    np.testing.assert_allclose(got["type_scores"][3], ref["type_scores"][3],
                               rtol=TAX_RTOL)
    perm = label_map(got["type_labels"], ref["type_labels"])
    args = (0, 90, 0.25, "diag", "ckpt", len(zt))
    assert_taxonomy_matches(
        json.loads(json.dumps(tlc.taxonomy_json(got, *args))),
        json.loads(json.dumps(jlc.taxonomy_json(ref, *args))), perm)
    for k, s in got["var_stats"].items():
        for f, v in s.items():
            np.testing.assert_allclose(v, ref["var_stats"][perm[k]][f],
                                       rtol=1e-6, err_msg=f)
    for k, pl in got["phase_labels"].items():
        assert same_partition(pl, ref["phase_labels"][perm[k]])
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    dyn = [k for k, v in got["taxonomy"].items() if v["is_dynamic"]]
    assert names == sorted(p.name.replace(f"_{dyn[0]}.", f"_{perm[dyn[0]]}.")
                           for p in (tmp_path / "t").iterdir())
    for name in ("type_gmm.pkl", f"phase_gmm_{dyn[0]}.pkl"):
        with open(tmp_path / "t" / name, "rb") as f:
            mine = pickle.load(f)
        with open(tmp_path / "j" / name.replace(
                f"_{dyn[0]}.", f"_{perm[dyn[0]]}."), "rb") as f:
            theirs = pickle.load(f)
        assert set(mine) == set(theirs)
        assert type(mine["gmm"]).__module__ == "forest_tpu_torch.eval.cluster"


def test_variability_csv_and_ysfc_pass_equal_jax(tmp_path):
    """The numpy-only pieces on the same labels and models: the statistics
    and their CSV bit for bit, and the second pass's ysfc store."""
    rng = np.random.default_rng(7)
    zt, summary, tvar, zp_dim = taxonomy_data(rng)
    fit = tlc.fit_taxonomy(zt, summary, tvar, zp_dim, [3],
                           min_cluster_pixels=50, seed=0, device="cpu")
    stats = [m.variability_stats(summary, tvar, fit["type_labels"], 3,
                                 zp_dim) for m in (tlc, jlc)]
    assert stats[0] == stats[1]
    for m, name in ((tlc, "t.csv"), (jlc, "j.csv")):
        m.write_variability_csv(stats[0], fit["taxonomy"], tmp_path / name)
    assert (tmp_path / "t.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    ysfc = rng.integers(0, 30, (1200, 6)).astype(np.float32)
    ysfc[rng.random((1200, 6)) < 0.3] = np.nan
    batches = [{"z_type": zt[s:s + 500], "summary": summary[s:s + 500],
                "ysfc": ysfc[s:s + 500]} for s in range(0, 1200, 500)]
    got, ref = [m.collect_ysfc_by_phase(
        iter(batches), fit["gmm_type"], fit["phase_gmms"], fit["taxonomy"],
        max_per_group=150) for m in (tlc, jlc)]
    assert got == ref
    assert sum(got[1].values()) == 400


def test_bic_sweep_matches_jax():
    """TestLandscapeCategories' BIC scenario on float32 data: the same
    best k, its BIC to 1e-5 relative."""
    rng = np.random.default_rng(8)
    x = np.concatenate([c + rng.normal(size=(150, 3))
                        for c in (np.zeros(3), np.full(3, 10.0))]
                       ).astype(np.float32)
    kj, gj, bj = jlc.bic_sweep(x, [1, 2, 4], seed=0)
    kt, gt, bt = tlc.bic_sweep(x, [1, 2, 4], seed=0, device="cpu")
    assert kt == kj == 2 and set(bt) == set(bj)
    np.testing.assert_allclose([bt[1], bt[2]], [bj[1], bj[2]], rtol=1e-5)
    assert same_partition(gt.predict(x), gj.predict(x))


def test_figures_are_skipped_without_matplotlib(tmp_path, capsys,
                                                monkeypatch):
    """Without matplotlib every figure is skipped with a log line naming
    it; the pickles and the CSV are written all the same."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    zt, summary, tvar, zp_dim = taxonomy_data(np.random.default_rng(9))
    fit = tlc.fit_taxonomy(zt, summary, tvar, zp_dim, [3],
                           min_cluster_pixels=50, seed=0, out_dir=tmp_path,
                           device="cpu")
    tlc.plot_ysfc_by_phase({}, {}, fit["taxonomy"],
                           tmp_path / "ysfc_by_phase.png")
    out = capsys.readouterr().out
    dyn = [k for k, v in fit["taxonomy"].items() if v["is_dynamic"]]
    for fig in ("silhouette_curve_type.png", "type_variability.png",
                f"silhouette_curve_phase_{dyn[0]}.png", "ysfc_by_phase.png"):
        assert f"skipped the figure {fig}" in out, fig
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["type_gmm.pkl", f"phase_gmm_{dyn[0]}.pkl",
         "variability_summary.csv"])


# --- the CLIs on the 96 x 96 cube -----------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_eval_fixture(tmp_path_factory.mktemp("torch_gmm"))


def _argv(files):
    return ["--checkpoint", str(files["ckpt"]), "--bindings",
            str(files["bindings"]), "--patch-size", str(EVAL_PATCH),
            "--split-block-size", "1", "1", "--batch-size", "2"]


def test_stream_pixels_matches_jax(files):
    """The device-side extraction: the same valid pixels, ysfc equal, the
    float16 embeddings and summaries within one float16 rounding on top
    of the float32 models' 1e-5."""
    from forest_tpu.data.bindings import parse_bindings as jparse
    from forest_tpu.data.feature_builder import FeatureBuilder as JFB
    from forest_tpu.data.frl_dataset import ForestDatasetV2 as JDS
    from forest_tpu.eval import frozen as jfrozen
    from forest_tpu_torch.data import parse_bindings as tparse
    from forest_tpu_torch.data.feature_builder import FeatureBuilder as TFB
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2 as TDS
    from forest_tpu_torch.eval import frozen as tfrozen

    bp = str(files["bindings"])
    jb, tb = jparse(bp), tparse(bp)
    jm, jp = jfrozen.load_frozen_model(files["ckpt"])
    tm = tfrozen.load_frozen_model(files["ckpt"], "cpu")
    kw = dict(split="train", patch_size=EVAL_PATCH, split_block_size=(1, 1),
              min_aoi=0.3)
    ref = list(jlc.stream_pixels(jlc.make_extract_fn(jm, jp, JFB(jb)),
                                 JDS(jb, **kw), 2))
    got = list(tlc.stream_pixels(tlc.make_extract_fn(tm, TFB(tb)),
                                 TDS(tb, **kw), 2, device="cpu"))
    assert len(got) == len(ref) > 0
    f16 = dict(rtol=2.0 ** -10 + 1e-5, atol=1e-4)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        np.testing.assert_array_equal(g["ysfc"], r["ysfc"])
        for k in ("z_type", "summary", "tvar"):
            assert g[k].dtype == np.float32 and g[k].shape == r[k].shape
            np.testing.assert_allclose(g[k], r[k], err_msg=k, **f16)


def test_gmm_cli_matches_jax(files, tmp_path, capsys):
    """Both CLIs with the EVT column, at component counts whose optimum
    is unambiguous on these embeddings: the same best k and sample, the
    labels equal up to a permutation, the EVT codes equal."""
    argv = _argv(files) + ["--components", "3", "4", "--capacity", "5000",
                           "--evt-source", "static_categorical.evt"]
    jgmm.main(argv + ["--output", str(tmp_path / "j.npz")])
    ref = json.loads(capsys.readouterr().out)
    tgmm.main(argv + ["--output", str(tmp_path / "t.npz"), "--device",
                      "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got["best_k"] == ref["best_k"]
    assert got["n_samples"] == ref["n_samples"] == 5000
    assert set(got) == set(ref) and set(got["bic"]) == set(ref["bic"])
    for k in got["bic"]:
        np.testing.assert_allclose(got["bic"][k], ref["bic"][k], rtol=1e-4)
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert set(t.files) == set(j.files)
    np.testing.assert_array_equal(t["evt"], j["evt"])
    np.testing.assert_allclose(t["z_type"], j["z_type"], rtol=1e-5,
                               atol=1e-5)
    assert same_partition(t["labels"], j["labels"])
    np.testing.assert_allclose(got["nmi"], ref["nmi"], rtol=1e-6)
    assert got["purity"] == ref["purity"]
    assert normalized_mutual_info_score(t["labels"], j["labels"]) == 1.0


def port_pixels(files) -> np.ndarray:
    """The port CLI's first pass at its defaults: the z_type of the
    reservoir it fits."""
    from forest_tpu_torch.data import parse_bindings as tparse
    from forest_tpu_torch.data.feature_builder import FeatureBuilder as TFB
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2 as TDS
    from forest_tpu_torch.data.samplers import ReservoirSampler
    from forest_tpu_torch.eval import frozen as tfrozen

    tb = tparse(str(files["bindings"]))
    tm = tfrozen.load_frozen_model(files["ckpt"], "cpu")
    rs = ReservoirSampler(500_000, seed=42)
    for b in tlc.stream_pixels(
            tlc.make_extract_fn(tm, TFB(tb)),
            TDS(tb, split="train", patch_size=EVAL_PATCH,
                split_block_size=(1, 1), min_aoi=0.3), 2, device="cpu"):
        rs.add(b["z_type"])
    return rs.sample()


def test_landscape_cli_matches_jax(files, tmp_path):
    """Both CLIs on the train split with every cluster dynamic: the same
    pixels fit, K_type, cluster sizes and K_phase per cluster, the type
    labels equal up to a permutation (both pickled models' predictions on
    the port's pixels), the same artifacts."""
    argv = _argv(files) + ["--k-type-min", "2", "--k-type-max", "4",
                           "--k-type-step", "1", "--min-cluster-pixels",
                           "20", "--dynamic-var-threshold", "0.0"]
    jlc.main(argv + ["--output-dir", str(tmp_path / "j")])
    tlc.main(argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    ref = json.loads((tmp_path / "j" / "taxonomy.json").read_text())
    got = json.loads((tmp_path / "t" / "taxonomy.json").read_text())
    models = []
    for tag in ("t", "j"):
        with open(tmp_path / tag / "type_gmm.pkl", "rb") as f:
            models.append(pickle.load(f)["gmm"])
    z = port_pixels(files)
    labels = models[0].predict(z)
    perm = label_map(labels, models[1].predict(z))
    assert got["n_pixels_fit"] == ref["n_pixels_fit"] == len(labels) > 0
    assert got["k_type"] == ref["k_type"]
    for k, entry in got["clusters"].items():
        r = ref["clusters"][str(perm[int(k)])]
        for f in ("n_type_pixels", "k_phase", "is_dynamic",
                  "phase_gmm_skipped"):
            assert entry[f] == r[f], f
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())


MAINS = {"gmm": (tgmm.main, ["--output", "x.npz"]),
         "landscape_categories": (tlc.main, [])}


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_cli_asked_for_cuda_without_a_card_raises(files, tool):
    """The default device is ``cuda``; without a card the CLI raises before
    it reads a patch (on a machine with a card this case does not apply)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    main, extra = MAINS[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--checkpoint", str(files["ckpt"]), "--bindings",
              str(files["bindings"])] + extra)
