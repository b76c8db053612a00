"""The port's ``eval.fia`` against the JAX package's, on the CPU.

``tests/test_fia.py``'s scenarios go through both packages. The numpy and
scipy estimators are copies and are held bit for bit. The kNN models run
on the port's own neighbours (to 1e-10), HDBSCAN and k-means on its own
estimators: their partitions are held up to a permutation of labels, the
variances and efficiencies built on them to 1e-6 relative, the CLI's JSON
for all four analyses equal in its keys and integers and to 1e-6 relative
in its floats.
"""
import csv
import json
import sys

import numpy as np
import pytest
import torch
from sklearn.mixture import GaussianMixture as SkGMM

from forest_tpu.eval import fia as jfia
from forest_tpu_torch.eval import fia as tfia
from forest_tpu_torch.eval.cluster import GaussianMixture

REL = 1e-6


def assert_same(got, ref, rtol=0.0, path="out"):
    """Recursive equality: keys, lengths and integers exactly, floats to
    ``rtol`` (0: bit for bit)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            assert_same(got[k], ref[k], rtol, f"{path}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, rtol, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray) and ref.dtype.kind == "f":
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0, err_msg=path)
    elif isinstance(ref, (float, np.floating)):
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0, err_msg=path)
    else:
        assert np.array_equal(np.asarray(got), np.asarray(ref)), path


def same_partition(a, b) -> bool:
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return (len(pairs) == len({p[0] for p in pairs})
            == len({p[1] for p in pairs}))


def _evt_data(rng, n=600):
    evt = rng.choice([7001, 7002, 7003, 7004], n)
    base = {7001: 0.0, 7002: 0.6, 7003: 8.0, 7004: 8.6, 7005: 8.3}
    z = np.asarray([base[e] for e in evt])[:, None] \
        + rng.normal(0, 0.2, (n, 3))
    evt = np.concatenate([evt, [7005] * 5])
    z = np.concatenate([z, 8.3 + rng.normal(0, 0.2, (5, 3))])
    return z.astype(np.float32), evt


def _hier_data(rng, n=900):
    t = rng.integers(0, 3, n)
    z_type = rng.normal(0, 0.3, (n, 4)) + t[:, None] * 5.0
    phase_group = rng.integers(0, 2, n)
    z_phase = rng.normal(0, 0.3, (n, 3))
    z_phase[t == 2] += (phase_group[t == 2] * 6.0)[:, None]
    y = t * 10.0 + np.where(t == 2, phase_group * 20.0, 0.0) \
        + rng.normal(0, 1.0, n)
    return z_type, z_phase, y


def _numpy_case(name, rng):
    """-> (function name, args, kwargs) of a numpy-only scenario."""
    y = rng.normal(10, 2, 100)
    two = np.concatenate([rng.normal(0, 1, 200), rng.normal(50, 1, 200)])
    skew = np.concatenate([np.zeros(800), rng.exponential(5, 200)])
    x4 = rng.normal(size=(300, 4))
    return {
        "post_stratified": ("post_stratified_estimate",
                            (two, np.repeat([0, 1], 200), {0: 0.3, 1: 0.7})),
        "post_stratified_missing": ("post_stratified_estimate",
                                    (y[:30], np.zeros(30, int),
                                     {0: 0.5, 7: 0.5})),
        "post_stratified_singleton": ("post_stratified_estimate",
                                      (np.asarray([1.0, 2.0, 3.0, 9.0]),
                                       np.asarray([0, 0, 0, 1]),
                                       {0: 0.75, 1: 0.25})),
        "simple_random": ("simple_random_estimate", (y,)),
        "relative_efficiency": ("relative_efficiency",
                                (two, np.repeat([0, 1], 200),
                                 {0: 0.5, 1: 0.5})),
        "ward": ("ward_cluster", (np.concatenate(
            [rng.normal(0, 0.2, (50, 3)), rng.normal(8, 0.2, (50, 3))]), 3)),
        "dh_skewed": ("dh_strata", (skew, 4)),
        "dh_constant": ("dh_strata", (np.ones(10), 4)),
        "pooled_within": ("pooled_within_variance",
                          (skew, rng.integers(0, 3, 1000),
                           rng.integers(0, 2, 1000))),
        "aggregate_bins": ("aggregate_bins_by_target",
                           (np.repeat([0, 1, 2, 3], 25),
                            np.repeat([0.0, 0.1, 10.0, 10.1], 25)
                            + rng.normal(0, 0.01, 100), 2)),
        "oof_scores": ("oof_linear_scores",
                       (x4, x4 @ np.array([1.0, -2.0, 0.5, 0.0]) + 3)),
        "hierarchical": ("hierarchical_type_phase_strata",
                         _hier_data(rng) + (3, 0.34, 2, 4)),
        "adjusted_r2": ("adjusted_r2", (y + rng.normal(0, 0.1, 100), y, 2)),
        "probe_table": ("linear_probe_table",
                        ({"a": x4[:, :2], "b": x4}, x4 @ np.ones(4))),
        "l2_blocks": ("blockwise_l2_normalize",
                      ({"a": rng.normal(0, 100.0, (50, 2)),
                        "b": rng.normal(0, 0.01, (50, 3))}, {"b": 2.0})),
        "error_by_strata": ("error_by_strata",
                            (skew + rng.normal(0, 0.5, 1000), skew, 5)),
        "recovery_classes": ("response_by_recovery_class",
                             (skew[:300], np.concatenate(
                                 [np.full(100, np.nan),
                                  rng.uniform(0, 30, 200)]))),
        "evt_segments": ("evt_centroid_segments", _evt_data(rng) + (2, 20)),
        "evt_segments_macro": ("evt_centroid_segments",
                               _evt_data(rng) + (2, 20, {
                                   7001: True, 7003: True, 7002: False,
                                   7004: False, 7005: False})),
        "evt_cohesion": ("evt_cohesion", (np.array([1, 1, 1, 2, 2, 2]),
                                          np.array([0, 0, 1, 1, 1, 1]))),
    }[name]


NUMPY_CASES = ["post_stratified", "post_stratified_missing",
               "post_stratified_singleton", "simple_random",
               "relative_efficiency", "ward", "dh_skewed", "dh_constant",
               "pooled_within", "aggregate_bins", "oof_scores",
               "hierarchical", "adjusted_r2", "probe_table", "l2_blocks",
               "error_by_strata", "recovery_classes", "evt_segments",
               "evt_segments_macro", "evt_cohesion"]


@pytest.mark.parametrize("case", NUMPY_CASES)
def test_numpy_estimators_equal_jax(case):
    """The copied numpy / scipy estimators: bit for bit."""
    name, args = _numpy_case(case, np.random.default_rng(0))
    assert_same(getattr(tfia, name)(*args), getattr(jfia, name)(*args))


def test_embedding_strata_equals_jax():
    """A cluster model carried across (``from_params`` on scikit-learn's
    fit) gives the JAX side's plot labels and population weights."""
    rng = np.random.default_rng(1)
    pop = np.concatenate([rng.normal(0, 0.3, (800, 2)),
                          rng.normal(5, 0.3, (200, 2))])
    plots = np.concatenate([rng.normal(0, 0.3, (20, 2)),
                            rng.normal(5, 0.3, (20, 2))])
    gm = SkGMM(2, random_state=0).fit(pop)
    mine = GaussianMixture.from_params(gm.weights_, gm.means_,
                                       gm.covariances_, "full", device="cpu")
    assert_same(tfia.embedding_strata(mine, plots, z_population=pop),
                jfia.embedding_strata(gm, plots, z_population=pop))
    assert_same(tfia.embedding_strata(mine, plots,
                                      population_counts=[3, 1]),
                jfia.embedding_strata(gm, plots, population_counts=[3, 1]))


@pytest.mark.parametrize("weighted", [True, False])
def test_knn_impute_matches_jax(weighted):
    rng = np.random.default_rng(2)
    z = rng.uniform(-1, 1, (500, 2))
    y = z[:, 0] * 3 + z[:, 1]
    zq = rng.uniform(-0.8, 0.8, (50, 2))
    np.testing.assert_allclose(
        tfia.knn_impute(z, y, zq, k=7, weighted=weighted, device="cpu"),
        jfia.knn_impute(z, y, zq, k=7, weighted=weighted),
        rtol=0, atol=1e-10)


def test_knn_eval_and_phase_weight_tuning_match_jax():
    rng = np.random.default_rng(3)
    zt_tr, zp_tr = rng.normal(size=(300, 3)), rng.normal(size=(300, 2))
    zt_va, zp_va = rng.normal(size=(100, 3)), rng.normal(size=(100, 2))
    y_tr, y_va = zp_tr @ np.ones(2), zp_va @ np.ones(2)
    assert_same(tfia.knn_eval(zt_tr, y_tr, zt_va, y_va, k=5, device="cpu"),
                jfia.knn_eval(zt_tr, y_tr, zt_va, y_va, k=5), rtol=1e-10)
    kw = dict(weight_grid=(0.0, 1.0, 4.0), k_grid=(5, 10))
    got = tfia.tune_phase_weight_and_k(zt_tr, zp_tr, y_tr, zt_va, zp_va,
                                       y_va, device="cpu", **kw)
    assert_same(got, jfia.tune_phase_weight_and_k(
        zt_tr, zp_tr, y_tr, zt_va, zp_va, y_va, **kw), rtol=1e-10)
    assert got["best"]["phase_weight"] > 0


def test_assign_noise_to_nearest_equals_jax():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(0, 0.1, (30, 2)),
                        rng.normal(5, 0.1, (30, 2)),
                        rng.uniform(-1, 6, (8, 2))])
    lab = np.concatenate([np.zeros(30), np.ones(30), -np.ones(8)]).astype(
        int)
    got = tfia.assign_noise_to_nearest(x, lab, device="cpu")
    np.testing.assert_array_equal(got, jfia.assign_noise_to_nearest(x, lab))
    assert (got >= 0).all()


def test_density_strata_match_jax():
    """HDBSCAN over a minPts grid, noise reassigned, target-aggregated:
    the same grid of (minPts, k, noise share), the chosen run's partition
    and the strata's variances."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 400)
    z = rng.normal(0, 6.0, (4, 5))[g] + rng.normal(0, 0.3, (400, 5))
    z = np.concatenate([z, rng.uniform(-15, 15, (40, 5))])
    y = np.concatenate([g * 8.0, rng.normal(10, 5, 40)]) \
        + rng.normal(0, 1.0, 440)
    kw = dict(k_cluster=4, k_strata=4, minpts_grid=(5, 10, 20, 40))
    ref = jfia.density_strata_report(z, y, **kw)
    got = tfia.density_strata_report(z, y, device="cpu", **kw)
    assert_same(got["hdbscan"]["grid"], ref["hdbscan"]["grid"], rtol=0)
    for k in ("min_pts", "k", "noise_frac"):
        assert got["hdbscan"][k] == ref["hdbscan"][k]
    assert same_partition(got["hdbscan"]["labels"], ref["hdbscan"]["labels"])
    assert same_partition(got["stratum"], ref["stratum"])
    for k in ("within_var", "baseline_var", "pct_of_baseline", "ess"):
        np.testing.assert_allclose(got[k], ref[k], rtol=REL, err_msg=k)


def test_removals_report_matches_jax():
    rng = np.random.default_rng(6)
    n = 600
    g = rng.integers(0, 3, n)
    z_type = rng.normal(0, 0.3, (n, 4)) + g[:, None] * 4.0
    z_all = np.concatenate([z_type, rng.normal(size=(n, 2))], 1)
    removals = np.where(rng.random(n) < 0.6, 0.0,
                        rng.exponential(1.0, n) * (1 + g * 5.0))
    balive = g * 12.0 + rng.normal(0, 1.0, n)
    aux = g * 20.0 + rng.normal(0, 8.0, n)
    args = (z_type, z_all, removals, balive, None, aux, 3)
    ref_rows, ref_lab = jfia.removals_stratification_report(
        *args, return_labels=True)
    rows, lab = tfia.removals_stratification_report(
        *args, return_labels=True, device="cpu")
    assert_same(rows, ref_rows, rtol=REL)
    assert set(lab) == set(ref_lab)
    for k in lab:
        assert same_partition(lab[k], ref_lab[k]), k


# --- the CLI ----------------------------------------------------------------

def _write_csv(path, rng, n=300):
    """test_fia's embeddings CSV, with a transfer target, a unit and an
    auxiliary column, and an invalid row as embed_locations writes one."""
    g = rng.integers(0, 3, n)
    zt = rng.normal(0, 0.3, (n, 4)) + g[:, None] * 5.0
    zp = rng.normal(0, 0.3, (n, 2))
    y = np.where(rng.random(n) < 0.4, 0.0, g * 10.0 + rng.normal(0, 1, n))
    cols = (["index", "valid"] + [f"z_type_{i}" for i in range(4)]
            + [f"z_phase_{i}" for i in range(2)]
            + ["BALIVE", "REMV", "UNITCD", "TCC"])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i in range(n):
            w.writerow([i, 1] + list(zt[i]) + list(zp[i])
                       + [g[i] * 12.0 + rng.normal(), y[i], i % 2,
                          g[i] * 20 + rng.normal(0, 8)])
        w.writerow([n, 0] + [""] * (len(cols) - 2))


ANALYSES = {"hierarchical": ["--k-type", "3", "--k-strata", "3"],
            "hdbscan": ["--k-type", "3", "--k-strata", "3"],
            "removals": ["--k-strata", "3", "--transfer-target", "BALIVE",
                         "--aux-col", "TCC"],
            "probe_table": []}


@pytest.mark.parametrize("analysis", sorted(ANALYSES))
def test_cli_matches_jax(analysis, tmp_path, capsys):
    """Both CLIs on one CSV: the JSON equal in its keys and integers and
    to 1e-6 relative in its floats, the strata npz and the report tables
    alike."""
    _write_csv(tmp_path / "emb.csv", np.random.default_rng(7))
    argv = ["--csv", str(tmp_path / "emb.csv"), "--target", "REMV",
            "--analysis", analysis, "--unit-col", "UNITCD"] \
        + ANALYSES[analysis]
    outs = []
    for tag, main, extra in (("j", jfia.main, []),
                             ("t", tfia.main, ["--device", "cpu"])):
        main(argv + extra + ["--output", str(tmp_path / f"{tag}.npz"),
                             "--report-dir", str(tmp_path / tag)])
        outs.append(json.loads(capsys.readouterr().out))
    assert_same(outs[1], outs[0], rtol=REL)
    assert outs[1]["n_plots"] == 300
    if analysis != "probe_table":
        assert same_partition(np.load(tmp_path / "t.npz")["stratum"],
                              np.load(tmp_path / "j.npz")["stratum"])
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())


def test_cli_without_matplotlib_writes_the_tables(tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _write_csv(tmp_path / "emb.csv", np.random.default_rng(8))
    tfia.main(["--csv", str(tmp_path / "emb.csv"), "--target", "REMV",
               "--analysis", "removals", "--k-strata", "3",
               "--report-dir", str(tmp_path / "rep"), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "skipped the figure" in printed
    out = json.loads(printed.splitlines()[-1])
    assert sorted(p.name for p in (tmp_path / "rep").iterdir()) == [
        "removals_efficiency.csv", "removals_efficiency.md"]
    assert out["table"]["baseline"]["pct_of_baseline"] == 100.0


def test_cli_asked_for_cuda_without_a_card_raises(tmp_path):
    """The default device is ``cuda``; without a card the CLI raises before
    it reads the CSV (on a machine with a card this case does not apply)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfia.main(["--csv", str(tmp_path / "missing.csv"), "--target", "y"])
