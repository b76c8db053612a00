"""The port's clustering estimators (``forest_tpu_torch.eval.cluster``)
against scikit-learn, which the JAX package calls, on the CPU.

Float64 data made from a seed with numpy, N <= 2,000, D <= 8, K <= 6.
From the same injected start (``means_init`` / ``weights_init`` /
``precisions_init``, ``KMeans(init=array, n_init=1)``) EM and Lloyd run
the same arithmetic in another order: parameters to rtol 1e-6, lower bound,
BIC, AIC, centres and inertia to rtol 1e-9, iterations and convergence
equal. The port's k-means++ draws from numpy's generator, not scikit-learn's
random stream, so seeded fits are held to scikit-learn's partitions up to a
permutation on blobs whose optimum is unambiguous. Silhouette, NMI and the
kNN regressor to 1e-10; HDBSCAN's labels up to a permutation, -1 kept as
-1. The fits on the card are held to the same fits on the CPU in
``tests/test_torch_eval_card.py``, which the card's machine (no
scikit-learn) can import.
"""
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from sklearn.cluster import HDBSCAN as SkHDBSCAN
from sklearn.cluster import KMeans as SkKMeans
from sklearn.metrics import normalized_mutual_info_score as sk_nmi
from sklearn.metrics import silhouette_score as sk_silhouette
from sklearn.mixture import GaussianMixture as SkGMM
from sklearn.neighbors import KNeighborsRegressor as SkKNN
from sklearn.neighbors import NearestNeighbors

from forest_tpu_torch.eval import cluster as cl

COV_TYPES = ("full", "tied", "diag", "spherical")
PARAM_TOL = dict(rtol=1e-6, atol=1e-12)
SCALAR_RTOL = 1e-9


def blobs(seed=0, k=4, d=5, n=300, scale=4.0, noise=0):
    """k Gaussian blobs of n points with spreads 0.5-1.4, plus ``noise``
    uniform points around them."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=scale, size=(k, d))
    x = np.concatenate([centres[i] + rng.normal(size=(n, d)) * (0.5 + 0.3 * i)
                        for i in range(k)])
    if noise:
        lim = np.abs(x).max()
        x = np.concatenate([x, rng.uniform(-lim, lim, size=(noise, d))])
    return x, np.repeat(np.arange(k), n)


def same_partition(a, b) -> bool:
    """Equal up to a permutation of the labels, with -1 kept as -1."""
    a, b = np.asarray(a), np.asarray(b)
    if not np.array_equal(a < 0, b < 0):
        return False
    pairs = set(zip(a[a >= 0].tolist(), b[b >= 0].tolist()))
    return (len(pairs) == len({p[0] for p in pairs})
            == len({p[1] for p in pairs}))


def injected_start(x, k, ct, seed=1):
    rng = np.random.default_rng(seed)
    d = x.shape[1]
    prec = {"full": np.stack([np.eye(d) * (1 + i) for i in range(k)]),
            "tied": np.eye(d) * 2.0, "diag": np.ones((k, d)),
            "spherical": np.linspace(0.5, 2.0, k)}[ct]
    return dict(weights_init=np.full(k, 1.0 / k),
                means_init=x[rng.choice(len(x), k, replace=False)],
                precisions_init=prec)


@pytest.mark.parametrize("ct", COV_TYPES)
def test_em_from_an_injected_start_matches_sklearn(ct):
    x, _ = blobs()
    start = injected_start(x, 4, ct)
    ref = SkGMM(4, covariance_type=ct, max_iter=200, **start).fit(x)
    got = cl.GaussianMixture(4, covariance_type=ct, max_iter=200,
                             device="cpu", **start).fit(x)
    assert got.n_iter_ == ref.n_iter_ and got.converged_ == ref.converged_
    for name in ("weights_", "means_", "covariances_",
                 "precisions_cholesky_", "precisions_"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   err_msg=name, **PARAM_TOL)
    np.testing.assert_allclose(got.lower_bound_, ref.lower_bound_,
                               rtol=SCALAR_RTOL)
    np.testing.assert_allclose(got.bic(x), ref.bic(x), rtol=SCALAR_RTOL)
    np.testing.assert_allclose(got.aic(x), ref.aic(x), rtol=SCALAR_RTOL)
    np.testing.assert_array_equal(got.predict(x), ref.predict(x))
    np.testing.assert_allclose(got.predict_proba(x), ref.predict_proba(x),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("ct", COV_TYPES)
def test_from_params_on_sklearns_fit(ct):
    """The JAX side's fitted parameters carried across: predict equal,
    score_samples to rtol 1e-9, bic and score as well."""
    x, _ = blobs(seed=2, k=3, d=6, n=250)
    ref = SkGMM(3, covariance_type=ct, random_state=0).fit(x)
    got = cl.GaussianMixture.from_params(ref.weights_, ref.means_,
                                         ref.covariances_, ct, device="cpu")
    np.testing.assert_array_equal(got.predict(x), ref.predict(x))
    np.testing.assert_allclose(got.score_samples(x), ref.score_samples(x),
                               rtol=SCALAR_RTOL)
    np.testing.assert_allclose(got.bic(x), ref.bic(x), rtol=SCALAR_RTOL)
    np.testing.assert_allclose(got.score(x), ref.score(x), rtol=SCALAR_RTOL)
    np.testing.assert_allclose(got.precisions_cholesky_,
                               ref.precisions_cholesky_, **PARAM_TOL)


@pytest.mark.parametrize("ct", COV_TYPES)
def test_seeded_fit_partitions_match_sklearn(ct):
    """The port's own k-means++ start: the same partition as scikit-learn's
    fit on separated blobs, fit_predict equal to fit().predict, and the
    optimum's BIC to 1e-6."""
    x, truth = blobs(seed=3, k=5, d=4, n=200, scale=8.0)
    ref = SkGMM(5, covariance_type=ct, random_state=0, n_init=2).fit(x)
    gm = cl.GaussianMixture(5, covariance_type=ct, random_state=0, n_init=2,
                            device="cpu")
    labels = gm.fit_predict(x)
    np.testing.assert_array_equal(labels, gm.predict(x))
    assert same_partition(labels, ref.predict(x))
    assert same_partition(labels, truth)
    np.testing.assert_allclose(gm.bic(x), ref.bic(x), rtol=1e-6)


def test_bic_selects_the_same_k_as_sklearn():
    x, _ = blobs(seed=4, k=4, d=3, n=200, scale=8.0)
    bic = {}
    for k in (2, 4, 6):
        bic[k] = (SkGMM(k, covariance_type="diag", random_state=0).fit(x)
                  .bic(x),
                  cl.GaussianMixture(k, covariance_type="diag",
                                     random_state=0, device="cpu").fit(x)
                  .bic(x))
    assert min(bic, key=lambda k: bic[k][0]) == 4
    assert min(bic, key=lambda k: bic[k][1]) == 4


def test_each_fit_draws_from_a_fresh_generator():
    """``random_state=seed`` seeds every fit afresh, so a fit does not
    depend on the ones before it; a Generator is drawn from in turn."""
    x, _ = blobs(seed=5, k=3, d=3, n=100)
    a = cl.GaussianMixture(3, covariance_type="diag", random_state=7,
                           device="cpu").fit(x)
    cl.GaussianMixture(5, random_state=7, device="cpu").fit(x)
    b = cl.GaussianMixture(3, covariance_type="diag", random_state=7,
                           device="cpu").fit(x)
    np.testing.assert_array_equal(a.means_, b.means_)
    rng = np.random.default_rng(7)
    s1 = cl.kmeans_plusplus(torch.as_tensor(x), 3, rng)
    s2 = cl.kmeans_plusplus(torch.as_tensor(x), 3, rng)
    s3 = cl.kmeans_plusplus(torch.as_tensor(x), 3, np.random.default_rng(7))
    assert torch.equal(s1, s3) and not torch.equal(s1, s2)


def test_float32_input_is_fit_in_float64():
    x, _ = blobs(seed=6)
    a = cl.GaussianMixture(4, covariance_type="diag", random_state=0,
                           device="cpu").fit(x.astype(np.float32))
    b = cl.GaussianMixture(4, covariance_type="diag", random_state=0,
                           device="cpu").fit(
        x.astype(np.float32).astype(np.float64))
    assert a.means_.dtype == np.float64
    np.testing.assert_array_equal(a.means_, b.means_)


def test_ill_defined_covariance_raises():
    x = np.zeros((20, 2))
    x[10:] = 1.0
    with pytest.raises(ValueError, match="ill-defined"):
        cl.GaussianMixture(2, covariance_type="full", reg_covar=0.0,
                           random_state=0, device="cpu").fit(x)


def test_pickle_loads_without_sklearn(tmp_path):
    """A pickled mixture holds numpy arrays and the port's class: it loads
    and predicts in a process where scikit-learn cannot be imported."""
    x, _ = blobs(seed=7, k=3, d=4, n=100)
    gm = cl.GaussianMixture(3, covariance_type="full", random_state=0,
                            device="cpu").fit(x)
    (tmp_path / "gm.pkl").write_bytes(pickle.dumps({"gmm": gm}))
    np.save(tmp_path / "x.npy", x)
    code = f"""
import pickle, sys
import numpy as np
sys.modules["sklearn"] = None
sys.path.insert(0, {str(Path(__file__).resolve().parents[1])!r})
gm = pickle.loads(open({str(tmp_path / "gm.pkl")!r}, "rb").read())["gmm"]
print(" ".join(map(str, gm.predict(np.load({str(tmp_path / "x.npy")!r})))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    np.testing.assert_array_equal(np.asarray(out.stdout.split(), int),
                                  gm.predict(x))


@pytest.mark.parametrize("tol", [1e-4, 0.01, 0.2])
def test_kmeans_from_an_injected_start_matches_sklearn(tol):
    """Lloyd from the same centres on overlapping blobs, where the stop
    depends on ``tol`` (20, 6 and 4 iterations here)."""
    x, _ = blobs(seed=8, k=5, d=6, n=300, scale=2.0)
    init = x[np.random.default_rng(1).choice(len(x), 5, replace=False)]
    ref = SkKMeans(5, init=init, n_init=1, tol=tol).fit(x)
    got = cl.KMeans(5, init=init, n_init=1, tol=tol, device="cpu").fit(x)
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    assert got.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_,
                               rtol=SCALAR_RTOL, atol=1e-12)
    np.testing.assert_allclose(got.inertia_, ref.inertia_, rtol=SCALAR_RTOL)


def test_seeded_kmeans_matches_sklearns_partition():
    x, truth = blobs(seed=9, k=6, d=3, n=150, scale=10.0)
    ref = SkKMeans(6, n_init=10, random_state=0).fit(x)
    got = cl.KMeans(6, n_init=10, random_state=0, device="cpu").fit(x)
    assert same_partition(got.labels_, ref.labels_)
    assert same_partition(got.labels_, truth)
    np.testing.assert_allclose(got.inertia_, ref.inertia_, rtol=SCALAR_RTOL)


@pytest.mark.parametrize("case", ["blobs", "singleton"])
def test_silhouette_matches_sklearn(case):
    x, lab = blobs(seed=10, k=3, d=4, n=120)
    if case == "singleton":
        lab = lab.copy()
        lab[0] = 7                        # a cluster of one scores 0
    np.testing.assert_allclose(cl.silhouette_score(x, lab, device="cpu"),
                               sk_silhouette(x, lab), rtol=0, atol=1e-10)


def test_silhouette_in_blocks(monkeypatch):
    """Blocks of rows give the whole matrix's answer."""
    x, lab = blobs(seed=11, k=3, d=4, n=100)
    whole = cl.silhouette_score(x, lab, device="cpu")
    monkeypatch.setattr(cl, "BLOCK_ELEMENTS", 7 * len(x))
    np.testing.assert_allclose(cl.silhouette_score(x, lab, device="cpu"),
                               whole, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="Number of labels"):
        cl.silhouette_score(x, np.zeros(len(x)), device="cpu")


@pytest.mark.parametrize("case", ["random", "related", "one_cluster"])
def test_nmi_matches_sklearn(case):
    rng = np.random.default_rng(12)
    a = rng.integers(0, 5, 600) + 7000
    b = {"random": rng.integers(0, 4, 600),
         "related": (a - 7000) // 2 + (rng.random(600) < 0.1),
         "one_cluster": np.zeros(600, int)}[case]
    np.testing.assert_allclose(cl.normalized_mutual_info_score(a, b),
                               sk_nmi(a, b), rtol=0, atol=1e-10)


@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_knn_regressor_matches_sklearn(weights, monkeypatch):
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, (800, 5))
    y = x[:, 0] * 3 + np.sin(x[:, 1])
    q = rng.uniform(-1, 1, (90, 5))
    ref = SkKNN(7, weights=weights).fit(x, y).predict(q)
    monkeypatch.setattr(cl, "BLOCK_ELEMENTS", 17 * len(x))   # 17-row blocks
    got = cl.KNeighborsRegressor(7, weights=weights, device="cpu").fit(
        x, y).predict(q)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def test_knn_distance_weights_keep_exact_matches_alone():
    """A query equal to training rows averages those rows' targets only."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(200, 3))
    x[1] = x[0]
    y = rng.normal(size=200)
    q = np.concatenate([x[:1], x[5:6], rng.normal(size=(4, 3))])
    ref = SkKNN(5, weights="distance").fit(x, y).predict(q)
    got = cl.KNeighborsRegressor(5, weights="distance", device="cpu").fit(
        x, y).predict(q)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[0], (y[0] + y[1]) / 2, rtol=1e-12)
    assert got[1] == y[5]


def test_nearest_neighbour_matches_sklearn():
    rng = np.random.default_rng(15)
    x, q = rng.normal(size=(500, 4)), rng.normal(size=(60, 4))
    dist, idx = cl.kneighbors(x, q, 3, device="cpu")
    ref_d, ref_i = NearestNeighbors(n_neighbors=3).fit(x).kneighbors(q)
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_allclose(dist, ref_d, rtol=0, atol=1e-10)


@pytest.mark.parametrize("mcs", [5, 10, 20, 40])
def test_hdbscan_matches_sklearn(mcs):
    """Continuous seeded blobs with uniform noise: the labels of
    ``min_cluster_size = min_samples = mcs`` up to a permutation."""
    x, _ = blobs(seed=16, k=5, d=4, n=180, scale=5.0, noise=120)
    ref = SkHDBSCAN(min_cluster_size=mcs, min_samples=mcs).fit(x).labels_
    got = cl.HDBSCAN(mcs, mcs, device="cpu").fit(x).labels_
    assert same_partition(got, ref), (np.unique(got), np.unique(ref))
    assert (got >= 0).any() and (got < 0).any()


@pytest.mark.parametrize("sep,mcs", [(2.4, 5), (2.4, 10), (2.8, 40),
                                     (3.2, 5)])
def test_hdbscan_nested_clusters_match_sklearn(sep, mcs):
    """Two sub-blobs ``sep`` apart inside one cluster, a loose blob, a dense
    small one and noise: the excess-of-mass choice between a cluster and
    its children is scikit-learn's."""
    rng = np.random.default_rng(21)
    x = np.concatenate([rng.normal([0, 0, 0], 0.4, (150, 3)),
                        rng.normal([sep, 0, 0], 0.4, (150, 3)),
                        rng.normal([8, 8, 0], 1.5, (200, 3)),
                        rng.normal([-6, 5, 2], 0.2, (60, 3)),
                        rng.uniform(-10, 12, (80, 3))])
    ref = SkHDBSCAN(min_cluster_size=mcs, min_samples=mcs).fit(x).labels_
    got = cl.HDBSCAN(mcs, mcs, device="cpu").fit(x).labels_
    assert same_partition(got, ref)


def test_hdbscan_min_samples_defaults_to_min_cluster_size():
    x, _ = blobs(seed=17, k=3, d=2, n=60, noise=20)
    ref = SkHDBSCAN(min_cluster_size=8).fit(x).labels_
    assert same_partition(cl.HDBSCAN(8, device="cpu").fit(x).labels_, ref)
    with pytest.raises(ValueError, match="min_samples"):
        cl.HDBSCAN(len(x) + 1, device="cpu").fit(x)


def test_hdbscan_makes_no_n_by_n_tensor(monkeypatch):
    """Memory linear in N: with blocks of 1,000 elements, no distance
    block ``_euclidean`` returns holds N x N elements, and the labels stay
    scikit-learn's."""
    x, _ = blobs(seed=18, k=4, d=5, n=70, scale=5.0, noise=20)
    n = len(x)
    euclidean = cl._euclidean

    def guarded(a, b):
        out = euclidean(a, b)
        assert out.numel() < n * n, tuple(out.shape)
        return out

    monkeypatch.setattr(cl, "BLOCK_ELEMENTS", 1000)
    monkeypatch.setattr(cl, "_euclidean", guarded)
    ref = SkHDBSCAN(min_cluster_size=10, min_samples=10).fit(x).labels_
    got = cl.HDBSCAN(10, 10, device="cpu").fit(x).labels_
    assert n == 300 and same_partition(got, ref)
    assert (got >= 0).any() and (got < 0).any()
