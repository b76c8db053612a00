"""The port's own clustering estimators, in torch on an explicit device.

The JAX package calls scikit-learn for the clustering of its eval tools
(``eval/gmm.py``, ``eval/landscape_categories.py``, ``eval/fia.py``). The
card's machine has no scikit-learn, so the port carries its own, named
after the scikit-learn objects whose call sites they replace and held to
scikit-learn 1.9's contracts:

- :class:`GaussianMixture`: EM for the ``full``, ``tied``, ``diag`` and
  ``spherical`` covariance types from a k-means start, best lower bound of
  ``n_init`` runs, ``predict`` / ``predict_proba`` / ``score_samples`` /
  ``score`` / ``bic`` / ``aic``; :meth:`GaussianMixture.from_params` builds
  a fitted model from parameters;
- :class:`KMeans`: k-means++ with ``2 + int(log k)`` local trials, then
  Lloyd, best inertia of ``n_init`` runs; ``init`` may be an array;
- :func:`silhouette_score` (Euclidean) and
  :func:`normalized_mutual_info_score` (arithmetic normalisation);
- :func:`kneighbors` and :class:`KNeighborsRegressor` (``uniform`` and
  ``distance`` weights, where a query with exact matches averages only
  them);
- :class:`HDBSCAN`: core distance to the ``min_samples``-th neighbour
  counting the point itself, Prim's tree over the mutual reachability,
  the condensed tree, excess-of-mass selection, noise labelled -1.

Every random draw comes from a numpy generator made on the host from
``random_state`` (an int or None seeds a fresh ``np.random.default_rng``;
a Generator is drawn from as it is), so a fit on the card and the same fit
on the CPU start from the same numbers. The arithmetic runs on ``device`` in
float64, whatever the input's type; HDBSCAN grows Prim's tree on ``device``
one mutual-reachability row a step, in memory linear in N, and walks it on
the host. A fit reads one set of scalars from the device per EM or Lloyd
iteration, to test convergence. Fitted attributes are numpy arrays, so a
pickled model loads with the port alone; methods take numpy arrays or
tensors and return numpy arrays.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

# rows of a [rows, N] block of float64 distances (2^25 elements, 256 MB)
BLOCK_ELEMENTS = 1 << 25
# eager runs of a repeated device step before it is captured as a graph
_GRAPH_WARM = 3
_EXACT = "donot_use_mm_for_euclid_dist"
_GMM_ILL_DEFINED = (
    "Fitting the mixture model failed because some components have "
    "ill-defined empirical covariance (for instance caused by singleton or "
    "collapsed samples). Try to decrease the number of components, increase "
    "reg_covar, or scale the input data.")


def _rng(random_state) -> np.random.Generator:
    if isinstance(random_state, np.random.Generator):
        return random_state
    return np.random.default_rng(random_state)


def _float64(x, device) -> torch.Tensor:
    """numpy array or tensor -> float64 tensor on ``device`` (float32 is
    copied as it is and widened there)."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device).to(torch.float64)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _block_rows(n: int) -> int:
    return max(1, BLOCK_ELEMENTS // max(n, 1))


def _euclidean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[A, D] x [B, D] -> [A, B] distances from the differences (no
    ``|a|^2 - 2 a.b + |b|^2`` cancellation; a point's distance to itself is
    exactly 0)."""
    return torch.cdist(a, b, compute_mode=_EXACT)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _sq_dist(a: torch.Tensor, b: torch.Tensor, b_sq: torch.Tensor
             ) -> torch.Tensor:
    """Squared distances [A, B] as scikit-learn's ``euclidean_distances(...,
    squared=True)`` computes them (the norms' form, clipped at 0)."""
    d = (a * a).sum(1)[:, None] - 2.0 * (a @ b.T) + b_sq[None, :]
    return d.clamp_(min=0.0)


def _nearest_centre(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Lloyd's assignment: argmin over k of |c_k|^2 - 2 x.c_k (first index
    on ties), by blocks of rows."""
    c_sq = (c * c).sum(1)
    step = _block_rows(c.shape[0])
    return torch.cat([(c_sq[None, :] - 2.0 * (x[s:s + step] @ c.T)).argmin(1)
                      for s in range(0, x.shape[0], step)])


def kmeans_plusplus(x: torch.Tensor, n_clusters: int,
                    rng: np.random.Generator) -> torch.Tensor:
    """k-means++ seeds [k, D] on x's device: the first uniformly, each next
    the best of ``2 + int(log k)`` candidates drawn in proportion to the
    squared distance to the nearest seed. The draws are made on the host up
    front and copied once."""
    n = x.shape[0]
    trials = 2 + int(np.log(n_clusters))
    first = int(rng.integers(n))
    u = torch.as_tensor(rng.uniform(size=(max(n_clusters - 1, 0), trials)),
                        device=x.device)
    x_sq = (x * x).sum(1)
    idx = torch.empty(n_clusters, dtype=torch.long, device=x.device)
    idx[0] = first
    closest = _sq_dist(x[first:first + 1], x, x_sq)[0]
    pot = closest.sum()
    for c in range(1, n_clusters):
        cand = torch.searchsorted(torch.cumsum(closest, 0),
                                  u[c - 1] * pot).clamp_(max=n - 1)
        dist = torch.minimum(closest, _sq_dist(x[cand], x, x_sq))
        pots = dist.sum(1)
        best = pots.argmin().view(1)
        pot = pots.index_select(0, best)[0]
        closest = dist.index_select(0, best)[0]
        idx[c:c + 1] = cand.index_select(0, best)
    return x.index_select(0, idx)


def _centre_sums(x, labels, k):
    sums = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
    sums.index_add_(0, labels, x)
    counts = torch.bincount(labels, minlength=k).to(x.dtype)
    return sums, counts


def _average(sums, counts):
    """scikit-learn's ``_average_centers``: an empty cluster sits on the
    largest cluster's centre."""
    centres = sums / counts.clamp(min=1.0)[:, None]
    empty = counts == 0
    return torch.where(empty[:, None], centres[counts.argmax()][None, :],
                       centres)


def _relocate_empty(x, centres_old, sums, counts, labels):
    """scikit-learn's ``_relocate_empty_clusters_dense``: each empty
    cluster takes one of the points farthest from their centres (here in
    descending order of that distance)."""
    empty = torch.nonzero(counts == 0).flatten().tolist()
    d = ((x - centres_old[labels]) ** 2).sum(1)
    if float(d.max()) == 0.0:
        return sums, counts
    far = torch.topk(d, len(empty)).indices.tolist()
    for new_id, j in zip(empty, far):
        old = int(labels[j])
        sums[old] -= x[j]
        sums[new_id] = x[j]
        counts[new_id] = 1.0
        counts[old] -= 1.0
    return sums, counts


def _lloyd(x, centres, max_iter: int, tol: float):
    """One Lloyd run from ``centres`` (scikit-learn's
    ``_kmeans_single_lloyd``): stop when the labels repeat (strict
    convergence) or the summed squared centre shift is at most ``tol``;
    without strict convergence the labels are recomputed from the last
    centres. -> (labels, inertia tensor, centres, iterations)."""
    k = centres.shape[0]
    labels_old = torch.full((x.shape[0],), -1, dtype=torch.long,
                            device=x.device)
    strict = False
    for i in range(max_iter):
        labels = _nearest_centre(x, centres)
        sums, counts = _centre_sums(x, labels, k)
        new = _average(sums, counts)
        shift = ((new - centres) ** 2).sum()
        same, n_empty, shift_tot = torch.stack([
            (labels == labels_old).all().to(x.dtype),
            (counts == 0).sum().to(x.dtype), shift]).tolist()
        if n_empty:
            sums, counts = _relocate_empty(x, centres, sums, counts, labels)
            new = _average(sums, counts)
            shift_tot = float(((new - centres) ** 2).sum())
        centres = new
        if same:
            strict = True
            break
        if shift_tot <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _nearest_centre(x, centres)
    inertia = ((x - centres[labels]) ** 2).sum()
    return labels, inertia, centres, i + 1


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """scikit-learn's ``_is_same_clustering``: equal up to a permutation
    of the labels (a's label -> b's label is a function)."""
    mapping = np.full(k, -1)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def _kmeans(x: torch.Tensor, n_clusters: int, init, n_init: int,
            max_iter: int, tol: float, rng: np.random.Generator):
    """k-means on a float64 tensor -> (labels, inertia, centres, n_iter),
    labels and centres on x's device. The data are centred on their mean
    first, as scikit-learn does."""
    tol = float(x.var(0, correction=0).mean()) * tol if tol else 0.0
    mean = x.mean(0)
    x = x - mean
    start = None
    if not isinstance(init, str):
        start = _float64(init, x.device) - mean
    best = None
    for _ in range(n_init):
        c0 = kmeans_plusplus(x, n_clusters, rng) if start is None else start
        labels, inertia, centres, n_iter = _lloyd(x, c0, max_iter, tol)
        inertia = float(inertia)
        if best is None or (inertia < best[1] and not _same_clustering(
                _host(labels), _host(best[0]), n_clusters)):
            best = (labels, inertia, centres, n_iter)
    labels, inertia, centres, n_iter = best
    return labels, inertia, centres + mean, n_iter


class KMeans:
    """k-means (scikit-learn's ``KMeans`` with the Lloyd algorithm):
    ``fit`` sets ``labels_``, ``cluster_centers_``, ``inertia_`` and
    ``n_iter_``. ``init``: ``"k-means++"`` or initial centres [k, D]."""

    def __init__(self, n_clusters: int = 8, *, init="k-means++",
                 n_init: int = 1, max_iter: int = 300, tol: float = 1e-4,
                 random_state=None, device="cuda"):
        self.n_clusters = n_clusters
        self.init = init
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.device = device

    def fit(self, x) -> "KMeans":
        labels, inertia, centres, n_iter = _kmeans(
            _float64(x, self.device), self.n_clusters, self.init,
            self.n_init, self.max_iter, self.tol, _rng(self.random_state))
        self.labels_ = _host(labels)
        self.cluster_centers_ = _host(centres)
        self.inertia_ = inertia
        self.n_iter_ = n_iter
        return self


# ---------------------------------------------------------------------------
# Gaussian mixtures
# ---------------------------------------------------------------------------

def _gaussian_parameters(x, resp, reg_covar: float, covariance_type: str):
    """scikit-learn's ``_estimate_gaussian_parameters`` -> (nk, means,
    covariances)."""
    nk = resp.sum(0) + 10 * torch.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, None]
    if covariance_type == "full":
        d = x.shape[1]
        cov = torch.empty(len(nk), d, d, dtype=x.dtype, device=x.device)
        for k in range(len(nk)):
            diff = x - means[k]
            cov[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
        cov += reg_covar * torch.eye(d, dtype=x.dtype, device=x.device)
    elif covariance_type == "tied":
        cov = x.T @ x - (means.T * nk) @ means
        cov = cov / nk.sum()
        cov += reg_covar * torch.eye(x.shape[1], dtype=x.dtype,
                                     device=x.device)
    else:
        cov = (resp.T @ (x * x)) / nk[:, None] - means ** 2 + reg_covar
        if covariance_type == "spherical":
            cov = cov.mean(1)
    return nk, means, cov


def _precision_cholesky(cov, covariance_type: str):
    """-> (Cholesky factor of the precisions, a 0/1 tensor that is 1 where
    a covariance is not positive definite), without a host sync."""
    if covariance_type in ("full", "tied"):
        chol, info = torch.linalg.cholesky_ex(cov)
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        prec = torch.linalg.solve_triangular(
            chol, eye.expand_as(chol), upper=False).transpose(-1, -2)
        return prec, (info != 0).any().to(cov.dtype)
    return 1.0 / torch.sqrt(cov), (cov <= 0.0).any().to(cov.dtype)


def _precision_cholesky_from_precisions(prec, covariance_type: str):
    if covariance_type in ("full", "tied"):
        flip = prec.flip(-1, -2)
        return torch.linalg.cholesky(flip).flip(-1, -2)
    return torch.sqrt(prec)


def _log_gaussian_prob(x, means, prec_chol, covariance_type: str):
    """scikit-learn's ``_estimate_log_gaussian_prob`` -> [N, K]."""
    n, d = x.shape
    k = means.shape[0]
    if covariance_type in ("full", "tied"):
        diag = torch.diagonal(prec_chol, dim1=-2, dim2=-1)
        log_det = torch.log(diag).sum(-1)
        log_prob = torch.empty(n, k, dtype=x.dtype, device=x.device)
        for j in range(k):
            pc = prec_chol[j] if covariance_type == "full" else prec_chol
            y = x @ pc - means[j] @ pc
            log_prob[:, j] = (y * y).sum(1)
    elif covariance_type == "diag":
        prec = prec_chol ** 2
        log_det = torch.log(prec_chol).sum(1)
        log_prob = ((means ** 2 * prec).sum(1) - 2.0 * (x @ (means * prec).T)
                    + (x ** 2) @ prec.T)
    else:
        prec = prec_chol ** 2
        log_det = d * torch.log(prec_chol)
        log_prob = ((means ** 2).sum(1) * prec - 2.0 * (x @ means.T * prec)
                    + torch.outer((x * x).sum(1), prec))
    return -0.5 * (d * math.log(2 * math.pi) + log_prob) + log_det


class GaussianMixture:
    """Gaussian mixture by EM (scikit-learn's ``GaussianMixture`` with its
    default k-means initialisation). ``fit`` sets ``weights_``, ``means_``,
    ``covariances_``, ``precisions_cholesky_``, ``precisions_``,
    ``converged_``, ``n_iter_`` and ``lower_bound_``; ``weights_init``,
    ``means_init`` and ``precisions_init``, all three given, replace the
    k-means start."""

    def __init__(self, n_components: int = 1, *, covariance_type="full",
                 tol: float = 1e-3, reg_covar: float = 1e-6,
                 max_iter: int = 100, n_init: int = 1, weights_init=None,
                 means_init=None, precisions_init=None, random_state=None,
                 device="cuda"):
        if covariance_type not in ("full", "tied", "diag", "spherical"):
            raise ValueError(f"covariance_type {covariance_type!r}")
        self.n_components = n_components
        self.covariance_type = covariance_type
        self.tol = tol
        self.reg_covar = reg_covar
        self.max_iter = max_iter
        self.n_init = n_init
        self.weights_init = weights_init
        self.means_init = means_init
        self.precisions_init = precisions_init
        self.random_state = random_state
        self.device = device

    # --- fitting ----------------------------------------------------------

    def _initialize(self, x, rng):
        ct, dev = self.covariance_type, x.device
        given = [None if v is None else _float64(v, dev) for v in
                 (self.weights_init, self.means_init, self.precisions_init)]
        weights, means, cov = None, None, None
        if any(v is None for v in given):
            labels = _kmeans(x, self.n_components, "k-means++", 1, 300,
                             1e-4, rng)[0]
            resp = torch.nn.functional.one_hot(
                labels, self.n_components).to(x.dtype)
            weights, means, cov = _gaussian_parameters(x, resp,
                                                       self.reg_covar, ct)
            weights = weights / x.shape[0]
        weights = weights if given[0] is None else given[0]
        means = means if given[1] is None else given[1]
        if given[2] is None:
            prec_chol, bad = _precision_cholesky(cov, ct)
        else:
            prec_chol = _precision_cholesky_from_precisions(given[2], ct)
            bad = torch.zeros((), dtype=x.dtype, device=dev)
        return [weights, means, cov, prec_chol], bad

    def _weighted_log_prob(self, x, params):
        weights, means, _, prec_chol = params
        return (_log_gaussian_prob(x, means, prec_chol, self.covariance_type)
                + torch.log(weights))

    def _e_step(self, x, params):
        wlp = self._weighted_log_prob(x, params)
        norm = torch.logsumexp(wlp, 1)
        return norm.mean(), wlp - norm[:, None]

    def _m_step(self, x, log_resp):
        nk, means, cov = _gaussian_parameters(
            x, torch.exp(log_resp), self.reg_covar, self.covariance_type)
        prec_chol, bad = _precision_cholesky(cov, self.covariance_type)
        return [nk / nk.sum(), means, cov, prec_chol], bad

    def fit(self, x) -> "GaussianMixture":
        self.fit_predict(x)
        return self

    def fit_predict(self, x) -> np.ndarray:
        x = _float64(x, self.device)
        if x.shape[0] < self.n_components:
            raise ValueError(f"Expected n_samples >= n_components but got "
                             f"n_components = {self.n_components}, "
                             f"n_samples = {x.shape[0]}")
        rng = _rng(self.random_state)
        max_lb, best = -math.inf, None
        self.converged_ = False
        for _ in range(self.n_init):
            params, bad = self._initialize(x, rng)
            if float(bad):
                raise ValueError(_GMM_ILL_DEFINED)
            lb, converged, n_iter = -math.inf, False, 0
            for n_iter in range(1, self.max_iter + 1):
                prev = lb
                norm, log_resp = self._e_step(x, params)
                params, bad = self._m_step(x, log_resp)
                lb, bad = torch.stack([norm, bad]).tolist()
                if bad:
                    raise ValueError(_GMM_ILL_DEFINED)
                if abs(lb - prev) < self.tol:
                    converged = True
                    break
            if lb > max_lb or max_lb == -math.inf:
                max_lb, best, self.converged_ = lb, (params, n_iter), \
                    converged
        params, self.n_iter_ = best
        self._set_parameters(params)
        self.lower_bound_ = max_lb
        # a final E-step, so that fit_predict(x) equals fit(x).predict(x)
        return _host(self._e_step(x, params)[1].argmax(1))

    def _set_parameters(self, params) -> None:
        weights, means, cov, prec_chol = params
        self.weights_ = _host(weights)
        self.means_ = _host(means)
        self.covariances_ = None if cov is None else _host(cov)
        self.precisions_cholesky_ = _host(prec_chol)
        if self.covariance_type in ("full", "tied"):
            self.precisions_ = _host(prec_chol @ prec_chol.transpose(-1, -2))
        else:
            self.precisions_ = _host(prec_chol ** 2)
        self.n_features_in_ = self.means_.shape[1]

    @classmethod
    def from_params(cls, weights, means, covariances, covariance_type: str,
                    device="cuda") -> "GaussianMixture":
        """A fitted mixture from its weights [K], means [K, D] and
        covariances (shaped by ``covariance_type`` as ``covariances_``); the
        precisions' Cholesky factors are computed from them as a fit's last
        M-step computes them."""
        gm = cls(len(weights), covariance_type=covariance_type, device=device)
        cov = _float64(covariances, device)
        prec_chol, bad = _precision_cholesky(cov, covariance_type)
        if float(bad):
            raise ValueError(_GMM_ILL_DEFINED)
        gm._set_parameters([_float64(weights, device),
                            _float64(means, device), cov, prec_chol])
        gm.converged_, gm.n_iter_, gm.lower_bound_ = True, 0, math.nan
        return gm

    # --- prediction -------------------------------------------------------

    def _params(self, dev):
        return [_float64(self.weights_, dev), _float64(self.means_, dev),
                None, _float64(self.precisions_cholesky_, dev)]

    def _wlp(self, x) -> torch.Tensor:
        x = _float64(x, x.device if isinstance(x, torch.Tensor)
                       else self.device)
        return self._weighted_log_prob(x, self._params(x.device))

    def predict(self, x) -> np.ndarray:
        return _host(self._wlp(x).argmax(1))

    def predict_proba(self, x) -> np.ndarray:
        wlp = self._wlp(x)
        return _host(torch.exp(wlp - torch.logsumexp(wlp, 1)[:, None]))

    def score_samples(self, x) -> np.ndarray:
        return _host(torch.logsumexp(self._wlp(x), 1))

    def score(self, x) -> float:
        return float(self.score_samples(x).mean())

    def _n_parameters(self) -> int:
        k, d = self.means_.shape
        cov = {"full": k * d * (d + 1) / 2.0, "diag": k * d,
               "tied": d * (d + 1) / 2.0, "spherical": k}[
                   self.covariance_type]
        return int(cov + d * k + k - 1)

    def bic(self, x) -> float:
        n = x.shape[0]
        return -2 * self.score(x) * n + self._n_parameters() * math.log(n)

    def aic(self, x) -> float:
        return -2 * self.score(x) * x.shape[0] + 2 * self._n_parameters()


# ---------------------------------------------------------------------------
# Scores
# ---------------------------------------------------------------------------

def silhouette_score(x, labels, *, device="cuda") -> float:
    """Mean silhouette coefficient (Euclidean, float64): per-cluster sums
    of distances by blocks of rows, a [block, N] distance block times the
    [N, K] one-hot labels; a sample of a singleton cluster scores 0."""
    x = _float64(x, device)
    classes, inv = np.unique(np.asarray(labels), return_inverse=True)
    n, k = x.shape[0], len(classes)
    if not 1 < k < n:
        raise ValueError(f"Number of labels is {k}. Valid values are 2 to "
                         f"n_samples - 1 (inclusive)")
    lab = torch.as_tensor(inv.reshape(-1), device=x.device)
    onehot = torch.nn.functional.one_hot(lab, k).to(x.dtype)
    freqs = onehot.sum(0)
    intra, inter = [], []
    step = _block_rows(n)
    for s in range(0, n, step):
        cd = _euclidean(x[s:s + step], x) @ onehot              # [B, K]
        li = lab[s:s + step, None]
        intra.append(cd.gather(1, li)[:, 0])
        inter.append((cd.scatter(1, li, math.inf) / freqs).min(1).values)
    a = torch.cat(intra) / (freqs - 1)[lab]
    b = torch.cat(inter)
    return float(torch.nan_to_num((b - a) / torch.maximum(a, b)).mean())


def normalized_mutual_info_score(labels_true, labels_pred) -> float:
    """NMI with the arithmetic mean of the two entropies, from the
    contingency table (on the host: the table is small)."""
    a, b = np.asarray(labels_true), np.asarray(labels_pred)
    ca, ia = np.unique(a, return_inverse=True)
    cb, ib = np.unique(b, return_inverse=True)
    if len(ca) == len(cb) == 1 or len(ca) == len(cb) == 0:
        return 1.0
    table = np.zeros((len(ca), len(cb)), np.int64)
    np.add.at(table, (ia.reshape(-1), ib.reshape(-1)), 1)
    table = table.astype(np.float64)
    nzx, nzy = np.nonzero(table)
    nz = table[nzx, nzy]
    total = table.sum()
    pi, pj = table.sum(1), table.sum(0)
    if pi.size == 1 or pj.size == 1:
        return 0.0
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + math.log(pi.sum()) + math.log(pj.sum())
    frac = nz / total
    mi = frac * (np.log(nz) - math.log(total)) + frac * log_outer
    mi = float(np.clip(np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0,
                                mi).sum(), 0.0, None))
    if mi == 0:
        return 0.0

    def entropy(counts):
        p = counts.astype(np.float64)
        if p.size == 1:
            return 0.0
        s = p.sum()
        return float(-np.sum((p / s) * (np.log(p) - math.log(s))))

    h = (entropy(np.bincount(ia.reshape(-1)))
         + entropy(np.bincount(ib.reshape(-1)))) / 2
    return float(mi / h)


# ---------------------------------------------------------------------------
# Nearest neighbours
# ---------------------------------------------------------------------------

def _kneighbors(train: torch.Tensor, query: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    step = _block_rows(train.shape[0])
    out = [torch.topk(_euclidean(query[s:s + step], train), k, dim=1,
                      largest=False, sorted=True)
           for s in range(0, query.shape[0], step)]
    return (torch.cat([o.values for o in out]),
            torch.cat([o.indices for o in out]))


def kneighbors(train, query, k: int, *, device="cuda"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The k nearest rows of ``train`` for each row of ``query``
    (Euclidean, by blocks of queries) -> (distances [Q, k] ascending,
    indices [Q, k])."""
    dist, idx = _kneighbors(_float64(train, device),
                            _float64(query, device), k)
    return _host(dist), _host(idx)


class KNeighborsRegressor:
    """kNN regression (scikit-learn's ``KNeighborsRegressor``, Euclidean):
    the mean of the neighbours' targets, or with ``weights="distance"`` the
    inverse-distance mean, where a query with neighbours at distance 0
    averages those alone."""

    def __init__(self, n_neighbors: int = 5, *, weights: str = "uniform",
                 device="cuda"):
        if weights not in ("uniform", "distance"):
            raise ValueError(f"weights {weights!r}")
        self.n_neighbors = n_neighbors
        self.weights = weights
        self.device = device

    def fit(self, x, y) -> "KNeighborsRegressor":
        self._x = _float64(x, self.device)
        self._y = _float64(y, self.device)
        return self

    def predict(self, x) -> np.ndarray:
        dist, idx = _kneighbors(self._x, _float64(x, self.device),
                                self.n_neighbors)
        y = self._y[idx]                                      # [Q, k, ...]
        if self.weights == "uniform":
            return _host(y.mean(1))
        zero = dist == 0
        w = torch.where(zero.any(1, keepdim=True), zero.to(dist.dtype),
                        1.0 / dist)
        if y.dim() == 3:
            w = w[..., None]
        return _host((y * w).sum(1) / w.sum(1))


# ---------------------------------------------------------------------------
# HDBSCAN
# ---------------------------------------------------------------------------

def _core_distances(x: torch.Tensor, min_samples: int) -> torch.Tensor:
    """Distance of each row to its ``min_samples``-th nearest row, the row
    itself counted, by [block, N] blocks of rows."""
    step = _block_rows(x.shape[0])
    return torch.cat([_euclidean(x[s:s + step], x).kthvalue(
        min_samples, dim=1).values for s in range(0, x.shape[0], step)])


def _repeat(step, times: int, device) -> None:
    """Run ``step`` (device work only, every tensor updated in place)
    ``times`` times. On a card the first _GRAPH_WARM run eagerly on a side
    stream, then one run is captured as a CUDA graph and replayed for the
    rest: one launch a step where the step's own ops take a dozen."""
    if torch.device(device).type != "cuda" or times <= _GRAPH_WARM:
        for _ in range(times):
            step()
        return
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(_GRAPH_WARM):
            step()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(times - _GRAPH_WARM):
        graph.replay()


def _prim_mst(x: torch.Tensor, core: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Prim's tree over the mutual reachability max(d(i, j), core_i,
    core_j), from node 0, as scikit-learn's ``mst_from_data_matrix`` grows
    it: each step takes the first node (lowest index) at the least
    reachability, and an edge's source is the tree node that last lowered
    that node's reachability. One [N] row of the reachability a step, on
    x's device (_repeat); the current node and the step's index stay
    device tensors, so no step waits for the host, and the edges come back
    in one copy.
    -> (sources, targets, weights) of the n - 1 edges in the order added."""
    n, dev = x.shape[0], x.device
    m = max(n - 1, 0)
    in_tree = torch.zeros(n, dtype=torch.bool, device=dev)
    reach = torch.full((n,), math.inf, dtype=x.dtype, device=dev)
    source = torch.zeros(n, dtype=torch.long, device=dev)
    src = torch.empty(m, dtype=torch.long, device=dev)
    dst, w = torch.empty_like(src), torch.empty(m, dtype=x.dtype, device=dev)
    cur = torch.zeros(1, dtype=torch.long, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)

    def step():
        in_tree.index_fill_(0, cur, True)
        row = torch.maximum(torch.maximum(
            _euclidean(x.index_select(0, cur), x)[0], core),
            core.index_select(0, cur))
        lower = row < reach
        reach.copy_(torch.where(lower, row, reach))
        source.copy_(torch.where(lower, cur, source))
        cand = reach.masked_fill(in_tree, math.inf)
        cur.copy_(cand.argmin().view(1))
        dst.index_copy_(0, i, cur)
        w.index_copy_(0, i, cand.index_select(0, cur))
        src.index_copy_(0, i, source.index_select(0, cur))
        i.add_(1)

    _repeat(step, m, dev)
    return _host(src), _host(dst), _host(w)


def _single_linkage(src, dst, w) -> np.ndarray:
    """scikit-learn's ``make_single_linkage`` over the tree's edges sorted
    by weight -> [n - 1, 4] rows (left, right, distance, size)."""
    order = np.argsort(w)
    n = len(w) + 1
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])
    out = np.zeros((n - 1, 4))

    def find(i):
        root = i
        while parent[root] != -1:
            root = parent[root]
        while parent[i] != -1 and parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for row, e in enumerate(order):
        a, b = find(src[e]), find(dst[e])
        out[row] = (a, b, w[e], size[a] + size[b])
        parent[a] = parent[b] = n + row
        size[n + row] = size[a] + size[b]
    return out


def _bfs(hierarchy: np.ndarray, root: int) -> list:
    n = len(hierarchy) + 1
    result, queue = [], [root]
    while queue:
        result.extend(queue)
        queue = [int(c) for x in queue if x >= n
                 for c in hierarchy[x - n, :2]]
    return result


def _condense_tree(hierarchy: np.ndarray, min_cluster_size: int
                   ) -> np.ndarray:
    """scikit-learn's ``_condense_tree`` -> [rows, 4] (parent, child,
    lambda, size): a split into two parts of at least ``min_cluster_size``
    makes two clusters; smaller parts fall out as points."""
    n = len(hierarchy) + 1
    root = 2 * (n - 1)
    relabel = np.empty(root + 1, np.int64)
    relabel[root] = n
    next_label = n + 1
    ignore = np.zeros(root + 1, bool)
    rows = []

    def size(node):
        return int(hierarchy[node - n, 3]) if node >= n else 1

    def fall_out(parent, node, lam):
        for sub in _bfs(hierarchy, node):
            if sub < n:
                rows.append((parent, sub, lam, 1))
            ignore[sub] = True

    for node in _bfs(hierarchy, root):
        if ignore[node] or node < n:
            continue
        left, right = int(hierarchy[node - n, 0]), int(hierarchy[node - n, 1])
        dist = hierarchy[node - n, 2]
        lam = 1.0 / dist if dist > 0.0 else math.inf
        nl, nr = size(left), size(right)
        if nl >= min_cluster_size and nr >= min_cluster_size:
            for child, count in ((left, nl), (right, nr)):
                relabel[child] = next_label
                next_label += 1
                rows.append((relabel[node], relabel[child], lam, count))
        elif nl < min_cluster_size and nr < min_cluster_size:
            fall_out(relabel[node], left, lam)
            fall_out(relabel[node], right, lam)
        elif nl < min_cluster_size:
            relabel[right] = relabel[node]
            fall_out(relabel[node], left, lam)
        else:
            relabel[left] = relabel[node]
            fall_out(relabel[node], right, lam)
    return np.asarray(rows, np.float64).reshape(-1, 4)


def _eom_labels(tree: np.ndarray) -> np.ndarray:
    """Stabilities, excess-of-mass selection without the root (scikit-
    learn's ``_compute_stability``, ``_get_clusters`` and ``_do_labelling``
    at ``allow_single_cluster=False``, epsilon 0) -> labels, -1 noise."""
    parent, child = tree[:, 0].astype(np.int64), tree[:, 1].astype(np.int64)
    lam, count = tree[:, 2], tree[:, 3].astype(np.int64)
    root = int(parent.min())
    births = np.full(max(int(child.max()), root) + 1, np.nan)
    births[child] = lam
    births[root] = 0.0
    stability = {int(c): 0.0 for c in range(root, int(parent.max()) + 1)}
    for p, l, c in zip(parent, lam, count):
        stability[int(p)] += (l - births[p]) * c
    nodes = sorted(stability, reverse=True)[:-1]
    is_cluster = {c: True for c in nodes}
    sub = count > 1
    c_parent, c_child = parent[sub], child[sub]
    for node in nodes:
        kids = c_child[c_parent == node]
        subtree = float(np.sum([stability[int(k)] for k in kids]))
        if subtree > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree
        else:
            queue = [node]
            while queue:
                for s in queue:
                    if s != node:
                        is_cluster[s] = False
                queue = c_child[np.isin(c_parent, queue)].tolist()
    clusters = sorted(c for c, keep in is_cluster.items() if keep)
    label_of = {c: i for i, c in enumerate(clusters)}
    # scikit-learn's union-find over the tree's edges into unselected nodes
    uf = np.zeros((int(parent.max()) + 1, 2), np.int64)
    uf[:, 0] = np.arange(len(uf))

    def find(x):
        path = []
        while uf[x, 0] != x:
            path.append(x)
            x = uf[x, 0]
        for p in path:
            uf[p, 0] = x
        return x

    for p, c in zip(parent, child):
        if c not in label_of:
            a, b = find(p), find(c)
            if uf[a, 1] < uf[b, 1]:
                uf[a, 0] = b
            elif uf[a, 1] > uf[b, 1]:
                uf[b, 0] = a
            else:
                uf[b, 0] = a
                uf[a, 1] += 1
    labels = np.full(root, -1, np.int64)
    for i in range(root):
        c = find(i)
        if c != root:
            labels[i] = label_of[c]
    return labels


class HDBSCAN:
    """HDBSCAN (scikit-learn's ``HDBSCAN`` at its defaults: Euclidean,
    excess of mass, ``allow_single_cluster=False``,
    ``cluster_selection_epsilon=0``): ``fit`` sets ``labels_``, -1 for
    noise. ``min_samples`` (default ``min_cluster_size``) counts the point
    itself. The core distances and Prim's tree run on ``device`` in memory
    linear in N (no [N, N] matrix); the tree walks on the host."""

    def __init__(self, min_cluster_size: int = 5,
                 min_samples: Optional[int] = None, *, device="cuda"):
        self.min_cluster_size = min_cluster_size
        self.min_samples = min_samples
        self.device = device

    def fit(self, x) -> "HDBSCAN":
        x = _float64(x, self.device)
        ms = self.min_cluster_size if self.min_samples is None \
            else self.min_samples
        if ms > x.shape[0]:
            raise ValueError(f"min_samples ({ms}) must be at most the number "
                             f"of samples in X ({x.shape[0]})")
        tree = _condense_tree(
            _single_linkage(*_prim_mst(x, _core_distances(x, ms))),
            self.min_cluster_size)
        self.labels_ = _eom_labels(tree)
        return self


__all__ = ["GaussianMixture", "KMeans", "kmeans_plusplus", "HDBSCAN",
           "KNeighborsRegressor", "kneighbors", "silhouette_score",
           "normalized_mutual_info_score"]
