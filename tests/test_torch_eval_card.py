"""The eval tools on the card against the same tools on the CPU.

Port only, since the card's machine has neither flax nor scikit-learn: the
fixture is
``torch_parity.write_port_eval_fixture`` (a 96 x 96 synthetic cube, two
tiny float32 checkpoints). On the card the smoothing kernel K1 runs; on the
CPU its plain version. TF32 is off (``torch_parity``). The clustering
estimators (``eval/cluster.py``) fit in float64 from the same host draws on
both. Every test is marked ``cuda`` and skips where there is no card.
"""
import json
import pickle

import numpy as np
import pytest

from forest_tpu_torch.data import parse_bindings
from forest_tpu_torch.data import zarrlite as zl
from forest_tpu_torch.data.feature_builder import FeatureBuilder
from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
from forest_tpu_torch.eval import embed_locations as tel
from forest_tpu_torch.eval import export_embeddings as tee
from forest_tpu_torch.eval import cluster as cl
from forest_tpu_torch.eval import frozen, gmm, phase_probe, train_probe
from forest_tpu_torch.eval import landscape_categories as lc
from torch_parity import (EVAL_PATCH, cuda_device, eval_locations,  # noqa
                          read_csv, write_port_eval_fixture)

SPLIT = dict(patch_size=EVAL_PATCH, split_block_size=(1, 1))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_port_eval_fixture(tmp_path_factory.mktemp("eval_card"))


def _argv(files, ckpt="ckpt"):
    return ["--checkpoint", str(files[ckpt]), "--bindings",
            str(files["bindings"]), "--patch-size", str(EVAL_PATCH)]


@pytest.mark.cuda
def test_export_on_the_card_matches_the_cpu(cuda_device, files, tmp_path):
    """``export_embeddings --phase``: within one float16 rounding (2^-10
    relative) plus 1e-5 of the CPU's export."""
    for dev in ("cpu", "cuda"):
        tee.main(_argv(files) + ["--phase", "--out",
                                 str(tmp_path / f"{dev}.zarr"),
                                 "--device", dev])
    for k in ("z_type", "z_phase"):
        cpu, gpu = (np.asarray(zl.open_zarr(tmp_path / f"{d}.zarr")[k],
                               np.float32) for d in ("cpu", "cuda"))
        assert np.isfinite(gpu).all()
        np.testing.assert_allclose(gpu, cpu, rtol=2.0 ** -10 + 1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.cuda
def test_embed_locations_on_the_card_matches_the_cpu(cuda_device, files,
                                                     tmp_path):
    """The points' CSV with the projection model: the same columns and
    rows, values within rtol / atol 1e-5."""
    eval_locations(tmp_path / "pts.csv")
    for dev in ("cpu", "cuda"):
        tel.main(_argv(files, "ckpt_proj")
                 + ["--locations", str(tmp_path / "pts.csv"),
                    "--split-block-size", "1", "1", "--output",
                    str(tmp_path / f"{dev}.csv"), "--device", dev])
    (cc, crows), (gc, grows) = (read_csv(tmp_path / "cpu.csv"),
                                read_csv(tmp_path / "cuda.csv"))
    assert gc == cc and len(grows) == len(crows)
    for c_, g_ in zip(crows, grows):
        for k in cc:
            if k in ("split", "valid", "index") or c_[k] == "":
                assert g_[k] == c_[k], k
            else:
                np.testing.assert_allclose(float(g_[k]), float(c_[k]),
                                           rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.cuda
def test_probes_on_the_card_match_the_cpu(cuda_device, files):
    """``train_probe_pipeline`` for 2 epochs (history within rtol 1e-4,
    atol 1e-6) and the phase probe's fit and evaluation with the full
    design (W within 1e-5 of max |W|, every metric within 1e-4), on the
    card and on the CPU."""
    b = parse_bindings(str(files["bindings"]))
    fb = FeatureBuilder(b)
    out = {}
    for dev in ("cpu", "cuda"):
        model = frozen.load_frozen_model(files["ckpt"], dev)
        enc_t, enc_p, _ = frozen.make_encode_fns(model, fb)
        ds = {s: ForestDatasetV2(b, split=s, **SPLIT)
              for s in ("train", "val")}
        hist = train_probe.train_probe_pipeline(
            enc_t, fb, ds["train"], ds["val"], "infonce_type_spectral",
            epochs=2, batch_size=2, echo=lambda *_: None,
            device=dev)["history"]
        targets = frozen.make_phase_target_fn(fb, "phase_target")

        def enc_phase(batch, coords):
            ta, tm = targets(batch, coords)
            return enc_p(batch, coords), ta, tm

        kw = dict(halo=4, mask_fn=phase_probe.make_probe_mask_fn(fb),
                  device=dev)
        w, pre = phase_probe.fit_phase_probe(enc_t, enc_phase, ds["train"],
                                             **kw)
        metrics = phase_probe.evaluate_phase_probe(
            enc_t, enc_phase, ds["val"], w, pre, fb, "phase_target", **kw)
        out[dev] = (hist, w, metrics)
    (hc, wc, mc), (hg, wg, mg) = out["cpu"], out["cuda"]
    for a, r in zip(hg, hc):
        for k in r:
            np.testing.assert_allclose(a[k], r[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(wg, wc, rtol=0, atol=1e-5 * np.abs(wc).max())
    for k in ("r2_total", "mse_total", "r2_total_original",
              "r2_temporal_total", "variance_fraction_temporal_total"):
        assert abs(mg[k] - mc[k]) <= 1e-4 * max(1.0, abs(mc[k])), k
    assert mg["n_observations"] == mc["n_observations"] > 0


def _blobs(seed, k, d, n, noise=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([c + rng.normal(size=(n, d)) * (0.5 + 0.3 * i)
                        for i, c in enumerate(rng.normal(scale=4.0,
                                                         size=(k, d)))])
    if noise:
        lim = np.abs(x).max()
        x = np.concatenate([x, rng.uniform(-lim, lim, size=(noise, d))])
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("ct", ["diag", "full"])
def test_gmm_fit_on_the_card_matches_the_cpu(cuda_device, ct):
    """One seeded fit (k-means++ start, EM, 2 inits) on the card and on
    the CPU from the same host draws: labels and iterations equal,
    parameters within 1e-6 relative."""
    x = _blobs(18, 6, 8, 300)
    fits = [cl.GaussianMixture(6, covariance_type=ct, random_state=0,
                               n_init=2, device=dev).fit(x)
            for dev in ("cpu", cuda_device)]
    np.testing.assert_array_equal(fits[1].predict(x), fits[0].predict(x))
    assert fits[1].n_iter_ == fits[0].n_iter_
    for name in ("weights_", "means_", "covariances_"):
        np.testing.assert_allclose(getattr(fits[1], name),
                                   getattr(fits[0], name), rtol=1e-6,
                                   atol=1e-12, err_msg=name)


@pytest.mark.cuda
def test_kmeans_hdbscan_silhouette_on_the_card_match_the_cpu(cuda_device):
    x = _blobs(19, 5, 4, 200, noise=100)
    km = [cl.KMeans(5, n_init=10, random_state=1, device=dev).fit(x)
          for dev in ("cpu", cuda_device)]
    np.testing.assert_array_equal(km[1].labels_, km[0].labels_)
    np.testing.assert_allclose(km[1].cluster_centers_,
                               km[0].cluster_centers_, rtol=1e-6)
    hd = [cl.HDBSCAN(20, 20, device=dev).fit(x).labels_
          for dev in ("cpu", cuda_device)]
    np.testing.assert_array_equal(hd[1], hd[0])
    sil = [cl.silhouette_score(x, km[0].labels_, device=dev)
           for dev in ("cpu", cuda_device)]
    np.testing.assert_allclose(sil[1], sil[0], rtol=1e-10)
    q = np.random.default_rng(20).normal(size=(50, 4))
    kn = [cl.KNeighborsRegressor(7, weights="distance", device=dev)
          .fit(x, x[:, 0]).predict(q) for dev in ("cpu", cuda_device)]
    np.testing.assert_allclose(kn[1], kn[0], rtol=1e-10)


@pytest.mark.cuda
def test_clustering_clis_on_the_card_match_the_cpu(cuda_device, files,
                                                   tmp_path, capsys):
    """``eval.gmm`` (components 3 4) and ``eval.landscape_categories`` on
    the card and on the CPU: the same sample and best K, the labels equal
    up to a permutation (the type GMMs' on the CPU run's gmm sample), the
    same taxonomy sizes."""
    argv = _argv(files) + ["--split-block-size", "1", "1", "--batch-size",
                           "2"]
    out = {}
    for dev in ("cpu", "cuda"):
        capsys.readouterr()
        gmm.main(argv + ["--components", "3", "4", "--capacity", "5000",
                         "--output", str(tmp_path / f"{dev}.npz"),
                         "--device", dev])
        summary = json.loads(capsys.readouterr().out.splitlines()[-1])
        lc.main(argv + ["--k-type-min", "2", "--k-type-max", "4",
                        "--k-type-step", "1", "--min-cluster-pixels", "20",
                        "--output-dir", str(tmp_path / dev), "--device",
                        dev])
        with open(tmp_path / dev / "type_gmm.pkl", "rb") as f:
            type_gmm = pickle.load(f)["gmm"]
        out[dev] = (summary, np.load(tmp_path / f"{dev}.npz")["labels"],
                    json.loads((tmp_path / dev / "taxonomy.json")
                               .read_text()),
                    type_gmm.predict(np.load(tmp_path / "cpu.npz")["z_type"]))
    (sc, lcpu, tc, tlc), (sg, lgpu, tg, tlg) = out["cpu"], out["cuda"]
    assert sg["best_k"] == sc["best_k"] and sg["n_samples"] == sc["n_samples"]
    assert cl.normalized_mutual_info_score(lcpu, lgpu) == 1.0
    assert cl.normalized_mutual_info_score(tlc, tlg) == 1.0
    for k in ("k_type", "n_pixels_fit", "n_dynamic_clusters"):
        assert tg[k] == tc[k], k
    assert sorted(c["n_type_pixels"] for c in tg["clusters"].values()) == \
        sorted(c["n_type_pixels"] for c in tc["clusters"].values())
