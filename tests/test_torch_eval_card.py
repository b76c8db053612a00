"""The eval tools on the card against the same tools on the CPU.

Port only, since the card's machine has neither flax nor scikit-learn: the
fixture is
``torch_parity.write_port_eval_fixture`` (a 96 x 96 synthetic cube, two
tiny float32 checkpoints). On the card the smoothing kernel K1 runs; on the
CPU its plain version. TF32 is off (``torch_parity``). The clustering
estimators (``eval/cluster.py``) fit in float64 from the same host draws on
both. The diagnostics tools (``phase_diagnostics``, ``visualize``) and
an imported reference checkpoint run float32 models, K1 against its plain
version with sums in another order. Every test is marked ``cuda`` and skips
where there is no card.
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
from forest_tpu_torch.eval import phase_diagnostics as tpd
from forest_tpu_torch.eval import visualize as tvis
from forest_tpu_torch.utils import torch_import as tti
from torch_parity import (EVAL_CFG, EVAL_PATCH, cuda_device,  # noqa
                          eval_locations, read_csv, reference_state_dict,
                          write_port_eval_fixture)

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


@pytest.mark.cuda
def test_phase_diagnostics_on_the_card_matches_the_cpu(cuda_device, files,
                                                       tmp_path, capsys):
    """``phase_diagnostics --probe`` on the card and on the CPU: the same
    files, integer cells equal, every other cell within 1e-4 (float32
    models; the probe's float64 fit on embeddings 1e-6 apart)."""
    argv = _argv(files) + ["--split-block-size", "1", "1", "--n-patches",
                           "4", "--probe", "--probe-max-batches", "2"]
    for dev in ("cpu", "cuda"):
        tpd.main(argv + ["--out", str(tmp_path / dev), "--device", dev])
    names = sorted(p.name for p in (tmp_path / "cpu").iterdir())
    assert sorted(p.name for p in (tmp_path / "cuda").iterdir()) == names
    tables = [n for n in names if n.endswith(".csv")]
    assert len(tables) == 5
    for name in tables:
        cols, crows = read_csv(tmp_path / "cpu" / name)
        _, grows = read_csv(tmp_path / "cuda" / name)
        assert len(grows) == len(crows) > 0
        for c_, g_ in zip(crows, grows):
            for k in cols:
                if k.startswith(("evt_", "n_", "count", "total", "bin_",
                                 "ysfc_bin")):
                    assert g_[k] == c_[k], (name, k)
                else:
                    np.testing.assert_allclose(float(g_[k]), float(c_[k]),
                                               rtol=1e-4, atol=1e-4,
                                               err_msg=f"{name} {k}")
    sums = [json.loads((tmp_path / d / "summary.json").read_text())
            for d in ("cpu", "cuda")]
    for k in ("n_evt_classes", "n_pixels_total", "top_evt_codes"):
        assert sums[1][k] == sums[0][k], k


@pytest.mark.cuda
def test_visualize_on_the_card_matches_the_cpu(cuda_device, files, tmp_path,
                                               capsys):
    """The records behind the sheets from the same probe weights on the
    card and on the CPU within 1e-5, the gate forward too; the CLI with
    ``--probe --forest-diag`` runs to its end on the card."""
    fb = FeatureBuilder(parse_bindings(str(files["bindings"])))
    ds = ForestDatasetV2(fb.bindings, split="test", **SPLIT)
    rng = np.random.default_rng(8)
    c = len(fb.bindings.get_feature("infonce_type_spectral").channels)
    w_lin = rng.normal(scale=0.3, size=(9, c))
    pre = phase_probe.PhaseProbePreprocessor(
        "full", 8, 3, rng.normal(scale=0.2, size=35), 0.5 + rng.random(35),
        np.linalg.qr(rng.normal(size=(24, 4)))[0])
    w_phase = rng.normal(scale=0.05, size=(16, 2))
    out = {}
    for dev in ("cpu", cuda_device):
        model = frozen.load_frozen_model(files["ckpt"], dev)
        enc_t, enc_p, _ = frozen.make_encode_fns(model, fb)
        gate = tvis.make_encode_gate(model, fb)(
            frozen.batch_to_device(ds.load_batch([0]), dev))
        out[str(dev)] = (
            tvis.collect_patch_records(enc_t, fb, ds, "infonce_type_spectral",
                                       w_lin, 2, device=dev),
            tvis.collect_forest_diag_records(enc_t, enc_p, fb, ds, [1, 0],
                                             w_phase, pre, "phase_target",
                                             device=dev),
            [t.cpu().numpy() for t in gate])
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    for recs_c, recs_g in zip(cpu[:2], gpu[:2]):
        for rc, rg in zip(recs_c, recs_g):
            for k, v in rc.items():
                if isinstance(v, np.ndarray) and v.dtype != bool:
                    np.testing.assert_allclose(rg[k], v, rtol=1e-5,
                                               atol=1e-5, err_msg=k)
                elif isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(rg[k], v, err_msg=k)
    for g_, c_ in zip(gpu[2], cpu[2]):
        np.testing.assert_allclose(g_, c_, rtol=1e-5, atol=1e-5)
    tvis.main(_argv(files) + ["--out", str(tmp_path), "--split-block-size",
                              "1", "1", "--n", "2", "--probe",
                              "--forest-diag"])
    assert "figures to" in capsys.readouterr().out


@pytest.mark.cuda
def test_reference_import_on_the_card(cuda_device, tmp_path):
    """A reference checkpoint (synthetic state_dict under the reference's
    key names) through the importer's CLI, loaded on the card: z_type and
    z_phase of a seeded patch within 1e-5 of the same file on the CPU."""
    import torch
    sd = reference_state_dict(np.random.default_rng(9), EVAL_CFG, 4, 3)
    torch.save({"model_state_dict": {k: torch.from_numpy(np.asarray(v))
                                     for k, v in sd.items()},
                "model_config": EVAL_CFG, "type_in_channels": 4,
                "phase_in_channels": 3}, tmp_path / "ref.pt")
    tti.main(["--checkpoint", str(tmp_path / "ref.pt"), "--output",
              str(tmp_path / "imported.msgpack")])
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 4)).astype(np.float32))
    px = torch.from_numpy(rng.normal(size=(9, 15, 3)).astype(np.float32))
    res = []
    for dev in ("cpu", cuda_device):
        model = frozen.load_frozen_model(tmp_path / "imported.msgpack", dev)
        with torch.inference_mode():
            zt = model(x.to(dev))
            zp = model.forward_phase_at_locations(px.to(dev), zt[0, 0, :9])
        res.append([zt.cpu().numpy(), zp.cpu().numpy()])
    for g_, c_ in zip(res[1], res[0]):
        assert np.isfinite(g_).all()
        np.testing.assert_allclose(g_, c_, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_hdbscan_on_the_card_in_linear_memory(cuda_device):
    """12,000 points in 56 dimensions, min 40: the labels equal the CPU's,
    and the card's peak allocation stays below 1 GB, where the dense
    mutual reachability alone would take 8 N^2 bytes (1.15 GB, three such
    matrices in the old fit)."""
    import torch
    rng = np.random.default_rng(11)
    x = np.concatenate([c + rng.normal(size=(3000, 56))
                        for c in rng.normal(scale=6.0, size=(4, 56))])
    cpu = cl.HDBSCAN(40, 40, device="cpu").fit(x).labels_
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gpu = cl.HDBSCAN(40, 40, device=cuda_device).fit(x).labels_
    peak = torch.cuda.max_memory_allocated() - base
    np.testing.assert_array_equal(gpu, cpu)
    assert len(set(gpu.tolist()) - {-1}) == 4
    assert peak < 1 << 30, peak
