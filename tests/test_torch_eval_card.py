"""The eval tools on the card against the same tools on the CPU.

Port only, since the card's machine has no flax: the fixture is
``torch_parity.write_port_eval_fixture`` (a 96 x 96 synthetic cube, two
tiny float32 checkpoints). On the card the smoothing kernel K1 runs; on the
CPU its plain version. TF32 is off (``torch_parity``). Every test is
marked ``cuda`` and skips where there is no card.
"""
import numpy as np
import pytest

from forest_tpu_torch.data import parse_bindings
from forest_tpu_torch.data import zarrlite as zl
from forest_tpu_torch.data.feature_builder import FeatureBuilder
from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
from forest_tpu_torch.eval import embed_locations as tel
from forest_tpu_torch.eval import export_embeddings as tee
from forest_tpu_torch.eval import frozen, phase_probe, train_probe
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
