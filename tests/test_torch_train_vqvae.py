"""End to end on the CPU: synthetic cube -> schema -> the port's train CLI ->
resume -> export, at the size of tests/test_train_vqvae_e2e.py; the run
directory the port wrote is then exported by the JAX package too, and the
two exports agree.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from forest_tpu.eval import export_codebook as jexport
from forest_tpu_torch.data.cube import build_synthetic_cube
from forest_tpu_torch.eval import export_codebook
from forest_tpu_torch.ops import vq
from forest_tpu_torch.training import train_vqvae

SMALL = dict(epochs=2, steps_per_epoch=8, batch_size=64, num_workers=2,
             block_size=(1, 1), min_hits_per_epoch=1, val_steps=2,
             emb_dim=16, hidden=32, codebook_size=16, eager=True,
             device="cpu")


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    build_synthetic_cube(root / "cube.zarr", height=96, width=96,
                         chunk_yx=32, patch_size=32, seed=0)
    cfg = train_vqvae.load_config(None, {})
    cfg.update(zarr=str(root / "cube.zarr"), run_dir=str(root / "run"),
               **SMALL)
    launches = vq.vq_core.launches
    result = train_vqvae.train(cfg)
    assert vq.vq_core.launches == launches      # CPU: the plain version
    return root, cfg, result


def test_history_metrics_and_checkpoints(trained_run):
    root, cfg, result = trained_run
    hist = json.loads((root / "run" / "history.json").read_text())
    assert [h["epoch"] for h in hist] == [0, 1]
    for h in hist:
        for key in ("train/loss_total", "train/loss_cont", "train/loss_cat",
                    "train/loss_canopy", "train/loss_vq", "train/perplexity",
                    "train/grad_norm", "train/cat/cat_0", "val/loss_total",
                    "val/perplexity", "epoch_time_s", "wait_s", "step_s",
                    "steps_per_s"):
            assert np.isfinite(h[key]), key
        assert h["train/perplexity"] >= 1.0
    ckpt = root / "run" / "ckpt"
    for name in ("ckpt_last", "ckpt_best_0", "ckpt_epoch_000",
                 "ckpt_epoch_001"):
        assert (ckpt / f"{name}.msgpack").exists(), name
        assert (ckpt / f"{name}.msgpack.json").exists(), name
    meta = json.loads((ckpt / "ckpt_last.msgpack.json").read_text())
    assert meta["epoch"] == 1 and meta["model_version"] == "vqvae-1"
    assert meta["model_config"]["codebook_size"] == 16
    state = result["state"]
    assert state.step == 16 and state.count == 16
    assert float(state.vq_stats.code_usage.sum()) == 16 * 64
    assert (root / "run" / "schema.json").exists()
    assert json.loads((root / "run" / "config.json").read_text())[
        "device"] == "cpu"


def test_auto_resume_continues_and_no_resume_restarts(trained_run, tmp_path):
    root, cfg, _ = trained_run
    run2 = tmp_path / "run_copy"
    shutil.copytree(root / "run", run2)
    result = train_vqvae.train(dict(cfg, epochs=3, run_dir=str(run2)))
    hist = json.loads((run2 / "history.json").read_text())
    assert [h["epoch"] for h in hist] == [2]    # only the new epoch trains
    assert result["state"].step == 24
    assert float(result["state"].vq_stats.code_usage.sum()) == 24 * 64
    result = train_vqvae.train(dict(cfg, epochs=1, run_dir=str(run2),
                                    no_resume=True))
    assert [h["epoch"] for h in result["history"]] == [0]
    assert result["state"].step == 8


def test_export_codebook_and_the_jax_export_of_the_same_run(trained_run,
                                                            tmp_path):
    root, cfg, _ = trained_run
    out = export_codebook.export(cfg["zarr"], cfg["run_dir"], write_csv=True,
                                 device="cpu")
    z = np.load(out, allow_pickle=False)
    K, T = 16, 5
    assert z["cont"].shape == (K * T, 8)
    assert z["cats"].shape == (K * T, 2)
    assert z["summary"].shape == (K, 3)
    assert z["usage"].sum() == 16 * 64
    assert list(z["code_id"][:6]) == [0, 0, 0, 0, 0, 1]
    assert list(z["year"][:5]) == list(z["years"])
    assert out.with_suffix(".csv").exists()
    assert out.with_name("code_summary.csv").exists()
    # the JAX package reads the port's checkpoint and decodes the same
    theirs = np.load(jexport.export(cfg["zarr"], cfg["run_dir"],
                                    out=str(tmp_path / "jax_export.npz")),
                     allow_pickle=False)
    assert sorted(theirs.files) == sorted(z.files)
    for k in ("cont", "canopy", "summary"):
        np.testing.assert_allclose(z[k], theirs[k], rtol=1e-5, atol=1e-5)
    for k in ("cats", "code_id", "year", "usage", "years"):
        np.testing.assert_array_equal(z[k], theirs[k])


def test_export_cli_takes_a_device_and_defaults_to_the_card(trained_run,
                                                           tmp_path):
    root, cfg, _ = trained_run
    out = tmp_path / "cli_export.npz"
    export_codebook.main(["--zarr", cfg["zarr"], "--run-dir", cfg["run_dir"],
                          "--out", str(out), "--device", "cpu"])
    z = np.load(out, allow_pickle=False)
    ref = np.load(export_codebook.export(cfg["zarr"], cfg["run_dir"],
                                         out=str(tmp_path / "ref.npz"),
                                         device="cpu"), allow_pickle=False)
    for k in ref.files:
        np.testing.assert_array_equal(z[k], ref[k])
    assert export_codebook.export.__defaults__[-1] == "cuda"
    assert export_codebook.decode_codebook_sequences.__defaults__ == \
        ("cuda",)


def test_export_on_cuda_without_a_card_raises(trained_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the export runs there")
    root, cfg, _ = trained_run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_codebook.export(cfg["zarr"], cfg["run_dir"],
                               out=str(tmp_path / "x.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_codebook.main(["--zarr", cfg["zarr"], "--run-dir",
                              cfg["run_dir"], "--out",
                              str(tmp_path / "y.npz")])
    assert not (tmp_path / "x.npz").exists()


def test_cli_main_trains_the_st_quantizer_under_max_steps(trained_run,
                                                          tmp_path):
    root, _, _ = trained_run
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(
        "train_vqvae:\n  emb_dim: 16\n  hidden: 32\n  codebook_size: 16\n"
        "  block_size: [1, 1]\n  min_hits_per_epoch: 1\n  val_steps: 1\n"
        "  num_workers: 2\n")
    train_vqvae.main(["--config", str(cfg_path), "--zarr",
                      str(root / "cube.zarr"), "--run-dir",
                      str(tmp_path / "run"), "--epochs", "3",
                      "--steps-per-epoch", "4", "--max-steps", "6",
                      "--quantizer", "st", "--device", "cpu"])
    hist = json.loads((tmp_path / "run" / "history.json").read_text())
    assert [h["epoch"] for h in hist] == [0, 1]     # 4 + 2 steps
    assert np.isfinite(hist[-1]["train/loss_total"])
    with pytest.raises(SystemExit):
        train_vqvae.main(["--device", "cpu"])


@pytest.mark.parametrize("option,match", [
    pytest.param({"steps_per_dispatch": 4, "data_parallel": True,
                  "device": "cuda"}, "one process per card",
                 id="option0-steps_per_dispatch"),
    pytest.param({"wire_compact": True, "data_parallel": True,
                  "device": "cuda"}, "one process per card",
                 id="option1-wire_compact"),
    pytest.param({"data_parallel": True, "device": "cuda"},
                 "one process per card: python -m torch.distributed.run "
                 "--nproc_per_node 2", id="option2-queue 6")])
def test_unported_options_are_refused_not_ignored(tmp_path, monkeypatch,
                                                  option, match):
    """``data_parallel`` is ported (tests/test_torch_parallel.py): in one
    process over several cards it has no one-process form and raises with
    the torchrun command, before any write. ``steps_per_dispatch`` and
    ``wire_compact`` are ported too (tests/test_torch_scan_steps.py,
    tests/test_torch_wire.py): they are no longer refused, and with them
    set the same one-process refusal is what raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = train_vqvae.load_config(None, {})
    cfg.update(zarr=str(tmp_path / "none.zarr"), run_dir=str(tmp_path / "r"),
               **SMALL)
    cfg.update(option)
    with pytest.raises(RuntimeError, match=match):
        train_vqvae.train(cfg)
    assert not (tmp_path / "r").exists()
    assert "NotImplementedError" not in Path(
        train_vqvae.__file__).read_text()


def test_the_default_device_is_the_card():
    assert train_vqvae.DEFAULTS["device"] == "cuda"
    assert train_vqvae.load_config(None, {"device": None})["device"] == "cuda"
    assert train_vqvae.host_to_device_batch.__defaults__[0] == "cuda"
