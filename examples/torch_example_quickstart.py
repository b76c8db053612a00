"""Quickstart on the port: both pipelines end-to-end on synthetic cubes in a
temp dir.

The PyTorch counterpart of ``examples/example_quickstart.py``, with its
sizes and settings:

1. Legacy VQ-VAE pipeline: cube -> train -> export codebook.
2. FRL pipeline: v2 cube -> stats -> train -> linear probe.

Everything trains and encodes on ``--device`` (``cuda`` by default; it
raises where there is no card): on a card every VQ-VAE step runs the VQ
kernel and every FRL step the bank-mix kernels and the row scatter.

Run: python examples/torch_example_quickstart.py [--epochs 2]
     [--device cuda|cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # run from a checkout, not installed
    sys.path.insert(0, str(ROOT))
from forest_tpu_torch.data.loader import resolve_device  # noqa: E402

LINES = {
    "workdir": "workdir: {path}",
    "vqvae_head": "== VQ-VAE pipeline ==",
    "codebook": "codebook exported -> {path}",
    "frl_head": "== FRL pipeline ==",
    "probe": "probe R2 (val): {r2_val}",
    "ok": "quickstart OK",
}


def say(out: dict, key: str, **values) -> None:
    """Print ``LINES[key]`` filled with ``values`` and keep the values."""
    print(LINES[key].format(**values))
    out[key] = values


def vqvae_quickstart(root: Path, epochs: int, device, out: dict) -> None:
    from forest_tpu_torch.data.cube import build_synthetic_cube
    from forest_tpu_torch.eval import export_codebook
    from forest_tpu_torch.training import train_vqvae

    say(out, "vqvae_head")
    build_synthetic_cube(root / "cube.zarr", height=96, width=96,
                         chunk_yx=32, patch_size=32)
    cfg = train_vqvae.load_config(None, {})
    cfg.update(zarr=str(root / "cube.zarr"), run_dir=str(root / "run"),
               epochs=epochs, steps_per_epoch=10, batch_size=64,
               num_workers=4, block_size=(1, 1), min_hits_per_epoch=1,
               emb_dim=32, hidden=32, codebook_size=32, val_steps=2,
               device=str(device))
    result = train_vqvae.train(cfg)
    path = export_codebook.export(cfg["zarr"], cfg["run_dir"],
                                  device=device)
    say(out, "codebook", path=str(path))
    out["vqvae_history"] = result["history"]


def frl_quickstart(root: Path, epochs: int, device, out: dict) -> None:
    import yaml

    from forest_tpu_torch.data.cube_v2 import (build_synthetic_v2_cube,
                                               synthetic_bindings)
    from forest_tpu_torch.eval import frozen, linear_probe as lp
    from forest_tpu_torch.training import train_representation as tr
    from forest_tpu_torch.training.representation.training_config import (
        parse_training_config)

    say(out, "frl_head")
    build_synthetic_v2_cube(root / "v2.zarr", height=96, width=96,
                            chunk_yx=32)
    bpath = root / "bindings.yaml"
    bpath.write_text(yaml.safe_dump(synthetic_bindings(
        root / "v2.zarr", root / "stats.json")))
    cfg = parse_training_config({
        "run": {"experiment_name": "quickstart",
                "run_root": str(root / "runs")},
        "training": {"epoch": {"num_epochs": epochs, "mode": "full",
                               "batch_size": 4}},
        "optimizer": {"lr": 1e-3},
        "scheduler": {"warmup_epochs": 0, "phase_rewarmup": False},
        "spatial_domain": {"patch_size": 32, "split_block_size": [1, 1]},
        "hardware": {"num_workers": 2}})
    model_cfg = {"version": "4", "model": {
        "z_type_dim": 8, "z_phase_dim": 3,
        "type_encoder": {"channels": [16, 8]},
        "phase_tcn": {"channels": [12, 12], "dilations": [1, 2]}}}
    result = tr.train(cfg, str(bpath), model_cfg, max_batches=3,
                      device=device)
    # the port's module carries its trained parameters
    enc_t, _, _ = frozen.make_encode_fns(result["model"], result["fb"])
    probe = lp.fit_linear_probe(enc_t, result["fb"], result["ds_train"],
                                result["ds_val"], "infonce_type_spectral",
                                max_batches_train=3, max_batches_eval=2,
                                batch_size=2, device=device)
    say(out, "probe", r2_val=probe["r2_val"])
    out["frl_history"] = result["history"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    out: dict = {}
    root = Path(tempfile.mkdtemp(prefix="forest_tpu_torch_quickstart_"))
    say(out, "workdir", path=str(root))
    vqvae_quickstart(root / "vq", a.epochs, dev, out)
    frl_quickstart(root / "frl", a.epochs, dev, out)
    say(out, "ok")
    return out


if __name__ == "__main__":
    main()
