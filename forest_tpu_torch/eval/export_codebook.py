"""Codebook export: decode every code to original units.

Port of ``forest_tpu/eval/export_codebook.py`` (it runs no kernel: the
decoder is a handful of small dense layers, evaluated on ``device``, the
card unless the caller asks for the CPU): decode all K codebook entries as
length-T sequences, de-normalize continuous channels via the dataset's cont
stats, argmax categorical heads back to raw codes via the schema's
dense->raw maps (NaN for MISS/UNK), attach cumulative code usage from the
train state, and write NPZ + optional CSVs.

Run: python -m forest_tpu_torch.eval.export_codebook --run-dir RUN --zarr CUBE \
         [--out OUT.npz] [--csv] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

import torch

from forest_tpu_torch.data.vqvae_dataset import VQVAEDataset
from forest_tpu_torch.models.vqvae import VQVAE
from forest_tpu_torch.training.checkpointing import load_state_raw
from forest_tpu_torch.utils.flax_bridge import params_from_flax


class RestoredState:
    """Inference-time view of a checkpoint: params + vq_stats only."""

    def __init__(self, raw: dict):
        self.params = raw["params"]
        vs = raw.get("vq_stats", {})
        self.vq_stats = type("VS", (), {
            "cluster_size": np.asarray(vs.get("cluster_size", [])),
            "cluster_sum": np.asarray(vs.get("cluster_sum", [])),
            "code_usage": np.asarray(vs.get("code_usage", [])),
        })()


def load_model_and_ds(zarr_path: str, run_dir: str,
                      ckpt_name: str = "ckpt_last.msgpack",
                      split=None) -> Tuple[VQVAE, RestoredState,
                                           VQVAEDataset, dict]:
    run_dir = Path(run_dir)
    ds = VQVAEDataset(zarr_path, run_dir / "schema.json", split=split)
    raw, meta = load_state_raw(run_dir / "ckpt" / ckpt_name)
    mc = dict(meta["model_config"])
    mc["cat_vocab_sizes"] = {k: int(v)
                             for k, v in mc["cat_vocab_sizes"].items()}
    model = VQVAE(**mc)
    return model, RestoredState(raw), ds, meta


def decode_codebook_sequences(model: VQVAE, params, device="cuda") -> Tuple[
        np.ndarray, Dict[str, np.ndarray], np.ndarray]:
    """``params``: the flax-layout tree of a checkpoint of either
    package. The model is moved to ``device`` and decodes there; without a
    card, ``"cuda"`` raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("export_codebook: no CUDA device; pass "
                           "device='cpu' (--device cpu) to decode on the CPU")
    model.load_state_dict(params_from_flax(params), strict=True)
    model.to(device)
    with torch.no_grad():
        cont, cat_logits, canopy = model.decode_codebook()
    return (cont.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in cat_logits.items()},
            canopy.cpu().numpy())


def denorm_continuous_KTC(cont_pred: np.ndarray, cont_names,
                          cont_stats: Dict[str, dict]) -> np.ndarray:
    mean = np.array([cont_stats[n]["mean"] for n in cont_names], np.float32)
    std = np.array([cont_stats[n]["std"] for n in cont_names], np.float32)
    return cont_pred * std + mean


def decode_cats_KTC(cat_logits: Dict[str, np.ndarray],
                    cat_names, cat_maps: Dict[str, np.ndarray]) -> np.ndarray:
    """Argmax each head -> raw codes; MISS/UNK decode to NaN. [K, T, Ncat]."""
    cols = []
    for n in cat_names:
        dense = cat_logits[n].argmax(-1)  # [K, T]
        raw = cat_maps[n][dense].astype(np.float64)
        raw[dense < 2] = np.nan
        cols.append(raw)
    return np.stack(cols, axis=-1)


def flatten_to_KT(x_KTC: np.ndarray, years: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[K,T,C] -> ([K*T, C], code_id [K*T], year [K*T])."""
    k, t, c = x_KTC.shape
    flat = x_KTC.reshape(k * t, c)
    code_id = np.repeat(np.arange(k, dtype=np.int32), t)
    year = np.tile(np.asarray(years, np.int32), k)
    return flat, code_id, year


def extract_code_usage_from_state(state) -> np.ndarray:
    return np.asarray(state.vq_stats.code_usage)


def code_summary(usage: np.ndarray, canopy: np.ndarray) -> np.ndarray:
    k = usage.shape[0]
    return np.stack([np.arange(k, dtype=np.float64),
                     usage.astype(np.float64),
                     canopy.astype(np.float64)], axis=1)


def export(zarr_path: str, run_dir: str, out: str = None,
           write_csv: bool = False, device="cuda") -> Path:
    model, state, ds, meta = load_model_and_ds(zarr_path, run_dir)
    years = np.asarray(ds.ds["years"])
    cont, cat_logits, canopy = decode_codebook_sequences(model, state.params,
                                                         device)
    cont_dn = denorm_continuous_KTC(cont, ds.cont_names, ds.cont_stats)
    cont_KT, code_id, year = flatten_to_KT(cont_dn, years)
    cats = decode_cats_KTC(cat_logits, ds.cat_names, ds.cat_maps)
    cats_KT, _, _ = flatten_to_KT(cats, years)
    usage = extract_code_usage_from_state(state)
    summary = code_summary(usage, canopy)

    out = Path(out or (Path(run_dir) / "codebook_export.npz"))
    np.savez_compressed(
        out, cont=cont_KT, cats=cats_KT, code_id=code_id, year=year,
        canopy=canopy, usage=usage, summary=summary,
        cont_names=np.array(ds.cont_names), cat_names=np.array(ds.cat_names),
        years=years)
    if write_csv:
        import csv
        with open(out.with_suffix(".csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["code_id", "year"] + list(ds.cont_names)
                       + list(ds.cat_names))
            for i in range(cont_KT.shape[0]):
                w.writerow([int(code_id[i]), int(year[i])]
                           + list(cont_KT[i]) + list(cats_KT[i]))
        with open(out.with_name("code_summary.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["code_id", "usage", "canopy"])
            w.writerows(summary.tolist())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--zarr", required=True)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the decoder runs (default: cuda)")
    a = ap.parse_args(argv)
    p = export(a.zarr, a.run_dir, a.out, a.csv, a.device)
    print(f"wrote {p}")


if __name__ == "__main__":
    main()
