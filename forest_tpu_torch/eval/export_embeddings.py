"""Dense embedding export: the frozen encoder over every patch -> a zarr
cube of embeddings.

Port of ``forest_tpu/eval/export_embeddings.py``: every patch of a
(split=None) dataset goes through the frozen type encoder (and, with
``--phase``, the dense phase path) on the device, and ``z_type [H, W, zt]``
(and ``z_phase [T, H, W, zp]``) are written as float16 into a chunked zarr
aligned to the source cube. Host decode of batch i+1 (``PrefetchLoader``),
the device's work on batch i and the copy back and zarr write of batch i-1
(one writer thread, at most two batches in flight) overlap. The cast to
float16 happens on the device, before the copy to the host. The dense phase
path takes the ``z_type`` the type path already computed (the JAX tool
computes it again; the outputs are the same). Arrays are created through the
port's ``zarrlite``, whose default compressor is ``writer_compressor()``
(blosc-LZ4 where libblosc loads, zlib elsewhere).

Run: python -m forest_tpu_torch.eval.export_embeddings --checkpoint CKPT \
         --bindings B.yaml --out EMB.zarr [--patch-size 256] [--phase] \
         [--device cuda]
"""
from __future__ import annotations

import argparse
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from forest_tpu_torch.data import zarrlite as zl
from forest_tpu_torch.data.loader import PrefetchLoader
from forest_tpu_torch.eval.frozen import batch_to_device


def export_embeddings(encode_type_fn: Callable, dataset,
                      out_path: str | Path, z_dim: int, batch_size: int = 4,
                      encode_phase_dense_fn: Optional[Callable] = None,
                      z_phase_dim: Optional[int] = None,
                      num_timesteps: Optional[int] = None,
                      needed_features: Optional[list] = None,
                      device="cuda") -> zl.ZarrGroup:
    """``encode_phase_dense_fn(batch, z_type) -> [B, T, H, W, zp]``.
    ``needed_features``: the features the encode fns build; when given,
    only the dataset groups they read are copied to the device."""
    keep = (dataset.bindings.groups_for_features(needed_features)
            if needed_features else None)
    h, w = dataset.height, dataset.width
    p = dataset.patch_size
    # Never write into an existing cube: zarrlite rewrites only metadata, so
    # stale chunk files of an earlier run (maybe on another chunk grid)
    # would read back as embeddings.
    out_path = Path(out_path)
    if (out_path / ".zgroup").exists():
        raise FileExistsError(
            f"{out_path} already holds a zarr group; remove it (or pick a "
            "new --out) before re-exporting -- stale chunks from an old "
            "run would silently mix into the new embedding cube")
    root = zl.create_group(out_path)
    root.attrs["source_cube"] = str(dataset.bindings.zarr_path)
    root.attrs["z_type_dim"] = int(z_dim)
    root.write_attrs()
    zt_arr = root.create_array("z_type", (h, w, z_dim), (p, p, z_dim),
                               np.float16, fill_value=float("nan"))
    zp_arr = None
    if encode_phase_dense_fn is not None:
        zp_arr = root.create_array(
            "z_phase", (num_timesteps, h, w, z_phase_dim),
            (1, p, p, z_phase_dim), np.float16, fill_value=float("nan"))

    saved = dataset._current_indices
    dataset._current_indices = list(range(len(dataset.patches)))
    try:
        n = len(dataset.patches)
        batches = [list(range(i, min(i + batch_size, n)))
                   for i in range(0, n, batch_size)]
        loader = PrefetchLoader(dataset, iter(batches), num_workers=2,
                                prefetch=2)
        writer = ThreadPoolExecutor(max_workers=1)
        try:
            futures: deque = deque()
            for idx, host_batch in zip(batches, loader):
                batch = batch_to_device(host_batch, device, keep)
                with torch.inference_mode():
                    zt = encode_type_fn(batch)
                    zp = (encode_phase_dense_fn(batch, zt).half()
                          if encode_phase_dense_fn is not None else None)
                    z = zt.half()
                futures.append(writer.submit(
                    _drain, (idx, z, zp), dataset, zt_arr, zp_arr))
                while len(futures) > 2:
                    futures.popleft().result()
            while futures:
                futures.popleft().result()
        finally:
            writer.shutdown(wait=False, cancel_futures=True)
            loader.close()
    finally:
        dataset._current_indices = saved
    return root


def _drain(item, dataset, zt_arr, zp_arr) -> None:
    """Copy one batch's float16 embeddings to the host and write each
    patch's window (ragged border patches cut to the cube)."""
    idx, z, zp = item
    z = z.cpu().numpy()
    if zp is not None:
        zp = zp.cpu().numpy()
    for k, j in enumerate(idx):
        win = dataset.patches[j]
        zt_arr[win.row_slice, win.col_slice] = z[k, :win.height, :win.width]
        if zp is not None:
            zp_arr[:, win.row_slice, win.col_slice] = \
                zp[k, :, :win.height, :win.width]


def make_encode_phase_dense(model, fb, phase_feature: str = "phase_ccdc"
                            ) -> Callable:
    """-> fn(batch, z_type) -> z_phase [B, T, H, W, zp]: the dense phase
    path (``forward_phase``) on the z_type already computed."""

    @torch.inference_mode()
    def encode(batch, z_type):
        px, _ = fb.build_feature(phase_feature, batch)
        return model.forward_phase(px, z_type)

    return encode


def main(argv=None):
    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--bindings", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--patch-size", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--phase", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the encoder runs (default: cuda)")
    a = ap.parse_args(argv)

    device = frozen.resolve_device(a.device)
    bindings = parse_bindings(a.bindings)
    ds = ForestDatasetV2(bindings, split=None, patch_size=a.patch_size)
    fb = FeatureBuilder(bindings)
    model = frozen.load_frozen_model(a.checkpoint, device)
    enc_t, _, _ = frozen.make_encode_fns(model, fb)
    feats = ["type_encoder_input"]
    enc_p_dense = None
    if a.phase:
        enc_p_dense = make_encode_phase_dense(model, fb)
        feats.append("phase_ccdc")
    root = export_embeddings(
        enc_t, ds, a.out, model.z_type_dim, a.batch_size, enc_p_dense,
        model.z_phase_dim, bindings.time_window.num_years,
        needed_features=feats, device=device)
    print(f"wrote {root.path}")
    return root


if __name__ == "__main__":
    main()


__all__ = ["export_embeddings", "make_encode_phase_dense", "main"]
