"""Embed point locations: coordinates CSV -> embedding columns CSV.

Port of ``forest_tpu/eval/embed_locations.py``: each point is mapped to
pixel coordinates, the patch around it is read and run through the frozen
encoder on the device, and one CSV row per point carries the column
families:

  pixel_row, pixel_col         zarr pixel coordinates
  split                        train/val/test (checkerboard partition)
  ysfc                         years-since-fast-change at the point's year
  evt                          EVT code (or -1)
  x_type_0..x_type_{C-1}       normalised type-encoder inputs at the pixel
  x_phase_0..x_phase_{C-1}     normalised phase inputs at the pixel + year
  z_type_0..z_type_{zt-1}      type embedding
  z_phase_0..z_phase_{zp-1}    phase embedding at the point's year
  g_type_0..g_type_{P-1}       projected type embedding (SimCLR g(h))

Points outside every patch get a row ``{"index": i, "valid": 0}``. Inputs
are (row, col) pixels or (x, y) map coordinates through the cube's affine
``geo_transform`` attr ``[x0, dx, y0, dy]``. A point's year maps to a
timestep through the dataset's configured time window; points without a
year (or outside the window) use the last timestep.

Run: python -m forest_tpu_torch.eval.embed_locations --locations pts.csv \
        --checkpoint CKPT --bindings B.yaml --output emb.csv [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from forest_tpu_torch.data import checkerboard
from forest_tpu_torch.eval.frozen import batch_to_device


def map_to_pixel(xs, ys, geo_transform) -> np.ndarray:
    """(x, y) map coords -> (row, col) via the affine [x0, dx, y0, dy]."""
    x0, dx, y0, dy = geo_transform
    col = np.round((np.asarray(xs) - x0) / dx).astype(np.int64)
    row = np.round((np.asarray(ys) - y0) / dy).astype(np.int64)
    return np.stack([row, col], axis=1)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def embed_locations(locations: np.ndarray, dataset, fb,
                    encode_type_fn: Callable,
                    encode_phase_fn: Optional[Callable] = None,
                    project_fn: Optional[Callable] = None,
                    patch_size: Optional[int] = None,
                    ysfc_source: str = "annual.ysfc",
                    evt_source: Optional[str] = None,
                    type_feature: str = "type_encoder_input",
                    phase_feature: str = "phase_ccdc",
                    years: Optional[Sequence] = None,
                    out_csv: Optional[str | Path] = None,
                    device="cuda") -> List[Dict]:
    """locations: [N, 2] (row, col) pixel coords; ``years``: optional
    per-point year. Reads each patch that holds a point once, encodes it on
    ``device`` and collects the rows (module docstring); writes the CSV
    when ``out_csv`` is given."""
    p = patch_size or dataset.patch_size
    # The patch's T axis is the configured time window (frl_dataset pads
    # each loaded year to temporal_window.year_to_index(year)), so a year
    # maps through the window, not through the cube's year positions.
    t_window = getattr(dataset, "temporal_window", None)
    rows_out: List[Dict] = []
    by_patch: Dict[tuple, List[int]] = {}
    for i, (r, c) in enumerate(np.asarray(locations)):
        by_patch.setdefault((int(r) // p, int(c) // p), []).append(i)

    patch_origin = {(w.row_start // p, w.col_start // p): j
                    for j, w in enumerate(dataset.patches)}

    for (pr, pc), idxs in by_patch.items():
        j = patch_origin.get((pr, pc))
        if j is None:
            rows_out.extend({"index": i, "valid": 0} for i in idxs)
            continue
        saved = dataset._current_indices
        dataset._current_indices = list(range(len(dataset.patches)))
        try:
            patch = dataset.get_patch(j)
        finally:
            dataset._current_indices = saved
        batch = batch_to_device({k: v[None] for k, v in patch.items()},
                                device)
        with torch.inference_mode():
            z_type = encode_type_fn(batch)[0]                # [H, W, zt]
            x_type = _host(fb.build_feature(type_feature, batch)[0][0])
            x_phase = _host(fb.build_feature(phase_feature, batch)[0][0])
        t_count = x_phase.shape[0]                           # [T, H, W, C]

        coords_local = np.asarray(
            [[int(locations[i][0]) - pr * p,
              int(locations[i][1]) - pc * p] for i in idxs])
        cj = torch.as_tensor(coords_local, device=z_type.device)
        z_sel = z_type[cj[:, 0], cj[:, 1]]
        z_pts = _host(z_sel)
        g_pts = _host(project_fn(z_sel)) if project_fn else z_pts
        zp_pts = (_host(encode_phase_fn(batch, cj)[0])       # [A, T, zp]
                  if encode_phase_fn is not None else None)

        gname, cname = ysfc_source.split(".")
        ysfc = patch[gname][..., fb.bindings.dataset[gname]
                            .channel_index(cname)]
        evt = None
        if evt_source:
            eg, ec = evt_source.split(".")
            evt = patch[eg][..., fb.bindings.dataset[eg].channel_index(ec)]

        split = {1: "train", 2: "val", 3: "test"}[int(
            checkerboard.split_code(pr * p, pc * p, p,
                                    dataset.split_block_size))]
        for n, i in enumerate(idxs):
            r, c = coords_local[n]
            # point year -> timestep index (default: the last). Years
            # outside the window keep the default; in-window years missing
            # from the cube land on their NaN-padded slot.
            ti = t_count - 1
            if years is not None and years[i] is not None \
                    and t_window is not None:
                yr = int(years[i])
                if t_window.start_year <= yr <= t_window.end_year:
                    ti = min(t_window.year_to_index(yr), t_count - 1)
            row: Dict = {
                "index": i, "valid": 1,
                "pixel_row": int(locations[i][0]),
                "pixel_col": int(locations[i][1]),
                "split": split,
                "ysfc": float(ysfc[ti, r, c] if ysfc.ndim == 3
                              else ysfc[r, c]),
            }
            if evt is not None:
                row["evt"] = int(evt[r, c]) if np.isfinite(evt[r, c]) \
                    else -1
            row.update({f"x_type_{d}": float(v)
                        for d, v in enumerate(x_type[r, c])})
            row.update({f"x_phase_{d}": float(v)
                        for d, v in enumerate(x_phase[ti, r, c])})
            row.update({f"z_type_{d}": float(v)
                        for d, v in enumerate(z_pts[n])})
            if zp_pts is not None:
                row.update({f"z_phase_{d}": float(v)
                            for d, v in enumerate(zp_pts[n, ti])})
            row.update({f"g_type_{d}": float(v)
                        for d, v in enumerate(g_pts[n])})
            rows_out.append(row)

    rows_out.sort(key=lambda r: r["index"])
    if out_csv:
        write_rows_csv(rows_out, out_csv)
    return rows_out


def write_rows_csv(rows: List[Dict], out_csv: str | Path) -> None:
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, restval="")
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--locations", required=True,
                    help="CSV with row,col[,year] or x,y[,year] columns")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--bindings", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--patch-size", type=int, default=128)
    ap.add_argument("--split-block-size", type=int, nargs=2, default=(4, 4))
    ap.add_argument("--map-coords", action="store_true",
                    help="locations are map x,y (uses the cube's "
                         "geo_transform attr)")
    ap.add_argument("--ysfc-source", default="annual.ysfc")
    ap.add_argument("--evt-source", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the encoder runs (default: cuda)")
    a = ap.parse_args(argv)

    device = frozen.resolve_device(a.device)
    bindings = parse_bindings(a.bindings)
    fb = FeatureBuilder(bindings)
    ds = ForestDatasetV2(bindings, split=None, patch_size=a.patch_size,
                         split_block_size=tuple(a.split_block_size),
                         min_aoi=0.0)
    model = frozen.load_frozen_model(a.checkpoint, device)
    enc_t, enc_p, proj = frozen.make_encode_fns(model, fb)

    with open(a.locations) as f:
        pts, years = [], []
        for rec in csv.DictReader(f):
            rec = {k.lower(): v for k, v in rec.items()}
            if a.map_coords:
                pts.append((float(rec["x"]), float(rec["y"])))
            else:
                pts.append((int(rec["row"]), int(rec["col"])))
            years.append(int(rec["year"]) if rec.get("year") else None)
    locs = np.asarray(pts)
    if a.map_coords:
        gt = ds.root.attrs.get("geo_transform")
        if gt is None:
            raise SystemExit("--map-coords needs a geo_transform cube attr")
        locs = map_to_pixel(locs[:, 0], locs[:, 1], gt)

    rows = embed_locations(
        locs, ds, fb, enc_t, enc_p, proj, ysfc_source=a.ysfc_source,
        evt_source=a.evt_source, years=years, out_csv=a.output,
        device=device)
    n_ok = sum(r.get("valid", 0) for r in rows)
    print(f"wrote {a.output}: {n_ok}/{len(rows)} points embedded")
    return rows


if __name__ == "__main__":
    main()


__all__ = ["embed_locations", "map_to_pixel", "write_rows_csv", "main"]
