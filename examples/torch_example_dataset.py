"""Dataset + feature-builder walkthrough on a synthetic cube, on the port.

The PyTorch counterpart of ``examples/example_dataset.py``: the same cube,
the same steps and the same printed lines, with the statistics and the
features computed on ``--device`` (``cuda`` by default; it raises where
there is no card).

Run: python examples/torch_example_dataset.py [--device cuda|cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # run from a checkout, not installed
    sys.path.insert(0, str(ROOT))
from forest_tpu_torch.data.loader import resolve_device  # noqa: E402

LINES = {
    "cube_head": "== cube ==",
    "cube": "cube: {path}",
    "summary": "{line}",
    "dataset_head": "== dataset ==",
    "split": "  {split}: {patches} patches",
    "groups": "  groups: {groups}",
    "stats_head": "== stats ==",
    "elevation": "  elevation: mean={mean:.1f} sd={sd:.1f} q50={q50:.1f}",
    "features_head": "== features ==",
    "type": "  type_encoder_input: {shape}, {valid_pct:.0f}% valid",
    "phase": "  phase_ccdc (whitened): {shape}, |max|={max_abs:.2f} (clip 5)",
    "locations": "  at-locations == full grid: {equal}",
}


def say(out: dict, key: str, many: bool = False, **values) -> None:
    """Print ``LINES[key]`` filled with ``values`` and keep the values (a
    list of them for a line printed once per item)."""
    print(LINES[key].format(**values))
    if many:
        out.setdefault(key, []).append(values)
    else:
        out[key] = values


def main(argv=None) -> dict:
    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.cube_v2 import (build_synthetic_v2_cube,
                                               synthetic_bindings)
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.data.stats import StatsCalculator
    from forest_tpu_torch.data.zarr_info import summarize

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    out: dict = {}
    td = Path(tempfile.mkdtemp())
    build_synthetic_v2_cube(td / "cube.zarr", height=96, width=96,
                            chunk_yx=32)
    say(out, "cube_head")
    summary = summarize(td / "cube.zarr", device=dev).split("files:")[0]
    for line in summary.split("\n"):
        if line.startswith("cube: "):
            say(out, "cube", path=line[len("cube: "):])
        else:
            say(out, "summary", many=True, line=line)

    bindings = parse_bindings(synthetic_bindings(td / "cube.zarr",
                                                 td / "stats.json"))
    say(out, "dataset_head")
    for split in ("train", "val", "test"):
        ds = ForestDatasetV2(bindings, split=split, patch_size=32,
                             split_block_size=(1, 1))
        say(out, "split", many=True, split=split, patches=len(ds.patches))

    ds = ForestDatasetV2(bindings, split=None, patch_size=32,
                         split_block_size=(1, 1))
    patch = ds.get_patch(0)
    say(out, "groups", groups={k: v.shape for k, v in patch.items()
                               if not k.startswith("__")})

    say(out, "stats_head")
    stats = StatsCalculator(bindings, ds, device=dev).compute(n_patches=4)
    e = stats["type_encoder_input"]["static.elevation"]
    say(out, "elevation", mean=e["mean"], sd=e["sd"], q50=e["q50"])

    say(out, "features_head")
    fb = FeatureBuilder(bindings, stats)
    on_dev = {k: torch.as_tensor(v, device=dev) for k, v in patch.items()
              if not k.startswith("__")}
    x, mask = fb.build_feature("type_encoder_input", on_dev)
    say(out, "type", shape=tuple(x.shape),
        valid_pct=float(mask.float().mean()) * 100)
    px, _ = fb.build_feature("phase_ccdc", on_dev)
    say(out, "phase", shape=tuple(px.shape), max_abs=float(px.abs().max()))
    coords = np.asarray([[8, 8], [16, 24]])
    # the port's builder is batched: one patch is a batch of one
    loc, _ = fb.build_feature_at_locations(
        "phase_ccdc", {k: v[None] for k, v in on_dev.items()},
        torch.as_tensor(coords, device=dev)[None])
    px_host = px.cpu().numpy()
    full_at = np.stack([px_host[:, r, c] for r, c in coords])
    say(out, "locations", equal=bool(np.allclose(loc[0].cpu().numpy(),
                                                 full_at, atol=1e-6)))
    out["stats"] = stats
    return out


if __name__ == "__main__":
    main()
