"""REQUIRED pipeline step on the port: compute the stats JSON for a
bindings config.

The PyTorch counterpart of ``examples/example_compute_stats.py``: run AFTER
building a cube and BEFORE training so FeatureBuilder has its
normalization stats and whitening covariances. The statistics are computed
on ``--device`` (``cuda`` by default; it raises where there is no card).

Usage:
  python examples/torch_example_compute_stats.py --bindings B.yaml \
      [--patch-size 256] [--n-patches 500] [--device cuda|cpu]

With no --bindings it demos the full flow on a synthetic cube in a temp dir.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # run from a checkout, not installed
    sys.path.insert(0, str(ROOT))
from forest_tpu_torch.data.loader import resolve_device  # noqa: E402

LINES = {
    "demo": "[demo] building synthetic cube in {path}",
    "wrote": "wrote {path}",
    "feature": "  {name}: {channels} channels {cov}",
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
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.data.stats import StatsCalculator

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bindings", default=None)
    ap.add_argument("--patch-size", type=int, default=256)
    ap.add_argument("--n-patches", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    out: dict = {}
    if a.bindings:
        bindings = parse_bindings(a.bindings)
        patch = a.patch_size
    else:
        from forest_tpu_torch.data.cube_v2 import (build_synthetic_v2_cube,
                                                   synthetic_bindings)
        td = Path(tempfile.mkdtemp())
        say(out, "demo", path=str(td))
        build_synthetic_v2_cube(td / "cube.zarr", height=96, width=96,
                                chunk_yx=32)
        bindings = parse_bindings(synthetic_bindings(td / "cube.zarr",
                                                     td / "stats.json"))
        patch = 32

    ds = ForestDatasetV2(bindings, split=None, patch_size=patch,
                         split_block_size=(1, 1))
    calc = StatsCalculator(bindings, ds, device=dev)
    path = calc.compute_and_save(a.n_patches)
    say(out, "wrote", path=str(path))
    stats = json.loads(Path(path).read_text())
    for fname, entries in stats.items():
        chans = [k for k in entries if not k.startswith("__")]
        cov = "with covariance" if "__covariance__" in entries else ""
        say(out, "feature", many=True, name=fname, channels=len(chans),
            cov=cov)
    out["patches"] = len(ds)
    out["stats"] = stats
    return out


if __name__ == "__main__":
    main()
