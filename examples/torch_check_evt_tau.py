"""EVT temperature calibration on the port: sweep tau over the
diffusion-distance distribution.

The PyTorch counterpart of ``examples/check_evt_tau.py``, with the same
synthetic table (``np.random.default_rng(0)``) and the same printed lines.
The metric and the sweep are host numpy in both packages; ``--device`` is
resolved as every entry point of the port resolves it (``cuda`` raises
where there is no card).

Run: python examples/torch_check_evt_tau.py [--confusion CSV --counts JSON]
     [--device cuda|cpu]
With no --confusion it demos on a synthetic confusion table.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # run from a checkout, not installed
    sys.path.insert(0, str(ROOT))
from forest_tpu_torch.data.loader import resolve_device  # noqa: E402

LINES = {
    "demo": "[demo] synthetic confusion table with {k} codes",
    "codes": "codes: {k}   log(K-1) = {log_k1:.3f} (uniform entropy)",
    "header": "tau    mean row entropy of softmax(-d_ref/tau)",
    "sweep": "{tau:5.2f}  {entropy:.3f}{marker}",
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
    from forest_tpu_torch.eval.tau_calibration import (DEFAULT_TAUS,
                                                       entropy_tau_sweep)
    from forest_tpu_torch.losses.evt_soft_neighborhood import (
        EvtDiffusionMetric)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--confusion", default=None)
    ap.add_argument("--counts", default=None,
                    help="JSON of {code: pixel count}")
    ap.add_argument("--min-count", type=int, default=100)
    ap.add_argument("--diffusion-steps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)

    out: dict = {}
    if a.confusion:
        counts = json.loads(Path(a.counts).read_text()) if a.counts else {}
        metric = EvtDiffusionMetric(a.confusion, counts,
                                    min_count=a.min_count,
                                    diffusion_steps=a.diffusion_steps)
    else:
        rng = np.random.default_rng(0)
        codes = [7001, 7002, 7003, 7004, 7005]
        k = len(codes)
        conf = rng.integers(2, 30, size=(k, k)).astype(float)
        conf += np.diag(rng.integers(80, 150, size=k).astype(float))
        lines = ["," + ",".join(map(str, codes))]
        for c, row in zip(codes, conf):
            lines.append(f"{c}," + ",".join(map(str, row)))
        p = Path(tempfile.mkdtemp()) / "conf.csv"
        p.write_text("\n".join(lines))
        metric = EvtDiffusionMetric(p, {c: 1000 for c in codes},
                                    min_count=10,
                                    min_confusion_samples=10)
        say(out, "demo", k=k)

    d_full = 1.0 - metric.similarity
    k = metric.n_codes
    # Same-code pairs are excluded in the loss: drop the diagonal so the
    # entropy runs over the K-1 cross-code neighbors per row.
    off = ~np.eye(k, dtype=bool)
    d_ref = d_full[off].reshape(k, k - 1)
    sweep = entropy_tau_sweep(d_ref, DEFAULT_TAUS)
    log_k1 = float(np.log(k - 1))
    say(out, "codes", k=k, log_k1=log_k1)
    say(out, "header")
    for tau, ent in sweep.items():
        marker = " <-- well-sized" if 0.3 * log_k1 < ent < 0.8 * log_k1 \
            else ""
        say(out, "sweep", many=True, tau=float(tau), entropy=float(ent),
            marker=marker)
    return out


if __name__ == "__main__":
    main()
