"""What training drivers share: the readings of a step's first updates
and their comparison with the plain reference.

A run's set-up builds the port's training state once, drives it through
its first ``compared`` steps by the window's own call on distinct batches,
and reads, before the window starts: each step's loss, the first
gradient as the optimizer took it (Adam's first moment after one update
divided by 1 - beta1) and each parameter's change over the compared steps.
After the window the reference repeats those steps from the same weights
and inputs, and the readings are compared leaf by leaf as gaps of norms:
|norm(port) - norm(reference)| over the larger of the reference leaf's norm
and the median leaf's. Leaves whose reference gradient lies under a
thousandth of the median leaf's move under Adam by round-off alone and are
left out of both.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

# Adam's first-moment decay: the first moment after one update is
# (1 - B1) times the clipped gradient
B1 = 0.9
TINY_GRADIENT = 1e-3


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.detach().double()))
            for n, t in tensors.items()}


def first_gradient(mu: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return leaf_norms({n: m / (1.0 - B1) for n, m in mu.items()})


def change(after: Dict[str, torch.Tensor],
           before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return leaf_norms({n: after[n].double() - before[n].double()
                       for n in before})


def leaf_gaps(port: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    floor = statistics.median(ref[n] for n in leaves)
    return {n: abs(port[n] - ref[n]) / max(ref[n], floor, 1e-30)
            for n in leaves}


def worst_leaf(port: Dict[str, float], ref: Dict[str, float],
               leaves: Sequence[str]) -> Tuple[float, str]:
    """The largest gap of norms over ``leaves``, and its leaf."""
    if not leaves:
        return math.nan, ""
    g = leaf_gaps(port, ref, leaves)
    name = max(g, key=g.get)
    return g[name], name


def moving_leaves(grad_ref: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad_ref.values())
    return [n for n, g in grad_ref.items() if g >= TINY_GRADIENT * med]


def gaps(port: Dict, ref: Dict) -> Dict[str, float]:
    """``port`` / ``ref``: {"loss": [per step], "grad1": {leaf: norm},
    "change": {leaf: norm}}. -> the step losses' largest relative gap
    (``loss_rel``); the first gradient's and the change's gaps of norms at
    the worst leaf (``*_leaf``) and at the median leaf (``*_median``: the
    median over the leaves of each leaf's gap)."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(port["loss"], ref["loss"]))
    if len(port["loss"]) != len(ref["loss"]) or not all(
            math.isfinite(v) for v in port["loss"]):
        loss = math.inf
    out = {"loss_rel": loss}
    leaves = moving_leaves(ref["grad1"])
    for key in ("grad1", "change"):
        g = leaf_gaps(port[key], ref[key], leaves) if leaves else {}
        out[f"{key}_leaf"] = max(g.values(), default=math.nan)
        out[f"{key}_median"] = (statistics.median(g.values()) if g
                                else math.nan)
    return out


def compare(port: Dict, ref: Dict, limits: Dict[str, float]
            ) -> List[Tuple[str, float, float]]:
    """(name, value, limit) for each number of :func:`gaps` that
    ``limits`` names."""
    g = gaps(port, ref)
    return [(k, g[k], lim) for k, lim in limits.items()]


def drain(pending: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """One device-to-host fetch of the queued metric dicts, as the trainers'
    loops fetch them (one stacked copy a block of steps). Clears
    ``pending``."""
    if not pending:
        return []
    keys = list(pending[0])
    flat = torch.stack([torch.stack([m[k].detach().reshape(()).double()
                                     for k in keys]) for m in pending])
    rows = flat.cpu().tolist()
    pending.clear()
    return [dict(zip(keys, r)) for r in rows]
