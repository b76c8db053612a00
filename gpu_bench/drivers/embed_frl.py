"""Embedding with the frozen FRL encoder, as the export calls it:
``eval.frozen.make_encode_fns``'s ``encode_type``, then
``eval.export_embeddings.make_encode_phase_dense`` on that z_type, both
outputs in float16 as the export writes them.

Traffic: ``batch_size`` patches of ``patch_size``² and ``timesteps`` steps
a batch, from a pool of ``pool`` distinct batches made on the device from
the seed and taken in turn, in a closed loop with one caller: each batch
is synchronised before the next. The outputs stay on the device. A unit is
one batch, timed from its dispatch to its outputs' completion; a batch that
raises has failed. The outputs of ``checked`` of the batches the window
ran, drawn from the seed as the window goes (a reservoir sample), are kept
and compared with the plain reference's on the same inputs after the
window; a batch that raised, or a window that kept nothing, is not
correct.
"""
from __future__ import annotations

import copy
import random
import traceback
from typing import Dict, List

import torch

from gpu_bench.costs import steps as costs
from gpu_bench.drivers.train_frl import Reference
from gpu_bench.harness import Laps
from gpu_bench.traffic import frl as traffic_frl
from gpu_bench.traffic import weights as traffic_weights


def gap(port: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """Relative gaps of ``port`` from ``ref``: the root mean square over
    the reference's, and the largest over the reference's largest
    magnitude."""
    p, r = port.double(), ref.double()
    d = p - r
    return {"rms": float(torch.linalg.vector_norm(d)
                         / torch.linalg.vector_norm(r)),
            "max": float(d.abs().max() / r.abs().max())}


class Cell:
    def __init__(self, cfg: Dict, workload: Dict, seed: int,
                 device: torch.device):
        self.cfg, self.wl, self.seed, self.dev = cfg, workload, seed, device
        t = workload["traffic"]
        self.traffic = t
        self.b, self.hw, self.t = (t["batch_size"], t["patch_size"],
                                   t["timesteps"])
        self.unit_items = self.b
        self.batch_no = 0
        self.raised = 0
        # the window's batches whose outputs are checked: a sample of
        # ``checked`` of those it ran, drawn from the seed
        self.rng = random.Random(seed)
        self.kept: List = []

    def flops(self) -> Dict[str, int]:
        return costs.frl_embed(self.cfg, self.b, self.hw, self.t)

    def setup(self) -> None:
        from forest_tpu_torch.data.bindings import parse_bindings
        from forest_tpu_torch.data.feature_builder import FeatureBuilder
        from forest_tpu_torch.eval import export_embeddings, frozen
        from forest_tpu_torch.models import representation as rep
        lap = Laps(self.dev)
        gen = torch.Generator(self.dev).manual_seed(self.seed)
        self.ref = Reference(self.cfg, self.dev)
        self.p0 = traffic_weights.draw(self.ref.model, gen)
        self.pool = [traffic_frl.batch(gen, self.cfg["bindings"], self.b,
                                       self.hw, self.t, self.traffic)
                     for _ in range(self.traffic["pool"])]
        lap("weights and inputs")
        bindings = parse_bindings(copy.deepcopy(self.cfg["bindings"]))
        fb = FeatureBuilder(bindings,
                            traffic_frl.feature_stats(self.cfg["bindings"]))
        model = rep.from_config(self.cfg, self.ref.type_in,
                                self.ref.phase_in)
        model.load_state_dict(self.p0)
        model = model.to(self.dev).eval()
        self.encode_type, _, _ = frozen.make_encode_fns(model, fb)
        self.encode_phase = export_embeddings.make_encode_phase_dense(
            model, fb)
        self.model = model
        lap("the port's encoder")
        for k in range(self.traffic["warm"]):
            self._embed(self.pool[k % len(self.pool)])
        lap(f"{self.traffic['warm']} warm batches")

    def synchronize(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _embed(self, batch):
        with torch.inference_mode():
            zt = self.encode_type(batch)
            zp = self.encode_phase(batch, zt).half()
            return zt.half(), zp

    def unit(self, i: int) -> int:
        k = self.batch_no
        self.batch_no += 1
        try:
            out = self._embed(self.pool[k % len(self.pool)])
            self.synchronize()
        except Exception:               # a batch that raises has failed
            traceback.print_exc()
            self.raised += 1
            return 1
        self.keep(k, out)
        return 0

    def keep(self, k: int, out) -> None:
        """Algorithm R: after n batches each is kept with chance
        ``checked`` / n."""
        m = self.traffic["checked"]
        if len(self.kept) < m:
            self.kept.append((k, out))
            return
        j = self.rng.randrange(k + 1)
        if j < m:
            self.kept[j] = (k, out)

    def finish(self) -> int:
        return 0

    def release(self) -> None:
        del self.encode_type, self.encode_phase, self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_outputs(self, k: int, tf32: bool = False):
        """The plain reference's float16 outputs for batch ``k``."""
        from gpu_bench.reference import precision
        from gpu_bench.reference.eval import export_embeddings, frozen
        model = self.ref.model
        model.load_state_dict(self.p0)
        model.eval()
        batch = self.pool[k % len(self.pool)]
        with precision.tf32(tf32), torch.inference_mode():
            zt = frozen.make_encode_type(model, self.ref.fb)(batch)
            zp = export_embeddings.make_encode_phase_dense(
                model, self.ref.fb)(batch, zt)
        return zt.half(), zp.half()

    def gaps(self, tf32: bool = False) -> Dict[str, float]:
        """The largest gap of each kind over the checked batches; inf where
        a batch raised or none was kept."""
        worst = {f"{o}_{g}": 0.0 for o in ("z_type", "z_phase")
                 for g in ("rms", "max")}
        if self.raised or not self.kept:
            return {k: float("inf") for k in worst}
        for k, (zt, zp) in self.kept:
            rt, rp = self.reference_outputs(k, tf32)
            for name, port, ref in (("z_type", zt, rt), ("z_phase", zp, rp)):
                for g, v in gap(port, ref).items():
                    worst[f"{name}_{g}"] = max(worst[f"{name}_{g}"], v)
        return worst

    def check(self):
        lim = self.wl["limits"]
        return [(k, v, lim[k]) for k, v in self.gaps().items() if k in lim]
