"""FRL training steps back to back, as ``representation.loops.run_epoch``
calls ``train_step.make_train_step``'s step.

Traffic: ``batch_size`` patches of ``patch_size``² and ``timesteps`` steps
a batch, from a pool of ``pool`` distinct batches made on the device from
the seed and taken in turn; each step draws from its own generator, seeded
as the CLI's loop seeds it; the step's metrics are fetched to the host
every ``fetch_every`` steps. Set-up makes the weights, the pool and the
draws of the first ``compared`` steps from the seed, runs those steps and
``warm`` more, and reads the first steps' losses, first gradient and
parameter change for the comparison with the plain reference. A unit is
one step; a step whose update the non-finite test skipped has failed.
"""
from __future__ import annotations

import copy
from typing import Dict, List

import torch

from gpu_bench.costs import steps as costs
from gpu_bench.drivers import _training as tr
from gpu_bench.harness import Laps
from gpu_bench.traffic import frl as traffic_frl
from gpu_bench.traffic import weights as traffic_weights

#: seeds of a step's generator, as the CLI's loop makes them
SEED_STRIDE = 100003


class Reference:
    """The plain reference's objects for one configuration: the bindings,
    feature builder, sampler, step configuration and model."""

    def __init__(self, cfg: Dict, device: torch.device):
        from gpu_bench.reference.data.bindings import parse_bindings
        from gpu_bench.reference.data.feature_builder import FeatureBuilder
        from gpu_bench.reference.models import representation as rep
        from gpu_bench.reference.training.representation import \
            config_builders as cb
        self.bindings = parse_bindings(copy.deepcopy(cfg["bindings"]))
        self.fb = FeatureBuilder(self.bindings,
                                 traffic_frl.feature_stats(cfg["bindings"]))
        self.type_in = len(
            self.bindings.get_feature("type_encoder_input").channels)
        self.phase_in = len(self.bindings.get_feature("phase_ccdc").channels)
        self.model = rep.from_config(cfg, self.type_in, self.phase_in
                                     ).to(device)
        self.step_cfg = cb.build_step_config(self.bindings, {})
        self.sampler = cb.build_sampler(self.bindings, {})


class Cell:
    def __init__(self, cfg: Dict, workload: Dict, seed: int,
                 device: torch.device):
        self.cfg, self.wl, self.seed, self.dev = cfg, workload, seed, device
        t = workload["traffic"]
        self.b, self.hw, self.t = (t["batch_size"], t["patch_size"],
                                   t["timesteps"])
        self.traffic = t
        self.unit_items = self.b
        self.step_no = 0
        self.pending: List[Dict[str, torch.Tensor]] = []

    def flops(self) -> Dict[str, int]:
        return costs.frl_train(self.cfg, self.b, self.hw, self.t)

    # --- the benchmark's inputs -------------------------------------------

    def _draws(self):
        """The first steps' draws, made by the reference's copy of the
        step's draw function from a generator seeded from the run's seed."""
        from gpu_bench.reference.training.representation.step import \
            draw_step_randoms
        gen = torch.Generator(self.dev).manual_seed(self.seed * 7 + 3)
        return [draw_step_randoms(gen, self.b, self.hw, self.ref.sampler,
                                  self.ref.step_cfg, self.ref.model, True,
                                  self.dev)
                for _ in range(self.traffic["compared"])]

    def setup(self) -> None:
        lap = Laps(self.dev)
        gen = torch.Generator(self.dev).manual_seed(self.seed)
        self.ref = Reference(self.cfg, self.dev)
        self.p0 = traffic_weights.draw(self.ref.model, gen)
        self.pool = [traffic_frl.batch(gen, self.cfg["bindings"], self.b,
                                       self.hw, self.t, self.traffic)
                     for _ in range(self.traffic["pool"])]
        lap("weights and inputs")
        self._build_port()
        lap("the port's step")
        self.port_readings = self._compared_steps()
        lap(f"{self.traffic['compared']} compared steps")
        for _ in range(self.traffic["warm"]):
            self.unit(0)
        self.finish()
        lap(f"{self.traffic['warm']} warm steps")

    def _build_port(self) -> None:
        from forest_tpu_torch.data.bindings import parse_bindings
        from forest_tpu_torch.data.feature_builder import FeatureBuilder
        from forest_tpu_torch.models import representation as rep
        from forest_tpu_torch.training.representation import (
            config_builders as cb, step as step_mod, train_step as ts)
        cfg, dev = self.cfg, self.dev
        bindings = parse_bindings(copy.deepcopy(cfg["bindings"]))
        fb = FeatureBuilder(bindings,
                            traffic_frl.feature_stats(cfg["bindings"]))
        model = rep.from_config(cfg, self.ref.type_in, self.ref.phase_in)
        model.load_state_dict(self.p0)
        process = step_mod.make_process_batch(
            model, fb, cb.build_sampler(bindings, {}),
            cb.build_step_config(bindings, {}), self.hw, device=dev)
        o = cfg["optimizer"]
        opt = ts.make_optimizer(o["lr"], o["weight_decay"], o["grad_clip"])
        self.state = ts.init_train_state(model, opt)
        self.train_step = ts.make_train_step(process, opt)
        self.step_mod = step_mod
        # the CLI hands the step its weights and curriculum as device
        # scalars, made once an epoch
        self.weights = {k: torch.tensor(float(v), device=dev)
                        for k, v in cfg["loss_weights"].items()}
        self.curriculum = {k: torch.tensor(float(v), device=dev) for k, v in
                           cfg["curriculum_at_full_ramp"].items()}

    def _port_draws(self, d):
        """The reference's draws in the port's types."""
        from forest_tpu_torch.models.conv2d_encoder import EncoderDraws
        return self.step_mod.StepDraws(
            d.anchor_jitter, d.anchor_supplement_u, d.neg_pool_u,
            d.neg_pick_u, d.xb_neg_j,
            EncoderDraws(d.encoder.input_u, tuple(d.encoder.layer_u)),
            tuple(d.phase))

    def _compared_steps(self) -> Dict:
        losses, grad1 = [], None
        for k, d in enumerate(self._draws()):
            self.state, m = self.train_step(
                self.state, self.pool[k % len(self.pool)], None,
                self.weights, self.curriculum, draws=self._port_draws(d))
            losses.append(float(m["loss_total"]))
            if k == 0:
                grad1 = tr.first_gradient(self.state.mu)
            self.step_no += 1
        params = dict(self.state.model.named_parameters())
        return {"loss": losses, "grad1": grad1,
                "change": tr.change(params, self.p0)}

    # --- the window --------------------------------------------------------

    def unit(self, i: int) -> int:
        gen = torch.Generator(self.dev).manual_seed(
            self.seed * SEED_STRIDE + self.step_no)
        batch = self.pool[self.step_no % len(self.pool)]
        self.state, m = self.train_step(self.state, batch, gen, self.weights,
                                        self.curriculum)
        self.step_no += 1
        self.pending.append(m)
        if len(self.pending) >= self.traffic["fetch_every"]:
            return self._fetch()
        return 0

    def _fetch(self) -> int:
        return sum(int(m["skipped"]) for m in tr.drain(self.pending))

    def finish(self) -> int:
        return self._fetch()

    def release(self) -> None:
        del self.state, self.train_step, self.weights, self.curriculum
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --- the comparison ----------------------------------------------------

    def reference_readings(self, tf32: bool = False,
                           half_batch: bool = False) -> Dict:
        """The reference's first steps from the same weights, batches and
        draws; ``tf32`` computes its float32 products in TF32 (the
        control); ``half_batch`` leaves the second half of each batch out
        of the losses (a fault)."""
        from gpu_bench.reference.training.representation import (
            step as step_mod, train_step as ts)
        from gpu_bench.reference import precision
        ref = self.ref
        ref.model.load_state_dict(self.p0)
        process = step_mod.make_process_batch(
            ref.model, ref.fb, ref.sampler, ref.step_cfg, self.hw,
            device=self.dev)
        o = self.cfg["optimizer"]
        step = ts.make_train_step(process, ts.AdamW(
            o["lr"], o["weight_decay"], o["grad_clip"]))
        state = ts.init_train_state(ref.model)
        weights = {k: float(v) for k, v in self.cfg["loss_weights"].items()}
        cur = {k: float(v) for k, v in
               self.cfg["curriculum_at_full_ramp"].items()}
        losses, grad1 = [], None
        with precision.tf32(tf32):
            for k, d in enumerate(self._draws()):
                batch = self.pool[k % len(self.pool)]
                if half_batch:
                    keep = torch.arange(self.b, device=self.dev) < self.b // 2
                    batch = dict(batch, __sample_valid__=keep)
                state, m = step(state, batch, None, weights, cur, draws=d)
                losses.append(float(m["loss_total"]))
                if k == 0:
                    grad1 = tr.first_gradient(state.mu)
        params = dict(ref.model.named_parameters())
        out = {"loss": losses, "grad1": grad1,
               "change": tr.change(params, self.p0)}
        del state, process
        return out

    def check(self):
        ref = self.reference_readings()
        return tr.compare(self.port_readings, ref, self.wl["limits"])
