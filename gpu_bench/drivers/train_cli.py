"""The FRL training CLI's own epoch over a zarr cube: ``loops.train_epoch``
with its ``PrefetchLoader`` over ``ForestDatasetV2``, as
``train_representation`` calls it, around ``train_step.make_train_step``'s
step built as ``train_frl.py`` builds it.

Traffic: set-up writes a cube of ``cube_hw``² pixels of every source of the
bindings (``traffic/cube.py``) under the run's temporary directory. The
dataset takes all its patches of ``patch_size``² (``split`` None, an
``aoi`` cover of ``min_aoi``) and visits them in a seeded order with
repeats, never one inside a batch (``traffic/cube.visits``). A unit is one
``train_epoch`` call of ``steps`` batches of ``batch_size`` with
``num_workers`` loader threads and ``rng_seed`` the run's seed plus the
epoch's number: a fresh loader each unit, each batch read, decoded,
assembled, pinned and copied by the CLI's loader, metrics fetched every 16
steps by ``run_epoch`` itself. A unit with a skipped step, or with fewer
than ``steps`` steps, has failed. Each unit's ``wait_s``,
``epoch_time_s`` and the dataset's ``load_batch`` seconds go to
``gpu_bench.epochs`` for the readers.

Set-up: the weights from the seed, the cube, the dataset and the port's
step, then epoch 0 through the same call with ``compared`` steps, the step
wrapped to read each step's loss, the first gradient and the change; it
warms every shape the window uses.

Correct: (1) ``checked`` of the window's batches, a reservoir sample drawn
from the seed, kept as handed to the step, each array equal bit for bit to
the plain read of the same patches from the cube's files
(``reference/data/cube_read.py``): ``batch_arrays_unequal`` counts those
that differ, every array of a batch the sample lacks included;
``missing_steps`` counts the steps the window's epochs did not hand over.
(2) The compared steps against the plain reference on the plain reads of
their batches, each step's generator seeded as ``run_epoch`` seeds it
(``_training``'s gaps).
"""
from __future__ import annotations

import copy
import os
import random
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from gpu_bench import epochs
from gpu_bench.drivers import _training as tr
from gpu_bench.drivers import train_frl
from gpu_bench.harness import Laps, log
from gpu_bench.traffic import cube as traffic_cube
from gpu_bench.traffic import weights as traffic_weights

TRAINING = ("loss_rel", "grad1_leaf", "grad1_median", "change_leaf",
            "change_median")


def same(got: torch.Tensor, want: np.ndarray) -> bool:
    """Equal type, shape and bits."""
    a = np.ascontiguousarray(got.numpy())
    b = np.ascontiguousarray(want)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


class Cell(train_frl.Cell):
    def __init__(self, cfg: Dict, workload: Dict, seed: int,
                 device: torch.device):
        super().__init__(cfg, workload, seed, device)
        self.steps = self.traffic["steps"]
        self.unit_items = self.b * self.steps
        self.epoch = 0
        self.loads: List[float] = []
        # the window's batches kept for the check: a sample of ``checked``
        # of those handed over, drawn from the seed
        self.rng = random.Random(seed)
        self.kept: List = []
        self.handed = 0
        self.missing = 0
        self.in_window = False
        epochs.UNITS.clear()

    def flops(self) -> Dict[str, int]:
        return {k: v * self.steps for k, v in super().flops().items()}

    def _visits(self, epoch: int, n: int) -> List[int]:
        return traffic_cube.visits(
            self.seed, epoch, n, self.b,
            max(self.steps, self.traffic["compared"]))

    # --- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from forest_tpu_torch.data.bindings import parse_bindings
        from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
        from forest_tpu_torch.training.representation import loops
        t, lap = self.traffic, Laps(self.dev)
        gen = torch.Generator(self.dev).manual_seed(self.seed)
        self.ref = train_frl.Reference(self.cfg, self.dev)
        self.p0 = traffic_weights.draw(self.ref.model, gen)
        lap("weights")
        self.tmp = tempfile.TemporaryDirectory(prefix="frl_cli_")
        self.cube = Path(self.tmp.name) / "cube.zarr"
        w0 = time.perf_counter()
        info = traffic_cube.write(self.cube, gen, self.cfg["bindings"], t)
        log(f"cube {t['cube_hw']}^2, {t['codec']}: {info['chunks']:.0f} "
            f"chunks ({info['whole_chunks']:.0f} written whole), "
            f"{info['raw_bytes'] / 1e9:.4f} GB raw, "
            f"{info['stored_bytes'] / 1e9:.4f} GB stored (ratio "
            f"{info['raw_bytes'] / info['stored_bytes']:.4f}), written in "
            f"{time.perf_counter() - w0:.3f} s; host: {os.cpu_count()} "
            f"CPUs, {torch.get_num_threads()} torch thread(s), "
            f"OMP_NUM_THREADS={os.environ.get('OMP_NUM_THREADS')}")
        lap("the cube")
        bindings = copy.deepcopy(self.cfg["bindings"])
        bindings["zarr"]["path"] = str(self.cube)
        cell = self

        class Visits(ForestDatasetV2):
            """The CLI's dataset, visiting the cell's order; each
            ``load_batch`` timed."""

            def on_epoch_start(self):
                self._current_indices = cell._visits(cell.epoch,
                                                     len(self.patches))

            def load_batch(self, indices):
                t0 = time.perf_counter()
                out = super().load_batch(indices)
                cell.loads.append(time.perf_counter() - t0)
                return out

        self.ds = Visits(parse_bindings(bindings), split=None,
                         patch_size=self.hw, min_aoi=t["min_aoi"])
        self.loops = loops
        self._build_port()
        lap(f"the dataset ({len(self.ds.patches)} patches) and the port's "
            f"step")
        self.port_readings = self._compared_epoch()
        from forest_tpu_torch.data import native
        lap(f"epoch 0: {t['compared']} compared steps; the port's native "
            f"decoder {'built' if native.available() else 'missing'}, "
            f"{native.decoded} chunks decoded by it")
        self.in_window = True

    def _epoch(self, step, batches: int):
        """One ``train_epoch`` call, the CLI's, of ``batches`` batches."""
        self.loads = []
        state, m = self.loops.train_epoch(
            self.ds, step, self.state, batch_size=self.b,
            weights=self.weights, curriculum=self.curriculum,
            rng_seed=self.seed + self.epoch,
            num_workers=self.traffic["num_workers"], max_batches=batches,
            device=self.dev)
        self.epoch += 1
        return state, m

    def _compared_epoch(self) -> Dict:
        losses, grad1 = [], {}
        step = self.train_step

        def compared(state, batch, gen, weights, curriculum):
            if not losses:
                nbytes = sum(v.numel() * v.element_size()
                             for v in batch.values())
                log(f"a step copies {nbytes / 1e6:.3f} MB to the card: "
                    + ", ".join(f"{k} {list(v.shape)} {v.dtype}"
                                for k, v in batch.items()))
            state, m = step(state, batch, gen, weights, curriculum)
            losses.append(m["loss_total"])
            if len(losses) == 1:
                grad1.update(tr.first_gradient(state.mu))
            return state, m

        self.state, _ = self._epoch(compared, self.traffic["compared"])
        params = dict(self.state.model.named_parameters())
        return {"loss": [float(v) for v in losses], "grad1": grad1,
                "change": tr.change(params, self.p0)}

    # --- the window --------------------------------------------------------

    def _window_step(self, state, batch, gen, weights, curriculum):
        self.keep((self.epoch, self.position), batch)
        self.position += 1
        return self.train_step(state, batch, gen, weights, curriculum)

    def keep(self, at, batch) -> None:
        """Algorithm R: after n batches each is kept with chance
        ``checked`` / n, as handed to the step."""
        m, n = self.traffic["checked"], self.handed
        self.handed += 1
        j = n if n < m else self.rng.randrange(n + 1)
        if j < m:
            kept = (at, {k: v.clone() for k, v in batch.items()})
            if j < len(self.kept):
                self.kept[j] = kept
            else:
                self.kept.append(kept)

    def unit(self, i: int) -> int:
        self.position = 0
        window = self.in_window
        self.state, m = self._epoch(
            self._window_step if window else self.train_step, self.steps)
        epochs.record(i, wait_s=m["wait_s"], epoch_time_s=m["epoch_time_s"],
                      load_s=sum(self.loads), loads=len(self.loads))
        log(f"unit {i}: {m['n_steps']} steps, {m['epoch_time_s']:.4f} s, "
            f"waited {m['wait_s']:.4f} s, {len(self.loads)} loads of "
            f"{1e3 * sum(self.loads) / max(len(self.loads), 1):.2f} ms")
        if window:
            self.missing += self.steps - m["n_steps"]
        return int(m["n_steps"] != self.steps or m.get("skipped", 0.0) > 0)

    def finish(self) -> int:
        self.in_window = False
        return 0

    def release(self) -> None:
        self.kept = [(at, {k: v.cpu() for k, v in b.items()})
                     for at, b in self.kept]
        del self.ds
        super().release()

    # --- the comparison ----------------------------------------------------

    def plain(self):
        from gpu_bench.reference.data.cube_read import Cube
        return Cube(self.cube, self.cfg["bindings"], self.hw,
                    self.traffic["min_aoi"])

    def unequal(self) -> float:
        """Arrays of the kept batches that differ from the plain read,
        every array of a batch the sample lacks included."""
        cube = self.plain()
        arrays = len(self.cfg["bindings"]["dataset"]) + 2
        n = (self.traffic["checked"] - len(self.kept)) * arrays
        for (epoch, pos), got in self.kept:
            order = self._visits(epoch, len(cube.patches))
            want = cube.batch(order[pos * self.b:(pos + 1) * self.b])
            n += len(set(got) ^ set(want))
            n += sum(not same(got[k], v) for k, v in want.items()
                     if k in got)
        return float(n)

    def reference_readings(self, tf32: bool = False,
                           half_batch: bool = False) -> Dict:
        """The reference's compared steps from the same weights, on the
        plain reads of epoch 0's batches, each step's generator seeded as
        ``run_epoch`` seeds it; ``tf32`` computes its float32 products in
        TF32 (the control); ``half_batch`` leaves the second half of each
        batch out of the losses (a fault)."""
        from gpu_bench.reference import precision
        from gpu_bench.reference.training.representation import (
            step as step_mod, train_step as ts)
        ref, cube = self.ref, self.plain()
        order = self._visits(0, len(cube.patches))
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
            for k in range(self.traffic["compared"]):
                batch = {n: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.dev) for n, v in cube.batch(
                        order[k * self.b:(k + 1) * self.b]).items()}
                if half_batch:
                    batch["__sample_valid__"] = torch.arange(
                        self.b, device=self.dev) < self.b // 2
                gen = torch.Generator(self.dev).manual_seed(
                    self.seed * train_frl.SEED_STRIDE + k)
                state, m = step(state, batch, gen, weights, cur)
                losses.append(float(m["loss_total"]))
                if k == 0:
                    grad1 = tr.first_gradient(state.mu)
        params = dict(ref.model.named_parameters())
        out = {"loss": losses, "grad1": grad1,
               "change": tr.change(params, self.p0)}
        del state, process
        return out

    def check(self):
        lim = self.wl["limits"]
        try:
            out = tr.compare(self.port_readings, self.reference_readings(),
                             {k: lim[k] for k in TRAINING})
            out.append(("batch_arrays_unequal", self.unequal(),
                        lim["batch_arrays_unequal"]))
            out.append(("missing_steps", float(self.missing),
                        lim["missing_steps"]))
            return out
        finally:
            self.tmp.cleanup()
