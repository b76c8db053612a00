"""FRL training CLI: the primary training entry point.

Port of ``forest_tpu/training/train_representation.py``: the three-file
YAML config (bindings + model + training), the stats sidecar computed when
it is missing, the train / val ``ForestDatasetV2`` with the checkerboard
split, the step of ``representation/{step, train_step}.py``, the two-phase
cosine learning rate with the phase re-warm-up, the curricula (input
dropout, smoothing gate, phase-loss ramp) per epoch, the per-epoch log
block, ``CheckpointManager`` in the JAX package's layout with auto-resume,
``--init-from``, early stopping, ``history.json`` and the archived configs.

Run:
  python -m forest_tpu_torch.training.train_representation \\
      --training configs/frl_training_v1.yaml --bindings B.yaml \\
      [--model-config M.yaml] [--num-epochs N] [--max-batches N] \\
      [--no-resume] [--init-from PARAMS.msgpack] [--profile] \\
      [--device cuda]

The run is on ``cuda`` unless ``--device cpu`` asks otherwise (the kernels'
plain versions then run).

Data parallel, one process per card (``forest_tpu_torch/parallel``):
  python -m torch.distributed.run --nproc_per_node N \
      -m forest_tpu_torch.training.train_representation --training ... \
      [--device cpu]   # gloo on the CPU; NCCL on the cards by default

(or ``FOREST_TPU_COORDINATOR`` / ``FOREST_TPU_NUM_PROCESSES`` /
``FOREST_TPU_PROCESS_ID`` set by hand). ``main`` brings the process group
up; each rank loads its rows ``[rank * B / W, (rank + 1) * B / W)`` of
every global batch of ``epoch.batch_size`` and steps its replica with the
loss, gradients and metrics reduced across the ranks; the state is
broadcast from rank 0 once built or resumed; rank 0 alone writes the stats
sidecar, checkpoints and ``history.json``, each write followed by a
barrier. ``hardware.data_parallel`` with several cards visible to one
process and no process group has no one-process form: it raises with the
``torchrun`` command to use.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import math
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import yaml

from forest_tpu_torch.data.bindings import parse_bindings
from forest_tpu_torch.data.feature_builder import FeatureBuilder
from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
from forest_tpu_torch.data.stats import StatsCalculator
from forest_tpu_torch.data.windows import SpatialWindow
from forest_tpu_torch.models import representation as rep
from forest_tpu_torch.parallel import dp, hosts
from forest_tpu_torch.parallel.mesh import Mesh, make_mesh
from forest_tpu_torch.training.checkpointing import (CheckpointManager,
                                                     load_state_raw)
from forest_tpu_torch.training.representation import (config_builders as cb,
                                                      curriculum as cur_mod,
                                                      epoch_logging, loops,
                                                      profiling)
from forest_tpu_torch.training.representation import step as step_mod
from forest_tpu_torch.training.representation import train_step as ts
from forest_tpu_torch.training.representation.training_config import (
    TrainingConfiguration, parse_training_config)
from forest_tpu_torch.training.scheduler import (cosine_lr,
                                                 two_phase_cosine_lr)
from forest_tpu_torch.utils.flax_bridge import (params_from_flax,
                                                params_to_flax)

log = logging.getLogger("forest_tpu_torch.train_representation")


def _git_hash() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], text=True,
            stderr=subprocess.DEVNULL).strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def apply_mixed_precision(model_cfg: Optional[Dict[str, Any]],
                          dtype: Optional[str]) -> Dict[str, Any]:
    """Thread hardware.mixed_precision into the model config as the
    spatial-conv compute-dtype DEFAULT; an explicit compute_dtype in the
    model config always wins."""
    mc = copy.deepcopy(model_cfg) if model_cfg else {}
    if not dtype:
        return mc
    sect = mc["model"] if "model" in mc else mc
    sc = sect.setdefault("spatial_conv", {})
    sc.setdefault("compute_dtype", dtype)
    return mc


def _data_parallel_mesh(cfg: TrainingConfiguration, device) -> Mesh:
    """The process group this run trains in (``hosts.training_mesh``); the
    global batch must divide by its ranks."""
    mesh = hosts.training_mesh(
        device, cfg.hardware.data_parallel,
        "forest_tpu_torch.training.train_representation")
    if cfg.epoch.batch_size % mesh.world_size:
        raise ValueError(
            f"epoch.batch_size {cfg.epoch.batch_size} must divide by "
            f"{mesh.world_size} processes for data-parallel training")
    return mesh


def _check_device(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_representation: no CUDA device; pass "
                           "--device cpu to train on the CPU")


def setup(cfg: TrainingConfiguration,
          bindings_path: Optional[str] = None,
          model_cfg: Optional[Dict[str, Any]] = None,
          device="cuda", *, mesh: Optional[Mesh] = None
          ) -> Dict[str, Any]:
    """Wire every component; returns the training context dict. With a
    ``mesh`` that has a process group, the steps are the data-parallel
    ones and ``device`` is the rank's card."""
    mesh = mesh or make_mesh(device)
    device = mesh.device
    bindings = parse_bindings(bindings_path or cfg.bindings_path)
    sd = cfg.spatial_domain
    dbg = SpatialWindow(*sd.debug_window) if sd.debug_window else None

    ds_kwargs = dict(patch_size=sd.patch_size,
                     split_block_size=sd.split_block_size,
                     min_aoi=sd.min_aoi, debug_window=dbg)

    # the stats sidecar: computed if it does not exist (or always), by the
    # primary rank; the others read it after the barrier
    stats_path = Path(bindings.stats.file)
    stats_s = None
    if hosts.is_primary() and (bindings.stats.compute == "always"
                               or not stats_path.exists()):
        log.info("computing stats -> %s", stats_path)
        t0 = time.perf_counter()
        ds_all = ForestDatasetV2(bindings, split=None, **ds_kwargs)
        StatsCalculator(bindings, ds_all, device=device).compute_and_save()
        stats_s = time.perf_counter() - t0
    hosts.sync()
    stats = json.loads(stats_path.read_text())

    ds_train = ForestDatasetV2(bindings, split="train",
                               epoch_mode=cfg.epoch.mode,
                               sample_frac=cfg.epoch.sample_frac,
                               sample_number=cfg.epoch.sample_number,
                               seed=cfg.seed, **ds_kwargs)
    ds_val = ForestDatasetV2(bindings, split="val", seed=cfg.seed,
                             **ds_kwargs)
    log.info("train patches: %d  val patches: %d",
             len(ds_train.patches), len(ds_val.patches))

    fb = FeatureBuilder(bindings, stats)
    builder_dict = cfg.as_builder_dict()
    step_cfg = cb.build_step_config(bindings, builder_dict)
    # channel counts of the features the step consumes
    type_c = len(bindings.get_feature(step_cfg.type_feature).channels)
    phase_c = len(bindings.get_feature(step_cfg.phase_feature).channels)
    model_cfg = apply_mixed_precision(model_cfg,
                                      cfg.hardware.mixed_precision_dtype)
    model = rep.from_config(model_cfg or {}, type_c, phase_c)
    rep.init_parameters(model, torch.Generator().manual_seed(cfg.seed))
    n_params = sum(p.numel() for p in model.parameters())
    log.info("model params: %.3f M on %s", n_params / 1e6, device)

    sampler = cb.build_sampler(bindings, builder_dict)
    weights = cb.build_loss_weights(builder_dict, bindings)
    curricula = cb.build_curricula(builder_dict, bindings)

    evt_tables = None
    if step_cfg.evt_enabled:
        from forest_tpu_torch.losses.evt_soft_neighborhood import \
            EvtDiffusionMetric
        evt_spec = bindings.losses["evt_soft_neighborhood"]
        counts = stats.get(evt_spec.get("counts_feature", ""), {}) \
            .get(step_cfg.evt_feature, {}).get("counts", {})
        metric_keys = ("min_count", "min_confusion_samples",
                       "diffusion_steps", "laplace_smoothing",
                       "binary_threshold", "max_weight")
        metric = EvtDiffusionMetric(evt_spec["confusion_csv"], counts,
                                    **{k: evt_spec[k] for k in metric_keys
                                       if k in evt_spec})
        evt_tables = step_mod.build_evt_tables(metric)

    process = step_mod.make_process_batch(model, fb, sampler, step_cfg,
                                          sd.patch_size, evt_tables,
                                          diag=cfg.diagnostics,
                                          device=device)

    # Steps per epoch under the configured epoch mode (the LR schedule and
    # the phase re-warm-up are pinned to real step counts); ceil, because
    # run_epoch fills the ragged tail batch instead of dropping it.
    if cfg.epoch.mode == "number":
        epoch_size = min(cfg.epoch.sample_number, len(ds_train.patches))
    elif cfg.epoch.mode == "frac":
        epoch_size = max(int(cfg.epoch.sample_frac
                             * len(ds_train.patches)), 1)
    else:
        epoch_size = len(ds_train.patches)
    steps_per_epoch = max(-(-epoch_size // cfg.epoch.batch_size), 1)
    total_steps = cfg.epoch.num_epochs * steps_per_epoch
    phase_start = curricula["phase_start_epoch"] * steps_per_epoch
    s = cfg.scheduler
    if s.phase_rewarmup and curricula["phase_start_epoch"] > 0:
        lr_sched = two_phase_cosine_lr(
            cfg.optimizer.lr, total_steps,
            phase_start_step=phase_start + steps_per_epoch,
            rewarmup_steps=s.rewarmup_epochs * steps_per_epoch,
            min_lr=cfg.optimizer.lr * s.min_lr_factor,
            warmup_steps=s.warmup_epochs * steps_per_epoch,
            start_factor=s.start_factor, peak_factor=s.peak_factor)
    else:
        lr_sched = cosine_lr(cfg.optimizer.lr, total_steps,
                             cfg.optimizer.lr * s.min_lr_factor,
                             s.warmup_epochs * steps_per_epoch)

    optimizer = ts.make_optimizer(lr_sched, cfg.optimizer.weight_decay,
                                  cfg.optimizer.grad_clip)
    state = ts.init_train_state(model, optimizer)
    if mesh.group is not None:
        log.info("FRL data-parallel over %d processes (rank %d on %s)",
                 mesh.world_size, mesh.rank, device)
    return dict(bindings=bindings, model=model, fb=fb, state=state,
                train_step=dp.make_dp_frl_step(process, optimizer, mesh),
                eval_step=dp.make_dp_frl_eval(process, mesh), mesh=mesh,
                ds_train=ds_train, ds_val=ds_val, weights=weights,
                curricula=curricula, step_cfg=step_cfg,
                lr_sched=lr_sched, steps_per_epoch=steps_per_epoch,
                optimizer=optimizer, model_cfg=model_cfg or {},
                device=device, stats_s=stats_s)


def _shapes(tree) -> Dict[str, Any]:
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(np.shape(v)))
            for k, v in tree.items()}


def _warm_start(state: ts.FRLTrainState, optimizer: ts.AdamW,
                init_from: str) -> ts.FRLTrainState:
    """Parameters from a params-only checkpoint, fresh optimizer state."""
    raw, _ = load_state_raw(Path(init_from))
    if "params" not in raw:
        raise ValueError(f"{init_from} has no 'params' entry")
    want = _shapes(params_to_flax(dict(state.model.named_parameters())))
    got = _shapes(raw["params"])
    if want != got:
        raise ValueError(
            f"--init-from {init_from} does not match the configured "
            f"model: expected leaf shapes {want} but checkpoint has {got}")
    state.model.load_state_dict(params_from_flax(raw["params"]), strict=True)
    return ts.init_train_state(state.model, optimizer)


def _device_scalars(values: Dict[str, float], device) -> Dict[str, Any]:
    """float32 device scalars, made by a fill (no host-to-device copy)."""
    return {k: torch.full((), float(v), dtype=torch.float32, device=device)
            for k, v in values.items()}


def train(cfg: TrainingConfiguration,
          bindings_path: Optional[str] = None,
          model_cfg: Optional[Dict[str, Any]] = None,
          max_batches: Optional[int] = None,
          resume: bool = True,
          init_from: Optional[str] = None,
          device="cuda") -> Dict[str, Any]:
    _check_device(torch.device(device))
    mesh = _data_parallel_mesh(cfg, device)
    exp_dir = cfg.run.experiment_dir
    if hosts.is_primary():
        exp_dir.mkdir(parents=True, exist_ok=True)
        (exp_dir / "provenance.json").write_text(json.dumps(
            {"git_hash": _git_hash(), "config": cfg.summary(),
             "time": time.strftime("%Y-%m-%dT%H:%M:%S")}, indent=1))
        # the exact configs, archived beside the run
        arch = exp_dir / "configs"
        arch.mkdir(exist_ok=True)
        (arch / "training_resolved.json").write_text(json.dumps(
            dataclasses.asdict(cfg), indent=1, default=str))
        if model_cfg:
            (arch / "model.yaml").write_text(yaml.safe_dump(model_cfg))
        bp = bindings_path or cfg.bindings_path
        if bp and Path(bp).exists():
            (arch / "bindings.yaml").write_text(Path(bp).read_text())

    ctx = setup(cfg, bindings_path, model_cfg, device, mesh=mesh)
    device = mesh.device
    state = ctx["state"]
    ckpt = CheckpointManager(
        exp_dir / cfg.run.ckpt_dir, prefix="encoder",
        top_k=cfg.run.checkpoint.save_top_k,
        periodic_every=cfg.run.checkpoint.save_every_n_epochs,
        monitor=cfg.run.checkpoint.monitor,
        monitor_start_epoch=cfg.run.checkpoint.monitor_start_epoch,
        mode=cfg.run.checkpoint.mode)

    start_epoch = 0
    resumed_run = False
    hosts.sync()    # the checkpoints are read after every rank is here
    if resume:
        resumed = ckpt.maybe_resume(state)
        if resumed is not None:
            state, meta = resumed
            start_epoch = int(meta.get("epoch", -1)) + 1
            resumed_run = True
            # the datasets' draws of the epochs already run, so the resumed
            # run sees the data order an uninterrupted one would
            val_every = (cfg.validation or {}).get("val_every_n_epochs", 1)
            for e in range(start_epoch):
                ctx["ds_train"].on_epoch_start()
                if val_every and e % val_every == 0:
                    ctx["ds_val"].on_epoch_start()
            log.info("auto-resumed from epoch %d (step %d)",
                     start_epoch - 1, state.step)
    if init_from:
        # A resumed run keeps its own state: resuming continues, init_from
        # seeds a new run.
        if resumed_run:
            log.warning("--init-from %s ignored: run auto-resumed from its "
                        "own checkpoint (use --no-resume or a fresh "
                        "experiment dir to warm-start)", init_from)
        else:
            state = _warm_start(state, ctx["optimizer"], init_from)
            log.info("warm-started params from %s (fresh optimizer state)",
                     init_from)
    state = hosts.replicate_state(state)

    cur = ctx["curricula"]
    base_weights = ctx["weights"]
    # the groups the step compares by exact value (EVT codes): the compact
    # wire never rounds them, whatever the YAML named them
    wire_skip = step_mod.wire_exact_groups(ctx["step_cfg"])
    model = ctx["model"]
    extra_meta = {"model_version": rep.VERSION,
                  "model_config": rep.model_config_dict(model),
                  "type_in_channels": model.type_in_channels,
                  "phase_in_channels": model.phase_in_channels}

    history = []
    val_cfg = cfg.validation or {}
    val_every = val_cfg.get("val_every_n_epochs", 1)
    es_cfg = cfg.early_stopping or {}
    es_enabled = es_cfg.get("enabled", False)
    es_patience = int(es_cfg.get("patience", 15))
    es_best = float("inf")
    es_bad = 0
    monitor = cfg.run.checkpoint.monitor
    for epoch in range(start_epoch, cfg.epoch.num_epochs):
        # the curricula, as device scalars once per epoch
        idr = cur_mod.compute_input_dropout_rate(
            cur["input_dropout"], epoch, cfg.epoch.num_epochs)
        min_gate = cur_mod.compute_smoothing_min_gate(
            epoch, cur["smoothing_freeze_until"],
            cur["smoothing_ramp_epochs"])
        ramp = cur_mod.ramp_weight(epoch, cur["phase_start_epoch"],
                                   cur["phase_ramp_epochs"])
        weights = _device_scalars(
            {k: v * (ramp if k in cur["phase_ramped_losses"] else 1.0)
             for k, v in base_weights.items()}, device)
        curriculum = _device_scalars({"input_dropout_rate": idr,
                                      "min_gate": min_gate}, device)

        # --profile traces the FIRST trained epoch
        trace_dir = (str(exp_dir / cfg.run.log_dir / "trace")
                     if profiling.is_profiling() and epoch == start_epoch
                     else None)
        with profiling.maybe_trace(trace_dir):
            state, train_m = loops.train_epoch(
                ctx["ds_train"], ctx["train_step"], state,
                batch_size=cfg.epoch.batch_size, weights=weights,
                curriculum=curriculum, rng_seed=cfg.seed + epoch,
                num_workers=cfg.hardware.num_workers,
                max_batches=max_batches, device=device, mesh=mesh,
                wire_skip=wire_skip)

        val_m = None
        if val_every and epoch % val_every == 0:
            val_m = loops.validate_epoch(
                ctx["ds_val"], ctx["eval_step"],
                batch_size=cfg.epoch.batch_size, weights=weights,
                curriculum=_device_scalars({"input_dropout_rate": 0.0,
                                            "min_gate": min_gate}, device),
                rng_seed=1_000_000 + epoch,
                num_workers=cfg.hardware.num_workers,
                max_batches=val_cfg.get("max_batches", max_batches),
                device=device, mesh=mesh, wire_skip=wire_skip)

        # the logged rate is the schedule at the step count (skipped steps
        # included), as the JAX CLI logs it
        lr_now = float(ctx["lr_sched"](int(state.step)))
        log.info("\n%s", epoch_logging.format_epoch_block(
            epoch, train_m, val_m, lr_now))
        metrics = epoch_logging.checkpoint_metrics(train_m, val_m)
        history.append({"epoch": epoch, **metrics})
        if hosts.is_primary():
            ckpt.save(epoch, state, metrics, extra_meta)
        hosts.sync()

        # early stopping on the monitored metric, in the direction of the
        # checkpoint monitor's mode
        if es_enabled and monitor in metrics:
            v = float(metrics[monitor])
            if cfg.run.checkpoint.mode == "max":
                improved = math.isfinite(v) and -v < es_best - 1e-9
                v = -v
            else:
                improved = math.isfinite(v) and v < es_best - 1e-9
            if improved:
                es_best, es_bad = v, 0
            else:
                es_bad += 1
                if es_bad >= es_patience:
                    log.info("early stopping at epoch %d "
                             "(no improvement for %d epochs)", epoch,
                             es_bad)
                    break

    if hosts.is_primary():
        (exp_dir / "history.json").write_text(json.dumps(history, indent=1))
    hosts.sync()
    return {**ctx, "state": state, "history": history,
            "start_epoch": start_epoch}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--training", required=True)
    ap.add_argument("--bindings", default=None)
    ap.add_argument("--model-config", dest="model_config", default=None)
    ap.add_argument("--num-epochs", dest="num_epochs", type=int,
                    default=None)
    ap.add_argument("--max-batches", dest="max_batches", type=int,
                    default=None)
    ap.add_argument("--num-workers", dest="num_workers", type=int,
                    default=None)
    ap.add_argument("--phase-start-epoch", dest="phase_start_epoch",
                    type=int, default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--init-from", dest="init_from", default=None,
                    help="params-only msgpack to warm-start a fresh run")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    profiling.set_profile(a.profile)
    cfg = parse_training_config(a.training)
    if a.num_epochs:
        cfg.epoch.num_epochs = a.num_epochs
    if a.num_workers:
        cfg.hardware.num_workers = a.num_workers
    if a.phase_start_epoch is not None:
        cfg.curriculum["phase_start_epoch"] = a.phase_start_epoch
    model_cfg = None
    mc_path = a.model_config or cfg.model_path
    if mc_path:
        model_cfg = yaml.safe_load(Path(mc_path).read_text())
    # no-op unless torchrun or FOREST_TPU_* configure several processes
    hosts.initialize(device=a.device)
    try:
        if a.overwrite and hosts.is_primary():
            shutil.rmtree(cfg.run.experiment_dir, ignore_errors=True)
        hosts.sync()
        return train(cfg, a.bindings, model_cfg, a.max_batches,
                     resume=not a.no_resume, init_from=a.init_from,
                     device=a.device)
    finally:
        hosts.shutdown()


if __name__ == "__main__":
    main()
