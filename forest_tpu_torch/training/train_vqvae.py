"""Legacy-pipeline VQ-VAE training CLI.

Port of ``forest_tpu/training/train_vqvae.py``: schema build -> VQVAEDataset
+ ChunkBatchSampler + prefetching loader -> VQVAE -> AdamW (codebook weight
decay 0) + cosine LR + lambda_vq annealer -> train step with EMA codebook
updates -> per-epoch checkpoints (``ckpt_last`` / ``ckpt_epoch_NNN`` /
``ckpt_best_0`` through the CheckpointManager).

Run:
  python -m forest_tpu_torch.training.train_vqvae --config configs/vae_v0.yaml \
      [--zarr PATH] [--run-dir PATH] [--epochs N] [--max-steps N] \
      [--device cuda]

The config YAML uses a ``train_vqvae:`` section with the JAX package's key
names, so its configs run unchanged. The run is on ``cuda`` unless
``--device cpu`` asks otherwise; the quantiser then goes through the
hand-written kernel ``ops.vq.vq_core`` every train and validation step.
Checkpoints have the JAX package's layout and load in either package.

Data parallel, one process per card (``forest_tpu_torch/parallel``):
  python -m torch.distributed.run --nproc_per_node N \
      -m forest_tpu_torch.training.train_vqvae --config ... [--device cpu]

Each rank samples batches of ``batch_size`` from its own chunk shard
(``ChunkBatchSampler(num_shards=world, shard_id=rank)``), so a global
batch has world x ``batch_size`` rows; the steps of an epoch and of a
validation are capped at the fewest any shard yields, so the ranks stay in
lockstep; gradients are averaged and the EMA statistics summed across the
ranks (``parallel.dp.make_dp_train_step``); rank 0 alone writes the
schema, checkpoints and ``history.json``, each write followed by a
barrier. ``data_parallel: true`` with several cards visible to one process
and no process group raises with the ``torchrun`` command to use.

``wire_compact: true`` puts the compact wire (``data.wire``: bfloat16
floats, bit-packed masks, ids narrowed by the schema's bounds) on the
batches' copies to the device; unset, it is off (the JAX CLI turns it on
only on a TPU), and under several ranks it stays off, as in the JAX CLI.
``steps_per_dispatch: K`` is accepted and logged, and the port runs one
step at a time: a block of K steps (``vqvae_step.make_scan_train_step``)
gives the same result bit for bit and saves only the pinned copies of K-1
batches, which on an H100 moved no step time (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import yaml

from forest_tpu_torch.data.cube import LegacyCube
from forest_tpu_torch.data.loader import PrefetchLoader, make_device_put
from forest_tpu_torch.data.samplers import ChunkBatchSampler
from forest_tpu_torch.data.schema import build_and_save_schema
from forest_tpu_torch.data.vqvae_dataset import IGNORE_INDEX, VQVAEDataset
from forest_tpu_torch.data.wire import encode_wire_batch
from forest_tpu_torch.models.vqvae import (VQVAE, init_parameters,
                                           model_config_dict)
from forest_tpu_torch.parallel import dp, hosts
from forest_tpu_torch.parallel.mesh import Mesh
from forest_tpu_torch.training import vqvae_step
from forest_tpu_torch.training.annealers import load_scheduler
from forest_tpu_torch.training.checkpointing import CheckpointManager
from forest_tpu_torch.training.scheduler import cosine_lr

log = logging.getLogger("forest_tpu_torch.train_vqvae")

DEFAULTS: Dict[str, Any] = dict(
    batch_size=64, steps_per_epoch=200, epochs=10, num_workers=8,
    eager=False, steps_per_dispatch=1,
    min_hits_per_epoch=100, mass_coverage=0.999, vocab_cap=5000,
    codebook_size=256, emb_dim=128, hidden=128, cat_emb_dim=8, beta=0.25,
    quantizer="ema", ema_decay=0.99, ema_eps=1e-5,
    lr=3e-4, min_lr=3e-5, weight_decay=1e-4, clip_grad=1.0,
    lambda_cont=1.0, lambda_cat=1.0, lambda_canopy=1.0,
    anneal_vq_schedule="constant", anneal_vq_value=1.0,
    block_size=(4, 4), split_train="train", split_val="val",
    drop_last=True, seed=0, device="cuda",
)
# metric dicts kept on the device between fetches
_DRAIN_EVERY = 16


def load_config(path: Optional[str],
                overrides: Dict[str, Any]) -> Dict[str, Any]:
    cfg = dict(DEFAULTS)
    if path:
        y = yaml.safe_load(Path(path).read_text()) or {}
        cfg.update(y.get("train_vqvae", y))
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    return cfg


def build_vq_annealer(cfg: Dict[str, Any]):
    """Map the flat anneal_vq_* keys to an AnnealConfig."""
    sched = cfg.get("anneal_vq_schedule", "constant")
    base = {"cont": cfg["lambda_cont"], "cat": cfg["lambda_cat"],
            "canopy": cfg["lambda_canopy"], "vq": 1.0}
    if sched == "constant":
        return load_scheduler(base, {"vq": float(
            cfg.get("anneal_vq_value", 1.0))})
    if sched == "warmup_hold_decay":
        return load_scheduler(base, {"vq": {
            "kind": "warmup_hold_decay",
            "start_step": int(cfg.get("anneal_vq_start", 0)),
            "warmup": int(cfg.get("anneal_vq_warmup", 0)),
            "hold": int(cfg.get("anneal_vq_hold", 0)),
            "decay": int(cfg.get("anneal_vq_decay", 0)),
            "floor": float(cfg.get("anneal_vq_floor", 0.0)),
            "ceil": float(cfg.get("anneal_vq_ceil", 1.0)),
            "final": float(cfg.get("anneal_vq_final", 1.0))}})
    return load_scheduler(base, {"vq": {
        "kind": sched,
        "start_value": float(cfg.get("anneal_vq_floor", 0.0)),
        "end_value": float(cfg.get("anneal_vq_ceil", 1.0)),
        "start_step": int(cfg.get("anneal_vq_start", 0)),
        "end_step": int(cfg.get("anneal_vq_start", 0))
        + int(cfg.get("anneal_vq_warmup", 1))}})


def wire_int_bounds(ds: VQVAEDataset) -> Dict[str, Any]:
    """The schema's value bounds of the id arrays, for the compact wire:
    the merged ``cat`` block is bounded by the largest ``num_ids``, each
    ``cat_target`` array also carries IGNORE_INDEX (-100). A feature named
    "cat" shares the merged block's key (the wire matches keys at any
    level), so that entry holds both arrays' union."""
    vocab = {n: int(ds.schema_cat[n]["num_ids"]) for n in ds.cat_names}
    if not vocab:
        return {}
    bounds: Dict[str, Any] = {n: (IGNORE_INDEX, v) for n, v in vocab.items()}
    bounds["cat"] = ((IGNORE_INDEX, max(vocab.values()))
                     if "cat" in vocab else max(vocab.values()))
    return bounds


def host_to_device_batch(batch: Dict[str, Any], device="cuda",
                         wire: bool = False,
                         int_bounds: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """Drop the host-only keys (``years``, ``yx``); the rest become tensors
    on ``device`` (pinned memory and a non-blocking copy onto a card).
    ``wire`` encodes the batch for the compact wire first; the steps
    decode it."""
    batch = {k: v for k, v in batch.items() if k not in ("years", "yx")}
    if wire:
        batch = encode_wire_batch(batch, int_bounds=int_bounds)
    return make_device_put(device, keep_host_keys=())(batch)


def _lockstep_cap(xy_by_chunk, batch_size: int, drop_last: bool,
                  mesh: Mesh) -> Optional[int]:
    """The fewest batches any rank's chunk shard yields (every rank can
    compute it): each rank must run the same number of steps, each with
    its collectives. None in one process."""
    if mesh.world_size <= 1:
        return None
    cap = min(len(ChunkBatchSampler(
        xy_by_chunk, batch_size, drop_last=drop_last,
        replacement_within_chunk=True, num_shards=mesh.world_size,
        shard_id=s)) for s in range(mesh.world_size))
    if cap == 0:
        raise ValueError(
            f"a process shard yields 0 batches ({mesh.world_size} "
            f"processes, {len(xy_by_chunk)} chunks): use fewer processes or "
            "a bigger or finer-chunked cube")
    return cap


def train(cfg: Dict[str, Any]) -> Dict[str, Any]:
    t_setup = time.perf_counter()
    mesh = hosts.training_mesh(cfg.get("device", "cuda"),
                               bool(cfg.get("data_parallel")),
                               "forest_tpu_torch.training.train_vqvae")
    device = mesh.device
    run_dir = Path(cfg["run_dir"])
    schema_path = run_dir / "schema.json"
    if hosts.is_primary():
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "config.json").write_text(json.dumps(
            {k: str(v) if isinstance(v, Path) else v
             for k, v in cfg.items()}, indent=1, default=str))
        # 1. schema (exposure-aware vocab collapse)
        if not schema_path.exists():
            cube = LegacyCube(cfg["zarr"])
            build_and_save_schema(
                cube, run_dir, cfg["batch_size"], cfg["steps_per_epoch"],
                cfg["min_hits_per_epoch"], cfg["mass_coverage"],
                cfg["vocab_cap"])
            log.info("schema written to %s", schema_path)
    hosts.sync()

    # 2. datasets + loaders
    block = tuple(cfg["block_size"])
    ds_tr = VQVAEDataset(cfg["zarr"], schema_path, split=cfg["split_train"],
                         eager=cfg["eager"], block_size=block)
    ds_va = VQVAEDataset(cfg["zarr"], schema_path, split=cfg["split_val"],
                         eager=cfg["eager"], block_size=block)
    log.info("train pixels: %d  val pixels: %d", len(ds_tr), len(ds_va))

    # 3. model
    cat_vocab = {n: ds_tr.schema_cat[n]["num_ids"] for n in ds_tr.cat_names}
    model = VQVAE(
        cont_dim=len(ds_tr.cont_names), cat_vocab_sizes=cat_vocab,
        naip_bands=ds_tr.naip.shape[-1], num_timesteps=len(ds_tr.ds["years"]),
        emb_dim=cfg["emb_dim"], codebook_size=cfg["codebook_size"],
        beta=cfg["beta"], hidden=cfg["hidden"], quantizer=cfg["quantizer"],
        cat_emb_dim=cfg["cat_emb_dim"], ema_decay=cfg["ema_decay"],
        ema_eps=cfg["ema_eps"])
    init_parameters(model, torch.Generator().manual_seed(int(cfg["seed"])))
    model.to(device)
    class_weights = {
        n: torch.as_tensor(ds_tr.class_weights_by_cat_name(n)).to(device)
        for n in ds_tr.cat_names}

    total_steps = cfg["epochs"] * cfg["steps_per_epoch"]
    lr_sched = cosine_lr(cfg["lr"], total_steps, cfg["min_lr"])
    opt = vqvae_step.make_optimizer(lr_sched, cfg["weight_decay"],
                                    cfg["clip_grad"])
    state = vqvae_step.init_train_state(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    log.info("model params: %.2f M on %s", n_params / 1e6, device)

    if mesh.group is not None:
        log.info("data-parallel over %d processes (rank %d on %s)",
                 mesh.world_size, mesh.rank, device)
    train_step = dp.make_dp_train_step(model, opt, mesh, class_weights)
    eval_step = dp.make_dp_eval_step(model, mesh, class_weights)
    # the compact wire: off unless the YAML asks for it, and in one process
    use_wire = bool(cfg.get("wire_compact")) and mesh.world_size == 1
    wire_bounds = wire_int_bounds(ds_tr) if use_wire else None
    if use_wire:
        log.info("compact wire on (bfloat16 floats, packed masks, narrow "
                 "ids: %s)", wire_bounds)
    spd = int(cfg.get("steps_per_dispatch") or 1)
    if spd > 1:
        log.warning("steps_per_dispatch=%d ignored: %s one step at a time",
                    spd, f"{mesh.world_size} data-parallel ranks run"
                    if mesh.world_size > 1 else "the port runs")
    tr_cap = _lockstep_cap(ds_tr.xy_by_chunk, cfg["batch_size"],
                           cfg["drop_last"], mesh)
    va_cap = _lockstep_cap(ds_va.xy_by_chunk, cfg["batch_size"], True, mesh)
    epoch_cap = min(cfg["steps_per_epoch"], tr_cap or cfg["steps_per_epoch"])
    val_steps = min(cfg.get("val_steps", 20),
                    va_cap or cfg.get("val_steps", 20))

    ckpt = CheckpointManager(run_dir / "ckpt", prefix="ckpt", top_k=1,
                             periodic_every=cfg.get("ckpt_every", 1),
                             monitor="val/loss_total",
                             monitor_start_epoch=0)
    start_epoch = 0
    if not cfg.get("no_resume"):
        resumed = ckpt.maybe_resume(state)
        if resumed is not None:
            state, meta = resumed
            start_epoch = int(meta.get("epoch", -1)) + 1
            log.info("auto-resumed from epoch %d", start_epoch - 1)
    state = hosts.replicate_state(state)

    annealer = build_vq_annealer(cfg)
    extra_meta = {"model_version": "vqvae-1",
                  "model_config": model_config_dict(model)}
    log.info("setup in %.1fs", time.perf_counter() - t_setup)

    global_step = start_epoch * cfg["steps_per_epoch"]
    max_steps = cfg.get("max_steps")
    history = []
    for epoch in range(start_epoch, cfg["epochs"]):
        sampler = ChunkBatchSampler(
            ds_tr.xy_by_chunk, cfg["batch_size"],
            drop_last=cfg["drop_last"],
            replacement_within_chunk=True, seed=cfg["seed"] + epoch,
            num_shards=mesh.world_size, shard_id=mesh.rank)
        loader = PrefetchLoader(ds_tr, sampler,
                                num_workers=cfg["num_workers"])
        t0 = time.perf_counter()
        wait_t = step_t = 0.0
        n_steps = 0
        agg: Dict[str, float] = {}
        pending: list = []  # on-device metric dicts awaiting a block fetch

        def drain():
            # one device-to-host fetch (and synchronisation) per block of
            # steps instead of one per step
            if pending:
                keys = list(pending[0])
                tot = torch.stack([torch.stack([m[k].float() for k in keys])
                                   for m in pending]).sum(0).tolist()
                for k, v in zip(keys, tot):
                    agg[k] = agg.get(k, 0.0) + v
                pending.clear()

        t_wait = time.perf_counter()
        for batch in loader:
            wait_t += time.perf_counter() - t_wait
            t_step = time.perf_counter()
            w = annealer(global_step)
            db = host_to_device_batch(batch, device, use_wire, wire_bounds)
            state, m = train_step(state, db, w)
            global_step += 1
            n_steps += 1
            pending.append(m)
            if len(pending) >= _DRAIN_EVERY:
                drain()
            step_t += time.perf_counter() - t_step
            t_wait = time.perf_counter()
            if n_steps >= epoch_cap:
                break
            if max_steps and global_step >= max_steps:
                break
        loader.close()
        drain()

        train_metrics = {f"train/{k.replace('loss/', 'loss_')}": v / n_steps
                         for k, v in agg.items()}
        # validation
        va_sampler = ChunkBatchSampler(ds_va.xy_by_chunk, cfg["batch_size"],
                                       drop_last=True, seed=0,
                                       replacement_within_chunk=True,
                                       num_shards=mesh.world_size,
                                       shard_id=mesh.rank)
        va_agg: Dict[str, float] = {}
        nv = 0
        w = annealer(global_step)
        va_loader = PrefetchLoader(ds_va, va_sampler,
                                   num_workers=cfg["num_workers"])
        for batch in va_loader:
            m = eval_step(host_to_device_batch(batch, device, use_wire,
                                               wire_bounds), w)
            keys = list(m)
            for k, v in zip(keys, torch.stack(
                    [m[k].float() for k in keys]).tolist()):
                va_agg[k] = va_agg.get(k, 0.0) + v
            nv += 1
            if nv >= val_steps:
                break
        va_loader.close()
        val_metrics = {f"val/{k.replace('loss/', 'loss_')}": v / max(nv, 1)
                       for k, v in va_agg.items()}

        dt = time.perf_counter() - t0
        metrics = {**train_metrics, **val_metrics,
                   "epoch_time_s": dt, "wait_s": wait_t, "step_s": step_t,
                   "steps_per_s": n_steps / max(dt, 1e-9)}
        history.append({"epoch": epoch, **metrics})
        log.info(
            "epoch %d: train %.4f  val %.4f  ppl %.1f  %.1f steps/s "
            "(wait %.1fs / step %.1fs)",
            epoch, train_metrics.get("train/loss_total", float("nan")),
            val_metrics.get("val/loss_total", float("nan")),
            train_metrics.get("train/perplexity", float("nan")),
            metrics["steps_per_s"], wait_t, step_t)
        if hosts.is_primary():
            ckpt.save(epoch, state, metrics, extra_meta)
        hosts.sync()
        if max_steps and global_step >= max_steps:
            break

    if hosts.is_primary():
        (run_dir / "history.json").write_text(json.dumps(history, indent=1))
    hosts.sync()
    return {"state": state, "model": model, "history": history,
            "dataset": ds_tr}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("--zarr", default=None)
    ap.add_argument("--run-dir", dest="run_dir", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    ap.add_argument("--steps-per-epoch", dest="steps_per_epoch", type=int,
                    default=None)
    ap.add_argument("--max-steps", dest="max_steps", type=int, default=None)
    ap.add_argument("--num-workers", dest="num_workers", type=int,
                    default=None)
    ap.add_argument("--quantizer", default=None)
    ap.add_argument("--no-resume", dest="no_resume", action="store_true",
                    default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = vars(ap.parse_args(argv))
    cfg = load_config(args.pop("config"), args)
    if not cfg.get("zarr") or not cfg.get("run_dir"):
        raise SystemExit("--zarr and --run-dir (or config) are required")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    # no-op unless torchrun or FOREST_TPU_* configure several processes
    hosts.initialize(device=cfg.get("device", "cuda"))
    try:
        train(cfg)
    finally:
        hosts.shutdown()


if __name__ == "__main__":
    main()
