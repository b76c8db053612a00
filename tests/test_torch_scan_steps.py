"""K train steps per block: ``vqvae_step.make_scan_train_step`` and the CLI's
``steps_per_dispatch``, against K sequential port steps and the JAX scan.

- the port's block of K = 4 steps equals 4 sequential ``train_step`` calls
  on the same slices, per-step weights and reseed draws bit for bit
  (parameters, Adam's moments, EMA state, every metric), with the draws
  taken from one generator and with ``pick`` injected;
- it tracks the JAX package's ``make_scan_train_step`` on the same stacked
  block, compact-wire encoded, with the JAX block's reseed draws (one per
  key of ``split(rng, K)``) injected as ``pick``: metrics, parameters and
  EMA state to 1e-5, the reseeded codes the same;
- ``python -m forest_tpu_torch.training.train_vqvae`` with a YAML that sets
  ``steps_per_dispatch: 3`` and ``wire_compact: true`` trains 4 steps to
  ``state.step == 4``, one step at a time as it logs, its history equal
  bit for bit to the run with ``steps_per_dispatch: 1``;
- an epoch whose sampler yields fewer batches than ``steps_per_epoch``,
  the last one short, trains every batch it yields and counts no other.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.data import wire as jwire
from forest_tpu.ops import vq as jvq
from forest_tpu.training import vqvae_step as jstep
from forest_tpu.training.scheduler import cosine_lr as jcosine
from forest_tpu_torch.data import wire as twire
from forest_tpu_torch.data.cube import build_synthetic_cube
from forest_tpu_torch.data.loader import make_device_put
from forest_tpu_torch.training import train_vqvae
from forest_tpu_torch.training import vqvae_step as tstep
from forest_tpu_torch.training.checkpointing import load_state_raw
from forest_tpu_torch.training.scheduler import cosine_lr as tcosine
from test_torch_vqvae_model import build_pair, make_batch
from test_torch_vqvae_step import assert_tree_close, class_weights
from torch_parity import ti

K, CODES, ROWS = 4, 16, 24
WEIGHTS = [{"cont": 1.0, "cat": 1.0, "canopy": 1.0 - 0.1 * i,
            "vq": 0.02 * i} for i in range(K)]
DEAD = (1, 6, 9)        # codes the EMA has given up on
# make_batch's ids: "cat" in [-1, vocab + 2), the targets in [-100, vocab)
BOUNDS = {"cat": (-100, 9), "evt": (-100, 7), "bps": (-100, 5)}


def port_pair(seed=12):
    """The port's model, optimizer, step and a state with DEAD codes."""
    rng = np.random.default_rng(11)
    batches = [make_batch(rng) for _ in range(K)]
    cw = class_weights(rng)
    jm, params, tm = build_pair(batches[0], seed=seed)
    opt = tstep.make_optimizer(tcosine(1e-3, 10, 1e-4), weight_decay=1e-2,
                               grad_clip=0.5)
    step = tstep.make_train_step(
        tm, opt, {n: torch.from_numpy(w) for n, w in cw.items()},
        reseed_dead=True)
    state = tstep.init_train_state(tm, opt)
    dead = np.ones(CODES, np.float32)
    dead[list(DEAD)] = 1e-6
    state.vq_stats = state.vq_stats._replace(
        cluster_size=torch.from_numpy(dead))
    return jm, params, tm, opt, step, state, batches, cw


def snapshot(state):
    return ({n: p.detach().clone() for n, p in
             state.model.named_parameters()},
            {n: v.clone() for n, v in state.mu.items()},
            {n: v.clone() for n, v in state.nu.items()},
            tuple(v.clone() for v in state.vq_stats), state.step,
            state.count)


def assert_same_bits(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert sorted(x) == sorted(y)
        for n in x:
            assert torch.equal(x[n], y[n]), n
    for x, y in zip(a[3], b[3]):
        assert torch.equal(x, y)
    assert a[4:] == b[4:]


def stacked_block(batches, wire):
    enc = [twire.encode_wire_batch(b, int_bounds=BOUNDS) if wire else b
           for b in batches]
    return make_device_put("cpu", keep_host_keys=())(
        twire.stack_batches(enc))


@pytest.mark.parametrize("draws", ["generator", "pick"])
@pytest.mark.parametrize("wire", [False, True])
def test_scan_equals_sequential_steps_bit_for_bit(draws, wire):
    *_, tm, opt, step, state, batches, _ = port_pair()
    seq_state = state
    *_, tm2, opt2, step2, scan_state, _, _ = port_pair()
    picks = torch.from_numpy(np.random.default_rng(3).integers(
        0, ROWS, size=(K, CODES)))
    gen = torch.Generator().manual_seed(5)
    seq_metrics = []
    for i, b in enumerate(batches):
        b = twire.encode_wire_batch(b, int_bounds=BOUNDS) if wire else b
        b = make_device_put("cpu", keep_host_keys=())(b)
        if draws == "generator":
            seq_state, m = step(seq_state, b, WEIGHTS[i], generator=gen)
        else:
            seq_state, m = step(seq_state, b, WEIGHTS[i], pick=picks[i])
        seq_metrics.append(m)

    multi = tstep.make_scan_train_step(step2)
    sw = {k: [w[k] for w in WEIGHTS] for k in WEIGHTS[0]}
    block = stacked_block(batches, wire)
    scan_draws = (torch.Generator().manual_seed(5) if draws == "generator"
                  else picks)
    scan_state, m = multi(scan_state, block, sw, scan_draws)
    assert sorted(m) == sorted(seq_metrics[0])
    for k in m:
        assert m[k].shape == (K,)
        assert torch.equal(m[k], torch.stack([s[k] for s in seq_metrics])), k
    assert_same_bits(snapshot(scan_state), snapshot(seq_state))
    assert scan_state.step == K
    # the reseed ran: the dead codes were given the batch's mean size
    assert bool((scan_state.vq_stats.cluster_size[list(DEAD)] >= 1e-3).all())


def test_scan_tracks_the_jax_scan_on_a_wire_block():
    jm, params, tm, _, step, tstate, batches, cw = port_pair()
    jopt = jstep.make_optimizer(jcosine(1e-3, 10, 1e-4), weight_decay=1e-2,
                                grad_clip=0.5)
    dead = np.asarray(tstate.vq_stats.cluster_size)
    jstate = jstep.VQVAETrainState(
        params, jopt.init(params),
        jvq.VQStats.init(CODES, 16, codebook=params["codebook"])._replace(
            cluster_size=jnp.asarray(dead)),
        jnp.zeros((), jnp.int32))
    jtrain = jstep.make_train_step(
        jm, jopt, {n: jnp.asarray(w) for n, w in cw.items()},
        use_pallas=False, reseed_dead=True, reseed_threshold=1e-3)
    enc = [jwire.encode_wire_batch(b, int_bounds=BOUNDS) for b in batches]
    jblock = jax.tree.map(jnp.asarray, jwire.stack_batches(enc))
    jw = {k: jnp.asarray([w[k] for w in WEIGHTS], jnp.float32)
          for k in WEIGHTS[0]}
    rng = jax.random.key(7)
    jstate, jm_ = jstep.make_scan_train_step(jtrain)(jstate, jblock, jw, rng)
    # the JAX block's reseed draws: one per key of split(rng, K)
    picks = torch.stack([ti(jax.random.randint(r, (CODES,), 0, ROWS))
                         for r in jax.random.split(rng, K)])
    multi = tstep.make_scan_train_step(step)
    sw = {k: [w[k] for w in WEIGHTS] for k in WEIGHTS[0]}
    tstate, tm_ = multi(tstate, stacked_block(batches, True), sw, picks)
    assert sorted(tm_) == sorted(jm_)
    for k in jm_:
        np.testing.assert_allclose(tm_[k].numpy(), np.asarray(jm_[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert_tree_close(tstate.params, jstate.params, "params")
    for f in jstate.vq_stats._fields:
        np.testing.assert_allclose(getattr(tstate.vq_stats, f).numpy(),
                                   np.asarray(getattr(jstate.vq_stats, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert tstate.step == int(jstate.step) == K


def test_cli_trains_a_yaml_with_steps_per_dispatch_and_the_wire(tmp_path,
                                                                caplog):
    build_synthetic_cube(tmp_path / "cube.zarr", height=64, width=64,
                         chunk_yx=32, patch_size=32, seed=0)
    base = dict(batch_size=32, steps_per_epoch=4, epochs=1, num_workers=1,
                emb_dim=16, codebook_size=16, hidden=32,
                min_hits_per_epoch=1, block_size=[1, 1], val_steps=1,
                wire_compact=True)
    cfg = tmp_path / "block.yaml"
    cfg.write_text(json.dumps({"train_vqvae": dict(base,
                                                   steps_per_dispatch=3)}))
    with caplog.at_level("INFO", logger="forest_tpu_torch.train_vqvae"):
        train_vqvae.main(["--config", str(cfg), "--zarr",
                          str(tmp_path / "cube.zarr"), "--run-dir",
                          str(tmp_path / "block"), "--device", "cpu"])
    assert "steps_per_dispatch=3 ignored: the port runs one step at a " \
        "time" in caplog.text
    raw, meta = load_state_raw(tmp_path / "block/ckpt/ckpt_last.msgpack")
    assert int(np.asarray(raw["step"])) == 4 and meta["epoch"] == 0
    out = train_vqvae.train(dict(
        train_vqvae.load_config(None, {}), **base, steps_per_dispatch=1,
        zarr=str(tmp_path / "cube.zarr"), run_dir=str(tmp_path / "steps"),
        device="cpu"))
    assert out["state"].step == 4 and out["state"].count == 4
    (block,) = json.loads((tmp_path / "block/history.json").read_text())
    (steps,) = out["history"]
    keys = [k for k in steps if k.startswith(("train/", "val/"))]
    assert keys and all(np.isfinite(steps[k]) for k in keys)
    assert {k: block[k] for k in keys} == {k: steps[k] for k in keys}


def test_a_short_epoch_trains_every_batch_the_loader_yields(tmp_path):
    """``steps_per_epoch`` above what the sampler yields, a count that
    ``steps_per_dispatch`` does not divide: every yielded batch is trained
    and only those are counted, in ``state.step`` and in the epoch
    means."""
    from forest_tpu_torch.data.samplers import ChunkBatchSampler
    from forest_tpu_torch.data.vqvae_dataset import VQVAEDataset

    BATCH = 256      # 7 batches of the cube's 1,920 train pixels
    build_synthetic_cube(tmp_path / "cube.zarr", height=64, width=64,
                         chunk_yx=32, patch_size=32, seed=0)
    cfg = dict(train_vqvae.load_config(None, {}), batch_size=BATCH,
               steps_per_epoch=40, epochs=1, num_workers=1, emb_dim=16,
               codebook_size=16, hidden=32, min_hits_per_epoch=1,
               block_size=(1, 1), val_steps=1,
               zarr=str(tmp_path / "cube.zarr"), device="cpu")
    runs = {k: train_vqvae.train(dict(cfg, steps_per_dispatch=k,
                                      run_dir=str(tmp_path / f"k{k}")))
            for k in (4, 1)}
    ds = VQVAEDataset(tmp_path / "cube.zarr", tmp_path / "k4/schema.json",
                      split="train", block_size=(1, 1))
    n = len(ChunkBatchSampler(ds.xy_by_chunk, BATCH, drop_last=True,
                              replacement_within_chunk=True))
    assert n % 4 and n < 40
    for out in runs.values():
        assert out["state"].step == out["state"].count == n
    hist = [{k: v for k, v in out["history"][0].items()
             if k.startswith(("train/", "val/"))} for out in runs.values()]
    assert hist[0] and hist[0] == hist[1]
    assert all(np.isfinite(v) for v in hist[0].values())


def test_several_ranks_run_one_step_at_a_time_on_the_plain_wire(
        tmp_path, monkeypatch, caplog):
    """Under a process group of more than one rank, ``steps_per_dispatch``
    warns and runs one step at a time, and the wire stays off, as in the
    JAX CLI (a mesh of world size 2 stands in for the group: rank 0 samples
    its own shard and runs the lockstep cap)."""
    from forest_tpu_torch.parallel import hosts
    from forest_tpu_torch.parallel.mesh import Mesh

    build_synthetic_cube(tmp_path / "cube.zarr", height=96, width=96,
                         chunk_yx=16, patch_size=32, seed=0)
    monkeypatch.setattr(hosts, "training_mesh", lambda device, *_: Mesh(
        torch.device(device), rank=0, world_size=2))
    multi = []
    monkeypatch.setattr(tstep, "make_scan_train_step",
                        lambda step: multi.append(step))
    cfg = dict(train_vqvae.load_config(None, {}), batch_size=16,
               steps_per_epoch=3, epochs=1, num_workers=1, emb_dim=16,
               codebook_size=16, hidden=32, min_hits_per_epoch=1,
               block_size=(1, 1), val_steps=1, steps_per_dispatch=2,
               wire_compact=True, zarr=str(tmp_path / "cube.zarr"),
               run_dir=str(tmp_path / "run"), device="cpu")
    with caplog.at_level("INFO", logger="forest_tpu_torch.train_vqvae"):
        out = train_vqvae.train(cfg)
    assert out["state"].step == 3 and not multi
    text = caplog.text
    assert "steps_per_dispatch=2 ignored: 2 data-parallel ranks" in text
    assert "compact wire on" not in text
