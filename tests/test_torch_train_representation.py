"""The port's FRL training CLI against the JAX package's, on the CPU.

One synthetic v2 cube (96², patches of 32, the EVT codes of
``tests/test_evt_training_e2e.py``) and the e2e model (z_type 12):

- ``StatsCalculator`` of both packages on the same cube: univariate entries
  and counts exactly equal, covariance matrix and mean to rtol 1e-6;
- ``train()`` of both packages for 2 epochs of at most 3 batches of 4 (the
  second a ragged tail), both auto-resuming from one starting state written
  by the JAX package (its initial parameters, seeded AdamW moments, count
  and step 3: with zero moments Adam's first steps are lr * sign(g), and
  the gradients that are zero but for rounding -- the FiLM shift, the last
  encoder norm's bias -- would take a random sign in each package), the
  same ``stats.json`` and the same draws: the port's
  ``step.draw_step_randoms`` returns the JAX step's draws for the key
  ``jax.random.key(generator.initial_seed())``; dropout and input dropout
  0. Three cases: the type losses alone (the phase ramp still 0, the
  two-phase learning rate), the phase losses live in epoch 1, and EVT on.
  Every history key per epoch (the loader and step timings aside) within
  rtol 1e-4 and the step test's atol 1e-6 (for means near 0 such as
  ``film_beta_mean``), the final parameters within rtol 1e-4 / atol 1e-4 x
  the tensor's max |p|, the curricula and ``n_steps`` equal. Largest error
  measured: 2.8e-6 relative on a history value above 1e-2 (EVT case),
  9.2e-6 of max |p| on a parameter;
- checkpoints: a run of 2 epochs resumed to 3 equals an uninterrupted run
  of 3 (constant learning rate; to the same tolerances, since two CPU runs
  of the same program differ in the last bits); ``--init-from`` loads
  parameters and starts a fresh optimizer, and refuses another model;
  ``encoder_last.msgpack`` crosses both ways between the packages'
  ``CheckpointManager`` with params, mu, nu, count and step equal; the
  port's checkpoint serves in the port's ``EncoderService``;
- the unported options are refused; the default device is ``cuda``, which
  raises without a card.
"""
import copy
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from forest_tpu.data import zarrlite as jzl
from forest_tpu.data.bindings import parse_bindings as jparse
from forest_tpu.data.cube_v2 import build_synthetic_v2_cube, synthetic_bindings
from forest_tpu.data.frl_dataset import ForestDatasetV2 as JDataset
from forest_tpu.data.stats import StatsCalculator as JStats
from forest_tpu.models import representation as jrep
from forest_tpu.training import checkpointing as jckpt
from forest_tpu.training import train_representation as jtr
from forest_tpu.training.representation import config_builders as jcb
from forest_tpu.training.representation import training_config as jtc
from forest_tpu_torch.data import parse_bindings as tparse
from forest_tpu_torch.data.frl_dataset import ForestDatasetV2 as TDataset
from forest_tpu_torch.data.stats import StatsCalculator as TStats
from forest_tpu_torch.data.stats import compute_stats_from_config
from forest_tpu_torch.models.conv2d_encoder import EncoderDraws
from forest_tpu_torch.serving import EncoderService
from forest_tpu_torch.training import checkpointing as tckpt
from forest_tpu_torch.training import train_representation as ttr
from forest_tpu_torch.training.representation import curriculum as tcur
from forest_tpu_torch.training.representation import step as tstep
from forest_tpu_torch.training.representation import training_config as ttc
from forest_tpu_torch.utils.flax_bridge import (adam_state_to_flax,
                                                params_from_flax,
                                                params_to_flax)
from torch_parity import tiny_step_draws

MODEL_CFG = {"version": "4", "model": {
    "z_type_dim": 12, "z_phase_dim": 4,
    "type_encoder": {"channels": [24, 12]},
    "phase_tcn": {"channels": [16, 16], "dilations": [1, 2]}}}
TIMINGS = ("epoch_time_s", "wait_s", "step_s")
CASES = ("type", "phase", "evt")


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    """The cube, plain and EVT bindings, and the JAX package's initial
    parameters as a params-only checkpoint."""
    root = tmp_path_factory.mktemp("frl_cli")
    build_synthetic_v2_cube(root / "cube.zarr", height=96, width=96,
                            chunk_yx=32, n_types=4, seed=3)
    plain = synthetic_bindings(root / "cube.zarr", root / "stats.json")
    evt = synthetic_bindings(root / "cube.zarr", root / "stats_evt.json")
    evt["features"]["evt_class"] = {
        "dim": ["C", "H", "W"],
        "channels": {"static_categorical.evt": {"norm": "identity"}}}
    codes = sorted(int(c) for c in np.unique(np.asarray(
        jzl.open_zarr(root / "cube.zarr")["static/evt/data/evt"][:]))
        if c >= 0)
    rng = np.random.default_rng(0)
    conf = rng.integers(5, 40, size=(len(codes), len(codes))).astype(float)
    conf += np.diag(rng.integers(100, 200, size=len(codes)).astype(float))
    lines = ["," + ",".join(map(str, codes))] + [
        f"{c}," + ",".join(map(str, row)) for c, row in zip(codes, conf)]
    (root / "evt_confusion.csv").write_text("\n".join(lines))
    evt["losses"]["evt_soft_neighborhood"] = {
        "type": "evt_soft_neighborhood",
        "feature": "static_categorical.evt", "counts_feature": "evt_class",
        "confusion_csv": str(root / "evt_confusion.csv"),
        "min_count": 10, "diffusion_steps": 2,
        "tau_ref": 0.5, "tau_learned": 0.5}
    paths = {}
    for name, raw in (("plain", plain), ("evt", evt)):
        paths[name] = root / f"bindings_{name}.yaml"
        paths[name].write_text(yaml.safe_dump(raw))
    jm = jrep.from_config(MODEL_CFG, 4, 3)
    params = jax.tree_util.tree_map(np.asarray, jrep.init_variables(
        jm, jax.random.key(11), num_timesteps=15)["params"])
    init = root / "init.msgpack"
    jckpt.save_state(init, {"params": params}, {})
    rng = np.random.default_rng(5)
    mu = jax.tree_util.tree_map(lambda p: rng.normal(
        scale=1e-2, size=p.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda p: rng.uniform(
        1e-5, 1e-3, size=p.shape).astype(np.float32), params)
    three = np.asarray(3, np.int32)
    jckpt.save_state(root / "start.msgpack", {
        "params": params, "step": three, "opt_state": {"0": {}, "1": {
            "0": {"count": three, "mu": mu, "nu": nu}, "1": {},
            "2": {"count": three}}}}, {"epoch": -1})
    return root, paths, init


def start_from_seeded_state(cfg):
    """Put the starting state where ``cfg``'s run auto-resumes from."""
    root = Path(cfg.run.run_root).parent
    ck = cfg.run.experiment_dir / cfg.run.ckpt_dir
    ck.mkdir(parents=True, exist_ok=True)
    for suffix in ("", ".json"):
        shutil.copy(root / f"start.msgpack{suffix}",
                    ck / f"encoder_last.msgpack{suffix}")


def training_dict(root, name, case, **over):
    raw = {
        "run": {"experiment_name": name, "run_root": str(root / "runs"),
                "checkpoint": {"save_top_k": 1, "save_every_n_epochs": 1}},
        "training": {"epoch": {"num_epochs": 2, "mode": "full",
                               "batch_size": 4}},
        "optimizer": {"lr": 1e-3},
        "scheduler": {"warmup_epochs": 1, "phase_rewarmup": True,
                      "rewarmup_epochs": 1},
        "spatial_domain": {"patch_size": 32, "split_block_size": [1, 1]},
        "curriculum": {"input_dropout": 0.0, "smoothing_freeze_until": 1,
                       "smoothing_ramp_epochs": 1,
                       "phase_start_epoch": 5 if case == "type" else 0,
                       "phase_ramp_epochs": 1},
        "hardware": {"num_workers": 2},
    }
    if case == "evt":
        raw["loss_weights"] = {"evt": 0.5}
    for k, v in over.items():
        raw[k] = {**raw.get(k, {}), **v}
    return raw


def jax_draws(monkeypatch, bindings_path, builder):
    """Make the port's step take the JAX step's draws for the key its
    generator's seed names; dropout is 0, so the dropout draws keep all."""
    jsampler = jcb.build_sampler(jparse(str(bindings_path)), builder)

    def draws(generator, batch_size, patch_size, sampler, cfg, model=None,
              train=True, device="cuda"):
        enc = phase = None
        if train:
            enc = EncoderDraws(torch.zeros(batch_size, 1, 1,
                                           model.encoder.in_channels))
            phase = ()
        return tiny_step_draws(jax.random.key(generator.initial_seed()),
                               jsampler, cfg.xb_neg_per_anchor, enc, phase,
                               bsz=batch_size, hw=patch_size)

    monkeypatch.setattr(tstep, "draw_step_randoms", draws)


_RUNS = {}


def run_both(cube, case):
    """Both packages' train() for ``case`` (once per module)."""
    if case in _RUNS:
        return _RUNS[case]
    root, paths, init = cube
    bpath = str(paths["evt" if case == "evt" else "plain"])
    raw_j = training_dict(root, f"jax_{case}", case)
    raw_t = training_dict(root, f"torch_{case}", case)
    jcfg = jtc.parse_training_config(raw_j)
    tcfg = ttc.parse_training_config(raw_t)
    start_from_seeded_state(jcfg)
    start_from_seeded_state(tcfg)
    j = jtr.train(jcfg, bpath, MODEL_CFG, max_batches=3)
    with pytest.MonkeyPatch.context() as mp:
        jax_draws(mp, bpath, tcfg.as_builder_dict())
        t = ttr.train(tcfg, bpath, MODEL_CFG, max_batches=3, device="cpu")
    assert t["start_epoch"] == 0
    _RUNS[case] = (j, t, jcfg, tcfg, bpath)
    return _RUNS[case]


@pytest.mark.parametrize("case", CASES)
def test_cli_tracks_jax(cube, case):
    j, t, _, _, _ = run_both(cube, case)
    assert t["curricula"] == j["curricula"]
    assert t["steps_per_epoch"] == j["steps_per_epoch"]
    assert t["step_cfg"].evt_enabled == j["step_cfg"].evt_enabled == \
        (case == "evt")
    assert len(t["history"]) == len(j["history"]) == 2
    worst = 0.0
    for th, jh in zip(t["history"], j["history"]):
        assert th["train/n_steps"] == jh["train/n_steps"] == 2
        assert th["val/n_steps"] == jh["val/n_steps"]
        assert th["train/skipped"] == 0
        assert_history_close(th, jh, f"epoch {th['epoch']}")
        worst = max([worst] + [abs(th[k] - v) / abs(v) for k, v in jh.items()
                               if not k.endswith(TIMINGS)
                               and np.isfinite(v) and abs(v) > 1e-2])
    # the curricula reached the step: loss_total is the sum of the losses
    # under each epoch's ramped weights (the phase losses live in epoch 1
    # of the phase and EVT cases, never in the type case)
    cur = t["curricula"]
    for h in t["history"]:
        ramp = tcur.ramp_weight(h["epoch"], cur["phase_start_epoch"],
                                cur["phase_ramp_epochs"])
        total = sum(w * (ramp if k in cur["phase_ramped_losses"] else 1.0)
                    * h.get(f"train/loss_{k}", 0.0)
                    for k, w in t["weights"].items())
        np.testing.assert_allclose(h["train/loss_total"], total, rtol=1e-5)
        assert (ramp > 0) == (case != "type" and h["epoch"] == 1)
    if case == "evt":
        assert t["history"][1]["train/loss_evt"] > 0
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   j["state"].params))
    got = {n: p.detach().numpy() for n, p in t["model"].named_parameters()}
    assert_params_close(got, {n: v.numpy() for n, v in want.items()})
    worst_p = max(float(np.abs(got[n] - v.numpy()).max()
                        / np.abs(v.numpy()).max()) for n, v in want.items())
    assert t["state"].step == int(j["state"].step) == 3 + 4
    assert t["state"].count == int(j["state"].opt_state[1][0].count)
    print(f"{case}: largest error {worst:.2e} relative on a history value "
          f"above 1e-2, {worst_p:.2e} of max |p| on a parameter")


def test_stats_match_jax(cube):
    root, paths, _ = cube
    kw = dict(split=None, patch_size=32, split_block_size=(1, 1))
    jb, tb = jparse(str(paths["evt"])), tparse(str(paths["evt"]))
    want = JStats(jb, JDataset(jb, **kw), seed=0).compute()
    got = TStats(tb, TDataset(tb, **kw), seed=0, device="cpu").compute()
    assert set(got) == set(want)
    n_cov = 0
    for fname in want:
        assert set(got[fname]) == set(want[fname])
        for ref, entry in want[fname].items():
            if ref == "__covariance__":
                n_cov += 1
                for k in ("matrix", "mean"):
                    np.testing.assert_allclose(
                        got[fname][ref][k], entry[k], rtol=1e-6,
                        err_msg=f"{fname} {k}")
                assert got[fname][ref]["n"] == entry["n"]
                assert got[fname][ref]["stat_domain"] == entry["stat_domain"]
            else:
                assert got[fname][ref] == entry, (fname, ref)
    assert n_cov == 2
    assert len(want["evt_class"]["static_categorical.evt"]["counts"]) >= 2


def test_compute_stats_from_config_writes_the_sidecar(cube, tmp_path):
    root, paths, _ = cube
    tb = tparse(str(paths["plain"]))
    tb.stats.file = str(tmp_path / "stats.json")
    kw = dict(patch_size=32, split_block_size=(1, 1))
    out = compute_stats_from_config(tb, device="cpu", **kw)
    assert out == tmp_path / "stats.json"
    want = TStats(tb, TDataset(tb, split=None, **kw), device="cpu").compute()
    assert json.loads(out.read_text()) == json.loads(json.dumps(want))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_checkpoints_cross_load_both_ways(cube):
    j, t, jcfg, tcfg, _ = run_both(cube, "type")
    jdir = jcfg.run.experiment_dir / jcfg.run.ckpt_dir
    tdir = tcfg.run.experiment_dir / tcfg.run.ckpt_dir
    jstate = j["state"]
    jadam = jstate.opt_state[1][0]
    jtree = {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
             "mu": jax.tree_util.tree_map(np.asarray, jadam.mu),
             "nu": jax.tree_util.tree_map(np.asarray, jadam.nu)}
    # the JAX package's checkpoint, resumed in the port
    state = copy.deepcopy(t["state"])
    state, meta = tckpt.CheckpointManager(jdir, prefix="encoder") \
        .maybe_resume(state)
    assert meta["epoch"] == 1
    mu, nu, count = adam_state_to_flax(state.mu, state.nu, state.count)
    _assert_trees_equal({"params": params_to_flax(dict(
        state.model.named_parameters())), "mu": mu, "nu": nu}, jtree)
    assert (state.count, state.step) == (int(jadam.count), int(jstate.step))
    # the port's checkpoint, resumed in the JAX package
    jloaded, meta = jckpt.CheckpointManager(tdir, prefix="encoder") \
        .maybe_resume(jstate)
    tstate = t["state"]
    mu, nu, _ = adam_state_to_flax(tstate.mu, tstate.nu, tstate.count)
    ladam = jloaded.opt_state[1][0]
    _assert_trees_equal(
        {"params": jax.tree_util.tree_map(np.asarray, jloaded.params),
         "mu": jax.tree_util.tree_map(np.asarray, ladam.mu),
         "nu": jax.tree_util.tree_map(np.asarray, ladam.nu)},
        {"params": params_to_flax(dict(tstate.model.named_parameters())),
         "mu": mu, "nu": nu})
    assert int(ladam.count) == tstate.count
    assert int(jloaded.opt_state[1][2].count) == tstate.count
    assert int(jloaded.step) == tstate.step
    assert meta["model_version"] == "4"
    assert meta["model_config"]["model"]["z_type_dim"] == 12


def test_port_checkpoint_serves(cube):
    _, t, _, tcfg, bpath = run_both(cube, "type")
    ckpt = tcfg.run.experiment_dir / tcfg.run.ckpt_dir / \
        "encoder_last.msgpack"
    patch = t["ds_val"].get_patch(0)
    groups = {k: v for k, v in patch.items() if not k.startswith("__")}
    service = EncoderService(ckpt, bpath, device="cpu", max_batch=2)
    try:
        z = service.encode(groups)["z_type"]
    finally:
        service.close()
    model = t["model"].eval()
    with torch.no_grad():
        x, _ = service.fb.build_feature(
            "type_encoder_input",
            {k: torch.as_tensor(v)[None] for k, v in groups.items()})
        want = model(x)[0].numpy()
    assert z.shape == (32, 32, 12)
    np.testing.assert_allclose(z, want, rtol=1e-5, atol=1e-6)


def assert_history_close(got, want, where=""):
    assert set(got) == set(want)
    for k in sorted(want):
        if not k.endswith(TIMINGS):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{where} {k}")


def assert_params_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_resumed_run_equals_an_uninterrupted_one(cube):
    root, paths, _ = cube
    const = {"scheduler": {"warmup_epochs": 0, "phase_rewarmup": False,
                           "min_lr_factor": 1.0}}
    runs = {}
    for name, epochs in (("resumed", (2, 3)), ("whole", (3,))):
        for n in epochs:
            cfg = ttc.parse_training_config(training_dict(
                root, f"torch_{name}", "phase", **const,
                training={"epoch": {"num_epochs": n, "mode": "full",
                                    "batch_size": 4}}))
            if n == epochs[0]:
                start_from_seeded_state(cfg)
            runs[name, n] = ttr.train(cfg, str(paths["plain"]), MODEL_CFG,
                                      max_batches=3, device="cpu")
    resumed, whole = runs["resumed", 3], runs["whole", 3]
    assert resumed["start_epoch"] == 2
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert [h["epoch"] for h in whole["history"]] == [0, 1, 2]
    assert_history_close(resumed["history"][0], whole["history"][2])
    assert_params_close(
        {n: p.detach().numpy() for n, p in
         resumed["model"].named_parameters()},
        {n: p.detach().numpy() for n, p in whole["model"].named_parameters()})
    assert resumed["state"].step == whole["state"].step == 3 + 6
    assert resumed["state"].count == whole["state"].count


def test_init_from_loads_params_with_a_fresh_optimizer(cube, tmp_path):
    root, paths, init = cube
    cfg = ttc.parse_training_config(training_dict(root, "init", "type"))
    ctx = ttr.setup(cfg, str(paths["plain"]), MODEL_CFG, device="cpu")
    state = ttr._warm_start(ctx["state"], ctx["optimizer"], str(init))
    raw, _ = tckpt.load_state_raw(init)
    assert_params_close({n: p.detach().numpy() for n, p in
                         state.model.named_parameters()},
                        params_from_flax(raw["params"]))
    assert (state.count, state.step) == (0, 0)
    assert all(not m.any() for m in state.mu.values())
    wide = copy.deepcopy(MODEL_CFG)
    wide["model"]["type_encoder"]["channels"] = [32, 12]
    cfg.run.experiment_name = "init_wide"
    with pytest.raises(ValueError, match="does not match the configured"):
        ttr.train(cfg, str(paths["plain"]), wide, max_batches=1,
                  init_from=str(init), device="cpu")


@pytest.mark.parametrize("setting,match", [
    ({"env": ("FOREST_TPU_NUM_PROCESSES", "2")}, "multi-process"),
    ({"env": ("FOREST_TPU_COORDINATOR", "localhost:1234")},
     "multi-process"),
    ({"env": ("WORLD_SIZE", "4")}, "multi-process"),
    ({"data_parallel_cards": 2}, "queue 6")])
def test_unported_options_are_refused(cube, monkeypatch, tmp_path, setting,
                                      match):
    root, paths, _ = cube
    over = {"run": {"experiment_name": "refused",
                    "run_root": str(tmp_path / "runs")}}
    model_cfg = copy.deepcopy(MODEL_CFG)
    if "env" in setting:
        monkeypatch.setenv(*setting["env"])
    if "data_parallel_cards" in setting:
        over["hardware"] = {"data_parallel": True}
        monkeypatch.setattr(torch.cuda, "device_count",
                            lambda: setting["data_parallel_cards"])
    cfg = ttc.parse_training_config(training_dict(root, "x", "type", **over))
    with pytest.raises(NotImplementedError, match=match):
        ttr.train(cfg, str(paths["plain"]), model_cfg, max_batches=1,
                  device="cpu")
    assert not (tmp_path / "runs").exists()   # refused before any write


def test_projection_head_trains_and_crosses_to_jax(cube, tmp_path):
    """A model config with ``type_projection`` enabled trains through the
    CLI (the head gets no gradient, as in the JAX step), and its checkpoint
    loads in the JAX package's ``load_frozen_model``: ``project_type`` of
    both within rtol / atol 1e-5."""
    from forest_tpu.eval import frozen as jfrozen
    root, paths, _ = cube
    model_cfg = copy.deepcopy(MODEL_CFG)
    model_cfg["model"]["type_projection"] = {
        "enabled": True, "hidden_dim": 10, "output_dim": 5}
    cfg = ttc.parse_training_config(training_dict(
        root, "proj", "type", run={"experiment_name": "proj",
                                   "run_root": str(tmp_path / "runs")}))
    out = ttr.train(cfg, str(paths["plain"]), model_cfg, max_batches=1,
                    device="cpu")
    jm, jp = jfrozen.load_frozen_model(
        cfg.run.experiment_dir / cfg.run.ckpt_dir / "encoder_last.msgpack")
    z = np.random.default_rng(3).normal(size=(7, 12)).astype(np.float32)
    ref = jm.apply({"params": jp}, z, method=jm.project_type)
    with torch.no_grad():
        got = out["model"].project_type(torch.from_numpy(z))
    assert got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_data_parallel_on_one_card_is_a_no_op(cube, monkeypatch, tmp_path):
    root, paths, _ = cube
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = ttc.parse_training_config(training_dict(
        root, "one_card", "type", hardware={"data_parallel": True},
        run={"experiment_name": "dp1", "run_root": str(tmp_path)},
        training={"epoch": {"num_epochs": 1, "mode": "full",
                            "batch_size": 4}}))
    out = ttr.train(cfg, str(paths["plain"]), MODEL_CFG, max_batches=1,
                    device="cpu")
    assert np.isfinite(out["history"][0]["train/loss_total"])


def test_the_default_device_is_the_card(cube, tmp_path):
    assert ttr.train.__defaults__[-1] == "cuda"
    assert ttr.setup.__defaults__[-1] == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    root, paths, _ = cube
    tpath = tmp_path / "training.yaml"
    tpath.write_text(yaml.safe_dump(training_dict(
        root, "default_device", "type",
        run={"experiment_name": "dd", "run_root": str(tmp_path / "runs")})))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.main(["--training", str(tpath), "--bindings",
                  str(paths["plain"])])
    assert not (tmp_path / "runs").exists()


def test_cli_main_writes_the_run(cube, tmp_path):
    """main() with --device cpu: the files of a run, then auto-resume."""
    root, paths, _ = cube
    mpath = tmp_path / "model.yaml"
    mpath.write_text(yaml.safe_dump(MODEL_CFG))
    tpath = tmp_path / "training.yaml"
    tpath.write_text(yaml.safe_dump(training_dict(
        root, "cli", "type",
        run={"experiment_name": "cli", "run_root": str(tmp_path / "runs"),
             "checkpoint": {"save_top_k": 2, "save_every_n_epochs": 1}})))
    argv = ["--training", str(tpath), "--bindings", str(paths["plain"]),
            "--model-config", str(mpath), "--max-batches", "1",
            "--num-epochs", "1", "--device", "cpu"]
    first = ttr.main(argv)
    exp = tmp_path / "runs" / "cli"
    for f in ("provenance.json", "history.json", "configs/model.yaml",
              "configs/bindings.yaml", "configs/training_resolved.json",
              "checkpoints/encoder_last.msgpack",
              "checkpoints/encoder_last.msgpack.json",
              "checkpoints/encoder_epoch_000.msgpack",
              "checkpoints/encoder_best_0.msgpack"):
        assert (exp / f).exists(), f
    again = ttr.main(argv[:-3] + ["2", "--device", "cpu"])
    assert again["start_epoch"] == 1
    assert [h["epoch"] for h in json.loads(
        (exp / "history.json").read_text())] == [1]
    assert again["state"].step == first["state"].step + 1
