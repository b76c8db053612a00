"""Shared pieces of the forest_tpu_torch parity tests.

Inputs are made once with numpy from a seed and handed to both packages;
JAX runs on the CPU (tests/conftest.py), torch on the CPU. TF32 is off so a
float32 comparison means float32 on a card too.
"""
import numpy as np
import pytest
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def t(a) -> torch.Tensor:
    """numpy / jax array -> float32 CPU tensor (a copy)."""
    return torch.from_numpy(np.array(a, np.float32))


def softmax_np(x: np.ndarray, axis: int) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def bank_mix_inputs(rng, b, h, w, c, nd=4, r=4):
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    a_w = softmax_np(rng.normal(size=(b, h, w, 2 * nd, r)), 3)
    b_w = softmax_np(rng.normal(size=(b, h, w, c, r)), 4)
    return x, a_w, b_w


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README)")
    return torch.device("cuda", 0)


def flax_params(init, seed, *args, **kwargs):
    """The flax parameter tree of ``init(key, *args)``, every leaf drawn as
    N(0, 0.3^2) noise (plus 1 for norm scales, which keeps GroupNorm well
    conditioned). Shapes come from ``jax.eval_shape``: no init runs."""
    import jax
    import jax.numpy as jnp
    shapes = jax.eval_shape(lambda k: init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, v in flat:
        noise = rng.normal(scale=0.3, size=v.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "scale":
            noise += 1.0
        leaves.append(jnp.asarray(noise))
    return jax.tree_util.tree_unflatten(tree, leaves)


def ti(a) -> torch.Tensor:
    """numpy / jax integer array -> int64 CPU tensor (a copy)."""
    return torch.from_numpy(np.array(a, np.int64))


def jax_anchor_draws(key, bsz, hw, cfg):
    """The raw draws behind ``vmap(sampler)(split(key, bsz))`` of the JAX
    package (``anchor_sampling.py``: per sample, key -> (grid key,
    supplement key) for grid-plus-supplement; grid key -> (ky, kx) -> one
    randint each; supplement key -> uniform over H*W).
    -> (jitter [B, 2] int64, supplement_u [B, H*W] or None)."""
    import jax
    r = cfg.jitter_radius
    jitter, supp = [], []
    for k in jax.random.split(key, bsz):
        if cfg.strategy == "grid-plus-supplement":
            k, ks = jax.random.split(k)
            supp.append(np.asarray(jax.random.uniform(ks, (hw * hw,))))
        ky, kx = jax.random.split(k)
        jitter.append([int(jax.random.randint(ky, (), -r, r + 1)),
                       int(jax.random.randint(kx, (), -r, r + 1))])
    return ti(jitter), (t(np.stack(supp)) if supp else None)


def jax_negative_draws(key, bsz, hw, n_anchors, pool):
    """The raw draws behind ``vmap(spatial_negative_slots)`` with
    ``split(key, bsz)``: per sample key -> (k_pool, k_pick), uniform over
    H*W and uniform [n_anchors, pool]. -> (pool_u, pick_u)."""
    import jax
    pool_u, pick_u = [], []
    for k in jax.random.split(key, bsz):
        k_pool, k_pick = jax.random.split(k)
        pool_u.append(np.asarray(jax.random.uniform(k_pool, (hw * hw,))))
        pick_u.append(np.asarray(jax.random.uniform(k_pick,
                                                    (n_anchors, pool))))
    return t(np.stack(pool_u)), t(np.stack(pick_u))


class record_bernoulli:
    """Context manager: records the uniform draw behind every
    ``jax.random.bernoulli`` call (bernoulli(key, p, shape) is
    ``uniform(key, shape) < p``), in call order, as float32 tensors. With
    ``traced``, inside a function that is traced (``jax.jit``): the draws
    are the trace's own arrays, which the function returns as outputs."""

    def __init__(self, traced: bool = False):
        self.traced = traced

    def __enter__(self):
        import jax
        self.jax = jax
        self.draws = []
        self._orig = jax.random.bernoulli

        def bernoulli(key, p=0.5, shape=None):
            shape = tuple(shape) if shape is not None else np.shape(p)
            u = jax.random.uniform(key, shape, np.float32)
            self.draws.append(u if self.traced else t(np.asarray(u)))
            return self._orig(key, p, shape)

        jax.random.bernoulli = bernoulli
        return self

    def __exit__(self, *exc):
        self.jax.random.bernoulli = self._orig
        return False


_JITTED = {}


def jax_step(jproc, params, batch, rng, weights, curriculum, train,
             grad=True):
    """The JAX step, jitted once per ``jproc`` (weights, curriculum and rng
    are traced): -> ((loss, metrics), grads or None, dropout draws as
    float32 tensors in call order)."""
    import jax
    import jax.numpy as jnp
    key = (id(jproc), bool(train), bool(grad))
    fn = _JITTED.get(key)
    if fn is None:
        step = (jax.value_and_grad(jproc, has_aux=True) if grad
                else jproc)

        def run(p, b, r, w, c):
            with record_bernoulli(traced=True) as rec:
                out = step(p, b, r, w, c, train)
            return out, rec.draws

        fn = _JITTED[key] = (jproc, jax.jit(run))
    out, draws = fn[1](
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
        {k: jnp.float32(v) for k, v in weights.items()},
        {k: jnp.float32(v) for k, v in curriculum.items()})
    draws = [t(np.asarray(d)) for d in draws]
    return (out[0], out[1], draws) if grad else (out, None, draws)


EVT_CODES = (7001, 7002, 7003)      # synthetic_frl_batch's codes
EVT_COUNTS = {7001: 500, 7002: 300, 7003: 120}


def jax_evt_tables(tmp_path):
    """The JAX package's EVT tables over the synthetic batch's codes."""
    from forest_tpu.losses.evt_soft_neighborhood import EvtDiffusionMetric
    from forest_tpu_torch.losses.evt_soft_neighborhood import \
        write_synthetic_confusion_csv
    from forest_tpu.training.representation.step import build_evt_tables
    csv_path = write_synthetic_confusion_csv(
        tmp_path / "evt_confusion.csv", EVT_CODES)
    return build_evt_tables(EvtDiffusionMetric(csv_path, EVT_COUNTS,
                                               min_count=10))


# --- the tiny training assembly of tests/frl_tiny.py, in both packages ---
TINY_HW, TINY_T, TINY_B = 32, 15, 2
TINY_MODEL = dict(type_in_channels=4, phase_in_channels=3, z_type_dim=8,
                  type_encoder_channels=(16, 8), z_phase_dim=3,
                  phase_tcn_channels=(12, 12), phase_tcn_dilations=(1, 2))


TYPE_WEIGHTS = ("spatial_infonce", "spectral_infonce", "vicreg_type")


def type_weights():
    """DEFAULT_WEIGHTS with only the type pathway's three losses on."""
    from forest_tpu_torch.training.representation import step as tstep
    return {k: (v if k in TYPE_WEIGHTS else 0.0)
            for k, v in tstep.DEFAULT_WEIGHTS.items()}


def full_weights():
    """DEFAULT_WEIGHTS: every loss but EVT on."""
    from forest_tpu_torch.training.representation import step as tstep
    return dict(tstep.DEFAULT_WEIGHTS)


def build_tiny_steps(encoder_dropout=0.0, strategy=None, seed=0,
                     edit_stats=None, phase_dropout=0.0, evt_tables=None,
                     diag=False):
    """Both packages' process_batch over the same bindings, stats (after
    ``edit_stats(stats)`` when given) and parameters; ``evt_tables`` from
    the JAX ``build_evt_tables`` turns EVT on (weight 0.1 in the training
    config) in both. -> (jax process, jax params, torch process, torch
    model, jax sampler)."""
    from forest_tpu.data.bindings import parse_bindings as jparse
    from forest_tpu.data.cube_v2 import (synthetic_bindings,
                                         synthetic_feature_stats)
    from forest_tpu.data.feature_builder import FeatureBuilder as JFB
    from forest_tpu.models import representation as jrep
    from forest_tpu.training.representation import config_builders as jcb
    from forest_tpu.training.representation import step as jstep
    from forest_tpu_torch.data import parse_bindings as tparse
    from forest_tpu_torch.data.feature_builder import FeatureBuilder as TFB
    from forest_tpu_torch.models import representation as trep
    from forest_tpu_torch.training.representation import \
        config_builders as tcb
    from forest_tpu_torch.training.representation import step as tstep
    from forest_tpu_torch.utils.flax_bridge import params_from_flax
    raw = synthetic_bindings("/dev/null", "/dev/null")
    training_cfg = {"sampling_strategy": strategy} if strategy else {}
    if evt_tables is not None:
        raw["losses"]["evt_soft_neighborhood"] = {
            "feature": "static_categorical.evt", "weight": 0.1}
    jb, tb = jparse(raw), tparse(raw)
    stats = synthetic_feature_stats(jb)
    if edit_stats is not None:
        edit_stats(stats)
    jm = jrep.RepresentationModel(type_encoder_dropout=encoder_dropout,
                                  phase_tcn_dropout=phase_dropout,
                                  **TINY_MODEL)
    params = flax_params(
        lambda k: jrep.init_variables(jm, k, num_timesteps=TINY_T), seed)
    jsampler = jcb.build_sampler(jb, training_cfg)
    jcfg = jcb.build_step_config(jb, training_cfg)
    jproc = jstep.make_process_batch(
        jm, JFB(jb, stats), jsampler, jcfg, TINY_HW, evt_tables=evt_tables,
        diag=diag)
    tm = trep.RepresentationModel(type_encoder_dropout=encoder_dropout,
                                  phase_tcn_dropout=phase_dropout,
                                  **TINY_MODEL)
    tm.load_state_dict(params_from_flax(params), strict=True)
    tcfg = tcb.build_step_config(tb, training_cfg)
    assert tcfg.evt_enabled == (evt_tables is not None) == jcfg.evt_enabled
    tproc = tstep.make_process_batch(
        tm, TFB(tb, stats), tcb.build_sampler(tb, training_cfg), tcfg,
        TINY_HW, evt_tables=evt_tables, diag=diag, device="cpu")
    return jproc, params, tproc, tm, jsampler


def tiny_step_draws(rng, jsampler, cfg_xb_neg=4, encoder=None, phase=None,
                    bsz=TINY_B, hw=TINY_HW):
    """The port's StepDraws holding the raw draws the JAX step makes from
    ``rng`` for a batch of ``bsz`` patches of ``hw``² (step.py: rng ->
    (k_anchor, k_neg, k_drop); anchors from split(k_anchor, B), negatives
    from split(k_neg, B), cross-batch negatives from fold_in(k_neg, 7))."""
    import jax
    from forest_tpu_torch.training.representation import step as tstep
    k_anchor, k_neg, _ = jax.random.split(rng, 3)
    a = jsampler.n_anchors(hw, hw)
    jitter, supp_u = jax_anchor_draws(k_anchor, bsz, hw, jsampler.cfg)
    pool_u, pick_u = jax_negative_draws(
        k_neg, bsz, hw, a, min(tstep.NEG_POOL_SIZE, hw * hw))
    neg_j = jax.random.randint(jax.random.fold_in(k_neg, 7),
                               (bsz * a, cfg_xb_neg), 0, bsz * a)
    return tstep.StepDraws(jitter, supp_u, pool_u, pick_u, ti(neg_j),
                           encoder, phase)


# --- the eval tools' shared fixture ---------------------------------------

EVAL_CFG = {"version": "4", "model": {
    "z_type_dim": 8, "z_phase_dim": 3,
    "type_encoder": {"channels": [16, 8], "num_groups": 4},
    "spatial_conv": {"gate_hidden": 8},
    "phase_tcn": {"channels": [12, 12], "dilations": [1, 2],
                  "num_groups": 4}}}
EVAL_CFG_PROJ = {"version": "4", "model": {
    **EVAL_CFG["model"],
    "type_projection": {"enabled": True, "hidden_dim": 10,
                        "output_dim": 5}}}
EVAL_HW, EVAL_CHUNK, EVAL_PATCH = 96, 32, 32
# a temporal probe target whose inverse runs a transform, a robust affine
# and the whitening
PHASE_TARGET = {
    "dim": ["C", "T", "H", "W"],
    "channels": {"annual.ysfc": {"transform": "log1p", "norm": "zscore"},
                 "annual.nbr": {"mask": "annual_mask.ccdc_ok",
                                "norm": "robust_iqr"}},
    "covariance": {"calculate": True, "stat_domain": "patch"}}


def _eval_cube(root, build_cube, make_bindings):
    """The cube, its bindings (``phase_target`` the phase loss's
    neighbourhood target) and their stats (the port's ``StatsCalculator``
    over every patch) in ``root`` -> the bindings' path."""
    import yaml

    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.data.stats import compute_stats_from_config

    build_cube(root / "cube.zarr", height=EVAL_HW, width=EVAL_HW,
               chunk_yx=EVAL_CHUNK)
    raw = make_bindings(root / "cube.zarr", root / "stats.json")
    raw["features"]["phase_target"] = PHASE_TARGET
    raw["losses"]["phase_neighborhood"]["neighborhood_target"] = \
        "features.phase_target"
    bpath = root / "bindings.yaml"
    bpath.write_text(yaml.safe_dump(raw))
    compute_stats_from_config(parse_bindings(raw), device="cpu",
                              patch_size=EVAL_PATCH)
    return bpath


def write_eval_fixture(root, seed=0):
    """A 96 x 96 synthetic v2 cube (chunks of 32) from the JAX package's
    builder, its bindings and stats (:func:`_eval_cube`), and two
    checkpoints of a tiny flax RepresentationModel with seeded parameters
    written by the JAX package's ``save_state``: without and with the type
    projection head. -> dict of paths."""
    import jax

    from forest_tpu.data.cube_v2 import (build_synthetic_v2_cube,
                                         synthetic_bindings)
    from forest_tpu.models import representation as jrep
    from forest_tpu.training.checkpointing import save_state

    out = {"root": root, "bindings": _eval_cube(
        root, build_synthetic_v2_cube, synthetic_bindings)}
    for name, cfg in (("ckpt", EVAL_CFG), ("ckpt_proj", EVAL_CFG_PROJ)):
        jm = jrep.from_config(cfg, 4, 3)
        params = flax_params(lambda k: jrep.init_variables(jm, k), seed)
        path = root / f"{name}.msgpack"
        save_state(path, {"params": jax.device_get(params), "step": 3},
                   {"model_config": cfg, "type_in_channels": 4,
                    "phase_in_channels": 3})
        out[name] = path
    return out


def write_port_eval_fixture(root, seed=0):
    """:func:`write_eval_fixture` with the port's own cube builder and
    checkpoints (``init_parameters`` from ``seed``): nothing of JAX or
    flax, for the card's machine, which has no flax."""
    from forest_tpu_torch.data.cube_v2 import (build_synthetic_v2_cube,
                                               synthetic_bindings)
    from forest_tpu_torch.models import representation as trep
    from forest_tpu_torch.training.checkpointing import save_state
    from forest_tpu_torch.utils.flax_bridge import params_to_flax

    out = {"root": root, "bindings": _eval_cube(
        root, build_synthetic_v2_cube, synthetic_bindings)}
    for name, cfg in (("ckpt", EVAL_CFG), ("ckpt_proj", EVAL_CFG_PROJ)):
        model = trep.from_config(cfg, 4, 3)
        trep.init_parameters(model, torch.Generator().manual_seed(seed))
        path = root / f"{name}.msgpack"
        save_state(path, {"params": params_to_flax(model.state_dict())},
                   {"model_config": cfg, "type_in_channels": 4,
                    "phase_in_channels": 3})
        out[name] = path
    return out


def eval_locations(path) -> int:
    """A points CSV (row, col, year) for ``embed_locations``: 14 points
    inside the 96 x 96 cube, with and without a year (years outside the
    window among them), and 3 off it. -> the number of points."""
    import csv
    rng = np.random.default_rng(2)
    rows = [(int(r), int(c), y) for (r, c), y in zip(
        rng.integers(0, EVAL_HW, (14, 2)),
        [None, 2012, 2024, 1990, 2016, None, 2010, 2030, 2019, None,
         2015, 2011, None, 2020])]
    rows += [(120, 5, 2015), (3, 400, None), (EVAL_HW, 0, None)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["row", "col", "year"])
        for r, c, y in rows:
            w.writerow([r, c, "" if y is None else y])
    return len(rows)


def read_csv(path):
    """-> (column names, rows as dicts of strings)."""
    import csv
    with open(path) as f:
        rd = csv.DictReader(f)
        return rd.fieldnames, list(rd)


# --- the reference-checkpoint importer --------------------------------

def reference_state_dict(rng, cfg, tin, pin):
    """A reference-shaped state_dict (numpy, N(0, 0.2^2) from ``rng``) for
    a version-4 model config: the reference's key names and layouts, the
    Sobel buffers and, with the projection head, a BatchNorm1d with its
    running statistics (the key inventory of ``utils/torch_import.py``)."""
    m = cfg["model"]
    zt, zp = m["z_type_dim"], m["z_phase_dim"]
    tch = list(m["type_encoder"]["channels"])
    ks = m["type_encoder"].get("kernel_size", 1)
    pch = list(m["phase_tcn"]["channels"])
    pk = m["phase_tcn"].get("kernel_size", 3)
    s = m.get("spatial_conv", {})
    gh = s.get("gate_hidden", 64)
    gk = s.get("gate_kernel_size", 3)
    nd = s.get("num_directions", 4)
    r = s.get("rank", 4)
    proj = m.get("type_projection") or {}

    def t(*shape):
        return rng.normal(scale=0.2, size=shape).astype(np.float32)

    sd = {}
    j, prev = 0, tin
    for i, ch in enumerate(tch):
        sd[f"encoder.layers.{j}.weight"] = t(ch, prev, ks, ks)
        sd[f"encoder.layers.{j + 1}.weight"] = t(ch)
        sd[f"encoder.layers.{j + 1}.bias"] = t(ch)
        j += 2 + (1 if i < len(tch) - 1 else 0)  # ReLU slot (dropout=0)
        prev = ch

    c = zt
    sd["spatial_conv.bank"] = t(nd, c, 1, 3, 3)
    sd["spatial_conv.sobel_x"] = t(c, 1, 3, 3)
    sd["spatial_conv.sobel_y"] = t(c, 1, 3, 3)
    sd["spatial_conv.mix_backbone.0.weight"] = t(gh, 2 * c, 3, 3)
    sd["spatial_conv.mix_backbone.0.bias"] = t(gh)
    sd["spatial_conv.mix_head_A.weight"] = t(2 * nd * r, gh, 1, 1)
    sd["spatial_conv.mix_head_A.bias"] = t(2 * nd * r)
    sd["spatial_conv.mix_head_B.weight"] = t(c * r, gh, 1, 1)
    sd["spatial_conv.mix_head_B.bias"] = t(c * r)
    sd["spatial_conv.gate_net.0.weight"] = t(gh, c, gk, gk)
    sd["spatial_conv.gate_net.0.bias"] = t(gh)
    sd["spatial_conv.gate_net.2.weight"] = t(c, gh, gk, gk)
    sd["spatial_conv.gate_net.2.bias"] = t(c)

    prev = pin
    for i, ch in enumerate(pch):
        pre = f"phase_tcn.layers.{i}"
        if prev != ch:
            sd[f"{pre}.projection.weight"] = t(ch, prev, 1)
            sd[f"{pre}.projection.bias"] = t(ch)
        sd[f"{pre}.conv.weight"] = t(ch, prev, pk)
        sd[f"{pre}.conv.bias"] = t(ch)
        sd[f"{pre}.norm.weight"] = t(ch)
        sd[f"{pre}.norm.bias"] = t(ch)
        sd[f"{pre}.gate.weight"] = t(ch, ch, 1)
        sd[f"{pre}.gate.bias"] = t(ch)
        prev = ch

    sd["phase_head.weight"] = t(zp, pch[-1], 1, 1)
    sd["phase_head.bias"] = t(zp)
    fh = max(zt, zp) // 2
    for net in ("gamma_network", "beta_network"):
        sd[f"phase_film.{net}.0.weight"] = t(fh, zt, 1, 1)
        sd[f"phase_film.{net}.0.bias"] = t(fh)
        sd[f"phase_film.{net}.2.weight"] = t(zp, fh, 1, 1)
        sd[f"phase_film.{net}.2.bias"] = t(zp)

    if proj:
        ph, po = proj["hidden_dim"], proj["output_dim"]
        sd["type_projection.net.0.weight"] = t(ph, zt)
        sd["type_projection.net.0.bias"] = t(ph)
        sd["type_projection.net.1.weight"] = np.abs(t(ph)) + 0.5
        sd["type_projection.net.1.bias"] = t(ph)
        sd["type_projection.net.1.running_mean"] = t(ph)
        sd["type_projection.net.1.running_var"] = np.abs(t(ph)) + 0.5
        sd["type_projection.net.1.num_batches_tracked"] = np.asarray(7)
        sd["type_projection.net.3.weight"] = t(po, ph)
        sd["type_projection.net.3.bias"] = t(po)
    return sd
