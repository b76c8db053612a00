"""forest_tpu_torch.models against the flax modules of forest_tpu.models.

Each module of the serving path is initialised in flax, its parameters are
perturbed from a seed (so GroupNorm scales / biases and FiLM heads are not
at their identity init), carried over with ``utils.flax_bridge``, and both
run on the same seeded numpy inputs on the CPU.

Tolerances: float32 rtol 1e-5 / atol 1e-5 -- flax's GroupNorm takes the
variance as E[x^2] - E[x]^2 and torch in two passes, and the convs sum in
another order; the bf16 ``compute_dtype`` case, atol 0.1 / rtol 0.05 on
O(1) outputs -- the two frameworks round to bf16 at different places
(torch's softmax and the bank run in float32 internally, XLA's in bf16),
which leaves a few bf16 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.models import conditioning as jcond
from forest_tpu.models import conv2d_encoder as jenc
from forest_tpu.models import representation as jrep
from forest_tpu.models import spatial as jspatial
from forest_tpu.models import tcn as jtcn
from forest_tpu_torch.models import conditioning as tcond
from forest_tpu_torch.models import conv2d_encoder as tenc
from forest_tpu_torch.models import representation as trep
from forest_tpu_torch.models import spatial as tspatial
from forest_tpu_torch.models import tcn as ttcn
from forest_tpu_torch.utils.flax_bridge import params_from_flax
from torch_parity import record_bernoulli, t

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.1)


def flax_params(init, seed, *args, **kwargs):
    """The flax parameter tree of ``init(key, *args)``, every leaf drawn as
    N(0, 0.3^2) noise (plus 1 for norm scales, which keeps GroupNorm well
    conditioned). Shapes come from ``jax.eval_shape``: no init runs."""
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


def bridge(params, module: torch.nn.Module) -> torch.nn.Module:
    module.load_state_dict(params_from_flax(params), strict=True)
    return module.eval()


def rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_conv2d_encoder():
    x = rand(0, 2, 9, 11, 4)
    jm = jenc.Conv2DEncoder(channels=(12, 6), num_groups=4)
    p = flax_params(jm.init, 1, jnp.asarray(x))
    ref = jm.apply({"params": p}, jnp.asarray(x))
    tm = bridge(p, tenc.Conv2DEncoder(4, (12, 6), num_groups=4))
    with torch.no_grad():
        out = tm(t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_edge_aware_smoothing(compute_dtype):
    x = rand(2, 2, 13, 10, 6)
    kw = dict(channels=6, gate_hidden=8, num_directions=4,
              coarse_dilation=3, rank=4)
    jm = jspatial.EdgeAwareSmoothingConv2D(
        **kw, compute_dtype=compute_dtype, use_pallas=False)
    p = flax_params(jm.init, 3, jnp.asarray(x))
    ref, ref_gate = jm.apply({"params": p}, jnp.asarray(x), min_gate=0.2,
                             return_gate=True)
    tm = bridge(p, tspatial.EdgeAwareSmoothingConv2D(
        **kw, compute_dtype=compute_dtype))
    with torch.no_grad():
        out, gate = tm(t(x), min_gate=0.2, return_gate=True)
    tol = F32 if compute_dtype is None else BF16
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(gate.numpy(), np.asarray(ref_gate), **tol)
    assert float(gate.min()) >= 0.2 - 1e-3


def test_conv2d_encoder_training_dropout():
    """Input and layer channel dropout with flax's own draws: the uniform
    numbers behind its two ``bernoulli`` calls go to the port."""
    x = rand(20, 3, 9, 11, 4)
    jm = jenc.Conv2DEncoder(channels=(12, 10, 6), num_groups=2,
                            dropout_rate=0.3)
    p = flax_params(jm.init, 21, jnp.asarray(x))
    with record_bernoulli() as rec:
        ref = jm.apply({"params": p}, jnp.asarray(x), deterministic=False,
                       input_dropout_rate=jnp.float32(0.4),
                       rngs={"dropout": jax.random.key(5)})
    assert [tuple(d.shape) for d in rec.draws] == [
        (3, 1, 1, 4), (3, 1, 1, 12), (3, 1, 1, 10)]
    tm = bridge(p, tenc.Conv2DEncoder(4, (12, 10, 6), num_groups=2,
                                      dropout_rate=0.3))
    draws = tenc.EncoderDraws(rec.draws[0], tuple(rec.draws[1:]))
    with torch.no_grad():
        out = tm(t(x), input_dropout_rate=0.4, deterministic=False,
                 draws=draws)
        same = tm(t(x), input_dropout_rate=0.4, deterministic=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    assert not np.allclose(out.numpy(), same.numpy())
    # from a generator: seeded, and rate 0 is the identity
    g = [tm(t(x), input_dropout_rate=0.4, deterministic=False,
            generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    tm0 = bridge(p, tenc.Conv2DEncoder(4, (12, 10, 6), num_groups=2))
    with torch.no_grad():
        np.testing.assert_array_equal(
            tm0(t(x), deterministic=False,
                generator=torch.Generator().manual_seed(0)).numpy(),
            tm0(t(x)).numpy())


def test_edge_aware_smoothing_gradients():
    """Gradients to x and to every parameter of the block against jax.grad
    (float32; 1e-4 of each tensor's largest magnitude: sums over all pixels
    in another order); the bf16 block hands float32 gradients to its
    float32 parameters."""
    x = rand(22, 2, 13, 10, 6)
    wgt = rand(23, 2, 13, 10, 6)
    kw = dict(channels=6, gate_hidden=8, num_directions=4,
              coarse_dilation=3, rank=4)
    jm = jspatial.EdgeAwareSmoothingConv2D(**kw, use_pallas=False)
    p = flax_params(jm.init, 24, jnp.asarray(x))
    gp, gx = jax.grad(
        lambda p_, x_: jnp.sum(jm.apply({"params": p_}, x_, min_gate=0.1)
                               * jnp.asarray(wgt)), argnums=(0, 1))(
        p, jnp.asarray(x))
    tm = bridge(p, tspatial.EdgeAwareSmoothingConv2D(**kw))
    tx = t(x).requires_grad_(True)
    (tm(tx, min_gate=0.1) * t(wgt)).sum().backward()
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, gp))
    ref["x"] = t(gx)
    got = {n: v.grad for n, v in tm.named_parameters()}
    got["x"] = tx.grad
    assert len(got) == 11
    for name, g in got.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)

    tb = bridge(p, tspatial.EdgeAwareSmoothingConv2D(
        **kw, compute_dtype="bfloat16"))
    tx = t(x).requires_grad_(True)
    (tb(tx, min_gate=0.1) * t(wgt)).sum().backward()
    for name, v in list(tb.named_parameters()) + [("x", tx)]:
        assert v.grad.dtype == torch.float32, name
        assert torch.isfinite(v.grad).all(), name
        f32 = got[name].flatten()
        cos = torch.dot(v.grad.flatten(), f32) / (v.grad.norm() * f32.norm())
        assert cos > 0.98, (name, float(cos))   # bf16 noise, same direction


def test_representation_model_training_forward():
    cfg = {**TINY_CFG, "model": {**TINY_CFG["model"], "type_encoder": {
        "channels": [12, 6], "num_groups": 4, "dropout_rate": 0.2}}}
    jm, p, tm = _pair(cfg, seed=25)
    assert tm.encoder.dropout_rate == 0.2
    x = rand(26, 2, 12, 10, 4)
    with record_bernoulli() as rec:
        zt_ref, gate_ref = jm.apply(
            {"params": p}, jnp.asarray(x), return_gate=True,
            input_dropout_rate=jnp.float32(0.5), min_gate=jnp.float32(0.3),
            deterministic=False, rngs={"dropout": jax.random.key(1)})
    draws = tenc.EncoderDraws(rec.draws[0], tuple(rec.draws[1:]))
    with torch.no_grad():
        zt, gate = tm(t(x), return_gate=True, input_dropout_rate=0.5,
                      min_gate=torch.tensor(0.3), deterministic=False,
                      draws=draws)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zt_ref), **F32)
    np.testing.assert_allclose(gate.numpy(), np.asarray(gate_ref), **F32)
    assert trep.model_config_dict(tm) == jrep.model_config_dict(jm)


@pytest.mark.parametrize("c_in,c_out,dilation", [(3, 8, 2), (8, 8, 1)])
def test_gated_residual_block(c_in, c_out, dilation):
    x = rand(4, 5, 15, c_in)
    jm = jtcn.GatedResidualBlock(out_channels=c_out, dilation=dilation,
                                 num_groups=4)
    p = flax_params(jm.init, 5, jnp.asarray(x))
    ref = jm.apply({"params": p}, jnp.asarray(x))
    tm = bridge(p, ttcn.GatedResidualBlock(c_in, c_out, dilation=dilation,
                                           num_groups=4))
    with torch.no_grad():
        out = tm(t(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("pooling,masked", [
    ("none", False), ("stats", True), ("stats", False)])
def test_tcn_encoder(pooling, masked):
    x = rand(6, 6, 15, 3)
    mask = None
    if masked:
        mask = (np.random.default_rng(7).random((6, 15)) > 0.3).astype(
            np.float32)
    jm = jtcn.TCNEncoder(channels=(8, 8), dilations=(1, 2), num_groups=4,
                         pooling=pooling)
    p = flax_params(jm.init, 8, jnp.asarray(x))
    ref = jm.apply({"params": p}, jnp.asarray(x),
                   None if mask is None else jnp.asarray(mask))
    tm = bridge(p, ttcn.TCNEncoder(3, (8, 8), dilations=(1, 2),
                                   num_groups=4, pooling=pooling))
    with torch.no_grad():
        out = tm(t(x), None if mask is None else t(mask))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_tcn_encoder_training_dropout():
    """Channel dropout at every block's input with flax's own draws (the
    uniform behind each ``jax.random.bernoulli``, [N, 1, C_in])."""
    x = rand(30, 6, 15, 3)
    jm = jtcn.TCNEncoder(channels=(8, 8), dilations=(1, 2), num_groups=4,
                         dropout_rate=0.3)
    p = flax_params(jm.init, 31, jnp.asarray(x))
    with record_bernoulli() as rec:
        ref = jm.apply({"params": p}, jnp.asarray(x), deterministic=False,
                       rngs={"dropout": jax.random.key(3)})
    assert [tuple(d.shape) for d in rec.draws] == [(6, 1, 3), (6, 1, 8)]
    assert any((d >= 0.7).any() for d in rec.draws)
    tm = bridge(p, ttcn.TCNEncoder(3, (8, 8), dilations=(1, 2),
                                   num_groups=4, dropout_rate=0.3))
    assert [tuple(d.shape) for d in tm.draw(6, None, "cpu")] == [
        (6, 1, 3), (6, 1, 8)]
    with torch.no_grad():
        out = tm(t(x), deterministic=False, draws=tuple(rec.draws))
        same = tm(t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(
        same.numpy(), np.asarray(jm.apply({"params": p}, jnp.asarray(x))),
        **F32)
    assert not np.allclose(out.numpy(), same.numpy())
    with pytest.raises(ValueError, match="draws"):
        tm(t(x), deterministic=False)


def test_film_layer():
    z = rand(9, 7, 6)
    jm = jcond.FiLMLayer(target_dim=3)
    p = flax_params(jm.init, 10, jnp.asarray(z))
    g_ref, b_ref = jm.apply({"params": p}, jnp.asarray(z))
    tm = bridge(p, tcond.FiLMLayer(6, 3))
    with torch.no_grad():
        g, b = tm(t(z))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **F32)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), **F32)
    h = rand(11, 7, 3)
    np.testing.assert_allclose(
        tcond.FiLMLayer.modulate(t(h), g, b).numpy(),
        np.asarray(jcond.FiLMLayer.modulate(jnp.asarray(h), g_ref, b_ref)),
        **F32)


TINY_CFG = {"version": "4", "model": {
    "z_type_dim": 6, "z_phase_dim": 3,
    "type_encoder": {"channels": [12, 6], "num_groups": 4},
    "spatial_conv": {"gate_hidden": 8},
    "phase_tcn": {"channels": [8, 8], "dilations": [1, 2],
                  "num_groups": 4}}}


def _pair(cfg, seed=12):
    jm = jrep.from_config(cfg, 4, 3)
    p = flax_params(lambda k: jrep.init_variables(jm, k), seed)
    tm = bridge(p, trep.from_config(cfg, 4, 3))
    return jm, p, tm


def test_representation_model_all_paths():
    jm, p, tm = _pair(TINY_CFG)
    v = {"params": p}
    x = rand(13, 2, 12, 10, 4)
    xp = rand(14, 2, 5, 12, 10, 3)
    zt_ref = jm.apply(v, jnp.asarray(x))
    zp_ref = jm.apply(v, jnp.asarray(xp), zt_ref, method=jm.forward_phase)
    px, zpx = rand(15, 9, 5, 3), rand(16, 9, 6)
    loc_ref = jm.apply(v, jnp.asarray(px), jnp.asarray(zpx),
                       method=jm.forward_phase_at_locations)
    with torch.no_grad():
        zt, gate = tm(t(x), min_gate=0.1, return_gate=True)
        loc = tm.forward_phase_at_locations(t(px), t(zpx))
    zt_gate_ref, gate_ref = jm.apply(v, jnp.asarray(x), min_gate=0.1,
                                     return_gate=True)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zt_gate_ref), **F32)
    np.testing.assert_allclose(gate.numpy(), np.asarray(gate_ref), **F32)
    with torch.no_grad():
        zt = tm(t(x))
        zp = tm.forward_phase(t(xp), zt)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zt_ref), **F32)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zp_ref), **F32)
    np.testing.assert_allclose(loc.numpy(), np.asarray(loc_ref), **F32)


def test_representation_model_bf16_smoothing():
    cfg = {**TINY_CFG, "model": {**TINY_CFG["model"], "spatial_conv": {
        "gate_hidden": 8, "compute_dtype": "bfloat16"}}}
    jm, p, tm = _pair(cfg, seed=17)
    x = rand(18, 2, 12, 10, 4)
    ref = jm.apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BF16)


def test_config_round_trip_matches_jax():
    jm = jrep.from_config(TINY_CFG, 4, 3)
    tm = trep.from_config(TINY_CFG, 4, 3)
    assert trep.model_config_dict(tm) == jrep.model_config_dict(jm)
    again = trep.from_config(trep.model_config_dict(tm), 4, 3)
    assert again.hparams == tm.hparams


def test_phase_forward_training_with_tcn_dropout():
    """``forward_phase_at_locations`` in training mode as the train step
    calls it (z, gamma, beta and the pre-FiLM h) with a phase dropout of
    0.3 and flax's draws."""
    cfg = {**TINY_CFG, "model": {**TINY_CFG["model"], "phase_tcn": {
        **TINY_CFG["model"]["phase_tcn"], "dropout_rate": 0.3}}}
    jm, p, tm = _pair(cfg, seed=32)
    assert tm.phase_tcn.dropout_rate == 0.3
    px, zpx = rand(33, 9, 5, 3), rand(34, 9, 6)
    with record_bernoulli() as rec:
        ref = jm.apply({"params": p}, jnp.asarray(px), jnp.asarray(zpx),
                       return_film=True, return_pre_film=True,
                       deterministic=False,
                       method=jm.forward_phase_at_locations,
                       rngs={"dropout": jax.random.key(4)})
    with torch.no_grad():
        got = tm.forward_phase_at_locations(
            t(px), t(zpx), return_film=True, return_pre_film=True,
            deterministic=False, draws=tuple(rec.draws))
    assert len(got) == 4
    for name, a, b in zip(("z", "gamma", "beta", "h_pre"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **F32)


def test_phase_dropout_config_round_trips():
    cfg = {**TINY_CFG, "model": {**TINY_CFG["model"], "phase_tcn": {
        **TINY_CFG["model"]["phase_tcn"], "dropout_rate": 0.2}}}
    tm = trep.from_config(cfg, 4, 3)
    assert tm.phase_tcn.dropout_rate == 0.2
    out = trep.model_config_dict(tm)
    assert out["model"]["phase_tcn"]["dropout_rate"] == 0.2
    assert out == jrep.model_config_dict(jrep.from_config(cfg, 4, 3))
    assert trep.from_config(out, 4, 3).hparams == tm.hparams


def test_projection_head_is_refused():
    """A config with ``type_projection.enabled`` is not refused: it builds
    the SimCLR head, whose ``project_type`` matches flax's (rtol / atol
    1e-5), and the config round-trips. Without the head ``project_type`` is
    the identity."""
    cfg = {**TINY_CFG, "model": {**TINY_CFG["model"], "type_projection": {
        "enabled": True, "hidden_dim": 8, "output_dim": 4}}}
    jm, p, tm = _pair(cfg, seed=41)
    z = rand(42, 11, 6)
    ref = jm.apply({"params": p}, jnp.asarray(z), method=jm.project_type)
    with torch.no_grad():
        got = tm.project_type(t(z))
    assert got.shape == (11, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    assert trep.model_config_dict(tm) == jrep.model_config_dict(jm)
    plain = trep.from_config(TINY_CFG, 4, 3)
    assert plain.project_type(t(z)).numpy().tobytes() == z.tobytes()


def test_init_parameters_is_seeded():
    a = trep.from_config(TINY_CFG, 4, 3)
    b = trep.from_config(TINY_CFG, 4, 3)
    trep.init_parameters(a, torch.Generator().manual_seed(0))
    trep.init_parameters(b, torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.all(a.phase_film.gamma_1.bias == 1.0)
    assert float(a.phase_film.gamma_1.weight.detach().std()) < 0.05
