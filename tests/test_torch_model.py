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
from torch_parity import t

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


def test_projection_head_is_refused():
    cfg = {"version": "4", "model": {"type_projection": {
        "enabled": True, "hidden_dim": 8, "output_dim": 4}}}
    with pytest.raises(NotImplementedError):
        trep.from_config(cfg, 4, 3)


def test_init_parameters_is_seeded():
    a = trep.from_config(TINY_CFG, 4, 3)
    b = trep.from_config(TINY_CFG, 4, 3)
    trep.init_parameters(a, torch.Generator().manual_seed(0))
    trep.init_parameters(b, torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.all(a.phase_film.gamma_1.bias == 1.0)
    assert float(a.phase_film.gamma_1.weight.detach().std()) < 0.05
