"""forest_tpu_torch.utils.flops and the kernels' declared costs.

(a) the cases of tests/test_flops.py on the port; (b) each hand-written
kernel's ``torch.library`` op, on a CPU tensor, counted by
``FlopCounterMode`` at exactly its declared FLOPs and nothing of its plain
body; (c) every ``*_cost`` function against its formula, and
``chip_smoke.bound_ms`` from the declared costs equal, to the bit, to the
formulas chip_smoke.py wrote out before the costs were declared, at its
timed shapes; (d) ``step_flops`` of the port's encoders and VQ-VAE against
``forest_tpu.utils.flops.compiled_flops`` of the same flax module with the
same weights (``utils.flax_bridge``); (e) a small FRL train step counted
twice (two steps, other draws) gives the same integer, and on a card the
same integer as on the CPU. JAX and the flax modules are imported only
inside (d): the ``cuda`` case runs on the card's machine, which has no
flax.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from forest_tpu_torch.models import conv2d_encoder as tenc
from forest_tpu_torch.models import tcn as ttcn
from forest_tpu_torch.ops import scatter as tsc
from forest_tpu_torch.ops import smoothing as tsm
from forest_tpu_torch.ops import vq as tvq
from forest_tpu_torch.ops import vq_variants as tvv
from forest_tpu_torch.utils import flops as fl
from forest_tpu_torch.utils.flax_bridge import params_from_flax
from torch_parity import (bank_mix_inputs, cuda_device,  # noqa: F401
                          flax_params, t, ti)

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------ (a) utils/flops
def test_step_flops_of_a_matmul_is_2n3():
    n = 64
    assert fl.step_flops(lambda a, b: a @ b, torch.ones(n, n),
                         torch.ones(n, n)) == 2 * n ** 3


def test_step_flops_counts_the_gradient():
    # forward and the gradient with respect to a: two products
    n = 32
    a = torch.ones(n, n, requires_grad=True)
    b = torch.ones(n, n)
    got = fl.step_flops(lambda: torch.autograd.grad((a @ b).sum(), a))
    assert got >= 2 * n ** 3
    assert got == 4 * n ** 3


def test_step_flops_raises_where_nothing_is_counted():
    with pytest.raises(ValueError, match="no operation"):
        fl.step_flops(lambda x: x + 1, torch.ones(3))


def test_mfu_fields_values():
    out = fl.mfu_fields("x", 66.9e12, 1.0, peaks={"h100_f32": 66.9})
    assert out == {"x_gflops": 66900.0, "x_tflops_per_s": 66.9,
                   "x_mfu_pct_h100_f32": 100.0}


def test_mfu_fields_default_keys_are_the_h100_peaks():
    out = fl.mfu_fields("frl", 989.4e12 / 2, 1.0)
    assert sorted(out) == sorted(
        ["frl_gflops", "frl_tflops_per_s"]
        + [f"frl_mfu_pct_{k}" for k in ("h100_bf16_dense", "h100_tf32_dense",
                                        "h100_f32")])
    assert out["frl_mfu_pct_h100_bf16_dense"] == 50.0


@pytest.mark.parametrize("flops,seconds", [(float("nan"), 1.0),
                                           (float("inf"), 1.0),
                                           (0.0, 1.0), (1e9, 0.0)])
def test_mfu_fields_non_finite_guard(flops, seconds):
    assert fl.mfu_fields("x", flops, seconds) == {"x_gflops": -1.0}


def test_mfu_in_01_for_honest_inputs():
    assert 0.0 < fl.mfu(1e12, 1.0, fl.PEAK_TFLOPS["h100_f32"]) < 1.0


def test_peaks_are_the_h100s_and_the_reference_a40():
    assert fl.PEAK_TFLOPS == {"h100_bf16_dense": 989.4,
                              "h100_tf32_dense": 494.7, "h100_f32": 66.9,
                              "a40_bf16": 149.7}
    assert fl.H100_PEAKS == {k: v for k, v in fl.PEAK_TFLOPS.items()
                             if k != "a40_bf16"}
    assert fl.PEAK_BYTES_PER_S == 3.35e12
    # the bounds' rates: the same card's, rounded as the bounds always were
    assert fl.BOUND_PEAK_FLOPS == {"f32": 67e12, "bf16": 989e12}


@pytest.mark.parametrize("cost,peak,want", [
    (fl.KernelCost(10, 3350), 1e12, (1e-9, "bytes")),
    (fl.KernelCost(10 ** 6, 3350), 1e9, (1e-3, "operations"))])
def test_bound_s(cost, peak, want):
    got = fl.bound_s(cost, peak)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-12)


# ------------------------------------------ (b) the ops, on CPU tensors
def _bank(rng, b, h, w, c, nd, grad):
    x, a_w, b_w = (t(v) for v in bank_mix_inputs(rng, b, h, w, c, nd=nd))
    return [v.requires_grad_(grad) for v in (x, a_w, b_w)]


def _bank_fwd(rng):
    x, a_w, b_w = _bank(rng, 2, 9, 11, 5, 4, False)
    return (lambda: tsm.bank_mix(x, a_w, b_w),
            {"forest_tpu_torch.bank_mix_fwd":
             tsm.bank_mix_cost(x.shape, 4, 4).flops})


def _bank_fwd_bwd(rng):
    x, a_w, b_w = _bank(rng, 1, 8, 12, 6, 2, True)
    kw = dict(num_directions=2, coarse_dilation=2)
    return (lambda: tsm.bank_mix(x, a_w, b_w, **kw).square().sum().backward(),
            {"forest_tpu_torch.bank_mix_fwd":
             tsm.bank_mix_cost(x.shape, 4, 2).flops,
             "forest_tpu_torch.bank_mix_bwd":
             tsm.bank_mix_bwd_cost(x.shape, 4, 2).flops})


def _extract_rows_bwd(rng):
    grid = t(rng.normal(size=(2, 40, 6))).requires_grad_(True)
    idx = ti(rng.integers(0, 40, size=(2, 17)))
    return (lambda: tsc.extract_rows(grid, idx).sum().backward(),
            {"forest_tpu_torch.scatter_add_rows":
             tsc.scatter_add_rows_cost((2, 17, 6), 40).flops})


def _scatter(rng):
    dz = t(rng.normal(size=(3, 11, 5)))
    idx = ti(rng.integers(0, 7, size=(3, 11)))
    return (lambda: tsc.scatter_add_rows(dz, idx, 7),
            {"forest_tpu_torch.scatter_add_rows":
             tsc.scatter_add_rows_cost(dz.shape, 7).flops})


def _vq(rng, op, flag):
    x, c = t(rng.normal(size=(70, 12))), t(rng.normal(size=(9, 12)))
    if op == "vq_core":
        return (lambda: tvq.vq_core(x, c, with_qx=flag),
                {"forest_tpu_torch.vq_core":
                 tvq.vq_core_cost(70, 12, 9, flag).flops})
    return (lambda: tvq.vq_assign(x, c, mxu_bf16=flag),
            {"forest_tpu_torch.vq_assign":
             tvq.vq_assign_cost(70, 12, 9, flag).flops})


OP_CASES = {
    "bank_mix forward": _bank_fwd,
    "bank_mix forward and backward": _bank_fwd_bwd,
    "extract_rows backward": _extract_rows_bwd,
    "scatter_add_rows": _scatter,
    "vq_core": lambda rng: _vq(rng, "vq_core", False),
    "vq_core with sum(q x)": lambda rng: _vq(rng, "vq_core", True),
    "vq_assign float32": lambda rng: _vq(rng, "vq_assign", False),
    "vq_assign bf16 operands": lambda rng: _vq(rng, "vq_assign", True),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_op_counts_its_declared_flops_and_nothing_of_its_body(case):
    """The plain bodies run einsums, grouped convolutions and products,
    which FlopCounterMode would count: only the ops' declared FLOPs may
    appear."""
    run, want = OP_CASES[case](np.random.default_rng(0))
    assert fl.flops_by_op(run) == want
    assert all(v > 0 for v in want.values())


def test_plain_bodies_alone_would_count_otherwise():
    """The bank's plain forward outside the op: the counter sees its
    convolutions and einsum products, another number than the declared."""
    x, a_w, b_w = _bank(np.random.default_rng(0), 2, 9, 11, 5, 4, False)
    plain = fl.flops_by_op(lambda: tsm.bank_mix_reference(x, a_w, b_w))
    assert "forest_tpu_torch.bank_mix_fwd" not in plain
    assert sum(plain.values()) != tsm.bank_mix_cost(x.shape, 4).flops


def test_op_gradients_equal_the_plain_autograd():
    """bank_mix's registered gradient on the CPU (the gradient written out)
    against autograd through the plain forward."""
    rng = np.random.default_rng(3)
    x, a_w, b_w = _bank(rng, 2, 13, 21, 5, 4, True)
    g = t(rng.normal(size=x.shape))
    got = torch.autograd.grad(tsm.bank_mix(x, a_w, b_w), (x, a_w, b_w), g)
    want = torch.autograd.grad(tsm.bank_mix_reference(x, a_w, b_w),
                               (x, a_w, b_w), g)
    for u, v in zip(got, want):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------- (c) declared costs
@pytest.mark.parametrize("shape,r,nd,size", [
    ((12, 256, 256, 48), 4, 4, 2), ((2, 33, 37, 5), 3, 2, 4)])
def test_bank_mix_costs(shape, r, nd, size):
    b, h, w, c = shape
    k, pix = 2 * nd, b * h * w
    fwd = tsm.bank_mix_cost(shape, r, nd, size)
    assert fwd == (pix * c * (3 * k + 2 * k * r + 2 * r),
                   size * (pix * c + pix * k * r + pix * c * r + pix * c), 0)
    bwd = tsm.bank_mix_bwd_cost(shape, r, nd, size)
    per = ((2 * k + 1) * (2 * r + 1) + 2 * k * r + 3 * k
           + r * (2 * k + 1) + 2 * k * r)
    # x, g, dx; A, dA; B, dB
    assert bwd == (pix * c * per,
                   size * (3 * pix * c + 2 * pix * k * r + 2 * pix * c * r),
                   0)


@pytest.mark.parametrize("b,n,c,rows", [(12, 2012, 48, 65536),
                                       (3, 77, 5, 131)])
def test_scatter_cost(b, n, c, rows):
    # dz and the int32 indices in, the float32 rows out
    assert tsc.scatter_add_rows_cost((b, n, c), rows) == (
        b * n * c, 4 * b * n * c + 4 * b * n + 4 * b * rows * c, 0)


@pytest.mark.parametrize("n,d,k", [(131072, 128, 256), (333, 24, 17)])
def test_vq_costs(n, d, k):
    # x, codebook in; idx (int32), q, counts, sums out
    core = 4 * (n * d + k * d + n + n * d + k + k * d)
    assert tvq.vq_core_cost(n, d, k) == (2 * n * k * d, core, 0)
    assert tvq.vq_core_cost(n, d, k, True) == (
        2 * n * k * d + 2 * n * d, core + 4, 0)
    for bf16 in (False, True):
        assert tvq.vq_assign_cost(n, d, k, bf16) == (
            2 * n * k * d, 4 * (n * d + k * d + n), 0)
    assert tvv.assign_cost(n, d, k) == (2 * n * k * d,
                                        4 * (n * d + k * d + n), 0)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    return cs


# the rates chip_smoke.py's bounds read before the costs were declared
F32_PEAK, BF16_PEAK = 67e12, 989e12


def _formula_bound_ms(tensors, flops, peak):
    """chip_smoke.py's bound before the costs were declared: every tensor
    moved once against the FLOPs it wrote out."""
    nbytes = sum(v.numel() * v.element_size() for v in tensors)
    by_bytes = nbytes / 3.35e12 * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_chip_smoke_bounds_are_the_formulas_it_wrote_out(chip_smoke):
    cs = chip_smoke
    f32, bf16 = torch.float32, torch.bfloat16
    k, r = 2 * cs.NUM_DIRECTIONS, cs.RANK
    cases = []
    for shape, dt in ((cs.SERVE_SHAPE, f32), (cs.SERVE_SHAPE, bf16),
                      (cs.TRAIN_SHAPE, bf16)):
        b, h, w, c = shape
        x = _meta(*shape, dtype=dt)
        tensors = (x, _meta(b, h, w, k, r, dtype=dt),
                   _meta(b, h, w, c, r, dtype=dt), x)
        cases.append((cs.bound_ms(tsm.bank_mix_cost(
            shape, r, cs.NUM_DIRECTIONS, x.element_size())),
            _formula_bound_ms(tensors, x.numel() * (3 * k + 2 * k * r
                                                    + 2 * r),
                              F32_PEAK)))
    for dt in (f32, bf16):
        b, h, w, c = cs.TRAIN_SHAPE
        x = _meta(*cs.TRAIN_SHAPE, dtype=dt)
        a_w, b_w = _meta(b, h, w, k, r, dtype=dt), _meta(b, h, w, c, r,
                                                        dtype=dt)
        flops = x.numel() * ((2 * k + 1) * (2 * r + 1) + 2 * k * r + 3 * k
                             + r * (2 * k + 1) + 2 * k * r)
        cases.append((cs.bound_ms(tsm.bank_mix_bwd_cost(
            x.shape, r, cs.NUM_DIRECTIONS, x.element_size())),
            _formula_bound_ms((x, a_w, b_w, x, x, a_w, b_w), flops,
                              F32_PEAK)))
    b, n, rows, c = cs.SCATTER_SHAPE
    dz = _meta(b, n, c)
    cases.append((cs.bound_ms(tsc.scatter_add_rows_cost(dz.shape, rows)),
                  _formula_bound_ms((dz, _meta(b, n, dtype=torch.int32),
                                     _meta(b, rows, c)), float(dz.numel()),
                                    F32_PEAK)))
    n, d, kk = cs.VQ_SHAPE
    x, cb = _meta(n, d), _meta(kk, d)
    idx = _meta(n, dtype=torch.int32)
    cases.append((cs.bound_ms(tvq.vq_core_cost(n, d, kk)),
                  _formula_bound_ms((x, cb, idx, x, _meta(kk), cb),
                                    2.0 * n * kk * d, F32_PEAK)))
    for bf in (False, True):
        peak = BF16_PEAK if bf else F32_PEAK
        cases.append((cs.bound_ms(tvq.vq_assign_cost(n, d, kk, bf),
                                  "bf16" if bf else "f32"),
                      _formula_bound_ms((x, cb, idx), 2.0 * n * kk * d,
                                        peak)))
    cases.append((cs.bound_ms(tvv.assign_cost(n, d, kk)),
                  _formula_bound_ms((x, cb, idx), 2.0 * n * kk * d,
                                    F32_PEAK)))
    for got, want in cases:
        assert got == want


# ----------------------------------------------- (d) against the JAX count
def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _conv2d_pair():
    import jax.numpy as jnp

    from forest_tpu.models import conv2d_encoder as jenc
    x = _rand(0, 2, 16, 16, 4)
    jm = jenc.Conv2DEncoder(channels=(32, 8), num_groups=4)
    p = flax_params(jm.init, 1, jnp.asarray(x))
    tm = tenc.Conv2DEncoder(4, (32, 8), num_groups=4)
    return (jm, p, (jnp.asarray(x),), {}), (tm, (t(x),))


def _tcn_pair():
    import jax.numpy as jnp

    from forest_tpu.models import tcn as jtcn
    x = _rand(6, 6, 15, 3)
    jm = jtcn.TCNEncoder(channels=(8, 8), dilations=(1, 2), num_groups=4,
                         pooling="none")
    p = flax_params(jm.init, 8, jnp.asarray(x))
    tm = ttcn.TCNEncoder(3, (8, 8), dilations=(1, 2), num_groups=4,
                         pooling="none")
    return (jm, p, (jnp.asarray(x),), {}), (tm, (t(x),))


def _vqvae_pair():
    import test_torch_vqvae_model as vm
    batch = vm.make_batch(np.random.default_rng(0))
    jm, p, tm = vm.build_pair(batch)
    return ((jm, p, (vm.to_jax(batch),), {"use_pallas": False}),
            (tm, (vm.to_torch(batch),)))


# The port counts products and convolutions only; XLA's cost model also
# counts every elementwise operation (GroupNorm's moments and scaling, the
# activations, bias adds) and, for the VQ-VAE's XLA quantiser, the one-hot
# products the kernel replaces by gathers. The ratios measured here are
# 0.738 (Conv2DEncoder, two 1x1 convs of 32 and 8 channels, where the
# GroupNorms weigh most), 0.719 (TCNEncoder, 8 channels) and 0.976 (the
# VQ-VAE's linear layers dominate); the floors sit just below them.
JAX_PAIRS = {"Conv2DEncoder": (_conv2d_pair, 0.70),
             "TCNEncoder": (_tcn_pair, 0.70),
             "VQVAE": (_vqvae_pair, 0.95)}


@pytest.mark.parametrize("name", list(JAX_PAIRS))
def test_forward_count_against_the_jax_count(name):
    import jax

    from forest_tpu.utils.flops import compiled_flops
    make, floor = JAX_PAIRS[name]
    (jm, p, jargs, jkw), (tm, targs) = make()
    jax_flops = compiled_flops(
        jax.jit(lambda params, *a: jm.apply({"params": params}, *a, **jkw)),
        p, *jargs)
    tm.load_state_dict(params_from_flax(p), strict=True)
    tm.eval()
    with torch.no_grad():
        port = fl.step_flops(tm, *targs)
    assert np.isfinite(jax_flops)
    assert floor * jax_flops <= port <= jax_flops, (port, jax_flops)


# --------------------------------------------- (e) a small FRL train step
def _small_step(device, seed=0):
    """The port's FRL train step (every loss of DEFAULT_WEIGHTS) over the
    synthetic bindings, a narrow v1-shaped model, B 2 patches of 32²."""
    from forest_tpu_torch.data import (parse_bindings, synthetic_bindings,
                                       synthetic_feature_stats,
                                       synthetic_frl_batch)
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.models import representation as rep
    from forest_tpu_torch.training.representation import (
        config_builders as cb, step as step_mod, train_step as ts)
    bindings = parse_bindings(synthetic_bindings("unused.zarr",
                                                 "unused.json"))
    fb = FeatureBuilder(bindings, synthetic_feature_stats(bindings))
    model = rep.RepresentationModel(
        len(bindings.get_feature("type_encoder_input").channels),
        len(bindings.get_feature("phase_ccdc").channels), z_type_dim=8,
        type_encoder_channels=(16, 8), z_phase_dim=3,
        spatial_conv_gate_hidden=8, phase_tcn_channels=(12, 12),
        phase_tcn_dilations=(1, 2))
    rep.init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device)
    step_cfg = cb.build_step_config(bindings, {})
    process = step_mod.make_process_batch(
        model, fb, cb.build_sampler(bindings, {}), step_cfg, 32,
        device=device)
    optimizer = ts.make_optimizer(1e-4)
    state = ts.init_train_state(model, optimizer)
    batch = {k: torch.as_tensor(v).to(device) for k, v in
             synthetic_frl_batch(np.random.default_rng(seed), 2, 32,
                                 15).items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    train_step = ts.make_train_step(process, optimizer)
    return lambda: train_step(state, batch, gen,
                              dict(step_mod.DEFAULT_WEIGHTS),
                              {"input_dropout_rate": 0.05,
                               "min_gate": 0.0})


def test_small_frl_step_counts_the_same_integer_twice():
    step = _small_step("cpu")
    first = fl.flops_by_op(step)
    second = fl.flops_by_op(step)       # the next step: other draws
    assert first == second
    for op in ("bank_mix_fwd", "bank_mix_bwd", "scatter_add_rows"):
        assert first[f"forest_tpu_torch.{op}"] > 0, op
    assert fl.step_flops(_small_step("cpu", seed=1)) == sum(first.values())


@pytest.mark.cuda
def test_small_frl_step_counts_the_same_on_the_card(cuda_device):
    card = fl.flops_by_op(_small_step(str(cuda_device)))
    assert card == fl.flops_by_op(_small_step("cpu"))
