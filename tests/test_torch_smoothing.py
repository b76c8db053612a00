"""forest_tpu_torch.ops.smoothing against forest_tpu.ops.smoothing.

The plain PyTorch version of the fused bank + rank-R mixing
(``bank_mix_reference``) and the Sobel / directional-bank grouped convs are
held to the JAX package on the same seeded inputs: to ``bank_mix_xla`` and
to the Pallas kernel in interpret mode (as tests/test_smoothing_kernel.py
runs it). The plain version of the backward (``bank_mix_bwd``: autograd
through ``bank_mix_reference``) is held to ``jax.grad`` of ``bank_mix_xla``
and to the Pallas backward kernel in interpret mode. The CUDA kernels behind
``bank_mix`` and ``bank_mix_bwd`` are held to the plain versions on a card
(``cuda`` marker).

Tolerances, float32: rtol 1e-6 with atol 1e-6 on O(1) values -- the same
sums taken in another order (grouped conv vs XLA conv, einsum order); the
gradients, which sum up to 48 channels or 17 taps more, rtol 1e-5 / atol
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.ops import smoothing as jsm
from forest_tpu_torch.ops import smoothing as tsm
from torch_parity import bank_mix_inputs, cuda_device, t  # noqa: F401

F32 = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)

# (B, H, W, C, num_directions, coarse_dilation): H and W not multiples of
# 16, C = 5 and 48, nd in {2, 4}, dc in {2, 3}.
CASES = [
    (2, 13, 21, 5, 4, 3),
    (1, 17, 19, 48, 4, 3),
    (1, 9, 23, 5, 2, 2),
    (1, 11, 10, 48, 2, 3),
    (1, 18, 7, 5, 4, 2),
]


@pytest.mark.parametrize("b,h,w,c,nd,dc", CASES)
def test_bank_mix_reference_matches_xla(b, h, w, c, nd, dc):
    rng = np.random.default_rng(b * 1000 + h * 10 + c)
    x, a_w, b_w = bank_mix_inputs(rng, b, h, w, c, nd=nd)
    ref = jsm.bank_mix_xla(jnp.asarray(x), jnp.asarray(a_w),
                           jnp.asarray(b_w), num_directions=nd,
                           coarse_dilation=dc)
    out = tsm.bank_mix_reference(t(x), t(a_w), t(b_w), num_directions=nd,
                                 coarse_dilation=dc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("b,h,w,c,nd,dc", CASES[:3])
def test_bank_mix_reference_matches_pallas_interpret(b, h, w, c, nd, dc):
    rng = np.random.default_rng(7 + h)
    x, a_w, b_w = bank_mix_inputs(rng, b, h, w, c, nd=nd)
    ref = jsm.bank_mix(jnp.asarray(x), jnp.asarray(a_w), jnp.asarray(b_w),
                       num_directions=nd, coarse_dilation=dc,
                       interpret=True)
    out = tsm.bank_mix_reference(t(x), t(a_w), t(b_w), num_directions=nd,
                                 coarse_dilation=dc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_border_one_hot():
    """A one-hot at each corner reaches every zero-padding edge of both
    dilations."""
    rng = np.random.default_rng(3)
    _, a_w, b_w = bank_mix_inputs(rng, 1, 12, 14, 5)
    x = np.zeros((1, 12, 14, 5), np.float32)
    for i, j in ((0, 0), (0, 13), (11, 0), (11, 13)):
        x[0, i, j, (i + j) % 5] = 1.0
    ref = jsm.bank_mix_xla(jnp.asarray(x), jnp.asarray(a_w),
                           jnp.asarray(b_w))
    out = tsm.bank_mix_reference(t(x), t(a_w), t(b_w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    assert np.count_nonzero(out.numpy()) == np.count_nonzero(np.asarray(ref))


# (B, H, W, C, num_directions, coarse_dilation, R): the forward kernel's
# edges -- it walks strips of 32 columns in segments of 32 rows -- with a
# ragged last strip and segment on each of its three paths (C = 48 compiled
# in, another even C, an odd C), H below 2 dc + 1, W below dc, dc = 1, and
# R = 1, 3, 6 and nd = 3 (the scalar path)
FWD_EDGE_CASES = [
    (1, 70, 37, 48, 4, 3, 4),
    (1, 40, 70, 8, 4, 3, 4),
    (2, 40, 37, 5, 4, 3, 4),
    (1, 5, 9, 5, 4, 3, 4),
    (2, 9, 2, 6, 4, 3, 4),
    (1, 33, 11, 6, 4, 1, 4),
    (1, 9, 11, 5, 4, 3, 1),
    (1, 9, 11, 48, 4, 3, 3),
    (1, 9, 33, 6, 3, 2, 6),
]


@pytest.mark.parametrize("b,h,w,c,nd,dc,r", FWD_EDGE_CASES)
def test_bank_mix_reference_edge_shapes_match_xla(b, h, w, c, nd, dc, r):
    rng = np.random.default_rng(60 + h + w + r)
    x, a_w, b_w = bank_mix_inputs(rng, b, h, w, c, nd=nd, r=r)
    ref = jsm.bank_mix_xla(jnp.asarray(x), jnp.asarray(a_w),
                           jnp.asarray(b_w), num_directions=nd,
                           coarse_dilation=dc)
    out = tsm.bank_mix(t(x), t(a_w), t(b_w), num_directions=nd,
                       coarse_dilation=dc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("c,dc,dtype,main,expect", [
    (48, 3, torch.float32, True, 8 * 7 * 48 * 4),     # 48 = 16 mod 32 words
    (48, 3, torch.bfloat16, True, 8 * 7 * 48 * 2),    # 24 = 8 mod 16 words
    (48, 3, torch.float32, False, 8 * 7 * 56 * 4),    # 56 = 8 mod 16
    (8, 3, torch.float32, True, 8 * 7 * 16 * 4),
    (8, 3, torch.bfloat16, True, 8 * 7 * 16 * 2),
    (5, 1, torch.float32, True, 4 * 3 * 8 * 4),      # odd C: scalar path
    (48, 17, torch.float32, True, 36 * 35 * 48 * 4),  # the first refused dc
])
def test_fwd_shared_memory_of_one_column(c, dc, dtype, main, expect):
    got = tsm.fwd_min_shared_bytes(c, dc, dtype, main_path=main)
    assert got == expect
    assert (got <= 232448) == (dc < 17)


def test_bank_mix_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(4)
    x, a_w, b_w = (t(v) for v in bank_mix_inputs(rng, 1, 9, 11, 5))
    before = tsm.bank_mix.launches
    out = tsm.bank_mix(x, a_w, b_w)
    assert torch.equal(out, tsm.bank_mix_reference(x, a_w, b_w))
    assert tsm.bank_mix.launches == before


def test_bank_mix_bf16_returns_bf16():
    rng = np.random.default_rng(5)
    x, a_w, b_w = (t(v).bfloat16() for v in bank_mix_inputs(rng, 1, 8, 9, 5))
    out = tsm.bank_mix(x, a_w, b_w)
    assert out.dtype == torch.bfloat16
    ref = tsm.bank_mix_reference(x.float(), a_w.float(), b_w.float())
    # one bf16 rounding of the float32 result: half an ulp, 2^-9 relative
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=2 ** -8, atol=1e-6)


def test_bank_mix_refuses_devices_without_a_kernel():
    x, a_w, b_w = (torch.empty(s, device="meta")
                   for s in ((1, 4, 4, 2), (1, 4, 4, 8, 4), (1, 4, 4, 2, 4)))
    with pytest.raises(ValueError, match="no kernel"):
        tsm.bank_mix(x, a_w, b_w)


@pytest.mark.parametrize("c", [5, 48])
def test_sobel_grads_matches_jax(c):
    x = np.random.default_rng(c).normal(size=(2, 11, 13, c)).astype(
        np.float32)
    ref = jsm.sobel_grads(jnp.asarray(x))
    np.testing.assert_allclose(tsm.sobel_grads(t(x)).numpy(),
                               np.asarray(ref), **F32)


@pytest.mark.parametrize("dilation", [1, 3])
def test_depthwise_bank_conv_matches_jax(dilation):
    x = np.random.default_rng(9).normal(size=(1, 10, 12, 5)).astype(
        np.float32)
    bank = jsm._direction_bank()
    ref = jsm.depthwise_bank_conv(jnp.asarray(x), bank, dilation=dilation)
    out = tsm.depthwise_bank_conv(t(x), bank, dilation=dilation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


# -------------------------------------------------------------- backward
# two shapes, one with odd H, W and C; the second also nd 2 / dc 2
BWD_CASES = [(2, 13, 21, 5, 4, 3), (1, 16, 24, 8, 4, 3), (1, 9, 23, 5, 2, 2)]


# (B, H, W, C, num_directions, coarse_dilation, R): what the one-pass kernel
# has to get right at its edges -- H below 2 dc + 1, W below dc, dc = 1
# (the +-1 and +-dc rows coincide), R = 1, 3 and 6 (its scalar path, and
# more ranks than one pass of four), C = 5, and a shape that crosses a
# 32-column strip and a 64-row segment with a ragged last strip; the last
# has an even C that is not the 48 the kernel has a compiled-in path for
BWD_EDGE_CASES = [
    (1, 5, 9, 5, 4, 3, 4),
    (2, 9, 2, 5, 4, 3, 4),
    (1, 3, 2, 8, 4, 3, 4),
    (1, 9, 11, 5, 4, 1, 4),
    (1, 9, 11, 5, 4, 3, 1),
    (1, 9, 11, 5, 4, 3, 3),
    (1, 9, 11, 6, 3, 2, 6),
    (1, 70, 37, 5, 4, 3, 4),
    (1, 70, 40, 8, 4, 3, 4),
]


def _bwd_inputs(rng, b, h, w, c, nd, r=4):
    x, a_w, b_w = bank_mix_inputs(rng, b, h, w, c, nd=nd, r=r)
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, a_w, b_w, g


def _jax_grads(fn, x, a_w, b_w, g):
    return jax.grad(lambda *args: jnp.sum(fn(*args) * jnp.asarray(g)),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(a_w),
                                       jnp.asarray(b_w))


@pytest.mark.parametrize("b,h,w,c,nd,dc", BWD_CASES)
def test_bank_mix_bwd_matches_jax_grad_of_xla(b, h, w, c, nd, dc):
    x, a_w, b_w, g = _bwd_inputs(np.random.default_rng(20 + h), b, h, w, c,
                                 nd)
    ref = _jax_grads(lambda *a: jsm.bank_mix_xla(
        *a, num_directions=nd, coarse_dilation=dc), x, a_w, b_w, g)
    before = tsm.bank_mix_bwd.launches
    out = tsm.bank_mix_bwd(t(x), t(a_w), t(b_w), t(g), num_directions=nd,
                           coarse_dilation=dc)
    assert tsm.bank_mix_bwd.launches == before      # CPU: the plain version
    for got, want, name in zip(out, ref, ("dx", "dA", "dB")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("b,h,w,c,nd,dc", BWD_CASES[:2])
def test_bank_mix_bwd_matches_pallas_interpret(b, h, w, c, nd, dc):
    x, a_w, b_w, g = _bwd_inputs(np.random.default_rng(30 + h), b, h, w, c,
                                 nd)
    ref = _jax_grads(lambda *a: jsm.bank_mix(
        *a, num_directions=nd, coarse_dilation=dc, interpret=True),
        x, a_w, b_w, g)
    out = tsm.bank_mix_bwd(t(x), t(a_w), t(b_w), t(g), num_directions=nd,
                           coarse_dilation=dc)
    for got, want, name in zip(out, ref, ("dx", "dA", "dB")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("b,h,w,c,nd,dc,r", BWD_EDGE_CASES)
def test_bank_mix_bwd_edge_shapes_match_jax_grad_of_xla(b, h, w, c, nd, dc,
                                                        r):
    x, a_w, b_w, g = _bwd_inputs(np.random.default_rng(40 + h + r), b, h, w,
                                 c, nd, r)
    ref = _jax_grads(lambda *a: jsm.bank_mix_xla(
        *a, num_directions=nd, coarse_dilation=dc), x, a_w, b_w, g)
    out = tsm.bank_mix_bwd(t(x), t(a_w), t(b_w), t(g), num_directions=nd,
                           coarse_dilation=dc)
    for got, want, name in zip(out, ref, ("dx", "dA", "dB")):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("b,h,w,c,nd,dc,r", BWD_EDGE_CASES[:6])
def test_bank_mix_bwd_edge_shapes_match_pallas_interpret(b, h, w, c, nd, dc,
                                                         r):
    x, a_w, b_w, g = _bwd_inputs(np.random.default_rng(50 + h + r), b, h, w,
                                 c, nd, r)
    ref = _jax_grads(lambda *a: jsm.bank_mix(
        *a, num_directions=nd, coarse_dilation=dc, interpret=True),
        x, a_w, b_w, g)
    out = tsm.bank_mix_bwd(t(x), t(a_w), t(b_w), t(g), num_directions=nd,
                           coarse_dilation=dc)
    for got, want, name in zip(out, ref, ("dx", "dA", "dB")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD,
                                   err_msg=name)


def test_bank_mix_is_differentiable_on_cpu():
    """autograd through ``bank_mix`` equals ``bank_mix_bwd``; a bf16 block
    hands float32 gradients back to float32 leaves."""
    x, a_w, b_w, g = (t(v) for v in _bwd_inputs(np.random.default_rng(6),
                                                1, 9, 11, 5, 4))
    leaves = [v.clone().requires_grad_(True) for v in (x, a_w, b_w)]
    tsm.bank_mix(*leaves).backward(g)
    for leaf, want in zip(leaves, tsm.bank_mix_bwd(x, a_w, b_w, g)):
        np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(), **F32)
    leaves = [v.clone().requires_grad_(True) for v in (x, a_w, b_w)]
    out = tsm.bank_mix(*(v.bfloat16() for v in leaves))
    assert out.dtype == torch.bfloat16
    out.backward(g.bfloat16())
    assert all(v.grad.dtype == torch.float32 for v in leaves)
    # bf16 inputs and one bf16 rounding of each gradient: 2^-7 relative
    for leaf, want in zip(leaves, tsm.bank_mix_bwd(x, a_w, b_w, g)):
        np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(),
                                   rtol=2 ** -6, atol=2 ** -6)


# ---------------------------------------------------------------- on a card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,nd,dc", CASES)
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, b, h, w,
                                              c, nd, dc):
    rng = np.random.default_rng(11)
    x, a_w, b_w = (t(v).to(cuda_device, dtype)
                   for v in bank_mix_inputs(rng, b, h, w, c, nd=nd))
    before = tsm.bank_mix.launches
    out = tsm.bank_mix(x, a_w, b_w, num_directions=nd, coarse_dilation=dc)
    torch.cuda.synchronize()
    assert tsm.bank_mix.launches == before + 1
    ref = tsm.bank_mix_reference(x, a_w, b_w, num_directions=nd,
                                 coarse_dilation=dc)
    # f32: reordered f32 sums; bf16: both round one f32 result, so at most
    # one bf16 ulp (2^-7 relative) apart where the sums straddle a rounding
    tol = F32 if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,nd,dc,r", FWD_EDGE_CASES)
def test_kernel_edge_shapes_on_card(cuda_device, dtype, b, h, w, c, nd, dc,
                                    r):
    rng = np.random.default_rng(14)
    x, a_w, b_w = (t(v).to(cuda_device, dtype)
                   for v in bank_mix_inputs(rng, b, h, w, c, nd=nd, r=r))
    kw = dict(num_directions=nd, coarse_dilation=dc)
    before = tsm.bank_mix.launches
    out = tsm.bank_mix(x, a_w, b_w, **kw)
    again = tsm.bank_mix(x, a_w, b_w, **kw)
    torch.cuda.synchronize()
    assert tsm.bank_mix.launches == before + 2
    assert torch.equal(out, again)          # no atomics: the same bits
    ref = tsm.bank_mix_reference(x, a_w, b_w, **kw).float()
    # f32: reordered f32 sums; bf16: one bf16 ulp of the largest magnitude
    bound = 1e-5 if dtype == torch.float32 else \
        2 ** -7 * max(1.0, ref.abs().max().item())
    assert (out.float() - ref).abs().max().item() <= bound


@pytest.mark.cuda
def test_kernel_refuses_what_does_not_fit_a_block_on_card(cuda_device):
    x = torch.zeros(1, 4, 4, 48, device=cuda_device)
    a_w = torch.zeros(1, 4, 4, 8, 4, device=cuda_device)
    b_w = torch.zeros(1, 4, 4, 48, 4, device=cuda_device)
    tsm.bank_mix(x, a_w, b_w, coarse_dilation=16)
    with pytest.raises(RuntimeError, match="one pixel column"):
        tsm.bank_mix(x, a_w, b_w, coarse_dilation=17)


@pytest.mark.cuda
def test_kernel_refuses_bad_input_on_card(cuda_device):
    x = torch.zeros(1, 4, 4, 2, device=cuda_device)
    a_w = torch.zeros(1, 4, 4, 8, 4, device=cuda_device)
    b_w = torch.zeros(1, 4, 4, 2, 4, device=cuda_device)
    with pytest.raises(TypeError):
        tsm.bank_mix(x.double(), a_w.double(), b_w.double())
    with pytest.raises(ValueError, match="contiguous"):
        tsm.bank_mix(x, a_w.transpose(3, 4).contiguous().transpose(3, 4),
                     b_w)
    with pytest.raises(ValueError, match="shapes"):
        tsm.bank_mix(x, a_w[..., :6, :].contiguous(), b_w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,nd,dc", BWD_CASES + [(2, 33, 37, 5, 4, 3)])
def test_bwd_kernel_matches_plain_version_on_card(cuda_device, dtype, b, h,
                                                  w, c, nd, dc):
    x, a_w, b_w, g = (t(v).to(cuda_device, dtype) for v in _bwd_inputs(
        np.random.default_rng(12), b, h, w, c, nd))
    kw = dict(num_directions=nd, coarse_dilation=dc)
    fwd, bwd = tsm.bank_mix.launches, tsm.bank_mix_bwd.launches
    leaves = [v.clone().requires_grad_(True) for v in (x, a_w, b_w)]
    tsm.bank_mix(*leaves, **kw).backward(g)
    torch.cuda.synchronize()
    assert tsm.bank_mix.launches == fwd + 1
    assert tsm.bank_mix_bwd.launches == bwd + 1
    ref = tsm.bank_mix_bwd_reference(x, a_w, b_w, g, **kw)
    # f32: reordered f32 sums; bf16: one bf16 ulp of the largest magnitude
    for leaf, want in zip(leaves, ref):
        want = want.float()
        bound = 1e-5 if dtype == torch.float32 else \
            2 ** -7 * max(1.0, want.abs().max().item())
        assert (leaf.grad.float() - want).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,nd,dc,r",
                         BWD_EDGE_CASES + [(1, 130, 70, 48, 4, 3, 4)])
def test_bwd_kernel_edge_shapes_on_card(cuda_device, dtype, b, h, w, c, nd,
                                        dc, r):
    x, a_w, b_w, g = (t(v).to(cuda_device, dtype) for v in _bwd_inputs(
        np.random.default_rng(13), b, h, w, c, nd, r))
    kw = dict(num_directions=nd, coarse_dilation=dc)
    before = tsm.bank_mix_bwd.launches
    got = tsm.bank_mix_bwd(x, a_w, b_w, g, **kw)
    again = tsm.bank_mix_bwd(x, a_w, b_w, g, **kw)
    torch.cuda.synchronize()
    assert tsm.bank_mix_bwd.launches == before + 2
    ref = tsm.bank_mix_bwd_reference(x, a_w, b_w, g, **kw)
    # f32: reordered f32 sums; bf16: one bf16 ulp of the largest magnitude
    for u, v, want in zip(got, again, ref):
        assert torch.equal(u, v)            # no atomics: the same bits
        want = want.float()
        bound = 1e-5 if dtype == torch.float32 else \
            2 ** -7 * max(1.0, want.abs().max().item())
        assert (u.float() - want).abs().max().item() <= bound


@pytest.mark.cuda
def test_bwd_kernel_refuses_what_does_not_fit_a_block_on_card(cuda_device):
    x = torch.zeros(1, 4, 4, 2, device=cuda_device)
    a_w = torch.zeros(1, 4, 4, 8, 4, device=cuda_device)
    b_w = torch.zeros(1, 4, 4, 2, 4, device=cuda_device)
    with pytest.raises(RuntimeError, match="coarse_dilation <= 19"):
        tsm.bank_mix_bwd(x, a_w, b_w, x, coarse_dilation=20)


@pytest.mark.cuda
def test_bwd_kernel_refuses_bad_cotangent_on_card(cuda_device):
    x = torch.zeros(1, 4, 4, 2, device=cuda_device)
    a_w = torch.zeros(1, 4, 4, 8, 4, device=cuda_device)
    b_w = torch.zeros(1, 4, 4, 2, 4, device=cuda_device)
    with pytest.raises(ValueError, match="bank_mix_bwd"):
        tsm.bank_mix_bwd(x, a_w, b_w, torch.zeros(1, 4, 4, 3,
                                                  device=cuda_device))
