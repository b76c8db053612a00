"""forest_tpu_torch.ops.smoothing against forest_tpu.ops.smoothing.

The plain PyTorch version of the fused bank + rank-R mixing
(``bank_mix_reference``) and the Sobel / directional-bank grouped convs are
held to the JAX package on the same seeded inputs: to ``bank_mix_xla`` and
to the Pallas kernel in interpret mode (as tests/test_smoothing_kernel.py
runs it). The CUDA kernel behind ``bank_mix`` is held to the plain version
on a card (``cuda`` marker).

Tolerances, float32: rtol 1e-6 with atol 1e-6 on O(1) values -- the same
sums taken in another order (grouped conv vs XLA conv, einsum order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.ops import smoothing as jsm
from forest_tpu_torch.ops import smoothing as tsm
from torch_parity import bank_mix_inputs, cuda_device, t  # noqa: F401

F32 = dict(rtol=1e-6, atol=1e-6)

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
