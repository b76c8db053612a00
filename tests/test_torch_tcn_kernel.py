"""The TCN block kernels (K9: ``ops.tcn_block``, ``csrc/tcn_block.cu``) and
their dispatch in ``RepresentationModel``.

On the CPU (every test not marked ``cuda``): the calls that must take the
composed modules (the CPU, autograd on, dropout, another dtype) do, and
count as such in ``tcn_block.calls``, and every shape goes to the op on a
card; the op refuses a block no kernel takes; the op's plain version,
reached through ``TCNEncoder.run_kernel``, equals the modules bit for bit
on every width, dilation, length and layout the card's cases run, the head
and FiLM included; the op's fake gives its shapes and strides; its
declared FLOPs equal a hand count and what ``FlopCounterMode`` counts for
the modules it replaces; the FRL train step's count is unchanged.

On a card (``cuda``): the tiled kernel against the composed modules on the
same card, TF32 off, at both input widths (13, projected, and 64),
dilations 1, 2 and 4, T 1, 2, 5 and 15, on contiguous, strided and [B, T,
H, W, C] inputs; the general kernel at the widths, groups, kernel sizes,
dilations and lengths the tiled one lacks (the eval fixtures' model among
them); the head and FiLM on both; the embedding cell's full batch [8, 15,
256, 256, 13] through ``forward_phase``, three launches and no composed
block; a block no kernel takes raising on the card instead of running the
modules; and a TF32 variant of the op (its operands rounded to TF32, as a
tensor core's TF32 product rounds them) outside the tolerance.

The tolerance, on the gap's root mean square over the composed output's and
on its largest element over the composed output's largest magnitude: each
output is a 3 C_in-term conv and a 64-term gate product summed in another
order than cuDNN's, through GroupNorm's 1 / std; float32's unit roundoff
(6e-8) over ~256 terms gives ~1e-6, and the kernel reads 2.2e-7 rms, 8e-7
max on the card's cases (4.1e-7, 7.5e-7 on the cell's batch). RMS_TOL 4e-6
and MAX_TOL 1e-5 hold those with 10x room; TF32 operands (unit roundoff
4.9e-4) read 5.8e-4 rms on the cell's batch, 145x over RMS_TOL.
"""
import math
import sys
from pathlib import Path

import pytest
import torch

from forest_tpu_torch.models import representation as rep
from forest_tpu_torch.models.conditioning import FiLMLayer
from forest_tpu_torch.models.tcn import GatedResidualBlock, TCNEncoder
from forest_tpu_torch.ops import tcn_block as tb
from forest_tpu_torch.utils import flops as fl
from torch_parity import cuda_device  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RMS_TOL, MAX_TOL = 4e-6, 1e-5
WIDTHS, DILATIONS, STEPS = (13, 64), (1, 2, 4), (1, 2, 5, 15)
LAYOUTS = ("contiguous", "strided", "spatial")
# utils.flops.flops_by_op of test_torch_flops._small_step("cpu") before the
# kernel: the training step runs its TCN with autograd on, composed
SMALL_STEP_FLOPS = 49744088
CELL = (8, 15, 256, 256, 13)
# the FRL train step at B 12, 256^2, GFLOP, as utils.flops.step_flops has
# counted it since its kernels stated their costs
FRL_STEP_GFLOP = 653.32
# blocks the tiled kernel lacks, which the general kernel runs: (C_in,
# C_out, groups, kernel size, dilation, T); the eval fixtures' two blocks
# first (tests/torch_parity.EVAL_CFG)
OTHER_BLOCKS = ((3, 12, 4, 3, 1, 15), (12, 12, 4, 3, 2, 15),
                (64, 64, 8, 3, 2, 20), (13, 64, 8, 3, 3, 15),
                (32, 32, 8, 5, 1, 7), (40, 64, 8, 3, 1, 15),
                (12, 12, 4, 3, 8, 5))
# whole TCNs with a head that the tiled kernel lacks: (C_in, widths,
# dilations, groups, head, T)
OTHER_TCNS = {"eval_fixture": (3, (12, 12), (1, 2), 4, 3, 15),
              "head_9": (13, (64, 64, 64), (1, 2, 4), 8, 9, 15),
              "steps_20": (13, (64, 64, 64), (1, 2, 4), 8, 8, 20)}


@pytest.fixture(scope="module")
def no_tf32():
    """TF32 off on the card for the composed side, restored after this
    module's tests."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _draw(module, seed):
    """Every parameter of ``module`` drawn: weights N(0, 1/fan_in), biases
    N(0, 0.3^2), GroupNorm scales 1 + N(0, 0.3^2)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            p.copy_(r * p[0].numel() ** -0.5 if p.dim() > 1
                    else 1.0 + 0.3 * r if name.endswith("norm.weight")
                    else 0.3 * r)
    return module


def _block(cin, d, device="cpu", seed=0, width=64, groups=8, k=3):
    """A block with every parameter drawn (:func:`_draw`)."""
    return _draw(GatedResidualBlock(cin, width, k, d, groups),
                 seed).to(device).eval()


def _other_tcn(case, device="cpu"):
    """-> (TCN, head, FiLM, T) of an OTHER_TCNS case, every parameter
    drawn."""
    cin, widths, dils, groups, z, t = OTHER_TCNS[case]
    enc = _draw(TCNEncoder(cin, widths, dilations=dils, num_groups=groups),
                7)
    head, film = _film(z, width=widths[-1])
    return enc.to(device).eval(), head.to(device), film.to(device), t


def _input(cin, t, layout, device="cpu", seed=1):
    """-> (x in ``layout``, the same series as [N, T, C])."""
    g = torch.Generator().manual_seed(seed)
    if layout == "spatial":
        x = torch.randn(2, t, 9, 7, cin, generator=g).to(device)
        return x, x.permute(0, 2, 3, 1, 4).reshape(-1, t, cin)
    if layout == "strided":
        big = torch.randn(t, 133, cin + 3, generator=g).to(device)
        x = big[:, :, 1:cin + 1].transpose(0, 1)
        return x, x
    x = torch.randn(133, t, cin, generator=g).to(device)
    return x, x


def _as_series(y):
    """[B, T, H, W, C] -> [N, T, C]; [N, T, C] as it is."""
    if y.dim() == 5:
        return y.permute(0, 2, 3, 1, 4).reshape(-1, y.shape[1], y.shape[-1])
    return y


def _film(z_dim=8, cond=48, device="cpu", seed=2, width=64):
    g = torch.Generator().manual_seed(seed)
    head = torch.nn.Linear(width, z_dim)
    film = FiLMLayer(cond, z_dim)
    with torch.no_grad():
        for p in list(head.parameters()) + list(film.parameters()):
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return head.to(device), film.to(device)


def _encoder(cin=13, device="cpu", seed=0):
    enc = TCNEncoder(cin, (64, 64, 64), dilations=(1, 2, 4))
    for i, d in enumerate((1, 2, 4)):
        src = _block(cin if i == 0 else 64, d, seed=seed + i)
        getattr(enc, f"block_{i}").load_state_dict(src.state_dict())
    return enc.to(device).eval()


def _composed_phase(enc, head, film, x, zt):
    """The dense phase pathway in modules: permute, the blocks, the head,
    FiLM, and back to [B, T, H, W, Z]."""
    b, t, h, w, c = x.shape
    y = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c).transpose(1, 2)
    for i in range(enc.n_blocks):
        y = getattr(enc, f"block_{i}")(y)
    gamma, beta = film(zt.reshape(b * h * w, -1))
    z = FiLMLayer.modulate(head(y.transpose(1, 2)), gamma[:, None, :],
                           beta[:, None, :])
    return z.reshape(b, h, w, t, -1).permute(0, 3, 1, 2, 4)


def _gaps(got, want):
    d = (got.double() - want.double())
    return (float(d.norm() / want.double().norm()),
            float(d.abs().max() / want.double().abs().max()))


def _fake_cuda(*shape, dtype=torch.float32):
    """A CUDA tensor without a card: shape, dtype and device alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return torch.empty(shape, dtype=dtype, device="cuda")


# ------------------------------------------------------------ dispatch, CPU
def test_cpu_calls_take_the_composed_path_and_count_as_such():
    enc = _encoder()
    x, _ = _input(13, 15, "spatial")
    before = dict(tb.tcn_block.calls)
    launches = tb.tcn_block.launches
    with torch.no_grad():
        enc(x)
        enc(x[:, :, 0, 0, :])
    enc(x)                                        # autograd on
    assert tb.tcn_block.calls == dict(before,
                                      composed=before["composed"] + 9)
    assert tb.tcn_block.launches == launches


def test_the_models_phase_paths_on_the_cpu_are_composed():
    model = rep.RepresentationModel(34, 13).eval()
    x, _ = _input(13, 15, "spatial")
    zt = torch.randn(2, 9, 7, 48)
    before = dict(tb.tcn_block.calls)
    with torch.inference_mode():
        model.forward_phase(x, zt)
        model.forward_phase_at_locations(x[:, :, 0, 0, :], zt[:, 0, 0, :])
    assert tb.tcn_block.calls == dict(before,
                                      composed=before["composed"] + 6)


@pytest.mark.parametrize("case", [
    "inference", "grad", "dropout_training", "dropout_deterministic",
    "cpu", "bfloat16", "steps_16", "steps_0", "dilation_3", "width_32",
    "projected_32", "head_9", "kernel_5", "groups_4"])
def test_the_kernel_takes_what_it_can_and_nothing_else(case):
    cin, chans, dils, k, groups, head, rate = 13, 64, (1, 2, 4), 3, 8, 8, 0.0
    t, dtype, det = 15, torch.float32, True
    if case == "dropout_training":
        rate, det = 0.1, False
    elif case == "dropout_deterministic":
        rate = 0.1
    elif case == "steps_16":
        t = 16
    elif case == "steps_0":
        t = 0
    elif case == "dilation_3":
        dils = (1, 3, 4)
    elif case == "width_32":
        chans = 32
    elif case == "projected_32":
        cin = 32
    elif case == "head_9":
        head = 9
    elif case == "kernel_5":
        k = 5
    elif case == "groups_4":
        groups = 4
    elif case == "bfloat16":
        dtype = torch.bfloat16
    enc = TCNEncoder(cin, (chans,) * 3, kernel_size=k, dilations=dils,
                     num_groups=groups, dropout_rate=rate)
    x = (torch.empty(4, t, cin) if case == "cpu"
         else _fake_cuda(4, t, cin, dtype=dtype))
    with torch.set_grad_enabled(case == "grad"):
        takes = enc.takes_kernel(x, det)
    # the shapes do not matter: on a card the op launches or raises
    assert takes == (case not in ("grad", "dropout_training", "cpu",
                                  "bfloat16")), (case, head)


# ------------------------------------------- the op's plain version, CPU
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("t", STEPS)
@pytest.mark.parametrize("d", DILATIONS)
@pytest.mark.parametrize("cin", WIDTHS)
def test_the_ops_plain_version_is_the_block(cin, d, t, layout):
    blk = _block(cin, d)
    x, series = _input(cin, t, layout)
    with torch.no_grad():
        got = blk.run_kernel(x)
        want = blk(series.transpose(1, 2)).transpose(1, 2)
    assert got.shape == x.shape[:-1] + (64,)
    assert torch.equal(_as_series(got), want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", OTHER_BLOCKS)
def test_the_ops_plain_version_is_the_block_at_other_widths(shape, layout):
    cin, width, groups, k, d, t = shape
    blk = _block(cin, d, width=width, groups=groups, k=k)
    x, series = _input(cin, t, layout)
    with torch.no_grad():
        got = blk.run_kernel(x)
        want = blk(series.transpose(1, 2)).transpose(1, 2)
    assert got.shape == x.shape[:-1] + (width,)
    assert torch.equal(_as_series(got), want)


@pytest.mark.parametrize("case", sorted(OTHER_TCNS))
def test_the_ops_plain_head_and_film_at_other_widths(case):
    enc, head, film, t = _other_tcn(case)
    x, series = _input(enc.in_widths[0], t, "spatial")
    zt = torch.randn(series.shape[0], 48)
    with torch.no_grad():
        gamma, beta = film(zt)
        got = enc.run_kernel(x, head, gamma, beta)
        want = FiLMLayer.modulate(head(enc(series)), gamma[:, None, :],
                                  beta[:, None, :])
    assert torch.equal(_as_series(got), want)


def _kernel_args(case):
    """The op's arguments for a block no kernel takes (``case``), as CPU
    tensors: kernel_args checks the shapes before it touches a device."""
    t, cin, width, k, proj, dim = 15, 64, 64, 3, False, 3
    if case == "steps_500":             # 500 (64 + 64) floats: 256 KB
        t = 500
    elif case == "even_kernel":
        k = 4
    elif case == "width_without_projection":
        cin = 13
    elif case == "rank_4":
        dim = 4
    x = torch.empty((2, t, 3, cin) if dim == 4 else (5, t, cin))
    v = torch.empty(width)
    return (x, torch.empty(width, cin, k), v, v, v,
            torch.empty(width, width, 1), v,
            torch.empty(width, cin, 1) if proj else None,
            torch.empty(width) if proj else None, None, None, None, None,
            1, 8, 1e-5)


@pytest.mark.parametrize("case", ["steps_500", "even_kernel",
                                  "width_without_projection", "rank_4"])
def test_the_op_refuses_a_block_no_kernel_takes(case):
    with pytest.raises(ValueError, match="tcn_block"):
        tb.kernel_args(*_kernel_args(case))


def test_the_longest_series_the_general_kernel_takes():
    """The shared memory bound, 227 KB (58,112 floats): 64 -> 64 takes 453
    steps without a head, 302 with one (16 floats, and 128 or 192 a
    step)."""
    assert tb.any_smem_bytes(453, 64, 64, 8, False) <= tb.MAX_SMEM \
        < tb.any_smem_bytes(454, 64, 64, 8, False)
    assert tb.any_smem_bytes(302, 64, 64, 8, True) <= tb.MAX_SMEM \
        < tb.any_smem_bytes(303, 64, 64, 8, True)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("film", [True, False])
def test_the_ops_plain_head_and_film_are_the_modules(layout, film):
    enc = _encoder()
    head, film_layer = _film()
    x, series = _input(13, 15, layout)
    zt = torch.randn(series.shape[0], 48)
    with torch.no_grad():
        gamma, beta = film_layer(zt)
        before = dict(tb.tcn_block.calls)
        got = enc.run_kernel(x, head, gamma if film else None,
                             beta if film else None)
        assert tb.tcn_block.calls == dict(before,
                                          kernel=before["kernel"] + 3)
        want = head(enc(series))
        if film:
            want = FiLMLayer.modulate(want, gamma[:, None, :],
                                      beta[:, None, :])
    assert got.shape == x.shape[:-1] + (8,) and got.is_contiguous()
    assert torch.equal(_as_series(got), want)


def test_the_models_kernel_path_on_the_cpu_is_its_composed_path():
    """forward_phase and forward_phase_at_locations as the kernel path
    runs them (TCNEncoder.run_kernel, the op's plain version here) against
    their composed path, every return."""
    model = rep.RepresentationModel(34, 13).eval()
    rep.init_parameters(model, torch.Generator().manual_seed(4))
    x, series = _input(13, 15, "spatial")
    zt = torch.randn(2, 9, 7, 48)
    tcn = model.phase_tcn
    with torch.inference_mode():
        want = model.forward_phase(x, zt)
        want_loc = model.forward_phase_at_locations(
            series, zt.reshape(-1, 48), return_film=True,
            return_pre_film=True)
        tcn.takes_kernel = lambda *a, **k: True
        got = model.forward_phase(x, zt)
        got_loc = model.forward_phase_at_locations(
            series, zt.reshape(-1, 48), return_film=True,
            return_pre_film=True)
    assert torch.equal(got, want)
    for g, w in zip(got_loc, want_loc):
        assert torch.equal(g, w)


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("head", [None, 8])
def test_the_fake_gives_the_shapes_and_strides(spatial, head):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty((2, 15, 6, 5, 64) if spatial else (60, 15, 64))
        w = torch.empty(64, 64, 3)
        v = torch.empty(64)
        out = torch.ops.forest_tpu_torch.tcn_block(
            x, w, v, v, v, torch.empty(64, 64, 1), v, None, None,
            None if head is None else torch.empty(head, 64),
            None if head is None else torch.empty(head),
            None if head is None else torch.empty(60, head),
            None if head is None else torch.empty(60, head), 2, 8, 1e-5)
    width = head or 64
    assert out.shape == x.shape[:-1] + (width,)
    if spatial and head is None:        # series-major [B, H, W, T, C]
        assert out.stride() == (6 * 5 * 15 * 64, 64, 5 * 15 * 64, 15 * 64,
                                1)
    else:
        assert out.is_contiguous()


# ---------------------------------------------------------------- FLOPs
@pytest.mark.parametrize("cin,head", [(13, 0), (64, 0), (64, 8), (13, 8)])
def test_the_declared_flops_are_a_hand_count_and_the_modules_count(cin,
                                                                   head):
    n, t = 11, 7
    blk = _block(cin, 2)
    lin, _ = _film()
    x, _ = _input(cin, t, "contiguous")
    x = x[:n]
    hand = 2 * n * t * (3 * cin * 64 + 64 * 64
                        + (cin * 64 if cin != 64 else 0) + head * 64)
    with torch.no_grad():
        got = fl.step_flops(lambda: blk.run_kernel(
            x, lin if head else None))
        modules = fl.step_flops(lambda: (
            lin(blk(x.transpose(1, 2)).transpose(1, 2)) if head
            else blk(x.transpose(1, 2))))
        by_op = fl.flops_by_op(lambda: blk.run_kernel(
            x, lin if head else None))
    assert got == hand == modules
    assert by_op == {"forest_tpu_torch.tcn_block": hand}
    assert tb.tcn_block_cost(n * t, cin, 64, 3, cin != 64, head).flops \
        == hand


def test_the_frl_train_steps_count_is_unchanged():
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_flops import _small_step
    before = dict(tb.tcn_block.calls)
    step = _small_step("cpu")
    assert fl.step_flops(step) == SMALL_STEP_FLOPS
    assert tb.tcn_block.calls["kernel"] == before["kernel"]
    assert tb.tcn_block.calls["composed"] > before["composed"]


# ------------------------------------------------------------- the card
def _card_block_case(cin, d, t, layout, device):
    blk = _block(cin, d, device)
    x, series = _input(cin, t, layout, device)
    launches = tb.tcn_block.launches
    with torch.inference_mode():
        got = blk.run_kernel(x)
        torch.cuda.synchronize()
        want = blk(series.transpose(1, 2)).transpose(1, 2)
    assert tb.tcn_block.launches == launches + 1
    return _gaps(_as_series(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("t", STEPS)
@pytest.mark.parametrize("d", DILATIONS)
@pytest.mark.parametrize("cin", WIDTHS)
def test_the_kernel_is_the_composed_block_on_the_card(cuda_device, no_tf32,
                                                      cin, d, t, layout):
    rms, worst = _card_block_case(cin, d, t, layout, cuda_device)
    assert rms <= RMS_TOL and worst <= MAX_TOL, (rms, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_kernels_head_and_film_on_the_card(cuda_device, no_tf32,
                                               layout):
    enc = _encoder(device=cuda_device)
    head, film = _film(device=cuda_device)
    x, series = _input(13, 15, layout, cuda_device)
    zt = torch.randn(series.shape[0], 48, device=cuda_device)
    with torch.inference_mode():
        gamma, beta = film(zt)
        got = enc.run_kernel(x, head, gamma, beta)
        want = FiLMLayer.modulate(head(enc.block_2(enc.block_1(enc.block_0(
            series.transpose(1, 2)))).transpose(1, 2)), gamma[:, None, :],
            beta[:, None, :])
    rms, worst = _gaps(_as_series(got), want)
    assert rms <= RMS_TOL and worst <= MAX_TOL, (rms, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", OTHER_BLOCKS)
def test_the_general_kernel_is_the_composed_block_on_the_card(
        cuda_device, no_tf32, shape, layout):
    cin, width, groups, k, d, t = shape
    blk = _block(cin, d, cuda_device, width=width, groups=groups, k=k)
    x, series = _input(cin, t, layout, cuda_device)
    launches = tb.tcn_block.launches
    with torch.inference_mode():
        got = blk.run_kernel(x)
        want = blk(series.transpose(1, 2)).transpose(1, 2)
    assert tb.tcn_block.launches == launches + 1
    rms, worst = _gaps(_as_series(got), want)
    assert rms <= RMS_TOL and worst <= MAX_TOL, (rms, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(OTHER_TCNS))
def test_the_general_kernels_phase_pathway_on_the_card(cuda_device, no_tf32,
                                                       case):
    """A model whose TCN the tiled kernel lacks, through forward_phase and
    forward_phase_at_locations in inference: every block on the op, none
    composed, against the modules on the same card."""
    cin, widths, dils, groups, z, t = OTHER_TCNS[case]
    model = rep.RepresentationModel(
        34, cin, z_type_dim=48, z_phase_dim=z, phase_tcn_channels=widths,
        phase_tcn_dilations=dils, phase_tcn_num_groups=groups)
    rep.init_parameters(model, torch.Generator().manual_seed(8))
    model = model.to(cuda_device).eval()
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(2, t, 9, 7, cin, device=cuda_device, generator=g)
    zt = torch.randn(2, 9, 7, 48, device=cuda_device, generator=g)
    series = x.permute(0, 2, 3, 1, 4).reshape(-1, t, cin)
    before = dict(tb.tcn_block.calls)
    with torch.inference_mode():
        got = model.forward_phase(x, zt)
        got_loc, h = model.forward_phase_at_locations(
            series, zt.reshape(-1, 48), return_pre_film=True)
        want = _composed_phase(model.phase_tcn, model.phase_head,
                               model.phase_film, x, zt)
    assert tb.tcn_block.calls == dict(
        before, kernel=before["kernel"] + 2 * len(widths))
    for got_, want_ in ((got, want), (got_loc, _as_series(want))):
        rms, worst = _gaps(_as_series(got_), _as_series(want_))
        assert rms <= RMS_TOL and worst <= MAX_TOL, (rms, worst)


@pytest.mark.cuda
def test_a_block_no_kernel_takes_raises_on_the_card(cuda_device):
    """500 steps at width 64 outgrow the general kernel's shared memory:
    in inference on the card the phase pathway raises, and runs no block
    composed."""
    model = rep.RepresentationModel(34, 13).to(cuda_device).eval()
    x = torch.zeros(1, 500, 2, 2, 13, device=cuda_device)
    zt = torch.zeros(1, 2, 2, 48, device=cuda_device)
    before = dict(tb.tcn_block.calls)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="tcn_block"):
        model.forward_phase(x, zt)
    assert tb.tcn_block.calls["composed"] == before["composed"]


@pytest.fixture(scope="module")
def cell(no_tf32):
    """The embedding cell's batch: the v1 model's phase pathway, x_phase
    [8, 15, 256, 256, 13] and z_type [8, 256, 256, 48] drawn on the card,
    and the composed pathway's z_phase (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README)")
    cuda_device = torch.device("cuda", 0)
    model = rep.RepresentationModel(34, 13)
    rep.init_parameters(model, torch.Generator().manual_seed(5))
    model = model.to(cuda_device).eval()
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(CELL, device=cuda_device, generator=g)
    zt = torch.randn(CELL[0], *CELL[2:4], 48, device=cuda_device,
                     generator=g)
    with torch.inference_mode():
        want = _composed_phase(model.phase_tcn, model.phase_head,
                               model.phase_film, x, zt)
    return model, x, zt, want


@pytest.mark.cuda
def test_the_cells_batch_through_the_kernel(cell):
    model, x, zt, want = cell
    before = dict(tb.tcn_block.calls)
    launches = tb.tcn_block.launches
    with torch.inference_mode():
        got = model.forward_phase(x, zt)
    assert tb.tcn_block.launches == launches + 3
    assert tb.tcn_block.calls == dict(before, kernel=before["kernel"] + 3)
    assert got.shape == want.shape and got.is_contiguous()
    rms, worst = _gaps(got, want)
    assert rms <= RMS_TOL and worst <= MAX_TOL, (rms, worst)


def _tf32(t):
    """t's float32 values rounded to TF32's 10-bit mantissa (nearest, ties
    away), as a tensor core rounds a TF32 product's operands."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.cuda
def test_a_tf32_variant_fails_the_tolerance(cell):
    model, x, zt, want = cell
    tcn, head = model.phase_tcn, model.phase_head
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith(("phase_tcn.", "phase_head.")):
                    p.copy_(_tf32(p))
        with torch.inference_mode():
            got = tcn.run_kernel(_tf32(x), head,
                                 *model.phase_film(zt.reshape(-1, 48)))
    finally:
        model.load_state_dict(saved)
    rms, worst = _gaps(got, want)
    assert rms > 10 * RMS_TOL and worst > 10 * MAX_TOL, (rms, worst)


@pytest.mark.cuda
def test_autograd_on_the_card_takes_the_composed_path(cuda_device):
    enc = _encoder(device=cuda_device)
    x, _ = _input(13, 15, "spatial", cuda_device)
    before = dict(tb.tcn_block.calls)
    enc(x).sum().backward()
    assert tb.tcn_block.calls == dict(before,
                                      composed=before["composed"] + 3)


@pytest.mark.cuda
def test_the_frl_train_step_at_b12_counts_its_flops_as_before(cuda_device):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    t = cs.build_train_step(str(cuda_device))
    before = tb.tcn_block.calls["kernel"]
    n = fl.step_flops(t.train_step, t.state, t.batch, t.gen, t.weights,
                      t.curriculum)
    assert round(n / 1e9, 2) == FRL_STEP_GFLOP
    assert tb.tcn_block.calls["kernel"] == before
    assert math.isfinite(n)
