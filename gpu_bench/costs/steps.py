"""The FLOPs of one training step or one forward, from the configuration
and the traffic's shapes alone.

Counted as ``torch.utils.flop_counter.FlopCounterMode`` counts the port's
steps at 3cfd860c7617988dff336bd92534bbc78565c650
(``forest_tpu_torch/utils/flops.step_flops``): matrix products and
convolutions at 2 FLOPs a multiply-add, forward and the backward's
gradients that autograd forms, each hand-written kernel by its declared
cost (``costs/kernels.py``), nothing for elementwise work, reductions,
gathers or the optimizer. The benchmark's tests hold these counts equal to
``step_flops``'s at small sizes. Each count is split by the precision the
configuration states for the part: {"bfloat16": ..., "float32": ...}.
"""
from __future__ import annotations

from typing import Dict, Tuple

from gpu_bench.costs import kernels


def conv(rows: int, c_in: int, c_out: int, taps: int = 1,
         groups: int = 1) -> int:
    """Forward FLOPs of a convolution with ``rows`` output positions."""
    return 2 * rows * c_out * (c_in // groups) * taps


def linear(rows: int, c_in: int, c_out: int) -> int:
    return 2 * rows * c_in * c_out


def _anchors(sampling: Dict, hw: int) -> int:
    """Anchors per patch of the bindings' grid-plus-supplement strategy."""
    g = sampling["grid"]
    per_axis = len(range(g["exclude_border"], hw - g["exclude_border"],
                         g["stride"]))
    return per_axis * per_axis + sampling["supplement"]["n"]


def _widths(cfg: Dict) -> Dict[str, int]:
    m, b = cfg["model"], cfg["bindings"]
    feats = b["features"]
    return {
        "type_in": len(feats["type_encoder_input"]["channels"]),
        "spec": len(feats["infonce_type_spectral"]["channels"]),
        "phase_in": len(feats["phase_ccdc"]["channels"]),
        "zt": m["z_type_dim"], "zp": m["z_phase_dim"],
        "gate": m["spatial_conv"]["gate_hidden"],
        "gk": m["spatial_conv"]["gate_kernel_size"] ** 2,
        "k": 2 * m["spatial_conv"]["num_directions"],
        "rank": m["spatial_conv"]["rank"],
        "tk": m["phase_tcn"]["kernel_size"],
    }


def _type_pathway(cfg: Dict, pix: int, train: bool) -> Tuple[int, int]:
    """(bfloat16, float32) FLOPs of the type encoder and the smoothing
    block over ``pix`` pixels, with the backward when ``train``."""
    w = _widths(cfg)
    chans = cfg["model"]["type_encoder"]["channels"]
    zt, g, k, r = w["zt"], w["gate"], w["k"], w["rank"]
    f32 = 0
    c_prev = w["type_in"]
    for i, c in enumerate(chans):
        f = conv(pix, c_prev, c)
        # the first conv's input is data: its weight's gradient alone
        f32 += f + (f if i == 0 else 2 * f) * train
        c_prev = c
    sobel = conv(pix, zt, 2 * zt, 9, groups=zt)
    learned = (conv(pix, 2 * zt, g, 9) + conv(pix, g, k * r)
               + conv(pix, g, zt * r) + conv(pix, zt, g, w["gk"])
               + conv(pix, g, zt, w["gk"]))
    bf16 = sobel + learned + (sobel + 2 * learned) * train
    shape = (pix, 1, 1, zt)
    bf16 += kernels.bank_mix_fwd(shape, r, k // 2).flops
    if train:
        bf16 += kernels.bank_mix_bwd(shape, r, k // 2).flops
    return bf16, f32


def _phase_pathway(cfg: Dict, n: int, t: int, train: bool) -> int:
    """Float32 FLOPs of the TCN, the bottleneck and FiLM over ``n`` series
    of ``t`` steps, with the backward when ``train`` (the TCN's input and
    FiLM's conditioning take no gradient)."""
    w = _widths(cfg)
    tcn = cfg["model"]["phase_tcn"]
    zt, zp = w["zt"], w["zp"]
    f = 0
    c_prev = w["phase_in"]
    for i, c in enumerate(tcn["channels"]):
        layers = [conv(n * t, c_prev, c, w["tk"]), conv(n * t, c, c)]
        if c_prev != c:
            layers.append(conv(n * t, c_prev, c))
        for j, flops in enumerate(layers):
            data_input = i == 0 and j != 1
            f += flops + (flops if data_input else 2 * flops) * train
        c_prev = c
    head = linear(n * t, c_prev, zp)
    hidden = max(zt, zp) // 2
    film_in, film_out = linear(n, zt, hidden), linear(n, hidden, zp)
    f += head + 2 * head * train
    f += 2 * (film_in + film_in * train + film_out + 2 * film_out * train)
    return f


def _whitened(cfg: Dict, feature: str, rows: int) -> int:
    """The FeatureBuilder's whitening product of ``feature`` over
    ``rows`` locations, where the bindings ask for a covariance."""
    fc = cfg["bindings"]["features"][feature]
    c = len(fc["channels"])
    return linear(rows, c, c) if fc.get("covariance", {}).get("calculate") \
        else 0


def frl_train(cfg: Dict, batch: int, hw: int, t: int) -> Dict[str, int]:
    """One FRL training step (``process_batch`` with every loss but EVT,
    its gradients) on ``batch`` patches of ``hw``², ``t`` steps."""
    w = _widths(cfg)
    a = _anchors(cfg["bindings"]["sampling-strategy"]["grid-plus-supplement"],
                 hw)
    n, zt, zp = batch * a, w["zt"], w["zp"]
    pool = min(512, hw * hw)
    knn = cfg["bindings"]["losses"]["infonce_type_spatial"]["knn_k"]
    bf16, f32 = _type_pathway(cfg, batch * hw * hw, True)
    f32 += _phase_pathway(cfg, n, t, True)
    # K3, the backward of the one extraction of anchors, their positives
    # and the negative pool
    f32 += kernels.scatter_add_rows(
        (batch, a + a * knn + pool, zt), hw * hw).flops
    f32 += (_whitened(cfg, "infonce_type_spectral", n)
            + _whitened(cfg, "infonce_type_spectral",
                        batch * (a * knn + pool))
            + _whitened(cfg, "phase_ccdc", n * t))
    spec, pca = w["spec"], 8
    f32 += 4 * linear(zt, n, zt)            # VICReg's covariance, forward
    #                                         and backward (2); the demean's
    #                                         Gram
    f32 += 2 * linear(n, zt, pca)           # the demean's projection; the
    #                                         leakage's backward
    f32 += linear(n, pca, n)                # the demean's kNN
    f32 += linear(zp, n, zt)                # the leakage's covariance
    f32 += 3 * linear(zp, n * t, zp)        # phase VICReg, with backward
    f32 += linear(n, spec, n)               # cross-batch mutual kNN
    f32 += linear(batch * a, spec, a)       # phase pairs' distances
    f32 += linear(batch * a, 64, a)         # their ysfc-class overlaps
    return {"bfloat16": bf16, "float32": f32}


def frl_embed(cfg: Dict, batch: int, hw: int, t: int) -> Dict[str, int]:
    """One embedding batch: the type pathway on ``batch`` patches of
    ``hw``², then the dense phase path over every pixel's ``t`` steps."""
    pix = batch * hw * hw
    bf16, f32 = _type_pathway(cfg, pix, False)
    f32 += _phase_pathway(cfg, pix, t, False)
    f32 += _whitened(cfg, "phase_ccdc", pix * t)
    return {"bfloat16": bf16, "float32": f32}
