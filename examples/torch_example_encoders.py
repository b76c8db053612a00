"""Encoder demos: every model block on synthetic tensors, on the port.

The PyTorch counterpart of ``examples/example_encoders.py``: the same
blocks, the same inputs (one ``np.random.default_rng(0)`` drawn in the same
order) and the same printed lines. The weights are seeded from a
``torch.Generator`` (``models.representation.init_parameters``), so they
are not the JAX example's; ``main(params=...)`` takes a block's weights as a
state_dict instead (``utils.flax_bridge.params_from_flax`` of the JAX
example's). On a card the smoothing block runs the hand-written bank-mix
kernel and the VQ-VAE the VQ kernel.

Run: python examples/torch_example_encoders.py [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # run from a checkout, not installed
    sys.path.insert(0, str(ROOT))
from forest_tpu_torch.data.loader import resolve_device  # noqa: E402

LINES = {
    "conv2d": "Conv2DEncoder: {x_shape} -> {h_shape}",
    "smoothing": "EdgeAwareSmoothing: gate mean {gate_mean:.3f} "
                 "(1 = preserve, 0 = smooth)",
    "tcn": "TCN (stats pooling): {ts_shape} -> {pooled_shape}",
    "film": "FiLM at init: gamma~{gamma_mean:.3f} beta~{beta_mean:.3f} "
            "(near identity)",
    "representation": "RepresentationModel ({k_params:.0f}k params): "
                      "z_type {z_shape}, z_phase {zp_shape}",
    "vqvae": "VQVAE: indices {indices}, perplexity {perplexity:.2f}",
}
# the blocks whose weights main(params=...) takes, by name
BLOCKS = ("conv2d", "smoothing", "tcn", "film", "representation", "vqvae")


def say(out: dict, key: str, **values) -> None:
    """Print ``LINES[key]`` filled with ``values`` and keep the values."""
    print(LINES[key].format(**values))
    out[key] = values


def main(argv=None, params: Optional[Mapping[str, Mapping]] = None) -> dict:
    """Returns the printed values by line and, under ``tensors``, each
    block's outputs as numpy arrays. ``params`` maps a name of ``BLOCKS``
    to that block's state_dict; the others are seeded."""
    from forest_tpu_torch.models import representation as rep
    from forest_tpu_torch.models import vqvae as vqm
    from forest_tpu_torch.models.conditioning import FiLMLayer
    from forest_tpu_torch.models.conv2d_encoder import Conv2DEncoder
    from forest_tpu_torch.models.spatial import EdgeAwareSmoothingConv2D
    from forest_tpu_torch.models.tcn import TCNEncoder

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    params = dict(params or {})
    unknown = sorted(set(params) - set(BLOCKS))
    if unknown:
        raise ValueError(f"no block named {unknown}; blocks: {BLOCKS}")

    def build(name, module, init=rep.init_parameters):
        if name in params:
            module.load_state_dict(params[name], strict=True)
        else:
            init(module, torch.Generator().manual_seed(0))
        return module.to(dev).eval()

    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev)

    def integers(high, shape):
        return torch.as_tensor(rng.integers(0, high, shape),
                               dtype=torch.int32, device=dev)

    out: dict = {}
    tensors: dict = {}
    with torch.inference_mode():
        x = normal(2, 32, 32, 10)
        enc = build("conv2d", Conv2DEncoder(10, (32, 16)))
        h = enc(x)
        say(out, "conv2d", x_shape=tuple(x.shape), h_shape=tuple(h.shape))

        sm = build("smoothing", EdgeAwareSmoothingConv2D(16))
        smoothed, gate = sm(h, return_gate=True)
        say(out, "smoothing", gate_mean=float(gate.mean()))

        tcn = build("tcn", TCNEncoder(3, (24, 24), dilations=(1, 2),
                                      pooling="stats"))
        ts = normal(5, 15, 3)
        pooled = tcn(ts)
        say(out, "tcn", ts_shape=tuple(ts.shape),
            pooled_shape=tuple(pooled.shape))

        film = build("film", FiLMLayer(16, 8))
        gamma, beta = film(normal(5, 16))
        say(out, "film", gamma_mean=float(gamma.mean()),
            beta_mean=float(beta.mean()))

        model = build("representation", rep.RepresentationModel(
            type_in_channels=10, phase_in_channels=3, z_type_dim=16,
            type_encoder_channels=(32, 16), z_phase_dim=4,
            phase_tcn_channels=(16, 16), phase_tcn_dilations=(1, 2)))
        z = model(x)
        px, zt = normal(7, 15, 3), normal(7, 16)
        zp = model.forward_phase_at_locations(px, zt)
        n = sum(p.numel() for p in model.parameters())
        say(out, "representation", k_params=n / 1e3, z_shape=tuple(z.shape),
            zp_shape=tuple(zp.shape))
        out["representation"]["n_params"] = n

        batch = {"cont": normal(4, 5, 6), "cat": integers(9, (4, 5, 1)),
                 "cat_target": {"evt": integers(9, (4, 5))},
                 "naip": normal(4, 3, 3, 2),
                 "canopy": torch.zeros(4, device=dev)}
        vq = build("vqvae", vqm.VQVAE(
            cont_dim=6, cat_vocab_sizes={"evt": 9}, naip_bands=2,
            num_timesteps=5, emb_dim=16, codebook_size=8, hidden=16),
            init=vqm.init_parameters)
        r = vq(batch)
        say(out, "vqvae", indices=r.indices.cpu().numpy(),
            perplexity=float(r.perplexity))

        for name, v in (("h", h), ("smoothed", smoothed), ("gate", gate),
                        ("pooled", pooled), ("gamma", gamma), ("beta", beta),
                        ("z_type", z), ("z_phase", zp),
                        ("vq_indices", r.indices), ("vq_z_e", r.z_e)):
            tensors[name] = v.float().cpu().numpy() if v.is_floating_point() \
                else v.cpu().numpy()
    out["tensors"] = tensors
    return out


if __name__ == "__main__":
    main()
