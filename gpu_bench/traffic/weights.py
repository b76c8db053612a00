"""Seeded weights, drawn on the device in one call.

Every parameter of a model gets its slice of one standard-normal draw,
scaled by its kind, as flax initialises the reference model: dense and
conv kernels N(0, 1 / fan_in); FiLM's output layers N(0, 0.01^2) with
gamma's bias 1; other biases 0; GroupNorm and LayerNorm scales 1.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


@torch.no_grad()
def draw(model: nn.Module, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """-> a state dict for ``model`` (the benchmark's reference model, whose
    names the port's model shares), on the generator's device."""
    film_out = {}
    for mod in model.modules():
        if hasattr(mod, "gamma_1") and hasattr(mod, "beta_1"):
            film_out[mod.gamma_1] = 1.0
            film_out[mod.beta_1] = 0.0
    kinds = {}
    for mod in model.modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                kinds[id(p)] = ("const", 1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                kinds[id(p)] = ("const", film_out.get(mod, 0.0))
            elif mod in film_out:
                kinds[id(p)] = ("normal", 0.01)
            elif leaf == "weight":
                kinds[id(p)] = ("normal", p[0].numel() ** -0.5)
            else:
                raise ValueError(f"no initialiser for parameter {leaf!r}")
    named = list(model.named_parameters())
    total = sum(p.numel() for _, p in named)
    z = torch.randn(total, generator=gen, device=gen.device)
    out, at = {}, 0
    for name, p in named:
        kind, v = kinds[id(p)]
        chunk = z[at:at + p.numel()].reshape(p.shape)
        out[name] = (chunk * v if kind == "normal"
                     else torch.full_like(chunk, v))
        at += p.numel()
    return out
