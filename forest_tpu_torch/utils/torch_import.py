"""Import reference PyTorch FRL checkpoints as flax-layout checkpoints.

Port of ``forest_tpu/utils/torch_import.py``: the migration path for users
of the reference, whose training loop saves ``{'model_state_dict':
model.state_dict(), ...}`` per epoch (the reference's
frl/training/train_representation.py:608-614). This module maps that
state_dict onto the flax parameter tree of the RepresentationModel, which
both packages' ``save_state`` write and both packages'
``eval.frozen.load_frozen_model`` read, so a trained reference encoder runs
the port's eval tools on a card without JAX. The torch-side layer naming is
derived from the reference model definitions:

- Conv2DEncoder ``encoder.layers.{j}``: Conv2d(bias=False) / GroupNorm
  interleaved with parameterless ReLU/Dropout2d slots, optional trailing
  1x1 Conv2d projection (conv2d_encoder.py:97-141).
- EdgeAwareSmoothingConv2D ``spatial_conv``: buffers bank/sobel_x/sobel_y
  (fixed constants, rebuilt statically here), ``mix_backbone.0``,
  ``mix_head_A``, ``mix_head_B``, ``gate_net.{0,2}`` (spatial.py:237-270).
- TCNEncoder ``phase_tcn.layers.{i}.{projection,conv,norm,gate}``
  (tcn.py:53-76,176-198).
- ``phase_head`` 1x1 Conv2d (representation.py:169).
- FiLM ``phase_film.{gamma,beta}_network.{0,2}`` 1x1 Convs
  (conditioning.py:55-67).
- MLPProjectionHead ``type_projection.net.{0,1,3}`` Linear/BatchNorm1d/Linear
  (heads.py:224-229).

Weight transforms: Conv2d [O,I,kh,kw] -> flax [kh,kw,I,O]; Conv1d [O,I,k]
-> [k,I,O]; Linear [O,I] -> Dense [I,O]; 1x1 Conv2d -> Dense via
``w[:, :, 0, 0].T``; GroupNorm weight -> scale. One data-layout fixup: the
reference feeds ``mix_backbone`` with ``cat([dx, dy], dim=1)`` (all-gx then
all-gy blocks, spatial.py:297) while this repository's ``sobel_grads``
interleaves gx/gy per channel, so the backbone conv's INPUT channels are
permuted accordingly.

Known divergences (surfaced in the import report):
- ``type_projection``: the reference uses BatchNorm1d; this repository uses
  LayerNorm (the reference ships with the projection disabled,
  frl_repr_model_v1.yaml:76-79). The BatchNorm eval affine is folded
  exactly into fc1 and the LayerNorm stays at identity init, so imported
  projections are approximate.

The reference checkpoint stores ``model_config`` (its own YAML schema with
a top-level ``latents`` section), ``type_in_channels`` and
``phase_in_channels`` alongside the state_dict, so the CLI needs no extra
arguments for a standard checkpoint; :func:`translate_reference_model_config`
maps the reference schema onto this repository's (``latents.*`` ->
``model.*``, ``dropout`` -> ``dropout_rate``). The target tree comes from
the port's own RepresentationModel (``from_config`` and
``init_parameters``), so nothing here needs JAX.

Run: python -m forest_tpu_torch.utils.torch_import \
        --checkpoint encoder_last.pt --output encoder_imported.msgpack
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

_BN_EPS = 1e-5  # torch BatchNorm1d default
_BUFFER_NAMES = ("bank", "sobel_x", "sobel_y")
_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


@dataclass
class ImportReport:
    mapped: List[str] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)    # buffers, BN stats
    unmapped: List[str] = field(default_factory=list)   # unrecognized keys
    defaulted: List[str] = field(default_factory=list)  # flax leaves kept at init
    warnings: List[str] = field(default_factory=list)

    def summary(self) -> str:
        return (f"mapped {len(self.mapped)} tensors, "
                f"skipped {len(self.skipped)} buffers/stats, "
                f"{len(self.unmapped)} unmapped, "
                f"{len(self.defaulted)} defaulted, "
                f"{len(self.warnings)} warnings")


def _conv2d(w: np.ndarray) -> np.ndarray:
    """torch Conv2d [O,I,kh,kw] -> flax [kh,kw,I,O]."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv1d(w: np.ndarray) -> np.ndarray:
    """torch Conv1d [O,I,k] -> flax [k,I,O]."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _dense(w: np.ndarray) -> np.ndarray:
    """torch Linear [O,I] -> flax Dense kernel [I,O]."""
    return np.ascontiguousarray(w.T)


def _dense_from_1x1(w: np.ndarray) -> np.ndarray:
    """torch 1x1 Conv2d [O,I,1,1] -> flax Dense kernel [I,O]."""
    return np.ascontiguousarray(w[:, :, 0, 0].T)


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _req(sd: Mapping[str, np.ndarray], key: str, context: str) -> np.ndarray:
    """Fetch a sibling tensor with a descriptive error when absent."""
    if key not in sd:
        raise ValueError(
            f"checkpoint is missing {key!r} (expected alongside {context}; "
            "incomplete or non-reference state_dict?)")
    return sd[key]


def _group(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[int, Dict]:
    """Collect ``{prefix}{j}.{leaf}`` entries into {j: {leaf: tensor}}."""
    out: Dict[int, Dict] = {}
    pat = re.compile(re.escape(prefix) + r"(\d+)\.(\w+)$")
    for k, v in sd.items():
        m = pat.match(k)
        if m:
            out.setdefault(int(m.group(1)), {})[m.group(2)] = v
    return out


def _convert_encoder(sd, params, rep: ImportReport) -> None:
    """``encoder.layers.*`` -> encoder/{conv_i, norm_i, conv_out}.

    Slot indices in the reference Sequential depend on which parameterless
    layers (ReLU/Dropout2d) were appended, so stages are recovered by
    CLASSIFYING parameterized entries in slot order: biasless 4-D weight =
    stage conv, 1-D weight+bias = GroupNorm, 4-D weight WITH bias = the
    optional trailing projection (Conv2d default bias=True -> conv_out)."""
    enc: Dict[str, Any] = {}
    conv_i = norm_i = 0
    slots = _group(sd, "encoder.layers.")
    for j in sorted(slots):
        entry = slots[j]
        w = entry["weight"]
        key = f"encoder.layers.{j}"
        if w.ndim == 4 and "bias" not in entry:
            enc[f"conv_{conv_i}"] = {"kernel": _conv2d(_f32(w))}
            conv_i += 1
            rep.mapped.append(f"{key}.weight")
        elif w.ndim == 1:
            enc[f"norm_{norm_i}"] = {
                "scale": _f32(w),
                "bias": _f32(_req(sd, f"{key}.bias", f"{key}.weight"))}
            norm_i += 1
            rep.mapped += [f"{key}.weight", f"{key}.bias"]
        elif w.ndim == 4:
            enc["conv_out"] = {
                "kernel": _conv2d(_f32(w)),
                "bias": _f32(_req(sd, f"{key}.bias", f"{key}.weight"))}
            rep.mapped += [f"{key}.weight", f"{key}.bias"]
        else:
            rep.unmapped.append(f"{key}.weight")
    if enc:
        params["encoder"] = enc


def _convert_spatial(sd, params, rep: ImportReport) -> None:
    sp: Dict[str, Any] = {}
    mb_w = sd.get("spatial_conv.mix_backbone.0.weight")
    if mb_w is not None:
        w = _f32(mb_w)                       # [hid, 2C, 3, 3]
        c = w.shape[1] // 2
        idx = np.empty(2 * c, np.int64)      # block [gx | gy] -> interleaved
        idx[0::2] = np.arange(c)
        idx[1::2] = np.arange(c) + c
        sp["mix_backbone"] = {
            "kernel": _conv2d(w[:, idx]),
            "bias": _f32(_req(sd, "spatial_conv.mix_backbone.0.bias",
                              "mix_backbone.0.weight")),
        }
        rep.mapped += ["spatial_conv.mix_backbone.0.weight",
                       "spatial_conv.mix_backbone.0.bias"]
    for tname, fname in (("mix_head_A", "mix_head_A"),
                         ("mix_head_B", "mix_head_B")):
        w = sd.get(f"spatial_conv.{tname}.weight")
        if w is not None:
            sp[fname] = {"kernel": _conv2d(_f32(w)),
                         "bias": _f32(_req(sd, f"spatial_conv.{tname}.bias",
                                           f"{tname}.weight"))}
            rep.mapped += [f"spatial_conv.{tname}.weight",
                           f"spatial_conv.{tname}.bias"]
    for slot, fname in ((0, "gate_0"), (2, "gate_1")):
        w = sd.get(f"spatial_conv.gate_net.{slot}.weight")
        if w is not None:
            sp[fname] = {"kernel": _conv2d(_f32(w)),
                         "bias": _f32(_req(
                             sd, f"spatial_conv.gate_net.{slot}.bias",
                             f"gate_net.{slot}.weight"))}
            rep.mapped += [f"spatial_conv.gate_net.{slot}.weight",
                           f"spatial_conv.gate_net.{slot}.bias"]
    for buf in _BUFFER_NAMES:
        if f"spatial_conv.{buf}" in sd:
            rep.skipped.append(f"spatial_conv.{buf}")
    if sp:
        params["spatial_conv"] = sp


def _convert_tcn(sd, params, rep: ImportReport) -> None:
    blocks: Dict[str, Any] = {}
    pat = re.compile(r"phase_tcn\.layers\.(\d+)\.(conv|norm|gate|projection)"
                     r"\.(weight|bias)$")
    for k, v in sd.items():
        m = pat.match(k)
        if not m:
            continue
        i, sub, leaf = int(m.group(1)), m.group(2), m.group(3)
        blk = blocks.setdefault(f"block_{i}", {})
        dst = blk.setdefault(sub, {})
        v = _f32(v)
        if sub == "norm":
            dst["scale" if leaf == "weight" else "bias"] = v
        elif leaf == "weight":
            dst["kernel"] = _conv1d(v)
        else:
            dst["bias"] = v
        rep.mapped.append(k)
    if blocks:
        params["phase_tcn"] = blocks


def _convert_heads(sd, params, rep: ImportReport) -> None:
    if "phase_head.weight" in sd:
        params["phase_head"] = {
            "kernel": _dense_from_1x1(_f32(sd["phase_head.weight"])),
            "bias": _f32(_req(sd, "phase_head.bias", "phase_head.weight")),
        }
        rep.mapped += ["phase_head.weight", "phase_head.bias"]

    film: Dict[str, Any] = {}
    for net, stem in (("gamma_network", "gamma"), ("beta_network", "beta")):
        for slot, suffix in ((0, "0"), (2, "1")):
            w = sd.get(f"phase_film.{net}.{slot}.weight")
            if w is None:
                continue
            film[f"{stem}_{suffix}"] = {
                "kernel": _dense_from_1x1(_f32(w)),
                "bias": _f32(_req(sd, f"phase_film.{net}.{slot}.bias",
                                  f"{net}.{slot}.weight")),
            }
            rep.mapped += [f"phase_film.{net}.{slot}.weight",
                           f"phase_film.{net}.{slot}.bias"]
    if film:
        params["phase_film"] = film

    if "type_projection.net.0.weight" in sd:
        def pr(k):
            return _f32(_req(sd, f"type_projection.net.{k}",
                             "type_projection.net.0.weight"))
        w0 = _f32(sd["type_projection.net.0.weight"])   # [hid, in]
        b0 = pr("0.bias")
        scale = pr("1.weight") / np.sqrt(pr("1.running_var") + _BN_EPS)
        params["type_projection"] = {
            "fc1": {"kernel": _dense(w0 * scale[:, None]),
                    "bias": (b0 - pr("1.running_mean")) * scale
                    + pr("1.bias")},
            "fc2": {"kernel": _dense(pr("3.weight")),
                    "bias": pr("3.bias")},
        }
        rep.mapped += [f"type_projection.net.{s}.{leaf}"
                       for s, leaf in ((0, "weight"), (0, "bias"),
                                       (1, "weight"), (1, "bias"),
                                       (3, "weight"), (3, "bias"))]
        for stat in _BN_STATS:
            k = f"type_projection.net.1.{stat}"
            if k in sd:
                rep.skipped.append(k)
        rep.warnings.append(
            "type_projection: BatchNorm1d eval affine folded into fc1; the "
            "flax LayerNorm stays at identity init, so projection outputs "
            "are approximate (reference ships with the projection disabled)")


def convert_state_dict(sd: Mapping[str, Any], *, strict: bool = True
                       ) -> Tuple[Dict[str, Any], ImportReport]:
    """Reference ``model.state_dict()`` (numpy-valued) -> flax params dict.

    Accepts the raw state_dict or the saved wrapper (``model_state_dict``
    key). Returns (params, report); ``strict`` raises on any tensor that
    cannot be represented on the flax side.
    """
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict[str, Any] = {}
    rep = ImportReport()
    _convert_encoder(sd, params, rep)
    _convert_spatial(sd, params, rep)
    _convert_tcn(sd, params, rep)
    _convert_heads(sd, params, rep)

    accounted = set(rep.mapped) | set(rep.skipped) | set(rep.unmapped)
    for k in sd:
        if k not in accounted:
            rep.unmapped.append(k)
    if strict and rep.unmapped:
        raise ValueError(f"unmapped reference tensors: {sorted(rep.unmapped)}")
    return params, rep


def _tree_paths(tree: Mapping, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_tree_paths(v, p))
        else:
            out[p] = tuple(np.shape(v))
    return out


# Flax leaves that may legitimately stay at their init values after an
# import (no torch counterpart; see module docstring).
_DEFAULT_OK = re.compile(r"^type_projection/norm/(scale|bias)$")


def import_reference_checkpoint(sd: Mapping[str, Any], model_cfg: Dict,
                                type_in_channels: int,
                                phase_in_channels: int, *,
                                strict: bool = True):
    """Convert + validate against the target model's parameter tree.

    Returns (params, report): ``params`` is the flax-layout tree of the
    RepresentationModel built from ``model_cfg`` (missing leaves -- e.g.
    the LayerNorm the reference doesn't have -- keep the values of
    ``init_parameters`` from seed 0 and are listed in
    ``report.defaulted``)."""
    import torch

    from forest_tpu_torch.models import representation as rmod
    from forest_tpu_torch.utils.flax_bridge import params_to_flax

    model = rmod.from_config(model_cfg, type_in_channels, phase_in_channels)
    rmod.init_parameters(model, torch.Generator().manual_seed(0))
    template = params_to_flax(model.state_dict())

    converted, rep = convert_state_dict(sd, strict=strict)
    want = _tree_paths(template)
    got = _tree_paths(converted)

    extra = sorted(set(got) - set(want))
    if extra:
        msg = (f"converted tensors have no home in the target model: {extra}"
               " (model_cfg mismatch with the checkpoint?)")
        if strict:
            raise ValueError(msg)
        rep.warnings.append(msg + " -- dropped")
        for p in extra:
            rep.unmapped.append(p)
            node = converted
            *parents, leaf = p.split("/")
            for k in parents:
                node = node[k]
            del node[leaf]
        got = _tree_paths(converted)
    for p in sorted(set(want) - set(got)):
        if _DEFAULT_OK.match(p):
            rep.defaulted.append(p)
        elif strict:
            raise ValueError(
                f"target leaf {p} missing from the checkpoint "
                "(architecture mismatch?)")
        else:
            rep.defaulted.append(p)
    for p, shp in got.items():
        if want[p] != shp:
            raise ValueError(
                f"shape mismatch at {p}: checkpoint {shp} vs model {want[p]}")

    def fill(tmpl: Mapping, conv: Mapping) -> Dict:
        out = {}
        for k, v in tmpl.items():
            if isinstance(v, Mapping):
                out[k] = fill(v, conv.get(k, {}))
            else:
                out[k] = np.asarray(conv[k], np.float32) if k in conv \
                    else np.asarray(v)
        return out

    return fill(template, converted), rep


def translate_reference_model_config(cfg: Dict) -> Dict:
    """Reference model-YAML schema -> the version-4 schema.

    The reference nests latent dims under ``latents`` and uses ``dropout``
    where this repository uses ``model.z_*_dim`` / ``dropout_rate``
    (frl_repr_model_v1.yaml:13-78; PARITY.md §2.6 renamed keys). Configs
    already in the version-4 shape pass through unchanged.
    """
    if "latents" not in cfg:
        return cfg
    lat = cfg["latents"]
    te = dict(cfg.get("type_encoder", {}))
    sc = dict(cfg.get("spatial_conv", {}))
    pt = dict(cfg.get("phase_tcn", {}))
    proj = dict(cfg.get("type_projection", {}))

    def section(src, keys, renames=()):
        out = {k: src[k] for k in keys if k in src}
        for old, new in renames:
            if old in src:
                out[new] = src[old]
        return out

    return {"version": str(cfg.get("version", "4")), "model": {
        "z_type_dim": lat["z_type_dim"],
        "z_phase_dim": lat["z_phase_dim"],
        "type_encoder": section(
            te, ("channels", "kernel_size", "num_groups"),
            (("dropout", "dropout_rate"),)),
        "spatial_conv": section(
            sc, ("gate_hidden", "gate_kernel_size", "num_directions",
                 "coarse_dilation", "rank")),
        "phase_tcn": section(
            pt, ("channels", "kernel_size", "dilations", "num_groups"),
            (("dropout", "dropout_rate"),)),
        "type_projection": section(
            proj, ("enabled", "hidden_dim", "output_dim", "l2_normalize")),
    }}


def main(argv=None):
    import argparse
    import sys
    from pathlib import Path

    import torch
    import yaml

    from forest_tpu_torch.training.checkpointing import save_state

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True,
                    help=".pt file saved by the reference trainer")
    ap.add_argument("--model-config", default=None,
                    help="model YAML (version-4 or reference schema); "
                         "defaults to the model_config stored in the "
                         "checkpoint")
    ap.add_argument("--type-in-channels", type=int, default=None,
                    help="defaults to the checkpoint's stored value")
    ap.add_argument("--phase-in-channels", type=int, default=None,
                    help="defaults to the checkpoint's stored value")
    ap.add_argument("--output", required=True,
                    help="msgpack output (loadable by eval.frozen."
                         "load_frozen_model; a .json meta sidecar is "
                         "written next to it)")
    ap.add_argument("--no-strict", action="store_true",
                    help="warn instead of failing on unmappable tensors")
    a = ap.parse_args(argv)

    raw = torch.load(a.checkpoint, map_location="cpu", weights_only=True)
    sd = raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw

    def to_np(v):
        if hasattr(v, "float"):            # torch tensor (incl. bf16/f16)
            return v.detach().float().numpy()
        return np.asarray(v)

    sd = {k: to_np(v) for k, v in sd.items()}

    if a.model_config is not None:
        model_cfg = yaml.safe_load(Path(a.model_config).read_text())
    elif isinstance(raw, dict) and "model_config" in raw:
        model_cfg = raw["model_config"]
    else:
        raise SystemExit("--model-config required: the checkpoint carries "
                         "no model_config entry")
    model_cfg = translate_reference_model_config(model_cfg)

    def channels(flag_val, key):
        if flag_val is not None:
            return flag_val
        if isinstance(raw, dict) and key in raw:
            return int(raw[key])
        raise SystemExit(f"--{key.replace('_', '-')} required: the "
                         f"checkpoint carries no {key} entry")

    tin = channels(a.type_in_channels, "type_in_channels")
    pin = channels(a.phase_in_channels, "phase_in_channels")

    params, rep = import_reference_checkpoint(
        sd, model_cfg, tin, pin, strict=not a.no_strict)
    out = Path(a.output)
    meta = {"model_config": model_cfg,
            "type_in_channels": tin,
            "phase_in_channels": pin,
            "imported_from": str(a.checkpoint),
            "import_report": {
                "mapped": len(rep.mapped), "skipped": rep.skipped,
                "unmapped": rep.unmapped, "defaulted": rep.defaulted,
                "warnings": rep.warnings}}
    save_state(out, {"params": params}, meta)
    print(f"wrote {out}: {rep.summary()}", file=sys.stderr)
    for w in rep.warnings:
        print(f"  warning: {w}", file=sys.stderr)


if __name__ == "__main__":
    main()


__all__ = ["convert_state_dict", "import_reference_checkpoint",
           "translate_reference_model_config", "ImportReport", "main"]
