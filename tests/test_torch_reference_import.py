"""The port's reference-checkpoint importer against the JAX package's.

``forest_tpu_torch.utils.torch_import`` and ``forest_tpu.utils.
torch_import`` on the same synthetic reference state_dicts (seeded random
tensors under the reference's key names, ``torch_parity.
reference_state_dict``), with and without a BatchNorm projection head:
the converted trees equal bit for bit, the imported trees too (the
defaulted leaves, the LayerNorm the reference lacks, sit at identity on
both sides), both CLIs write the same params, and the two packages' models
on those params agree within rtol / atol 1e-5 (serving's bound). The error
paths raise the same errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.eval import frozen as jfrozen
from forest_tpu.utils import torch_import as jti
from forest_tpu_torch.eval import frozen as tfrozen
from forest_tpu_torch.training.checkpointing import load_state_raw
from forest_tpu_torch.utils import torch_import as tti
from torch_parity import EVAL_CFG, EVAL_CFG_PROJ, reference_state_dict

TOL = dict(rtol=1e-5, atol=1e-5)
TIN, PIN = 4, 3
CFGS = {"plain": EVAL_CFG, "projection": EVAL_CFG_PROJ}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _same_tree(got, ref, skip=()):
    g, r = _flat(got), _flat(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        if k not in skip:
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k
            np.testing.assert_array_equal(g[k], np.asarray(r[k]), err_msg=k)


def _report(rep):
    return (rep.mapped, rep.skipped, rep.unmapped, rep.defaulted,
            rep.warnings)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_convert_state_dict_equals_jax(name):
    sd = reference_state_dict(np.random.default_rng(0), CFGS[name], TIN, PIN)
    got, grep = tti.convert_state_dict({"model_state_dict": sd})
    ref, rrep = jti.convert_state_dict({"model_state_dict": sd})
    _same_tree(got, ref)
    assert _report(grep) == _report(rrep)
    assert len(grep.mapped) + len(grep.skipped) == len(sd)
    mb = got["spatial_conv"]["mix_backbone"]["kernel"]
    assert mb.shape == (3, 3, 16, 8)     # the input channels interleaved


@pytest.mark.parametrize("name", sorted(CFGS))
def test_import_reference_checkpoint_equals_jax(name):
    """Strict: every leaf converted or defaulted by rule; the trees equal,
    the defaulted LayerNorm at identity on both sides."""
    sd = reference_state_dict(np.random.default_rng(1), CFGS[name], TIN, PIN)
    got, grep = tti.import_reference_checkpoint(sd, CFGS[name], TIN, PIN)
    ref, rrep = jti.import_reference_checkpoint(sd, CFGS[name], TIN, PIN)
    _same_tree(got, ref)
    assert _report(grep) == _report(rrep)
    assert grep.defaulted == ([] if name == "plain" else
                              ["type_projection/norm/bias",
                               "type_projection/norm/scale"])


def test_import_not_strict_equals_jax():
    """Without ``strict``: a missing head and an unknown tensor are
    reported alike; the imported leaves equal, the defaulted ones keep each
    package's init (compared by name only)."""
    sd = reference_state_dict(np.random.default_rng(2), EVAL_CFG, TIN, PIN)
    del sd["phase_head.weight"], sd["phase_head.bias"]
    sd["extra.weight"] = np.ones(3, np.float32)
    got, grep = tti.import_reference_checkpoint(sd, EVAL_CFG, TIN, PIN,
                                                strict=False)
    ref, rrep = jti.import_reference_checkpoint(sd, EVAL_CFG, TIN, PIN,
                                                strict=False)
    assert _report(grep) == _report(rrep)
    assert grep.defaulted == ["phase_head/bias", "phase_head/kernel"]
    assert grep.unmapped == ["extra.weight"]
    _same_tree(got, ref, skip=grep.defaulted)


def _reference_pt(path, sd):
    """A checkpoint as the reference trainer saves it: the state_dict as
    tensors, its model config in the reference schema, the input
    widths."""
    m = EVAL_CFG_PROJ["model"]
    torch.save({"model_state_dict": {k: torch.from_numpy(np.asarray(v))
                                     for k, v in sd.items()},
                "model_config": {
                    "latents": {"z_type_dim": m["z_type_dim"],
                                "z_phase_dim": m["z_phase_dim"]},
                    **{k: m[k] for k in ("type_encoder", "spatial_conv",
                                         "phase_tcn", "type_projection")}},
                "type_in_channels": TIN, "phase_in_channels": PIN,
                "epoch": 7}, path)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Both CLIs on one reference checkpoint -> (the port's output, the
    JAX package's)."""
    tmp = tmp_path_factory.mktemp("torch_reference_import")
    _reference_pt(tmp / "encoder_last.pt", reference_state_dict(
        np.random.default_rng(3), EVAL_CFG_PROJ, TIN, PIN))
    out = {}
    for tag, mod in (("t", tti), ("j", jti)):
        out[tag] = tmp / f"imported_{tag}.msgpack"
        mod.main(["--checkpoint", str(tmp / "encoder_last.pt"),
                  "--output", str(out[tag])])
    return out


def test_mains_write_equal_checkpoints(imported):
    """The same params and the same metadata (the translated model config,
    the widths, the import report), apart from the output's own path."""
    (tp, tmeta), (jp, jmeta) = (load_state_raw(imported[k])
                                for k in ("t", "j"))
    _same_tree(tp["params"], jp["params"])
    for meta in (tmeta, jmeta):
        meta.pop("imported_from")
    assert tmeta == jmeta
    assert tmeta["model_config"]["model"]["type_projection"]["enabled"]
    assert tmeta["import_report"]["defaulted"] == [
        "type_projection/norm/bias", "type_projection/norm/scale"]


def test_imported_models_agree_with_jax(imported):
    """The port's checkpoint through the port's ``load_frozen_model`` and
    the JAX package's through its own: z_type of a seeded 32 x 32 patch,
    z_phase of 6 pixel series and the projection within 1e-5."""
    tm = tfrozen.load_frozen_model(imported["t"], "cpu")
    jm, jp = jfrozen.load_frozen_model(imported["j"])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 32, 32, TIN)).astype(np.float32)
    px = rng.normal(size=(6, 15, PIN)).astype(np.float32)
    with torch.inference_mode():
        zt = tm(torch.from_numpy(x))
        zp = tm.forward_phase_at_locations(torch.from_numpy(px),
                                           zt[0, :6, 0])
        g = tm.project_type(zt[0, 0])
    jzt = jm.apply({"params": jp}, jnp.asarray(x))
    jzp = jm.apply({"params": jp}, jnp.asarray(px), jzt[0, :6, 0],
                   method=jm.forward_phase_at_locations)
    jg = jm.apply({"params": jp}, jzt[0, 0], method=jm.project_type)
    for got, ref in ((zt, jzt), (zp, jzp), (g, jg)):
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert zp.shape == (6, 15, 3) and g.shape == (32, 5)


def _broken(case):
    sd = reference_state_dict(np.random.default_rng(5), EVAL_CFG, TIN, PIN)
    if case == "missing_leaf":
        del sd["phase_tcn.layers.1.gate.weight"]
    elif case == "shape":
        sd["phase_head.weight"] = np.zeros((3, 7, 1, 1), np.float32)
    else:
        sd["extra.weight"] = np.ones(3, np.float32)
    return sd


@pytest.mark.parametrize("case,match", [
    ("missing_leaf", "missing from the checkpoint"),
    ("shape", "shape mismatch at phase_head/kernel"),
    ("unmapped", "unmapped reference tensors")])
def test_errors_equal_jax(case, match):
    """``strict`` on a missing leaf and on an unknown tensor, and a shape
    mismatch (strict or not): the same ValueError from both packages."""
    sd = _broken(case)
    msgs = []
    for mod in (tti, jti):
        with pytest.raises(ValueError, match=match) as err:
            mod.import_reference_checkpoint(sd, EVAL_CFG, TIN, PIN,
                                            strict=case != "shape")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
