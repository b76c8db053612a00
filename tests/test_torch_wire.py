"""The compact host-to-device wire (``forest_tpu_torch.data.wire``) against
the JAX package's ``forest_tpu.data.wire``, on the CPU.

- encode: the same keys and dtypes as the JAX encoder, bfloat16 leaves
  equal to ``ml_dtypes``' bits (compared as uint16: rounding ties, NaN of
  both signs, infinities, subnormals, float64 input), packed masks and
  narrow ids byte for byte; the int-bound tiers, ``wire_int_bounds`` with
  a feature named "cat"; a mask with a 2-D companion, or one stored under
  ``__cm``, travels plain; the skip and "categorical" groups stay exact;
- decode: equal to the JAX decode (narrow ids widened to int32, the values
  unchanged), the identity on a plain batch, a channel-major group back to
  a contiguous channel-last tensor, a batch on another device refused;
- ``ForestDatasetV2.set_wire_layout(True)``: ``load_batch`` equal to the
  JAX dataset's channel-major batch (ragged edge patches zero-padded), and
  its decode equal to the channel-last batch rounded to bfloat16, bit for
  bit;
- one FRL CLI epoch with the wire on (the port's ``run_epoch`` and the JAX
  package's, ``wire_compact=True``, from the same seeded state, data and
  draws): every history value within rtol 1e-5, the step fed channel-major
  batches, the dataset's layout reset after the epoch; a VQ-VAE step on a
  wire batch within 2e-2 of the plain step (the JAX test's bound).
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from forest_tpu.data import wire as jwire
from forest_tpu.data.bindings import parse_bindings as jparse
from forest_tpu.data.cube_v2 import synthetic_frl_batch
from forest_tpu.data.frl_dataset import ForestDatasetV2 as JDataset
from forest_tpu.training import train_representation as jtr
from forest_tpu.training import train_vqvae as jtv
from forest_tpu.training.representation import loops as jloops
from forest_tpu.training.representation import step as jstep
from forest_tpu.training.representation import training_config as jtc
from forest_tpu_torch.data import parse_bindings as tparse
from forest_tpu_torch.data import wire
from forest_tpu_torch.data.frl_dataset import ForestDatasetV2 as TDataset
from forest_tpu_torch.data.loader import make_device_put
from forest_tpu_torch.training import train_representation as ttr
from forest_tpu_torch.training import train_vqvae as ttv
from forest_tpu_torch.training import vqvae_step as tvstep
from forest_tpu_torch.training.representation import loops as tloops
from forest_tpu_torch.training.representation import step as tstep
from forest_tpu_torch.training.representation import train_step as tts
from forest_tpu_torch.training.representation import training_config as ttc
from test_torch_train_representation import (MODEL_CFG, TIMINGS, cube,
                                             jax_draws,
                                             start_from_seeded_state,
                                             training_dict)
from test_torch_vqvae_model import build_pair, make_batch

assert cube      # the module fixture: a 96² v2 cube and its bindings


def vq_batch(rng, b=32):
    """A VQ-VAE batch with every float hazard bfloat16 has."""
    batch = make_batch(rng, b=b)
    c = batch["cont"]
    c[0, 0, :6] = [np.nan, -np.nan, np.inf, -np.inf, 1e-40, -0.0]
    # exact ties between two bfloat16 values: round to even both ways
    # and x86's default NaN (inf - inf), which is negative
    c[1, 0, :3] = np.asarray([0x3F808000, 0x3F818000, 0xFFC00000],
                             np.uint32).view(np.float32)
    batch["canopy64"] = rng.normal(size=(b,)) * 1e3        # float64
    return batch


def assert_encoded_equal(got, want, where=""):
    assert list(got) == list(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_encoded_equal(g, w, f"{where}/{k}")
            continue
        w = np.asarray(w)
        if w.dtype == ml_dtypes.bfloat16:
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16
            assert g.shape == w.shape, k
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                w.view(np.uint16), err_msg=f"{where}/{k}")
        else:
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            assert g.tobytes() == w.tobytes(), f"{where}/{k}"


def to_jax(tree):
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


# the id tiers: int_bounds -> the dtypes of "cat", cat_target "evt" and "bps"
TIERS = [
    pytest.param(None, (np.int32, np.int32, np.int32), id="no-bounds"),
    pytest.param({"cat": (-100, 9), "evt": (-100, 7), "bps": (-100, 5)},
                 (np.int8, np.int8, np.int8), id="signed-8"),
    pytest.param({"cat": 300, "evt": (-100, 300), "bps": (-100, 2 ** 15)},
                 (np.uint16, np.int16, np.int16), id="16-bit"),
    pytest.param({"cat": 9, "evt": (0, 7), "bps": (0, 300)},
                 (np.uint8, np.uint8, np.uint16), id="unsigned"),
    pytest.param({"cat": 2 ** 16, "evt": (0, 2 ** 16), "bps": (-100, 5)},
                 (np.uint16, np.uint16, np.int8), id="uint16-high"),
    pytest.param({"cat": 2 ** 17, "evt": (-100, 2 ** 16),
                  "bps": (-2 ** 16, 5)},
                 (np.int32, np.int32, np.int32), id="too-wide")]


def bounded_batch(seed, bounds):
    """``vq_batch`` with its ids inside ``bounds``, each bounded array
    holding its own extremes (the largest id below the bound, so a uint16
    tier carries ids of 2**15 and above)."""
    batch = vq_batch(np.random.default_rng(seed))
    if not bounds:
        return batch
    if not isinstance(bounds["cat"], tuple):
        batch["cat"] = np.abs(batch["cat"])     # a non-negative id block
    for name, a in (("cat", batch["cat"]), *batch["cat_target"].items()):
        lo, hi = bounds[name] if isinstance(bounds[name], tuple) \
            else (0, bounds[name])
        np.clip(a, lo, hi - 1, out=a)
        a.reshape(-1)[:2] = (lo, hi - 1)
    return batch


@pytest.mark.parametrize("bounds,tiers", TIERS)
def test_encode_equals_jax_bit_for_bit(bounds, tiers):
    batch = bounded_batch(0, bounds)
    got = wire.encode_wire_batch(batch, int_bounds=bounds)
    want = jwire.encode_wire_batch(batch, int_bounds=bounds)
    assert_encoded_equal(got, want)
    assert got["cont_nan_mask"].ndim == 2       # packed
    assert got["cont"].dtype == torch.bfloat16
    assert (got["cat"].dtype, got["cat_target"]["evt"].dtype,
            got["cat_target"]["bps"].dtype) == tiers


def test_frl_batch_encodes_as_jax_with_skip_groups():
    b = synthetic_frl_batch(np.random.default_rng(1), 2, 16)
    b["evt_codes"] = np.full((2, 16, 16, 1), 7123.0, np.float32)
    b["__sample_valid__"] = np.ones(2, bool)
    cfg = tstep.StepConfig(evt_enabled=True, evt_feature="evt_codes.evt")
    skip = tstep.wire_exact_groups(cfg)
    assert skip == jstep.wire_exact_groups(jstep.StepConfig(
        evt_enabled=True, evt_feature="evt_codes.evt")) == ("evt_codes",)
    assert tstep.wire_exact_groups(tstep.StepConfig()) == ()
    got = wire.encode_wire_batch(b, skip=skip)
    assert_encoded_equal(got, jwire.encode_wire_batch(b, skip=skip))
    for k in ("evt_codes", "static_categorical"):   # exact, float32
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], b[k])
    assert got["static"].dtype == torch.bfloat16
    assert got["__window__"].dtype == np.int32


def test_wire_int_bounds_match_jax_with_a_feature_named_cat():
    from types import SimpleNamespace
    for names, vocab in ((["cat", "evt"], {"cat": 9, "evt": 300}),
                         (["evt"], {"evt": 9}), ([], {})):
        ds = SimpleNamespace(cat_names=names, schema_cat={
            n: {"num_ids": v} for n, v in vocab.items()})
        assert ttv.wire_int_bounds(ds) == jtv.wire_int_bounds(ds)
    ds = SimpleNamespace(cat_names=["cat", "evt"],
                         schema_cat={"cat": {"num_ids": 9},
                                     "evt": {"num_ids": 300}})
    assert ttv.wire_int_bounds(ds)["cat"] == (-100, 300)


def test_masks_with_a_2d_or_a_channel_major_companion_travel_plain():
    rng = np.random.default_rng(2)
    b = {"score": rng.normal(size=(8, 5)).astype(np.float32),
         "score_nan_mask": (rng.random((8, 5)) > 0.3).astype(np.uint8),
         "orphan_nan_mask": (rng.random((8, 7)) > 0.3).astype(np.uint8),
         "grid__cm": rng.normal(size=(8, 3, 4, 4)).astype(np.float32),
         "grid_nan_mask": (rng.random((8, 4, 4, 3)) > 0.3).astype(np.uint8)}
    got = wire.encode_wire_batch(b)
    assert_encoded_equal(got, jwire.encode_wire_batch(b))
    for k in ("score_nan_mask", "orphan_nan_mask", "grid_nan_mask"):
        assert got[k].shape == b[k].shape       # not packed
    dec = wire.decode_wire_batch(make_device_put("cpu", ())(got))
    for k in ("score_nan_mask", "orphan_nan_mask", "grid_nan_mask"):
        np.testing.assert_array_equal(dec[k].numpy(), b[k])


@pytest.mark.parametrize("bounds,tiers", TIERS)
def test_decode_equals_jax_decode(bounds, tiers):
    batch = bounded_batch(3, bounds)
    batch["grid__cm"] = np.random.default_rng(4).normal(
        size=(4, 3, 5, 6, 7)).astype(np.float32)
    enc = wire.encode_wire_batch(batch, int_bounds=bounds)
    assert (enc["cat"].dtype, enc["cat_target"]["evt"].dtype,
            enc["cat_target"]["bps"].dtype) == tiers
    got = wire.decode_wire_batch(make_device_put("cpu", ())(enc))
    want = jwire.decode_wire_batch(to_jax(jwire.encode_wire_batch(
        batch, int_bounds=bounds)))
    assert sorted(got) == sorted(want) and "grid" in got
    for k, w in want.items():
        pairs = ([(got[k][n], w[n]) for n in w] if isinstance(w, dict)
                 else [(got[k], w)])
        for g, w_ in pairs:
            w_ = np.asarray(w_)
            if np.issubdtype(w_.dtype, np.integer) and \
                    not k.endswith("_nan_mask"):
                assert g.dtype == torch.int32     # widened on the device
                w_ = w_.astype(np.int32)
            else:
                assert g.dtype == getattr(torch, w_.dtype.name)
            np.testing.assert_array_equal(g.numpy(), w_, err_msg=k)
    assert got["grid"].is_contiguous() and got["grid"].shape == (4, 5, 6, 7,
                                                                3)


def test_decode_is_the_identity_on_a_plain_batch_and_refuses_a_device():
    batch = make_device_put("cpu", ())(make_batch(np.random.default_rng(5)))
    dec = wire.decode_wire_batch(batch, "cpu")
    for k, v in batch.items():
        if isinstance(v, dict):
            assert all(dec[k][n] is v[n] for n in v)
        else:
            assert dec[k] is v, k
    with pytest.raises(ValueError, match="the step runs on cuda"):
        wire.decode_wire_batch(batch, "cuda")


def test_stack_batches_owning_leaves_and_one_copy_per_leaf():
    rng = np.random.default_rng(6)
    batches = [wire.encode_wire_batch(vq_batch(rng, 8)) for _ in range(3)]
    s = wire.stack_batches(batches)
    assert s["cont"].shape == (3, 8, 5, 6) and s["cont"].is_contiguous()
    assert s["cat"].flags["OWNDATA"] and s["cat"].shape == (3, 8, 5, 2)
    assert s["cat_target"]["evt"].shape == (3, 8, 5)
    dev = make_device_put("cpu", ())(s)
    for i, b in enumerate(batches):
        assert torch.equal(dev["cont"][i].view(torch.int16),
                           b["cont"].view(torch.int16))
        np.testing.assert_array_equal(dev["cat"][i].numpy(), b["cat"])
    assert wire.wire_bytes(s) == sum(wire.wire_bytes(b) for b in batches)


def _datasets(cube, patch):
    root, paths, _ = cube
    kw = dict(split=None, patch_size=patch, split_block_size=(1, 1),
              min_aoi=0.0)
    return (JDataset(jparse(str(paths["evt"])), **kw),
            TDataset(tparse(str(paths["evt"])), **kw))


def test_channel_major_load_batch_equals_jax_and_decodes_to_bf16(cube):
    jd, td = _datasets(cube, 40)            # 96 = 40 + 40 + 16: ragged
    idx = [0, 2, len(td) - 1]
    assert td.patches[idx[-1]].height < 40
    plain = td.load_batch(idx)
    jd.set_wire_layout(True)
    td.set_wire_layout(True)
    got, want = td.load_batch(idx), jd.load_batch(idx)
    assert list(got) == list(want) and "annual__cm" in got
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    td.set_wire_layout(False)
    assert list(td.load_batch(idx)) == list(plain)
    skip = ("static_categorical",)
    dec = wire.decode_wire_batch(make_device_put("cpu", ())(
        wire.encode_wire_batch(got, skip=skip)), "cpu")
    assert sorted(dec) == sorted(plain)
    for k, v in plain.items():
        ref = (v if k in skip or k == "__window__"
               else wire.to_bfloat16(v).float().numpy())
        assert dec[k].is_contiguous() and dec[k].dtype == torch.float32 \
            or k == "__window__"
        assert dec[k].numpy().tobytes() == ref.tobytes(), k


def test_frl_epoch_with_the_wire_tracks_jax(cube, monkeypatch):
    root, paths, _ = cube
    bpath = str(paths["evt"])
    over = {"training": {"epoch": {"num_epochs": 1, "mode": "full",
                                   "batch_size": 4}}}
    jcfg = jtc.parse_training_config(
        training_dict(root, "jax_wire", "evt", **over))
    tcfg = ttc.parse_training_config(
        training_dict(root, "torch_wire", "evt", **over))
    start_from_seeded_state(jcfg)
    start_from_seeded_state(tcfg)
    monkeypatch.setattr(jloops, "run_epoch", functools.partial(
        jloops.run_epoch, wire_compact=True))
    j = jtr.train(jcfg, bpath, MODEL_CFG, max_batches=2)
    seen = []

    def spy(batch, device=None):
        seen.append(sorted(batch))
        return wire.decode_wire_batch(batch, device)

    monkeypatch.setattr(tts, "decode_wire_batch", spy)
    monkeypatch.setattr(tloops, "run_epoch", functools.partial(
        tloops.run_epoch, wire_compact=True))
    jax_draws(monkeypatch, bpath, tcfg.as_builder_dict())
    t = ttr.train(tcfg, bpath, MODEL_CFG, max_batches=2, device="cpu")
    (th,), (jh,) = t["history"], j["history"]
    assert th["train/n_steps"] == jh["train/n_steps"] == 2
    assert set(th) == set(jh)
    for k in sorted(jh):
        if not k.endswith(TIMINGS):
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert seen and all("annual__cm" in keys and "static__cm" in keys
                        for keys in seen)
    assert not t["ds_train"]._channel_major
    assert not t["ds_val"]._channel_major


def test_vqvae_step_on_a_wire_batch_tracks_the_plain_step():
    rng = np.random.default_rng(8)
    batch = make_batch(rng)
    w = {"cont": 1.0, "cat": 1.0, "canopy": 1.0, "vq": 1.0}
    bounds = {"cat": (-100, 9), "evt": (-100, 7), "bps": (-100, 5)}
    losses = {}
    for name, use_wire, ib in (("plain", False, None), ("wire", True, None),
                               ("narrow", True, bounds)):
        _, _, tm = build_pair(batch, seed=3)
        opt = tvstep.make_optimizer(1e-3)
        step = tvstep.make_train_step(tm, opt)
        db = ttv.host_to_device_batch(dict(batch), "cpu", use_wire, ib)
        _, m = step(tvstep.init_train_state(tm, opt), db, w)
        losses[name] = float(m["loss/total"])
        ev = tvstep.make_eval_step(tm)(db, w)
        assert np.isfinite(float(ev["loss/total"]))
    assert losses["wire"] == pytest.approx(losses["plain"], rel=2e-2)
    assert losses["narrow"] == losses["wire"]   # narrow ids are lossless
