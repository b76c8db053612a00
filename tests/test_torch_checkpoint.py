"""forest_tpu_torch's flax-msgpack checkpoint codec against flax itself.

Both directions, on a seeded tree shaped like a training state (nested
params, an int step, an optimizer sub-tree with numpy scalars, None, bools,
strings, floats, and arrays of several dtypes and ranks, one of them long
enough to need the 32-bit length forms): bytes written by the port are
restored by ``flax.serialization.msgpack_restore`` and vice versa, and the
files of the two ``save_state`` functions load in either package. Arrays
must come back bit-identical. Also the flax <-> torch parameter bridge.
"""
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.models import representation as jrep
from forest_tpu.training import checkpointing as jck
from forest_tpu_torch.models import representation as trep
from forest_tpu_torch.training import checkpointing as tck
from forest_tpu_torch.utils.flax_bridge import (params_from_flax,
                                                params_to_flax)


def _state(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(
                np.float32), "bias": np.zeros(8, np.float32)},
            "dense": {"kernel": rng.normal(size=(70000,)).astype(
                np.float32)},
            "ints": rng.integers(-5, 5, size=(2, 3)).astype(np.int32),
            "empty": np.zeros((0, 3), np.float32),
        },
        "step": 1234567,
        "neg": -70000,
        "lr": 0.25,
        "opt_state": {"0": {"count": np.int32(7), "mu": {
            "a": rng.normal(size=(5,)).astype(np.float64)}},
            "1": {}, "2": None},
        "flags": {"on": True, "off": False},
        "name": "x" * 40,
    }


def _assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_same(u, v)
    elif isinstance(a, (np.ndarray, np.generic)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_port_bytes_restore_in_flax():
    state = _state(0)
    _assert_same(state, flax.serialization.msgpack_restore(tck.packb(state)))


def test_flax_bytes_restore_in_port():
    state = _state(1)
    data = flax.serialization.msgpack_serialize(state)
    _assert_same(state, tck.unpackb(data))
    assert tck.packb(state) == data  # same encoding, byte for byte


def test_save_state_files_cross_load(tmp_path):
    state, meta = _state(2), {"model_config": {"version": "4"},
                              "type_in_channels": np.int64(4)}
    tck.save_state(tmp_path / "port.msgpack", state, meta)
    jck.save_state(tmp_path / "jax.msgpack", state, meta)
    for name in ("port.msgpack", "jax.msgpack"):
        raw_t, meta_t = tck.load_state_raw(tmp_path / name)
        raw_j, meta_j = jck.load_state_raw(tmp_path / name)
        _assert_same(state, raw_t)
        _assert_same(state, raw_j)
        assert meta_t == meta_j == {"model_config": {"version": "4"},
                                    "type_in_channels": 4}


def test_bfloat16_leaf_widens_exactly():
    x = jnp.asarray([1.5, -2.25, 3.0e-3], jnp.bfloat16)
    out = tck.unpackb(flax.serialization.msgpack_serialize({"w": x}))["w"]
    np.testing.assert_array_equal(out, np.asarray(x, np.float32))


def test_rejects_unsupported_ext():
    with pytest.raises(ValueError, match="ext type"):
        tck.unpackb(bytes([0xd4, 5, 0]))


def test_params_bridge_round_trip():
    jm = jrep.RepresentationModel(type_in_channels=4, phase_in_channels=3,
                                  z_type_dim=6, z_phase_dim=3,
                                  type_encoder_channels=(12, 6),
                                  phase_tcn_channels=(8, 8),
                                  phase_tcn_dilations=(1, 2))
    shapes = jax.eval_shape(lambda k: jrep.init_variables(jm, k),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    sd = params_from_flax(params)
    tm = trep.RepresentationModel(4, 3, z_type_dim=6, z_phase_dim=3,
                                  type_encoder_channels=(12, 6),
                                  phase_tcn_channels=(8, 8),
                                  phase_tcn_dilations=(1, 2))
    tm.load_state_dict(sd, strict=True)
    assert tm.spatial_conv.mix_backbone.weight.shape == (64, 12, 3, 3)
    assert torch.equal(tm.encoder.norm_0.weight,
                       torch.from_numpy(params["encoder"]["norm_0"]["scale"]))
    _assert_same(params, params_to_flax(tm.state_dict()))
