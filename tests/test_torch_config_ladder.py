"""The VQ-VAE config ladder through the port's trainer, held to the JAX
trainer: ``configs/vae_evt_only.yaml`` (no continuous channels, no NAIP
bands), ``vae_static_only.yaml`` (T = 1, no categorical loss) and
``vae_full.yaml`` (56 continuous, 4 categorical, 4 NAIP bands), each on
the 64 x 64 synthetic cube and at the sizes of ``tests/test_config_ladder.py``.

Both trainers run one epoch of 4 steps and one validation step on the same
cube, on one device (``data_parallel: false``: the tests' JAX sees eight
virtual CPU devices, and its trainer would otherwise split every batch into
eight replicas), from the same initial parameters (the JAX trainer's,
captured as it initialises and loaded into the port's model) and the same
batches (the samplers are the same). Every history value but the timings
agrees within rtol 1e-5 (atol 1e-6), and the final parameters within 1e-5.
"""
import jax
import numpy as np
import pytest

from forest_tpu.data.cube import build_synthetic_cube
from forest_tpu.training import train_vqvae as jtv
from forest_tpu_torch.training import train_vqvae as ttv
from forest_tpu_torch.utils import flax_bridge
from test_config_ladder import CONFIG_DIR

RUNGS = {
    "vae_evt_only.yaml": (dict(n_cont=0, n_cat=2, n_naip=0),
                          dict(lambda_cont=0.0, lambda_canopy=0.0)),
    "vae_static_only.yaml": (dict(years=(2021,), n_cont=6, n_cat=0,
                                  n_naip=3), dict(lambda_cat=0.0)),
    "vae_full.yaml": (dict(n_cont=56, n_cat=4, n_naip=4), {}),
}
TIMINGS = ("epoch_time_s", "wait_s", "step_s", "steps_per_s")


def config(module, name, tmp_path, run, overrides):
    cfg = module.load_config(str(CONFIG_DIR / name), {})
    cfg.update(zarr=str(tmp_path / "cube.zarr"), run_dir=str(tmp_path / run),
               epochs=1, steps_per_epoch=4, batch_size=32, num_workers=2,
               block_size=(1, 1), min_hits_per_epoch=1, val_steps=1,
               emb_dim=16, hidden=16, codebook_size=8, eager=True,
               data_parallel=False, **overrides)
    return cfg


@pytest.mark.parametrize("name", sorted(RUNGS))
def test_rung_trains_in_the_port_as_in_jax(name, tmp_path, monkeypatch):
    cube_kw, overrides = RUNGS[name]
    build_synthetic_cube(tmp_path / "cube.zarr", height=64, width=64,
                         chunk_yx=32, patch_size=32, seed=0, **cube_kw)
    init = {}
    jax_init = jtv.vqvae_step.init_train_state

    def capture(*args, **kw):
        state = jax_init(*args, **kw)
        init["params"] = jax.tree_util.tree_map(np.asarray, state.params)
        return state

    monkeypatch.setattr(jtv.vqvae_step, "init_train_state", capture)
    j = jtv.train(config(jtv, name, tmp_path, "jax", overrides))

    def load_jax_init(model, generator):
        model.load_state_dict(flax_bridge.params_from_flax(init["params"]),
                              strict=True)

    monkeypatch.setattr(ttv, "init_parameters", load_jax_init)
    t = ttv.train(config(ttv, name, tmp_path, "torch",
                         dict(overrides, device="cpu")))

    (th,), (jh,) = t["history"], j["history"]
    assert set(th) == set(jh)
    for k in sorted(jh):
        if not k.endswith(TIMINGS):
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert np.isfinite(th["train/loss_total"])
    got = flax_bridge.params_from_flax(t["state"].params)
    for n, v in flax_bridge.params_from_flax(
            jax.tree_util.tree_map(np.asarray, j["state"].params)).items():
        np.testing.assert_allclose(got[n].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(v.abs().max()),
                                   err_msg=n)
    ds = t["dataset"]
    if name == "vae_evt_only.yaml":
        assert not ds.cont_names and th["train/loss_cat"] > 0
        assert ds.naip.shape[-1] == 0
    elif name == "vae_static_only.yaml":
        assert not ds.cat_names and th["train/loss_cont"] > 0
        assert len(ds.ds["years"]) == 1
    else:
        assert (len(ds.cont_names), len(ds.cat_names)) == (56, 4)
