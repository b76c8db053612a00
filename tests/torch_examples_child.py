"""JAX example runs for ``tests/test_torch_examples.py``, in processes of
their own (the JAX examples compile op by op on the CPU; the test starts
the processes at once and runs the port's examples meanwhile).

    python tests/torch_examples_child.py '[["LABEL", "SCRIPT", ARGS...], ...]'
    python tests/torch_examples_child.py --encoders OUT.pkl

The first form runs each ``examples/SCRIPT`` in turn through ``runpy`` with
``sys.argv`` set, as ``tests/test_examples_smoke.py`` does; its lines go to
stdout after a line ``### LABEL``. The second runs ``example_encoders.py``
the same way and then, in the same process, the same blocks on the same
inputs with the same ``jax.random`` keys, and pickles their parameters
(numpy trees) and outputs to OUT.pkl.
"""
import json
import pickle
import runpy
import sys
from pathlib import Path

import numpy as np

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def run_example(script: str, args) -> None:
    sys.argv = [script, *args]
    runpy.run_path(str(EXAMPLES / script), run_name="__main__")


def encoder_blocks() -> dict:
    """The blocks of ``example_encoders.main`` at its inputs and keys:
    {"params": {block: tree}, "outputs": {name: array}}."""
    import jax
    import jax.numpy as jnp

    from forest_tpu.models import representation as rep
    from forest_tpu.models.conditioning import FiLMLayer
    from forest_tpu.models.conv2d_encoder import Conv2DEncoder
    from forest_tpu.models.spatial import EdgeAwareSmoothingConv2D
    from forest_tpu.models.tcn import TCNEncoder
    from forest_tpu.models.vqvae import VQVAE

    rng = np.random.default_rng(0)
    key = jax.random.key(0)
    params, outs = {}, {}
    x = jnp.asarray(rng.normal(size=(2, 32, 32, 10)), jnp.float32)
    enc = Conv2DEncoder(channels=(32, 16))
    params["conv2d"] = enc.init(key, x)["params"]
    h = enc.apply({"params": params["conv2d"]}, x)
    sm = EdgeAwareSmoothingConv2D(channels=16)
    params["smoothing"] = sm.init(key, h)["params"]
    smoothed, gate = sm.apply({"params": params["smoothing"]}, h,
                              return_gate=True)
    tcn = TCNEncoder(channels=(24, 24), dilations=(1, 2), pooling="stats")
    ts = jnp.asarray(rng.normal(size=(5, 15, 3)), jnp.float32)
    params["tcn"] = tcn.init(key, ts)["params"]
    pooled = tcn.apply({"params": params["tcn"]}, ts)
    film = FiLMLayer(target_dim=8)
    cond = jnp.asarray(rng.normal(size=(5, 16)), jnp.float32)
    params["film"] = film.init(key, cond)["params"]
    gamma, beta = film.apply({"params": params["film"]}, cond)
    model = rep.RepresentationModel(
        type_in_channels=10, phase_in_channels=3, z_type_dim=16,
        type_encoder_channels=(32, 16), z_phase_dim=4,
        phase_tcn_channels=(16, 16), phase_tcn_dilations=(1, 2))
    params["representation"] = rep.init_variables(
        model, key, num_timesteps=15)["params"]
    z = model.apply({"params": params["representation"]}, x)
    px = jnp.asarray(rng.normal(size=(7, 15, 3)), jnp.float32)
    zt = jnp.asarray(rng.normal(size=(7, 16)), jnp.float32)
    zp = model.apply({"params": params["representation"]}, px, zt,
                     method=model.forward_phase_at_locations)
    batch = {
        "cont": jnp.asarray(rng.normal(size=(4, 5, 6)), jnp.float32),
        "cat": jnp.asarray(rng.integers(0, 9, (4, 5, 1)), jnp.int32),
        "cat_target": {"evt": jnp.asarray(rng.integers(0, 9, (4, 5)),
                                          jnp.int32)},
        "naip": jnp.asarray(rng.normal(size=(4, 3, 3, 2)), jnp.float32),
        "canopy": jnp.zeros((4,), jnp.float32),
    }
    vq = VQVAE(cont_dim=6, cat_vocab_sizes={"evt": 9}, naip_bands=2,
               num_timesteps=5, emb_dim=16, codebook_size=8, hidden=16)
    params["vqvae"] = vq.init(key, batch, use_pallas=False)["params"]
    out = vq.apply({"params": params["vqvae"]}, batch, use_pallas=False)
    outs.update(h=h, smoothed=smoothed, gate=gate, pooled=pooled,
                gamma=gamma, beta=beta, z_type=z, z_phase=zp,
                vq_indices=out.indices, vq_z_e=out.z_e)
    n_params = sum(int(np.prod(p.shape)) for p in
                   jax.tree_util.tree_leaves(params["representation"]))
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "outputs": {k: np.asarray(v) for k, v in outs.items()},
            "n_params": n_params}


if __name__ == "__main__":
    if sys.argv[1] == "--encoders":
        out_path = Path(sys.argv[2])
        run_example("example_encoders.py", [])
        sys.stdout.flush()
        out_path.write_bytes(pickle.dumps(encoder_blocks()))
    else:
        for label, script, *args in json.loads(sys.argv[1]):
            print(f"### {label}", flush=True)
            run_example(script, args)
