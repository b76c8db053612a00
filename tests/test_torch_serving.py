"""forest_tpu_torch.serving against forest_tpu.serving, end to end.

One checkpoint is written by the JAX package's ``save_state`` from a tiny
flax RepresentationModel with seeded parameters, with the metadata serving
reads (``model_config``, ``type_in_channels``, ``phase_in_channels``) and a
stats JSON from ``synthetic_feature_stats``. Both ``EncoderService``s serve
it; the port runs on the CPU, where its bank + mixing op is the plain
version. ``z_type`` and ``z_phase`` must agree to rtol 1e-5 / atol 1e-5:
float32 throughout, with XLA's fused, reordered sums (whitening, GroupNorm
via E[x^2] - E[x]^2, convs) on the JAX side.
"""
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import yaml

from forest_tpu import serving as jserving
from forest_tpu.data.bindings import parse_bindings
from forest_tpu.data.cube_v2 import (build_synthetic_v2_cube,
                                     synthetic_bindings,
                                     synthetic_feature_stats,
                                     synthetic_frl_batch)
from forest_tpu.models import representation as jrep
from forest_tpu.training.checkpointing import save_state
from forest_tpu_torch import serving as tserving

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = {"version": "4", "model": {
    "z_type_dim": 6, "z_phase_dim": 3,
    "type_encoder": {"channels": [12, 6], "num_groups": 4},
    "spatial_conv": {"gate_hidden": 8},
    "phase_tcn": {"channels": [8, 8], "dilations": [1, 2],
                  "num_groups": 4}}}


@pytest.fixture(scope="module")
def served_files(tmp_path_factory):
    """-> (checkpoint, bindings YAML) of a tiny seeded flax encoder, with a
    32 x 32 synthetic cube behind the bindings."""
    root = tmp_path_factory.mktemp("torch_serve")
    build_synthetic_v2_cube(root / "cube.zarr", height=32, width=32)
    raw = synthetic_bindings(root / "cube.zarr", root / "stats.json")
    (root / "stats.json").write_text(json.dumps(
        synthetic_feature_stats(parse_bindings(raw))))
    bpath = root / "bindings.yaml"
    bpath.write_text(yaml.safe_dump(raw))

    jm = jrep.from_config(CFG, 4, 3)
    shapes = jax.eval_shape(lambda k: jrep.init_variables(jm, k),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(scale=0.3, size=s.shape).astype(np.float32),
        shapes)
    ckpt = root / "encoder.msgpack"
    save_state(ckpt, {"params": params, "step": 3},
               {"model_config": CFG, "type_in_channels": 4,
                "phase_in_channels": 3})
    return ckpt, bpath


@pytest.fixture(scope="module")
def services(served_files):
    ckpt, bpath = served_files
    jsvc = jserving.EncoderService(ckpt, bpath, max_batch=2)
    tsvc = tserving.EncoderService(ckpt, bpath, device="cpu", max_batch=2)
    yield jsvc, tsvc
    jsvc.close()
    tsvc.close()


def _patch(seed, hw=16):
    batch = synthetic_frl_batch(np.random.default_rng(seed), b=1, hw=hw, t=5)
    batch["static"][0, 2, 3, 1] = np.nan
    return {k: v[0] for k, v in batch.items()}


def test_z_type_and_z_phase_match_jax(services):
    jsvc, tsvc = services
    patch = _patch(1)
    ref = jsvc.encode(patch, phase=True)
    out = tsvc.encode(patch, phase=True)
    assert set(out) == {"z_type", "z_phase"}
    assert out["z_type"].shape == (16, 16, 6)
    assert out["z_phase"].shape == (5, 16, 16, 3)
    np.testing.assert_allclose(out["z_type"], ref["z_type"], **TOL)
    np.testing.assert_allclose(out["z_phase"], ref["z_phase"], **TOL)
    only_type = tsvc.encode(patch)
    assert set(only_type) == {"z_type"}
    np.testing.assert_allclose(only_type["z_type"], out["z_type"],
                               rtol=1e-6, atol=1e-6)


def test_concurrent_mixed_batches_match_jax(services):
    jsvc, tsvc = services
    patches = [_patch(10 + i, hw=16 if i % 3 else 12) for i in range(5)]
    results = {}

    def call(i):
        results[i] = tsvc.encode(patches[i], phase=bool(i % 2))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60.0)
    assert not any(th.is_alive() for th in threads)
    for i, p in enumerate(patches):
        ref = jsvc.encode(p, phase=bool(i % 2))
        assert set(results[i]) == set(ref)
        for k in ref:
            np.testing.assert_allclose(results[i][k], ref[k], **TOL)


def test_bad_request_fails_alone(services):
    _, tsvc = services
    good = _patch(2)
    bad = {"static": good["static"]}
    out = tsvc._run_batch([(good, False), (bad, False)])
    assert out[0]["z_type"].shape == (16, 16, 6)
    assert isinstance(out[1], tserving.Failure)


def test_http_round_trip(services):
    _, tsvc = services
    srv = tserving.make_server(tsvc, "127.0.0.1", 0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        patch = _patch(3)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/encode?phase=1",
            data=tserving.pack_npz(patch), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = tserving.unpack_npz(resp.read())
        direct = tsvc.encode(patch, phase=True)
        for k in ("z_type", "z_phase"):
            np.testing.assert_allclose(out[k], direct[k], rtol=1e-6,
                                       atol=1e-6)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        assert health["z_type_dim"] == 6 and health["z_phase_dim"] == 3
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/v1/encode",
                                     data=b"not-npz", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=10)
        assert ei.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10.0)


def test_cli_warms_up_from_the_cube(served_files, monkeypatch, capsys):
    """``main`` builds the service on the asked device, encodes one cube
    patch with and without z_phase before listening, and closes the server
    and the service when serving stops."""
    ckpt, bpath = served_files
    seen = {}

    class StubServer:
        def __init__(self, service, host, port):
            seen.update(service=service, host=host, port=port)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            seen["closed"] = True

    monkeypatch.setattr(tserving, "make_server", StubServer)
    tserving.main(["--checkpoint", str(ckpt), "--bindings", str(bpath),
                   "--device", "cpu", "--port", "0", "--max-batch", "2",
                   "--warm-patch-size", "16"])
    svc = seen["service"]
    assert svc.device.type == "cpu" and seen["closed"]
    assert (svc.batches_run, svc.requests_served) == (2, 2)
    assert "warm: ran both signatures at 16px / B=2" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="closed"):
        svc.encode({})


def test_port_imports_no_jax():
    code = ("import sys; import forest_tpu_torch.serving, "
            "forest_tpu_torch.eval.frozen, forest_tpu_torch.models."
            "representation, forest_tpu_torch.data, "
            "forest_tpu_torch.ops.smoothing; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
