"""The port's frozen-encoder eval tools against the JAX package's, on the CPU.

``eval.frozen``'s closures, ``embed_locations`` and ``export_embeddings``
of ``forest_tpu_torch`` and ``forest_tpu`` on one tiny checkpoint (with and
without the type projection head) over a 96 x 96 synthetic cube
(``torch_parity.write_eval_fixture``), through the same bindings and stats.
float32 models: rtol / atol 1e-5, serving's bound (XLA's reordered sums on
the JAX side); the exported float16 arrays within one float16 rounding on
top of that.
The tools on the card are held to their runs on the CPU in
``tests/test_torch_eval_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.data import zarrlite as jzl
from forest_tpu.data.bindings import parse_bindings as jparse
from forest_tpu.data.feature_builder import FeatureBuilder as JFB
from forest_tpu.data.frl_dataset import ForestDatasetV2 as JDS
from forest_tpu.eval import embed_locations as jel
from forest_tpu.eval import export_embeddings as jee
from forest_tpu.eval import frozen as jfrozen
from forest_tpu_torch.data import parse_bindings as tparse
from forest_tpu_torch.data import zarrlite as tzl
from forest_tpu_torch.data.feature_builder import FeatureBuilder as TFB
from forest_tpu_torch.data.frl_dataset import ForestDatasetV2 as TDS
from forest_tpu_torch.eval import embed_locations as tel
from forest_tpu_torch.eval import export_embeddings as tee
from forest_tpu_torch.eval import frozen as tfrozen
from forest_tpu_torch.eval import phase_probe as tpp
from forest_tpu_torch.eval import train_probe as ttp
from torch_parity import (EVAL_PATCH, eval_locations, read_csv,
                          write_eval_fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
# one float16 rounding on top of the float32 models' 1e-5
F16 = dict(rtol=2.0 ** -10 + 1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_eval_fixture(tmp_path_factory.mktemp("torch_eval"))


def _both(files, ckpt):
    bp = str(files["bindings"])
    jfb, tfb = JFB(jparse(bp)), TFB(tparse(bp))
    jm, jp = jfrozen.load_frozen_model(files[ckpt])
    tm = tfrozen.load_frozen_model(files[ckpt], "cpu")
    return jfb, tfb, (jm, jp), tm


@pytest.mark.parametrize("ckpt", ["ckpt", "ckpt_proj"])
def test_encode_closures_match_jax(files, ckpt):
    """encode_type, encode_phase at shared coords, project,
    make_encode_phase_film and make_phase_target_fn (a temporal and a
    static target) on a batch of two patches, rtol / atol 1e-5."""
    jfb, tfb, (jm, jp), tm = _both(files, ckpt)
    host = JDS(jfb.bindings, split=None, patch_size=EVAL_PATCH).load_batch(
        [1, 4])
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = tfrozen.batch_to_device(host, "cpu")
    coords = np.random.default_rng(1).integers(0, EVAL_PATCH, (7, 2))
    jfns = jfrozen.make_encode_fns(jm, jp, jfb)
    tfns = tfrozen.make_encode_fns(tm, tfb)

    def check(got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert tuple(g.shape) == tuple(r.shape)
            np.testing.assert_allclose(g.float().numpy(), np.asarray(r),
                                       **TOL)

    zt = tfns[0](tb)
    check(zt, jfns[0](jb))
    assert zt.shape == (2, EVAL_PATCH, EVAL_PATCH, 8)
    check(tfns[1](tb, torch.as_tensor(coords)),
          jfns[1](jb, jnp.asarray(coords)))
    flat = zt.reshape(-1, 8)[:50]
    check(tfns[2](flat), jfns[2](jnp.asarray(flat.numpy())))
    assert tfns[2](flat).shape[-1] == (5 if ckpt == "ckpt_proj" else 8)
    check(tfrozen.make_encode_phase_film(tm, tfb)(tb, torch.as_tensor(
        coords)), jfrozen.make_encode_phase_film(jm, jp, jfb)(
        jb, jnp.asarray(coords)))
    for target in ("phase_target", "infonce_type_spectral"):
        got = tfrozen.make_phase_target_fn(tfb, target)(
            tb, torch.as_tensor(coords))
        ref = jfrozen.make_phase_target_fn(jfb, target)(
            jb, jnp.asarray(coords))
        check(got[0], ref[0])
        assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_embed_locations_cli_matches_jax(files, tmp_path, capsys):
    """Both CLIs on the same points with the projection model and the EVT
    column: the same columns in the same order (every family), the same
    ``valid: 0`` rows, values within rtol / atol 1e-5."""
    n = eval_locations(tmp_path / "pts.csv")
    argv = ["--locations", str(tmp_path / "pts.csv"), "--checkpoint",
            str(files["ckpt_proj"]), "--bindings", str(files["bindings"]),
            "--patch-size", str(EVAL_PATCH), "--split-block-size", "1", "1",
            "--evt-source", "static_categorical.evt"]
    jel.main(argv + ["--output", str(tmp_path / "j.csv")])
    tel.main(argv + ["--output", str(tmp_path / "t.csv"), "--device",
                     "cpu"])
    assert "14/17 points embedded" in capsys.readouterr().out
    jcols, jrows = read_csv(tmp_path / "j.csv")
    tcols, trows = read_csv(tmp_path / "t.csv")
    assert tcols == jcols and len(trows) == len(jrows) == n
    for fam in ("pixel_row", "split", "ysfc", "evt", "x_type_0",
                "x_phase_0", "z_type_7", "z_phase_2", "g_type_4"):
        assert fam in tcols, fam
    assert [r["valid"] for r in trows][-3:] == ["0", "0", "0"]
    for tr, jr in zip(trows, jrows):
        for k in jcols:
            if k in ("split", "valid", "index") or jr[k] == "":
                assert tr[k] == jr[k], k
            else:
                np.testing.assert_allclose(float(tr[k]), float(jr[k]),
                                           err_msg=k, **TOL)


def _read_zarr(zl, path):
    root = zl.open_zarr(path)
    return {k: np.asarray(root[k]).astype(np.float32)
            for k in ("z_type", "z_phase")}


def test_export_embeddings_cli_matches_jax(files, tmp_path):
    """Both CLIs with ``--phase`` over every patch (batches of 4, 4 and 1):
    z_type [96, 96, 8] and z_phase [15, 96, 96, 3] in float16, within one
    float16 rounding (2^-10 relative) of each other on top of the models'
    1e-5; an existing group is refused."""
    argv = ["--checkpoint", str(files["ckpt"]), "--bindings",
            str(files["bindings"]), "--patch-size", str(EVAL_PATCH),
            "--phase"]
    jee.main(argv + ["--out", str(tmp_path / "j.zarr")])
    tee.main(argv + ["--out", str(tmp_path / "t.zarr"), "--device", "cpu"])
    ref = _read_zarr(jzl, tmp_path / "j.zarr")
    got = _read_zarr(tzl, tmp_path / "t.zarr")
    assert tzl.open_zarr(tmp_path / "t.zarr")["z_phase"].dtype == np.float16
    assert got["z_type"].shape == (96, 96, 8)
    assert got["z_phase"].shape == (15, 96, 96, 3)
    for k in ref:
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **F16)
    with pytest.raises(FileExistsError):
        tee.main(argv + ["--out", str(tmp_path / "t.zarr"), "--device",
                         "cpu"])


MAINS = {"embed_locations": (tel.main, ["--locations", "x", "--output", "y"]),
         "export_embeddings": (tee.main, ["--out", "y"]),
         "train_probe": (ttp.main, []),
         "phase_probe": (tpp.main, [])}


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_cli_asked_for_cuda_without_a_card_raises(files, tool):
    """The default device is ``cuda``; without a card the CLI raises before
    it reads a patch (on a machine with a card this case does not apply)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    main, extra = MAINS[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--checkpoint", str(files["ckpt"]), "--bindings",
              str(files["bindings"])] + extra)
