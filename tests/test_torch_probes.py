"""The port's probe algebra against the JAX package's, on the CPU.

Heads, transform inverses, the warm-up cosine schedule, ``StreamingRidge``,
the closed-form and SGD linear probes, ``train_probe`` and ``phase_probe``
of ``forest_tpu_torch`` and ``forest_tpu`` on the same inputs: numpy arrays
made from a seed, and one tiny checkpoint over a 96 x 96 synthetic cube
(``torch_parity.write_eval_fixture``). The tolerances are stated at each
test; float32 throughout unless a test says float64, with XLA's reordered
sums on the JAX side.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from forest_tpu.data import transforms as jtf
from forest_tpu.data.bindings import parse_bindings as jparse
from forest_tpu.data.feature_builder import FeatureBuilder as JFB
from forest_tpu.data.frl_dataset import ForestDatasetV2 as JDS
from forest_tpu.eval import frozen as jfrozen
from forest_tpu.eval import linear_probe as jlp
from forest_tpu.eval import phase_probe as jpp
from forest_tpu.eval import train_probe as jtp
from forest_tpu.models import heads as jheads
from forest_tpu.models import representation as jrep
from forest_tpu_torch.data import parse_bindings as tparse
from forest_tpu_torch.data import transforms as ttf
from forest_tpu_torch.data.feature_builder import FeatureBuilder as TFB
from forest_tpu_torch.data.frl_dataset import ForestDatasetV2 as TDS
from forest_tpu_torch.eval import frozen as tfrozen
from forest_tpu_torch.eval import linear_probe as tlp
from forest_tpu_torch.eval import phase_probe as tpp
from forest_tpu_torch.eval import train_probe as ttp
from forest_tpu_torch.models import heads as theads
from forest_tpu_torch.models import representation as trep
from forest_tpu_torch.training.checkpointing import save_state
from forest_tpu_torch.training.scheduler import warmup_cosine_decay_schedule
from forest_tpu_torch.utils.flax_bridge import params_from_flax, params_to_flax
from torch_parity import EVAL_CFG_PROJ, EVAL_PATCH, flax_params, t
from torch_parity import write_eval_fixture

SPLIT = dict(patch_size=EVAL_PATCH, split_block_size=(1, 1))


# --- heads and the projection ---------------------------------------------

HEADS = {
    "mlp": (lambda: jheads.MLPHead((7, 5), 3),
            lambda: theads.MLPHead(6, (7, 5), 3), (9, 6)),
    "linear": (lambda: jheads.LinearHead(3),
               lambda: theads.LinearHead(6, 3), (9, 6)),
    "conv2d": (lambda: jheads.Conv2DHead(3, hidden_dim=5, kernel_size=3),
               lambda: theads.Conv2DHead(6, 3, 5, 3), (2, 7, 8, 6)),
    "conv2d_even_kernel": (lambda: jheads.Conv2DHead(3, kernel_size=2),
                           lambda: theads.Conv2DHead(6, 3, None, 2),
                           (2, 7, 8, 6)),
    "projection": (lambda: jheads.MLPProjectionHead(10, 5),
                   lambda: theads.MLPProjectionHead(6, 10, 5), (9, 6)),
}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_flax(name):
    """Each head on the same flax parameters, rtol / atol 1e-6."""
    jmake, tmake, shape = HEADS[name]
    jm = jmake()
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    params = flax_params(jm.init, 2, jnp.zeros(shape))
    tm = tmake()
    tm.load_state_dict(params_from_flax(params), strict=True)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_projection_head_crosses_the_bridge_both_ways(tmp_path):
    """flax -> port -> flax gives the flax tree back bit for bit; a
    checkpoint the port writes loads in the JAX package, ``project_type``
    within rtol / atol 1e-5."""
    jm = jrep.from_config(EVAL_CFG_PROJ, 4, 3)
    params = flax_params(lambda k: jrep.init_variables(jm, k), 5)
    tm = trep.from_config(EVAL_CFG_PROJ, 4, 3)
    tm.load_state_dict(params_from_flax(params), strict=True)
    back = params_to_flax(tm.state_dict())
    assert set(back["type_projection"]) == {"fc1", "norm", "fc2"}
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(flat_t[path], np.asarray(v))

    trep.init_parameters(tm, torch.Generator().manual_seed(6))
    ckpt = tmp_path / "port.msgpack"
    save_state(ckpt, {"params": params_to_flax(tm.state_dict())},
               {"model_config": trep.model_config_dict(tm),
                "type_in_channels": 4, "phase_in_channels": 3})
    jm2, jp2 = jfrozen.load_frozen_model(ckpt)
    z = np.random.default_rng(7).normal(size=(13, 8)).astype(np.float32)
    ref = jm2.apply({"params": jp2}, jnp.asarray(z), method=jm2.project_type)
    with torch.no_grad():
        got = tm.project_type(t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# --- transforms and the schedule ------------------------------------------

SPECS = [None, "none", "identity", "log1p", "log10", "sqrt", "cbrt", "neg",
         {"name": "log"}, {"name": "log", "epsilon": 1e-3}]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_transform_inverse_matches_jax(spec):
    """forward, inverse and both round trips on numpy (float64) and on
    tensors against the JAX package's on numpy, rtol 1e-6 (atol 1e-12)."""
    x = np.random.default_rng(8).uniform(0.05, 6.0, 64)
    y = np.random.default_rng(9).uniform(-1.0, 1.5, 64)
    jt, tt = jtf.get_transform(spec), ttf.get_transform(spec)
    tol = dict(rtol=1e-6, atol=1e-12)
    for arr in (lambda a: a, torch.from_numpy):
        fwd, inv = tt.forward(arr(x)), tt.inverse(arr(y))
        np.testing.assert_allclose(np.asarray(fwd), jt.forward(x), **tol)
        np.testing.assert_allclose(np.asarray(inv), jt.inverse(y), **tol)
        np.testing.assert_allclose(np.asarray(tt.inverse(fwd)), x, **tol)
        np.testing.assert_allclose(np.asarray(tt.forward(inv)),
                                   jt.forward(jt.inverse(y)), **tol)
        assert np.array_equal(np.asarray(tt.domain_check(arr(y))),
                              jt.domain_check(y))


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (1, 2),
                                          (6, 41)])
def test_warmup_cosine_matches_optax(warmup, total):
    """train_probe's schedule at every step (warm-up 0 clamped to 1, as the
    probe calls it), atol 1e-7 at a peak of 5e-2 (optax in float32)."""
    args = (0.0, 5e-2, max(warmup, 1), max(total, 2))
    ref = optax.warmup_cosine_decay_schedule(*args)
    got = warmup_cosine_decay_schedule(*args)
    for step in range(total + 3):
        assert abs(got(step) - float(ref(step))) <= 1e-7, step


# --- StreamingRidge, the closed-form and SGD probes ------------------------

@pytest.mark.parametrize("f64", [False, True])
def test_streaming_ridge_matches_jax(f64):
    """X^T X and X^T Y within 1e-6 (float32 blocks) or 1e-12 (float64
    blocks) of max |entry|, rows counted alike, the solve within 1e-5 or
    1e-10 of max |W|; one update with NaN targets and the default mask, one
    with a given mask."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 300, 7)).astype(np.float32)
    y = rng.normal(size=(2, 300, 3)).astype(np.float32)
    y[0, ::17, 1] = np.nan
    valid = rng.random(300) > 0.3
    jr = jlp.StreamingRidge(7, 3, f64_blocks=f64)
    tr = tlp.StreamingRidge(7, 3, f64_blocks=f64)
    for r, conv in ((jr, jnp.asarray), (tr, torch.from_numpy)):
        r.update(conv(x[0]), conv(y[0]))
        r.update(conv(x[1]), conv(y[1]), conv(valid))
    tol = 1e-12 if f64 else 1e-6
    for a, b in ((tr.xtx, jr.xtx), (tr.xty, jr.xty)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())
    assert tr.n == jr.n
    wj, wt = jr.solve(1e-3), tr.solve(1e-3)
    np.testing.assert_allclose(wt, wj, rtol=0,
                               atol=(1e-10 if f64 else 1e-5)
                               * np.abs(wj).max())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_eval_fixture(tmp_path_factory.mktemp("torch_probes"))


@pytest.fixture(scope="module")
def env(files):
    """Both packages' bindings, features, datasets and encode closures."""
    bp = str(files["bindings"])
    jb, tb = jparse(bp), tparse(bp)
    jfb, tfb = JFB(jb), TFB(tb)
    jm, jp = jfrozen.load_frozen_model(files["ckpt"])
    tm = tfrozen.load_frozen_model(files["ckpt"], "cpu")
    return {"jb": jb, "tb": tb, "jfb": jfb, "tfb": tfb,
            "jfns": jfrozen.make_encode_fns(jm, jp, jfb),
            "tfns": tfrozen.make_encode_fns(tm, tfb),
            "jds": {s: JDS(jb, split=s, **SPLIT) for s in ("train", "val")},
            "tds": {s: TDS(tb, split=s, **SPLIT) for s in ("train", "val")}}


def test_fit_linear_probe_matches_jax(env):
    """Per-metric R^2 within 1e-5, MSE within 1e-5 relative, the same
    pixels counted."""
    kw = dict(target_feature="infonce_type_spectral", batch_size=4)
    ref = jlp.fit_linear_probe(env["jfns"][0], env["jfb"],
                               env["jds"]["train"], env["jds"]["val"], **kw)
    got = tlp.fit_linear_probe(env["tfns"][0], env["tfb"],
                               env["tds"]["train"], env["tds"]["val"],
                               device="cpu", **kw)
    assert got["n_train_pixels"] == ref["n_train_pixels"] > 0
    for k in ("r2_train", "r2_val"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5)
    for k in ("mse_train", "mse_val"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)


def _phase_fns(fns, frozen, fb, target):
    enc_t, enc_p, _ = fns
    targets = frozen.make_phase_target_fn(fb, target)

    def enc_phase(batch, coords):
        ta, tm = targets(batch, coords)
        return enc_p(batch, coords), ta, tm

    return enc_t, enc_phase


def test_fit_phase_linear_probe_matches_jax(env):
    """[z_type, z_phase, outer] at strided anchors against the temporal
    ``phase_target``: R^2 within 1e-5, the same rows counted."""
    kw = dict(target_feature="phase_target", anchor_stride=4, batch_size=2)
    ref = jlp.fit_phase_linear_probe(
        *_phase_fns(env["jfns"], jfrozen, env["jfb"], "phase_target"),
        env["jfb"], env["jds"]["train"], env["jds"]["val"], **kw)
    got = tlp.fit_phase_linear_probe(
        *_phase_fns(env["tfns"], tfrozen, env["tfb"], "phase_target"),
        env["tfb"], env["tds"]["train"], env["tds"]["val"], device="cpu",
        **kw)
    assert got["n_train_pixels"] == ref["n_train_pixels"] > 0
    for k in ("r2_train", "r2_val"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5)


def test_train_linear_probe_matches_jax_with_its_draws():
    """The SGD probe fed the minibatch rows ``jax.random.randint`` drew for
    the JAX run: W within 1e-5 (atol) after 40 AdamW steps."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(500, 6)).astype(np.float32)
    y = (x @ rng.normal(size=(6, 2)) + 0.1).astype(np.float32)
    valid = rng.random(500) > 0.2
    kw = dict(lr=1e-2, steps=40, weight_decay=1e-4, batch_size=64, seed=3)
    ref = jlp.train_linear_probe(x, y, valid, **kw)
    key, idx = jax.random.key(3), []
    for _ in range(40):
        key, sub = jax.random.split(key)
        idx.append(np.asarray(jax.random.randint(sub, (64,), 0, 500)))
    got = tlp.train_linear_probe(x, y, valid, indices=np.stack(idx),
                                 device="cpu", **kw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # without injected indices: the port's own draws, the same shape
    assert tlp.train_linear_probe(x, y, valid, device="cpu",
                                  **kw).shape == (7, 2)


# --- train_probe ------------------------------------------------------------

@pytest.mark.parametrize("target,masks", [
    ("infonce_type_spectral", ()),
    ("ysfc", ("static_mask.forest",))], ids=["static", "temporal_masked"])
def test_train_probe_pipeline_matches_jax(env, tmp_path, target, masks):
    """Two epochs of both pipelines: every history value within rtol 1e-4
    (atol 1e-6), the parameters within 1e-4 of max |p|, the same npz keys
    and values (rtol 1e-4) and the same JSON layout."""
    kw = dict(target_feature=target, epochs=2, lr=5e-2, batch_size=2,
              mask_channels=masks, echo=lambda *_: None)
    jds = {s: JDS(env["jb"], split=s, **SPLIT) for s in ("train", "val")}
    tds = {s: TDS(env["tb"], split=s, **SPLIT) for s in ("train", "val")}
    ref = jtp.train_probe_pipeline(env["jfns"][0], env["jfb"], jds["train"],
                                   jds["val"], out_dir=tmp_path / "j", **kw)
    got = ttp.train_probe_pipeline(env["tfns"][0], env["tfb"], tds["train"],
                                   tds["val"], out_dir=tmp_path / "t",
                                   device="cpu", **kw)
    assert got["names"] == ref["names"]
    assert got["best_epoch"] == ref["best_epoch"]
    assert len(got["history"]) == len(ref["history"]) == 2
    for hg, hr in zip(got["history"], ref["history"]):
        assert hg.keys() == hr.keys()
        for k in hr:
            np.testing.assert_allclose(hg[k], hr[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for k in ("w", "b"):
        ref_p = np.asarray(ref["params"][k])
        np.testing.assert_allclose(got["params"][k], ref_p, rtol=0,
                                   atol=1e-4 * np.abs(ref_p).max())
    for name in ("probe_best.npz", "probe_final.npz"):
        a, b = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if b[k].dtype.kind in "US":
                assert (a[k] == b[k]).all()
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                           atol=1e-4 * np.abs(b[k]).max())
    ja = json.loads((tmp_path / "j" / "probe_history.json").read_text())
    ta = json.loads((tmp_path / "t" / "probe_history.json").read_text())
    assert ta.keys() == ja.keys() and ta["final"].keys() == ja["final"].keys()
    assert ta["target_metrics"] == ja["target_metrics"]


def test_train_probe_cli_on_the_cpu(files, tmp_path):
    out = tmp_path / "probe"
    res = ttp.main(["--checkpoint", str(files["ckpt"]), "--bindings",
                    str(files["bindings"]), "--target-feature",
                    "infonce_type_spectral", "--patch-size", "32",
                    "--split-block-size", "1", "1", "--epochs", "1",
                    "--output-dir", str(out), "--device", "cpu"])
    assert np.isfinite(res["best_val_r2"])
    for f in ("probe_best.npz", "probe_final.npz", "probe_history.json"):
        assert (out / f).is_file()


# --- phase_probe ------------------------------------------------------------

@pytest.fixture(scope="module")
def phase_env(env):
    keep = set(env["jb"].groups_for_features(
        ["type_encoder_input", "phase_ccdc", "phase_target"])) | \
        {"static_mask"}
    common = dict(anchor_stride=4, halo=4, batch_size=2, keep_groups=keep)
    j = dict(common, mask_fn=jpp.make_probe_mask_fn(env["jfb"]))
    tt = dict(common, mask_fn=tpp.make_probe_mask_fn(env["tfb"]),
              device="cpu")
    return {"j": j, "t": tt,
            "jfns": _phase_fns(env["jfns"], jfrozen, env["jfb"],
                               "phase_target"),
            "tfns": _phase_fns(env["tfns"], tfrozen, env["tfb"],
                               "phase_target")}


def _leaves(m, prefix=""):
    if isinstance(m, dict):
        for k, v in m.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(m, (int, float, np.floating, np.integer)):
        yield prefix, float(m)


@pytest.mark.parametrize("design,pca_k", [
    ("full", 20), ("full", 0), ("additive", 20), ("type-only", 20),
    ("phase-only", 20)])
def test_phase_probe_matches_jax(env, phase_env, design, pca_k):
    """Fit on train, evaluate on val: the column means and scales within
    1e-5 relative, the PCA components equal up to sign (1e-4), predictions
    on the val rows within 1e-5 of max |prediction|, every metric of the
    report within 1e-4 (NaN where JAX has NaN)."""
    fit = dict(design=design, interaction_pca_k=pca_k)
    wj, pj = jpp.fit_phase_probe(*phase_env["jfns"], env["jds"]["train"],
                                 **fit, **phase_env["j"])
    wt, pt = tpp.fit_phase_probe(*phase_env["tfns"], env["tds"]["train"],
                                 **fit, **phase_env["t"])
    assert wt.shape == wj.shape == (pj.output_dim + 1, 2)
    np.testing.assert_allclose(pt.mean, pj.mean, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pt.std, pj.std, rtol=1e-5)
    assert (pt.pca_components is None) == (pj.pca_components is None) == \
        (design != "full" or pca_k == 0)
    if pj.pca_components is not None:
        sign = np.sign((pt.pca_components * pj.pca_components).sum(0))
        np.testing.assert_allclose(pt.pca_components * sign,
                                   pj.pca_components, rtol=0, atol=1e-4)
    # predictions of both probes on the same val rows
    blocks = list(tpp.iter_phase_blocks(
        *phase_env["tfns"], env["tds"]["val"], max_batches=None,
        **{k: v for k, v in phase_env["t"].items()}))
    for zt, zp, _, valid in blocks:
        x_raw, m = tpp._flat_design(zt, zp, valid, design)
        x_np = x_raw.numpy()[m.numpy()]
        pred_j = pj.transform(x_np) @ wj[:-1] + wj[-1]
        pred_t = (pt.transform(x_raw) @ torch.from_numpy(wt[:-1])
                  + torch.from_numpy(wt[-1])).numpy()[m.numpy()]
        np.testing.assert_allclose(pred_t, pred_j, rtol=0,
                                   atol=1e-5 * np.abs(pred_j).max())
    mj = jpp.evaluate_phase_probe(*phase_env["jfns"], env["jds"]["val"], wj,
                                  pj, env["jfb"], "phase_target",
                                  **phase_env["j"])
    mt = tpp.evaluate_phase_probe(*phase_env["tfns"], env["tds"]["val"], wt,
                                  pt, env["tfb"], "phase_target",
                                  **phase_env["t"])
    assert mt["channels"] == mj["channels"]
    assert mt["n_observations"] == mj["n_observations"] > 0
    assert mt["n_pixels"] == mj["n_pixels"]
    lj, lt = dict(_leaves(mj)), dict(_leaves(mt))
    assert lt.keys() == lj.keys()
    for k, v in lj.items():
        if np.isnan(v):
            assert np.isnan(lt[k]), k
        else:
            assert abs(lt[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, lt[k], v)
    assert tpp.format_phase_probe_report(mt, "val").splitlines()[0] == \
        jpp.format_phase_probe_report(mj, "val").splitlines()[0]


@pytest.mark.parametrize("feature", ["phase_target", "phase_ccdc"])
def test_inverse_normalization_matches_jax(env, feature):
    """Un-whiten, undo the affine, invert the transform: float64 numpy and
    tensors against the JAX package's on numpy, rtol 1e-10."""
    y = np.random.default_rng(12).normal(size=(50, 2 if feature ==
                                               "phase_target" else 3))
    ref = jpp.inverse_normalization_fn(env["jfb"], feature)(y)
    inv = tpp.inverse_normalization_fn(env["tfb"], feature)
    np.testing.assert_allclose(inv(y), ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(inv(torch.from_numpy(y)).numpy(), ref,
                               rtol=1e-10, atol=1e-12)


def test_phase_probe_cli_on_the_cpu(files, tmp_path, capsys):
    """``main`` with its defaults but the tiny geometry: the bindings'
    neighbourhood target is probed, the report printed, the JSON saved."""
    out = tmp_path / "probe.json"
    res = tpp.main(["--checkpoint", str(files["ckpt"]), "--bindings",
                    str(files["bindings"]), "--patch-size", "32",
                    "--split-block-size", "1", "1", "--halo", "4",
                    "--output", str(out), "--device", "cpu"])
    assert res["target_feature"] == "phase_target"
    assert "===== phase probe val" in capsys.readouterr().out
    saved = json.loads(out.read_text())
    assert np.asarray(saved["weights"]).shape == (8 + 3 + 20 + 1, 2)
    assert np.isfinite(res["metrics"]["val"]["r2_total"])
