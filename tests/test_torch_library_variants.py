"""The last library variants of the port against the JAX package, on the
CPU: the pair builders of ``losses/pairs.py``, the flat
``contrastive_loss`` and ``segment_logsumexp``,
``utils/spatial.spatial_negative_pairs``, Conv2DEncoder's other activation
and trailing projection (with ``flax_bridge`` and ``torch_import`` mapping
``conv_out``), TCN's spatial [B, T, H, W, C] form,
``conditioning.broadcast_to_time`` and ``FiLMConditionedBlock``,
``transforms.register`` and ``sample_anchors_grid_plus_supplement``.

One parametrised case per variant, on seeded numpy inputs fed to both
packages (random draws made with ``jax.random`` and handed to the port).
Integers, indices and flags are equal (the k smallest of a row are taken
in the order ``lax.top_k`` gives ties, lowest index first; where the port
keeps ``torch.topk``, indices are compared where valid); floats within
rtol 1e-5 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.data import anchor_sampling as jas
from forest_tpu.data import transforms as jtf
from forest_tpu.losses import contrastive as jcon
from forest_tpu.losses import pairs as jpairs
from forest_tpu.models import conditioning as jcond
from forest_tpu.models.conv2d_encoder import Conv2DEncoder as JEncoder
from forest_tpu.models.tcn import TCNEncoder as JTCN
from forest_tpu.utils import spatial as jsp
from forest_tpu_torch.data import anchor_sampling as tas
from forest_tpu_torch.data import transforms as ttf
from forest_tpu_torch.losses import contrastive as tcon
from forest_tpu_torch.losses import pairs as tpairs
from forest_tpu_torch.models import conditioning as tcond
from forest_tpu_torch.models.conv2d_encoder import Conv2DEncoder as TEncoder
from forest_tpu_torch.models.tcn import TCNEncoder as TTCN
from forest_tpu_torch.utils import flax_bridge, torch_import
from forest_tpu_torch.utils import spatial as tsp
from torch_parity import flax_params, t, ti

TOL = dict(rtol=1e-5, atol=1e-5)


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def close(got, want):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(g, np.asarray(want), **TOL)


def distances(seed, n=24, m=None):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 5.0, size=(n, m or n)).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = np.inf
    d[3, 4] = np.nan
    valid = rng.random(m or n) > 0.15
    return d, valid


def case_pairs_knn():
    d, v = distances(0)
    for sym in (False, True):
        got = tpairs.pairs_knn(t(d), 5, torch.from_numpy(v), symmetric=sym)
        want = jpairs.pairs_knn(jnp.asarray(d), 5, jnp.asarray(v),
                                symmetric=sym)
        for g, w in zip(got, want):
            same(g, w)
    assert got[0].dtype == torch.int32 and not bool(got[1].all())


def case_knn_membership():
    d, v = distances(1)
    same(tpairs.knn_membership(t(d), 4, torch.from_numpy(v)),
         jpairs.knn_membership(jnp.asarray(d), 4, jnp.asarray(v)))
    same(tpairs.knn_membership(t(d), 30),       # k past N
         jpairs.knn_membership(jnp.asarray(d), 30))


def case_pairs_mutual_knn():
    d, v = distances(2)
    d = np.minimum(d, d.T)
    got = tpairs.pairs_mutual_knn(t(d), 6, torch.from_numpy(v))
    want = jpairs.pairs_mutual_knn(jnp.asarray(d), 6, jnp.asarray(v))
    for g, w in zip(got, want):
        same(g, w)
    assert 0 < int(got[1].sum()) < got[1].numel()
    with pytest.raises(ValueError, match="square"):
        tpairs.pairs_mutual_knn(t(d[:, :5]), 3)


def case_pairs_quantile():
    d, v = distances(3, 20, 28)
    for q, low in ((0.1, 0.0), (0.5, 0.2)):
        got = tpairs.pairs_quantile(t(d), q, torch.from_numpy(v), low=low)
        same(got, jpairs.pairs_quantile(jnp.asarray(d), q, jnp.asarray(v),
                                        low=low))
        assert bool(got.any())


def case_pairs_radius():
    d, v = distances(4)
    same(tpairs.pairs_radius(t(d), 1.5, torch.from_numpy(v), min_dist=0.5),
         jpairs.pairs_radius(jnp.asarray(d), 1.5, jnp.asarray(v),
                             min_dist=0.5))


def case_mask_to_pairs():
    rng = np.random.default_rng(5)
    adj = rng.random((9, 11)) < 0.2
    key = jax.random.key(4)
    u = t(jax.random.uniform(key, (99,)))
    for max_pairs, draw in ((12, None), (12, key), (120, None)):
        got = tpairs.mask_to_pairs(torch.from_numpy(adj), max_pairs,
                                   uniform=None if draw is None else u)
        want = jpairs.mask_to_pairs(jnp.asarray(adj), max_pairs, key=draw)
        for g, w in zip(got, want):
            same(g, w)
    assert got[0].shape == (120, 2) and not bool(got[1][-1])


def case_apply_spatial_constraint():
    d, _ = distances(6)
    coords = np.random.default_rng(6).integers(0, 12, (24, 2)).astype(
        np.int32)
    same(tpairs.apply_spatial_constraint(t(d), ti(coords), 4.0),
         jpairs.apply_spatial_constraint(jnp.asarray(d), jnp.asarray(coords),
                                         4.0))


def case_pairs_with_spatial_constraint(strategy):
    d, v = distances(7)
    d = np.minimum(d, d.T)
    coords = np.random.default_rng(7).integers(0, 16, (24, 2)).astype(
        np.int32)
    kw = dict(strategy=strategy, k=4, q=0.2, radius=2.0, min_spatial=3.0)
    got = tpairs.pairs_with_spatial_constraint(
        t(d), ti(coords), valid_mask=torch.from_numpy(v), **kw)
    want = jpairs.pairs_with_spatial_constraint(
        jnp.asarray(d), jnp.asarray(coords), valid_mask=jnp.asarray(v),
        **kw)
    for g, w in zip(got, want):
        same(g, w)
    with pytest.raises(ValueError, match="unknown pair strategy"):
        tpairs.pairs_with_spatial_constraint(t(d), ti(coords),
                                             strategy="nearest")


def case_pairs_mutual_knn_chunked():
    rng = np.random.default_rng(8)
    f = rng.normal(size=(37, 6)).astype(np.float32)
    patch = rng.integers(0, 3, 37).astype(np.int32)
    coords = rng.integers(0, 10, (37, 2)).astype(np.int32)
    got = tpairs.pairs_mutual_knn_chunked(t(f), 5, ti(patch), ti(coords),
                                          3.0, chunk_size=8)
    want = jpairs.pairs_mutual_knn_chunked(
        jnp.asarray(f), 5, jnp.asarray(patch), jnp.asarray(coords), 3.0,
        chunk_size=8)
    same(got[1], want[1])
    ok = np.asarray(want[1])
    same(got[0].numpy()[ok], np.asarray(want[0])[ok])
    assert 0 < ok.sum() < ok.size


def case_segment_logsumexp():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=40).astype(np.float32) * 3
    ids = rng.integers(0, 6, 40).astype(np.int32)      # segment 6 empty
    valid = rng.random(40) > 0.3
    valid[ids == 2] = False                           # no valid entry
    shift = rng.normal(size=7).astype(np.float32)
    for sh in (None, shift):
        got = tcon.segment_logsumexp(t(logits), ti(ids), 7,
                                     torch.from_numpy(valid),
                                     None if sh is None else t(sh))
        want = jcon.segment_logsumexp(jnp.asarray(logits), jnp.asarray(ids),
                                      7, jnp.asarray(valid),
                                      None if sh is None else jnp.asarray(sh))
        close(got[0], want[0])
        same(got[1], want[1])


def case_contrastive_loss(similarity):
    rng = np.random.default_rng(10)
    p, d, s = 60, 8, 9
    za = rng.normal(size=(p, d)).astype(np.float32)
    zo = rng.normal(size=(p, d)).astype(np.float32)
    ids = rng.integers(0, s - 1, p).astype(np.int32)   # anchor s-1 unused
    pos = rng.random(p) < 0.3
    w = rng.uniform(0.1, 2.0, p).astype(np.float32)
    pv = rng.random(p) > 0.1
    got = tcon.contrastive_loss(t(za), t(zo), ti(ids),
                                torch.from_numpy(pos), s, t(w),
                                torch.from_numpy(pv), similarity, 0.1)
    want = jcon.contrastive_loss(jnp.asarray(za), jnp.asarray(zo),
                                 jnp.asarray(ids), jnp.asarray(pos), s,
                                 jnp.asarray(w), jnp.asarray(pv),
                                 similarity, 0.1)
    close(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    same(got[1]["n_anchors_used"], want[1]["n_anchors_used"])
    for k in ("mean_pos_sim", "mean_neg_sim"):
        close(got[1][k], want[1][k])
    # the grouped form on the same pairs when every anchor has K rows
    zg = t(zo).reshape(6, 10, d)
    loss_g, _ = tcon.contrastive_loss_grouped(
        t(za[::10]), zg, torch.from_numpy(pos).reshape(6, 10),
        t(w).reshape(6, 10), torch.from_numpy(pv).reshape(6, 10),
        similarity, 0.1)
    loss_f, _ = tcon.contrastive_loss(
        t(np.repeat(za[::10], 10, 0)), t(zo), ti(np.repeat(np.arange(6), 10)),
        torch.from_numpy(pos), 6, t(w), torch.from_numpy(pv), similarity,
        0.1)
    close(loss_f, loss_g.detach().numpy())


def case_spatial_negative_pairs():
    rng = np.random.default_rng(11)
    b, h, w, n, pool = 2, 20, 24, 15, 64
    mask = (rng.random((b, h, w)) < 0.7).astype(np.float32)
    mask[1] = rng.random((h, w)) < 0.02    # fewer valid pixels than picks
    coords = np.stack([rng.integers(0, h, (b, n)), rng.integers(0, w, (b, n))],
                      -1).astype(np.int32)
    keys = jax.random.split(jax.random.key(12), b)
    pool_u, pick_u = [], []
    for k in keys:
        k_pool, k_pick = jax.random.split(k)
        pool_u.append(np.asarray(jax.random.uniform(k_pool, (h * w,))))
        pick_u.append(np.asarray(jax.random.uniform(k_pick, (n, pool))))
    got = tsp.spatial_negative_pairs(
        ti(coords), t(mask), 5.0, 14.0, 4, pool, pool_u=t(np.stack(pool_u)),
        pick_u=t(np.stack(pick_u)))
    for i in range(b):
        aidx, nbr, ok = map(np.asarray, jsp.spatial_negative_pairs(
            jnp.asarray(coords[i]), jnp.asarray(mask[i]), keys[i], 5.0, 14.0,
            4, pool))
        same(got[0][i], aidx)
        same(got[2][i], ok)
        same(got[1][i].numpy()[ok], nbr[ok])
    assert bool(got[2].any()) and not bool(got[2].all())


def case_conv2d_encoder(activation, out):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 7, 9, 4)).astype(np.float32)
    jm = JEncoder(channels=(8, 6), activation=activation, out_channels=out,
                  num_groups=2)
    params = flax_params(lambda k: jm.init(k, jnp.asarray(x)), 14)
    tm = TEncoder(4, (8, 6), num_groups=2, activation=activation,
                  out_channels=out)
    tm.load_state_dict(flax_bridge.params_from_flax(params), strict=True)
    assert ("conv_out" in params) == (out == 5)
    close(tm(t(x)), jm.apply({"params": params}, jnp.asarray(x)))
    # flax_bridge carries conv_out's kernel and bias back unchanged
    back = flax_bridge.params_to_flax(tm.state_dict())
    for name, leaf in (("conv_out", "kernel"), ("conv_out", "bias"),
                       ("conv_0", "kernel")):
        if name in params:
            same(back[name][leaf], params[name][leaf])


def case_torch_import_conv_out():
    """A reference encoder Sequential with a trailing biased 1x1 conv
    imports as ``encoder/conv_out`` and reproduces the reference output in
    the port's Conv2DEncoder."""
    g = torch.Generator().manual_seed(15)
    ref = torch.nn.Sequential(
        torch.nn.Conv2d(4, 8, 1, bias=False), torch.nn.GroupNorm(2, 8),
        torch.nn.ReLU(), torch.nn.Conv2d(8, 6, 1, bias=False),
        torch.nn.GroupNorm(2, 6), torch.nn.Conv2d(6, 5, 1))
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5 + (
                1.0 if p.ndim == 1 and p.shape[0] in (6, 8) else 0.0))
    sd = {f"encoder.layers.{k}": v.numpy()
          for k, v in ref.state_dict().items()}
    params, rep = torch_import.convert_state_dict(sd)
    assert set(params["encoder"]["conv_out"]) == {"kernel", "bias"}
    assert not rep.unmapped
    tm = TEncoder(4, (8, 6), num_groups=2, out_channels=5)
    tm.load_state_dict(flax_bridge.params_from_flax(params["encoder"]),
                       strict=True)
    x = torch.randn(2, 4, 5, 7, generator=g)
    with torch.no_grad():
        close(tm(x.permute(0, 2, 3, 1)), ref(x).permute(0, 2, 3, 1).numpy())


def case_tcn_spatial(pooling, masked):
    rng = np.random.default_rng(16)
    x = rng.normal(size=(2, 6, 3, 4, 5)).astype(np.float32)
    mask = rng.random((2, 6, 3, 4)) > 0.3 if masked else None
    jm = JTCN(channels=(8, 8), pooling=pooling, num_groups=4)
    params = flax_params(lambda k: jm.init(k, jnp.asarray(x)), 17)
    tm = TTCN(5, (8, 8), pooling=pooling, num_groups=4)
    tm.load_state_dict(flax_bridge.params_from_flax(params), strict=True)
    got = tm(t(x), None if mask is None else torch.from_numpy(mask))
    want = jm.apply({"params": params}, jnp.asarray(x),
                    None if mask is None else jnp.asarray(mask))
    assert got.shape == want.shape
    close(got, want)


def case_broadcast_to_time():
    p = np.random.default_rng(18).normal(size=(3, 4)).astype(np.float32)
    for axis in (1, 0, -1):
        same(tcond.broadcast_to_time(t(p), 5, axis),
             jcond.broadcast_to_time(jnp.asarray(p), 5, axis))


def case_film_conditioned_block():
    rng = np.random.default_rng(19)
    x = rng.normal(size=(7, 5)).astype(np.float32)
    c = rng.normal(size=(7, 4)).astype(np.float32)
    jm = jcond.FiLMConditionedBlock(features=6)
    params = flax_params(lambda k: jm.init(k, jnp.asarray(x),
                                           jnp.asarray(c)), 20)
    tm = tcond.FiLMConditionedBlock(5, 4, 6)
    tm.load_state_dict(flax_bridge.params_from_flax(params), strict=True)
    close(tm(t(x), t(c)),
          jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(c)))


def case_transforms_register():
    saved = dict(ttf._REGISTRY), dict(jtf._REGISTRY)
    try:
        for mod in (ttf, jtf):
            mod.register(mod.Transform("halve", lambda x: x / 2,
                                       lambda x: x * 2, lambda x: x > 0))
        x = np.asarray([-1.0, 0.5, 4.0], np.float32)
        got = ttf.apply_transform("halve", t(x))
        want = jtf.apply_transform("halve", jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert np.isnan(got[0].item())
        assert ttf.get_transform("halve").inverse(t(x))[2] == 8.0
        ttf.register(ttf.Transform("halve", lambda x: x, lambda x: x,
                                   lambda x: x == x))      # replaces
        assert float(ttf.apply_transform("halve", t(x))[0]) == -1.0
    finally:
        for mod, reg in zip((ttf, jtf), saved):
            mod._REGISTRY.clear()
            mod._REGISTRY.update(reg)


def case_sample_anchors_grid_plus_supplement():
    rng = np.random.default_rng(21)
    b, h, w = 3, 48, 40
    weights = (rng.random((b, h, w)) < 0.4).astype(np.float32) \
        * rng.uniform(0.5, 2.0, (b, h, w)).astype(np.float32)
    weights[2] = 0.0                                  # no valid pixel
    key = jax.random.key(22)
    jitter, supp_u = [], []          # the JAX function's draws, per sample
    for k in jax.random.split(key, b):
        kg, ks = jax.random.split(k)
        supp_u.append(np.asarray(jax.random.uniform(ks, (h * w,))))
        ky, kx = jax.random.split(kg)
        jitter.append([int(jax.random.randint(kk, (), -3, 4))
                       for kk in (ky, kx)])
    jitter, supp_u = ti(jitter), t(np.stack(supp_u))
    coords, valid = tas.sample_anchors_grid_plus_supplement(
        t(weights), 8, 4, 3, 20, jitter=jitter, supplement_u=supp_u)
    for i, k in enumerate(jax.random.split(key, b)):
        jc, jv = map(np.asarray, jas.sample_anchors_grid_plus_supplement(
            k, h, w, jnp.asarray(weights[i]), 8, 4, 3, 20))
        same(valid[i], jv)
        same(coords[i].numpy()[jv], jc[jv])
    assert not bool(valid[2].any()) and bool(valid[0].any())


CASES = [
    ("pairs_knn", case_pairs_knn, {}),
    ("knn_membership", case_knn_membership, {}),
    ("pairs_mutual_knn", case_pairs_mutual_knn, {}),
    ("pairs_quantile", case_pairs_quantile, {}),
    ("pairs_radius", case_pairs_radius, {}),
    ("mask_to_pairs", case_mask_to_pairs, {}),
    ("apply_spatial_constraint", case_apply_spatial_constraint, {}),
    *[(f"pairs_with_spatial_constraint-{s}",
       case_pairs_with_spatial_constraint, {"strategy": s})
      for s in ("knn", "mutual_knn", "quantile", "radius")],
    ("pairs_mutual_knn_chunked", case_pairs_mutual_knn_chunked, {}),
    ("segment_logsumexp", case_segment_logsumexp, {}),
    *[(f"contrastive_loss-{s}", case_contrastive_loss, {"similarity": s})
      for s in ("l2", "cosine", "dot")],
    ("spatial_negative_pairs", case_spatial_negative_pairs, {}),
    *[(f"conv2d_encoder-{a}-{o}", case_conv2d_encoder,
       {"activation": a, "out": o})
      for a, o in (("none", 5), ("relu", 5), ("gelu", None), ("relu", 6))],
    ("torch_import_conv_out", case_torch_import_conv_out, {}),
    *[(f"tcn_spatial-{p}-{'masked' if m else 'unmasked'}", case_tcn_spatial,
       {"pooling": p, "masked": m})
      for p, m in (("none", False), ("stats", False), ("stats", True))],
    ("broadcast_to_time", case_broadcast_to_time, {}),
    ("film_conditioned_block", case_film_conditioned_block, {}),
    ("transforms_register", case_transforms_register, {}),
    ("sample_anchors_grid_plus_supplement",
     case_sample_anchors_grid_plus_supplement, {}),
]


@pytest.mark.parametrize("fn,kw", [pytest.param(fn, kw, id=name)
                                   for name, fn, kw in CASES])
def test_variant_matches_jax(fn, kw):
    fn(**kw)
