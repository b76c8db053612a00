"""forest_tpu_torch.ops.vq and ops.vq_variants against forest_tpu.ops.vq.

The same seeded numpy inputs go through the JAX function and its
counterpart in the port. The JAX side runs as tests/test_vq.py runs it on
the CPU: its XLA path (``use_pallas=False``) and the Pallas kernels in
interpret mode (``interpret=True``). On the CPU the port's wrappers take
their plain versions and count no launch. Indices must agree exactly
(seeded Gaussian data has no near-ties at these sizes); floats to 1e-5
(float32 sums in another order). The CUDA kernels K4-K7 are held to their
plain versions on a card (``cuda`` marker).
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.ops import vq as jvq
from forest_tpu_torch.ops import vq as tvq
from forest_tpu_torch.ops import vq_variants as tvv
from torch_parity import cuda_device, t, ti  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(333, 24, 17), (64, 32, 40), (5, 7, 3), (200, 128, 16)]
JAX_MODES = [{"use_pallas": False}, {"interpret": True}]
MODE_IDS = ["xla", "pallas-interpret"]


def _data(shape, seed=0):
    n, d, k = shape
    rng = np.random.default_rng(seed + n)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(k, d)).astype(np.float32))


def _bench_script():
    """scripts/bench_vq_variants.py as a module, loaded by path."""
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "bench_vq_variants.py"
    spec = importlib.util.spec_from_file_location("bench_vq_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- vq_core, K4
@pytest.mark.parametrize("mode", JAX_MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_vq_core_matches_jax(shape, mode):
    x, c = _data(shape)
    ref = jvq.vq_core(jnp.asarray(x), jnp.asarray(c), with_qx=True, **mode)
    before = tvq.vq_core.launches
    got = tvq.vq_core(t(x), t(c), with_qx=True)
    assert tvq.vq_core.launches == before          # CPU: the plain version
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert len(tvq.vq_core(t(x), t(c))) == 4


@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("mode", JAX_MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_vq_assign_matches_jax(shape, mode, mxu_bf16):
    x, c = _data(shape, seed=1)
    ref = jvq.vq_assign(jnp.asarray(x), jnp.asarray(c), mxu_bf16=mxu_bf16,
                        **mode)
    got = tvq.vq_assign(t(x), t(c), mxu_bf16=mxu_bf16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if not mxu_bf16:
        np.testing.assert_array_equal(got.numpy(),
                                      tvq.vq_core(t(x), t(c))[0].numpy())


def test_vq_assign_rejects_unknown_kwargs():
    x, c = _data((5, 7, 3))
    for bad in ({"use_pallas": False}, {"tile_n": 256}, {"mxu_bf61": True}):
        with pytest.raises(TypeError, match="unexpected kwargs"):
            tvq.vq_assign(t(x), t(c), **bad)
    with pytest.raises(TypeError):
        tvq.vq_core(t(x), t(c), use_pallas=False)


def test_bad_shapes_and_devices_raise():
    with pytest.raises(ValueError, match="must be"):
        tvq.vq_core(torch.ones(3, 4), torch.ones(5, 6))
    with pytest.raises(ValueError, match="must be"):
        tvq.vq_assign(torch.ones(3), torch.ones(5, 3))
    with pytest.raises(ValueError, match="no kernel"):
        tvq.vq_core(torch.ones(3, 4, device="meta"),
                    torch.ones(5, 4, device="meta"))


@pytest.mark.parametrize("mode", JAX_MODES, ids=MODE_IDS)
def test_nan_conventions_match_jax(mode):
    """A NaN input row lands on index 0 and is counted; a NaN codebook row
    is never assigned."""
    x, c = _data((40, 8, 6), seed=2)
    x[3] = np.nan
    x[7, 2] = np.nan
    c[4] = np.nan
    ref = jvq.vq_core(jnp.asarray(x), jnp.asarray(c), **mode)
    idx, q, counts, _ = tvq.vq_core(t(x), t(c))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
    assert idx[3] == 0 and idx[7] == 0 and not (idx == 4).any()
    np.testing.assert_array_equal(q[3].numpy(), c[0])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref[2]))
    assert counts.sum() == 40
    np.testing.assert_array_equal(
        tvq.vq_assign(t(x), t(c)).numpy(),
        np.asarray(jvq.vq_assign(jnp.asarray(x), jnp.asarray(c), **mode)))


@pytest.mark.parametrize("mode", JAX_MODES, ids=MODE_IDS)
def test_ties_take_the_lowest_index_as_jax(mode):
    rng = np.random.default_rng(3)
    x = rng.integers(-2, 3, size=(300, 6)).astype(np.float32)
    half = rng.integers(-2, 3, size=(5, 6)).astype(np.float32)
    c = np.concatenate([half, half])                  # exact duplicates
    ref = jvq.vq_core(jnp.asarray(x), jnp.asarray(c), **mode)[0]
    idx = tvq.vq_core(t(x), t(c))[0]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    assert idx.max() < 5
    np.testing.assert_array_equal(tvq.vq_assign(t(x), t(c)).numpy(),
                                  idx.numpy())


def test_stats_segments_cover_every_row():
    for n in (1, 64, 4096, 4097, 131072, 10 ** 7):
        segs, rows = tvq.stats_segments(n)
        assert 1 <= segs <= 128 and rows % 128 == 0 and segs * rows >= n
        assert (segs - 1) * rows < n


# N at the edges of vq_core's one-launch path (one row tile of 128), and one
# that crosses the statistics pass's segments of 256 rows
EDGE_N = [1, 63, 64, 65, 127, 128, 129, 845]


@pytest.mark.parametrize("n", EDGE_N)
def test_small_path_choice_and_scratch_layout(n):
    d, k = 128, 256
    small = tvq.vq_core_small(n, k)
    assert small == (n <= 128)
    assert tvq.vq_core_launches(n, k) == (1 if small else 4)
    assert not tvq.vq_core_small(n, 2049) and tvq.vq_core_small(1, 2048)
    nbytes, layout = tvq.vq_core_scratch(n, d, k)
    if small:
        slot = -(-16 * n * 4 // 256) * 256
        assert layout == {"part_d": (0, 16 * n), "part_i": (slot, 16 * n),
                          "qx_part": (2 * slot, 16)}
    else:
        segs, _ = tvq.stats_segments(n)
        assert {name: cnt for name, (_, cnt) in layout.items()} == {
            "c2": k, "cnt_part": segs * k, "sum_part": segs * k * d,
            "qx_part": -(-n // 64)}
    ends = sorted((off, off + 4 * cnt) for off, cnt in layout.values())
    assert all(off % 256 == 0 for off, _ in ends)
    assert all(e <= o for (_, e), (o, _) in zip(ends, ends[1:]))
    assert ends[-1][1] <= nbytes < ends[-1][1] + 256


@pytest.mark.parametrize("n", EDGE_N)
def test_vq_core_matches_jax_at_the_path_edges(n):
    x, c = _data((n, 128, 256), seed=3)
    ref = jvq.vq_core(jnp.asarray(x), jnp.asarray(c), with_qx=True,
                      use_pallas=False)
    got = tvq.vq_core(t(x), t(c), with_qx=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# ----------------------------------------------------- quantiser variants
@pytest.mark.parametrize("mode", ["st", "ema"])
def test_quantize_values_and_gradients_match_jax(mode):
    x, c = _data((48, 12, 9), seed=4)
    w = np.random.default_rng(5).normal(size=(48, 12)).astype(np.float32)

    def loss(xj, cj):
        r = jvq.quantize(xj, cj, mode=mode, beta=0.3, use_pallas=False)
        return jnp.sum(r.quantized * jnp.asarray(w)) + 2.0 * r.vq_loss, r

    (_, ref), (gx, gc) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(x), jnp.asarray(c))
    tx, tc = t(x).requires_grad_(True), t(c).requires_grad_(True)
    r = tvq.quantize(tx, tc, mode=mode, beta=0.3)
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(ref.indices))
    for name in ("quantized", "vq_loss", "counts", "sums", "perplexity"):
        np.testing.assert_allclose(getattr(r, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)
    (torch.sum(r.quantized * t(w)) + 2.0 * r.vq_loss).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    if mode == "st":
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), **TOL)
        assert tc.grad.abs().sum() > 0
    else:                       # the EMA codebook learns by update only
        assert tc.grad is None and float(jnp.abs(gc).sum()) == 0.0


def test_quantize_rejects_unknown_mode():
    x, c = _data((5, 7, 3))
    with pytest.raises(ValueError, match="unknown quantizer mode"):
        tvq.quantize(t(x), t(c), mode="gumbel")


@pytest.mark.parametrize("counts", [[4.0, 4.0, 4.0, 4.0], [9.0, 0.0, 0.0],
                                    [0.0, 0.0], [5.0, 1.0, 0.0, 2.0]])
def test_perplexity_matches_jax(counts):
    got = tvq.perplexity_from_counts(torch.tensor(counts))
    ref = jvq.perplexity_from_counts(jnp.asarray(counts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


# ------------------------------------------------------ EMA codebook state
def test_vq_stats_init_matches_jax_and_copies_the_codebook():
    _, c = _data((5, 7, 3))
    cb = torch.nn.Parameter(t(c))
    seeded = tvq.VQStats.init(3, 7, codebook=cb)
    ref = jvq.VQStats.init(3, 7, codebook=jnp.asarray(c))
    for g, r in zip(seeded, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert seeded.cluster_sum.data_ptr() != cb.data_ptr()
    assert not seeded.cluster_sum.requires_grad
    with torch.no_grad():
        cb.add_(1.0)
    np.testing.assert_array_equal(seeded.cluster_sum.numpy(), c)
    for g, r in zip(tvq.VQStats.init(3, 7), jvq.VQStats.init(3, 7)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_ema_codebook_update_matches_jax_over_three_batches():
    rng = np.random.default_rng(6)
    _, c = _data((5, 16, 10), seed=6)
    js = jvq.VQStats.init(10, 16, codebook=jnp.asarray(c))
    ts = tvq.VQStats.init(10, 16, codebook=t(c))
    jc, tc = jnp.asarray(c), t(c)
    for _ in range(3):
        x = rng.normal(size=(64, 16)).astype(np.float32)
        _, _, jcounts, jsums = jvq.vq_core(jnp.asarray(x), jc,
                                           use_pallas=False)
        _, _, tcounts, tsums = tvq.vq_core(t(x), tc)
        js, jc = jvq.ema_codebook_update(js, jc, jcounts, jsums, decay=0.9,
                                         eps=1e-5)
        ts, tc = tvq.ema_codebook_update(ts, tc, tcounts, tsums, decay=0.9,
                                         eps=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        for g, r in zip(ts, js):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert ts.code_usage.sum() == 3 * 64


def test_unassigned_codes_keep_their_initial_vectors():
    _, c = _data((5, 8, 6), seed=7)
    stats = tvq.VQStats.init(6, 8, codebook=t(c))
    counts = torch.tensor([10.0, 0, 0, 0, 0, 0])
    sums = torch.zeros(6, 8)
    sums[0] = 10.0
    _, cb = tvq.ema_codebook_update(stats, t(c), counts, sums)
    np.testing.assert_allclose(cb[1:].numpy(), c[1:], rtol=1e-4, atol=1e-5)


def test_reseed_dead_codes_matches_jax_with_its_draw():
    rng = np.random.default_rng(8)
    _, c = _data((5, 8, 12), seed=8)
    cand = rng.normal(size=(30, 8)).astype(np.float32)
    size = rng.uniform(0.5, 3.0, size=12).astype(np.float32)
    size[[2, 5, 11]] = 1e-5                         # dead
    csum = rng.normal(size=(12, 8)).astype(np.float32)
    usage = rng.integers(0, 50, size=12).astype(np.float32)
    key = jax.random.key(9)
    jcb, jstats = jvq.reseed_dead_codes(
        jnp.asarray(c), jvq.VQStats(jnp.asarray(size), jnp.asarray(csum),
                                    jnp.asarray(usage)),
        jnp.asarray(cand), key)
    pick = ti(jax.random.randint(key, (12,), 0, 30))   # the JAX draw
    tcb, tstats = tvq.reseed_dead_codes(
        t(c), tvq.VQStats(t(size), t(csum), t(usage)), t(cand), pick=pick)
    np.testing.assert_allclose(tcb.numpy(), np.asarray(jcb), **TOL)
    for g, r in zip(tstats, jstats):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert not np.array_equal(tcb[2].numpy(), c[2])
    np.testing.assert_array_equal(tcb[0].numpy(), c[0])


def test_reseed_draws_from_a_generator_by_default():
    _, c = _data((5, 8, 12), seed=8)
    cand = t(np.random.default_rng(1).normal(size=(30, 8)))
    stats = tvq.VQStats(torch.full((12,), 1e-6), torch.zeros(12, 8),
                        torch.zeros(12))
    a, _ = tvq.reseed_dead_codes(t(c), stats, cand,
                                 generator=torch.Generator().manual_seed(3))
    b, _ = tvq.reseed_dead_codes(t(c), stats, cand,
                                 generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert all((cand == row).all(1).any() for row in a)   # all reseeded


# --------------------------------------------- the sweep's variants, K6, K7
@pytest.mark.parametrize("mxu_bf16", [False, True])
def test_variant_plain_versions_match_jax_vq_assign(mxu_bf16):
    x, c = _data((333, 24, 17), seed=10)
    ref = np.asarray(jvq.vq_assign(jnp.asarray(x), jnp.asarray(c),
                                   use_pallas=False, mxu_bf16=mxu_bf16))
    before = (tvv.make_assign.launches, tvv.make_assign_t.launches)
    rows = tvv.make_assign(512, mxu_bf16)(t(x), t(c))
    cols = tvv.make_assign_t(512, mxu_bf16, torch.float32, False)(t(x), t(c))
    pre = tvv.make_assign_t(2048, mxu_bf16, torch.float32, True)(
        t(x.T.copy()), t(c))
    assert (tvv.make_assign.launches, tvv.make_assign_t.launches) == before
    for got in (rows, cols, pre):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_variant_plain_versions_match_the_scripts_xla_assign():
    script = _bench_script()
    x, c = _data((333, 24, 17), seed=11)
    ref = np.asarray(script.xla_assign(jnp.asarray(x), jnp.asarray(c)))
    for got in (tvv.assign_reference(t(x), t(c)),
                tvv.assign_t_reference(t(x), t(c)),
                tvv.matmul_assign(t(x), t(c))):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_variant_knobs_on_the_plain_versions():
    x, c = _data((200, 16, 12), seed=12)
    bf16 = tvv.make_assign(512, True, torch.bfloat16)(t(x), t(c))
    # bf16 storage: operands and ||c||^2 from the rounded values
    xr, cr = t(x).bfloat16().float(), t(c).bfloat16().float()
    exp = ((cr * cr).sum(-1)[None] - 2.0 * xr @ cr.t()).argmin(1)
    np.testing.assert_array_equal(bf16.numpy(), exp.numpy())
    mins = tvv.make_assign(512, False, torch.float32, argmin=False)(
        t(x), t(c))
    d = (t(c) * t(c)).sum(-1)[None] - 2.0 * t(x) @ t(c).t()
    np.testing.assert_array_equal(mins.numpy(),
                                  d.min(1).values.to(torch.int32).numpy())
    with pytest.raises(ValueError, match="multiple"):
        tvv.make_assign(100, False)(t(x), t(c))
    with pytest.raises(TypeError, match="io_dtype"):
        tvv.make_assign(512, False, torch.float16)(t(x), t(c))
    with pytest.raises(ValueError, match="do not fit"):
        tvv.make_assign_t(512, False, torch.float32, True)(t(x), t(c))


def test_sweep_lists_the_scripts_variants():
    x = torch.zeros(4, 4)
    names = [n for n, _, _ in tvv.variants(x, x.t())]
    assert len(names) == 15 and len(set(names)) == 15
    assert sum("tileT=4096" in n for n in names) == 3
    assert (tvv.N, tvv.D, tvv.K) == (131072, 128, 256)
    if not torch.cuda.is_available():     # the sweep never times a CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tvv.main(["--iters", "1"])


@pytest.mark.parametrize("shape,f32,bf16", [
    ((131072, 128, 256), "resident", "mma"),    # the bench shape
    ((64, 128, 256), "resident", "mma"),        # the VQ-VAE step's
    ((333, 24, 17), "resident", "mma"),
    ((5, 7, 3), "slab", "slab"),                # D not a multiple of 4
    ((64, 8, 2049), "slab", "mma"),             # float32 codebook too big
    ((1000, 128, 1024), "slab", "slab"),        # both too big
], ids=str)
def test_vq_assign_path_choice(shape, f32, bf16):
    assert tvq.vq_assign_path(*shape) == f32
    assert tvq.vq_assign_path(*shape, mxu_bf16=True) == bf16
    assert tvq.vq_assign_path(*shape, aligned=False) == "slab"
    assert tvq.vq_assign_path(*shape, mxu_bf16=True, aligned=False) == \
        "slab"


def test_shared_memory_of_the_resident_products():
    # K4's resident product at the bench shape: 198 KB
    assert tvq.resident_shared_bytes(128, 256) == 202752
    assert tvq.resident_shared_bytes(128, 256, transposed=True) == \
        4 * (256 * 132 + 2 * 128 * 64)
    # bf16 codebook 256 x (128 + 8), rounded tile, three float32 tiles, norms
    assert tvq.mma_shared_bytes(128, 256) == \
        256 * 136 * 2 + 64 * 136 * 2 + 3 * 64 * 128 * 4 + 1024
    assert tvq.mma_shared_bytes(128, 256, True, 2) == \
        256 * 136 * 2 + 128 * 72 * 2 + 3 * 64 * 128 * 2 + 1024
    for d, k in ((128, 256), (24, 17), (8, 2049)):
        if tvq.vq_assign_path(64, d, k, True) == "mma":
            assert tvq.mma_shared_bytes(d, k) <= tvq._SHARED_BYTES


def test_layout_constants_equal_the_headers():
    """The constants by which ops.vq sizes the resident products' shared
    memory are the ones csrc/vq_resident.cuh launches with."""
    src = (Path(tvq.__file__).resolve().parents[1] / "csrc" /
           "vq_resident.cuh").read_text()
    const = {m[1]: int(m[2]) for m in
             re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    assert const["RES_ROWS"] == tvq._RESIDENT_ROWS
    assert const["RES_CODES"] == tvq._RESIDENT_CODES
    assert const["MMA_STAGES"] == tvq._MMA_STAGES
    assert const["MMA_PAD"] == tvq._MMA_PAD
    assert const["MAX_SHARED_BYTES"] - const["RES_STATIC_BYTES"] == \
        tvq._SHARED_BYTES


@pytest.mark.parametrize("tile", [512, 1024, 2048, 4096])
def test_transposed_grid_does_not_follow_the_tpu_tile(tile):
    n = 131072
    assert tvv.cols_path(n, 128, 256) == "resident"
    assert tvv.cols_path(n, 128, 256, mxu_bf16=True) == "mma"
    assert tvv.cols_path(n, 128, 256, io_dtype=torch.bfloat16) == "mma"
    assert tvv.launch_grid(n, 132) == 132   # persistent blocks
    assert tvv.launch_grid(100, 132) == 2
    assert tvv.launch_grid(n, 132) == tvq.persistent_blocks(n, 132)
    # the knob is still checked, and still the sweep's name
    fn = tvv.make_assign_t(tile, False, torch.float32, True)
    x, c = _data((64, 16, 12), seed=13)
    np.testing.assert_array_equal(
        fn(t(x.T.copy()), t(c)).numpy(),
        tvv.assign_reference(t(x), t(c)).numpy())
    with pytest.raises(ValueError, match="multiple"):
        tvv.make_assign_t(tile + 64, False)(t(x), t(c))


@pytest.mark.parametrize("n,d,io,mxu,path", [
    (336, 24, torch.float32, False, "resident"),
    (333, 24, torch.float32, False, "slab"),    # a row of [D, N] unaligned
    (336, 24, torch.bfloat16, False, "mma"),    # bf16 storage rounds
    (340, 24, torch.bfloat16, True, "slab"),    # bf16 rows need N % 8
    (336, 26, torch.float32, True, "slab"),     # D not a multiple of 4
])
def test_transposed_path_choice(n, d, io, mxu, path):
    assert tvv.cols_path(n, d, 17, mxu, io) == path
    assert tvv.cols_path(n, d, 17, mxu, io, aligned=False) == "slab"


@pytest.mark.parametrize("tile", [512, 1024, 2048, 4096])
def test_row_grid_does_not_follow_the_tpu_tile(tile):
    n = 131072
    assert tvv.rows_path(n, 128, 256) == "resident"
    assert tvv.rows_path(n, 128, 256, mxu_bf16=True) == "mma"
    assert tvv.rows_path(n, 128, 256, io_dtype=torch.bfloat16) == "mma"
    # K6's float32 and rounded paths are K5's
    assert tvv.rows_path(n, 128, 256) == tvq.vq_assign_path(n, 128, 256)
    assert tvv.rows_path(n, 128, 256, True) == tvq.vq_assign_path(
        n, 128, 256, True)
    fn = tvv.make_assign(tile, False, torch.float32)
    x, c = _data((64, 16, 12), seed=14)
    np.testing.assert_array_equal(fn(t(x), t(c)).numpy(),
                                  tvv.assign_reference(t(x), t(c)).numpy())
    with pytest.raises(ValueError, match="multiple"):
        tvv.make_assign(tile + 64, False)(t(x), t(c))


@pytest.mark.parametrize("n,d,io,mxu,path", [
    (333, 24, torch.float32, False, "resident"),  # any N: rows of 96 bytes
    (333, 24, torch.float32, True, "mma"),
    (333, 24, torch.bfloat16, False, "mma"),      # bf16 storage rounds
    (333, 20, torch.bfloat16, True, "slab"),      # a bf16 row is 40 bytes
    (333, 26, torch.float32, False, "slab"),      # D not a multiple of 4
    (5, 7, torch.float32, False, "slab"),
])
def test_row_path_choice(n, d, io, mxu, path):
    assert tvv.rows_path(n, d, 17, mxu, io) == path
    assert tvv.rows_path(n, d, 17, mxu, io, aligned=False) == "slab"


def test_row_path_falls_back_where_the_codebook_does_not_fit():
    assert tvv.rows_path(64, 128, 256) == "resident"
    assert tvv.rows_path(64, 128, 257) == "slab"
    assert tvv.rows_path(64, 128, 4096, True) == "slab"


# ---------------------------------------------------------------- on a card
def _rule_ok(x, c, idx, c2_from=None):
    """chip_smoke.py's float64 rule: the chosen code's distance within
    64 float32 ulps of max |d| of the row's best."""
    x64, c64 = x.double(), c.double()
    c2 = ((c if c2_from is None else c2_from).double() ** 2).sum(-1)
    d = (x64 * x64).sum(-1, keepdim=True) - 2.0 * x64 @ c64.t() + c2
    picked = d.gather(1, idx.long()[:, None])[:, 0]
    tol = 64 * 2.0 ** -23 * d.abs().max()
    return bool(((picked - d.min(1).values) <= tol).all())


CARD_SHAPES = [(131072, 128, 256), (64, 128, 256), (333, 24, 17), (5, 7, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_vq_core_kernel_matches_plain_version_on_card(cuda_device, shape):
    x, c = (t(a).to(cuda_device) for a in _data(shape, seed=20))
    before = tvq.vq_core.launches
    got = tvq.vq_core(x, c, with_qx=True)
    again = tvq.vq_core(x, c, with_qx=True)
    torch.cuda.synchronize()
    assert tvq.vq_core.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    idx, q, counts, sums, qx = got
    assert _rule_ok(x, c, idx)
    il = idx.long()
    assert torch.equal(q, c[il])
    assert torch.equal(counts, torch.bincount(il, minlength=c.shape[0])
                       .float())
    exp = torch.zeros_like(c).index_add_(0, il, x)
    assert (sums - exp).abs().max() <= 1e-5 * exp.abs().max()
    exp_qx = (q.double() * x.double()).sum()
    assert abs(qx.double() - exp_qx) <= 1e-5 * abs(exp_qx)
    if shape[0] <= 333:
        assert torch.equal(idx, tvq.vq_core_reference(x, c)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_N)
def test_vq_core_kernel_at_the_path_edges_on_card(cuda_device, n):
    x, c = (t(a).to(cuda_device) for a in _data((n, 128, 256), seed=24))
    before = tvq.vq_core.launches
    got = tvq.vq_core(x, c, with_qx=True)
    again = tvq.vq_core(x, c, with_qx=True)
    torch.cuda.synchronize()
    assert tvq.vq_core.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    idx, q, counts, sums, qx = got
    assert torch.equal(idx, tvq.vq_assign(x, c))
    assert torch.equal(idx, tvq.vq_core_reference(x, c)[0])
    il = idx.long()
    assert torch.equal(q, c[il])
    assert torch.equal(counts, torch.bincount(il, minlength=256).float())
    exp = torch.zeros_like(c).index_add_(0, il, x)
    assert (sums - exp).abs().max() <= 1e-5 * exp.abs().max()
    exp_qx = (q.double() * x.double()).sum()
    assert abs(qx.double() - exp_qx) <= 1e-5 * abs(exp_qx)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 8, 2048), (64, 8, 2049),
                                   (100, 130, 40), (300, 6, 3000)], ids=str)
def test_vq_core_kernel_around_the_one_launch_limits_on_card(cuda_device,
                                                             shape):
    x, c = (t(a).to(cuda_device) for a in _data(shape, seed=26))
    got = tvq.vq_core(x, c, with_qx=True)
    again = tvq.vq_core(x, c, with_qx=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    idx, q, counts, sums, qx = got
    assert torch.equal(idx, tvq.vq_assign(x, c))
    assert _rule_ok(x, c, idx)
    il = idx.long()
    assert torch.equal(q, c[il])
    assert torch.equal(counts, torch.bincount(il, minlength=c.shape[0])
                       .float())
    exp = torch.zeros_like(c).index_add_(0, il, x)
    assert (sums - exp).abs().max() <= 1e-5 * exp.abs().max()


@pytest.mark.cuda
def test_vq_core_indices_equal_vq_assign_at_the_bench_shape_on_card(
        cuda_device):
    x, c = (t(a).to(cuda_device) for a in _data((131072, 128, 256),
                                                 seed=25))
    idx = tvq.vq_core(x, c)[0]
    assert torch.equal(idx, tvq.vq_assign(x, c))
    assert torch.equal(idx.cpu(), tvq.vq_core_reference(x.cpu(),
                                                        c.cpu())[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_vq_assign_kernel_matches_plain_version_on_card(cuda_device, shape,
                                                        mxu_bf16):
    x, c = (t(a).to(cuda_device) for a in _data(shape, seed=21))
    before = tvq.vq_assign.launches
    idx = tvq.vq_assign(x, c, mxu_bf16=mxu_bf16)
    torch.cuda.synchronize()
    assert tvq.vq_assign.launches == before + 1
    xp, cp = (x.bfloat16(), c.bfloat16()) if mxu_bf16 else (x, c)
    assert _rule_ok(xp, cp, idx, c2_from=c)
    if not mxu_bf16:
        assert torch.equal(idx, tvq.vq_core(x, c)[0])


@pytest.mark.cuda
def test_nan_and_tie_rules_of_the_kernels_on_card(cuda_device):
    x, c = (t(a).to(cuda_device) for a in _data((333, 24, 17), seed=22))
    x[3] = float("nan")
    c[5] = float("nan")
    ref = tvq.vq_core_reference(x, c)
    got = tvq.vq_core(x, c)
    assert torch.equal(got[0], ref[0]) and got[0][3] == 0
    assert not (got[0] == 5).any() and torch.equal(got[1], ref[1])
    assert torch.equal(tvq.vq_assign(x, c), ref[0])
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    xi = torch.randint(-2, 3, (4096, 32), device=cuda_device,
                       generator=gen).float()
    half = torch.randint(-2, 3, (32, 32), device=cuda_device,
                         generator=gen).float()
    ci = torch.cat([half, half])
    for a, b in zip(tvq.vq_core(xi, ci, True),
                    tvq.vq_core_reference(xi, ci, True)):
        assert torch.equal(a, b)
    for fn, plain in ((tvv.make_assign(128, False), tvv.assign_reference),
                      (tvv.make_assign_t(128, False),
                       tvv.assign_t_reference)):
        assert torch.equal(fn(xi, ci), plain(xi, ci))
    empty = tvq.vq_core(x[:0], c)
    assert empty[0].shape == (0,) and empty[3].shape == (17, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16,io", [(False, torch.float32),
                                         (True, torch.float32),
                                         (True, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(131072, 128, 256), (333, 24, 17)],
                         ids=str)
def test_variant_kernels_match_plain_versions_on_card(cuda_device, shape,
                                                      mxu_bf16, io):
    x, c = (t(a).to(cuda_device) for a in _data(shape, seed=23))
    xf, cf = x.to(io), c.to(io)
    xp, cp = (xf.bfloat16(), cf.bfloat16()) if mxu_bf16 else (xf, cf)
    before = (tvv.make_assign.launches, tvv.make_assign_t.launches)
    rows = tvv.make_assign(512, mxu_bf16, io)(x, c)
    cols = tvv.make_assign_t(1024, mxu_bf16, io, False)(x, c)
    pre = tvv.make_assign_t(512, mxu_bf16, io, True)(x.t().contiguous(), c)
    torch.cuda.synchronize()
    assert (tvv.make_assign.launches, tvv.make_assign_t.launches) == \
        (before[0] + 1, before[1] + 2)
    for idx in (rows, cols, pre):
        assert _rule_ok(xp, cp, idx, c2_from=cf)
    assert torch.equal(cols, pre)
    mins = tvv.make_assign(512, False, torch.float32, argmin=False)(x, c)
    ref = tvv.assign_reference(x, c, argmin=False)
    assert (mins - ref).abs().max() <= 1


def _integer_inputs(device, n=4096, d=32, k=64):
    """chip_smoke.py's small integers, the codebook's upper half a copy of
    its lower: every product and sum exact in float32 in any order."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randint(-2, 3, (n, d), device=device, generator=gen).float()
    half = torch.randint(-2, 3, (k // 2, d), device=device,
                         generator=gen).float()
    return x, torch.cat([half, half])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_vq_assign_paths_on_card(cuda_device, shape):
    """K5 float32 takes the path vq_assign_path names and equals vq_core's
    indices; with bfloat16 operands it holds the float64 rule, two runs are
    bit-identical, and integer inputs give the plain version exactly."""
    x, c = (t(a).to(cuda_device) for a in _data(shape, seed=27))
    f32 = tvq.vq_assign(x, c)
    assert tvq.vq_assign.last_path == tvq.vq_assign_path(*shape)
    assert torch.equal(f32, tvq.vq_core(x, c)[0])
    b1 = tvq.vq_assign(x, c, mxu_bf16=True)
    assert tvq.vq_assign.last_path == tvq.vq_assign_path(*shape, True)
    b2 = tvq.vq_assign(x, c, mxu_bf16=True)
    torch.cuda.synchronize()
    assert torch.equal(b1, b2)
    assert _rule_ok(x.bfloat16(), c.bfloat16(), b1, c2_from=c)
    if shape == (131072, 128, 256):
        assert tvq.vq_assign_path(*shape) == "resident"
        assert tvq.vq_assign_path(*shape, True) == "mma"
    xi, ci = _integer_inputs(cuda_device)
    for bf16 in (False, True):
        assert torch.equal(tvq.vq_assign(xi, ci, mxu_bf16=bf16),
                           tvq.vq_assign_reference(xi, ci, mxu_bf16=bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [256, 257])   # the last codebook that fits
def test_path_choice_agrees_with_the_launchs_check_on_card(cuda_device, k):
    """Where the codebook stops fitting shared memory, the persistent
    paths the Python side picks launch and those it rejects are refused by
    the C launch: both sides size shared memory alike."""
    n, d = 64, 128
    x, c = (t(a).to(cuda_device) for a in _data((n, d, k), seed=29))
    stream = torch.cuda.current_stream().cuda_stream
    blocks = tvq.persistent_blocks(n, tvq.sm_count(cuda_device.index))
    scratch, c2, cb16 = tvq.assign_scratch(cuda_device, k, d, "mma")
    idx = torch.empty(n, dtype=torch.int32, device=cuda_device)
    for mxu, path in ((False, "resident"), (True, "mma")):
        fits = tvq.vq_assign_path(n, d, k, mxu) == path
        err = tvq._assign_fn()(
            x.data_ptr(), c.data_ptr(), c2, cb16, idx.data_ptr(), n, d, k,
            int(mxu), tvq.ASSIGN_PATHS.index(path), blocks, stream)
        assert (err == 0) == fits, (mxu, err)
    xt = x.t().contiguous()
    for mxu, path in ((False, "resident"), (True, "mma")):
        fits = tvv.cols_path(n, d, k, mxu) == path
        err = tvv._entry("vq_variant_cols")(
            xt.data_ptr(), c.data_ptr(), c2, cb16, idx.data_ptr(), n, d, k,
            512, 0, int(mxu), tvq.ASSIGN_PATHS.index(path), blocks, stream)
        assert (err == 0) == fits, (mxu, err)
    torch.cuda.synchronize()
    assert (k == 256) == (tvq.vq_assign_path(n, d, k) == "resident")


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16,io", [(False, torch.float32),
                                         (True, torch.float32),
                                         (True, torch.bfloat16)])
def test_row_variant_at_every_tile_on_card(cuda_device, mxu_bf16, io):
    """K6 gives the same indices at every TPU tile, on K5's products: its
    float32 indices equal K5's float32 ones and, with bfloat16 operands
    (float32 storage), K5's bfloat16 ones; argmin=False writes the
    truncated row minimum of the same products."""
    x, c = (t(a).to(cuda_device) for a in _data((131072, 128, 256),
                                                 seed=30))
    got = [tvv.make_assign(tile, mxu_bf16, io)(x, c)
           for tile in (512, 1024, 2048, 4096)]
    assert tvv.make_assign.last_path == ("mma" if mxu_bf16 else "resident")
    torch.cuda.synchronize()
    assert all(torch.equal(got[0], g) for g in got[1:])
    if io == torch.float32:
        assert torch.equal(got[0], tvq.vq_assign(x, c, mxu_bf16=mxu_bf16))
    cf = c.to(io)
    xp, cp = (x.to(io).bfloat16(), cf.bfloat16()) if mxu_bf16 else (x, c)
    assert _rule_ok(xp, cp, got[0], c2_from=cf)
    mins = tvv.make_assign(512, mxu_bf16, io, argmin=False)(x, c)
    assert tvv.make_assign.last_path == ("mma" if mxu_bf16 else "resident")
    ref = tvv.assign_reference(x, c, mxu_bf16, io, argmin=False)
    diff = (mins.long() - ref.long()).abs()
    assert diff.max() <= 1 and (diff != 0).sum() <= x.shape[0] // 1000


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_row_variant_paths_on_card(cuda_device, shape):
    """Each shape on the path rows_path names, by the float64 rule; integer
    inputs give the plain version exactly, ties and all."""
    x, c = (t(a).to(cuda_device) for a in _data(shape, seed=31))
    for mxu in (False, True):
        idx = tvv.make_assign(512, mxu)(x, c)
        assert tvv.make_assign.last_path == tvv.rows_path(*shape, mxu)
        xp, cp = (x.bfloat16(), c.bfloat16()) if mxu else (x, c)
        assert _rule_ok(xp, cp, idx, c2_from=c)
    xi, ci = _integer_inputs(cuda_device)
    for mxu in (False, True):
        assert torch.equal(tvv.make_assign(128, mxu)(xi, ci),
                           tvv.assign_reference(xi, ci, mxu))


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16,io", [(False, torch.float32),
                                         (True, torch.float32),
                                         (True, torch.bfloat16)])
def test_transposed_variant_at_every_tile_on_card(cuda_device, mxu_bf16, io):
    """K7 gives the same indices at every TPU tile; its float32 indices
    equal K5's float32 indices (the same fmaf chains); its rounded variants
    run on the tensor-core path and hold the float64 rule."""
    x, c = (t(a).to(cuda_device) for a in _data((131072, 128, 256),
                                                 seed=28))
    xt = x.t().contiguous()
    got = [tvv.make_assign_t(tile, mxu_bf16, io, True)(xt, c)
           for tile in (512, 1024, 2048, 4096)]
    assert tvv.make_assign_t.last_path == ("mma" if mxu_bf16 else
                                           "resident")
    torch.cuda.synchronize()
    assert all(torch.equal(got[0], g) for g in got[1:])
    if not mxu_bf16:
        assert torch.equal(got[0], tvq.vq_assign(x, c))
    cf = c.to(io)
    xp, cp = (x.to(io).bfloat16(), cf.bfloat16()) if mxu_bf16 else (x, c)
    assert _rule_ok(xp, cp, got[0], c2_from=cf)
