"""forest_tpu_torch.ops.scatter against forest_tpu.ops.scatter.

``scatter_add_rows`` (on the CPU its plain version, ``index_add_`` per
sample), ``extract_rows`` and ``extract_at_coords`` are held to the JAX
package on the same seeded inputs with duplicated indices: to its XLA path
and to the Pallas kernel in interpret mode (as tests/test_scatter_op.py runs
it), in value and in gradient. The CUDA kernel is held to the plain
version on a card (``cuda`` marker): in value, bit for bit between two runs
and on data whose sums are exact, and in what an index out of range does.

Tolerance, float32: rtol 1e-6 / atol 1e-5 -- rows that share a destination
are summed in another order (the bound tests/test_scatter_op.py uses).
Integer-valued data is compared exactly.
"""
from types import SimpleNamespace


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.ops import scatter as jsc
from forest_tpu_torch.ops import scatter as tsc
from torch_parity import cuda_device, t, ti  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-5)
# (B, N, C, R): odd C and small N; a 2048-multiple R with C 48
CASES = [(3, 500, 7, 8192), (2, 300, 48, 4096), (1, 64, 5, 2048)]


def _case(rng, b, n, c, r, dup_frac=0.25):
    idx = rng.integers(0, r, size=(b, n)).astype(np.int32)
    ndup = int(n * dup_frac)
    idx[:, :ndup] = idx[:, ndup:2 * ndup]        # guaranteed duplicates
    return idx, rng.normal(size=(b, n, c)).astype(np.float32)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("b,n,c,r", CASES)
def test_scatter_add_rows_matches_jax(b, n, c, r, interpret):
    idx, dz = _case(np.random.default_rng(n), b, n, c, r)
    ref = jsc.scatter_add_rows(jnp.asarray(dz), jnp.asarray(idx), r,
                               use_pallas=interpret, interpret=interpret)
    before = tsc.scatter_add_rows.launches
    out = tsc.scatter_add_rows(t(dz), ti(idx), r)
    assert tsc.scatter_add_rows.launches == before   # CPU: plain version
    assert out.shape == (b, r, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_heavy_duplicates_match_jax():
    rng = np.random.default_rng(1)
    b, n, c, r = 2, 300, 5, 4096
    idx = rng.choice([5, 6, 2050, 2060], size=(b, n)).astype(np.int32)
    dz = rng.normal(size=(b, n, c)).astype(np.float32)
    ref = jsc.scatter_add_rows(jnp.asarray(dz), jnp.asarray(idx), r,
                               use_pallas=False)
    out = tsc.scatter_add_rows(t(dz), ti(idx).int(), r)
    # ~75 rows per destination: atol 1e-4 as in tests/test_scatter_op.py
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("interpret", [False, True])
def test_extract_at_coords_value_and_gradient_match_jax(interpret):
    rng = np.random.default_rng(2)
    b, h, w, c, n = 2, 32, 64, 6, 200            # H*W = 2048
    grid = rng.normal(size=(b, h, w, c)).astype(np.float32)
    coords = np.stack([rng.integers(0, h, size=(b, n)),
                       rng.integers(0, w, size=(b, n))], -1).astype(np.int32)
    coords[:, :50] = coords[:, 50:100]            # duplicates
    wgt = rng.normal(size=(b, n, c)).astype(np.float32)

    def loss(g):
        z = jsc.extract_at_coords(g, jnp.asarray(coords),
                                  use_pallas=interpret, interpret=interpret)
        return jnp.sum(z * jnp.asarray(wgt)), z

    (_, zref), gref = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(grid))
    tg = t(grid).requires_grad_(True)
    z = tsc.extract_at_coords(tg, ti(coords))
    np.testing.assert_array_equal(z.detach().numpy(), np.asarray(zref))
    (z * t(wgt)).sum().backward()
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(gref), **TOL)


def test_extract_rows_gradient_takes_the_grid_dtype():
    grid = torch.randn(2, 16, 3, dtype=torch.float64, requires_grad=True)
    idx = torch.tensor([[0, 3, 3], [15, 15, 1]])
    tsc.extract_rows(grid, idx).sum().backward()
    assert grid.grad.dtype == torch.float64
    assert grid.grad[0, 3].tolist() == [2.0] * 3
    assert grid.grad[1, 15].tolist() == [2.0] * 3


@pytest.mark.parametrize("bad", [-1, 16])
def test_index_out_of_range_raises(bad):
    idx = torch.tensor([[0, bad, 2]])
    with pytest.raises(IndexError, match="outside"):
        tsc.scatter_add_rows(torch.ones(1, 3, 2), idx, 16)


def _integer_case(rng, b, n, c, r, dests):
    """Small integers on a few destinations: every sum is exact in float32
    whatever its order."""
    idx = rng.choice(dests, size=(b, n)).astype(np.int64)
    dz = rng.integers(-3, 4, size=(b, n, c)).astype(np.float32)
    want = np.zeros((b, r, c), np.float32)
    for i in range(b):
        np.add.at(want[i], idx[i], dz[i])
    return idx, dz, want


# the last three: more indices than one scan step of the kernel takes
# (2,048), and rows wider than one block's 256 vectors, whole and ragged
EXACT_CASES = [(2, 300, 5, 4099), (1, 64, 48, 16), (3, 40, 7, 131),
               (2, 5000, 8, 300), (1, 30, 4100, 50), (1, 30, 1030, 50)]


@pytest.mark.parametrize("b,n,c,r", EXACT_CASES)
def test_reference_adds_duplicates_exactly(b, n, c, r):
    idx, dz, want = _integer_case(np.random.default_rng(n + c), b, n, c, r,
                                  [0, 5, 6, r - 1])
    out = tsc.scatter_add_rows_reference(t(dz), ti(idx), r)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(
        tsc.scatter_add_rows(t(dz), ti(idx).int(), r).numpy(), want)


def test_reference_adds_in_ascending_j():
    """1e8 + 1 - 1e8 in float32 is 0 when added in ascending j (the 1 is
    lost in the first sum) and 1 in any order that pairs the large terms
    first."""
    dz = torch.tensor([[[1e8], [1.0], [-1e8], [3.0]]])
    idx = torch.tensor([[2, 2, 2, 0]])
    out = tsc.scatter_add_rows_reference(dz, idx, 4)
    assert out[0, :, 0].tolist() == [3.0, 0.0, 0.0, 0.0]
    assert float(np.float32(np.float32(1e8 + 1.0) - 1e8)) == 0.0


def test_check_index_false_still_checks_on_cpu():
    with pytest.raises(IndexError, match="outside"):
        tsc.scatter_add_rows(torch.ones(1, 3, 2), torch.tensor([[0, 16, 2]]),
                             16, check_index=False)


@pytest.mark.parametrize("bad", [-1, 16])
def test_extract_rows_backward_raises_on_bad_index_on_cpu(bad):
    """The backward skips the host's check only on a card; on the CPU a bad
    index still raises (the forward's gather would have refused it first,
    so the op's registered backward is called here by hand)."""
    ctx = SimpleNamespace(saved_tensors=(torch.tensor([[0, bad, 2]]),),
                          n_rows=16, grid_dtype=torch.float32)
    with pytest.raises(IndexError, match="outside"):
        tsc._extract_rows_backward(ctx, torch.ones(1, 3, 2))
    grid = torch.zeros(1, 16, 2, requires_grad=True)
    with pytest.raises((IndexError, RuntimeError)):
        tsc.extract_rows(grid, torch.tensor([[0, bad, 2]])).sum().backward()


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="must be"):
        tsc.scatter_add_rows(torch.ones(3, 2), torch.zeros(3, 2).long(), 4)
    with pytest.raises(TypeError, match="int32 or int64"):
        tsc.scatter_add_rows(torch.ones(1, 3, 2), torch.zeros(1, 3), 4)
    with pytest.raises(ValueError, match="no kernel"):
        tsc.scatter_add_rows(torch.ones(1, 3, 2, device="meta"),
                             torch.zeros(1, 3, device="meta").long(), 4)


# ---------------------------------------------------------------- on a card
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,r", CASES + [(2, 2012, 48, 65536),
                                             (3, 77, 5, 131)])
def test_kernel_matches_plain_version_on_card(cuda_device, b, n, c, r):
    idx, dz = _case(np.random.default_rng(5), b, n, c, r)
    idx, dz = ti(idx).to(cuda_device), t(dz).to(cuda_device)
    before = tsc.scatter_add_rows.launches
    out = tsc.scatter_add_rows(dz, idx, r)
    torch.cuda.synchronize()
    assert tsc.scatter_add_rows.launches == before + 1
    ref = tsc.scatter_add_rows_reference(dz, idx, r)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,r", CASES + [(12, 2012, 48, 65536)])
def test_kernel_runs_are_bit_identical_on_card(cuda_device, b, n, c, r):
    idx, dz = _case(np.random.default_rng(6), b, n, c, r)
    idx, dz = ti(idx).to(cuda_device), t(dz).to(cuda_device)
    first = tsc.scatter_add_rows(dz, idx, r)
    again = tsc.scatter_add_rows(dz, idx.int(), r, check_index=False)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,r", EXACT_CASES + [(2, 3000, 8, 70000)])
def test_kernel_is_exact_on_integer_data_on_card(cuda_device, b, n, c, r):
    """Heavy duplicates (n / 4 rows per destination) on the vector and the
    scalar path, over several scan steps and several blocks per row, bit
    for bit."""
    idx, dz, want = _integer_case(np.random.default_rng(n + c), b, n, c, r,
                                  [0, 5, 6, r - 1])
    out = tsc.scatter_add_rows(t(dz).to(cuda_device), ti(idx).to(cuda_device),
                               r)
    np.testing.assert_array_equal(out.cpu().numpy(), want)


@pytest.mark.cuda
def test_bad_index_on_card(cuda_device):
    """The public form raises; the unchecked form leaves the rows out."""
    idx, dz, _ = _integer_case(np.random.default_rng(3), 2, 50, 8, 64,
                               [1, 2, 63])
    idx[0, 4], idx[1, 0], idx[1, 49] = 64, -1, 10 ** 6
    dz_d, idx_d = t(dz).to(cuda_device), ti(idx).to(cuda_device)
    with pytest.raises(IndexError, match="outside"):
        tsc.scatter_add_rows(dz_d, idx_d, 64)
    out = tsc.scatter_add_rows(dz_d, idx_d, 64, check_index=False)
    ok = (idx >= 0) & (idx < 64)
    want = tsc.scatter_add_rows_reference(t(dz * ok[:, :, None]),
                                          ti(np.where(ok, idx, 0)), 64)
    np.testing.assert_array_equal(out.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_extract_at_coords_backward_launches_the_kernel_on_card(cuda_device):
    grid = torch.randn(2, 8, 8, 4, device=cuda_device, requires_grad=True)
    coords = torch.randint(0, 8, (2, 20, 2), device=cuda_device)
    before = tsc.scatter_add_rows.launches
    tsc.extract_at_coords(grid, coords).sum().backward()
    assert tsc.scatter_add_rows.launches == before + 1
    with pytest.raises(IndexError):
        tsc.scatter_add_rows(torch.ones(2, 20, 4, device=cuda_device),
                             coords[..., 0] + 100, 64)
