"""`segment_histogram` (the MoE layer's expert loads) in the port against
the JAX package: the port's plain version and oracle against the JAX
Pallas kernel (interpret mode on the CPU) and the JAX oracle.  Counts are
int32, so the bar is exact equality."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _hypothesis_stub import given, settings, st
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_histogram as sh


def _jax(vals: np.ndarray, n_bins: int):
    """(JAX Pallas kernel, JAX oracle) on vals, as numpy."""
    v = jnp.asarray(vals)
    return (np.asarray(jops.segment_histogram(v, n_bins)),
            np.asarray(jref.segment_histogram_ref(v.reshape(-1), n_bins)))


def _port(vals: np.ndarray, n_bins: int):
    """(port's plain version through ops, port's oracle) on vals."""
    t = torch.from_numpy(vals)
    return (ops.segment_histogram(t, n_bins).numpy(),
            ref.segment_histogram_ref(t.reshape(-1), n_bins).numpy())


def _assert_all_equal(vals, n_bins):
    kern, oracle = _jax(vals, n_bins)
    plain, port_oracle = _port(vals, n_bins)
    for got in (plain, port_oracle):
        assert got.dtype == np.int32 and got.shape == (n_bins,)
        np.testing.assert_array_equal(got, kern)
        np.testing.assert_array_equal(got, oracle)
    return plain


@pytest.mark.parametrize("shape", [(64,), (7, 9), (2, 3, 100), (5000,)])
@pytest.mark.parametrize("n_bins", [1, 8, 384])
def test_matches_jax_kernel_and_oracle(shape, n_bins):
    """The grid of the JAX package's own kernel test, values in
    [-2, n_bins + 3) so both ends drop."""
    rng = np.random.default_rng(42)
    vals = rng.integers(-2, n_bins + 3, size=shape).astype(np.int32)
    got = _assert_all_equal(vals, n_bins)
    inside = vals[(vals >= 0) & (vals < n_bins)]
    assert got.sum() == inside.size


@pytest.mark.parametrize("dtype", [np.int64, np.int16, np.int8, np.uint8])
def test_other_integer_dtypes_cast_to_int32(dtype):
    rng = np.random.default_rng(7)
    vals = rng.integers(-2, 11, size=(3, 333)).clip(
        np.iinfo(dtype).min, np.iinfo(dtype).max).astype(dtype)
    _assert_all_equal(vals, 8)


def test_int64_values_wrap_to_their_int32_bits():
    """The cast is a plain astype: 2^32 + 3 counts as 3 and 2^31 as -2^31
    (dropped), as in the reference's `_flatten_pad`."""
    vals = torch.tensor([2**32 + 3, 2**31, 3, -1, 2**33], dtype=torch.int64)
    want = np.zeros(8, np.int32)
    want[3], want[0] = 2, 1
    np.testing.assert_array_equal(ops.segment_histogram(vals, 8).numpy(),
                                  want)


@pytest.mark.parametrize("n_bins", [1, 8, 384])
def test_values_all_out_of_range(n_bins):
    vals = np.concatenate([np.full(700, -1), np.full(300, n_bins),
                           np.arange(-50, 0), np.arange(n_bins, n_bins + 50)]
                          ).astype(np.int32)
    got = _assert_all_equal(vals, n_bins)
    assert not got.any()


def test_every_value_in_one_bin():
    vals = np.full(4099, 5, np.int32)
    got = _assert_all_equal(vals, 8)
    assert got[5] == 4099 and got.sum() == 4099


def test_block_edges():
    """Sizes around the Pallas block of 1,024 (the pad of -1 must drop)."""
    rng = np.random.default_rng(3)
    for n in (1, 1023, 1024, 1025, 2048, 3073):
        _assert_all_equal(rng.integers(-1, 9, n).astype(np.int32), 8)


def test_empty_input_gives_zeros_where_the_pallas_kernel_raises():
    """The one known difference: on an empty input the JAX Pallas kernel
    raises TypeError (its block slice is larger than the operand); the JAX
    oracle and the port give zeros."""
    empty = np.zeros((0,), np.int32)
    with pytest.raises(TypeError, match="slice_sizes"):
        jops.segment_histogram(jnp.asarray(empty), 8)
    oracle = np.asarray(jref.segment_histogram_ref(jnp.asarray(empty), 8))
    plain, port_oracle = _port(empty, 8)
    np.testing.assert_array_equal(plain, np.zeros(8, np.int32))
    np.testing.assert_array_equal(plain, oracle)
    np.testing.assert_array_equal(port_oracle, oracle)
    assert plain.dtype == np.int32


@pytest.mark.parametrize("bad", [torch.zeros(4), torch.zeros(4).double(),
                                 torch.zeros(4, dtype=torch.bool)])
def test_rejects_non_integer_values(bad):
    with pytest.raises(TypeError):
        ops.segment_histogram(bad, 8)
    with pytest.raises(TypeError):
        sh.segment_histogram_host(bad, 8)


@pytest.mark.parametrize("n_bins", [0, -3])
def test_rejects_fewer_than_one_bin(n_bins):
    with pytest.raises(ValueError, match="n_bins"):
        ops.segment_histogram(torch.arange(4), n_bins)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    ops.reset_launches()
    vals = torch.arange(-3, 20, dtype=torch.int32)
    for use_kernels in (True, False):
        got = ops.segment_histogram(vals, 8, use_kernels=use_kernels)
        np.testing.assert_array_equal(got.numpy(), np.ones(8, np.int32))
    assert ops.LAUNCHES["segment_histogram"] == 0
    assert "segment_histogram" in ops.KERNELS


def test_cuda_wrapper_refuses_a_cpu_tensor():
    from repro_torch.kernels._build import KernelError
    with pytest.raises(KernelError, match="CUDA"):
        sh.segment_histogram_cuda(torch.arange(4), 8)


@settings(max_examples=12, deadline=None)
@given(n=st.integers(1, 3000), n_bins=st.integers(1, 600),
       seed=st.integers(0, 2**31 - 1))
def test_property_matches_jax_oracle_and_numpy(n, n_bins, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-3, n_bins + 3, n).astype(np.int32)
    plain, port_oracle = _port(vals, n_bins)
    oracle = np.asarray(jref.segment_histogram_ref(jnp.asarray(vals), n_bins))
    want = np.bincount(vals[(vals >= 0) & (vals < n_bins)],
                       minlength=n_bins)
    for got in (plain, port_oracle):
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(got, want)


_CLUSTER_BINS = sh.CLUSTER_BLOCKS * sh.CLUSTER_BLOCK_BINS


@pytest.mark.parametrize("n,n_bins,want", [
    (1, 8, (sh.SH_ONE, 1, 32)),                   # a decode call's shape
    (16, 8, (sh.SH_ONE, 1, 32)),
    (16384, 8, (sh.SH_ONE, 1, 1024)),             # a prefill call's
    (1024, 384, (sh.SH_ONE, 1, 256)),
    (sh.ONE_BLOCK_VALUES, sh.SHARED_BINS, (sh.SH_ONE, 1, 1024)),
    (sh.ONE_BLOCK_VALUES + 1, 8,
     (sh.SH_GRID, -(-(sh.ONE_BLOCK_VALUES + 1) // (8 * sh.GRID_THREADS)),
      sh.GRID_THREADS)),
    (1 << 24, 384, (sh.SH_GRID, sh.MAX_GRID_BLOCKS, sh.GRID_THREADS)),
    (5, sh.SHARED_BINS + 1,
     (sh.SH_CLUSTER, sh.CLUSTER_BLOCKS, sh.CLUSTER_THREADS)),
    (1 << 18, 1 << 16, (sh.SH_CLUSTER, 4 * sh.CLUSTER_BLOCKS,
                        sh.CLUSTER_THREADS)),
    (1 << 30, 1 << 16, (sh.SH_CLUSTER, sh.MAX_CLUSTERS * sh.CLUSTER_BLOCKS,
                        sh.CLUSTER_THREADS)),
    (1 << 24, 1 << 18, (sh.SH_CLUSTER, sh.MAX_CLUSTERS // 2
                        * sh.CLUSTER_BLOCKS, sh.CLUSTER_THREADS)),
    (1 << 17, _CLUSTER_BINS,
     (sh.SH_CLUSTER, sh.CLUSTER_BLOCKS, sh.CLUSTER_THREADS)),
    (1 << 20, _CLUSTER_BINS + 1, (sh.SH_GLOBAL, 512, sh.GRID_THREADS)),
])
def test_histogram_plan_picks_each_arm(n, n_bins, want):
    """Few values and bins in one block's shared memory: one block, no
    memset (the decode and prefill calls); more values: the grid; bins
    past one block: a cluster per n_bins values, at most MAX_CLUSTERS (half
    as many past 2^17 bins, one block an SM); bins past a cluster: device
    atomics."""
    assert sh.histogram_plan(n, n_bins) == want
