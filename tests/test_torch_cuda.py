"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit (`nvcc`) and
skips without one.  Run them on the GPU machine with
`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`.
Outputs are int32 data-plane values, so the bar is bit equality.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (canonical, plan_skew_join, reference_join,
                              running_example, two_way)
from repro_torch.core.executor import (ExecutorConfig, ShardedJoinExecutor,
                                       _build_routes, _route_specs)
from repro_torch.data import chain_query, skewed_join_dataset
from repro_torch.kernels import join_probe as jp
from repro_torch.kernels import map_pack as mp
from repro_torch.kernels import ops
from repro_torch.kernels import scatter_pack as sp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(rng, n, w, domain, invalid_frac=0.1):
    rows = rng.integers(0, domain, size=(n, w)).astype(np.int32)
    rows[rng.random(n) < invalid_frac] = -1
    return rows


def _specs(k, skew_attr="B"):
    q = two_way()
    data = skewed_join_dataset(q, 600, 50, skew={skew_attr: 1.6}, seed=5)
    plan = plan_skew_join(q, data, k)
    return {n: _route_specs(r) for n, r in _build_routes(plan).items()}


def _eq(a, b):
    assert a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _synthetic_specs(k):
    """One hashed route of fanout 2 with a not-in constraint."""
    return {"T": ((((0, 0x9E3779B1, k // 2, 1),), (0, k // 2), 0, (),
                   ((1, (7, 13)),)),)}


@pytest.mark.parametrize("k,n,make_specs", [
    (8, 0, _specs), (8, 5, _specs), (64, 1000, _specs), (256, 40000, _specs),
    (16384, 50000, _synthetic_specs)])
def test_map_count_kernel(dev, k, n, make_specs):
    """k > 8192 takes the kernel's global-atomics path."""
    rng = np.random.default_rng(k + n)
    specs = make_specs(k)
    for name, routes in specs.items():
        rows = torch.from_numpy(_rows(rng, n, 2, 50)).to(dev)
        got = ops.map_count(rows, routes, k, 8)
        _eq(got, mp.map_count_host(rows, routes, k, 8))


@pytest.mark.parametrize("k,n_loc,cap", [(8, 1, 4), (64, 700, 8),
                                         (256, 5000, 4096), (8, 0, 2)])
def test_scatter_pack_kernel(dev, k, n_loc, cap):
    rng = np.random.default_rng(k * n_loc + cap)
    specs = _specs(k)
    ptable = torch.from_numpy(rng.integers(0, 8, k).astype(np.int32)).to(dev)
    for routes in specs.values():
        rows = torch.from_numpy(_rows(rng, 8 * n_loc, 2, 50)).to(dev)
        rows = rows.view(8, n_loc, 2)
        buf, over = ops.scatter_pack(rows, routes, ptable, k, 8, cap)
        buf_h, over_h = sp.scatter_pack_host(rows, routes, ptable, k, 8, cap)
        _eq(buf, buf_h)
        _eq(over, over_h)


@pytest.mark.parametrize("b,n,w,bits", [(1, 0, 2, 4), (3, 1000, 2, 1),
                                        (8, 5000, 3, 5), (2, 70000, 2, 16)])
def test_hash_and_build_kernels(dev, b, n, w, bits):
    rng = np.random.default_rng(n + bits)
    keys = torch.from_numpy(rng.integers(-1, 30, size=(b, n, w))
                            .astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random((b, n)) > 0.2).to(dev)
    _eq(ops.join_hash(keys, valid, bits), jp.join_hash_host(keys, valid, bits))
    for got, want in zip(ops.build_table(keys, valid, bits),
                         jp.build_table_host(keys, valid, bits)):
        _eq(got, want)


@pytest.mark.parametrize("b,n_l,n_r,cap", [(1, 1, 1, 4), (4, 300, 200, 5000),
                                           (8, 3000, 2500, 20000)])
def test_expand_rows_kernel(dev, b, n_l, n_r, cap):
    rng = np.random.default_rng(n_l + cap)
    lk = torch.from_numpy(rng.integers(0, 40, (b, n_l, 1)).astype(np.int32))
    rk = torch.from_numpy(rng.integers(0, 40, (b, n_r, 1)).astype(np.int32))
    lk, rk = lk.to(dev), rk.to(dev)
    lv = torch.ones((b, n_l), dtype=torch.bool, device=dev)
    rv = torch.from_numpy(rng.random((b, n_r)) > 0.1).to(dev)
    bits = jp.default_bits(n_r)
    bl = jp.join_hash_host(lk, lv, bits)
    br, rank, hist = jp.build_table_host(rk, rv, bits)
    counts, lo, perm = jp.probe_tables(lk, bl, rk, br, rank, hist, bits)
    left = torch.cat([lk, lk + 100], -1)
    right = torch.cat([rk, rk * 3], -1)
    got = ops.expand_rows(left, right, counts, lo, perm, cap)
    want = sp.expand_rows_host(left, right, counts, lo, perm, cap)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("q,skew,k", [
    (two_way(), {"B": 1.5}, 64),
    (running_example(), {"B": 1.2, "C": 1.2}, 256),
    (chain_query(4), {"X2": 1.2}, 64),
])
def test_executor_on_card(dev, q, skew, k):
    data = skewed_join_dataset(q, 200, 60, skew=skew, seed=3)
    plan = plan_skew_join(q, data, k)
    results = []
    for use_kernels in (True, False):
        cfg = ExecutorConfig(out_capacity=1 << 17, use_kernels=use_kernels)
        ops.reset_launches()
        ex = ShardedJoinExecutor(plan, 8, cfg, device=dev)
        res = ex.session().prepare(data).run_batch()
        assert res["shuffle_overflow"].sum() == 0
        assert res["join_overflow"].sum() == 0
        results.append(res)
        launched = all(ops.LAUNCHES[name] > 0 for name in ops.KERNELS)
        assert launched == use_kernels, ops.LAUNCHES
    kern, plain = results
    for key in kern:
        np.testing.assert_array_equal(kern[key], plain[key])
    np.testing.assert_array_equal(
        canonical(kern["rows"][kern["valid"]]), reference_join(q, data))
