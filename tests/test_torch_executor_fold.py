"""`tests/test_fold.py`'s explicit placements through the port, n_dev = 8:
two residuals' cells forced onto one device, every cell on device 0, and
k = 512 (64 cells a device) for the two-way join and the running example.

Each case runs under every `ExecutorConfig` arm and, on fused + hash, under
the chunked exchange (overlap_shuffle = 3), and must equal the JAX session
(8 virtual devices) under the same placement and C: its six `BatchResult`
fields, caps and placement strategy; canonically, `reference_join`."""
import functools

import numpy as np
import pytest

from _torch_port_cases import ARMS, N_DEV, assert_same_result
from repro.core import CellPlacement as JaxPlacement
from repro.core import plan_skew_join as jax_plan
from repro.core import running_example as jax_running_example
from repro.core import two_way as jax_two_way
from repro.core.executor import ExecutorConfig as JaxConfig
from repro.core.executor import ShardedJoinExecutor as JaxExecutor
from repro.launch.mesh import make_mesh_compat
from repro_torch.core import (CellPlacement, canonical, plan_skew_join,
                              reference_join, running_example, two_way)
from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
from repro_torch.data import skewed_join_dataset

# name -> (query, rows, domain, skew, seed, k, planner kwargs, placement,
# out_capacity): test_fold.py's cases.
CASES = {
    "cross_residual_cells_on_device_0": (
        "two_way", 600, 30, {"B": 1.9}, 33, 32, {}, "two_residuals", 1 << 18),
    "all_cells_on_device_0": (
        "two_way", 400, 40, {"B": 1.7}, 34, 32, {}, "zeros", 1 << 18),
    "two_way_k512": (
        "two_way", 600, 40, {"B": 1.9}, 31, 64 * N_DEV, {}, None, 1 << 18),
    "running_example_k512": (
        "running_example", 100, 50, {"B": 1.5, "C": 1.2}, 32, 64 * N_DEV,
        {"max_hh_per_attr": 3}, None, 1 << 16),
}
QUERIES = {"two_way": (two_way, jax_two_way),
           "running_example": (running_example, jax_running_example)}
# The port's runs: every arm serially, and fused + hash chunked (C = 3).
RUNS = [(arm, 0) for arm in ARMS] + [("fused+hash", 3)]


@functools.lru_cache(maxsize=None)
def _case(name):
    qname, n, domain, skew, seed, k, kw, how, _ = CASES[name]
    data = skewed_join_dataset(QUERIES[qname][0](), n, domain, skew=skew,
                               seed=seed)
    plan = plan_skew_join(QUERIES[qname][0](), data, k, **kw)
    table = None
    if how == "two_residuals":
        assert len(plan.residuals) >= 2
        table = np.arange(k, dtype=np.int32) % N_DEV
        c0 = plan.residuals[0].cube.offset % k
        c1 = plan.residuals[1].cube.offset % k
        assert c0 != c1
        table[c0] = table[c1] = 0
    elif how == "zeros":
        table = np.zeros(k, np.int32)
    return data, plan, table


@functools.lru_cache(maxsize=None)
def _jax_run(name, chunks):
    """The JAX session's caps, placement strategy and first result, on
    its plain path (`use_kernels=False`, which the JAX package pins
    bit-equal to its Pallas kernels in interpret mode, and is faster)."""
    qname, _, _, _, _, k, kw, _, cap_out = CASES[name]
    data, _, table = _case(name)
    plan = jax_plan(QUERIES[qname][1](), data, k, **kw)
    ex = JaxExecutor(plan, make_mesh_compat((N_DEV,), ("cells",)),
                     config=JaxConfig(out_capacity=cap_out,
                                      overlap_shuffle=chunks,
                                      use_kernels=False))
    placement = None if table is None else JaxPlacement(table, N_DEV)
    s = ex.session().prepare(data, placement=placement)
    res = s.run_batch()
    return (dict(s.caps), s.placement.strategy,
            {key: np.asarray(res[key]) for key in res})


@pytest.mark.parametrize("arm,chunks", RUNS,
                         ids=[f"{a}-C{c}" for a, c in RUNS])
@pytest.mark.parametrize("name", list(CASES))
def test_explicit_placements_match_jax(name, arm, chunks):
    qname, _, _, _, _, _, _, how, cap_out = CASES[name]
    data, plan, table = _case(name)
    ex = ShardedJoinExecutor(plan, N_DEV, ExecutorConfig(
        out_capacity=cap_out, overlap_shuffle=chunks, **ARMS[arm]),
        device="cpu")
    placement = None if table is None else CellPlacement(table, N_DEV)
    s = ex.session().prepare(data, placement=placement)
    res = s.run_batch()
    caps, strategy, want = _jax_run(name, chunks)
    assert s.caps == caps
    assert s.placement.strategy == strategy == (
        "lpt" if table is None else "explicit")
    assert_same_result(res, want)
    assert int(res["shuffle_overflow"].sum()) == 0
    assert int(res["join_overflow"].sum()) == 0
    np.testing.assert_array_equal(canonical(res["rows"][res["valid"]]),
                                  reference_join(QUERIES[qname][0](), data))
    if how == "zeros":
        assert (res["recv_counts"][1:] == 0).all()
        assert res["recv_counts"][0] > 0
