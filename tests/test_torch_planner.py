"""The port's numpy planner and data copies vs the JAX package's.

HH sets, residual joins, Shares, k, route specs and LPT tables must be
equal for the same query, data and k; the synthetic generators must give
byte-identical arrays from the same seed."""
import numpy as np
import pytest

import repro.core as jcore
import repro.data as jdata
from repro.core.executor import _build_routes as jax_build_routes
from repro.core.executor import _route_specs as jax_route_specs
from repro.core.executor import quantize_capacity as jax_quantize
from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch.core.executor import (_build_routes, _route_specs,
                                       quantize_capacity)

# (query name, rows per relation, domain, skew, seed)
CASES = [
    ("two_way", 300, 40, {"B": 1.5}, 21),
    ("running_example", 200, 60, {"B": 1.2, "C": 1.2}, 3),
    ("chain4", 3000, 1 << 16, {"X2": 1.5}, 3),
    ("two_way", 2000, 1 << 12, {"B": 1.1}, 99),
]


def _queries(name):
    if name == "chain4":
        return jdata.chain_query(4), tdata.chain_query(4)
    return getattr(jcore, name)(), getattr(tcore, name)()


def _residual_view(plan):
    return [(rp.residual.combo.hh, rp.k_i, dict(rp.solution.shares),
             rp.solution.cost, rp.cube.attr_order, rp.cube.shares,
             rp.cube.offset, rp.cube.salt) for rp in plan.residuals]


@pytest.mark.parametrize("name,n,domain,skew,seed", CASES)
@pytest.mark.parametrize("k", [8, 64, 256])
def test_plan_matches_jax(name, n, domain, skew, seed, k):
    jq, tq = _queries(name)
    data = tdata.skewed_join_dataset(tq, n, domain, skew=skew, seed=seed)
    jplan = jcore.plan_skew_join(jq, data, k)
    tplan = tcore.plan_skew_join(tq, data, k)
    assert tplan.k == jplan.k
    assert dict(tplan.hhs.per_attr) == dict(jplan.hhs.per_attr)
    assert _residual_view(tplan) == _residual_view(jplan)
    t_specs = {r: _route_specs(x) for r, x in _build_routes(tplan).items()}
    j_specs = {r: jax_route_specs(x)
               for r, x in jax_build_routes(jplan).items()}
    assert t_specs == j_specs
    loads = tplan.cell_loads(data)
    np.testing.assert_array_equal(loads, jplan.cell_loads(data))
    np.testing.assert_array_equal(
        tcore.lpt_placement(loads, 8).table, jcore.lpt_placement(loads, 8).table)
    np.testing.assert_array_equal(
        tcore.modulo_placement(k, 8).table, jcore.modulo_placement(k, 8).table)


@pytest.mark.parametrize("name,n,domain,skew,seed", CASES)
def test_datasets_and_reference_match(name, n, domain, skew, seed):
    jq, tq = _queries(name)
    tq_data = tdata.skewed_join_dataset(tq, n, domain, skew=skew, seed=seed)
    jq_data = jdata.skewed_join_dataset(jq, n, domain, skew=skew, seed=seed)
    for rel in tq.relations:
        np.testing.assert_array_equal(tq_data[rel.name], jq_data[rel.name])
    small = {r: a[:150] for r, a in tq_data.items()}
    np.testing.assert_array_equal(tcore.reference_join(tq, small),
                                  jcore.reference_join(jq, small))


def test_drifting_batch_matches_jax():
    kw = dict(n=5000, hh_rows=300, tail_domain=700, hot_set=(3, 9),
              hot_bonus=20, seed=4, extra_hh={"B": 200})
    got = tdata.drifting_join_batch(tcore.two_way(), **kw)
    want = jdata.drifting_join_batch(jcore.two_way(), **kw)
    for rel in ("R", "S"):
        np.testing.assert_array_equal(got[rel], want[rel])


def test_hashing_and_capacity_grid_match_jax():
    for attr, salt in [("A", 0), ("B", 3), ("X12", 7)]:
        assert tcore.hash_seed(attr, salt) == jcore.hash_seed(attr, salt)
    vals = np.arange(-1, 5000, 7)
    for share in (1, 2, 64, 1024):
        np.testing.assert_array_equal(
            tcore.multiply_shift(vals, tcore.hash_seed("B", 1), share),
            jcore.multiply_shift(vals, jcore.hash_seed("B", 1), share))
    for cap in (0, 1, 2, 3, 5, 100, 4097, 131071):
        for ratio in (0.5, 1.5, 2.0):
            assert quantize_capacity(cap, ratio) == jax_quantize(cap, ratio)
