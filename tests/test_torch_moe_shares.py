"""The port's SkewShares MoE dispatch planner against the JAX package:
`plan_dispatch` field for field, `route_tokens` and the multiply-shift
hash bit for bit, and the reference's own tests mirrored on the port."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _hypothesis_stub import given, settings, st
from repro.core import moe_shares as jms
from repro_torch.core.moe_shares import (dispatch_cost, multiply_shift_torch,
                                         plan_dispatch, route_tokens,
                                         shares_split)

LOADS = {
    "uniform8": (np.full(8, 100.0), 8),
    "uniform8x2": (np.ones(8), 16),
    "hot": (np.array([1000.0] + [10.0] * 7), 16),
    "two_hot": (np.array([500.0, 400.0] + [10.0] * 6), 13),
    "zero_loads": (np.zeros(4), 8),
    "pareto": (np.random.default_rng(3).pareto(1.2, 64) * 100 + 1, 128),
}


def _assert_same_plan(got, want):
    assert (got.n_experts, got.n_slots, got.max_group) == \
        (want.n_experts, want.n_slots, want.max_group)
    for f in ("slots_of_expert", "group_size", "slot_to_expert"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", sorted(LOADS))
def test_plan_dispatch_matches_reference(case):
    loads, n_slots = LOADS[case]
    got, want = plan_dispatch(loads, n_slots), jms.plan_dispatch(loads, n_slots)
    _assert_same_plan(got, want)
    np.testing.assert_array_equal(got.expected_slot_loads(loads),
                                  want.expected_slot_loads(loads))
    assert dispatch_cost(loads, got, 100.0) == \
        jms.dispatch_cost(loads, want, 100.0)


def _plan_with_max_group(g):
    plans = {1: (np.ones(8), 8), 2: (np.ones(8), 16),
             4: (np.array([1000.0] + [10.0] * 7), 11)}
    loads, n_slots = plans[g]
    plan = plan_dispatch(loads, n_slots)
    assert plan.max_group == g
    return plan, jms.plan_dispatch(loads, n_slots)


@pytest.mark.parametrize("max_group", [1, 2, 4])
def test_route_tokens_matches_reference(max_group):
    """Token ids near 2^31 (and negative ones) wrap mod 2^32 before the
    top-bits shift."""
    plan, jplan = _plan_with_max_group(max_group)
    rng = np.random.default_rng(max_group)
    n = 4096
    experts = rng.integers(0, plan.n_experts, n).astype(np.int32)
    tokens = np.concatenate([
        np.arange(n // 4), 2**31 - 1 - np.arange(n // 4),
        rng.integers(2**30, 2**31 - 1, n // 4),
        rng.integers(-2**31, 0, n // 4)]).astype(np.int32)
    got = route_tokens(plan, torch.from_numpy(experts),
                       torch.from_numpy(tokens))
    want = np.asarray(jms.route_tokens(jplan, jnp.asarray(experts),
                                       jnp.asarray(tokens)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nbuckets", [1, 2, 4, 128, 2**16])
def test_multiply_shift_matches_reference(nbuckets):
    vals = np.array([0, 1, 7, 2**31 - 1, -1, -2**31, 123456789, 2**30],
                    np.int32)
    for seed in (0x85EBCA6B, 0x9E3779B1, 3):
        got = multiply_shift_torch(torch.from_numpy(vals), seed, nbuckets)
        want = np.asarray(jms.multiply_shift_jnp(jnp.asarray(vals), seed,
                                                 nbuckets))
        np.testing.assert_array_equal(got.numpy(), want)


def test_multiply_shift_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        multiply_shift_torch(torch.arange(4), 1, 6)


# -- the reference's tests (tests/test_moe_shares.py), on the port ----------

def test_uniform_loads_one_slot_each():
    plan = plan_dispatch(np.full(8, 100.0), 8)
    assert (plan.group_size == 1).all()
    assert (plan.slot_to_expert == np.arange(8)).all()


def test_hot_expert_gets_replicas():
    loads = np.array([1000.0] + [10.0] * 7)
    plan = plan_dispatch(loads, 16)
    assert plan.group_size[0] == 8
    assert plan.group_size[1:].max() == 1
    assert plan.expected_slot_loads(loads).max() <= 1000.0 / 8 + 1e-9


def test_classical_vs_skewshares_imbalance():
    rng = np.random.default_rng(0)
    loads = np.r_[[4096.0], rng.uniform(10, 60, 63)]
    c = dispatch_cost(loads, plan_dispatch(loads, 64), weight_cost=100)
    s = dispatch_cost(loads, plan_dispatch(loads, 128), weight_cost=100)
    assert c["max_slot_load"] == 4096.0
    assert s["max_slot_load"] <= c["max_slot_load"] / 16


def test_too_few_slots_raise():
    with pytest.raises(ValueError):
        plan_dispatch(np.ones(8), 4)


@settings(max_examples=20, deadline=None)
@given(e=st.integers(2, 64), spare_pow=st.integers(0, 3),
       seed=st.integers(0, 2**31 - 1))
def test_balance_property_and_reference_equality(e, spare_pow, seed):
    rng = np.random.default_rng(seed)
    loads = rng.pareto(1.2, size=e) * 100 + 1
    n_slots = e * (1 << spare_pow)
    plan = plan_dispatch(loads, n_slots)
    _assert_same_plan(plan, jms.plan_dispatch(loads, n_slots))
    assert plan.group_size.sum() <= n_slots
    assert (plan.group_size & (plan.group_size - 1)).max() == 0
    flat = plan.slots_of_expert[plan.slots_of_expert >= 0]
    assert len(np.unique(flat)) == len(flat)
    assert plan.expected_slot_loads(loads).max() <= loads.max() + 1e-9


def test_route_tokens_valid_and_balanced():
    plan = plan_dispatch(np.array([10000.0] + [100.0] * 15), 32)
    g0 = int(plan.group_size[0])
    assert g0 >= 8
    n = 50_000
    slots = route_tokens(plan, torch.zeros(n, dtype=torch.int32),
                         torch.arange(n, dtype=torch.int32)).numpy()
    valid_slots = plan.slots_of_expert[0, :g0]
    assert set(slots.tolist()) <= set(valid_slots.tolist())
    counts = np.bincount(slots, minlength=plan.n_slots)[valid_slots]
    assert counts.max() <= 1.3 * counts.mean()


def test_route_tokens_single_slot_expert():
    plan = plan_dispatch(np.full(4, 1.0), 4)
    slots = route_tokens(plan, torch.tensor([0, 1, 2, 3, 2]), torch.arange(5))
    np.testing.assert_array_equal(slots.numpy(), [0, 1, 2, 3, 2])


def test_shares_split_matches_reference_and_closed_form():
    for args in ((10**6, 10**4, 16), (10**5, 10**5, 16), (1, 10**6, 4)):
        assert shares_split(*args) == jms.shares_split(*args)
    x, y = shares_split(tokens=10**6, weight_cost=10**4, k=16)
    assert x * y == pytest.approx(16, rel=1e-9) and x > y
    assert shares_split(1, 10**6, 4) == (1.0, 4.0)
