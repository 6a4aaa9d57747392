"""Port executor vs the JAX executor on R(A,B) ⋈ S(B,C), n_dev = 8."""
import numpy as np
import pytest

from _torch_port_cases import (ARMS, N_DEV, assert_same_result,
                               check_against_jax, jax_session)
from repro.core import two_way as jax_two_way
from repro_torch.core import plan_skew_join, two_way
from repro_torch.core.executor import (CapacityOverflowError, ExecutorConfig,
                                       ShardedJoinExecutor, session_from_numpy)
from repro_torch.core.placement import CellPlacement
from repro_torch.data import skewed_join_dataset


def _data():
    return skewed_join_dataset(two_way(), 300, 40, skew={"B": 1.5}, seed=21)


@pytest.mark.parametrize("k", [8, 64, 256])
def test_two_way_matches_jax(k):
    check_against_jax(jax_two_way(), two_way(), _data(), k)


def test_forced_overflow_matches_jax():
    """Tiny shuffle caps and output capacity: the same copies and results
    are dropped, and the per-(device, relation) counters agree."""
    data = _data()
    caps = {"R": 3, "S": 2}
    jplan, jex, js, jres = jax_session(jax_two_way(), data, 64, 16, caps=caps)
    assert int(jres["shuffle_overflow"].sum()) > 0
    assert int(jres["join_overflow"].sum()) > 0
    rels = [(r.name, r.attrs) for r in jplan.query.relations]
    s = session_from_numpy(rels, 64, N_DEV, jex.route_specs,
                           js.placement.table, caps, 16, device="cpu")
    assert_same_result(s.run_batch(data), jres)


def test_result_rows_raises_on_overflow():
    data = _data()
    plan = plan_skew_join(two_way(), data, 64)
    ex = ShardedJoinExecutor(plan, N_DEV, ExecutorConfig(out_capacity=16),
                             device="cpu")
    with pytest.raises(CapacityOverflowError) as err:
        ex.result_rows(data)
    assert err.value.join_overflow.sum() > 0
    assert err.value.relations == ("R", "S")


OTHER_ARMS = [arm for arm in ARMS if arm != "fused+hash"]


@pytest.mark.parametrize("arm", OTHER_ARMS)
@pytest.mark.parametrize("k", [8, 64, 256])
def test_two_way_arms_match_jax(arm, k):
    check_against_jax(jax_two_way(), two_way(), _data(), k, arm)


def test_two_way_staged_sort_matches_jax_staged_sort():
    """Against the reference's own staged + sort-merge session."""
    check_against_jax(jax_two_way(), two_way(), _data(), 64, "staged+sort",
                      {"fuse_map": False, "hash_reduce": False})


@pytest.mark.parametrize("arm", OTHER_ARMS)
def test_forced_overflow_arms_match_jax(arm):
    """Forced overflow under each other arm: the staged pack's ranks and
    the sort-merge probe drop the same copies and results as the
    reference's fused + hash session."""
    data = _data()
    caps = {"R": 3, "S": 2}
    jplan, jex, js, jres = jax_session(jax_two_way(), data, 64, 16, caps=caps)
    assert int(jres["shuffle_overflow"].sum()) > 0
    assert int(jres["join_overflow"].sum()) > 0
    placement = CellPlacement(np.asarray(js.placement.table, np.int32), N_DEV)
    ex = ShardedJoinExecutor.from_specs(
        two_way(), 64, jex.route_specs, N_DEV,
        ExecutorConfig(out_capacity=16, **ARMS[arm]), placement=placement,
        device="cpu")
    s = ex.session().prepare(data, caps=caps)
    assert s.count_passes == 0
    assert_same_result(s.run_batch(), jres)
