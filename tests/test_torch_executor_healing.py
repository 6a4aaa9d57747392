"""The port's executor healing surface vs the JAX session, n_dev = 8:
bounded retry, the error taxonomy, the session's fault counters and their
lazy drain, count_batch / cell_loads / refold.

Each case runs the same numpy data through the JAX `ExecutorSession` (8
virtual devices) and the port's session on the CPU; the data plane is
int32, so caps, counters and rows are compared for equality."""
import numpy as np
import pytest

from _torch_port_cases import N_DEV, assert_same_result, out_capacity
from repro.core import plan_skew_join as jax_plan
from repro.core import two_way as jax_two_way
from repro.core.executor import ExecutorConfig as JaxConfig
from repro.core.executor import RetryPolicy as JaxRetryPolicy
from repro.core.executor import ShardedJoinExecutor as JaxExecutor
from repro.core.executor import \
    CapacityOverflowError as JaxCapacityOverflowError
from repro.core.placement import lpt_placement as jax_lpt_placement
from repro.launch.mesh import make_mesh_compat
from repro_torch.core import (canonical, lpt_placement, plan_skew_join,
                              reference_join, two_way)
from repro_torch.core.executor import (CapacityOverflowError, ExecutorConfig,
                                       ExecutorError, RetryBudgetExceededError,
                                       RetryPolicy, ShardedJoinExecutor)
from repro_torch.data import skewed_join_dataset

STAT_KEYS = ("batches", "retries", "escalations", "shuffle_overflow",
             "join_overflow")


def _data(seed=27, n=500, domain=40, skew=1.7):
    return skewed_join_dataset(two_way(), n, domain, skew={"B": skew},
                               seed=seed)


def _pair(data, k=8, cap_out=None, **cfg):
    """(JAX executor, port executor) on one plan of `data`."""
    cap_out = cap_out or out_capacity(two_way(), data)
    jex = JaxExecutor(jax_plan(jax_two_way(), data, k),
                      make_mesh_compat((N_DEV,), ("cells",)),
                      config=JaxConfig(out_capacity=cap_out, **cfg))
    ex = ShardedJoinExecutor(plan_skew_join(two_way(), data, k), N_DEV,
                             ExecutorConfig(out_capacity=cap_out, **cfg),
                             device="cpu")
    assert ex.route_specs == jex.route_specs
    return jex, ex


def _same_stats(got, want):
    for key in STAT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def _exact(res, data):
    np.testing.assert_array_equal(canonical(res["rows"][res["valid"]]),
                                  reference_join(two_way(), data))


@pytest.mark.parametrize("force", ["R", "S", "join"])
def test_run_with_retry_escalates_only_failing_caps(force):
    """Tiny caps on one relation (or a tiny cap_out): run_with_retry
    recovers exactly, escalates only the failing cap on the bucket grid,
    keeps every failed attempt's overflow in stats, and walks the JAX
    session's ladder: the same caps, cap_out, counters and rows."""
    data = _data()
    full = out_capacity(two_way(), data)      # the whole join's rows
    cap_out = full // 16 if force == "join" else full
    jex, ex = _pair(data, cap_out=cap_out)
    sessions = []
    for e in (jex, ex):
        probe = e.session().prepare(data)
        caps = dict(probe.caps)
        if force != "join":
            caps[force] = 2
        sessions.append(e.session().prepare(data, caps=caps,
                                            placement=probe.placement))
    js, s = sessions
    start = dict(s.caps)
    jres, res = js.run_with_retry(), s.run_with_retry()
    assert_same_result(res, jres)
    _exact(res, data)
    assert s.caps == js.caps and s.cap_out == js.cap_out
    _same_stats(s.stats, js.stats)
    assert 1 <= s.stats["retries"] <= RetryPolicy().max_retries
    assert s.stats["batches"] == s.stats["retries"] + 1
    assert res["shuffle_overflow"].sum() == 0         # delivered result clean
    assert res["join_overflow"].sum() == 0
    if force == "join":
        assert s.caps == start and s.cap_out > cap_out
        assert s.stats["join_overflow"].sum() > 0
        assert s.stats["shuffle_overflow"].sum() == 0
    else:
        other = "S" if force == "R" else "R"
        col = ("R", "S").index(force)
        assert s.caps[force] > 2 and s.caps[other] == start[other]
        assert s.stats["shuffle_overflow"][:, col].sum() > 0
        assert s.stats["shuffle_overflow"][:, 1 - col].sum() == 0
        assert s.cap_out == ex.config.out_capacity


def test_overflow_error_carries_per_device_breakdown():
    """CapacityOverflowError.from_result on a forced overflow: the JAX
    error's per-(device, relation) counters and message, hint included."""
    data = _data(seed=28)
    jex, ex = _pair(data)
    errs = []
    for e, error in ((jex, JaxCapacityOverflowError),
                     (ex, CapacityOverflowError)):
        probe = e.session().prepare(data)
        res = e.session().prepare(data, caps=dict(probe.caps, R=2),
                                  placement=probe.placement).run_batch()
        assert res["shuffle_overflow"].sum() > 0
        errs.append(error.from_result(res, ("R", "S")))
    jerr, err = errs
    assert str(err) == str(jerr)
    assert "shuffle[R]" in str(err) and "run_with_retry()" in str(err)
    assert err.shuffle_by_rel.shape == (N_DEV, 2)
    np.testing.assert_array_equal(err.shuffle_by_rel, jerr.shuffle_by_rel)
    np.testing.assert_array_equal(err.join_overflow, jerr.join_overflow)
    assert err.shuffle_by_rel[:, 0].sum() > 0        # attributed to R
    assert err.shuffle_by_rel[:, 1].sum() == 0


@pytest.mark.parametrize("max_retries", [0, 1])
def test_retry_budget_exceeded_raises_with_breakdown(max_retries):
    """Caps squeezed past what max_retries escalations absorb: the
    budget error names a device, nests in the taxonomy and carries the JAX
    error's attempts, breakdown and message."""
    data = _data(seed=51)
    jex, ex = _pair(data, k=32)
    errs = []
    for e, policy in ((jex, JaxRetryPolicy(max_retries=max_retries)),
                      (ex, RetryPolicy(max_retries=max_retries))):
        probe = e.session().prepare(data)
        caps = {r: 1 for r in probe.caps}
        s = e.session().prepare(data, caps=caps, placement=probe.placement)
        with pytest.raises(Exception) as err:
            s.run_with_retry(policy=policy)
        errs.append((err.value, s))
    (jerr, js), (err, s) = errs
    assert type(err) is RetryBudgetExceededError
    assert isinstance(err, CapacityOverflowError)
    assert isinstance(err, ExecutorError) and isinstance(err, RuntimeError)
    assert "retry budget exhausted" in str(err) and "dev 0" in str(err)
    assert str(err) == str(jerr)
    assert err.attempts == jerr.attempts == max_retries + 1
    np.testing.assert_array_equal(err.shuffle_by_rel, jerr.shuffle_by_rel)
    np.testing.assert_array_equal(err.join_overflow, jerr.join_overflow)
    assert s.caps == js.caps
    _same_stats(s.stats, js.stats)


def test_stats_after_overflow_batch_and_retry_match_jax(monkeypatch):
    """A forced-overflow run_batch, then run_with_retry on the same
    session: the lifetime counters equal the JAX session's, and the port
    parks each batch's overflow on the device until stats (or the pending
    bound) drains it."""
    data = _data(seed=29)
    jex, ex = _pair(data)
    sessions = []
    for e in (jex, ex):
        probe = e.session().prepare(data)
        s = e.session().prepare(data, caps=dict(probe.caps, S=2),
                                placement=probe.placement)
        s.run_batch()
        sessions.append(s)
    js, s = sessions
    assert len(s._pending) == 1 and s._stats["shuffle_overflow"].sum() == 0
    assert s.stats["shuffle_overflow"].sum() > 0 and not s._pending
    res, jres = s.run_with_retry(), js.run_with_retry()
    assert_same_result(res, jres)
    _same_stats(s.stats, js.stats)
    assert s.stats["batches"] >= 3 and s.stats["retries"] >= 1
    monkeypatch.setattr(type(s), "_PENDING_MAX", 2)
    before = s._stats["batches"]
    s.run_batch()
    assert len(s._pending) == 1
    s.run_batch()                             # the bound drains it itself
    assert not s._pending and s._stats["batches"] == before + 2


def test_empty_plan_counts_batches():
    """A provably empty join still counts its batches, as JAX's does."""
    q = two_way()
    data = {"R": np.array([[1, 2]], np.int32),
            "S": np.zeros((0, 2), np.int32)}
    jex = JaxExecutor(jax_plan(jax_two_way(), data, 8),
                      make_mesh_compat((N_DEV,), ("cells",)))
    ex = ShardedJoinExecutor(plan_skew_join(q, data, 8), N_DEV, device="cpu")
    js, s = jex.session().prepare(data), ex.session().prepare(data)
    for _ in range(2):
        res, jres = s.run_batch(), js.run_batch()
        assert_same_result(res, jres)
    _same_stats(s.stats, js.stats)
    assert s.stats["batches"] == 2
    assert s.count_batch() == [] and js.count_batch() == []


@pytest.mark.parametrize("dead", [[3], [0, 5]])
def test_count_batch_cell_loads_and_refold_match_jax(dead):
    """count_batch of a streamed batch, the prepare-time cell loads, and a
    refold over the survivors: the JAX session's count matrices, loads,
    table and caps; the refolded batch's rows, with nothing received by
    the dead devices and no step built."""
    data = _data(seed=52, n=600, domain=50, skew=1.6)
    jex, ex = _pair(data, k=32)
    js, s = jex.session().prepare(data), ex.session().prepare(data)
    assert s.count_passes == js.count_passes == 1
    loads = s.cell_loads()
    np.testing.assert_array_equal(loads, js.cell_loads())
    assert s.count_passes == 1                # prepare's matrices kept
    half = {name: arr[: len(arr) // 2] for name, arr in data.items()}
    assert_same_result(s.run_batch(half), js.run_batch(half))
    counted, jcounted = s.count_batch(), js.count_batch()
    assert s.count_passes == js.count_passes == 2
    for c, jc in zip(counted, jcounted):
        np.testing.assert_array_equal(c, jc)
    assert sum(int(c.sum()) for c in counted) < loads.sum()
    survivors = [d for d in range(N_DEV) if d not in dead]
    placement = lpt_placement(loads, N_DEV, devices=survivors)
    np.testing.assert_array_equal(
        placement.table,
        jax_lpt_placement(js.cell_loads(), N_DEV, devices=survivors).table)
    compiles, caps = ex.compile_count, dict(s.caps)
    s.refold(placement)
    js.refold(jax_lpt_placement(js.cell_loads(), N_DEV, devices=survivors))
    assert s.caps == js.caps
    res, jres = s.run_batch(), js.run_batch()
    assert_same_result(res, jres)
    _exact(res, data)
    assert all(res["recv_counts"][d] == 0 for d in dead)
    assert (np.delete(res["recv_counts"], dead) > 0).all()
    assert ex.compile_count == compiles + (s.caps != caps)  # table: no build
    # Caps sized for the observed batch instead of prepare's.
    s.refold(placement, counts=counted)
    js.refold(js.placement, counts=jcounted)
    assert s.caps == js.caps
    assert_same_result(s.run_batch(half), js.run_batch(half))


def test_hooks_before_prepare_raise():
    data = _data()
    ex = ShardedJoinExecutor(plan_skew_join(two_way(), data, 8), N_DEV,
                             device="cpu")
    s = ex.session()
    for call in (s.count_batch, s.cell_loads, s.run_batch, s.run_with_retry,
                 lambda: s.refold(lpt_placement(np.ones(8), N_DEV))):
        with pytest.raises(RuntimeError, match="before prepare"):
            call()
