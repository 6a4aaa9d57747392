"""Chaos suite of the port's `SelfHealingSession`: every fault it claims to
survive, injected deterministically (`repro_torch.ft.ChaosInjector`),
recovery held exact against `reference_join`, and each scenario run through
the JAX package's `SelfHealingSession` on the same data and schedule:
equal evictions, survivors, re-folds, re-fold builds, retry counters,
placement tables and rows.

Scenarios (the reference's `tests/test_chaos.py`):
  * capacity overflow  -> bounded retry on the cap grid, exact result; a
                          ladder the executor has walked builds no step;
  * retry budget       -> RetryBudgetExceededError with the breakdown;
  * device loss        -> dropped heartbeats age out on the virtual clock,
                          the device is evicted, cells re-fold over the
                          survivors with no step built, it receives no row;
  * every device gone  -> DeviceLossError, all cells on the last device;
  * straggler          -> an injected delay strikes out, same re-fold;
  * corrupted rows     -> rejected by input validation naming the
                          relation; the session stays usable and warm.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_port_cases import N_DEV, RESULT_KEYS
from repro.core import plan_skew_join as jax_plan
from repro.core import two_way as jax_two_way
from repro.core import executor as jax_executor
from repro.ft import ChaosInjector as JaxChaosInjector
from repro.launch.mesh import make_mesh_compat
from repro.serve import SelfHealingSession as JaxSelfHealingSession
from repro_torch.core import (canonical, plan_skew_join, reference_join,
                              two_way)
from repro_torch.core import executor as port_executor
from repro_torch.data import skewed_join_dataset
from repro_torch.ft import ChaosInjector
from repro_torch.serve import SelfHealingSession

JAX = SimpleNamespace(Session=JaxSelfHealingSession, Chaos=JaxChaosInjector,
                      ex=jax_executor)
PORT = SimpleNamespace(Session=SelfHealingSession, Chaos=ChaosInjector,
                       ex=port_executor)
CAP_OUT = 65536         # per device, as the reference suite's


def _data(n, domain, seed, skew=None):
    skew = {"B": skew} if skew else None
    return skewed_join_dataset(two_way(), n, domain, skew=skew, seed=seed)


def _executor(pkg, data, k=32):
    if pkg is JAX:
        return jax_executor.ShardedJoinExecutor(
            jax_plan(jax_two_way(), data, k),
            make_mesh_compat((N_DEV,), ("cells",)),
            config=jax_executor.ExecutorConfig(out_capacity=CAP_OUT))
    return port_executor.ShardedJoinExecutor(
        plan_skew_join(two_way(), data, k), N_DEV,
        port_executor.ExecutorConfig(out_capacity=CAP_OUT), device="cpu")


def _state(eng, res=None):
    """What both packages must agree on after a batch."""
    st = eng.stats
    out = dict(evicted=list(eng.evicted), alive=list(eng.alive),
               refolds=eng.refolds, refold_compiles=eng.refold_compiles,
               batches=st["batches"], retries=st["retries"],
               escalations=st["escalations"],
               stats_shuffle=st["shuffle_overflow"].tolist(),
               stats_join=st["join_overflow"].tolist(),
               table=eng.session.placement.table.tolist(),
               caps=dict(eng.session.caps), cap_out=eng.session.cap_out,
               compiles=eng.executor.compile_count)
    if res is not None:
        out.update({key: np.asarray(res[key]).tolist()
                    for key in RESULT_KEYS})
    return out


def _exact(res, data):
    np.testing.assert_array_equal(canonical(res["rows"][res["valid"]]),
                                  reference_join(two_way(), data))


def _both(scenario, data, **kw):
    """Run `scenario(pkg, data)` for JAX and the port; their trails of
    states must be equal.  Returns the port's."""
    want, got = scenario(JAX, data, **kw), scenario(PORT, data, **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"state {i} differs"
    return got


def _overflow(pkg, data):
    ex = _executor(pkg, data)
    chaos = pkg.Chaos(N_DEV, seed=0)
    chaos.squeeze_caps(0.3)                    # forced-tiny caps -> overflow
    eng = pkg.Session(ex, chaos=chaos).prepare(data)
    res = eng.run_batch()
    if pkg is PORT:
        _exact(res, data)
    return [_state(eng, res)]


def test_overflow_retry_recovers_exactly():
    data = _data(500, 40, 51, 1.7)
    st, = _both(_overflow, data)
    assert 1 <= st["retries"] <= port_executor.RetryPolicy().max_retries
    assert np.sum(st["stats_shuffle"]) >= 1            # attempts kept visible
    assert np.sum(st["shuffle_overflow"]) == 0          # delivered clean
    assert np.sum(st["join_overflow"]) == 0


def _ladder(pkg, data):
    ex = _executor(pkg, data)
    trail = []
    for _ in range(2):
        chaos = pkg.Chaos(N_DEV, seed=0)
        chaos.squeeze_caps(0.3)
        eng = pkg.Session(ex, chaos=chaos).prepare(data)
        res = eng.run_batch()
        if pkg is PORT:
            _exact(res, data)
        trail.append(_state(eng, res))
    return trail


def test_overflow_retry_ladder_is_warm_second_time():
    """A second session walking the ladder the executor walked once
    builds no step."""
    first, second = _both(_ladder, _data(500, 40, 51, 1.7))
    assert first["retries"] >= 1
    assert second["retries"] == first["retries"]
    assert second["compiles"] == first["compiles"]


def _budget(pkg, data):
    ex = _executor(pkg, data)
    trail = []
    for _ in range(2):
        chaos = pkg.Chaos(N_DEV, seed=0)
        chaos.squeeze_caps(0.3)
        eng = pkg.Session(ex, retry=pkg.ex.RetryPolicy(max_retries=0),
                          chaos=chaos).prepare(data)
        with pytest.raises(pkg.ex.RetryBudgetExceededError) as err:
            eng.run_batch()
        assert isinstance(err.value, pkg.ex.CapacityOverflowError)
        trail.append(dict(_state(eng), message=str(err.value),
                          attempts=err.value.attempts,
                          shuffle_by_rel=err.value.shuffle_by_rel.tolist(),
                          join_by_dev=err.value.join_overflow.tolist(),
                          step=chaos.step))
    return trail


def test_retry_budget_exceeded_raises_with_breakdown():
    """max_retries = 0: the budget error names the failing devices, is a
    CapacityOverflowError, and the virtual clock still advanced."""
    first, _ = _both(_budget, _data(500, 40, 51, 1.7))
    assert "retry budget exhausted" in first["message"]
    assert "dev 0" in first["message"]
    assert first["attempts"] == 1 and first["step"] == 1
    assert np.sum(first["shuffle_by_rel"]) > 0


def _device_loss(pkg, data, dead):
    ex = _executor(pkg, data)
    chaos = pkg.Chaos(N_DEV, seed=0)
    chaos.drop_heartbeats(dead)
    eng = pkg.Session(ex, chaos=chaos, heartbeat_timeout_s=2.5,
                      suspect_timeout_s=1.5, step_seconds=1.0).prepare(data)
    trail = [_state(eng, eng.run_batch())]      # healthy batch, beats kept
    while eng.evicted == [] and eng.session.stats["batches"] < 16:
        trail.append(_state(eng, eng.run_batch()))
    trail.append(_state(eng, eng.run_batch()))  # degraded-mode batch
    return trail


@pytest.mark.parametrize("dead", [3, 0])
def test_device_loss_refolds_over_survivors_exactly(dead):
    """Dropped heartbeats age out; the dead device is evicted, cells
    re-fold over the 7 survivors with no step built, the evicted device
    receives nothing, and output stays exact on every batch."""
    data = _data(600, 50, 52, 1.6)
    trail = _both(_device_loss, data, dead=dead)
    last = trail[-1]
    assert last["evicted"] == [dead]
    assert last["alive"] == [d for d in range(N_DEV) if d != dead]
    assert last["refolds"] == 1 and last["refold_compiles"] == 0
    assert last["compiles"] == trail[-2]["compiles"]   # traced table: warm
    assert last["recv_counts"][dead] == 0
    assert all(c > 0 for d, c in enumerate(last["recv_counts"]) if d != dead)
    assert dead not in last["table"]
    rows = np.asarray(last["rows"])[np.asarray(last["valid"])]
    np.testing.assert_array_equal(canonical(rows),
                                  reference_join(two_way(), data))


def _evict_all(pkg, data):
    ex = _executor(pkg, data)
    eng = pkg.Session(ex).prepare(data)
    trail = []
    for d in range(N_DEV - 1):
        eng.evict_device(d)
        trail.append(_state(eng))
    with pytest.raises(pkg.ex.DeviceLossError, match="no surviving devices"):
        eng.evict_device(N_DEV - 1)
    with pytest.raises(pkg.ex.DeviceLossError, match="is not alive"):
        eng.evict_device(0)
    res = eng.run_batch()                       # every cell on one device
    if pkg is PORT:
        _exact(res, data)
    trail.append(_state(eng, res))
    return trail


def test_evicting_every_device_refuses():
    trail = _both(_evict_all, _data(300, 30, 53))
    last = trail[-1]
    assert last["alive"] == [N_DEV - 1] and set(last["table"]) == {N_DEV - 1}
    assert last["refolds"] == N_DEV - 1


def _straggler(pkg, data):
    ex = _executor(pkg, data)
    chaos = pkg.Chaos(N_DEV, seed=0)
    chaos.delay_device(5, 30.0)                 # 30 s/step on a short step
    eng = pkg.Session(ex, chaos=chaos, straggler_threshold=1.5,
                      evict_after=2).prepare(data)
    trail = []
    while eng.evicted == [] and eng.session.stats["batches"] < 8:
        res = eng.run_batch()
        if pkg is PORT:
            _exact(res, data)
        trail.append(_state(eng, res))
    trail.append(_state(eng, eng.run_batch()))
    return trail


def test_straggler_is_evicted_and_result_exact():
    data = _data(600, 50, 54, 1.6)
    trail = _both(_straggler, data)
    last = trail[-1]
    assert last["evicted"] == [5] and last["refolds"] == 1
    assert last["recv_counts"][5] == 0
    rows = np.asarray(last["rows"])[np.asarray(last["valid"])]
    np.testing.assert_array_equal(canonical(rows),
                                  reference_join(two_way(), data))


def _corrupt(pkg, data):
    ex = _executor(pkg, data)
    chaos = pkg.Chaos(N_DEV, seed=3)
    eng = pkg.Session(ex, chaos=chaos).prepare(data)
    trail = [_state(eng, eng.run_batch(data))]  # step 0: clean
    chaos.corrupt_rows("R", n_rows=2)           # due at the current step
    with pytest.raises(pkg.ex.InputValidationError,
                       match=r"relation 'R'.*corrupted") as err:
        eng.run_batch(data)
    trail.append(dict(_state(eng), message=str(err.value)))
    res = eng.run_batch(data)                   # corruption was one-shot
    if pkg is PORT:
        _exact(res, data)
    trail.append(_state(eng, res))
    return trail


def test_corrupted_rows_rejected_then_clean_retry_exact():
    """The corrupted chunk is rejected before routing (same rows named as
    the JAX session's); the next clean chunk runs on the warm step."""
    trail = _both(_corrupt, _data(500, 40, 55, 1.5))
    assert trail[2]["compiles"] == trail[0]["compiles"]
    assert trail[2]["batches"] == 2
