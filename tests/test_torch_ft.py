"""The port's fault-tolerance monitors (`repro_torch.ft`): health,
stragglers and the chaos injector, as the reference's `tests/test_ft.py`
holds `repro.ft`; the injector also against the JAX package's."""
import warnings

import numpy as np
import pytest

from repro.ft import ChaosInjector as JaxChaosInjector
from repro_torch.ft import (CORRUPT_VALUE, ChaosInjector, HealthMonitor,
                            NodeState, StragglerWatchdog)


def test_health_monitor_detects_failure():
    t = [0.0]
    hm = HealthMonitor(n_nodes=4, heartbeat_timeout_s=30, suspect_timeout_s=10,
                       clock=lambda: t[0])
    assert hm.failed_nodes() == []
    hm.inject_failure(2)
    t[0] = 15.0
    for n in (0, 1, 3):
        hm.heartbeat(n)
    assert hm.state(2) == NodeState.SUSPECT
    t[0] = 35.0
    for n in (0, 1, 3):
        hm.heartbeat(n)
    assert hm.failed_nodes() == [2]
    assert sorted(hm.healthy_nodes()) == [0, 1, 3]


def test_straggler_watchdog():
    wd = StragglerWatchdog(n_nodes=4, threshold=1.5, evict_after=3)
    for _ in range(5):
        wd.record_step(np.array([1.0, 1.0, 1.0, 4.0]))
    assert wd.stragglers() == [3]
    assert wd.to_evict() == [3]
    w = wd.shard_weights()
    assert w[3] < w[0]          # straggler gets less data
    assert w.sum() == pytest.approx(1.0)


def test_straggler_all_zero_step_has_no_stragglers():
    """An all-zero step report is a clean no-op: no warning, no nan EMA,
    no stragglers, no strikes; real times afterwards still strike."""
    w = StragglerWatchdog(n_nodes=4, evict_after=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # any warning -> test failure
        w.record_step(np.zeros(4))
        assert w.stragglers() == []
        assert w.to_evict() == []
        np.testing.assert_array_equal(w.shard_weights(), np.full(4, 0.25))
        w.record_step(np.array([1.0, 1.0, 1.0, 10.0]))
    assert w.stragglers() == [3]


def test_health_monitor_unknown_node_is_a_clear_error():
    hm = HealthMonitor(n_nodes=4, clock=lambda: 0.0)
    with pytest.raises(ValueError, match=r"unknown node 9.*n_nodes=4"):
        hm.state(9)
    with pytest.raises(ValueError, match="unknown node -1"):
        hm.state(-1)


@pytest.mark.parametrize("seed", [0, 7])
def test_chaos_injector_determinism(seed):
    """Same seed + schedule -> identical corruption, the same rows and
    columns as the JAX injector's; the clock is fully virtual."""
    data = {"R": np.arange(20, dtype=np.int32).reshape(10, 2),
            "S": np.arange(36, dtype=np.int32).reshape(12, 3)}
    outs = []
    for make in (ChaosInjector, ChaosInjector, JaxChaosInjector):
        ch = make(4, seed=seed)
        ch.corrupt_rows("R", n_rows=3, at_step=0)
        ch.corrupt_rows("S", n_rows=2, at_step=1)
        first = ch.mangle(data)
        ch.advance(1.0)
        outs.append((first, ch.mangle(data)))
    for first, second in outs[1:]:
        for got, want in ((first, outs[0][0]), (second, outs[0][1])):
            for name in data:
                np.testing.assert_array_equal(got[name], want[name])
    first, second = outs[0]
    assert (first["R"] == CORRUPT_VALUE).sum() == 3   # exactly 3 cells
    assert first["S"] is data["S"] or (first["S"] == data["S"]).all()
    assert (second["S"] == CORRUPT_VALUE).sum() == 2
    assert (second["R"] == data["R"]).all()
    assert (data["R"] >= 0).all() and (data["S"] >= 0).all()  # untouched
    ch = ChaosInjector(4)
    assert ch.mangle(data) is data                    # nothing due
    assert ch.clock() == 0.0
    ch.advance(2.5)
    ch.advance(2.5)
    assert ch.clock() == 5.0 and ch.step == 2
    ch.drop_heartbeats(1)
    assert ch.dropped_heartbeats() == {1}
    ch.restore_heartbeats(1)
    assert ch.dropped_heartbeats() == set()
    assert ch.squeeze({"R": 100, "S": 3}) == {"R": 100, "S": 3}
    ch.squeeze_caps(0.01)
    assert ch.squeeze({"R": 100, "S": 3}) == {"R": 1, "S": 1}
    ch.squeeze_caps(0.5, rel="S")                     # per relation first
    assert ch.squeeze({"R": 100, "S": 30}) == {"R": 1, "S": 15}
    ch.delay_device(2, 3.0)
    np.testing.assert_array_equal(ch.step_times(np.ones(4)), [1, 1, 4, 1])
    with pytest.raises(ValueError, match="outside"):
        ch.delay_device(4, 1.0)
    with pytest.raises(ValueError):
        ChaosInjector(0)
