"""The adaptation axis of the port's `SelfHealingSession` against the JAX
package's, end to end.

`tests/test_adapt.py`'s five live-session scenarios run through both
packages' `SelfHealingSession(adapt=...)` with the same policy, plan, data
and schedule (JAX on 8 virtual devices, the port with n_devices = 8 on the
CPU): after every batch the two must give equal `stats` (the adaptation
counters and the retired sessions' folded in), placement table, caps,
`executor.plan.hhs`, `detector.history` and result (rows, valid flags,
overflow, received counts), and the port's rows equal `reference_join`.
Then the reference's claims hold on the port's trail: organic
re-placement and a same-structure re-plan build no step, a new heavy
hitter builds one and counts it.  The forced actions and mild drift also
run on the port's other three `ExecutorConfig` arms against the JAX
session (fused + hash, which the reference pins equal to its other arms),
and a re-plan in degraded mode folds the new plan over the survivors.
Last, the fault both packages had (ROADMAP §3): a batch filling a type
combination that an adaptive re-plan pruned re-plans the port's session
first and stays exact, where the JAX session drops those rows."""
import functools
import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_adapt_cases import (CAP_OUT, E2E_POL, HOT_A, HOT_B, HOT_MILD,
                                K_PLAN, drift_batch)
from _torch_port_cases import ARMS, N_DEV, RESULT_KEYS
from repro.core import plan_skew_join as jax_plan
from repro.core import two_way as jax_two_way
from repro.core.adapt import AdaptPolicy as JaxPolicy
from repro.core.executor import ExecutorConfig as JaxConfig
from repro.core.executor import ShardedJoinExecutor as JaxExecutor
from repro.launch.mesh import make_mesh_compat
from repro.serve import SelfHealingSession as JaxSession
from repro_torch.core import (AdaptPolicy, canonical, plan_skew_join,
                              reference_join, two_way)
from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
from repro_torch.serve import SelfHealingSession

# The step-drift scenario's policy: the replan threshold below HALF the
# full step's TV (~0.10), as the window dilutes a fresh step by ~2x.
STEP_POL = dict(E2E_POL, replace_threshold=0.015, replan_threshold=0.04)


def _jax_executor(data):
    return JaxExecutor(jax_plan(jax_two_way(), data, K_PLAN),
                       make_mesh_compat((N_DEV,), ("cells",)),
                       config=JaxConfig(out_capacity=CAP_OUT))


def _port_executor(data, arm="fused+hash"):
    return ShardedJoinExecutor(plan_skew_join(two_way(), data, K_PLAN), N_DEV,
                               ExecutorConfig(out_capacity=CAP_OUT,
                                              **ARMS[arm]),
                               device="cpu")


JAX = SimpleNamespace(Session=JaxSession, Policy=JaxPolicy,
                      executor=lambda data, arm: _jax_executor(data))
PORT = SimpleNamespace(Session=SelfHealingSession, Policy=AdaptPolicy,
                       executor=_port_executor)


def _digest(a) -> tuple:
    """Shape and values (integers compared as int64: the packages' counters
    differ in width, not in value)."""
    a = np.asarray(a)
    if a.dtype != bool:
        a = a.astype(np.int64)
    a = np.ascontiguousarray(a)
    return a.shape, hashlib.sha256(a.tobytes()).hexdigest()


def _state(eng, ex0, res, batch):
    """What both packages must agree on after a batch."""
    st = eng.stats
    return dict(
        stats={k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in st.items()},
        table=eng.session.placement.table.tolist(),
        caps=dict(eng.session.caps), cap_out=eng.session.cap_out,
        hhs=dict(eng.executor.plan.hhs.per_attr),
        history=list(eng.detector.history),
        original_executor=eng.executor is ex0,
        compiles=(ex0.compile_count, eng.executor.compile_count),
        result={key: _digest(res[key]) for key in RESULT_KEYS},
        exact=bool(np.array_equal(
            canonical(np.asarray(res["rows"])[np.asarray(res["valid"])]),
            reference_join(two_way(), batch))))


def _session(pkg, arm, policy=E2E_POL):
    data0 = drift_batch(HOT_A, seed=1)
    ex = pkg.executor(data0, arm)
    return ex, pkg.Session(ex, adapt=pkg.Policy(**policy)).prepare(data0)


def _run(eng, ex, batches, stop_on_replan=False):
    trail = []
    for batch in batches:
        trail.append(_state(eng, ex, eng.run_batch(batch), batch))
        if stop_on_replan and eng.replans:
            break
    return trail


@functools.lru_cache(maxsize=None)
def _jax_trail(scenario):
    return scenario(JAX, None)


def _both(scenario, arm="fused+hash"):
    """The scenario's trail of states for JAX and for the port under `arm`:
    equal, and every port batch exact.  Returns the port's trail."""
    want, got = _jax_trail(scenario), scenario(PORT, arm)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in w:
            assert g[key] == w[key], f"state {i}: {key} differs"
        assert g["exact"], f"state {i}: rows differ from reference_join"
    return got


def _stable(pkg, arm):
    ex, eng = _session(pkg, arm)
    return _run(eng, ex, [drift_batch(HOT_A, seed=10 + i) for i in range(6)])


def test_e2e_stable_stream_never_adapts():
    st = _both(_stable)[-1]["stats"]
    assert st["replacements"] == 0 and st["replans"] == 0
    assert st["replace_compiles"] == 0 and st["replan_compiles"] == 0


def _mild(pkg, arm):
    ex, eng = _session(pkg, arm)
    trail = _run(eng, ex, [drift_batch(HOT_A, seed=20 + i) for i in range(3)])
    return trail + _run(eng, ex, [drift_batch(HOT_MILD, seed=30 + i)
                                       for i in range(6)])


@pytest.mark.parametrize("arm", list(ARMS))
def test_e2e_mild_drift_organic_replacement_zero_compiles(arm):
    trail = _both(_mild, arm)
    warm, last = trail[2], trail[-1]
    st = last["stats"]
    assert st["replacements"] >= 1, "mild drift must trigger a re-placement"
    assert st["replans"] == 0, "mild drift must NOT re-plan"
    assert st["replace_compiles"] == 0
    assert last["compiles"] == warm["compiles"], "re-placement built a step"
    assert last["table"] != warm["table"], \
        "re-placement did not change the fold"


def _step(pkg, arm):
    ex, eng = _session(pkg, arm, STEP_POL)
    trail = _run(eng, ex, [drift_batch(HOT_A, seed=40 + i) for i in range(3)])
    return trail + _run(eng, ex, [drift_batch(HOT_B, seed=50 + i)
                                       for i in range(6)])


def test_e2e_step_drift_organic_replan_lands_warm():
    trail = _both(_step)
    warm, last = trail[2], trail[-1]
    st = last["stats"]
    assert st["replans"] >= 1, "step drift must trigger a re-plan"
    assert st["replan_compiles"] == 0, "same-structure re-plan built a step"
    assert last["original_executor"], "plan cache missed on equal structure"
    assert last["compiles"] == warm["compiles"]
    assert st["replans"] <= 2, f"replan thrash: {last['history']}"
    assert st["batches"] == 9                 # retired counters folded in


def _new_hh(pkg, arm):
    ex, eng = _session(pkg, arm)
    trail = _run(eng, ex, [drift_batch(HOT_A, seed=60 + i) for i in range(3)])
    # value 1 becomes a genuine second heavy hitter (sketch-provable)
    trail += _run(eng, ex, [drift_batch(HOT_A, seed=70 + i,
                                        extra_hh={"B": 256})
                                 for i in range(4)], stop_on_replan=True)
    # and the adapted session keeps delivering exact results
    return trail + _run(eng, ex, [drift_batch(HOT_A, seed=80,
                                              extra_hh={"B": 256})])


def test_e2e_new_heavy_hitter_cold_replan_is_honest_and_exact():
    last = _both(_new_hh)[-1]
    st = last["stats"]
    assert st["replans"] >= 1, "provable new HH must force a re-plan"
    assert not last["original_executor"], "new HH set must build a new plan"
    assert 1 in last["hhs"]["B"], f"new plan missed the promoted HH: " \
                                  f"{last['hhs']}"
    assert st["replan_compiles"] >= 1, \
        "a structurally new plan must count its step build"


def _forced(pkg, arm):
    ex, eng = _session(pkg, arm)
    trail = _run(eng, ex, [drift_batch(HOT_A, seed=90 + i) for i in range(2)])
    eng.force_replace()
    trail += _run(eng, ex, [drift_batch(HOT_A, seed=92)])
    eng.force_replan()
    return trail + _run(eng, ex, [drift_batch(HOT_A, seed=93)])


@pytest.mark.parametrize("arm", list(ARMS))
def test_e2e_forced_actions_warm_and_stats_cumulative(arm):
    trail = _both(_forced, arm)
    warm, last = trail[1], trail[-1]
    st = last["stats"]
    assert st["replacements"] == 1 and st["replans"] == 1
    assert st["replace_compiles"] == 0 and st["replan_compiles"] == 0
    assert last["compiles"] == warm["compiles"]
    assert last["original_executor"]          # plan cache hit
    assert st["batches"] == 4                 # merged across the replan


def _degraded(pkg, arm):
    ex, eng = _session(pkg, arm)
    eng.evict_device(3)
    trail = _run(eng, ex, [drift_batch(HOT_A, seed=100 + i) for i in range(2)])
    # A new heavy hitter re-plans cold while device 3 stays evicted.
    return trail + _run(eng, ex, [drift_batch(HOT_A, seed=110 + i,
                                         extra_hh={"B": 256})
                                  for i in range(5)])


def test_replan_in_degraded_mode_folds_over_the_survivors():
    """A re-plan keeps degraded mode: the new plan's cells fold over the
    seven survivors, and device 3 receives nothing before or after."""
    trail = _both(_degraded)
    last = trail[-1]
    assert last["stats"]["evicted"] == [3]
    assert last["stats"]["replans"] >= 1 and not last["original_executor"]
    assert all(3 not in st["table"] for st in trail)


def test_adapt_refuses_an_executor_without_a_plan():
    """`from_specs` executors carry route specs and no plan; adaptation
    re-plans from the planner's plan, so `adapt=` refuses them (and the
    session without it runs)."""
    data = drift_batch(HOT_A, seed=1)
    ex0 = _port_executor(data)
    ex = ShardedJoinExecutor.from_specs(
        ex0.query, ex0.k, ex0.route_specs, N_DEV,
        ExecutorConfig(out_capacity=CAP_OUT), device="cpu")
    with pytest.raises(ValueError, match="planner's plan"):
        SelfHealingSession(ex, adapt=AdaptPolicy(**E2E_POL))
    res = SelfHealingSession(ex).prepare(data).run_batch()
    np.testing.assert_array_equal(
        canonical(res["rows"][res["valid"]]), reference_join(two_way(), data))


def _set_b(batch, rel, n, seed):
    """`batch` with column B set to 1 in n rows of `rel`, picked by
    default_rng(seed)."""
    out = {k: np.array(v) for k, v in batch.items()}
    col = two_way().relation(rel).attrs.index("B")
    rows = np.random.default_rng(seed).choice(len(out[rel]), n, replace=False)
    out[rel][rows, col] = 1
    return out


def _pruned_after_replan(pkg, arm):
    """Batches 0-2 put B = 1 in 300 of R's rows only: batch 2 re-plans on
    its own, with HHs B = 0 and 1, and prunes B = 1 (S has none).  The
    fourth batch then fills B = 1 in both relations."""
    ex, eng = _session(pkg, arm)
    batches = [_set_b(drift_batch(HOT_A, seed=60 + i), "R", 300, i)
               for i in range(3)]
    last = _set_b(_set_b(drift_batch(HOT_A, seed=70), "R", 300, 9),
                  "S", 40, 10)
    trail = _run(eng, ex, batches)
    res = eng.run_batch(last)
    rows = np.asarray(res["rows"])[np.asarray(res["valid"])]
    return trail, rows, last, eng.stats


def test_a_batch_in_a_combination_a_replan_pruned_replans_first():
    """A batch with rows in a type combination that an adaptive re-plan
    pruned (its one-batch sample had none of them in S) re-plans before it
    runs, with the plan's own HHs, counted in `replans`, and is exact:
    29,380 rows.  The JAX session keeps the pruned plan and drops 12,000
    of them without an overflow or an error.  Until then the two trails
    are equal, and the re-plan of batch 2 prunes B = 1 in both."""
    want_trail, jax_rows, data, jax_st = _pruned_after_replan(JAX, None)
    trail, rows, _, st = _pruned_after_replan(PORT, "fused+hash")
    for i, (g, w) in enumerate(zip(trail, want_trail)):
        for key in w:
            assert g[key] == w[key], f"state {i}: {key} differs"
        assert g["exact"], f"state {i}: rows differ from reference_join"
    assert trail[-1]["stats"]["replans"] == 1
    assert trail[-1]["hhs"] == {"B": (0, 1)}
    want = reference_join(two_way(), data)
    assert len(want) == 29_380 and len(jax_rows) == 17_380
    assert jax_st["replans"] == 1
    assert not np.asarray(jax_st["shuffle_overflow"]).any()
    assert not np.asarray(jax_st["join_overflow"]).any()
    np.testing.assert_array_equal(canonical(rows), want)
    assert st["replans"] == 2 and st["replan_compiles"] == 2
