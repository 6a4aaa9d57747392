"""The port's SelfHealingSession (with and without adapt=) and
JoinServingEngine over a mesh of W gloo ranks on the CPU, against the JAX
package's on 8 virtual devices and the port's one-process ones, n_dev = 8.

W ∈ {2, 4} ranks each run every session case in one spawn
(`_torch_mesh_cases.session_rank`, torch-only); both groups start at once
and the JAX and one-process runs go on in this process while they do.
Every batch's and request's rows and valid flags, put together in rank
order, must equal both references' bit for bit, and every rank's stats,
survivors, evictions, placement, caps, step builds, plan HHs, detector
history and engine counters both references'.  The cases
(`_torch_mesh_cases.SESSION_CASES`): the chaos schedule (a retry ladder,
dropped heartbeats, a straggler, a rank's devices evicted in one re-fold),
the monitor on its own clock with a `timing_fn` straggler (the readings
equal on every rank), adaptation's forced re-place and warm re-plan, the
pruned-combination stream (held to JAX on its first three batches, where
the JAX session is exact), and `mixed_workload(6, seed=0)` through the
engine."""
import time
from types import SimpleNamespace

import numpy as np
import pytest

import _torch_mesh_cases as mc
from repro.core import plan_skew_join as jax_plan
from repro.core import two_way as jax_two_way
from repro.core.adapt import AdaptPolicy as JaxPolicy
from repro.core.executor import ExecutorConfig as JaxConfig
from repro.core.executor import ShardedJoinExecutor as JaxExecutor
from repro.data import mixed_workload as jax_mixed_workload
from repro.ft import ChaosInjector as JaxChaos
from repro.launch.mesh import make_mesh_compat
from repro.serve import JoinServingEngine as JaxEngine
from repro.serve import SelfHealingSession as JaxSession
from repro_torch.core import canonical, reference_join, two_way


def _jax_package():
    mesh = make_mesh_compat((mc.N_DEV,), ("cells",))
    return SimpleNamespace(
        Session=JaxSession, Chaos=JaxChaos, Policy=JaxPolicy,
        two_way=jax_two_way, plan=jax_plan, mixed_workload=jax_mixed_workload,
        executor=lambda plan, cap_out: JaxExecutor(
            plan, mesh, config=JaxConfig(out_capacity=cap_out)),
        engine=lambda: JaxEngine(mesh, k=mc.N_DEV),
        evict=lambda eng, devices: eng._evict(devices))


def _references(world):
    """{case: (the JAX package's trail, the port's one-process trail)}."""
    jax_pkg, port = _jax_package(), mc.port_package()
    return {name: (case(jax_pkg, world), case(port, world))
            for name, case in mc.SESSION_CASES.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{W: (every rank's results, {case: (JAX trail, one-process trail)})}."""
    deadline = time.monotonic() + mc.DEADLINE_S
    groups = {}
    for world in mc.SESSION_WORLDS:
        d = tmp_path_factory.mktemp(f"session{world}")
        groups[world] = (d, mc.spawn_ranks(mc.session_rank, world,
                                           str(d / "store"), str(d)))
    try:
        want = {world: _references(world) for world in mc.SESSION_WORLDS}
    finally:
        for _, ctx in groups.values():
            mc.join_ranks(ctx, deadline)
    return {world: (mc.load_ranks(d, world), want[world])
            for world, (d, _) in groups.items()}


def _trail(runs, world, name):
    """The mesh's trail (the ranks' put together) and both references'."""
    ranks, refs = runs[world]
    want, one = refs[name]
    assert [r["where"] for r in ranks] == [dict(rank=i, world=world)
                                           for i in range(world)]
    got = mc.put_together([r[name] for r in ranks], f"W{world} {name}")
    assert len(got) == len(want) == len(one)
    return got, want, one


@pytest.mark.parametrize("world", mc.SESSION_WORLDS)
def test_healing_session_over_a_mesh(runs, world):
    """The chaos schedule: the retry ladder, device 3's dropped heartbeats,
    device 5's strikes and the last rank's devices, each evicted in one
    re-fold, then a degraded batch: every state equal to JAX's and the
    one-process session's, every batch exact, the evicted devices
    receiving nothing."""
    got, want, one = _trail(runs, world, "heal")
    mc.same(got, want, f"W{world} heal vs JAX")
    mc.same(got, one, f"W{world} heal vs one process")
    lost = mc.lost_devices(world)
    first, last = got[0], got[-1]
    assert first["stats"]["retries"] >= 1
    assert first["stats"]["escalations"] >= 1
    assert first["compiles"] > 1                   # the ladder's rungs
    assert last["evicted"] == [3, 5] + [d for d in lost if d != 5]
    assert last["alive"] == [d for d in range(mc.N_DEV)
                             if d not in last["evicted"]]
    assert last["stats"]["refolds"] == 3
    assert set(last["table"]) <= set(last["alive"])
    assert all(last["result"]["recv_counts"][d] == 0 for d in last["evicted"])
    data = mc.heal_data()
    for st in got[:-2]:
        if "result" in st:
            res = st["result"]
            np.testing.assert_array_equal(
                canonical(res["rows"][res["valid"]]),
                reference_join(two_way(), data))
            assert res["shuffle_overflow"].sum() == 0


@pytest.mark.parametrize("world", mc.SESSION_WORLDS)
def test_monitor_clock_and_wall_are_agreed_over_the_mesh(runs, world):
    """Without chaos the monitor's clock and the batch wall are rank 0's
    on every rank (the heartbeat times and the watchdog's smoothed times
    equal across ranks); device 6, ten times the wall, strikes out and is
    evicted in the same batch as in both references."""
    ranks = runs[world][0]
    for i in range(len(ranks[0]["clock"])):
        for r in ranks[1:]:
            assert r["clock"][i]["readings"] == \
                ranks[0]["clock"][i]["readings"]
    got, want, one = _trail(runs, world, "clock")
    got = mc.without_readings(got)
    mc.same(got, mc.without_readings(want), f"W{world} clock vs JAX")
    mc.same(got, mc.without_readings(one), f"W{world} clock vs one process")
    assert [s["evicted"] for s in got] == [[], [6], [6]]


@pytest.mark.parametrize("world", mc.SESSION_WORLDS)
def test_forced_adaptation_over_a_mesh(runs, world):
    """A forced re-place and a forced warm re-plan: equal to both
    references after every batch, no step built, the plan cache hit."""
    got, want, one = _trail(runs, world, "adapt_forced")
    mc.same(got, want, f"W{world} adapt_forced vs JAX")
    mc.same(got, one, f"W{world} adapt_forced vs one process")
    st = got[-1]["stats"]
    assert (st["replacements"], st["replans"]) == (1, 1)
    assert (st["replace_compiles"], st["replan_compiles"]) == (0, 0)
    assert got[-1]["compiles"] == got[1]["compiles"]
    assert got[-1]["original_executor"]
    assert st["batches"] == 4


@pytest.mark.parametrize("world", mc.SESSION_WORLDS)
def test_pruned_combination_replan_over_a_mesh(runs, world):
    """Batch 2 re-plans on its own (new executor over the mesh) and prunes
    B = 1; batch 3 fills it and re-plans first (a second new executor):
    every batch equal to the one-process session's and exact, the first
    three to the JAX session's too."""
    from _torch_adapt_cases import HOT_A, drift_batch
    got, want, one = _trail(runs, world, "adapt_pruned")
    mc.same(got[:3], want[:3], f"W{world} adapt_pruned vs JAX")
    mc.same(got, one, f"W{world} adapt_pruned vs one process")
    st = got[-1]["stats"]
    assert st["replans"] == 2 and st["replan_compiles"] == 2
    assert got[-1]["hhs"] == {"B": (0, 1)}
    last = mc._set_b(mc._set_b(drift_batch(HOT_A, seed=70), "R", 300, 9),
                     "S", 40, 10)
    res = got[-1]["result"]
    rows = res["rows"][res["valid"]]
    assert len(rows) == 29_380
    np.testing.assert_array_equal(canonical(rows),
                                  reference_join(two_way(), last))


def _engine_without_replans(trail):
    """The port's engine trail without the per-tenant `replans` the
    reference lacks (0 wherever the reference is exact)."""
    out = []
    for st in trail:
        st = dict(st)
        if "tenant_stats" in st:
            ts = dict(st["tenant_stats"])
            assert ts.pop("replans") == 0
            st["tenant_stats"] = ts
        if "stats" in st:
            tenants = {}
            for name, ts in st["stats"]["tenants"].items():
                ts = dict(ts)
                assert ts.pop("replans") == 0
                tenants[name] = ts
            st["stats"] = dict(st["stats"], tenants=tenants)
        out.append(st)
    return out


@pytest.mark.parametrize("world", mc.SESSION_WORLDS)
def test_join_serving_engine_over_a_mesh(runs, world):
    """`mixed_workload(6, seed=0)`: each request's rows, put together in
    rank order, equal the JAX engine's and the one-process engine's, and
    exact; buckets, tenant stats and the engine's stats (cache hits,
    misses, builds) equal on every rank and to both."""
    got, want, one = _trail(runs, world, "engine")
    mc.same(got, one, f"W{world} engine vs one process")
    mc.same(_engine_without_replans(got), want, f"W{world} engine vs JAX")
    subs = list(mc.port_package().mixed_workload(6, seed=0))
    for req, (_, q, d) in zip(got, subs):
        assert req["done"]
        np.testing.assert_array_equal(canonical(req["rows"]),
                                      canonical(reference_join(q, d)))
    st = got[-1]["stats"]
    assert st["requests"] == 6 and st["cache"]["executors"] == 3
