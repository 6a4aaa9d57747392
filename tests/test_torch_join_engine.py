"""The port's multi-tenant `JoinServingEngine` against the JAX package's.

`tests/test_join_engine.py`'s ten scenarios (bucketing, the executable
cache, scheduling, per-tenant adaptation, the request stream) run through
both engines on the same submissions: JAX with k = 8 on 8 virtual devices,
the port with n_devices = 8 on the CPU.  Per request the two must give
equal rows, buckets and per-tenant stats; the engines equal `stats`
(`cache.stats` with its hit, miss, eviction and step-build counters
included); and the port's rows canonically equal `reference_join`.
`mixed_workload` equals the reference's array for array."""
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_adapt_cases import pruned_pair
from repro.core import running_example as jax_running_example
from repro.core import two_way as jax_two_way
from repro.core.adapt import AdaptPolicy as JaxPolicy
from repro.core.adapt import TenantDriftBank as JaxBank
from repro.data import mixed_workload as jax_mixed_workload
from repro.launch.mesh import make_mesh_compat
from repro.serve import JoinServingEngine as JaxEngine
from repro_torch.core import (AdaptPolicy, TenantDriftBank, canonical,
                              reference_join, running_example, two_way)
from repro_torch.data import mixed_workload, skewed_join_dataset
from repro_torch.serve import JoinServingEngine


def _jax_engine(**kw):
    return JaxEngine(make_mesh_compat((8,), ("cells",)), k=8, **kw)


def _port_engine(**kw):
    return JoinServingEngine(8, device="cpu", **kw)


# Each package's engine, adaptation classes and queries (the data are
# shared numpy arrays).
JAX = SimpleNamespace(engine=_jax_engine, Policy=JaxPolicy, Bank=JaxBank,
                      two_way=jax_two_way, running_example=jax_running_example,
                      mixed_workload=jax_mixed_workload)
PORT = SimpleNamespace(engine=_port_engine, Policy=AdaptPolicy,
                       Bank=TenantDriftBank, two_way=two_way,
                       running_example=running_example,
                       mixed_workload=mixed_workload)


def _tenant_stats(stats):
    """A tenant's stats without the port's `replans`, which the reference
    lacks and which must be 0 wherever the reference is exact."""
    stats = dict(stats)
    assert stats.pop("replans", 0) == 0
    return stats


def _request(req, eng):
    """What both engines must agree on for a served request."""
    return dict(done=req.done, bucket=req.bucket, tenant=req.tenant,
                rows=np.asarray(req.rows, np.int64),
                tenant_stats=_tenant_stats(eng.tenants[req.tenant].stats))


def _engine_stats(eng):
    st = dict(eng.stats)
    st["tenants"] = {name: _tenant_stats(ts)
                     for name, ts in st["tenants"].items()}
    return st


def _same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            _same(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def _both(scenario, *args):
    """`scenario(pkg, ...)` for JAX and the port: equal trails.  Returns
    the port's."""
    want, got = scenario(JAX, *args), scenario(PORT, *args)
    _same(got, want)
    return got


def _exact(req, query, data):
    assert req["done"]
    np.testing.assert_array_equal(canonical(req["rows"]),
                                  canonical(reference_join(query, data)))


def _serve_all(eng, subs):
    """Submit `(tenant, query, data)`s, drain the engine, return the
    requests' trails and the engine's stats."""
    reqs = [eng.submit(t, q, d) for t, q, d in subs]
    eng.run()
    return [_request(r, eng) for r in reqs], _engine_stats(eng)


def _data(n, dom, seed, skew=None):
    return skewed_join_dataset(two_way(), n, dom, skew=skew, seed=seed)


def _warm_reuse(pkg):
    eng = pkg.engine()
    q = pkg.two_way()
    out = _serve_all(eng, [("t", q, _data(400, 800, s)) for s in range(4)])
    # Steady state: a fifth same-bucket request builds nothing.
    c0 = eng.cache.compile_count()
    last = _serve_all(eng, [("t", q, _data(400, 800, 9))])
    return out, last, eng.cache.compile_count() - c0


def test_single_tenant_warm_reuse_and_exact():
    """Same-bucket requests of one tenant share one prepared session: one
    prepare, one build, every result exact."""
    (reqs, st), (last, _), built = _both(_warm_reuse)
    for s, req in enumerate(reqs):
        _exact(req, two_way(), _data(400, 800, s))
    assert st["tenants"]["t"]["prepares"] == 1
    assert st["cache"]["hits"] == 3 and st["cache"]["misses"] == 1
    assert built == 0 and last[0]["done"]


@pytest.fixture(scope="module")
def mixed9():
    """Nine `mixed_workload` requests through both engines, each fed its
    own package's stream (equal array for array), once for the tests that
    read them."""
    return (list(mixed_workload(9, seed=0)),
            _both(lambda pkg: _serve_all(pkg.engine(),
                                         pkg.mixed_workload(9, seed=0))))


def test_multi_tenant_interleaved_exact_with_split_stats(mixed9):
    """Three structurally distinct tenants interleave on one engine;
    results stay exact per request and the shared sessions' counters split
    out into per-tenant stats."""
    subs, (reqs, st) = mixed9
    for req, (_, q, d) in zip(reqs, subs):
        _exact(req, q, d)
    assert st["requests"] == 9
    assert set(st["tenants"]) == {"pairs", "chain3", "chain4"}
    for name, ts in st["tenants"].items():
        assert ts["requests"] == 3, name
        assert ts["rows_in"] > 0
        assert ts["batches"] >= 3            # retries add attempts
    # Distinct structures -> distinct executors, never shared.
    assert st["cache"]["executors"] == 3


def test_per_tenant_stats_sum_to_the_engines(mixed9):
    """The per-tenant split loses nothing: requests, step builds and
    prepares sum to the engine's requests, builds and cache misses."""
    _, (reqs, st) = mixed9
    tenants = st["tenants"].values()
    assert sum(ts["requests"] for ts in tenants) == st["requests"] == 9
    assert sum(ts["compiles"] for ts in tenants) == st["compiles"]
    assert sum(ts["prepares"] for ts in tenants) == st["cache"]["misses"]
    assert sum(ts["rows_out"] for ts in tenants) == \
        sum(len(r["rows"]) for r in reqs)


def _bucketing(pkg):
    eng = pkg.engine()
    q = pkg.two_way()
    first = _serve_all(eng, [("t", q, _data(n, 800, seed))
                             for n, seed in ((300, 1), (400, 2), (500, 3))])
    second = _serve_all(eng, [("t", q, _data(600, 800, 4))])   # bucket 1024
    return first, second


def test_shape_bucketing_shares_executables():
    """Requests whose row counts land in one geometric bucket share a
    prepared session (cache hit); a count past the bucket edge is a miss."""
    (reqs, st), (_, st2) = _both(_bucketing)
    assert {r["bucket"] for r in reqs} == {(512, 512)}
    assert st["cache"]["hits"] == 2 and st["cache"]["misses"] == 1
    assert st2["cache"]["misses"] == 2
    assert st2["cache"]["sessions"] == 2
    assert st2["cache"]["executors"] == 1         # same structure


def _collision(pkg, d_small, d_big):
    eng = pkg.engine()
    q = pkg.two_way()
    out = _serve_all(eng, [("small", q, d_small), ("big", q, d_big)])
    (ex,) = eng.cache._executors.values()
    shapes = sorted({key[0] for key in ex._step_cache})
    same_key = eng.tenants["small"].struct_key == eng.tenants["big"].struct_key
    return out, [[list(s) for s in sh] for sh in shapes], same_key


def test_structural_collision_does_not_share_steps():
    """Two tenants colliding on (k, route specs) but differing in shapes
    share ONE executor yet get distinct sessions and distinct steps — and
    both stay exact."""
    d_small, d_big = _data(300, 900, 5), _data(900, 900, 6)
    (reqs, st), shapes, same_key = _both(_collision, d_small, d_big)
    _exact(reqs[0], two_way(), d_small)
    _exact(reqs[1], two_way(), d_big)
    assert st["cache"]["executors"] == 1          # structures collide
    assert st["cache"]["sessions"] == 2           # shapes do not
    assert same_key
    assert len(shapes) >= 2                       # one step per shape


def _eviction(pkg, d_a, d_b):
    eng = pkg.engine(max_sessions=1)
    q = pkg.two_way()
    cold = [_serve_all(eng, [("t", q, d)]) for d in (d_a, d_b)]
    evictions = eng.cache.stats["evictions"]
    c0 = eng.cache.compile_count()
    p0 = eng.tenants["t"].stats["prepares"]
    replay = [_serve_all(eng, [("t", q, d)]) for d in (d_a, d_b)]
    return (cold, replay, evictions, eng.cache.compile_count() - c0,
            eng.tenants["t"].stats["prepares"] - p0)


def test_session_eviction_reprepares_warm_and_bit_exact():
    """Evicting a live tenant's session is transparent: the next request
    re-prepares (a miss) but the executor's step cache keeps the bucket's
    step, so ZERO new builds — and the replayed request is bit-exact."""
    d_a, d_b = _data(300, 800, 7), _data(900, 800, 8)   # buckets 512, 1024
    cold, replay, evictions, built, prepares = _both(_eviction, d_a, d_b)
    assert evictions >= 1                         # the bound forced one
    for (c, _), (r, _) in zip(cold, replay):
        np.testing.assert_array_equal(canonical(r[0]["rows"]),
                                      canonical(c[0]["rows"]))
    assert built == 0                             # warm re-prepare
    assert prepares == 2


def _round_robin(pkg):
    eng = pkg.engine(max_live=2)
    q = pkg.two_way()
    reqs = [eng.submit(t, q, _data(200, 500, s))
            for t in ("a", "b", "c") for s in (1, 2)]
    served = eng.step_round()
    eng.run()
    return served, [_request(r, eng) for r in reqs], _engine_stats(eng)


def test_round_robin_scheduling_drains_all_tenants():
    """`max_live` bounds each round; rotation keeps every tenant served."""
    served, reqs, st = _both(_round_robin)
    assert served == 2                            # bounded by max_live
    for i, req in enumerate(reqs):
        _exact(req, two_way(), _data(200, 500, 1 + i % 2))
    assert all(ts["requests"] == 2 for ts in st["tenants"].values())


def _switch(pkg):
    eng = pkg.engine()
    q, q3 = pkg.two_way(), pkg.running_example()
    out = _serve_all(eng, [("t", q, skewed_join_dataset(q, 100, 200,
                                                        seed=1))])
    with pytest.raises(ValueError, match="switched query structure") as err:
        eng.submit("t", q3, skewed_join_dataset(q3, 100, 200, seed=1))
    return out, str(err.value)


def test_tenant_query_switch_rejected():
    _both(_switch)


def _per_tenant(pkg):
    policy = pkg.Policy(replace_threshold=0.001, replan_threshold=0.99,
                        window=2, patience=1, min_batches=1,
                        replace_cooldown=1, replan_cooldown=99)
    eng = pkg.engine(adapt=policy)
    q = pkg.two_way()
    # Shifting seeds move load between cells -> TV drift > 0.001.
    subs = [("drifty", q, _data(400, 600, 40 + s, {"B": 0.8}))
            for s in range(4)] + [("calm", q, _data(300, 600, 50))]
    out = _serve_all(eng, subs)
    det_d, det_c = eng.adapt.get("drifty"), eng.adapt.get("calm")
    dets = [dict(batches=d.batches, history=list(d.history),
                 expected=d.expected.tolist()) for d in (det_d, det_c)]
    return out, dets, det_d is not det_c


def test_per_tenant_adaptation_is_isolated():
    """With adapt= enabled, a hair-trigger policy re-places the tenant that
    drifts without touching the others' detectors — and every result after
    the action stays exact."""
    (reqs, st), (det_d, det_c), distinct = _both(_per_tenant)
    for s, req in enumerate(reqs[:4]):
        _exact(req, two_way(), _data(400, 600, 40 + s, {"B": 0.8}))
    _exact(reqs[4], two_way(), _data(300, 600, 50))
    assert st["tenants"]["drifty"]["replacements"] >= 1
    # Isolation: each tenant windows only its own stream.
    assert distinct
    assert det_d["batches"] >= 4 and det_c["batches"] == 1
    assert det_d["history"]                       # acted on drifty


def _pruned(pkg, first, second):
    eng = pkg.engine()
    reqs = [eng.submit("t", pkg.two_way(), d) for d in (first, second)]
    eng.run()
    return ([np.asarray(r.rows, np.int64) for r in reqs],
            dict(eng.tenants["t"].stats))


def _empty_first():
    """A first request with S empty (a plan of no residual join), then a
    full one."""
    d = _data(300, 600, 1)
    return {"R": d["R"], "S": d["S"][:0]}, d


@pytest.mark.parametrize("pair,lost", [(pruned_pair, 2000),
                                       (_empty_first, None)])
def test_a_request_in_a_pruned_combination_is_replanned(pair, lost):
    """A request with rows in a type combination the tenant's plan pruned
    (empty in the request it was planned on) re-plans the tenant, counted
    in `replans`, and is exact.  The reference engine keeps its first plan
    and drops that combination's rows without a word: 2,000 of them, or
    every row where the first request left a relation empty."""
    first, second = pair()
    want = [reference_join(two_way(), d) for d in (first, second)]
    lost = len(want[1]) if lost is None else lost
    (jax_first, jax_second), _ = _pruned(JAX, first, second)
    rows, st = _pruned(PORT, first, second)
    np.testing.assert_array_equal(canonical(rows[0]), canonical(jax_first))
    for got, ref in zip(rows, want):
        np.testing.assert_array_equal(canonical(got), canonical(ref))
    assert st["replans"] == 1 and st["prepares"] == 2
    assert lost > 0 and len(jax_second) == len(want[1]) - lost


def _bank(pkg):
    bank = pkg.Bank(pkg.Policy(replace_threshold=0.05, replan_threshold=0.9,
                               patience=2, min_batches=1))
    base = np.ones(8)
    bank.register("a", base)
    bank.register("b", base)
    shifted = np.array([8, 1, 1, 1, 1, 1, 1, 1], float)
    verdicts = [bank.observe("a", shifted), bank.observe("a", shifted),
                bank.observe("b", base), bank.observe("unknown", shifted)]
    bank.rebaseline("a", shifted, action="replace")
    return verdicts, list(bank.get("a").history), list(bank.get("b").history)


def test_drift_bank_routes_by_tenant():
    """Host-side: the bank keeps per-tenant windows — one tenant's drift
    never advances another's streaks."""
    verdicts, hist_a, hist_b = _both(_bank)
    assert verdicts == ["stable", "replace", "stable", "stable"]
    assert hist_a and not hist_b


@pytest.mark.parametrize("n,seed", [(6, 3), (9, 0)])
def test_mixed_workload_equals_the_reference_and_is_deterministic(n, seed):
    """Same arguments -> byte-identical request stream, array for array
    the JAX package's."""
    a = list(mixed_workload(n, seed=seed))
    ref = list(jax_mixed_workload(n, seed=seed))
    assert len({t for t, _, _ in a}) == 3          # ≥ 3 distinct queries
    for (ta, qa, da), (tr, qr, dr), (tb, _, db) in zip(
            a, ref, mixed_workload(n, seed=seed)):
        assert ta == tr == tb
        assert [(r.name, r.attrs) for r in qa.relations] == \
            [(r.name, r.attrs) for r in qr.relations]
        assert list(da) == list(dr)
        for name in da:
            assert da[name].dtype == dr[name].dtype
            np.testing.assert_array_equal(da[name], dr[name])
            np.testing.assert_array_equal(da[name], db[name])
    c = list(mixed_workload(n, seed=seed + 1))
    assert any(not np.array_equal(da[k], dc[k])
               for (_, _, da), (_, _, dc) in zip(a, c) for k in da)
