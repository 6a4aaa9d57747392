"""Shared cases of the mesh tests (tests/test_torch_executor_mesh.py,
tests/test_torch_session_mesh.py and the card tests in
tests/test_torch_cuda.py): W ranks spawned over a file store, each running
the port's session over a `make_join_mesh` mesh on the same data.  The
session cases (`SESSION_CASES`) take a package namespace, so the tests run
them through the JAX package's SelfHealingSession and JoinServingEngine and
the port's one-process ones too.

Torch-only: a spawned rank imports this module (the spawn start method
imports the module its function lives in), so nothing here imports JAX or
the JAX package.  Each rank writes what it saw to `rank<r>.pkl` in the
run's directory; `spawn_ranks` / `join_ranks` start and join a group with
a deadline, and a rank's exception fails its caller."""
from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np
import torch

N_DEV = 8
WORLDS = (1, 2, 4, 8)
DEADLINE_S = 240.0              # a spawned group's wall-clock limit
COLLECTIVE_TIMEOUT_S = 60.0     # a collective's limit inside a rank
RESULT_KEYS = ("rows", "valid", "shuffle_overflow", "shuffle_overflow_by_rel",
               "join_overflow", "recv_counts")
STAT_KEYS = ("batches", "retries", "escalations", "shuffle_overflow",
             "join_overflow")
# The port's ExecutorConfig arms: (map, reduce) -> config fields.
ARMS = {"fused+hash": {}, "fused+sort": {"hash_reduce": False},
        "staged+hash": {"fuse_map": False},
        "staged+sort": {"fuse_map": False, "hash_reduce": False}}
SURVIVORS = tuple(d for d in range(N_DEV) if d != 3)


def dataset(name: str):
    """(query, data) of a named case dataset (the single-process executor
    tests' own)."""
    from repro_torch.core import running_example, two_way
    from repro_torch.data import chain_query, skewed_join_dataset
    if name == "two_way":
        q = two_way()
        return q, skewed_join_dataset(q, 300, 40, skew={"B": 1.5}, seed=21)
    if name == "running_example":
        q = running_example()
        return q, skewed_join_dataset(q, 200, 60, skew={"B": 1.2, "C": 1.2},
                                      seed=3)
    if name == "chain4":
        q = chain_query(4)
        return q, skewed_join_dataset(q, 3000, 1 << 16, skew={"X2": 1.5},
                                      seed=3)
    raise KeyError(name)


def out_capacity(query, data):
    """A per-device output capacity that holds every cascade step's whole
    intermediate join (the left-deep prefixes R0 ⋈ ... ⋈ Ri)."""
    from repro_torch.core import JoinQuery, reference_join
    from repro_torch.core.executor import quantize_capacity
    rels = query.relations
    biggest = max(len(reference_join(JoinQuery(rels[:i]), data))
                  for i in range(2, len(rels) + 1))
    return quantize_capacity(max(biggest, 1))


def half(data):
    return {name: arr[: len(arr) // 2] for name, arr in data.items()}


# name -> (dataset, k, arm, overlap_shuffle, steps, worlds): the steps run
# in order on one executor, so its step-cache counters take them all in.
CASES = {
    "two_way_k8": ("two_way", 8, "fused+hash", 0, ("run", "retry"), WORLDS),
    "two_way_k256": ("two_way", 256, "fused+hash", 0, ("run",), WORLDS),
    "running_example_k64": ("running_example", 64, "fused+hash", 0,
                            ("run",), WORLDS),
    "chain4_k64": ("chain4", 64, "fused+hash", 0, ("run",), WORLDS),
    **{f"two_way_k64_{arm}": ("two_way", 64, arm, 0, ("run", "refold"),
                              (1, 2, 4, 8) if arm == "fused+hash" else (4,))
       for arm in ARMS},
    **{f"two_way_k64_{arm}_c3": ("two_way", 64, arm, 3, ("run",), (2, 4))
       for arm in ("fused+hash", "staged+sort")},
}


def cases_of(world: int) -> list[str]:
    return [name for name, case in CASES.items() if world in case[5]]


def _result(res) -> dict:
    return {key: np.asarray(res[key]) for key in RESULT_KEYS}


def run_steps(ex, data, steps, lpt) -> dict:
    """The steps of a case on executor `ex` (the port's or the JAX
    package's: the session API is the same; `lpt` is its package's
    `lpt_placement`): what each step saw, as numpy and ints, and the
    step-cache counters after them all."""
    got: dict = {}
    for step in steps:
        seen = got[step] = {}
        if step == "run":
            s = ex.session().prepare(data)
            seen.update(caps=dict(s.caps), cap_out=s.cap_out,
                        table=np.asarray(s.placement.table),
                        count_passes=s.count_passes,
                        first=_result(s.run_batch()))
            seen["half"] = _result(s.run_batch(half(data)))
            seen["result_rows"] = ex.result_rows(data)
        elif step == "retry":     # a forced shuffle overflow healed
            probe = ex.session().prepare(data)
            squeezed = dict(probe.caps, R=max(probe.caps["R"] // 4, 1))
            s = ex.session().prepare(data, caps=squeezed,
                                     placement=probe.placement)
            seen["start_caps"] = dict(s.caps)
            seen["first"] = _result(s.run_with_retry())
            seen.update(caps=dict(s.caps), cap_out=s.cap_out,
                        stats={key: np.asarray(s.stats[key])
                               for key in STAT_KEYS})
        else:   # refold: count_batch, cell_loads and refold between batches
            s = ex.session().prepare(data)
            seen["first"] = _result(s.run_batch())
            seen["half"] = _result(s.run_batch(half(data)))
            seen["count_batch"] = [np.asarray(c) for c in s.count_batch()]
            seen["cell_loads"] = np.asarray(s.cell_loads())
            placement = lpt(seen["cell_loads"], N_DEV, devices=SURVIVORS)
            s.refold(placement)
            seen.update(table=np.asarray(placement.table), caps=dict(s.caps),
                        refolded=_result(s.run_batch(data)))
            s.refold(placement, counts=s.count_batch())
            seen["batch_caps"] = dict(s.caps)
            seen["count_passes"] = s.count_passes
    got["counters"] = (ex.compile_count, ex.step_hits, ex.evicted_steps)
    return got


def run_case(name: str, device, mesh) -> dict:
    """One case over `mesh` (or in one process with mesh=None)."""
    from repro_torch.core import lpt_placement, plan_skew_join
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    ds, k, arm, chunks, steps, _ = CASES[name]
    q, data = dataset(ds)
    cfg = ExecutorConfig(out_capacity=out_capacity(q, data),
                         overlap_shuffle=chunks, **ARMS[arm])
    ex = ShardedJoinExecutor(plan_skew_join(q, data, k), N_DEV, cfg,
                             device=device, mesh=mesh)
    return run_steps(ex, data, steps, lpt_placement)


def refusals(world: int, mesh) -> dict:
    """What a mesh executor refuses (W not dividing n_devices), and a
    SelfHealingSession over it healing one squeezed batch: its rows in
    rank order (the test puts them together) and its retries."""
    from repro_torch.core import plan_skew_join
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    from repro_torch.ft import ChaosInjector
    from repro_torch.serve import SelfHealingSession
    q, data = dataset("two_way")
    plan = plan_skew_join(q, data, 64)
    out = {}
    if world > 1:
        try:
            ShardedJoinExecutor(plan, world + world // 2, device="cpu",
                                mesh=mesh)
        except ValueError as err:
            out["indivisible"] = str(err)
    chaos = ChaosInjector(N_DEV, seed=0)
    chaos.squeeze_caps(0.25)
    cfg = ExecutorConfig(out_capacity=out_capacity(q, data))
    eng = SelfHealingSession(ShardedJoinExecutor(plan, N_DEV, cfg,
                                                 device="cpu", mesh=mesh),
                             chaos=chaos).prepare(data)
    res = eng.run_batch()
    out["self_healing"] = dict(_result(res), retries=eng.stats["retries"])
    return out


def cpu_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """A gloo rank on the CPU: every case of `world`, then the refusals."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_join_mesh
    torch.set_num_threads(1)
    mesh = make_join_mesh("gloo", device="cpu", init_method=f"file://{store}",
                          rank=rank, world_size=world,
                          timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        got = {name: run_case(name, "cpu", mesh) for name in cases_of(world)}
        got["refusals"] = refusals(world, mesh)
        got["where"] = dict(rank=mesh.get_local_rank(), world=mesh.size())
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


# -- the session cases: SelfHealingSession (with and without adapt=) and
# JoinServingEngine over a mesh, held to the JAX package's and the port's
# one-process ones.  `pkg` names a package's classes (`port_package` here;
# the test builds the JAX package's): Session, Chaos, Policy, plan (the
# planner), executor(plan, cap_out), engine(), mixed_workload and
# evict(eng, devices), a rank's loss (`evict_rank` over a mesh).

SESSION_WORLDS = (2, 4)
HEAL_K = 32
HEAL_CAP_OUT = 65536


def heal_data():
    """The chaos suite's device-loss cell: two_way, 600 rows a relation,
    domain 50, B skewed 1.6, seed 52."""
    from repro_torch.core import two_way
    from repro_torch.data import skewed_join_dataset
    return skewed_join_dataset(two_way(), 600, 50, skew={"B": 1.6}, seed=52)


def lost_devices(world: int) -> list[int]:
    """The devices the chaos schedule loses: the last rank's of a W-rank
    mesh.  One rank holds every device, so at W = 1 the last two are lost
    by hand, as the last rank of four would be."""
    per = N_DEV // (world if world > 1 else 4)
    return list(range(N_DEV - per, N_DEV))


def session_state(eng, res=None) -> dict:
    """What a SelfHealingSession of either package shows after a batch:
    its stats, survivors, placement, caps, step builds and, given one, the
    batch's result (rows and valid the rank's own over a mesh)."""
    st = eng.stats
    out = dict(stats={k: (np.asarray(v).tolist()
                          if isinstance(v, np.ndarray) else v)
                      for k, v in st.items()},
               alive=list(eng.alive), evicted=list(eng.evicted),
               table=np.asarray(eng.session.placement.table).tolist(),
               caps=dict(eng.session.caps), cap_out=int(eng.session.cap_out),
               compiles=int(eng.executor.compile_count))
    if eng.detector is not None:
        out.update(hhs=dict(eng.executor.plan.hhs.per_attr),
                   history=list(eng.detector.history))
    if res is not None:
        out["result"] = _result(res)
    return out


def heal(pkg, world: int) -> list[dict]:
    """The chaos schedule: caps squeezed to 0.1 (a retry ladder of two
    rungs), device 3's heartbeats dropped (evicted on the virtual clock),
    device 5 delayed 30 s a step (two strikes, evicted), then the last
    rank's devices lost in one re-fold, and a degraded batch on other data.
    The state after every batch and every eviction."""
    from repro_torch.core import two_way
    from repro_torch.data import skewed_join_dataset
    data = heal_data()
    ex = pkg.executor(pkg.plan(pkg.two_way(), data, HEAL_K), HEAL_CAP_OUT)
    chaos = pkg.Chaos(N_DEV, seed=0)
    chaos.squeeze_caps(0.1)
    eng = pkg.Session(ex, chaos=chaos, heartbeat_timeout_s=2.5,
                      suspect_timeout_s=1.5, step_seconds=1.0,
                      straggler_threshold=1.5, evict_after=2).prepare(data)
    trail = [session_state(eng, eng.run_batch())]
    chaos.drop_heartbeats(3)
    while 3 not in eng.evicted and len(trail) < 8:
        trail.append(session_state(eng, eng.run_batch()))
    chaos.restore_heartbeats(3)
    chaos.delay_device(5, 30.0)
    while 5 not in eng.evicted and len(trail) < 16:
        trail.append(session_state(eng, eng.run_batch()))
    pkg.evict(eng, lost_devices(world))
    trail.append(session_state(eng))
    other = skewed_join_dataset(two_way(), 500, 50, skew={"B": 1.6},
                                seed=56)
    trail.append(session_state(eng, eng.run_batch(other)))
    return trail


def clock(pkg, world: int) -> list[dict]:
    """No chaos injector: the monitor on its own clock, per-device times
    from a `timing_fn` that makes device 6 ten times the wall (two strikes,
    evicted).  Over a mesh the clock readings and the wall are rank 0's,
    so every rank's monitor and watchdog hold the same numbers
    (`readings`, compared across ranks only)."""
    data = heal_data()
    ex = pkg.executor(pkg.plan(pkg.two_way(), data, HEAL_K), HEAL_CAP_OUT)
    slow = np.arange(N_DEV) == 6
    eng = pkg.Session(ex, evict_after=2,
                      timing_fn=lambda w: np.where(slow, 10.0 * w, w)
                      ).prepare(data)
    trail = []
    for _ in range(3):
        trail.append(session_state(eng, eng.run_batch()))
        trail[-1]["readings"] = dict(
            beats=sorted(eng.health._last_beat.items()),
            times=np.asarray(eng.watchdog._t).tolist())
    return trail


def adapt_forced(pkg, world: int) -> list[dict]:
    """tests/test_torch_adapt_session.py's forced actions: two batches, a
    forced re-place, a batch, a forced (warm) re-plan, a batch."""
    from _torch_adapt_cases import CAP_OUT, E2E_POL, HOT_A, K_PLAN, drift_batch
    data0 = drift_batch(HOT_A, seed=1)
    ex = pkg.executor(pkg.plan(pkg.two_way(), data0, K_PLAN), CAP_OUT)
    eng = pkg.Session(ex, adapt=pkg.Policy(**E2E_POL)).prepare(data0)
    trail = [session_state(eng, eng.run_batch(drift_batch(HOT_A, seed=90 + i)))
             for i in range(2)]
    eng.force_replace()
    trail.append(session_state(eng, eng.run_batch(drift_batch(HOT_A,
                                                              seed=92))))
    eng.force_replan()
    trail.append(session_state(eng, eng.run_batch(drift_batch(HOT_A,
                                                              seed=93))))
    for st in trail:
        st["original_executor"] = eng.executor is ex
    return trail


def _set_b(batch, rel, n, seed):
    """`batch` with column B set to 1 in n rows of `rel`, picked by
    default_rng(seed) (tests/test_torch_adapt_session.py's)."""
    from repro_torch.core import two_way
    out = {k: np.array(v) for k, v in batch.items()}
    col = two_way().relation(rel).attrs.index("B")
    rows = np.random.default_rng(seed).choice(len(out[rel]), n, replace=False)
    out[rel][rows, col] = 1
    return out


def adapt_pruned(pkg, world: int) -> list[dict]:
    """The pruned-combination stream (ROADMAP §3.1): batches 0-2 put B = 1
    in 300 of R's rows only, so batch 2 re-plans on its own and prunes
    B = 1; the fourth fills B = 1 in both relations and re-plans first in
    the port (the JAX session drops those rows: the test compares it on
    the first three batches only)."""
    from _torch_adapt_cases import CAP_OUT, E2E_POL, HOT_A, K_PLAN, drift_batch
    data0 = drift_batch(HOT_A, seed=1)
    ex = pkg.executor(pkg.plan(pkg.two_way(), data0, K_PLAN), CAP_OUT)
    eng = pkg.Session(ex, adapt=pkg.Policy(**E2E_POL)).prepare(data0)
    batches = [_set_b(drift_batch(HOT_A, seed=60 + i), "R", 300, i)
               for i in range(3)]
    batches.append(_set_b(_set_b(drift_batch(HOT_A, seed=70), "R", 300, 9),
                          "S", 40, 10))
    return [session_state(eng, eng.run_batch(b)) for b in batches]


def engine(pkg, world: int) -> list[dict]:
    """`mixed_workload(6, seed=0)` through a JoinServingEngine at k = 8:
    each request's rows (the rank's own over a mesh), bucket and tenant
    stats, then the engine's stats."""
    eng = pkg.engine()
    reqs = [eng.submit(t, q, d) for t, q, d in pkg.mixed_workload(6, seed=0)]
    eng.run()
    out = [dict(done=r.done, bucket=r.bucket, tenant=r.tenant,
                rows=np.asarray(r.rows, np.int64),
                tenant_stats=dict(eng.tenants[r.tenant].stats))
           for r in reqs]
    return out + [dict(stats=eng.stats)]


def port_package(mesh=None, device="cpu"):
    """The port's namespace for the session cases, over `mesh` or in one
    process on `device`."""
    from types import SimpleNamespace

    from repro_torch.core import AdaptPolicy, plan_skew_join, two_way
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    from repro_torch.data import mixed_workload
    from repro_torch.ft import ChaosInjector
    from repro_torch.serve import SelfHealingSession
    from repro_torch.serve.join_engine import JoinServingEngine

    def evict(eng, devices):
        if mesh is None or mesh.size() == 1:    # those still alive
            eng.evict_devices([d for d in devices if d in eng.alive])
        else:
            assert devices == lost_devices(mesh.size()), devices
            eng.evict_rank(mesh.size() - 1)

    return SimpleNamespace(
        Session=SelfHealingSession, Chaos=ChaosInjector, Policy=AdaptPolicy,
        two_way=two_way, plan=plan_skew_join, mixed_workload=mixed_workload,
        executor=lambda plan, cap_out: ShardedJoinExecutor(
            plan, N_DEV, ExecutorConfig(out_capacity=cap_out),
            device=None if mesh is not None else device, mesh=mesh),
        engine=lambda: JoinServingEngine(
            N_DEV, device=None if mesh is not None else device, mesh=mesh),
        evict=evict)


# name -> case(pkg, world): the trail of states the tests compare.
SESSION_CASES = {"heal": heal, "clock": clock, "adapt_forced": adapt_forced,
                 "adapt_pruned": adapt_pruned, "engine": engine}


def same(got, want, where: str = "") -> None:
    """Nested dicts, lists and arrays equal, naming where they differ."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            same(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=where)
    else:
        assert got == want, where


def put_together(trails: list[list[dict]], where: str) -> list[dict]:
    """One trail from the ranks' trails of a session case, each state's
    rank-local parts (a batch's rows and valid flags, a request's rows)
    concatenated in rank order; everything else must be equal on every
    rank."""
    assert len({len(t) for t in trails}) == 1, where
    out = []
    for i, states in enumerate(zip(*trails)):
        first = dict(states[0])
        local = [k for k in ("result", "rows") if k in first]
        for other in states[1:]:
            same({k: v for k, v in other.items() if k not in local},
                 {k: v for k, v in first.items() if k not in local},
                 f"{where}[{i}] across ranks")
        if "rows" in first:
            first["rows"] = np.concatenate([st["rows"] for st in states])
        if "result" in first:
            res = dict(first["result"])
            for key in ("rows", "valid"):
                res[key] = np.concatenate([st["result"][key]
                                           for st in states])
            first["result"] = res
        out.append(first)
    return out


def without_readings(trail: list[dict]) -> list[dict]:
    """A trail without the rank-agreed clock readings (`clock`), which a
    one-process run reads from its own clock."""
    return [{k: v for k, v in st.items() if k != "readings"} for st in trail]


def session_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """A gloo rank on the CPU: every session case over the mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_join_mesh
    torch.set_num_threads(1)
    mesh = make_join_mesh("gloo", device="cpu", init_method=f"file://{store}",
                          rank=rank, world_size=world,
                          timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        pkg = port_package(mesh)
        got = {name: case(pkg, world)
               for name, case in SESSION_CASES.items()}
        got["where"] = dict(rank=mesh.get_local_rank(), world=mesh.size())
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def card_session_rank(rank: int, world: int, backend: str, store: str
                      ) -> None:
    """A rank on card 0 (gloo ranks share it; one NCCL rank): every session
    case over the mesh, put together with the other ranks' (one
    all_gather_object a case) and held to the one-process session and
    engine on the card, which this rank runs too."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_join_mesh
    mesh = make_join_mesh(backend, device="cuda:0" if backend == "gloo"
                          else None, init_method=f"file://{store}",
                          rank=rank, world_size=world,
                          timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        pkg, one = port_package(mesh), port_package(device="cuda")
        for name, case in SESSION_CASES.items():
            got = case(pkg, world)
            trails = [None] * world
            dist.all_gather_object(trails, got)
            label = f"{name} {backend} rank {rank} of {world}"
            want = case(one, world)
            got = put_together(trails, label)
            if name == "clock":
                got, want = without_readings(got), without_readings(want)
            same(got, want, label)
    finally:
        dist.destroy_process_group()


# The card cases: test_torch_cuda.py's executor cases (query, skew, k) on
# 200 rows a relation, domain 60, seed 3; arms and C of each card run.
CARD_CASES = (("two_way", {"B": 1.5}, 64),
              ("running_example", {"B": 1.2, "C": 1.2}, 256),
              ("chain4", {"X2": 1.2}, 64))
CARD_ARMS = ("fused+hash", "staged+sort")


def _card_data(name: str, skew):
    from repro_torch.core import running_example, two_way
    from repro_torch.data import chain_query, skewed_join_dataset
    q = {"two_way": two_way, "running_example": running_example,
         "chain4": lambda: chain_query(4)}[name]()
    return q, skewed_join_dataset(q, 200, 60, skew=skew, seed=3)


def card_rank(rank: int, world: int, backend: str, store: str,
              chunks: tuple[int, ...]) -> None:
    """A rank on card 0 (gloo ranks share it; one NCCL rank): each card
    case on each of CARD_ARMS and each C in `chunks` over the mesh, held
    to the one-process card session: this rank's rows and valid flags
    `torch.equal` to its destinations', every counter, the caps, the
    placement and result_rows equal, no step built by a second batch."""
    import torch.distributed as dist
    from repro_torch.core import plan_skew_join
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    from repro_torch.launch.mesh import make_join_mesh
    mesh = make_join_mesh(backend, device="cuda:0" if backend == "gloo"
                          else None, init_method=f"file://{store}",
                          rank=rank, world_size=world,
                          timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        per = N_DEV // world
        mine = slice(rank * per, (rank + 1) * per)
        for (name, skew, k), arm, c in [
                (case, arm, c) for case in CARD_CASES for arm in CARD_ARMS
                for c in chunks]:
            q, data = _card_data(name, skew)
            plan = plan_skew_join(q, data, k)
            cfg = ExecutorConfig(out_capacity=1 << 17, overlap_shuffle=c,
                                 **ARMS[arm])
            one = ShardedJoinExecutor(plan, N_DEV, cfg, device="cuda")
            s1 = one.session().prepare(data)
            want = s1.run_batch()
            ex = ShardedJoinExecutor(plan, N_DEV, cfg, mesh=mesh)
            assert ex.device == torch.device("cuda", 0), ex.device
            s = ex.session().prepare(data)
            label = f"{name} k={k} {arm} C={c} rank {rank} of {world}"
            assert s.caps == s1.caps, label
            assert np.array_equal(s.placement.table, s1.placement.table), label
            for res in (s.run_batch(), s.run_batch()):
                assert torch.equal(res.tensors[0], want.tensors[0][mine]), label
                assert torch.equal(res.tensors[1], want.tensors[1][mine]), label
                for key in RESULT_KEYS[2:]:
                    assert np.array_equal(res[key], want[key]), (label, key)
                assert int(res["shuffle_overflow"].sum()) == 0, label
                assert int(res["join_overflow"].sum()) == 0, label
            assert (ex.compile_count, ex.step_hits) == (1, 1), label
            assert np.array_equal(ex.result_rows(data),
                                  one.result_rows(data)), label
    finally:
        dist.destroy_process_group()


def nccl_shared_card_rank(rank: int, world: int, store: str) -> None:
    """NCCL ranks all naming card 0: refused on every rank before any
    process group exists."""
    import torch.distributed as dist
    from repro_torch.core.executor import ExecutorError
    from repro_torch.launch.mesh import make_join_mesh
    try:
        make_join_mesh("nccl", device="cuda:0", init_method=f"file://{store}",
                       rank=rank, world_size=world,
                       timeout_s=COLLECTIVE_TIMEOUT_S)
    except ExecutorError as err:
        assert "would share the card" in str(err), err
    else:
        raise AssertionError("two NCCL ranks on one card were not refused")
    assert not dist.is_initialized()


def spawn_ranks(fn, world: int, *args):
    """Start `world` ranks of `fn(rank, world, *args)` with the spawn
    start method; `join_ranks` waits for them."""
    import torch.multiprocessing as mp
    return mp.start_processes(fn, args=(world, *args), nprocs=world,
                              join=False, start_method="spawn")


def join_ranks(ctx, deadline: float) -> None:
    """Join a spawned group by `deadline` (time.monotonic()); a rank's
    exception re-raises here, and a group past the deadline is killed and
    fails."""
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{len(ctx.processes)} ranks still "
                                   f"running at their deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def load_ranks(out_dir, world: int) -> list[dict]:
    ranks = []
    for r in range(world):
        with open(Path(out_dir) / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks
