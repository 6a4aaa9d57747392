"""Shared cases of the mesh tests (tests/test_torch_executor_mesh.py and
the card tests in tests/test_torch_cuda.py): W ranks spawned over a file
store, each running the port's session over a `make_join_mesh` mesh on
the same data.

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
    """What a mesh executor refuses: W not dividing n_devices, and a
    SelfHealingSession over it."""
    from repro_torch.core import plan_skew_join
    from repro_torch.core.executor import ShardedJoinExecutor
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
    try:
        SelfHealingSession(ShardedJoinExecutor(plan, N_DEV, device="cpu",
                                               mesh=mesh))
    except ValueError as err:
        out["self_healing"] = str(err)
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
