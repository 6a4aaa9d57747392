"""The port's executor over a mesh of W gloo ranks on the CPU against the
JAX executor on 8 virtual devices, n_dev = 8.

W ∈ {1, 2, 4, 8} ranks each run every case of their W in one spawn
(`_torch_mesh_cases.cpu_rank`, torch-only); all four groups start at once
and the JAX sessions run while they do.  The ranks' rows and valid masks
put together in rank order must equal the JAX arrays bit for bit, and
every rank's counters, caps, placement, stats and step-cache counters the
JAX session's."""
import time

import numpy as np
import pytest
import torch

import _torch_mesh_cases as mc
from repro.core import plan_skew_join as jax_plan
from repro.core import running_example as jax_running_example
from repro.core import two_way as jax_two_way
from repro.core.executor import ExecutorConfig as JaxConfig
from repro.core.executor import ShardedJoinExecutor as JaxExecutor
from repro.core.placement import lpt_placement as jax_lpt_placement
from repro.data import chain_query as jax_chain_query
from repro.launch.mesh import make_mesh_compat
from repro_torch.core import canonical, reference_join
from repro_torch.core.executor import ExecutorError
from repro_torch.launch.mesh import make_join_mesh

JAX_QUERIES = {"two_way": jax_two_way, "running_example": jax_running_example,
               "chain4": lambda: jax_chain_query(4)}


def jax_key(name):
    """Cases with equal keys share one JAX run: every arm's reference is
    the fused + hash session, which the JAX package pins bit-identical to
    its other arms."""
    ds, k, _, chunks, steps, _ = mc.CASES[name]
    return ds, k, chunks, steps


def jax_case(key):
    """The JAX session's side of `mc.run_case`, on a fresh executor."""
    ds, k, chunks, steps = key
    q, data = mc.dataset(ds)
    ex = JaxExecutor(jax_plan(JAX_QUERIES[ds](), data, k),
                     make_mesh_compat((mc.N_DEV,), ("cells",)),
                     config=JaxConfig(out_capacity=mc.out_capacity(q, data),
                                      overlap_shuffle=chunks))
    return mc.run_steps(ex, data, steps, jax_lpt_placement)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{W: every rank's results} and {case: the JAX session's}."""
    deadline = time.monotonic() + mc.DEADLINE_S
    groups = {}
    for world in mc.WORLDS:
        d = tmp_path_factory.mktemp(f"mesh{world}")
        groups[world] = (d, mc.spawn_ranks(mc.cpu_rank, world,
                                           str(d / "store"), str(d)))
    try:
        want = {key: jax_case(key)
                for key in dict.fromkeys(map(jax_key, mc.CASES))}
    finally:
        for _, ctx in groups.values():
            mc.join_ranks(ctx, deadline)
    return ({world: mc.load_ranks(d, world)
             for world, (d, _) in groups.items()}, want)


def _same_result(ranks, want, key):
    """Rows and valid masks put together in rank order, every counter on
    every rank."""
    for field in mc.RESULT_KEYS:
        got = [np.asarray(r[key][field]) for r in ranks]
        if field in ("rows", "valid"):
            np.testing.assert_array_equal(np.concatenate(got), want[key][field],
                                          err_msg=f"{key}/{field}")
        else:
            for g in got:
                np.testing.assert_array_equal(g, want[key][field],
                                              err_msg=f"{key}/{field}")


def _same_everywhere(ranks, want, key):
    for r in ranks:
        got, exp = r[key], want[key]
        if isinstance(exp, dict):
            assert got.keys() == exp.keys(), key
            for name in exp:
                np.testing.assert_array_equal(np.asarray(got[name]),
                                              np.asarray(exp[name]),
                                              err_msg=f"{key}/{name}")
        elif isinstance(exp, list):
            assert len(got) == len(exp), key
            for g, e in zip(got, exp):
                np.testing.assert_array_equal(g, np.asarray(e), err_msg=key)
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(exp),
                                          err_msg=key)


CASE_PARAMS = [(world, name) for world in mc.WORLDS
               for name in mc.cases_of(world)]
COMPARED = ("caps", "cap_out", "table", "count_passes", "start_caps", "stats",
            "count_batch", "cell_loads", "batch_caps", "result_rows")


@pytest.mark.parametrize("world,name", CASE_PARAMS,
                         ids=[f"W{w}-{n}" for w, n in CASE_PARAMS])
def test_mesh_matches_jax(runs, world, name):
    ranks, want = runs[0][world], runs[1][jax_key(name)]
    assert [r["where"] for r in ranks] == [dict(rank=i, world=world)
                                           for i in range(world)]
    q, data = mc.dataset(mc.CASES[name][0])
    for step in mc.CASES[name][4]:
        got = [r[name][step] for r in ranks]
        for key in ("first", "half", "refolded"):
            if key in want[step]:
                _same_result(got, want[step], key)
        for key in COMPARED:
            if key in want[step]:
                _same_everywhere(got, want[step], key)
        first = want[step]["first"]
        assert first["shuffle_overflow"].sum() == 0
        assert first["join_overflow"].sum() == 0
        np.testing.assert_array_equal(
            canonical(first["rows"][first["valid"]]), reference_join(q, data))
    for r in ranks:
        assert r[name]["counters"] == want["counters"]
    if "retry" in want:
        assert want["retry"]["stats"]["retries"] >= 1
        assert want["retry"]["caps"]["R"] > want["retry"]["start_caps"]["R"]
    if "refold" in want:
        assert want["refold"]["refolded"]["recv_counts"][3] == 0


@pytest.mark.parametrize("world", [w for w in mc.WORLDS if w > 1])
def test_mesh_refuses_what_it_does_not_take(runs, world):
    """W not dividing n_devices is refused on every rank, and a
    SelfHealingSession over a mesh executor heals a batch whose caps were
    squeezed to a quarter: its rows, put together in rank order, are the
    exact join, with the same retries on every rank."""
    ranks = runs[0][world]
    for r in ranks:
        assert "do not divide n_devices" in r["refusals"]["indivisible"]
    healed = [r["refusals"]["self_healing"] for r in ranks]
    assert healed[0]["retries"] >= 1
    assert all(h["retries"] == healed[0]["retries"] for h in healed)
    rows = np.concatenate([h["rows"] for h in healed])
    valid = np.concatenate([h["valid"] for h in healed])
    for h in healed:
        assert h["shuffle_overflow"].sum() == h["join_overflow"].sum() == 0
    q, data = mc.dataset("two_way")
    np.testing.assert_array_equal(canonical(rows[valid]),
                                  reference_join(q, data))


def test_make_join_mesh_refuses_nccl_on_the_cpu(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(ExecutorError, match="NCCL runs on the card"):
        make_join_mesh("nccl", device="cpu", init_method=store, rank=0,
                       world_size=1)
    with pytest.raises(ExecutorError, match="name backend='gloo'"):
        make_join_mesh(device="cpu", init_method=store, rank=0, world_size=1)
    with pytest.raises(ExecutorError, match="not one of"):
        make_join_mesh("mpi", device="cpu", init_method=store, rank=0,
                       world_size=1)
    assert not torch.distributed.is_initialized()


def test_make_join_mesh_refuses_two_nccl_ranks_on_one_card(monkeypatch,
                                                           tmp_path):
    """Rank 1 of 2 on a host with one card: its card cuda:1 does not
    exist, so the two NCCL ranks would share cuda:0; refused before any
    process group or CUDA call."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ExecutorError, match="would share a card"):
        make_join_mesh(init_method=f"file://{tmp_path / 'store'}", rank=1,
                       world_size=2)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ExecutorError, match="would share a card"):
        make_join_mesh(init_method=f"file://{tmp_path / 'store'}")
    assert not torch.distributed.is_initialized()


def test_make_join_mesh_one_gloo_rank_on_the_cpu(tmp_path):
    """A mesh of one gloo rank: the "cells" dimension over the default
    group; a second call while it exists is refused."""
    mesh = make_join_mesh("gloo", device="cpu",
                          init_method=f"file://{tmp_path / 'store'}", rank=0,
                          world_size=1)
    try:
        assert mesh.mesh_dim_names == ("cells",) and mesh.size() == 1
        assert mesh.device_type == "cpu"
        with pytest.raises(ExecutorError, match="exists already"):
            make_join_mesh("gloo", device="cpu", rank=0, world_size=1,
                           init_method=f"file://{tmp_path / 'other'}")
    finally:
        torch.distributed.destroy_process_group()
