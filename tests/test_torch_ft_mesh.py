"""Fault tolerance over a (data, model) mesh of 4 gloo ranks on the CPU,
the counterpart of tests/test_ft.py's resharding restore (lines 47-66)
and elastic training (lines 130-166): a checkpoint saved on (2, 2)
restores on (1, 2) bit for bit, and either package restores the other's
sharded checkpoint; a reduced qwen2-0.5b step on (2, 2), a save, DP row 0
fails, `survivors_mesh` and `elastic_remesh` give (1, 2), and the next
step there has a finite loss and optimizer step 2, as the JAX package's
same schedule (float32 parameters here, so that the losses compare at
rtol 1e-5; the reference's test keeps bf16); and `launch.train --mesh
2x2` through a failure at step 3, the ranks of the failed row leaving and
the survivors going on from the last checkpoint.  The ranks' side is
tests/_torch_lm_mesh_cases.py (`ft_rank`, `driver_rank`), both groups
spawned at once."""
import dataclasses
import pickle
import re
import socket
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_lm_mesh_cases as lc
import _torch_mesh_cases as mc
from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.configs import ARCHS
from repro.ft import elastic_remesh, survivors_mesh
from repro.models.common import init_params
from repro.optim import AdamWConfig, adamw
from repro.train import build_train_step

TOL = dict(rel=1e-5)


def _mesh(shape):
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))


def _jax_tree(mesh):
    tree = {k: jnp.asarray(v.float().numpy() if k == "b" else v.numpy())
            for k, v in lc.ft_tree().items()}
    tree["b"] = tree["b"].astype(jnp.bfloat16)
    sh = {"w": NamedSharding(mesh, P("data", "model")),
          "b": NamedSharding(mesh, P()), "step": NamedSharding(mesh, P())}
    return {k: jax.device_put(v, sh[k]) for k, v in tree.items()}, sh


def _jax_elastic():
    """The reference's elastic schedule on (2, 2) -> (1, 2), float32."""
    cfg = dataclasses.replace(ARCHS["qwen2-0.5b"].reduced(), remat="none")
    babs = {k: jax.ShapeDtypeStruct((lc.FT_B, lc.FT_S), jnp.int32)
            for k in ("tokens", "labels")}
    ocfg = AdamWConfig(lr=lc.FT_LR)
    mesh = _mesh((2, 2))
    fns = build_train_step(cfg, mesh, babs, donate=False, opt_cfg=ocfg)
    params = init_params(fns.layout, jax.random.key(0), jnp.float32)
    start = jax.device_get(params)
    params = jax.device_put(params, fns.param_shardings)
    opt = jax.device_put(adamw.init(params, ocfg), fns.opt_shardings)
    batch = {k: jnp.asarray(v) for k, v in lc.ft_batch().items()}
    params, opt, m0 = fns.step(params, opt, batch)
    with tempfile.TemporaryDirectory() as d:
        ck = JCheckpointer(d)
        ck.save(1, {"params": params, "opt": opt}, blocking=True)
        small = survivors_mesh(mesh, failed_dp_rows=[0])
        fns2 = build_train_step(cfg, small, babs, donate=False,
                                opt_cfg=ocfg)
        abstract = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
            {"params": params, "opt": opt})
        _, state = elastic_remesh(ck, abstract,
                                  {"params": fns2.param_shardings,
                                   "opt": fns2.opt_shardings})
    _, o2, m1 = fns2.step(state["params"], state["opt"], batch)
    return start, [jax.device_get(m0), jax.device_get(m1)], int(o2["step"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ft_mesh")
    tree, _ = _jax_tree(_mesh((4, 2)))
    JCheckpointer(str(d / "jax_ckpt")).save(5, tree, blocking=True)
    start, want, want_step = _jax_elastic()
    with open(d / "qwen2.pkl", "wb") as f:
        pickle.dump(start, f)
    drv = tmp_path_factory.mktemp("driver_mesh")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    deadline = time.monotonic() + lc.DEADLINE_S
    groups = [mc.spawn_ranks(lc.ft_rank, 4, str(d / "store"), str(d)),
              mc.spawn_ranks(lc.driver_rank, 4, port, str(drv))]
    for ctx in groups:
        mc.join_ranks(ctx, deadline)
    logs = [(drv / f"rank{r}.log").read_text() for r in range(4)]
    return d, mc.load_ranks(d, 4), want, want_step, logs


def _assemble(ranks, part, shape, dtype):
    out = np.full(shape, np.nan, dtype)
    for got in ranks:
        for key, (offset, block) in got[part].items():
            if key == "w":
                out[tuple(slice(o, o + n) for o, n in
                          zip(offset, block.shape))] = block
    return out


def test_checkpoint_saved_on_2x2_restores_on_1x2(runs):
    _, ranks, *_ = runs
    want = lc.ft_tree()
    assert ranks[0]["saved_files"] == ["COMMITTED", "manifest.json",
                                       "shard_0.npz", "shard_1.npz",
                                       "shard_2.npz", "shard_3.npz"]
    small = [r for r in ranks if "small" in r]
    assert len(small) == 2                       # ranks 0 and 1
    np.testing.assert_array_equal(
        _assemble([r["small"] for r in small], "blocks", (8, 8), np.float32),
        want["w"].numpy())
    for r in small:
        got = r["small"]
        assert got["step"] == 3
        assert got["blocks"]["w"][1].shape == (8, 4)
        np.testing.assert_array_equal(got["blocks"]["b"][1], np.ones(3))
        assert got["blocks"]["step"][1] == 7
        assert got["dtypes"] == {"w": "torch.float32", "b": "torch.bfloat16",
                                 "step": "torch.int32"}


def test_jax_checkpoint_restores_on_the_port_mesh(runs):
    _, ranks, *_ = runs
    np.testing.assert_array_equal(
        _assemble(ranks, "from_jax", (8, 8), np.float32),
        lc.ft_tree()["w"].numpy())
    for r in ranks:
        assert r["from_jax"]["w"][1].shape == (4, 4)
        assert r["from_jax"]["step"][1] == 7


def test_port_mesh_checkpoint_restores_in_jax(runs):
    d, *_ = runs
    tree, sh = _jax_tree(_mesh((2, 2)))
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            tree)
    back = JCheckpointer(str(d / "ckpt")).restore(3, abstract, sh)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(tree[k]))


def test_elastic_training_over_the_mesh(runs):
    _, ranks, want, want_step, _ = runs
    assert [r["survivor"] for r in ranks] == [False, False, True, True]
    for r in ranks[2:]:
        assert r["restored_step"] == 1 and r["shape"] == (1, 2)
        assert r["opt_step"] == want_step == 2   # optimizer state carried
        assert np.isfinite(float(r["metrics"][1]["loss"]))
        for got, w in zip(r["metrics"], want):
            for k in ("loss", "zloss", "grad_norm"):
                assert float(got[k]) == pytest.approx(float(w[k]), **TOL), k


def test_driver_remeshes_onto_the_survivors(runs):
    *_, logs = runs
    assert "mesh={'data': 2, 'model': 2}" in logs[0]
    assert ("[FT] re-meshing {'data': 2, 'model': 2} -> "
            "{'data': 1, 'model': 2}, restoring step 2") in logs[0]
    for r in (0, 1):
        assert f"rank {r} is not in the survivors' mesh: it leaves" in logs[r]
        assert "done" not in logs[r]
    steps = {int(m[1]): (float(m[2]), int(m[3])) for m in re.finditer(
        r"step\s+(\d+)\s+loss (\S+)\s+gnorm \S+\s+opt_step (\d+)", logs[2])}
    assert sorted(steps) == [3, 4, 5]            # logged by the new origin
    assert all(np.isfinite(loss) for loss, _ in steps.values())
    # The checkpoint of step 2 held the state after 3 updates.
    assert [steps[s][1] for s in (3, 4, 5)] == [4, 5, 6]
    assert "done; final checkpoint at 6" in logs[2]
