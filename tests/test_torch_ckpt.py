"""The port's checkpoints and elastic restart: test_ft.py's checkpoint and
survivor tests on the port (round trip, restore after a re-mesh, async
writes with gc, crash atomicity, `survivors_mesh`, elastic training end
to end), and checkpoints carried between the packages: one the JAX
package wrote (bf16 parameters, an 8-bit AdamW state; on one device and
sharded over 8) restores in the port bit for bit, and one the port wrote
restores in JAX bit for bit."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.configs import ARCHS as JARCHS
from repro.launch.mesh import make_mesh_compat
from repro.models import api as japi
from repro.models.common import init_params as jinit_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import ARCHS
from repro_torch.ft import elastic_remesh, logical_mesh, survivors_mesh
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train import build_train_step
from repro_torch.tree import flatten

NAME = "mixtral-8x22b"


def _tree():
    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.tensor([1.0, -2.5, 3.25]).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}


def _abstract(tree):
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (torch or numpy, bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.reshape(-1).view(np.uint8)


def _same_bits(got, want):
    fg, fw = flatten(got), flatten(jax.device_get(want))
    assert list(fg) == list(fw)
    for k, w in fw.items():
        g = fg[k]
        assert tuple(g.shape) == tuple(np.shape(w)), k
        assert str(g.dtype).removeprefix("torch.") == str(np.asarray(w).dtype), k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ck = Checkpointer(str(tmp_path))
    ck.save(7, tree, blocking=True)
    assert ck.latest_step() == 7
    restored = ck.restore(7, _abstract(tree), "cpu")
    for k in tree:
        assert restored[k].dtype == tree[k].dtype
        assert torch.equal(restored[k], tree[k])
    # The reference's on-disk layout.
    path = tmp_path / "step_7"
    assert sorted(os.listdir(path)) == ["COMMITTED", "manifest.json",
                                        "shard_0.npz"]
    with np.load(path / "shard_0.npz") as z:
        assert z.files == ["b::0", "step::0", "w::0"]


def test_checkpoint_restore_after_remesh(tmp_path):
    """Save on the (4, 2) grid, lose a DP row, restore on the survivors'."""
    mesh = logical_mesh((4, 2))
    tree = _tree()
    ck = Checkpointer(str(tmp_path))
    ck.save(3, tree, blocking=True)
    small = survivors_mesh(mesh, failed_dp_rows=[1])
    step, restored = elastic_remesh(ck, _abstract(tree), "cpu")
    assert step == 3 and small.shape == {"data": 2, "model": 2}
    assert torch.equal(restored["w"], torch.arange(64.0).reshape(8, 8))
    with pytest.raises(RuntimeError, match="no committed checkpoint"):
        elastic_remesh(Checkpointer(str(tmp_path / "empty")), {}, "cpu")


def test_checkpoint_async_and_gc(tmp_path):
    tree = _tree()
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
        tree["w"].add_(1)           # training goes on; the snapshot holds
    ck.wait()
    ck._gc()
    assert ck.all_steps() == [3, 4]
    assert float(ck.restore(3, _abstract(tree), "cpu")["w"][0, 0]) == 2.0


def test_crash_atomicity(tmp_path):
    """A step dir without COMMITTED must be invisible."""
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(), blocking=True)
    os.makedirs(tmp_path / "step_9", exist_ok=True)     # simulated torn write
    (tmp_path / "step_9" / "shard_0.npz").write_bytes(b"garbage")
    assert ck.latest_step() == 5


def test_survivors_mesh():
    mesh = logical_mesh((4, 2))
    small = survivors_mesh(mesh, failed_dp_rows=[1])
    assert small.shape == {"data": 2, "model": 2}
    lost = set(mesh.devices[1].flatten().tolist())
    assert not (set(small.devices.flatten().tolist()) & lost)
    # Three survivors of four trim to two (a power of two).
    assert survivors_mesh(mesh, [0]).shape == {"data": 2, "model": 2}
    assert logical_mesh().shape == {"data": 2, "model": 4}


def test_end_to_end_elastic_training(tmp_path):
    """Save -> kill a DP row -> re-mesh -> restore -> keep training."""
    cfg = dataclasses.replace(ARCHS["qwen2-0.5b"].reduced(), remat="none")
    mesh = logical_mesh((4, 2))
    Bn, S = 8, 16
    ocfg = AdamWConfig(lr=1e-3)
    fns = build_train_step(cfg, opt_cfg=ocfg, device="cpu")
    model = api.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw.init(model.tree(), ocfg)
    batch = {"tokens": torch.zeros((Bn, S), dtype=torch.int32) + 3,
             "labels": torch.ones((Bn, S), dtype=torch.int32)}
    model, opt, m0 = fns.step(model, opt, batch)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": model.tree(), "opt": opt}, blocking=True)

    small = survivors_mesh(mesh, failed_dp_rows=[0])
    assert small.shape == {"data": 2, "model": 2}
    fns2 = build_train_step(cfg, opt_cfg=ocfg, device="cpu")
    step, state = elastic_remesh(
        ck, {"params": fns2.params_abstract, "opt": fns2.opt_abstract}, "cpu")
    assert step == 1
    for k, v in flatten(model.tree()).items():
        assert torch.equal(flatten(state["params"])[k], v), k
    model2 = api.build(cfg, state["params"])
    _, o2, m1 = fns2.step(model2, state["opt"], batch)
    assert np.isfinite(float(m1["loss"]))
    assert int(o2["step"]) == 2          # optimizer state carried over


# ---------------------------------------------------------------------------
# Between the packages
# ---------------------------------------------------------------------------

def _jax_state(bits=8):
    """Reduced mixtral's bf16 parameters and an 8-bit AdamW state after one
    step (non-zero states and scales), as JAX arrays."""
    jcfg = JARCHS[NAME].reduced()
    params = jinit_params(japi.layout(jcfg), jax.random.key(0))
    ocfg = JAdamWConfig(lr=1e-2, state_bits=bits)
    opt = jadamw.init(params, ocfg)
    keys = iter(jax.random.split(jax.random.key(1), 64))
    grads = jax.tree.map(lambda p: jax.random.normal(next(keys), p.shape,
                                                     p.dtype), params)
    params, opt, _ = jadamw.apply(params, opt, grads, ocfg)
    return {"params": params, "opt": opt}


def _port_abstract(bits=8):
    fns = build_train_step(ARCHS[NAME].reduced(),
                           AdamWConfig(state_bits=bits), device="cpu")
    return {"params": fns.params_abstract, "opt": fns.opt_abstract}


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _jax_state()
    assert tree["params"]["blocks"]["moe"]["w1"].dtype == jnp.bfloat16
    JCheckpointer(str(tmp_path)).save(4, tree, blocking=True)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 4
    restored = ck.restore(4, _port_abstract(), "cpu")
    _same_bits(restored, tree)
    model = api.build(ARCHS[NAME].reduced(), restored["params"])
    assert model.blocks[1].moe.w1.dtype == torch.bfloat16


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_jax_checkpoint_restores_in_the_port(tmp_path):
    """Saved from a (4, 2) mesh: several shards a leaf, each placed by its
    index."""
    mesh = make_mesh_compat((4, 2), ("data", "model"))
    tree = {"w": jax.device_put(
                jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
                NamedSharding(mesh, P("data", "model"))),
            "b": jax.device_put(jnp.arange(8, dtype=jnp.bfloat16),
                                NamedSharding(mesh, P("data"))),
            "step": jnp.int32(9)}
    JCheckpointer(str(tmp_path)).save(2, tree, blocking=True)
    got = Checkpointer(str(tmp_path)).restore(2, {
        "w": torch.empty(8, 8, device="meta"),
        "b": torch.empty(8, dtype=torch.bfloat16, device="meta"),
        "step": torch.empty((), dtype=torch.int32, device="meta")}, "cpu")
    _same_bits(got, tree)


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    cfg = ARCHS[NAME].reduced()
    ocfg = AdamWConfig(lr=1e-2, state_bits=8)
    fns = build_train_step(cfg, ocfg, device="cpu",
                           total_steps=10, warmup_steps=1)
    model = api.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw.init(model.tree(), ocfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
             for k in ("tokens", "labels")}
    for _ in range(2):
        model, opt, _ = fns.step(model, opt, batch)
    tree = {"params": model.tree(), "opt": opt}
    Checkpointer(str(tmp_path)).save(2, tree, blocking=True)

    mesh = make_mesh_compat((1, 1), ("data", "model"))
    jtree = _jax_state()
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            jtree)
    rep = jax.tree.map(lambda _: NamedSharding(mesh, P()), jtree)
    restored = JCheckpointer(str(tmp_path)).restore(2, abstract, rep)
    assert int(restored["opt"]["step"]) == 2
    _same_bits({k: v for k, v in flatten(tree).items()},
               {k: v for k, v in flatten(jax.device_get(restored)).items()})
