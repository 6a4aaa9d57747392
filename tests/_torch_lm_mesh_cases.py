"""Shared cases of the LM mesh tests (tests/test_torch_train_mesh.py,
tests/test_torch_train_mesh_shapes.py, tests/test_torch_ft_mesh.py): the
port's train step over a (data, model) mesh of gloo ranks, spawned over a
file store, against the JAX package's pjit step on a mesh of the same
shape and against the port's one-process step.

Torch-only: a spawned rank imports this module, so nothing here imports
JAX or the JAX package.  The test writes the reference's numbers for a
case to `<case>.pkl` (its parameters and optimizer state as numpy before
each step and after the last, and the batch); each rank carries the start
in (`params_from_jax(mesh=)`: every rank its own block of the same
arrays), runs the steps over the mesh and in one process, and writes
what it saw to `rank<r>.pkl`: each step's metrics, both ways; the largest
difference of each of its blocks (parameters and states) from the
reference's after each step and from the one-process run's; and the local
shape of every leaf.  Chained cases take each step from the last;
unchained ones (8-bit states: a code at a rounding tie may flip and Adam
carries that on, see tests/test_torch_train_step.py) take each step from
the reference's state of that step.  A `<case>.pkl` that holds only the
start, with no optimizer state (scripts/mesh_step_sweep.py writes such
files, with no JAX), chains every step from fresh states and compares
the mesh with the one-process run alone."""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

B, S = 4, 16
STEPS = 3
TOL = dict(rel=1e-5)
LR = 1e-2
STEP_KW = dict(total_steps=10, warmup_steps=1)
COLLECTIVE_TIMEOUT_S = 60.0
DEADLINE_S = 240.0
# Parameters further than PARAM_LISTED from the reference's or the
# one-process step's (tests/_lm_mesh_jax.py's PARAM_TOL) are listed
# element by element, at most LISTED_MAX a leaf, for its check.
PARAM_LISTED = 1e-3
LISTED_MAX = 64

# case -> (arch, n_micro, state bits, mesh shape, chained)
CASES = {
    "qwen3_n1_2x2": ("qwen3-14b", 1, 32, (2, 2), True),
    "qwen3_n2_2x2": ("qwen3-14b", 2, 32, (2, 2), True),
    "mixtral_8bit_2x2": ("mixtral-8x22b", 1, 8, (2, 2), False),
    "mamba2_2x2": ("mamba2-370m", 1, 32, (2, 2), True),
    "qwen3_n1_1x4": ("qwen3-14b", 1, 32, (1, 4), True),
    "qwen3_n2_1x4": ("qwen3-14b", 2, 32, (1, 4), True),
    "qwen3_n1_4x1": ("qwen3-14b", 1, 32, (4, 1), True),
    "qwen3_n2_4x1": ("qwen3-14b", 2, 32, (4, 1), True),
}
SQUARE = [c for c, v in CASES.items() if v[3] == (2, 2)]
SHAPES = [c for c, v in CASES.items() if v[3] != (2, 2)]


def batch(vocab: int, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}{k}/"))
    return out


def _block_errors(tree, want, one=None, listed=None) -> dict:
    """{leaf: largest |difference|} of this rank's blocks of `tree`
    (DTensors) from the same blocks of `want` (numpy, the whole arrays)
    and of `one` (the one-process run's tensors), codes as integers.
    With `listed`, each leaf also lists its elements further than that
    from either (`over`: global index, |difference| from `want`, from
    `one`; at most LISTED_MAX) and counts them (`n_over`)."""
    from repro_torch.models.common import local_block
    out = {}
    for key, t in _flat(tree).items():
        local, offset = local_block(t.shape, t.placements, t.device_mesh)
        sl = tuple(slice(o, o + n) for o, n in zip(offset, local))
        mine = t.to_local().detach().double().numpy()
        ref = np.asarray(_flat(want)[key])[sl].astype(np.float64)
        err = {"ref": float(np.abs(mine - ref).max(initial=0.0)),
               "ref_rel": float((np.abs(mine - ref)
                                 / np.maximum(np.abs(ref), 1e-30)).max(
                                     initial=0.0))}
        d_one = np.zeros_like(mine)
        if one is not None:
            o = _flat(one)[key].detach().double().numpy()[sl]
            d_one = np.abs(mine - o)
            err["one"] = float(d_one.max(initial=0.0))
        if listed is not None:
            d_ref = np.abs(mine - ref)
            far = np.argwhere(np.maximum(d_ref, d_one) > listed)
            err["n_over"] = len(far)
            err["over"] = [(tuple(int(i + o) for i, o in zip(idx, offset)),
                            float(d_ref[tuple(idx)]), float(d_one[tuple(idx)]))
                           for idx in far[:LISTED_MAX]]
        out[key] = err
    return out


def run_case(case: str, mesh, in_dir) -> dict:
    from repro_torch.configs import ARCHS
    arch, n_micro, bits, _, chained = CASES[case]
    with open(Path(in_dir) / f"{case}.pkl", "rb") as f:
        ref = pickle.load(f)
    return run_steps(ARCHS[arch].reduced(), n_micro, bits, chained, mesh,
                     ref)


def run_steps(cfg, n_micro: int, bits: int, chained: bool, mesh,
              ref: dict) -> dict:
    """STEPS steps of `cfg` over `mesh` and in one process from `ref`'s
    start on its batch (`run_case`'s body; module docstring)."""
    from repro_torch.kernels import ops
    from repro_torch.models.convert import opt_state_from_jax, params_from_jax
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    ocfg = AdamWConfig(lr=LR, state_bits=bits)
    fns = build_train_step(cfg, ocfg, n_micro=n_micro, mesh=mesh,
                           device="cpu", **STEP_KW)
    one = build_train_step(cfg, ocfg, n_micro=n_micro, device="cpu",
                           **STEP_KW)
    states = ref["states"]
    got = {"metrics": [], "one": [], "errors": []}
    ops.reset_launches()
    for i in range(STEPS):
        if i == 0 or (not chained and i < len(states)):
            params, opt = states[i]
            model = params_from_jax(params, cfg, device="cpu", mesh=mesh)
            model1 = params_from_jax(params, cfg, device="cpu")
            if opt is None:
                state = adamw.init(model.tree(), ocfg)
                state1 = adamw.init(model1.tree(), ocfg)
            else:
                state = opt_state_from_jax(opt, cfg, device="cpu", mesh=mesh)
                state1 = opt_state_from_jax(opt, cfg, device="cpu")
        _, _, m = fns.step(model, state, ref["batch"])
        _, _, m1 = one.step(model1, state1, ref["batch"])
        got["metrics"].append({k: v.numpy().copy() for k, v in m.items()})
        got["one"].append({k: v.numpy().copy() for k, v in m1.items()})
        if i + 1 < len(states):
            want_p, want_o = states[i + 1]
            got["errors"].append({
                "params": _block_errors(model.tree(), want_p, model1.tree(),
                                        listed=PARAM_LISTED),
                "opt": _block_errors(state, want_o, state1)})
    got["shapes"] = {f"params/{k}": tuple(v.to_local().shape)
                     for k, v in _flat(model.tree()).items()}
    got["shapes"].update({f"opt/{k}": tuple(v.to_local().shape)
                          for k, v in _flat(state).items()})
    got["placements"] = {k: tuple(str(p) for p in v.placements)
                         for k, v in _flat(model.tree()).items()}
    got["launches"] = dict(ops.LAUNCHES)
    got["coordinate"] = tuple(mesh.get_coordinate())
    return got


def check_metrics(got, want, case):
    """Each step's metrics `got` against `want`: loss, zloss and
    grad_norm within TOL, lr_scale within 1e-7, the same keys,
    expert_load equal and summing to B·S·K·L."""
    import pytest
    from repro_torch.configs import ARCHS
    for i, w in enumerate(want):
        for k in ("loss", "zloss", "grad_norm"):
            assert float(got[i][k]) == pytest.approx(float(w[k]), **TOL), (
                case, i, k)
        assert float(got[i]["lr_scale"]) == pytest.approx(
            float(w["lr_scale"]), abs=1e-7)
        assert set(got[i]) == set(w)
        if "expert_load" in w:
            cfg = ARCHS[CASES[case][0]].reduced()
            np.testing.assert_array_equal(got[i]["expert_load"],
                                          np.asarray(w["expert_load"]))
            assert got[i]["expert_load"].sum() == (
                B * S * cfg.topk * cfg.n_layers)


def comm_checks(mesh) -> dict:
    """What the loss and the 8-bit update send between ranks
    (`CommDebugMode`'s counts by collective) and what they compute: the
    loss on logits (B, S, 512) split over (data, vocab) against the plain
    one; two 8-bit AdamW updates of a (2, 8, 16) leaf split over (data,
    last axis), its gradients' norm below grad_clip, against the same
    updates in one process, this rank's blocks bit for bit."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.models.common import (ShardCtx, default_rules,
                                           distribute_tree, local_of)
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train.train_step import _mesh_loss
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(B, S, 512, generator=g)
    labels = torch.randint(0, 500, (B, S), generator=g, dtype=torch.int32)
    shd = ShardCtx(mesh, default_rules(mesh))
    lg = distribute_tree(logits, (Shard(0), Shard(2)), mesh)
    lab = distribute_tree(labels, (Shard(0), Replicate()), mesh)
    with CommDebugMode() as comm:
        _, m = _mesh_loss(lg, {}, lab, shd)
    plain = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels.long()[..., None])[..., 0]).mean()
    out = {"loss": (float(m["loss"].to_local()), float(plain)),
           "loss_comms": {str(k): v for k, v in
                          comm.get_comm_counts().items()}}

    cfg = AdamWConfig(lr=1e-2, state_bits=8)
    pl = {"w": (Shard(1), Shard(2))}
    w = torch.randn(2, 8, 16, generator=g)
    grads = [torch.randn(2, 8, 16, generator=g) * 1e-2 for _ in range(2)]
    one = {"w": w.clone()}
    one_state = adamw.init(one, cfg)
    params = distribute_tree({"w": w}, pl, mesh)
    state = adamw.init(params, cfg)
    with CommDebugMode() as comm:
        for gr in grads:
            adamw.apply(params, state, distribute_tree({"w": gr}, pl, mesh),
                        cfg)
    for gr in grads:
        adamw.apply(one, one_state, {"w": gr}, cfg)
    same = {"w": torch.equal(params["w"].to_local(),
                             local_of(one["w"], pl["w"], mesh))}
    for k, t in state["mu"]["w"].items():
        same[k] = torch.equal(t.to_local(), local_of(
            one_state["mu"]["w"][k], t.placements, mesh))
    out.update(update_same=same, update_comms={
        str(k): v for k, v in comm.get_comm_counts().items()})
    return out


def lm_rank(rank: int, world: int, store: str, out_dir: str, cases) -> None:
    """A gloo rank on the CPU: every case of `cases`, each over a mesh of
    its shape (built by every rank, in case order, from one default
    group)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import lm_mesh, make_lm_mesh
    torch.set_num_threads(1)
    first = CASES[cases[0]][3]
    meshes = {first: make_lm_mesh(first, backend="gloo", device="cpu",
                                  init_method=f"file://{store}", rank=rank,
                                  world_size=world,
                                  timeout_s=COLLECTIVE_TIMEOUT_S)}
    try:
        for case in cases:
            shape = CASES[case][3]
            if shape not in meshes:
                meshes[shape] = lm_mesh("cpu", shape)
        got = {case: run_case(case, meshes[CASES[case][3]], out_dir)
               for case in cases}
        if (2, 2) in meshes:
            got["comm"] = comm_checks(meshes[(2, 2)])
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


# -- fault tolerance over the mesh (tests/test_torch_ft_mesh.py): a
# checkpoint saved on (2, 2) restored on (1, 2), one the JAX package
# wrote restored on (2, 2), the elastic path of the reference's
# test_end_to_end_elastic_training, and the training driver's --mesh
# re-mesh.

FT_B, FT_S = 8, 16
FT_LR = 1e-3


def ft_tree():
    """test_ft.py's tree: w (8, 8) split over (data, model), b and step
    replicated."""
    return ({"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
             "b": torch.ones(3, dtype=torch.bfloat16),
             "step": torch.tensor(7, dtype=torch.int32)})


def ft_placements(mesh):
    from torch.distributed.tensor import Replicate, Shard
    rep = (Replicate(),) * mesh.ndim
    return {"w": (Shard(0), Shard(1)), "b": rep, "step": rep}


def ft_batch():
    return {"tokens": np.full((FT_B, FT_S), 3, np.int32),
            "labels": np.ones((FT_B, FT_S), np.int32)}


def _blocks(tree) -> dict:
    """{leaf: (its offset, this rank's block as numpy)}."""
    from repro_torch.models.common import local_block
    out = {}
    for key, t in _flat(tree).items():
        _, offset = local_block(t.shape, t.placements, t.device_mesh)
        out[key] = (offset, t.to_local().float().numpy())
    return out


def ft_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    import dataclasses

    import torch.distributed as dist
    from repro_torch.ckpt import Checkpointer
    from repro_torch.configs import ARCHS
    from repro_torch.ft import elastic_remesh, survivors_mesh
    from repro_torch.launch.mesh import lm_mesh, make_lm_mesh
    from repro_torch.models import api
    from repro_torch.models.common import distribute_tree
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    out = Path(out_dir)
    mesh = make_lm_mesh((2, 2), backend="gloo", device="cpu",
                        init_method=f"file://{store}", rank=rank,
                        world_size=world, timeout_s=COLLECTIVE_TIMEOUT_S)
    got: dict = {}
    try:
        # Save on (2, 2), restore on (1, 2): ranks 0 and 1.
        tree = distribute_tree(ft_tree(), ft_placements(mesh), mesh)
        ck = Checkpointer(str(out / "ckpt"))
        ck.save(3, tree)
        got["saved_files"] = sorted(p.name for p in (out / "ckpt" /
                                                     "step_3").iterdir())
        small = lm_mesh("cpu", (1, 2), ranks=[0, 1])
        abstract = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in ft_tree().items()}
        if small.get_coordinate() is not None:
            step, back = elastic_remesh(ck, abstract,
                                        placements=ft_placements(small),
                                        mesh=small)
            got["small"] = {"step": step, "blocks": _blocks(back),
                            "dtypes": {k: str(v.dtype) for k, v in
                                       back.items()}}
        # The JAX package's (4, 2) checkpoint on this (2, 2) mesh.
        jck = Checkpointer(str(out / "jax_ckpt"))
        back = jck.restore(5, abstract, placements=ft_placements(mesh),
                           mesh=mesh)
        got["from_jax"] = _blocks(back)

        # The reference's elastic training: a step on (2, 2), a save, DP
        # row 0 fails, the survivors restore and step on.
        with open(out / "qwen2.pkl", "rb") as f:
            params = pickle.load(f)
        cfg = dataclasses.replace(ARCHS["qwen2-0.5b"].reduced(),
                                  remat="none")
        ocfg = AdamWConfig(lr=FT_LR)
        fns = build_train_step(cfg, ocfg, mesh=mesh, device="cpu")
        model = params_from_jax(params, cfg, device="cpu", mesh=mesh)
        opt = adamw.init(model.tree(), ocfg)
        _, _, m0 = fns.step(model, opt, ft_batch())
        ck2 = Checkpointer(str(out / "elastic"))
        saved = {"params": model.tree(), "opt": opt}
        ck2.save(1, saved)
        # Restored in the saved dtypes (float32 parameters, not the
        # config's bf16 of `params_abstract`).
        abstract = tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), saved)
        small = survivors_mesh(mesh, failed_dp_rows=[0])
        got["metrics"] = [{k: v.numpy().copy() for k, v in m0.items()}]
        got["survivor"] = small.get_coordinate() is not None
        if got["survivor"]:
            fns2 = build_train_step(cfg, ocfg, mesh=small, device="cpu")
            step, state = elastic_remesh(
                ck2, abstract, placements={"params": fns2.param_placements,
                            "opt": fns2.opt_placements}, mesh=small)
            got["restored_step"] = step
            model2 = api.build(cfg, state["params"])
            _, o2, m1 = fns2.step(model2, state["opt"], ft_batch())
            got["metrics"].append({k: v.numpy().copy()
                                   for k, v in m1.items()})
            got["opt_step"] = int(o2["step"].to_local())
            got["shape"] = tuple(small.shape)
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def driver_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """`launch.train --mesh 2x2` as torchrun would start it (its settings
    in the environment), a DP row failing at step 3; the rank's log."""
    import contextlib
    import io
    import os
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    from repro_torch.launch import train
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        train.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                    "--backend", "gloo", "--mesh", "2x2", "--steps", "6",
                    "--batch", "8", "--seq", "16", "--lr", "3e-3",
                    "--ckpt-every", "2", "--fail-at-step", "3",
                    "--log-every", "1", "--ckpt-dir",
                    str(Path(out_dir) / "ckpt")])
    with open(Path(out_dir) / f"rank{rank}.log", "w") as f:
        f.write(log.getvalue())
