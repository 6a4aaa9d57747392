"""The JAX package's side of the LM mesh tests (tests/_torch_lm_mesh_cases.py
holds the ranks' side): the reference's pjit train step on a mesh of the
case's shape over the test session's virtual devices, from the seed-made
float32 parameters; each step's metrics, its parameters and optimizer
state as numpy before each step and after the last (chained or, for an
unchained case, each step from the reference's own state: the same
sequence), and the shape of every leaf's shard on each device, by the
rank at that mesh position (rank r at (r // model, r % model))."""
from __future__ import annotations

import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import _torch_lm_mesh_cases as lc
from repro.configs import ARCHS
from repro.models.common import init_params
from repro.optim import AdamWConfig, adamw
from repro.train import build_train_step


PARAM_TOL = 1e-3
STATE_TOL = 1e-5


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}{k}/"))
    return out


def jax_case(case: str) -> dict:
    arch, n_micro, bits, shape, _ = lc.CASES[case]
    cfg = ARCHS[arch].reduced()
    return jax_steps(cfg, n_micro, bits, shape, lc.batch(cfg.vocab))


def jax_steps(cfg, n_micro: int, bits: int, shape, batch: dict,
              adjust=None) -> dict:
    """The reference's steps of `cfg` on a mesh of `shape` over `batch`
    (numpy, its keys and shapes the step's), from the seed-made float32
    parameters, `adjust(params)` (numpy leaves) applied to them first
    where given (`jax_case`'s body)."""
    devices = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = Mesh(devices, ("data", "model"))
    babs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for k, v in batch.items()}
    ocfg = AdamWConfig(lr=lc.LR, state_bits=bits)
    fns = build_train_step(cfg, mesh, babs, n_micro=n_micro, opt_cfg=ocfg,
                           donate=False, **lc.STEP_KW)
    params = init_params(fns.layout, jax.random.key(0), jnp.float32)
    if adjust is not None:
        params = adjust(jax.device_get(params))
    params = jax.device_put(params, fns.param_shardings)
    opt = jax.device_put(adamw.init(params, ocfg), fns.opt_shardings)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics, states = [], [jax.device_get((params, opt))]
    for _ in range(lc.STEPS):
        params, opt, m = fns.step(params, opt, jb)
        metrics.append(jax.device_get(m))
        states.append(jax.device_get((params, opt)))
    by_device = {d: r for r, d in enumerate(devices.reshape(-1))}
    shapes = [dict() for _ in by_device]
    for prefix, tree in (("params", params), ("opt", opt)):
        for key, arr in _flat(tree).items():
            for sh in arr.addressable_shards:
                shapes[by_device[sh.device]][f"{prefix}/{key}"] = tuple(
                    sh.data.shape)
    return {"metrics": metrics, "states": states, "batch": batch,
            "shapes": shapes, "opt_step": int(opt["step"])}


def run(cases, tmp_path_factory, name: str) -> tuple[list[dict], dict]:
    """The reference's cases, written for the ranks, then 4 ranks spawned
    over them; (every rank's results, {case: the reference's})."""
    d = tmp_path_factory.mktemp(name)
    want = {}
    for case in cases:
        want[case] = jax_case(case)
        with open(d / f"{case}.pkl", "wb") as f:
            pickle.dump({"states": want[case]["states"],
                         "batch": want[case]["batch"]}, f)
    deadline = time.monotonic() + lc.DEADLINE_S
    import _torch_mesh_cases as mc
    ctx = mc.spawn_ranks(lc.lm_rank, 4, str(d / "store"), str(d),
                         list(cases))
    mc.join_ranks(ctx, deadline)
    return mc.load_ranks(d, 4), want


def check_case(ranks, want, case, shape=None):
    """Every rank's metrics of `case` against the reference's and the
    one-process step's, alike on every rank, its shard shapes the
    reference's, no kernel launched, its mesh coordinate (`shape`: the
    mesh's, by default the LM case's)."""
    shape = shape or lc.CASES[case][3]
    for r, rank in enumerate(ranks):
        got = rank[case]
        lc.check_metrics(got["metrics"], want[case]["metrics"], case)
        lc.check_metrics(got["metrics"], got["one"], case)
        for k, v in got["metrics"][-1].items():   # every rank the same
            np.testing.assert_array_equal(v, ranks[0][case]["metrics"][-1][k])
        assert got["shapes"] == want[case]["shapes"][r], (case, r)
        assert all(v == 0 for v in got["launches"].values())
        assert got["coordinate"] == (r // shape[1], r % shape[1])


def check_blocks(ranks, case):
    """Every rank's blocks after each step against the reference's and
    the one-process step's (module docstring)."""
    for rank in ranks:
        for i, step in enumerate(rank[case]["errors"]):
            for part, leaves in step.items():
                for key, err in leaves.items():
                    where = (case, i, part, key, err)
                    if key == "step":
                        assert err["ref"] == err["one"] == 0, where
                    elif key.endswith("_q"):
                        assert max(err["ref"], err["one"]) <= 1, where
                    elif key.endswith("_s"):
                        assert err["ref_rel"] <= 1e-3, where
                    else:
                        tol = PARAM_TOL if part == "params" else STATE_TOL
                        assert max(err["ref"], err["one"]) <= tol, where
