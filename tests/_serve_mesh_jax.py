"""The JAX package's side of the serve mesh tests
(tests/_torch_serve_mesh_cases.py holds the ranks' side): the reference's
pjit decode step, prefill and `ServingEngine` on a mesh of the case's
shape over the test session's virtual devices, from float32 parameters
made from a seed; what it gives (next tokens, last-position logits, the
cache after the last step as numpy, and the shape of each cache leaf's
shard on each device, by the rank at that mesh position: rank r at
(r // model, r % model)), and the checks of the ranks' results against
it.

Tolerances (float32 parameters and float32 caches: a bf16 cache entry
that the ranks' other sums round to the other neighbour would carry one
bf16 step into every later logit), each beside the worst measured over
both files' cases: logits within `LOGIT_TOL` = 1e-5 of the reference's
and of the one-process port's (worst 3.7e-7); each rank's block of a
cache leaf within `CACHE_TOL` = 1e-5 of the block's largest magnitude
(keys, values and conv windows; worst absolute 1.4e-6) and the SSM state
within `STATE_TOL` = 1e-5 absolute (worst 0), against both.  The engine
case serves on the bf16 cache, as the reference's engine does, and its
tokens are held equal."""
from __future__ import annotations

import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import _torch_serve_mesh_cases as sc
from repro.configs import ARCHS
from repro.models import api
from repro.models.common import ShardCtx, init_params
from repro.serve import ServingEngine, build_decode_step, build_prefill

LOGIT_TOL, CACHE_TOL, STATE_TOL = sc.LOGIT_TOL, sc.CACHE_TOL, sc.STATE_TOL


def _mesh(shape) -> tuple[Mesh, np.ndarray]:
    devices = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return Mesh(devices, ("data", "model")), devices


def _shard_shapes(tree, devices) -> list[dict]:
    by_device = {d: r for r, d in enumerate(devices.reshape(-1))}
    shapes = [dict() for _ in by_device]
    for key, arr in tree.items():
        for sh in arr.addressable_shards:
            shapes[by_device[sh.device]][key] = tuple(sh.data.shape)
    return shapes


def _decode(cfg, mesh, devices, params, inputs) -> dict:
    fns = build_decode_step(cfg, mesh, sc.B, sc.MAX_SEQ)
    p = jax.device_put(params, fns.param_shardings)
    cache = jax.device_put(api.init_cache(cfg, sc.B, sc.MAX_SEQ,
                                          jnp.float32), fns.cache_shardings)
    shd = ShardCtx(mesh, fns.rules)
    logits_of = jax.jit(lambda p, c, t, pos: api.decode_step(
        p, cfg, c, {"tokens": t}, pos, shd)[0][:, -1])
    tok = jnp.asarray(inputs["tokens"])
    pos0 = jnp.asarray(inputs["pos"])
    out = {"tokens": [], "logits": []}
    for t in range(sc.STEPS):
        out["logits"].append(np.asarray(logits_of(p, cache, tok, pos0 + t)))
        nxt, cache = fns.decode(p, cache, tok, pos0 + t)
        out["tokens"].append(np.asarray(nxt))
        tok = nxt[:, None]
    out["shapes"] = _shard_shapes(cache, devices)
    out["cache"] = {k: np.asarray(v, np.float32) for k, v in cache.items()}
    return out


def _engine(cfg, mesh, params, inputs) -> dict:
    eng = ServingEngine(cfg, mesh, sc.ENGINE["slots"], sc.ENGINE["max_seq"],
                        params)
    reqs = [eng.submit(p, m) for p, (_, m) in
            zip(inputs["prompts"], sc.ENGINE["requests"])]
    eng.run()
    return {"tokens": [r.out for r in reqs]}


def _prefill(cfg, mesh, params, inputs) -> dict:
    prompt = inputs["prompt"]
    fns = build_prefill(cfg, mesh, {"tokens": jax.ShapeDtypeStruct(
        prompt.shape, jnp.int32)})
    lg = fns.prefill(jax.device_put(params, fns.param_shardings),
                     {"tokens": jnp.asarray(prompt)})
    return {"logits": np.asarray(lg)}


def jax_case(case: str) -> dict:
    kind, _, shape, _ = sc.CASES[case]
    cfg = sc.config(case, ARCHS)
    mesh, devices = _mesh(shape)
    params = init_params(api.layout(cfg), jax.random.key(0), jnp.float32)
    inputs = sc.inputs(cfg.vocab)
    if kind in ("decode", "moe"):
        out = _decode(cfg, mesh, devices, params, inputs)
    elif kind == "engine":
        out = _engine(cfg, mesh, params, inputs)
    else:
        out = _prefill(cfg, mesh, params, inputs)
    return {**out, "params": jax.device_get(params), "inputs": inputs}


def run(cases, tmp_path_factory, name: str) -> tuple[list[dict], dict]:
    """The reference's cases, written for the ranks, then 4 ranks spawned
    over them; (every rank's results, {case: the reference's})."""
    d = tmp_path_factory.mktemp(name)
    want = {}
    for case in cases:
        want[case] = jax_case(case)
        with open(d / f"{case}.pkl", "wb") as f:
            pickle.dump(want[case], f)
    deadline = time.monotonic() + sc.DEADLINE_S
    import _torch_mesh_cases as mc
    ctx = mc.spawn_ranks(sc.serve_rank, 4, str(d / "store"), str(d),
                         list(cases))
    mc.join_ranks(ctx, deadline)
    return mc.load_ranks(d, 4), want


def check_decode(ranks, want, case: str) -> None:
    """Every rank's next tokens equal to the reference's and the
    one-process port's at every step, and its logits within LOGIT_TOL of
    both; the step ran eagerly, once a step."""
    for r, rank in enumerate(ranks):
        got = rank[case]
        for t in range(sc.STEPS):
            where = (case, r, t)
            np.testing.assert_array_equal(got["tokens"][t],
                                          want[case]["tokens"][t], str(where))
            np.testing.assert_array_equal(got["tokens"][t], got["one"][t],
                                          str(where))
            assert got["logits"][t]["ref"] <= LOGIT_TOL, (where, got["logits"])
            assert got["logits"][t]["one"] <= LOGIT_TOL, (where, got["logits"])
        assert got["counts"] == (sc.STEPS, 0, 0), got["counts"]
        shape = sc.CASES[case][2]
        assert got["coordinate"] == (r // shape[1], r % shape[1])


def check_cache(ranks, want, case: str) -> None:
    """Every rank's block of each cache leaf within CACHE_TOL (relative)
    or STATE_TOL (the SSM state) of the reference's cache
    at the same global index and of the one-process port's, and of the
    shape of the reference's shard on the device at that mesh position."""
    for r, rank in enumerate(ranks):
        for key, err in rank[case]["cache"].items():
            where = (case, r, key, err)
            assert err["shape"] == want[case]["shapes"][r][key], where
            if key == "ssm":
                assert max(err["ref"], err["one"]) <= STATE_TOL, where
            else:
                assert max(err["ref_rel"], err["one_rel"]) <= CACHE_TOL, where
