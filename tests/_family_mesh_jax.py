"""The JAX package's side of the family mesh tests
(tests/_torch_family_mesh_cases.py holds the ranks' side): the reference's
pjit train step, decode step, prefill and `ServingEngine` for the hybrid,
enc-dec and VLM families on a mesh of the case's shape over the test
session's virtual devices, from the seed-made float32 parameters with the
VLM's gate set (`fc.adjust`); what it gives, and the checks of the ranks'
results against it.  The train side is tests/_lm_mesh_jax.py's
(`jax_steps`, `check_case`, `check_blocks`), with the frontend's input in
the batch; the serve side's tolerances are tests/_serve_mesh_jax.py's:
logits within `LOGIT_TOL`, each rank's block of a cache leaf within
`CACHE_TOL` of the block's largest magnitude (keys, values, conv windows,
encoder rows, vision tokens) and the SSM states within `STATE_TOL`,
against the reference and the one-process port; each block's shape the
reference's shard's on the device at that mesh position."""
from __future__ import annotations

import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np

import _lm_mesh_jax as lj
import _serve_mesh_jax as sj
import _torch_family_mesh_cases as fc
import _torch_serve_mesh_cases as sc
from repro.configs import ARCHS
from repro.models import api
from repro.models.common import ShardCtx, init_params
from repro.serve import build_decode_step, build_prefill

LOGIT_TOL, CACHE_TOL, STATE_TOL = sj.LOGIT_TOL, sj.CACHE_TOL, sj.STATE_TOL


def _shard_shapes(tree, devices) -> list[dict]:
    return sj._shard_shapes(sc.flat(tree), devices)


def _numpy(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in sc.flat(tree).items()}


def _params(cfg):
    return fc.adjust(jax.device_get(init_params(
        api.layout(cfg), jax.random.key(0), jnp.float32)), cfg)


# -- training -----------------------------------------------------------------

def train_case(case: str) -> dict:
    _, _, shape, bits, _ = fc.TRAIN[case]
    cfg = fc.train_config(case, ARCHS)
    return lj.jax_steps(cfg, 1, bits, shape, fc.train_batch(cfg),
                        adjust=lambda p: fc.adjust(p, cfg))


def run_train(cases, tmp_path_factory, name: str) -> tuple[list[dict], dict]:
    """The reference's train cases, written for the ranks, then 4 ranks
    spawned over them; (every rank's results, {case: the reference's})."""
    d = tmp_path_factory.mktemp(name)
    want = {}
    for case in cases:
        want[case] = train_case(case)
        with open(d / f"{case}.pkl", "wb") as f:
            pickle.dump({"states": want[case]["states"],
                         "batch": want[case]["batch"]}, f)
    return _spawn(fc.train_rank, d, cases), want


def _spawn(rank_fn, d, cases) -> list[dict]:
    import _torch_mesh_cases as mc
    deadline = time.monotonic() + fc.DEADLINE_S
    ctx = mc.spawn_ranks(rank_fn, 4, str(d / "store"), str(d), list(cases))
    mc.join_ranks(ctx, deadline)
    return mc.load_ranks(d, 4)


# -- serving ------------------------------------------------------------------

def _decode(cfg, mesh, devices, params, cache, inputs, max_seq: int,
            fns=None) -> dict:
    """STEPS greedy steps of the reference's decode step from `cache`
    (numpy, or arrays the step's shardings place): each step's logits and
    next tokens, the cache after the last as numpy and its shards'
    shapes."""
    fns = fns or build_decode_step(cfg, mesh, fc.B, max_seq)
    p = jax.device_put(params, fns.param_shardings)
    cache = jax.device_put(cache, fns.cache_shardings)
    shd = ShardCtx(mesh, fns.rules)
    logits_of = jax.jit(lambda p, c, t, pos: api.decode_step(
        p, cfg, c, {"tokens": t}, pos, shd)[0][:, -1])
    tok = jnp.asarray(inputs["tokens"])
    pos0 = jnp.asarray(inputs["pos"])
    out = {"tokens": [], "logits": []}
    for t in range(fc.STEPS):
        out["logits"].append(np.asarray(logits_of(p, cache, tok, pos0 + t)))
        nxt, cache = fns.decode(p, cache, tok, pos0 + t)
        out["tokens"].append(np.asarray(nxt))
        tok = nxt[:, None]
    out["shapes"] = _shard_shapes(cache, devices)
    out["cache"] = _numpy(cache)
    return out


def _prefill(cfg, mesh, devices, params, inputs) -> dict:
    """`build_prefill`'s logits over the prompt and the frontend's input;
    `api.prefill` jitted on the mesh into a zeroed float32 cache of the
    decode step's shardings (the filled cache as numpy, its shards'
    shapes); STEPS decode steps from it at the positions after the
    prompt."""
    batch = {"tokens": inputs["prompt"],
             **{k: inputs[k] for k in ("frames", "vision_emb")
                if k in inputs}}
    fp = build_prefill(cfg, mesh, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                   for k, v in batch.items()})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"prefill_logits": np.asarray(fp.prefill(
        jax.device_put(params, fp.param_shardings), jb))}
    fns = build_decode_step(cfg, mesh, fc.B, fc.MAX_SEQ)
    shd = ShardCtx(mesh, fns.rules)
    cache = jax.device_put(api.init_cache(cfg, fc.B, fc.MAX_SEQ, jnp.float32),
                           fns.cache_shardings)
    lg, cache = jax.jit(
        lambda p, b, c: api.prefill(p, cfg, b, c, shd),
        out_shardings=(None, fns.cache_shardings))(
        jax.device_put(params, fns.param_shardings), jb, cache)
    out.update(api_logits=np.asarray(lg)[:, -1], prefilled=_numpy(cache),
               prefilled_shapes=_shard_shapes(cache, devices))
    inputs = dict(inputs, pos=np.full(fc.B, fc.PREFILL_S, np.int32))
    out.update(_decode(cfg, mesh, devices, params, cache, inputs, fc.MAX_SEQ,
                       fns))
    return out


def serve_case(case: str) -> dict:
    kind, _, _, shape, max_seq, _ = fc.SERVE[case]
    cfg = fc.serve_config(case, ARCHS)
    mesh, devices = sj._mesh(shape)
    params = _params(cfg)
    inputs = fc.serve_inputs(case, cfg.vocab)
    ref = {"params": params, "inputs": inputs}
    if kind == "decode":
        ref["cache0"] = fc.seeded_cache(cfg, fc.B, max_seq)
        ref.update(_decode(cfg, mesh, devices, params, ref["cache0"], inputs,
                           max_seq))
    elif kind == "prefill":
        ref.update(_prefill(cfg, mesh, devices, params, inputs))
    else:
        ref.update(sj._engine(cfg, mesh, params, inputs))
    return ref


def run_serve(cases, tmp_path_factory, name: str) -> tuple[list[dict], dict]:
    """The reference's serve cases, written for the ranks, then 4 ranks
    spawned over them; (every rank's results, {case: the reference's})."""
    d = tmp_path_factory.mktemp(name)
    want = {}
    for case in cases:
        want[case] = serve_case(case)
        with open(d / f"{case}.pkl", "wb") as f:
            pickle.dump(want[case], f)
    return _spawn(fc.serve_rank, d, cases), want


def check_decode(ranks, want, case: str) -> None:
    """Every rank's next tokens equal to the reference's and the
    one-process port's at every step, its logits within LOGIT_TOL of both,
    the step eager once a step, the rank at its mesh position."""
    shape = fc.SERVE[case][3]
    for r, rank in enumerate(ranks):
        got = rank[case]
        for t in range(fc.STEPS):
            where = (case, r, t)
            np.testing.assert_array_equal(got["tokens"][t],
                                          want[case]["tokens"][t], str(where))
            np.testing.assert_array_equal(got["tokens"][t], got["one"][t],
                                          str(where))
            assert got["logits"][t]["ref"] <= LOGIT_TOL, (where, got["logits"])
            assert got["logits"][t]["one"] <= LOGIT_TOL, (where, got["logits"])
        assert got["counts"] == (fc.STEPS, 0, 0), got["counts"]
        assert got["coordinate"] == (r // shape[1], r % shape[1])


def check_cache(ranks, want, case: str, which: str = "cache",
                shapes: str = "shapes") -> None:
    """Every rank's block of each cache leaf (`which`: after the decode
    steps, or as the prefill left it) within CACHE_TOL (relative) or
    STATE_TOL (the SSM states) of the reference's at the same global index
    and of the one-process port's, and of the shape of the reference's
    shard on the device at that mesh position."""
    for r, rank in enumerate(ranks):
        errs = rank[case][which]
        assert set(errs) == set(want[case][shapes][r]), (case, r, errs)
        for key, err in errs.items():
            where = (case, r, key, err)
            assert err["shape"] == want[case][shapes][r][key], where
            if key.endswith("ssm"):
                assert max(err["ref"], err["one"]) <= STATE_TOL, where
            else:
                assert max(err["ref_rel"], err["one_rel"]) <= CACHE_TOL, where
