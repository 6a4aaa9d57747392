"""Shared cases of the serve mesh tests (tests/test_torch_serve_mesh.py,
tests/test_torch_serve_mesh_engine.py): the port's decode step, prefill
and serving engine over a (data, model) mesh of gloo ranks, spawned over a
file store, against the JAX package's pjit builders on a mesh of the same
shape (tests/_serve_mesh_jax.py) and against the port in one process.

Torch-only: a spawned rank imports this module, so nothing here imports
JAX or the JAX package.  The test writes the reference's side of a case to
`<case>.pkl` (the seed-made float32 parameters as numpy, the inputs, and
what the reference gave; scripts/mesh_step_sweep.py --serve writes the
parameters and inputs alone, with no JAX, and the ranks then hold the
mesh to the one-process port alone); each rank carries the parameters in (every rank
its own block of the same arrays), runs the case over the mesh and in one
process, and writes to `rank<r>.pkl` what it saw: the next tokens, the
largest differences of its logits and of its blocks of the cache from the
reference's and the one-process run's, the shape of each of its blocks,
and, for the MoE case, the expert loads its `segment_histogram` calls
counted."""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

B, MAX_SEQ, STEPS = 4, 32, 3
# Each row's first position: over a sequence split of 2 or 4 blocks of
# MAX_SEQ, rows 1-3 cross from one rank's block into the next's.
POS0 = (0, 7, 15, 22)
PREFILL_S = 16
ENGINE = dict(slots=2, max_seq=48, requests=((5, 6), (3, 8), (7, 4),
                                             (2, 10), (4, 5)))
# The tolerances (tests/_serve_mesh_jax.py says why each is what it is).
LOGIT_TOL = 1e-5
CACHE_TOL = 1e-5
STATE_TOL = 1e-5
COLLECTIVE_TIMEOUT_S = 60.0
DEADLINE_S = 240.0

# case -> (kind, arch, mesh shape, config overrides)
CASES = {
    "qwen2_2x2": ("decode", "qwen2-0.5b", (2, 2), {}),
    "qwen2_1x4": ("decode", "qwen2-0.5b", (1, 4), {}),
    "qwen2_4x1": ("decode", "qwen2-0.5b", (4, 1), {}),
    "mamba2_2x2": ("decode", "mamba2-370m", (2, 2), {}),
    "mamba2_1x4": ("decode", "mamba2-370m", (1, 4), {}),
    "mamba2_4x1": ("decode", "mamba2-370m", (4, 1), {}),
    # Two KV heads: the cache's KV heads split over "model" at (2, 2); at
    # (1, 4) they do not divide (full-size qwen2-0.5b's case): the keys'
    # heads are gathered before they are split out, the sequence split.
    "qwen3_kv2_2x2": ("decode", "qwen3-14b", (2, 2), {"n_kv_heads": 2}),
    "qwen3_kv2_1x4": ("decode", "qwen3-14b", (1, 4), {"n_kv_heads": 2}),
    "mixtral_2x2": ("moe", "mixtral-8x22b", (2, 2), {}),
    "engine_2x2": ("engine", "qwen2-0.5b", (2, 2), {}),
    "prefill_2x2": ("prefill", "qwen3-14b", (2, 2), {}),
}
DECODE = [c for c, v in CASES.items() if v[0] == "decode"]
OTHERS = [c for c, v in CASES.items() if v[0] != "decode"]


def config(case: str, archs):
    """The case's reduced config from the registry `archs` (the port's or
    the reference's)."""
    _, arch, _, overrides = CASES[case]
    return dataclasses.replace(archs[arch].reduced(), **overrides)


def inputs(vocab: int) -> dict:
    rng = np.random.default_rng(1)
    return {"tokens": rng.integers(0, vocab, (B, 1)).astype(np.int32),
            "pos": np.asarray(POS0, np.int32),
            "prompt": rng.integers(0, vocab, (B, PREFILL_S)).astype(np.int32),
            "prompts": [rng.integers(0, vocab, n).tolist()
                        for n, _ in ENGINE["requests"]]}


def _errors(mine, want, one=None) -> dict:
    """This rank's block of a tensor against the same block of `want` (the
    whole array) and of `one` (the one-process run's): the largest
    absolute difference, and that difference over the block's largest
    magnitude."""
    from repro_torch.models.common import local_block, to_local
    local, offset = local_block(mine.shape, mine.placements, mine.device_mesh)
    sl = tuple(slice(o, o + n) for o, n in zip(offset, local))
    got = to_local(mine).double().numpy()
    out = {"shape": tuple(local)}
    others = {}
    if want is not None:
        others["ref"] = np.asarray(want, np.float64)[sl]
    if one is not None:
        others["one"] = one.double().numpy()[sl]
    for name, other in others.items():
        out[name] = float(np.abs(got - other).max(initial=0.0))
        out[f"{name}_rel"] = out[name] / max(
            float(np.abs(other).max(initial=0.0)), 1e-30)
    return out


def tree_map(fn, t, *rest):
    """fn over the leaves of a cache tree (and the matching leaves of
    `rest`), None kept: the hybrid's nested states and the tails that a
    config without one holds as None."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in t.items()}
    return fn(t, *rest)


def flat(t, prefix: str = "") -> dict:
    """A cache tree's leaves by `/`-joined path, sorted, None dropped."""
    if t is None:
        return {}
    if not isinstance(t, dict):
        return {prefix[:-1]: t}
    out = {}
    for k in sorted(t):
        out.update(flat(t[k], f"{prefix}{k}/"))
    return out


def _decode_logits(model, cfg, cache, tokens, pos, shd):
    """The step's last-position logits on a copy of the cache: (B, V),
    whole (over a mesh, the same on every rank)."""
    from repro_torch.models import api
    from repro_torch.models.common import distribute_tree
    if shd.mesh is not None:
        tokens = distribute_tree(tokens, shd.placements(tokens.shape, "batch",
                                                        None), shd.mesh)
        pos = distribute_tree(pos, shd.placements(pos.shape, "batch"),
                              shd.mesh)
    copy = tree_map(torch.Tensor.clone, cache)
    with torch.no_grad():
        lg, _ = api.decode_step(model, cfg, copy, {"tokens": tokens}, pos,
                                shd)
    lg = lg[:, -1]
    return lg.full_tensor() if shd.mesh is not None else lg


def run_decode(case: str, mesh, ref: dict) -> dict:
    """STEPS greedy steps over the mesh and in one process from the same
    tokens, each fed its own next tokens, on float32 caches (a bf16 cache
    entry that a rank's other sums round the other way would carry its
    step into every later logit)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.common import NO_SHARD, ShardCtx
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve import build_decode_step
    from repro_torch.serve.serve_step import mesh_cache
    cfg = config(case, ARCHS)
    fns = build_decode_step(cfg, B, MAX_SEQ, mesh=mesh, device="cpu")
    one = build_decode_step(cfg, B, MAX_SEQ, device="cpu")
    model = params_from_jax(ref["params"], cfg, device="cpu", mesh=mesh,
                            rules=fns.rules)
    model1 = params_from_jax(ref["params"], cfg, device="cpu")
    cache = mesh_cache(cfg, fns, torch.float32)
    cache1 = api.init_cache(cfg, B, MAX_SEQ, torch.float32, device="cpu")
    shd = ShardCtx(mesh, fns.rules)
    tok = torch.as_tensor(ref["inputs"]["tokens"])
    tok1 = tok
    pos0 = torch.as_tensor(ref["inputs"]["pos"])
    seen, loads = [], {"mesh": [], "one": []}
    kernel = ops.segment_histogram

    def watched(values, n_bins, use_kernels=True):
        out = kernel(values, n_bins, use_kernels=use_kernels)
        seen.append((values.numel(), out.clone(),
                     torch.equal(out, kernel(values, n_bins,
                                             use_kernels=False))))
        return out

    got = {"tokens": [], "one": [], "logits": []}
    ops.segment_histogram = watched
    try:
        for t in range(STEPS):
            pos = pos0 + t
            lg = _decode_logits(model, cfg, cache, tok, pos, shd)
            lg1 = _decode_logits(model1, cfg, cache1, tok1, pos, NO_SHARD)
            seen.clear()
            nxt, _ = fns.decode(model, cache, tok, pos)
            loads["mesh"].append(list(seen))
            seen.clear()
            nxt1, _ = one.decode(model1, cache1, tok1, pos)
            loads["one"].append(list(seen))
            got["tokens"].append(nxt.numpy().copy())
            got["one"].append(nxt1.numpy().copy())
            got["logits"].append({"one": float((lg - lg1).abs().max())})
            if "logits" in ref:
                got["logits"][-1]["ref"] = float(np.abs(
                    lg.double().numpy() - ref["logits"][t]).max())
            tok, tok1 = nxt[:, None], nxt1[:, None]
    finally:
        ops.segment_histogram = kernel
    got["cache"] = {k: _errors(v, ref["cache"][k] if "cache" in ref
                               else None, cache1[k])
                    for k, v in cache.items()}
    got["placements"] = {k: tuple(str(p) for p in pl)
                         for k, pl in fns.cache_placements.items()}
    got["counts"] = (fns.eager_calls, fns.captures, fns.replays)
    if cfg.family == "moe":
        got["loads"] = {k: [[(n, out.numpy(), same) for n, out, same in call]
                            for call in v] for k, v in loads.items()}
    return got


def run_engine(case: str, mesh, ref: dict) -> dict:
    from repro_torch.configs import ARCHS
    return serve_engine(config(case, ARCHS), mesh, ref)


def serve_engine(cfg, mesh, ref: dict) -> dict:
    """The five requests on a mesh engine (the reference's numpy tree as
    its parameters) and a one-process engine; the last request, which
    reuses a slot, alone on a fresh mesh engine."""
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve import ServingEngine
    prompts = ref["inputs"]["prompts"]
    news = [m for _, m in ENGINE["requests"]]

    def serve(engine, which):
        reqs = [engine.submit(prompts[i], news[i]) for i in which]
        engine.run()
        return [r.out for r in reqs], engine

    args = (cfg, ENGINE["slots"], ENGINE["max_seq"])
    mesh_out, eng = serve(ServingEngine(*args, ref["params"], mesh=mesh,
                                        device="cpu"), range(len(prompts)))
    one_out, _ = serve(ServingEngine(*args, params_from_jax(
        ref["params"], cfg, device="cpu"), device="cpu"), range(len(prompts)))
    solo, _ = serve(ServingEngine(*args, ref["params"], mesh=mesh,
                                  device="cpu"), [len(prompts) - 1])
    return {"tokens": mesh_out, "one": one_out, "solo": solo[0],
            "counts": (eng.fns.eager_calls, eng.fns.captures,
                       eng.fns.replays), "ticks": eng.ticks,
            "cache_keys": sorted(flat(eng.cache))}


def run_prefill(case: str, mesh, ref: dict) -> dict:
    """`build_prefill(mesh=)`'s logits against the reference's and the
    one-process prefill's; then `api.prefill` over the mesh filling a
    cache of the decode step's placements, against `api.prefill` in one
    process: logits and every rank's blocks of the cache."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import ShardCtx, distribute_tree
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve import build_decode_step, build_prefill
    from repro_torch.serve.serve_step import mesh_cache
    cfg = config(case, ARCHS)
    prompt = torch.as_tensor(ref["inputs"]["prompt"])
    fns = build_prefill(cfg, mesh=mesh, batch_shapes={"tokens": prompt.shape},
                        device="cpu")
    model = params_from_jax(ref["params"], cfg, device="cpu", mesh=mesh,
                            rules=fns.rules)
    model1 = params_from_jax(ref["params"], cfg, device="cpu")
    lg = fns.prefill(model, {"tokens": prompt.numpy()})
    lg1 = build_prefill(cfg, device="cpu").prefill(model1, {"tokens": prompt})
    got = {"logits": {"one": float((lg - lg1).abs().max())},
           "shape": tuple(lg.shape)}
    if "logits" in ref:
        got["logits"]["ref"] = float(np.abs(lg.double().numpy()
                                            - ref["logits"]).max())

    dec = build_decode_step(cfg, B, MAX_SEQ, mesh=mesh, device="cpu")
    shd = ShardCtx(mesh, dec.rules)
    model = params_from_jax(ref["params"], cfg, device="cpu", mesh=mesh,
                            rules=dec.rules)
    cache = mesh_cache(cfg, dec, torch.float32)
    cache1 = api.init_cache(cfg, B, MAX_SEQ, torch.float32, device="cpu")
    rows = distribute_tree(prompt, shd.placements(prompt.shape, "batch",
                                                  None), mesh)
    lg, _ = api.prefill(model, cfg, {"tokens": rows}, cache, shd)
    lg1, _ = api.prefill(model1, cfg, {"tokens": prompt}, cache1)
    got["api_prefill"] = {
        "logits": float((lg.full_tensor() - lg1).abs().max()),
        "cache": {k: _errors(v, None, cache1[k]) for k, v in cache.items()},
        "placements": {k: tuple(str(p) for p in pl)
                       for k, pl in dec.cache_placements.items()}}
    return got


RUNS = {"decode": run_decode, "moe": run_decode, "engine": run_engine,
        "prefill": run_prefill}


def serve_rank(rank: int, world: int, store: str, out_dir: str, cases
               ) -> None:
    """A gloo rank on the CPU: every case of `cases`, each over a mesh of
    its shape (built by every rank, in case order, from one default
    group)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import lm_mesh, make_lm_mesh
    torch.set_num_threads(1)
    first = CASES[cases[0]][2]
    meshes = {first: make_lm_mesh(first, backend="gloo", device="cpu",
                                  init_method=f"file://{store}", rank=rank,
                                  world_size=world,
                                  timeout_s=COLLECTIVE_TIMEOUT_S)}
    try:
        for case in cases:
            shape = CASES[case][2]
            if shape not in meshes:
                meshes[shape] = lm_mesh("cpu", shape)
        got = {}
        for case in cases:
            with open(Path(out_dir) / f"{case}.pkl", "rb") as f:
                ref = pickle.load(f)
            mesh = meshes[CASES[case][2]]
            got[case] = RUNS[CASES[case][0]](case, mesh, ref)
            got[case]["coordinate"] = tuple(mesh.get_coordinate())
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def check_one_process(ranks, case: str) -> float:
    """Every rank's results of `case` against the one-process port's
    alone (the check of a run without the reference): the same tokens,
    logits within LOGIT_TOL, cache blocks within CACHE_TOL (STATE_TOL for
    the SSM state).  Returns the worst logit difference; raises
    AssertionError on a failure."""
    worst = 0.0
    for rank in ranks:
        got = rank[case]
        kind = CASES[case][0]
        if kind == "engine":
            assert got["tokens"] == got["one"], (case, "tokens")
            assert got["tokens"][-1] == got["solo"], (case, "reused slot")
            continue
        if kind == "prefill":
            logits = [got["logits"]["one"], got["api_prefill"]["logits"]]
            caches = got["api_prefill"]["cache"]
        else:
            for t in range(STEPS):
                np.testing.assert_array_equal(got["tokens"][t], got["one"][t],
                                              str((case, t)))
            logits = [lg["one"] for lg in got["logits"]]
            caches = got["cache"]
        worst = max(worst, *logits)
        assert max(logits) <= LOGIT_TOL, (case, logits)
        for key, err in caches.items():
            assert (err["one"] <= STATE_TOL if key == "ssm"
                    else err["one_rel"] <= CACHE_TOL), (case, key, err)
    return worst
