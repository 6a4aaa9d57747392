"""Shared cases of the family mesh tests (tests/test_torch_family_mesh_train.py,
tests/test_torch_family_mesh_serve.py): the hybrid (zamba2), enc-dec
(seamless-m4t) and VLM (llama-3.2-vision) families trained and served over
a (data, model) mesh of gloo ranks, spawned over a file store, against the
JAX package's pjit step, decode step, prefill and engine on a mesh of the
same shape (tests/_family_mesh_jax.py) and against the port in one
process.

Torch-only: a spawned rank imports this module, so nothing here imports
JAX or the JAX package.  The reduced configs skip what this path adds
(2 layers give zamba2 no shared block and the VLM no cross-attention;
`attn_chunk` is 0), so the cases override them: 4 layers for the hybrid
and the VLM (one group and one tail), small `attn_chunk`s for the chunked
attention, two KV heads at (1, 4) for the ring's sequence split.  The
VLM's zero-initialised gate is set to `GATE` in the numpy tree both
packages receive.  Decode starts from a cache seeded non-zero
(`seeded_cache`) or filled by a prefill: attention over zeros would hide
a wrong split.

The train cases run through tests/_torch_lm_mesh_cases.py's `run_steps`
(its pickles, results and checks); the serve cases write to `rank<r>.pkl`
what tests/_torch_serve_mesh_cases.py's do, with every cache leaf under
its `/`-joined path."""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

import _torch_lm_mesh_cases as lc
import _torch_serve_mesh_cases as sc

GATE = 0.5
B, MAX_SEQ, STEPS, POS0 = sc.B, sc.MAX_SEQ, sc.STEPS, sc.POS0
PREFILL_S = sc.PREFILL_S
ENGINE = sc.ENGINE
DEADLINE_S = 240.0

HYBRID = ("zamba2-7b", {"n_layers": 4})
ENCDEC = ("seamless-m4t-medium", {})
VLM = ("llama-3.2-vision-90b", {"n_layers": 4})


def _with(family, **more):
    return family[0], {**family[1], **more}


# case -> (arch, config overrides, mesh shape, state bits, chained)
# zamba2 at (2, 2) takes each step from the reference's state, as the
# 8-bit case does: an element of its tail block's in_proj has |g| near
# Adam's eps = 1e-8 (m 4e-9, v 1.2e-16 after step 3), where the update
# lr·m/(√v + eps) carries the last bits of g into a part of lr, and the
# chain carries that on: the one-process port, chained, is 1.03e-3 from
# the reference there after 3 steps, the mesh 1.36e-3 (3.3e-4 from the
# one-process port).
TRAIN = {
    "zamba2_2x2": (*HYBRID, (2, 2), 32, False),
    "zamba2_1x4": (*HYBRID, (1, 4), 32, True),
    "seamless_2x2": (*ENCDEC, (2, 2), 32, True),
    "seamless_1x4": (*ENCDEC, (1, 4), 32, True),
    "vision_2x2": (*VLM, (2, 2), 8, False),
    "vision_1x4": (*VLM, (1, 4), 32, True),
    # Chunked attention: the encoder's 4 frames and the decoder's 16
    # tokens in chunks of 2, the cross-attention's 16 x 4 logits past 2²;
    # the VLM's 16 x 16 cross-attention logits past 8², in chunks of 8.
    "seamless_chunk_2x2": (*_with(ENCDEC, attn_chunk=2), (2, 2), 32, True),
    "vision_chunk_1x4": (*_with(VLM, attn_chunk=8), (1, 4), 32, True),
}

# case -> (kind, arch, config overrides, mesh shape, max_seq, first positions)
# Decode at MAX_SEQ 32 from POS0 crosses the blocks of a sequence split
# over 2 or 4 ranks (the VLM's one KV head; zamba2's and seamless' four
# split by heads).  The ring: a 64-slot window of 128 positions, two KV
# heads on 4 ranks (the window split into blocks of 16); rows cross the
# blocks at 16 and 48, the wrap at 64, and one row decodes past it.
SERVE = {
    "zamba2_2x2": ("decode", *HYBRID, (2, 2), MAX_SEQ, POS0),
    "zamba2_1x4": ("decode", *HYBRID, (1, 4), MAX_SEQ, POS0),
    "seamless_2x2": ("decode", *ENCDEC, (2, 2), MAX_SEQ, POS0),
    "seamless_1x4": ("decode", *ENCDEC, (1, 4), MAX_SEQ, POS0),
    "vision_2x2": ("decode", *VLM, (2, 2), MAX_SEQ, POS0),
    "vision_1x4": ("decode", *VLM, (1, 4), MAX_SEQ, POS0),
    "zamba2_ring_kv2_1x4": ("decode", *_with(HYBRID, n_kv_heads=2), (1, 4),
                            128, (14, 47, 62, 70)),
    # One decode token against 8 encoder rows, in chunks of 2; the VLM's
    # against 16 vision tokens.
    "seamless_chunk_2x2": ("decode", *_with(ENCDEC, attn_chunk=2), (2, 2),
                           MAX_SEQ, POS0),
    "vision_chunk_1x4": ("decode", *_with(VLM, attn_chunk=2), (1, 4),
                         MAX_SEQ, POS0),
    "seamless_prefill_2x2": ("prefill", *ENCDEC, (2, 2), MAX_SEQ, None),
    "vision_prefill_1x4": ("prefill", *VLM, (1, 4), MAX_SEQ, None),
    "zamba2_engine_2x2": ("engine", *HYBRID, (2, 2), ENGINE["max_seq"],
                          None),
}
DECODE = [c for c, v in SERVE.items() if v[0] == "decode"]
OTHERS = [c for c, v in SERVE.items() if v[0] != "decode"]


def train_config(case: str, archs):
    """The train case's config from the registry `archs` (the port's or
    the reference's)."""
    arch, overrides = TRAIN[case][:2]
    return dataclasses.replace(archs[arch].reduced(), **overrides)


def serve_config(case: str, archs):
    _, arch, overrides = SERVE[case][:3]
    return dataclasses.replace(archs[arch].reduced(), **overrides)


def frontend(cfg, batch: int, seq: int, rng) -> dict:
    """The stub frontend's input of the family, float32 from `rng`:
    encdec's frames (B, S // enc_ratio, d_model), the VLM's vision
    embeddings (B, vision_tokens, vision_dim)."""
    if cfg.family == "encdec":
        shape = (batch, max(seq // cfg.enc_ratio, 1), cfg.d_model)
        return {"frames": rng.standard_normal(shape, dtype=np.float32)}
    if cfg.family == "vlm":
        shape = (batch, cfg.vision_tokens, cfg.vision_dim)
        return {"vision_emb": rng.standard_normal(shape, dtype=np.float32)}
    return {}


def train_batch(cfg, seed: int = 1) -> dict:
    """lc.batch's tokens and labels and the frontend's input."""
    out = lc.batch(cfg.vocab, seed)
    out.update(frontend(cfg, lc.B, lc.S, np.random.default_rng(seed + 1)))
    return out


def adjust(params: dict, cfg) -> dict:
    """The seed-made numpy tree with the VLM's gate at GATE (a zero gate
    hides the cross-attention)."""
    if cfg.family == "vlm":
        gate = params["ca_blocks"]["gate"]
        params["ca_blocks"]["gate"] = np.full(gate.shape, GATE, gate.dtype)
    return params


def seeded_cache(cfg, batch: int, max_seq: int, seed: int = 2) -> dict:
    """The family's cache tree of `init_cache(cfg, batch, max_seq)` in
    float32, every leaf drawn from N(0, 1) (None where the cache holds
    None): non-zero keys, values, states, encoder rows and vision tokens
    for decode to start from."""
    from repro_torch.models import api
    rng = np.random.default_rng(seed)

    def draw(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        return rng.standard_normal(tuple(t.shape), dtype=np.float32)

    return draw(api.init_cache(cfg, batch, max_seq, device="meta"))


def serve_inputs(case: str, vocab: int) -> dict:
    """sc.inputs' tokens, prompt and prompts, this case's first positions,
    and the frontend's input of a prefill."""
    from repro_torch.configs import ARCHS
    out = sc.inputs(vocab)
    pos0 = SERVE[case][5]
    if pos0 is not None:
        out["pos"] = np.asarray(pos0, np.int32)
    out.update(frontend(serve_config(case, ARCHS), B, PREFILL_S,
                        np.random.default_rng(3)))
    return out


# -- the ranks' side ----------------------------------------------------------

def _placed(cache_np, fns):
    """A numpy cache tree as DTensors of the decode step's placements
    (every rank its own block)."""
    from repro_torch.models.common import distribute_tree
    return sc.tree_map(lambda a, pl: distribute_tree(
        torch.from_numpy(a.copy()), pl, fns.mesh), cache_np,
        fns.cache_placements)


def _decode_steps(cfg, fns, one, model, model1, cache, cache1, ref, got):
    """STEPS greedy steps over the mesh and in one process from the same
    tokens and first positions, each fed its own next tokens; into `got`
    the tokens, the logits' differences and every cache block's."""
    from repro_torch.models.common import NO_SHARD, ShardCtx
    shd = ShardCtx(fns.mesh, fns.rules)
    tok = tok1 = torch.as_tensor(ref["inputs"]["tokens"])
    pos0 = torch.as_tensor(ref["inputs"]["pos"])
    got.update(tokens=[], one=[], logits=[])
    for t in range(STEPS):
        pos = pos0 + t
        lg = sc._decode_logits(model, cfg, cache, tok, pos, shd)
        lg1 = sc._decode_logits(model1, cfg, cache1, tok1, pos, NO_SHARD)
        nxt, _ = fns.decode(model, cache, tok, pos)
        nxt1, _ = one.decode(model1, cache1, tok1, pos)
        got["tokens"].append(nxt.numpy().copy())
        got["one"].append(nxt1.numpy().copy())
        got["logits"].append({"one": float((lg - lg1).abs().max())})
        if "logits" in ref:
            got["logits"][-1]["ref"] = float(np.abs(
                lg.double().numpy() - ref["logits"][t]).max())
        tok, tok1 = nxt[:, None], nxt1[:, None]
    want = sc.flat(ref.get("cache", {}))
    one_flat = sc.flat(cache1)
    got["cache"] = {k: sc._errors(v, want.get(k), one_flat[k])
                    for k, v in sc.flat(cache).items()}
    got["placements"] = {k: tuple(str(p) for p in pl)
                         for k, pl in sc.flat(fns.cache_placements).items()}
    got["counts"] = (fns.eager_calls, fns.captures, fns.replays)


def _models(cfg, ref, fns):
    from repro_torch.models.convert import params_from_jax
    return (params_from_jax(ref["params"], cfg, device="cpu", mesh=fns.mesh,
                            rules=fns.rules),
            params_from_jax(ref["params"], cfg, device="cpu"))


def run_decode(case: str, mesh, ref: dict) -> dict:
    """Decode from the seeded cache (`ref["cache0"]`), over the mesh and in
    one process, float32 caches (module docstring of
    tests/_torch_serve_mesh_cases.py)."""
    from repro_torch.configs import ARCHS
    from repro_torch.serve import build_decode_step
    cfg = serve_config(case, ARCHS)
    max_seq = SERVE[case][4]
    fns = build_decode_step(cfg, B, max_seq, mesh=mesh, device="cpu")
    one = build_decode_step(cfg, B, max_seq, device="cpu")
    model, model1 = _models(cfg, ref, fns)
    cache = _placed(ref["cache0"], fns)
    cache1 = sc.tree_map(lambda a: torch.from_numpy(a.copy()), ref["cache0"])
    got = {}
    _decode_steps(cfg, fns, one, model, model1, cache, cache1, ref, got)
    return got


def run_prefill(case: str, mesh, ref: dict) -> dict:
    """`build_prefill(mesh=)` over the prompt and the frontend's input
    against the reference's and the one-process prefill's logits; then
    `api.prefill` over the mesh into a zeroed float32 cache of the decode
    step's placements (filling `enc_out` or `vis` and, for enc-dec, the
    self-attention blocks) against the reference's and the one-process
    `api.prefill`, and STEPS decode steps from the filled caches at the
    positions after the prompt."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import ShardCtx, distribute_tree
    from repro_torch.serve import build_decode_step, build_prefill
    from repro_torch.serve.serve_step import mesh_cache
    cfg = serve_config(case, ARCHS)
    inputs = ref["inputs"]
    batch = {"tokens": inputs["prompt"],
             **{k: inputs[k] for k in ("frames", "vision_emb")
                if k in inputs}}
    fp = build_prefill(cfg, mesh=mesh, batch_shapes={
        k: v.shape for k, v in batch.items()}, device="cpu")
    model, model1 = _models(cfg, ref, fp)
    lg = fp.prefill(model, batch)
    lg1 = build_prefill(cfg, device="cpu").prefill(
        model1, {k: torch.as_tensor(v) for k, v in batch.items()})
    got = {"prefill": {"one": float((lg - lg1).abs().max())},
           "shape": tuple(lg.shape)}
    if "prefill_logits" in ref:
        got["prefill"]["ref"] = float(np.abs(lg.double().numpy()
                                             - ref["prefill_logits"]).max())

    fns = build_decode_step(cfg, B, MAX_SEQ, mesh=mesh, device="cpu")
    one = build_decode_step(cfg, B, MAX_SEQ, device="cpu")
    model, model1 = _models(cfg, ref, fns)
    shd = ShardCtx(mesh, fns.rules)
    cache = mesh_cache(cfg, fns, torch.float32)
    cache1 = api.init_cache(cfg, B, MAX_SEQ, torch.float32, device="cpu")
    rows = {k: distribute_tree(torch.as_tensor(v), shd.placements(
        v.shape, "batch", *(None,) * (v.ndim - 1)), mesh)
        for k, v in batch.items()}
    with torch.no_grad():
        lg, _ = api.prefill(model, cfg, rows, cache, shd)
        lg1, _ = api.prefill(model1, cfg, {k: torch.as_tensor(v) for k, v in
                                           batch.items()}, cache1)
    lg = lg.full_tensor()
    got["api_prefill"] = {"one": float((lg - lg1).abs().max())}
    if "api_logits" in ref:
        got["api_prefill"]["ref"] = float(np.abs(
            lg[:, -1].double().numpy() - ref["api_logits"]).max())
    want = sc.flat(ref.get("prefilled", {}))
    got["prefilled"] = {k: sc._errors(v, want.get(k), sc.flat(cache1)[k])
                        for k, v in sc.flat(cache).items()}
    ref = dict(ref, inputs=dict(inputs, pos=np.full(B, PREFILL_S, np.int32)))
    _decode_steps(cfg, fns, one, model, model1, cache, cache1, ref, got)
    return got


def run_engine(case: str, mesh, ref: dict) -> dict:
    from repro_torch.configs import ARCHS
    return sc.serve_engine(serve_config(case, ARCHS), mesh, ref)


RUNS = {"decode": run_decode, "prefill": run_prefill, "engine": run_engine}


def _meshes(shapes, rank: int, world: int, store: str) -> dict:
    from repro_torch.launch.mesh import lm_mesh, make_lm_mesh
    meshes = {shapes[0]: make_lm_mesh(shapes[0], backend="gloo",
                                      device="cpu",
                                      init_method=f"file://{store}",
                                      rank=rank, world_size=world,
                                      timeout_s=sc.COLLECTIVE_TIMEOUT_S)}
    for shape in shapes:
        if shape not in meshes:
            meshes[shape] = lm_mesh("cpu", shape)
    return meshes


def train_rank(rank: int, world: int, store: str, out_dir: str, cases
               ) -> None:
    """A gloo rank on the CPU: every train case of `cases`, each over a
    mesh of its shape (built by every rank, in case order, from one
    default group), through lc.run_steps."""
    import torch.distributed as dist
    from repro_torch.configs import ARCHS
    torch.set_num_threads(1)
    meshes = _meshes([TRAIN[c][2] for c in cases], rank, world, store)
    try:
        got = {}
        for case in cases:
            _, _, shape, bits, chained = TRAIN[case]
            with open(Path(out_dir) / f"{case}.pkl", "rb") as f:
                ref = pickle.load(f)
            got[case] = lc.run_steps(train_config(case, ARCHS), 1, bits,
                                     chained, meshes[shape], ref)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def serve_rank(rank: int, world: int, store: str, out_dir: str, cases
               ) -> None:
    """A gloo rank on the CPU: every serve case of `cases`, each over a
    mesh of its shape."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    meshes = _meshes([SERVE[c][3] for c in cases], rank, world, store)
    try:
        got = {}
        for case in cases:
            with open(Path(out_dir) / f"{case}.pkl", "rb") as f:
                ref = pickle.load(f)
            mesh = meshes[SERVE[case][3]]
            got[case] = RUNS[SERVE[case][0]](case, mesh, ref)
            got[case]["coordinate"] = tuple(mesh.get_coordinate())
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def _cache_ok(caches: dict, which: str) -> None:
    for key, err in caches.items():
        if key.endswith("ssm"):
            assert err[which] <= sc.STATE_TOL, (key, err)
        else:
            assert err[f"{which}_rel"] <= sc.CACHE_TOL, (key, err)


def check_one_process(ranks, case: str) -> float:
    """Every rank's results of `case` against the one-process port's
    alone (the check of a run without the reference): the same tokens,
    logits within LOGIT_TOL, cache blocks within CACHE_TOL (STATE_TOL for
    the SSM states).  Returns the worst logit difference; raises
    AssertionError on a failure."""
    worst = 0.0
    for rank in ranks:
        got = rank[case]
        if SERVE[case][0] == "engine":
            assert got["tokens"] == got["one"], (case, "tokens")
            assert got["tokens"][-1] == got["solo"], (case, "reused slot")
            continue
        logits = [lg["one"] for lg in got["logits"]]
        if SERVE[case][0] == "prefill":
            logits += [got["prefill"]["one"], got["api_prefill"]["one"]]
            _cache_ok(got["prefilled"], "one")
        for t in range(STEPS):
            np.testing.assert_array_equal(got["tokens"][t], got["one"][t],
                                          str((case, t)))
        worst = max(worst, *logits)
        assert max(logits) <= sc.LOGIT_TOL, (case, logits)
        _cache_ok(got["cache"], "one")
    return worst
