"""The port's continuous-batching `ServingEngine` (reduced mixtral, MoE
decode through the port's model) against the JAX package's engine with
the same float32 parameters, token for token, and the reference's engine
tests mirrored on the port alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch.mesh import make_mesh_compat
from repro.models import api as japi
from repro.models.common import init_params as jinit_params
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import ARCHS
from repro_torch.models import api
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServingEngine, build_decode_step, build_prefill

NAME = "mixtral-8x22b"
# (prompt length, max_new_tokens) of the reference's engine test.
REQUESTS = ((5, 6), (3, 8), (7, 4), (2, 10), (4, 5))


@pytest.fixture(scope="module")
def carried():
    """(JAX cfg, JAX params (f32), port cfg, port model)."""
    jcfg, cfg = JARCHS[NAME].reduced(), ARCHS[NAME].reduced()
    jparams = jinit_params(japi.layout(jcfg), jax.random.key(0), jnp.float32)
    return (jcfg, jparams, cfg,
            params_from_jax(jax.device_get(jparams), cfg, device="cpu"))


def _engine(carried, slots=4, max_seq=48):
    _, _, cfg, model = carried
    return ServingEngine(cfg, slots, max_seq, model, device="cpu")


def test_tokens_match_the_jax_engine(carried):
    """Five requests on two slots (the JAX engine on a 1 x 1 mesh): every
    request's output equal token for token."""
    jcfg, jparams, cfg, model = carried
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n, _ in REQUESTS]
    jeng = JaxEngine(jcfg, make_mesh_compat((1, 1), ("data", "model")), 2,
                     48, jparams)
    jreqs = [jeng.submit(p, m) for p, (_, m) in zip(prompts, REQUESTS)]
    jeng.run()
    eng = _engine(carried, slots=2)
    reqs = [eng.submit(p, m) for p, (_, m) in zip(prompts, REQUESTS)]
    eng.run()
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert [len(r.out) for r in reqs] == [m for _, m in REQUESTS]
    assert eng.tokens_out == jeng.tokens_out == sum(m for _, m in REQUESTS)
    assert eng.ticks == jeng.ticks
    assert eng.cache["k"].dtype == torch.bfloat16


def test_continuous_batching_matches_solo_generation(carried):
    """Sharing slots must not change any request's output (isolation)."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 500, size=n).tolist() for n in (4, 6, 3)]
    eng = _engine(carried, slots=3)
    reqs = [eng.submit(p, 5) for p in prompts]
    eng.run()
    solo = []
    for p in prompts:
        eng1 = _engine(carried, slots=1)
        r = eng1.submit(p, 5)
        eng1.run()
        solo.append(r.out)
    assert [r.out for r in reqs] == solo


def test_slot_reuse_is_isolated(carried):
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, 500, size=6).tolist()
    p2 = rng.integers(0, 500, size=4).tolist()
    eng = _engine(carried, slots=1)
    eng.submit(p1, 4)
    r2 = eng.submit(p2, 4)
    eng.run()
    fresh = _engine(carried, slots=1)
    r2f = fresh.submit(p2, 4)
    fresh.run()
    assert r2.out == r2f.out


def test_reset_slot_zeroes_its_cache_rows(carried):
    eng = _engine(carried, slots=2)
    for a in eng.cache.values():
        a.fill_(1)
    eng._reset_slot(1)
    for a in eng.cache.values():
        assert (a[:, 1] == 0).all() and (a[:, 0] == 1).all()


def test_occupancy_and_fifo_admission(carried):
    eng = _engine(carried, slots=4)
    eng.submit([1, 2, 3], 4)
    eng._admit()
    assert eng.occupancy() == 0.25
    eng = _engine(carried, slots=3)
    reqs = [eng.submit([1 + (i % 7), 2, 3], 2) for i in range(8)]
    eng._admit()
    assert [eng.slots[i] for i in range(3)] == reqs[:3]
    reqs[3].done = True                         # cancelled before admission
    reqs[0].done, eng.slots[0] = True, None
    eng._admit()
    assert eng.slots[0] is reqs[4] and len(eng.waiting) == 3
    eng.run()
    assert all(r.done for r in reqs) and not eng.waiting
    assert eng.tokens_out == 2 * 6          # all but the two marked done


def test_max_seq_ends_a_request(carried):
    eng = _engine(carried, slots=1, max_seq=8)
    r = eng.submit([5, 6, 7], 20)
    eng.run()
    assert r.done and len(r.out) == 8 - 3


def test_prefill_builder_gives_the_last_position_logits(carried):
    _, _, cfg, model = carried
    toks = torch.randint(0, cfg.vocab, (2, 9),
                         generator=torch.Generator().manual_seed(3))
    fns = build_prefill(cfg, device="cpu")
    lg = fns.prefill(model, {"tokens": toks})
    want, _ = api.forward(model, cfg, {"tokens": toks})
    assert lg.shape == (2, cfg.padded_vocab())
    torch.testing.assert_close(lg, want[:, -1], atol=1e-5, rtol=1e-5)


def test_decode_builder_is_greedy(carried):
    _, _, cfg, model = carried
    fns = build_decode_step(cfg, 2, 16, device="cpu")
    cache = api.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    toks = torch.tensor([[3], [9]], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    nxt, _ = fns.decode(model, cache, toks, pos)
    cache2 = api.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    lg, _ = api.decode_step(model, cfg, cache2, {"tokens": toks}, pos)
    assert nxt.dtype == torch.int32
    assert torch.equal(nxt, lg[:, -1].argmax(-1).to(torch.int32))
    with pytest.raises(ValueError, match="built for"):
        fns.decode(model, api.init_cache(cfg, 3, 16, device="cpu"),
                   toks, pos)


def test_unported_family_is_refused(carried):
    """Every registered family is ported; a family the registry does not
    know is refused by the dispatch's lookup, as the reference's."""
    cfg = dataclasses.replace(ARCHS["mamba2-370m"].reduced(), family="rnn")
    with pytest.raises(KeyError, match="rnn"):
        build_decode_step(cfg, 2, 16, device="cpu")


@pytest.mark.parametrize("name,slots,max_seq", [
    ("mamba2-370m", 2, 16), ("zamba2-7b", 3, 12),
    ("seamless-m4t-medium", 2, 16), ("llama-3.2-vision-90b", 2, 8)])
def test_decode_builder_checks_the_family_cache(name, slots, max_seq):
    """The decode step takes the family's `init_cache` tree for its slots
    and positions (nested, with None where there is no tail) and refuses
    another's; encdec's enc_out may hold the rows a prefill gave it."""
    from repro_torch.serve.serve_step import cache_shapes
    cfg = ARCHS[name].reduced()
    model = api.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    fns = build_decode_step(cfg, slots, max_seq, device="cpu")
    cache = api.init_cache(cfg, slots, max_seq, device="cpu")
    assert cache_shapes(cfg, slots, max_seq) == {
        k: (None if v is None else
            {kk: tuple(vv.shape) for kk, vv in v.items()}
            if isinstance(v, dict) else tuple(v.shape))
        for k, v in cache.items()}
    toks = torch.zeros((slots, 1), dtype=torch.int32)
    pos = torch.zeros(slots, dtype=torch.int32)
    nxt, _ = fns.decode(model, cache, toks, pos)
    assert nxt.shape == (slots,)
    if cfg.family == "encdec":
        cache["enc_out"] = cache["enc_out"][:, :1].clone()
        fns.decode(model, cache, toks, pos)
    longer = api.init_cache(cfg, slots, max_seq + 1, device="cpu")
    if cfg.family == "ssm":          # its state does not grow with max_seq
        fns.decode(model, longer, toks, pos)
    else:
        with pytest.raises(ValueError, match="built for"):
            fns.decode(model, longer, toks, pos)
    with pytest.raises(ValueError, match="built for"):
        fns.decode(model, api.init_cache(cfg, slots + 1, max_seq,
                                         device="cpu"),
                   torch.zeros((slots + 1, 1), dtype=torch.int32),
                   torch.zeros(slots + 1, dtype=torch.int32))


def test_reset_slot_walks_the_nested_cache():
    """The hybrid cache nests dicts and holds None (no tail): slot i of
    every state is zeroed (batch axis 1 from rank 3, 0 below); encdec's
    and vlm's rank-3 (B, rows, d) leaves lose column i, as the
    reference's convention does, and an index past their rows is dropped."""
    for name, changes in (("zamba2-7b", {"n_layers": 6, "attn_every": 2}),
                          ("seamless-m4t-medium", {}),
                          ("llama-3.2-vision-90b", {})):
        cfg = dataclasses.replace(ARCHS[name].reduced(), **changes)
        model = api.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        eng = ServingEngine(cfg, 3, 8, model, device="cpu")
        leaves = []

        def fill(t):
            for v in t.values():
                if isinstance(v, dict):
                    fill(v)
                elif v is not None:
                    v.fill_(1)
                    leaves.append(v)

        fill(eng.cache)
        if name == "zamba2-7b":
            assert eng.cache["tail"] is None
        eng._reset_slot(1)
        for a in leaves:
            assert bool((a[:, 1] == 0).all()) and bool((a[:, 0] == 1).all())
        if name == "seamless-m4t-medium":
            assert eng.cache["enc_out"].shape[1] == 2
            eng._reset_slot(2)                   # past enc_out's 2 rows
            assert bool((eng.cache["enc_out"][:, 0] == 1).all())
            assert bool((eng.cache["k"][:, 2] == 0).all())
