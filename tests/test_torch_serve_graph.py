"""What the captured serve steps rest on, on the CPU: the MoE model builds
its default dispatch plan once and routes from the plan's kept tables, so
a second step uploads nothing and plans nothing; a decode given one plan
over several steps still equals the JAX package's; and off the card every
call of the serve builders runs eagerly (the graphs are held on the card
in test_torch_cuda.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models.common import init_params as jinit_params
from repro_torch.configs import ARCHS
from repro_torch.models import api, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import build_decode_step, build_prefill

NAME = "mixtral-8x22b"
HOT = np.array([1000.0] + [10.0] * 7)     # expert 0 on 8 of the 16 slots


@pytest.fixture(scope="module")
def carried():
    """(JAX cfg, JAX params (f32), port cfg, port model) of the reduced
    mixtral with a sliding window of 4."""
    jcfg = dataclasses.replace(JARCHS[NAME].reduced(), sliding_window=4)
    cfg = dataclasses.replace(ARCHS[NAME].reduced(), sliding_window=4)
    jparams = jinit_params(japi.layout(jcfg), jax.random.key(0), jnp.float32)
    return (jcfg, jparams, cfg,
            params_from_jax(jax.device_get(jparams), cfg, device="cpu"))


def test_second_step_uploads_nothing_and_plans_nothing(carried, monkeypatch):
    """Count `torch.as_tensor` (the tables' upload) and `plan_dispatch`
    over a first and a second `moe_ffn` and `decode_step` without a plan:
    the second of each calls neither."""
    _, _, cfg, model = carried
    calls = {"as_tensor": 0, "plan_dispatch": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(torch, "as_tensor",
                        counted("as_tensor", torch.as_tensor))
    monkeypatch.setattr(moe, "plan_dispatch",
                        counted("plan_dispatch", moe.plan_dispatch))
    moe._uniform_plan.cache_clear()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))
    cache = api.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    toks = torch.tensor([[3], [9]], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    first = []
    for _ in range(2):
        before = dict(calls)
        moe.moe_ffn(model.blocks[0].moe, cfg, moe.build_plan(cfg), x)
        moe.decode_step(model, cfg, cache, toks, pos)
        first.append({k: calls[k] - before[k] for k in calls})
    assert first[0] == {"as_tensor": 2, "plan_dispatch": 1}
    assert first[1] == {"as_tensor": 0, "plan_dispatch": 0}
    assert moe.build_plan(cfg) is moe.build_plan(cfg)
    hot = moe.build_plan(cfg, HOT)
    assert calls["plan_dispatch"] == 2 and hot is not moe.build_plan(cfg)


@pytest.mark.parametrize("plan", ["hot", "default"])
def test_decode_with_one_plan_equals_jax(carried, plan):
    """A prefill of 3 tokens, then 5 greedy decode steps past the window
    of 4, every step given the same plan object (a hot expert on 8 slots,
    or none: the default plan, built once): the greedy tokens equal the
    JAX package's, logits and caches within 1e-4."""
    jcfg, jparams, cfg, model = carried
    B, S, Smax = 2, 3, 10
    tplan = moe.build_plan(cfg, HOT) if plan == "hot" else None
    jplan = jmoe.build_plan(jcfg, HOT) if plan == "hot" else None
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S)
                                             ).astype(np.int32)
    jcache = japi.init_cache(jcfg, B, Smax, jnp.float32)
    cache = api.init_cache(cfg, B, Smax, torch.float32, device="cpu")
    want_lg, jcache = jmoe.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                                   plan=jplan)
    got_lg, cache = moe.prefill(model, cfg, torch.from_numpy(toks), cache,
                                plan=tplan)
    jdecode = jax.jit(lambda p, c, t, pos: jmoe.decode_step(
        p, jcfg, c, t, pos, plan=jplan))
    nxt = np.argmax(np.asarray(want_lg)[:, -1], -1).astype(np.int32)
    for step in range(5):
        pos = np.full(B, S + step, np.int32)
        want_lg, jcache = jdecode(jparams, jcache, jnp.asarray(nxt[:, None]),
                                  jnp.asarray(pos))
        got_lg, cache = moe.decode_step(model, cfg, cache,
                                        torch.from_numpy(nxt[:, None]),
                                        torch.from_numpy(pos), plan=tplan)
        np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg),
                                   atol=1e-4, rtol=1e-4)
        want_tok = np.argmax(np.asarray(want_lg)[:, -1], -1).astype(np.int32)
        np.testing.assert_array_equal(
            got_lg[:, -1].argmax(-1).numpy().astype(np.int32), want_tok)
        nxt = want_tok
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-4,
                                   rtol=1e-4)
    if plan == "hot":
        assert tplan.max_group == 8 and list(tplan._tables) == [
            torch.device("cpu")]


def test_builders_run_eagerly_off_the_card(carried):
    """On the CPU every decode call runs eagerly: no capture, no replay,
    and the tokens those of `api.decode_step`; the prefill, eager
    everywhere, gives `api.forward`'s last logits."""
    _, _, cfg, model = carried
    fns = build_decode_step(cfg, 2, 8, device="cpu")
    cache = api.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    ref = api.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    toks = torch.tensor([[5], [7]], dtype=torch.int32)
    for t in range(3):
        pos = torch.full((2,), t, dtype=torch.int32)
        nxt, got = fns.decode(model, cache, toks, pos)
        lg, _ = api.decode_step(model, cfg, ref, {"tokens": toks}, pos)
        assert got is cache
        assert torch.equal(nxt, lg[:, -1].argmax(-1).to(torch.int32))
        toks = nxt[:, None]
    assert (fns.eager_calls, fns.captures, fns.replays) == (3, 0, 0)
    pre = build_prefill(cfg, device="cpu")
    assert pre.compiled is None
    lg = pre.prefill(model, {"tokens": toks})
    want, _ = api.forward(model, cfg, {"tokens": toks}, last_only=True)
    assert torch.equal(lg, want[:, -1])
