"""The port's dense family (`models/transformer.py`) against the JAX
package: reduced qwen2-0.5b (QKV bias, tied embeddings) and reduced
qwen3-14b (QK norm), in float32 with the reference's parameters carried
over by `params_from_jax`.

Float outputs agree within atol = rtol = 1e-5 per module and 1e-4 for the
whole model (the frameworks sum matrix products and softmaxes in other
orders, and those differences grow over the layers); greedy tokens are
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import api as japi
from repro.models import layers as JL
from repro.models.common import count_params as jcount_params
from repro.models.common import init_params as jinit_params
from repro.models.common import map_layout as jmap_layout
from repro_torch.configs import ARCHS
from repro_torch.models import api, layers as L, transformer as TF
from repro_torch.models.common import count_params, map_layout
from repro_torch.models.convert import params_from_jax

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = ["qwen2-0.5b", "qwen3-14b"]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _carried(name, **changes):
    jcfg = dataclasses.replace(JARCHS[name].reduced(), **changes)
    cfg = dataclasses.replace(ARCHS[name].reduced(), **changes)
    jparams = jinit_params(japi.layout(jcfg), jax.random.key(0), jnp.float32)
    # Non-zero biases and norm scales, so that every leaf is read.
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                  jnp.float32), jparams)
    return jcfg, cfg, jparams, params_from_jax(jax.device_get(jparams), cfg,
                                               device="cpu")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("reduced", [False, True])
def test_layout_matches_reference(name, reduced):
    jcfg, cfg = JARCHS[name], ARCHS[name]
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    got = map_layout(api.layout(cfg), lambda p, _: dataclasses.astuple(p))
    want = jmap_layout(japi.layout(jcfg), lambda p, _: dataclasses.astuple(p))
    assert got == want
    assert count_params(api.layout(cfg)) == jcount_params(japi.layout(jcfg))


def test_swiglu():
    rng = np.random.default_rng(1)
    lay = L.swiglu_layout(128, 256)
    p = {k: 0.1 * rng.standard_normal(pd.shape).astype(np.float32)
         for k, pd in lay.items()}
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    _close(L.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x)),
           JL.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x)), MODULE_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_block(name):
    jcfg, cfg, jparams, model = _carried(name)
    x = np.random.default_rng(2).standard_normal((2, 12, 128)
                                                 ).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy()
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"])
    from repro.models import transformer as JTF
    want = JTF.block_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           JTF.NO_SHARD)
    got = model.blocks[1](torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want, MODULE_TOL)
    assert torch.equal(got, TF.block_apply(model.blocks[1], cfg,
                                           torch.from_numpy(x),
                                           torch.from_numpy(pos)))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("changes", [{}, {"attn_chunk": 8,
                                          "sliding_window": 12}],
                         ids=["dense", "chunked_window12"])
def test_forward(name, changes):
    jcfg, cfg, jparams, model = _carried(name, **changes)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 32)
                                             ).astype(np.int32)
    want_lg, want_aux = japi.forward(jparams, jcfg,
                                     {"tokens": jnp.asarray(toks)})
    got_lg, got_aux = api.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert got_aux == want_aux == {}
    assert got_lg.shape == (2, 32, cfg.padded_vocab())
    _close(got_lg, want_lg, MODEL_TOL)
    last, _ = api.forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                          last_only=True)
    torch.testing.assert_close(last[:, 0], got_lg[:, -1], **MODULE_TOL)
    assert torch.equal(model(torch.from_numpy(toks)), got_lg)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_steps(name):
    """Prefill 3 tokens, then 6 greedy decode steps: logits and caches
    within 1e-4 of the reference's and the same greedy tokens."""
    jcfg, cfg, jparams, model = _carried(name)
    Bn, S, Smax = 2, 3, 12
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (Bn, S)
                                             ).astype(np.int32)
    jcache = japi.init_cache(jcfg, Bn, Smax, jnp.float32)
    cache = api.init_cache(cfg, Bn, Smax, torch.float32, device="cpu")
    want_lg, jcache = japi.prefill(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)}, jcache)
    got_lg, cache = api.prefill(model, cfg, {"tokens": torch.from_numpy(toks)},
                                cache)
    _close(got_lg, want_lg, MODEL_TOL)
    for k in ("k", "v"):
        _close(cache[k], jcache[k], MODEL_TOL)
    tok = np.asarray(jnp.argmax(want_lg[:, -1], -1)).astype(np.int32)
    assert np.array_equal(got_lg[:, -1].argmax(-1).numpy(), tok)
    for t in range(6):
        pos = np.full(Bn, S + t, np.int32)
        want_lg, jcache = japi.decode_step(jparams, jcfg, jcache,
                                           {"tokens": jnp.asarray(tok[:, None])},
                                           jnp.asarray(pos))
        got_lg, cache = api.decode_step(model, cfg, cache,
                                        {"tokens": torch.from_numpy(tok[:, None])},
                                        torch.from_numpy(pos))
        _close(got_lg, want_lg, MODEL_TOL)
        nxt = np.asarray(jnp.argmax(want_lg[:, -1], -1)).astype(np.int32)
        assert np.array_equal(got_lg[:, -1].argmax(-1).numpy(), nxt)
        tok = nxt
    for k in ("k", "v"):
        _close(cache[k], jcache[k], MODEL_TOL)


def test_tied_embeddings_share_one_leaf():
    """qwen2's unembedding is its token table: one parameter, whose
    gradient sums both uses."""
    _, cfg, _, model = _carried("qwen2-0.5b")
    assert cfg.tie_embeddings and "unembed" not in model.tree()["embed"]
    model.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(5))
    lg, _ = api.forward(model, cfg, {"tokens": toks})
    lg[..., :cfg.vocab].sum().backward()
    g = model.embed.tok.grad
    assert g is not None and bool(g[cfg.vocab:].eq(0).all())
    assert bool(g[toks.unique()].abs().sum(-1).gt(0).all())
