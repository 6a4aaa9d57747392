"""The port's MoE model (mixtral-8x22b, reduced) against the JAX package,
in float32 on both sides with the reference's parameters carried over by
`params_from_jax`.

Integer outputs (expert loads, dropped tokens, slots, greedy tokens) must
be equal.  Float outputs agree within atol = rtol = 1e-5 per module and
1e-4 for the whole model: the two frameworks sum matrix products and
softmaxes in other orders, and those differences grow over the layers.
The JAX side reaches the Pallas `segment_histogram` in interpret mode, as
the JAX package's own tests run it on the CPU.
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
from repro.models import moe as jmoe
from repro.models.common import count_params as jcount_params
from repro.models.common import init_params as jinit_params
from repro.models.common import map_layout as jmap_layout
from repro_torch.configs import ARCHS, cell_applicable, SHAPES
from repro_torch.core.moe_shares import route_tokens
from repro_torch.models import api, layers as L, moe
from repro_torch.models.common import (count_params, init_params,
                                       map_layout)
from repro_torch.models.convert import params_from_jax

NAME = "mixtral-8x22b"
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(**changes):
    """(JAX cfg, port cfg): the reduced mixtral with the same changes."""
    return (dataclasses.replace(JARCHS[NAME].reduced(), **changes),
            dataclasses.replace(ARCHS[NAME].reduced(), **changes))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def carried():
    """(JAX params (f32), port model, port cfg) of the reduced mixtral."""
    jcfg, cfg = _cfgs()
    jparams = jinit_params(japi.layout(jcfg), jax.random.key(0), jnp.float32)
    model = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    return jparams, model, cfg


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- configs and layouts ----------------------------------------------------

def test_configs_match_reference():
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in ARCHS:
        for got, want in ((ARCHS[name], JARCHS[name]),
                          (ARCHS[name].reduced(), JARCHS[name].reduced())):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
            assert (got.n_slots(), got.padded_vocab()) == \
                (want.n_slots(), want.padded_vocab())
            if got.n_heads:
                assert got.hd() == want.hd()
        from repro.configs import cell_applicable as jcell
        for shape in SHAPES:
            assert cell_applicable(ARCHS[name], shape) == \
                jcell(JARCHS[name], shape)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_layout_matches_reference(name, reduced):
    jcfg, cfg = JARCHS[name], ARCHS[name]
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    got = map_layout(api.layout(cfg), lambda p, _: dataclasses.astuple(p))
    want = jmap_layout(japi.layout(jcfg), lambda p, _: dataclasses.astuple(p))
    assert got == want
    assert count_params(api.layout(cfg)) == jcount_params(japi.layout(jcfg))


def test_unported_families_raise():
    for name in ("qwen2-0.5b", "mamba2-370m", "zamba2-7b",
                 "seamless-m4t-medium", "llama-3.2-vision-90b"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
            api.layout(ARCHS[name].reduced())


def test_parameter_names_follow_the_layout(carried):
    _, model, cfg = carried
    names = {n for n, _ in model.named_parameters()}
    want = {"embed.tok", "embed.final_norm", "embed.unembed"}
    for i in range(cfg.n_layers):
        want |= {f"blocks.{i}.attn.{k}" for k in ("wq", "wk", "wv", "wo",
                                                  "norm")}
        want |= {f"blocks.{i}.moe.{k}" for k in ("router", "w1", "w3", "w2",
                                                 "norm")}
    assert names == want
    assert not any(p.requires_grad for p in model.parameters())


def test_params_from_jax_carries_bf16_exactly_and_checks_shapes():
    jcfg, cfg = _cfgs()
    jp = jax.device_get(jinit_params(japi.layout(jcfg), jax.random.key(1)))
    assert jp["blocks"]["moe"]["w1"].dtype.name == "bfloat16"
    model = params_from_jax(jp, cfg, device="cpu")
    w1 = model.blocks[1].moe.w1
    assert w1.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w1.float().numpy(), jp["blocks"]["moe"]["w1"][1].astype(np.float32))
    bad = dict(jp, embed=dict(jp["embed"], tok=jp["embed"]["tok"][:-1]))
    with pytest.raises(ValueError, match="tok"):
        params_from_jax(bad, cfg, device="cpu")
    missing = dict(jp, embed={k: v for k, v in jp["embed"].items()
                              if k != "unembed"})
    with pytest.raises(ValueError, match="unembed"):
        params_from_jax(missing, cfg, device="cpu")


def test_init_params_draws_the_layout():
    _, cfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    tree = init_params(api.layout(cfg), g, device="cpu", dtype=torch.float32)
    assert tree["blocks"]["attn"]["norm"].eq(1).all()
    w1 = tree["blocks"]["moe"]["w1"]
    assert w1.shape == (cfg.n_layers, 16, 128, 256)
    assert abs(float(w1.std()) - 0.02) < 1e-3
    again = init_params(api.layout(cfg), torch.Generator().manual_seed(0),
                        device="cpu", dtype=torch.float32)
    assert torch.equal(again["embed"]["tok"], tree["embed"]["tok"])


# -- per module, within 1e-5 ------------------------------------------------

def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 128), _rand(rng, 128)
    _close(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale)), MODULE_TOL)
    q = _rand(rng, 2, 7, 4, 32)
    pos = rng.integers(0, 60, (2, 7)).astype(np.int32)
    for theta in (1e6, 1e4):
        _close(L.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), theta),
               JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), theta),
               MODULE_TOL)
    _close(L.rope_frequencies(32, 1e6), JL.rope_frequencies(32, 1e6),
           MODULE_TOL)


@pytest.mark.parametrize("kv", [1, 2])
@pytest.mark.parametrize("window", [0, 4])
def test_sdpa_dense(kv, window):
    rng = np.random.default_rng(kv + window)
    q, k, v = _rand(rng, 2, 9, 4, 32), _rand(rng, 2, 9, kv, 32), \
        _rand(rng, 2, 9, kv, 32)
    mask = L._causal_mask(9, 9, 0, window)
    jmask = JL._causal_mask(9, 9, 0, window)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    _close(L._sdpa_dense(*map(torch.from_numpy, (q, k, v)), mask),
           JL._sdpa_dense(*map(jnp.asarray, (q, k, v)), jmask), MODULE_TOL)


@pytest.mark.parametrize("S", [32, 29])
@pytest.mark.parametrize("window", [0, 12])
def test_sdpa_chunked(S, window):
    """chunk 8 over S = 32 (four full chunks) and S = 29 (a short last
    chunk, which the reference pads)."""
    rng = np.random.default_rng(S + window)
    q, k, v = _rand(rng, 2, S, 4, 32), _rand(rng, 2, S, 1, 32), \
        _rand(rng, 2, S, 1, 32)
    got = L._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), 0, window, 8)
    _close(got, JL._sdpa_chunked(*map(jnp.asarray, (q, k, v)), 0, window, 8),
           MODULE_TOL)
    dense = L._sdpa_dense(*map(torch.from_numpy, (q, k, v)),
                          L._causal_mask(S, S, 0, window))
    torch.testing.assert_close(got, dense, **MODULE_TOL)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_attention(carried, window, cache_dtype):
    """An f32 query against an f32 or a bf16 cache (JAX promotes to f32)."""
    jparams, model, cfg = carried
    jcfg, cfg = _cfgs(sliding_window=window)
    rng = np.random.default_rng(window)
    B, Smax = 3, 16
    x = _rand(rng, B, 1, 128)
    ck, cv = _rand(rng, B, Smax, 1, 32), _rand(rng, B, Smax, 1, 32)
    pos = np.array([0, 5, 15], np.int32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    jdt = getattr(jnp, cache_dtype)
    want = JL.decode_attention(jp, jcfg, jnp.asarray(x),
                               jnp.asarray(ck).astype(jdt),
                               jnp.asarray(cv).astype(jdt), jnp.asarray(pos))
    tdt = getattr(torch, cache_dtype)
    got = L.decode_attention(model.blocks[0].attn, cfg, torch.from_numpy(x),
                             torch.from_numpy(ck).to(tdt),
                             torch.from_numpy(cv).to(tdt),
                             torch.from_numpy(pos))
    _close(got[0], want[0], MODULE_TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == tdt
        _close(g.float(), np.asarray(w.astype(jnp.float32)), MODULE_TOL)


@pytest.mark.parametrize("changes", [{}, {"attn_chunk": 8,
                                          "sliding_window": 12}],
                         ids=["dense", "chunked_window12"])
def test_self_attention_with_qkv_bias_and_qk_norm(changes):
    """The optional QKV bias and q/k RMSNorm of the attention layout (no
    ported family sets them yet), with random values in every leaf."""
    jcfg, cfg = _cfgs(qkv_bias=True, qk_norm=True, **changes)
    rng = np.random.default_rng(8)
    lay = L.attention_layout(cfg)
    assert {"bq", "bk", "bv", "q_norm", "k_norm"} <= set(lay)
    p = {k: 0.2 * _rand(rng, *pd.shape) for k, pd in lay.items()}
    x = _rand(rng, 2, 32, 128)
    pos = np.broadcast_to(np.arange(32), (2, 32)).copy()
    got = L.self_attention({k: torch.from_numpy(v) for k, v in p.items()},
                           cfg, torch.from_numpy(x), torch.from_numpy(pos))
    want = JL.self_attention({k: jnp.asarray(v) for k, v in p.items()},
                             jcfg, jnp.asarray(x), jnp.asarray(pos))
    _close(got, want, MODULE_TOL)


def _jax_route(jparams, layer, x, jcfg):
    """The reference router's expert ids for x (numpy)."""
    p = jax.tree.map(lambda a: a[layer], jparams["blocks"]["moe"])
    h = JL.rmsnorm(jnp.asarray(x), p["norm"])
    gates = jax.nn.softmax(h.astype(jnp.float32) @ p["router"], axis=-1)
    return np.asarray(jax.lax.top_k(gates, jcfg.topk)[1])


@pytest.mark.parametrize("skew", [1.0, 40.0])
def test_moe_ffn(carried, skew):
    """skew 40 makes expert 0 hot (its router column scaled), so its two
    replica slots overflow their capacity and tokens drop."""
    jparams, model, cfg = carried
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(int(skew))
    B, S = 2, 64
    x = _rand(rng, B, S, 128)
    jp = jax.tree.map(lambda a: np.array(a[0]), jparams["blocks"]["moe"])
    jp["router"][:, 0] *= skew
    jp = jax.tree.map(jnp.asarray, jp)
    tp = moe.MoEFFN(cfg, {k: torch.from_numpy(np.asarray(v))
                          for k, v in jp.items()})
    plan, jplan = moe.build_plan(cfg), jmoe.build_plan(jcfg)
    want_y, want = jmoe.moe_ffn(jp, jcfg, jplan, jnp.asarray(x))
    got_y, got = tp(torch.from_numpy(x), plan)
    _close(got_y, want_y, MODULE_TOL)
    np.testing.assert_array_equal(got["expert_load"].numpy(),
                                  np.asarray(want["expert_load"]))
    assert int(got["dropped_tokens"]) == int(want["dropped_tokens"])
    _close(got["aux_loss"], want["aux_loss"], MODULE_TOL)
    assert int(got["expert_load"].sum()) == B * S * cfg.topk
    if skew > 1:
        assert int(got["dropped_tokens"]) > 0
    # The slots: the same expert ids route to the same slots.
    h = L.rmsnorm(torch.from_numpy(x), tp["norm"])
    gates = torch.softmax(h @ tp["router"], dim=-1)
    _, eidx = moe.top_experts(gates, cfg.topk)
    jeidx = _jax_route({"blocks": {"moe": jax.tree.map(lambda a: a[None],
                                                       jp)}}, 0, x, jcfg)
    np.testing.assert_array_equal(eidx.numpy(), jeidx)
    pos_ids = np.broadcast_to(np.arange(S, dtype=np.int32)[None, :, None],
                              (B, S, cfg.topk)).reshape(-1)
    from repro.core.moe_shares import route_tokens as jroute
    np.testing.assert_array_equal(
        route_tokens(plan, eidx.reshape(-1), torch.from_numpy(pos_ids.copy())
                     ).numpy(),
        np.asarray(jroute(jplan, jnp.asarray(jeidx.reshape(-1)),
                          jnp.asarray(pos_ids))))


@pytest.mark.parametrize("ties", ["zeroed_router", "two_equal_columns"])
def test_moe_ffn_router_ties_go_to_the_lower_expert(carried, ties):
    """Tied gates pick the lower expert index, as jax.lax.top_k does: a
    zeroed router ties every gate (all tokens to experts 0 and 1); two
    equal router columns (experts 2 and 5) tie only those gates."""
    jparams, _, cfg = carried
    jcfg, _ = _cfgs()
    x = _rand(np.random.default_rng(0), 2, 64, 128)
    jp = jax.tree.map(lambda a: np.array(a[0]), jparams["blocks"]["moe"])
    if ties == "zeroed_router":
        jp["router"][:] = 0
    else:
        jp["router"][:, 5] = jp["router"][:, 2]
    jp = jax.tree.map(jnp.asarray, jp)
    tp = moe.MoEFFN(cfg, {k: torch.from_numpy(np.asarray(v))
                          for k, v in jp.items()})
    plan, jplan = moe.build_plan(cfg), jmoe.build_plan(jcfg)
    want_y, want = jmoe.moe_ffn(jp, jcfg, jplan, jnp.asarray(x))
    got_y, got = tp(torch.from_numpy(x), plan)
    np.testing.assert_array_equal(got["expert_load"].numpy(),
                                  np.asarray(want["expert_load"]))
    assert int(got["dropped_tokens"]) == int(want["dropped_tokens"])
    _close(got_y, want_y, MODULE_TOL)
    h = L.rmsnorm(torch.from_numpy(x), tp["norm"])
    _, eidx = moe.top_experts(torch.softmax(h @ tp["router"], dim=-1),
                              cfg.topk)
    jeidx = _jax_route({"blocks": {"moe": jax.tree.map(lambda a: a[None],
                                                       jp)}}, 0, x, jcfg)
    np.testing.assert_array_equal(eidx.numpy(), jeidx)
    if ties == "zeroed_router":
        assert (jeidx == np.array([0, 1])).all()
    else:
        has2, has5 = (jeidx == 2).any(-1), (jeidx == 5).any(-1)
        assert not (has5 & ~has2).any() and (has2 & ~has5).any()
    pos_ids = np.broadcast_to(np.arange(64, dtype=np.int32)[None, :, None],
                              (2, 64, cfg.topk)).reshape(-1)
    from repro.core.moe_shares import route_tokens as jroute
    np.testing.assert_array_equal(
        route_tokens(plan, eidx.reshape(-1), torch.from_numpy(pos_ids.copy())
                     ).numpy(),
        np.asarray(jroute(jplan, jnp.asarray(jeidx.reshape(-1)),
                          jnp.asarray(pos_ids))))


def test_moe_ffn_decode_capacity_one(carried):
    """S = 1 (a decode step): cap = ceil(2/16·1.25) = 1 per slot."""
    jparams, model, cfg = carried
    jcfg, _ = _cfgs()
    x = _rand(np.random.default_rng(5), 4, 1, 128)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["moe"])
    want_y, want = jmoe.moe_ffn(jp, jcfg, jmoe.build_plan(jcfg), jnp.asarray(x))
    got_y, got = moe.moe_ffn(model.blocks[1].moe, cfg, moe.build_plan(cfg),
                             torch.from_numpy(x))
    _close(got_y, want_y, MODULE_TOL)
    np.testing.assert_array_equal(got["expert_load"].numpy(),
                                  np.asarray(want["expert_load"]))
    assert int(got["dropped_tokens"]) == int(want["dropped_tokens"]) == 0


# -- whole model, within 1e-4 -----------------------------------------------

@pytest.mark.parametrize("changes", [{}, {"attn_chunk": 8,
                                          "sliding_window": 12}],
                         ids=["dense", "chunked_window12"])
def test_forward(carried, changes):
    jparams, model, _ = carried
    jcfg, cfg = _cfgs(**changes)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 32)
                                             ).astype(np.int32)
    want_lg, want = japi.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got_lg, got = api.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    _close(got_lg, want_lg, MODEL_TOL)
    np.testing.assert_array_equal(got["expert_load"].numpy(),
                                  np.asarray(want["expert_load"]))
    assert got["expert_load"].dtype == torch.int32
    assert int(got["expert_load"].sum()) == 2 * 32 * cfg.topk * cfg.n_layers
    _close(got["aux_loss"], want["aux_loss"], MODEL_TOL)
    last, _ = api.forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                          last_only=True)
    torch.testing.assert_close(last[:, 0], got_lg[:, -1], **MODULE_TOL)


def test_modules_call_the_same_functions(carried):
    """model(tokens), block(x, ...) and attn(x, ...) are the functions of
    models/moe.py and models/layers.py on the module's own cfg."""
    _, model, cfg = carried
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(6))
    lg, aux = model(toks)
    want_lg, want = moe.forward(model, cfg, toks)
    assert torch.equal(lg, want_lg)
    assert torch.equal(aux["expert_load"], want["expert_load"])
    x = L.embed(model.embed, cfg, toks)
    positions = torch.arange(12)[None].expand(2, 12)
    assert torch.equal(model.blocks[0].attn(x, positions),
                       L.self_attention(model.blocks[0].attn, cfg, x,
                                        positions))
    y, stats = model.blocks[0](x, positions, moe.build_plan(cfg))
    y2, stats2 = moe.block_apply(model.blocks[0], cfg, moe.build_plan(cfg),
                                 x, positions)
    assert torch.equal(y, y2)
    assert torch.equal(stats["expert_load"], stats2["expert_load"])


def test_prefill_then_decode_steps_across_a_window(carried):
    """Prefill 3 tokens, then 6 greedy decode steps past a sliding window of
    4: logits and caches within 1e-4 and the same greedy tokens."""
    jparams, model, _ = carried
    jcfg, cfg = _cfgs(sliding_window=4)
    B, S, Smax = 2, 3, 12
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)
                                             ).astype(np.int32)
    jcache = japi.init_cache(jcfg, B, Smax, jnp.float32)
    cache = api.init_cache(cfg, B, Smax, torch.float32, device="cpu")
    want_lg, jcache = japi.prefill(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)}, jcache)
    got_lg, cache = api.prefill(model, cfg, {"tokens": torch.from_numpy(toks)},
                                cache)
    _close(got_lg, want_lg, MODEL_TOL)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], MODEL_TOL)
    jdecode = jax.jit(lambda p, c, t, pos: japi.decode_step(
        p, jcfg, c, {"tokens": t}, pos))
    nxt = np.argmax(np.asarray(want_lg)[:, -1], -1).astype(np.int32)
    assert np.array_equal(nxt, got_lg[:, -1].argmax(-1).numpy())
    for step in range(6):
        pos = np.full(B, S + step, np.int32)
        want_lg, jcache = jdecode(jparams, jcache, jnp.asarray(nxt[:, None]),
                                  jnp.asarray(pos))
        got_lg, cache = api.decode_step(model, cfg, cache,
                                        {"tokens": torch.from_numpy(nxt[:, None])},
                                        torch.from_numpy(pos))
        _close(got_lg, want_lg, MODEL_TOL)
        want_tok = np.argmax(np.asarray(want_lg)[:, -1], -1).astype(np.int32)
        np.testing.assert_array_equal(
            got_lg[:, -1].argmax(-1).numpy().astype(np.int32), want_tok)
        nxt = want_tok
    assert S + 5 >= cfg.sliding_window + 4
    for key in ("k", "v"):
        _close(cache[key], jcache[key], MODEL_TOL)


def test_padded_vocab():
    """vocab 500 pads to 512: the pad columns are NEG_INF on both sides."""
    jcfg, cfg = _cfgs(vocab=500)
    assert cfg.padded_vocab() == 512
    jparams = jinit_params(japi.layout(jcfg), jax.random.key(3), jnp.float32)
    model = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, 500, (2, 8)).astype(np.int32)
    want_lg, want = japi.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got_lg, got = api.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    _close(got_lg, want_lg, MODEL_TOL)
    assert (got_lg[..., 500:] == L.NEG_INF).all()
    assert np.all(np.asarray(want_lg)[..., 500:] == L.NEG_INF)
    np.testing.assert_array_equal(got["expert_load"].numpy(),
                                  np.asarray(want["expert_load"]))


def test_bf16_model_of_the_port_alone():
    """The working dtype: random bf16 parameters from a seeded generator;
    finite logits and loads that sum to B·S·K·L."""
    _, cfg = _cfgs(attn_chunk=8)
    model = api.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert model.embed.tok.dtype == torch.bfloat16
    toks = torch.randint(0, cfg.vocab, (3, 20),
                         generator=torch.Generator().manual_seed(1))
    lg, aux = api.forward(model, cfg, {"tokens": toks})
    assert lg.dtype == torch.float32 and lg.shape == (3, 20, 512)
    assert torch.isfinite(lg).all()
    assert int(aux["expert_load"].sum()) == 3 * 20 * 2 * cfg.n_layers
    model.use_kernels = False
    _, aux2 = api.forward(model, cfg, {"tokens": toks})
    assert torch.equal(aux["expert_load"], aux2["expert_load"])
    cache = api.init_cache(cfg, 3, 24, device="cpu")
    lg1, cache = api.prefill(model, cfg, {"tokens": toks}, cache)
    assert cache["k"].dtype == torch.bfloat16 and torch.isfinite(lg1).all()
    lg2, _ = api.decode_step(model, cfg, cache, {"tokens": toks[:, -1:]},
                             torch.full((3,), 20, dtype=torch.int32))
    assert torch.isfinite(lg2).all()
