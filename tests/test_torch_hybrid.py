"""The port's hybrid family (`models/hybrid.py`, zamba2-7b) against the
JAX package, in float32 with random values in every leaf
(`_torch_family_cases`): the stock reduced config (2 layers at
attn_every 2: no group, the shared block never applied) and a 7-layer one
(two groups of two Mamba blocks with the shared block, one tail block).
Forward, prefill, decode past the shared block's ring, a train step, the
shared block's gradient gathered from both applications, remat "full"
against "none", and the serving engine token for token."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_cases import (MODEL_TOL, MODULE_TOL, SEVEN, batch,
                                 carried, cfgs, check_decode, check_forward,
                                 check_train_step, close)
from repro.launch.mesh import make_mesh_compat
from repro.models import api as japi
from repro.models import layers as JL
from repro.serve import ServingEngine as JaxEngine
from repro_torch.models import api, hybrid, layers as L
from repro_torch.serve import ServingEngine
from repro_torch.train import loss_fn

NAME = "zamba2-7b"
CONFIGS = {"stock": {}, "seven": SEVEN[NAME]}


@pytest.fixture(scope="module")
def models():
    return {k: carried(NAME, **v) for k, v in CONFIGS.items()}


@pytest.fixture(params=list(CONFIGS))
def model(request, models):
    return models[request.param]


def test_group_counts():
    _, cfg = cfgs(NAME)
    assert hybrid.group_counts(cfg) == (0, 2)
    seven = dataclasses.replace(cfg, **SEVEN[NAME])
    assert hybrid.group_counts(seven) == (2, 1)


def test_decode_attention_ring(models):
    """The shared block's one-token decode against a ring of 6 slots: the
    slot pos % 6 written, the reference's kv_valid mask (slots <= pos
    before the wrap, all after), bf16 ring against f32 queries."""
    jcfg, cfg, jparams, tmodel = models["seven"]
    rng = np.random.default_rng(9)
    B, W = 3, 6
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, W, cfg.n_kv_heads, cfg.hd())
                             ).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    pos = np.array([2, 6, 13], np.int32)
    ring = pos % W
    valid = (np.arange(W)[None] <= pos[:, None]) | (pos[:, None] >= W)
    want = JL.decode_attention(
        jparams["shared_attn"], jcfg, jnp.asarray(x),
        jnp.asarray(ck).astype(jnp.bfloat16),
        jnp.asarray(cv).astype(jnp.bfloat16), jnp.asarray(pos),
        write_pos=jnp.asarray(ring), kv_valid=jnp.asarray(valid))
    got = L.decode_attention(
        tmodel.shared_attn, cfg, torch.from_numpy(x),
        torch.from_numpy(ck).to(torch.bfloat16),
        torch.from_numpy(cv).to(torch.bfloat16), torch.from_numpy(pos),
        write_pos=torch.from_numpy(ring), kv_valid=torch.from_numpy(valid))
    close(got[0], want[0], MODULE_TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.bfloat16
        close(g.float(), np.asarray(w.astype(jnp.float32)), MODULE_TOL)


def test_forward(model):
    check_forward(*model)


def test_prefill_returns_the_cache(model):
    jcfg, cfg, jparams, tmodel = model
    b = batch(cfg, 2, 12, 5)
    cache = api.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    lg, out = api.prefill(tmodel, cfg, {"tokens": torch.from_numpy(
        b["tokens"])}, cache)
    want, _ = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(b["tokens"])},
                           japi.init_cache(jcfg, 2, 16, jnp.float32))
    close(lg, want, MODEL_TOL)
    assert out is cache


def test_decode_past_the_ring(model):
    """max_seq 6 makes the shared block's ring 6 slots (under the reduced
    window of 64); 10 steps wrap it."""
    jcfg, cfg, jparams, tmodel = model
    cache = check_decode(jcfg, cfg, jparams, tmodel, B=2, Smax=6, steps=10)
    n_groups, tail = hybrid.group_counts(cfg)
    assert cache["attn_k"].shape[:3] == (n_groups, 2, 6)
    assert (cache["tail"] is None) == (tail == 0)


def test_train_step():
    check_train_step(NAME, SEVEN[NAME])


def test_shared_block_gathers_both_applications_and_remat_changes_nothing():
    """The shared block is applied twice: its gradient is the sum over
    both (nonzero, one leaf); the stacked Mamba leaves get theirs slice by
    slice.  Remat "full" (nested: each Mamba block inside its group, then
    the group) gives the gradients of "none"."""
    grads = {}
    for remat in ("none", "full"):
        _, cfg, _, tmodel = carried(NAME, remat=remat, **SEVEN[NAME])
        tmodel.requires_grad_(True)
        b = {k: torch.from_numpy(v) for k, v in batch(cfg, 2, 20, 6).items()}
        total, _ = loss_fn(tmodel, cfg, b)
        total.backward()
        grads[remat] = {n: p.grad.clone() for n, p in
                        tmodel.named_parameters()}
    g = grads["full"]
    assert g["mamba_blocks.in_proj"].shape[0] == 4
    assert all(bool(g["mamba_blocks.in_proj"][i].abs().sum() > 0)
               for i in range(4))
    assert bool(g["shared_attn.wq"].abs().sum() > 0)
    for n, want in grads["none"].items():
        torch.testing.assert_close(g[n], want, atol=1e-6, rtol=1e-5)


def test_serving_engine_matches_the_jax_engine(models, monkeypatch):
    """The 7-layer model: five requests on two slots with max_seq 12
    (requests reuse slots, so the nested reset runs); tokens equal the JAX
    engine's (1 x 1 mesh).  Both engines' caches are float32 here: in the
    engines' bf16 the frameworks' ~1e-6 differences round to a bf16 ulp,
    logits then differ by up to 6e-4, and request 2's last token is a
    greedy near-tie (margin 2.2e-4) that flips."""
    import repro.models.api as japi_mod
    import repro_torch.models.api as api_mod
    jinit, tinit = japi_mod.init_cache, api_mod.init_cache
    monkeypatch.setattr(japi_mod, "init_cache", lambda *a, **kw: jinit(
        *a, **{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(api_mod, "init_cache", lambda *a, **kw: tinit(
        *a, **{**kw, "dtype": torch.float32}))
    jcfg, cfg, jparams, tmodel = models["seven"]
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, n).tolist(), m)
            for n, m in ((5, 6), (3, 8), (7, 4), (2, 9), (4, 5))]
    jeng = JaxEngine(jcfg, make_mesh_compat((1, 1), ("data", "model")), 2,
                     12, jparams)
    jr = [jeng.submit(p, m) for p, m in reqs]
    jeng.run()
    eng = ServingEngine(cfg, 2, 12, tmodel, device="cpu")
    tr = [eng.submit(p, m) for p, m in reqs]
    eng.run()
    assert [r.out for r in tr] == [r.out for r in jr]
    assert [len(r.out) for r in tr] == [m for _, m in reqs]
    assert eng.ticks == jeng.ticks
    assert eng.cache["mamba"]["conv"].dtype == torch.float32
