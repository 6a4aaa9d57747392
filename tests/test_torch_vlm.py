"""The port's VLM family (`models/vlm.py`, llama-3.2-vision-90b) against
the JAX package, in float32 with random values in every leaf, the gate
included (`_torch_family_cases`): the stock reduced config (2 layers at
cross_attn_every 2: no group, no cross-attention) and a 7-layer one (two
groups of two self-attention blocks and a gated cross-attention block,
one tail block).  The gated cross-attention block, the forward, prefill
(the vision tokens into the cache) then decode, a train step, and remat
"full" against "none".  (The driver's stub `vision_emb` is held against
the reference driver's in test_torch_pipeline_and_driver.py.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_cases import (MODULE_TOL, SEVEN, batch, carried, cfgs,
                                 check_decode, check_forward,
                                 check_train_step, close)
from repro.models import vlm as JV
from repro_torch.models import vlm as V
from repro_torch.train import loss_fn

NAME = "llama-3.2-vision-90b"
CONFIGS = {"stock": {}, "seven": SEVEN[NAME]}


@pytest.fixture(scope="module")
def models():
    return {k: carried(NAME, **v) for k, v in CONFIGS.items()}


@pytest.fixture(params=list(CONFIGS))
def model(request, models):
    return models[request.param]


def test_group_counts():
    _, cfg = cfgs(NAME)
    assert V.group_counts(cfg) == (0, 2)
    assert V.group_counts(dataclasses.replace(cfg, **SEVEN[NAME])) == (2, 1)


def test_gated_cross_attention_block(models):
    """`_apply_ca` (x + gate·(h − x), then the MLP) of group 1's block on
    projected vision tokens; a zero gate makes the cross-attention the
    identity."""
    jcfg, cfg, jparams, model = models["seven"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    emb = rng.standard_normal((2, cfg.vision_tokens, cfg.vision_dim)
                              ).astype(np.float32)
    vis = V._project(model, torch.from_numpy(emb))
    jvis = jnp.asarray(emb) @ jparams["vision_proj"]
    close(vis, jvis, MODULE_TOL)
    jp = jax.tree.map(lambda a: a[1], jparams["ca_blocks"])
    got = V._apply_ca(model.ca_blocks[1], cfg, torch.from_numpy(x), vis)
    close(got, JV._apply_ca(jp, jcfg, jnp.asarray(x), jvis, JV.NO_SHARD),
          MODULE_TOL)
    ca = dict(model.ca_blocks[1].__dict__["_tensors"])
    ca["gate"] = torch.zeros(1)
    plain = V.L.swiglu(ca["mlp"], torch.from_numpy(x))
    torch.testing.assert_close(V._apply_ca(ca, cfg, torch.from_numpy(x), vis),
                               plain)


def test_forward(model):
    check_forward(*model)


def test_prefill_then_decode(model):
    """Prefill of 8 tokens sets the cache's vision tokens (the reference's
    simplified prefill fills no KV); then 6 decode steps across them."""
    jcfg, cfg, jparams, tmodel = model
    cache = check_decode(jcfg, cfg, jparams, tmodel, B=2, Smax=16, steps=6,
                         prompt=8)
    assert bool(cache["vis"].abs().sum() > 0)


def test_train_step():
    check_train_step(NAME, SEVEN[NAME])


def test_remat_full_gives_the_gradients_of_none():
    """The group recomputed as one piece with each self-attention block
    recomputed inside it: the gradients of "none"; the gate's is
    nonzero."""
    grads = {}
    for remat in ("none", "full"):
        _, cfg, _, tmodel = carried(NAME, remat=remat, **SEVEN[NAME])
        tmodel.requires_grad_(True)
        b = {k: torch.from_numpy(v) for k, v in batch(cfg, 2, 16, 6).items()}
        total, _ = loss_fn(tmodel, cfg, b)
        total.backward()
        grads[remat] = {n: p.grad.clone() for n, p in
                        tmodel.named_parameters()}
    assert bool(grads["full"]["ca_blocks.gate"].abs().gt(0).all())
    assert bool(grads["full"]["vision_proj"].abs().sum() > 0)
    for n, want in grads["none"].items():
        torch.testing.assert_close(grads["full"][n], want, atol=1e-6,
                                   rtol=1e-5)

