"""The port's train step against the JAX package's: reduced qwen3-14b at
n_micro 1 and 2 (float32 states) and reduced mixtral-8x22b (8-bit
states), in float32, the JAX side on a 1 x 1 mesh.  The reference's
parameters and optimizer state are carried over (`params_from_jax`,
`opt_state_from_jax`) and both packages take the same batch for 3 steps
with a warmup of one step, so steps 2 and 3 update.

Tolerances: loss, zloss and grad_norm within rtol = 1e-5 (the two
frameworks sum the matrix products, softmaxes and the norm in other
orders, and the updates carry it on); lr_scale within 1e-7; expert_load
equal.  The reference's train-step tests (loss descends, the expert-load
metric) are mirrored on the port alone.
"""
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
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.train import build_train_step as jbuild_train_step
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train import build_train_step, loss_fn

TOL = dict(rel=1e-5)
B, S = 4, 16
STEPS = dict(total_steps=10, warmup_steps=1)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _jax_run(name, n_micro, bits, batch, n_steps):
    """JAX's per-step metrics, and its initial params and state (numpy)."""
    jcfg = JARCHS[name].reduced()
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    babs = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in batch}
    ocfg = JAdamWConfig(lr=1e-2, state_bits=bits)
    fns = jbuild_train_step(jcfg, mesh, babs, n_micro=n_micro, opt_cfg=ocfg,
                            donate=False, **STEPS)
    params = jinit_params(fns.layout, jax.random.key(0), jnp.float32)
    opt = jadamw.init(params, ocfg)
    start = jax.device_get((params, opt))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(n_steps):
        params, opt, m = fns.step(params, opt, jb)
        out.append(jax.device_get(m))
    return out, start, int(opt["step"])


@pytest.mark.parametrize("name,n_micro,bits", [
    ("qwen3-14b", 1, 32),
    ("qwen3-14b", 2, 32),
    ("mixtral-8x22b", 1, 8),
])
def test_train_step_matches_jax(name, n_micro, bits):
    cfg = ARCHS[name].reduced()
    batch = _batch(cfg, 1)
    want, (jparams, jopt), jstep = _jax_run(name, n_micro, bits, batch, 3)
    model = params_from_jax(jparams, cfg, device="cpu")
    opt = opt_state_from_jax(jopt, cfg, device="cpu")
    fns = build_train_step(cfg, AdamWConfig(lr=1e-2, state_bits=bits),
                           n_micro=n_micro, device="cpu", **STEPS)
    ops.reset_launches()
    for i, w in enumerate(want):
        model, opt, m = fns.step(model, opt, batch)
        for k in ("loss", "zloss", "grad_norm"):
            assert float(m[k]) == pytest.approx(float(w[k]), **TOL), (i, k)
        assert float(m["lr_scale"]) == pytest.approx(float(w["lr_scale"]),
                                                     abs=1e-7)
        assert set(m) == set(w)
        if cfg.family == "moe":
            assert m["expert_load"].dtype == torch.float32
            np.testing.assert_array_equal(m["expert_load"].numpy(),
                                          np.asarray(w["expert_load"]))
    assert float(want[0]["lr_scale"]) == 0.0       # taken before the increment
    assert int(opt["step"]) == jstep == 3
    assert all(v == 0 for v in ops.LAUNCHES.values())   # CPU: plain versions


@pytest.mark.parametrize("name,n_micro,bits", [
    ("qwen3-14b", 1, 32),
    ("qwen3-14b", 2, 32),
    ("mixtral-8x22b", 1, 8),
    ("qwen2-0.5b", 1, 32),
])
def test_train_step_runs_and_descends(name, n_micro, bits):
    cfg = ARCHS[name].reduced()
    fns = build_train_step(cfg, AdamWConfig(lr=1e-2, state_bits=bits),
                           n_micro=n_micro, device="cpu")
    model = api.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw.init(model.tree(), AdamWConfig(lr=1e-2, state_bits=bits))
    batch = _batch(cfg, 2)
    losses = []
    for _ in range(4):
        model, opt, metrics = fns.step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]          # same batch -> loss must descend
    assert int(opt["step"]) == 4
    assert model.blocks.attn.wq.dtype == torch.bfloat16
    assert all(p.grad is None for p in model.parameters())


def test_moe_expert_load_metric():
    cfg = ARCHS["mixtral-8x22b"].reduced()
    fns = build_train_step(cfg, device="cpu")
    model = api.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw.init(model.tree(), AdamWConfig())
    _, _, metrics = fns.step(model, opt, _batch(cfg, 3))
    load = metrics["expert_load"].numpy()
    assert load.shape == (cfg.n_experts,)
    assert load.sum() == B * S * cfg.topk * cfg.n_layers


def test_remat_full_gives_the_gradients_of_none():
    """Recomputing each layer in the backward pass changes no gradient
    (MoE, float32), and the stacked leaves' gradients land slice by slice;
    remat="dots" is refused."""
    cfg = ARCHS["mixtral-8x22b"].reduced()
    tree = None
    grads = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        model = api.init_model(c, torch.Generator().manual_seed(4),
                               device="cpu", dtype=torch.float32)
        model.requires_grad_(True)
        batch = {k: torch.from_numpy(v) for k, v in _batch(c, 4).items()}
        total, _ = loss_fn(model, c, batch)
        total.backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
        tree = model.tree()
    assert tree["blocks"]["moe"]["w1"].grad.shape[0] == cfg.n_layers
    for n, g in grads["none"].items():
        torch.testing.assert_close(grads["full"][n], g, atol=1e-6, rtol=1e-5)
    c = dataclasses.replace(cfg, remat="dots")
    model = api.init_model(c, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="dots"):
        api.forward(model, c, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_step_refuses_without_a_card(monkeypatch):
    from repro_torch.core.executor import ExecutorError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ExecutorError, match="CUDA"):
        build_train_step(ARCHS["qwen2-0.5b"].reduced())
