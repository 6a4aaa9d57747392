"""The port's train step against the JAX package's: reduced qwen3-14b at
n_micro 1 and 2 (float32 states) and reduced mixtral-8x22b (8-bit
states), in float32, the JAX side on a 1 x 1 mesh.  The reference's
parameters and optimizer state are carried over (`params_from_jax`,
`opt_state_from_jax`) and both packages take the same batch for 3 steps
with a warmup of one step, so steps 2 and 3 update.

Tolerances: loss, zloss and grad_norm within rtol = 1e-5 (the two
frameworks sum the matrix products, softmaxes and the norm in other
orders, and the updates carry it on); lr_scale within 1e-7; expert_load
equal.

The 8-bit case takes each step from the reference's parameters and state
of that step: the two frameworks' gradients differ in their last bits (up
to ~1e-4 relative on the rows of experts few tokens reach, whose gradients
are ~1e-8), so an int8 code at a rounding tie may round the other way,
a jump of one quantization step that Adam's normalisation carries into
the next step's loss.  Chained, the steps then part by more than 1e-5 on
one host and not on another; carried, each step's metrics hold at 1e-5,
and its states are held to the reference's: every code within one, every
scale within 1e-3 relative (the gradients' agreement on those rows, with
margin).  `test_8bit_update_equals_the_reference_given_the_same_inputs`
holds the update itself bit for bit.  The reference's train-step tests (loss descends, the expert-load
metric) are mirrored on the port alone, and so is what a captured step
needs of the eager one: it replaces no tensor it was given, and the
capture helper's binding changes exactly when one is replaced.
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
from repro_torch.tree import flatten

TOL = dict(rel=1e-5)
B, S = 4, 16
STEPS = dict(total_steps=10, warmup_steps=1)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _jax_run(name, n_micro, bits, batch, n_steps):
    """JAX's per-step metrics, its params and state (numpy) before each
    step, and its step counter at the end."""
    jcfg = JARCHS[name].reduced()
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    babs = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in batch}
    ocfg = JAdamWConfig(lr=1e-2, state_bits=bits)
    fns = jbuild_train_step(jcfg, mesh, babs, n_micro=n_micro, opt_cfg=ocfg,
                            donate=False, **STEPS)
    params = jinit_params(fns.layout, jax.random.key(0), jnp.float32)
    opt = jadamw.init(params, ocfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out, before = [], []
    for _ in range(n_steps):
        before.append(jax.device_get((params, opt)))
        params, opt, m = fns.step(params, opt, jb)
        out.append(jax.device_get(m))
    return out, before + [jax.device_get((params, opt))], int(opt["step"])


@pytest.mark.parametrize("name,n_micro,bits", [
    ("qwen3-14b", 1, 32),
    ("qwen3-14b", 2, 32),
    ("mixtral-8x22b", 1, 8),
])
def test_train_step_matches_jax(name, n_micro, bits):
    """Float32 states: 3 chained steps from the reference's start.  8-bit
    states: each step from the reference's parameters and state of that
    step, its states after it held to the reference's (module docstring)."""
    cfg = ARCHS[name].reduced()
    batch = _batch(cfg, 1)
    want, jstates, jstep = _jax_run(name, n_micro, bits, batch, 3)
    model = params_from_jax(jstates[0][0], cfg, device="cpu")
    opt = opt_state_from_jax(jstates[0][1], cfg, device="cpu")
    fns = build_train_step(cfg, AdamWConfig(lr=1e-2, state_bits=bits),
                           n_micro=n_micro, device="cpu", **STEPS)
    ops.reset_launches()
    for i, w in enumerate(want):
        if bits == 8:
            model = params_from_jax(jstates[i][0], cfg, device="cpu")
            opt = opt_state_from_jax(jstates[i][1], cfg, device="cpu")
        model, opt, m = fns.step(model, opt, batch)
        if bits == 8:
            _assert_8bit_states_near(opt, jstates[i + 1][1])
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


def _numpy_leaves(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": numpy array}."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_numpy_leaves(v, f"{prefix}{k}/"))
    return out


def _assert_8bit_states_near(opt, jopt):
    """The port's 8-bit states against the reference's after one step from
    the same state: every code within one, every scale within 1e-3."""
    got = {k: v.numpy() for k, v in flatten(opt).items()}
    want = _numpy_leaves(jopt)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k.endswith("_q"):
            assert np.abs(got[k].astype(np.int32) - w).max() <= 1, k
        elif k.endswith("_s"):
            np.testing.assert_allclose(got[k], w, rtol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Float32 ulps between a and b (both positive)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_8bit_update_equals_the_reference_given_the_same_inputs(monkeypatch):
    """The port's 8-bit `adamw.apply` and the reference's, given the same
    parameters (reduced mixtral, float32), the same nonzero 8-bit states
    (two earlier reference steps) and the same gradients, whose norm is
    below grad_clip (so both clip by exactly 1 and no norm's summation
    order enters): equal bit for bit, every parameter, code and scale, to
    the reference run op by op (`jax.disable_jit`).  Jitted, XLA's CPU
    backend fuses `b1 * m + (1 - b1) * g` into one multiply-add, whose m
    is an ulp off the op-by-op one; against that every scale is within two
    ulps (an ulp of the row's largest |m|, divided by 127, may cross into
    the scale's lower binade) and a code differs by at most one, and only
    where the port's unrounded value lies at a tie (|x| / scale within 8
    ulps of k + 1/2: an ulp of x and two of the scale, with margin)."""
    cfg = ARCHS["mixtral-8x22b"].reduced()
    jcfg = JARCHS["mixtral-8x22b"].reduced()
    ocfg = JAdamWConfig(lr=1e-2, state_bits=8)
    params = jinit_params(japi.layout(jcfg), jax.random.key(0), jnp.float32)
    rng = np.random.default_rng(0)

    def grads():
        return jax.tree.map(lambda p: jnp.asarray(
            (rng.standard_normal(p.shape) * 1e-5).astype(np.float32)), params)

    japply = jax.jit(lambda p, s, g: jadamw.apply(p, s, g, ocfg))
    state = jadamw.init(params, ocfg)
    for _ in range(2):
        params, state, _ = japply(params, state, grads())
    g = grads()
    start = jax.device_get((params, state))
    with jax.disable_jit():
        op_p, op_s, op_m = jadamw.apply(*start, g, ocfg)
    jit_p, jit_s, _ = japply(*start, g)

    model = params_from_jax(start[0], cfg, device="cpu")
    opt = opt_state_from_jax(start[1], cfg, device="cpu")
    tg = params_from_jax(jax.device_get(g), cfg, device="cpu").tree()
    unrounded = []
    q8 = adamw._q8

    def kept(x):
        unrounded.append(x.clone())
        return q8(x)

    monkeypatch.setattr(adamw, "_q8", kept)
    _, _, m = adamw.apply(model.tree(), opt, tg,
                          AdamWConfig(lr=1e-2, state_bits=8))
    assert float(m["grad_norm"]) < 1.0
    assert float(m["grad_norm"]) == pytest.approx(float(op_m["grad_norm"]),
                                                  rel=1e-5)

    got_p = {k: v.numpy() for k, v in flatten(model.tree()).items()}
    got = {k: v.numpy() for k, v in flatten(opt).items()}
    for k, w in _numpy_leaves(jax.device_get(op_p)).items():
        np.testing.assert_array_equal(got_p[k], w, err_msg=k)
    for k, w in _numpy_leaves(jax.device_get(op_s)).items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)

    # One slice a leaf at this size: `_q8` saw m, then sqrt(v), a leaf.
    assert len(unrounded) == 2 * len(got_p)
    xs = dict(zip([f"mu/{k}/{f}" for k in got_p for f in ("m", "v")],
                  unrounded))
    want = _numpy_leaves(jax.device_get(jit_s))
    for k in got_p:
        for f in ("m", "v"):
            q, s = got[f"mu/{k}/{f}_q"], got[f"mu/{k}/{f}_s"]
            wq, ws = want[f"mu/{k}/{f}_q"], want[f"mu/{k}/{f}_s"]
            assert _ulps(s, ws).max() <= 2, (k, f)
            d = q.astype(np.int32) - wq
            assert np.abs(d).max() <= 1, (k, f)
            x = xs[f"mu/{k}/{f}"].numpy().reshape(q.shape)
            r = np.abs(x.astype(np.float64)) / s.astype(np.float64)
            tie = np.abs(r - np.floor(r) - 0.5) <= 8 * 2.0 ** -24 * r
            assert tie[d != 0].all(), (k, f)
    assert int(opt["step"]) == int(op_s["step"]) == 3


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


def _tensors(model, opt):
    """Every parameter and optimizer-state tensor, by path: (object,
    address)."""
    leaves = {**{f"params/{k}": v for k, v in flatten(model.tree()).items()},
              **{f"opt/{k}": v for k, v in flatten(opt).items()}}
    return {k: (v, v.data_ptr()) for k, v in leaves.items()}


@pytest.mark.parametrize("name,n_micro,bits", [
    ("qwen2-0.5b", 2, 32),
    ("mixtral-8x22b", 1, 8),
])
def test_step_replaces_no_tensor_it_was_given(name, n_micro, bits):
    """After each step every parameter and state tensor, `opt["step"]`
    too, is the same object at the same address (a captured step reads
    them there), and the counter advanced in place."""
    cfg = ARCHS[name].reduced()
    ocfg = AdamWConfig(lr=1e-2, state_bits=bits)
    fns = build_train_step(cfg, ocfg, n_micro=n_micro, device="cpu")
    model = api.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw.init(model.tree(), ocfg)
    before = _tensors(model, opt)
    counter = opt["step"]
    for i in range(2):
        model2, opt2, _ = fns.step(model, opt, _batch(cfg, 5))
        assert model2 is model and opt2 is opt
        after = _tensors(model, opt)
        assert after.keys() == before.keys()
        for k, (t, ptr) in before.items():
            assert after[k][0] is t and after[k][1] == ptr, k
        assert opt["step"] is counter and int(counter) == i + 1
    assert fns.compiled.eager_calls == 2 and fns.compiled.captures == 0


def test_binding_changes_when_a_bound_tensor_is_replaced(tmp_path):
    """The capture helper's binding of (model, optimizer state, batch keys)
    is unchanged by a step and changes when a tensor is replaced: the
    state's counter, a parameter, or the whole model and state restored
    from a checkpoint (new tensors of the same values)."""
    from repro_torch.ckpt import Checkpointer
    from repro_torch.graph import binding
    cfg = ARCHS["qwen2-0.5b"].reduced()
    ocfg = AdamWConfig(lr=1e-2)
    fns = build_train_step(cfg, ocfg, device="cpu")
    model = api.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw.init(model.tree(), ocfg)
    keys = ("tokens", "labels")
    key = binding((model, opt, keys))
    fns.step(model, opt, _batch(cfg, 6))
    assert binding((model, opt, keys)) == key
    assert binding((model, opt, ("labels", "tokens"))) != key
    opt["step"] = opt["step"] + 0
    assert binding((model, opt, keys)) != key
    key = binding((model, opt, keys))
    wq = model.blocks.attn.wq
    wq.data = wq.data.clone()
    assert binding((model, opt, keys)) != key
    key = binding((model, opt, keys))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": model.tree(), "opt": opt}, blocking=True)
    state = ck.restore(1, {"params": fns.params_abstract,
                           "opt": fns.opt_abstract}, "cpu")
    restored = api.build(cfg, state["params"])
    assert binding((restored, state["opt"], keys)) != key
    for a, b in zip(restored.parameters(), model.parameters()):
        assert torch.equal(a, b)
