"""Shared cases of the family comparison tests (tests/test_torch_ssm.py,
test_torch_hybrid.py, test_torch_encdec.py, test_torch_vlm.py,
test_torch_archs.py): the reference's parameters in float32 with random
values in every leaf, carried over to the port by `params_from_jax`, the
configs that reach the blocks the stock reduced ones skip, and the
comparisons of a train step, a decode run and the training driver against
the JAX package.

Tolerances (as `test_torch_dense.py`'s): float32 atol = rtol = 1e-5 per
module and 1e-4 per model (the two frameworks sum matrix products, scans
and softmaxes in other orders, and the differences grow over the layers);
train-step metrics within rtol 1e-5.
"""
import dataclasses
import sys

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
from repro_torch.models import api
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.train import build_train_step

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(rel=1e-5)
# Configs that reach the blocks the stock reduced ones skip: zamba2 with
# two groups (shared block applied twice) and a tail, the vision model
# with two cross-attention groups and a tail.
SEVEN = {"zamba2-7b": dict(n_layers=7, attn_every=2),
         "llama-3.2-vision-90b": dict(n_layers=7, cross_attn_every=2)}


def cfgs(name, **changes):
    """(JAX cfg, port cfg): the reduced config with the same changes."""
    return (dataclasses.replace(JARCHS[name].reduced(), **changes),
            dataclasses.replace(ARCHS[name].reduced(), **changes))


def _leaf_values(path, a, rng):
    """Random values of a leaf's own scale: the layout's init plus noise,
    and for the SSM's and the vision gate's leaves values that move
    them off their zeros / ones init (A between -2.7 and -0.14, dt_bias
    about softplus's knee, D around 1, the gate in (0.3, 0.9))."""
    name = path[-1]
    if name == "A_log":
        return rng.uniform(-2.0, 1.0, a.shape)
    if name == "dt_bias":
        return rng.uniform(-1.0, 1.0, a.shape)
    if name == "D":
        return rng.uniform(0.5, 1.5, a.shape)
    if name == "gate":
        return rng.uniform(0.3, 0.9, a.shape)
    if name == "conv_b":
        return 0.1 * rng.standard_normal(a.shape)
    return np.asarray(a) + 0.05 * rng.standard_normal(a.shape)


def random_params(jcfg, seed=0):
    """The reference's float32 parameters (numpy) with random values in
    every leaf."""
    jp = jax.device_get(jinit_params(japi.layout(jcfg), jax.random.key(seed),
                                     jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: _leaf_values([k.key for k in path], a, rng
                                     ).astype(np.float32), jp)


def carried(name, seed=0, **changes):
    """(JAX cfg, port cfg, JAX params (jnp), port model on the CPU)."""
    jcfg, cfg = cfgs(name, **changes)
    jp = random_params(jcfg, seed)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, jp),
            params_from_jax(jp, cfg, device="cpu"))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def close_tree(got, want, tol):
    """Every leaf of a (nested) cache, None where the reference holds
    None."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close_tree(got[k], want[k], tol)
    elif want is None:
        assert got is None
    else:
        assert tuple(got.shape) == tuple(want.shape)
        close(got, want, tol)


def batch(cfg, B, S, seed, frontend_dtype=np.float32):
    """numpy tokens, labels and the family's stub frontend input."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, max(S // cfg.enc_ratio, 1), cfg.d_model)).astype(frontend_dtype)
    if cfg.family == "vlm":
        out["vision_emb"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(frontend_dtype)
    return out


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def check_forward(jcfg, cfg, jparams, model, B=2, S=24, seed=3):
    """Forward logits within MODEL_TOL of the reference's; last_only and
    the model's own call agree with it."""
    b = batch(cfg, B, S, seed)
    want, waux = japi.forward(jparams, jcfg, as_jax(b))
    got, aux = api.forward(model, cfg, as_torch(b))
    assert aux == waux == {}
    assert got.shape == (B, S, cfg.padded_vocab())
    close(got, want, MODEL_TOL)
    last, _ = api.forward(model, cfg, as_torch(b), last_only=True)
    torch.testing.assert_close(last[:, 0], got[:, -1], **MODULE_TOL)
    return got


def check_decode(jcfg, cfg, jparams, model, B, Smax, steps, prompt=0,
                 seed=4):
    """`prompt` tokens prefilled (none: a zeroed cache), then `steps`
    greedy decode steps in both packages: logits and caches within
    MODEL_TOL, the same greedy tokens, the cache's keys, shapes and dtypes
    kept.  Returns the port's cache."""
    rng = np.random.default_rng(seed)
    jcache = japi.init_cache(jcfg, B, Smax, jnp.float32)
    cache = api.init_cache(cfg, B, Smax, torch.float32, device="cpu")
    if prompt:
        b = batch(cfg, B, prompt, seed)
        del b["labels"]
        want, jcache = japi.prefill(jparams, jcfg, as_jax(b), jcache)
        got, cache = api.prefill(model, cfg, as_torch(b), cache)
        close(got, want, MODEL_TOL)
        close_tree(cache, jcache, MODEL_TOL)
        tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
        assert np.array_equal(got[:, -1].argmax(-1).numpy(), tok)
    else:
        tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
    shapes = {k: None if v is None else (tuple(v.shape), v.dtype)
              for k, v in _flat(cache).items()}
    jdecode = jax_decode(jcfg, jparams)
    for t in range(steps):
        pos = np.full(B, prompt + t, np.int32)
        want, jcache = jdecode(jcache, jnp.asarray(tok[:, None]),
                               jnp.asarray(pos))
        got, cache = api.decode_step(model, cfg, cache,
                                     {"tokens": torch.from_numpy(tok[:, None])},
                                     torch.from_numpy(pos))
        close(got, want, MODEL_TOL)
        nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
        assert np.array_equal(got[:, -1].argmax(-1).numpy(), nxt)
        tok = nxt
    close_tree(cache, jcache, MODEL_TOL)
    assert {k: None if v is None else (tuple(v.shape), v.dtype)
            for k, v in _flat(cache).items()} == shapes
    return cache


def jax_decode(jcfg, jparams):
    """The reference's decode step, jitted once (its eager scans compile
    again at every call)."""
    step = jax.jit(lambda p, c, t, pos: japi.decode_step(
        p, jcfg, c, {"tokens": t}, pos))
    return lambda c, t, pos: step(jparams, c, t, pos)


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def check_train_step(name, changes=None, B=2, S=24, bits=32, seed=5):
    """One `StepFns.step` of the port against the JAX package's on a 1 x 1
    mesh, from the same random parameters and state: loss, zloss and
    grad_norm within rtol 1e-5, lr_scale within 1e-7, step 1 both."""
    jcfg, cfg = cfgs(name, **(changes or {}))
    b = batch(cfg, B, S, seed)
    babs = {k: jax.ShapeDtypeStruct(v.shape, jnp.asarray(v).dtype)
            for k, v in b.items()}
    kw = dict(total_steps=10, warmup_steps=0)
    fns = jbuild_train_step(jcfg, make_mesh_compat((1, 1), ("data", "model")),
                            babs, opt_cfg=JAdamWConfig(lr=1e-2,
                                                       state_bits=bits),
                            donate=False, **kw)
    jp = random_params(jcfg, seed)
    jopt = jax.device_get(jadamw.init(jp, JAdamWConfig(state_bits=bits)))
    model = params_from_jax(jp, cfg, device="cpu")
    opt = opt_state_from_jax(jopt, cfg, device="cpu")
    _, jopt2, want = fns.step(jax.tree.map(jnp.asarray, jp),
                              jax.tree.map(jnp.asarray, jopt), as_jax(b))
    tfns = build_train_step(cfg, AdamWConfig(lr=1e-2, state_bits=bits),
                            device="cpu", **kw)
    model, opt, got = tfns.step(model, opt, b)
    assert set(got) == set(want)
    for k in ("loss", "zloss", "grad_norm"):
        assert float(got[k]) == pytest.approx(float(want[k]), **STEP_TOL), k
    assert float(got["lr_scale"]) == pytest.approx(float(want["lr_scale"]),
                                                   abs=1e-7)
    assert int(opt["step"]) == int(jopt2["step"]) == 1
    assert all(p.grad is None for p in model.parameters())
    return got


def driver_losses(out: str) -> list[float]:
    return [float(line.split("loss")[1].split()[0])
            for line in out.splitlines() if line.startswith("step ")]


def check_driver(name, tmp_path, capsys, monkeypatch, changes=None,
                 steps=2, batch_size=2, seq=16):
    """The port's driver against the reference's on the reduced config
    (with `changes`, through each driver's `get`), both from the
    reference's step-0 parameters and state (`init_params(key(0))`, the
    reference driver's own): the port resumes from a step-0 checkpoint of
    them in the reference's format.  Both draw the stub frontend from a
    fresh `default_rng(0)` at step 0.  The batches' arrays are equal
    (frames / vision_emb bit for bit in bf16); the bf16 losses agree
    within rtol 1e-3 (the frameworks round bf16 intermediates in other
    places; 5e-5 apart in the runs that set it)."""
    import repro.launch.train as jtrain
    import repro_torch.launch.train as ttrain
    from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
    from repro.data import PipelineConfig as JPipelineConfig
    from repro.data import TokenPipeline as JTokenPipeline
    from repro_torch.data import PipelineConfig, TokenPipeline

    jcfg, cfg = cfgs(name, **(changes or {}))
    monkeypatch.setattr(jtrain, "get", lambda _: jcfg)
    monkeypatch.setattr(ttrain, "get", lambda _: cfg)
    args = ["--arch", name, "--steps", str(steps), "--batch",
            str(batch_size), "--seq", str(seq), "--log-every", "1",
            "--lr", "1e-2"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"

    # The batches: the reference driver's make_batch against the port's.
    jfns_abs = {"tokens": jax.ShapeDtypeStruct((batch_size, seq), jnp.int32),
                "labels": jax.ShapeDtypeStruct((batch_size, seq), jnp.int32)}
    jfns_abs.update({k: jax.ShapeDtypeStruct(s, jnp.bfloat16) for k, s in
                     ttrain.frontend_shapes(cfg, batch_size, seq).items()})
    jpipe = JTokenPipeline(JPipelineConfig(jcfg.vocab, seq, batch_size))
    tpipe = TokenPipeline(PipelineConfig(cfg.vocab, seq, batch_size))
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for step in range(steps):
        jb = jtrain.make_batch(jcfg, jpipe, step, jfns_abs, jrng)
        tb = ttrain.make_batch(cfg, tpipe, step, trng, "cpu")
        assert set(tb) == set(jb)
        for k, v in jb.items():
            assert tb[k].dtype == (torch.bfloat16 if v.dtype == jnp.bfloat16
                                   else torch.int32)
            np.testing.assert_array_equal(
                tb[k].view(torch.int16).numpy() if v.dtype == jnp.bfloat16
                else tb[k].numpy(),
                np.asarray(v).view(np.int16) if v.dtype == jnp.bfloat16
                else np.asarray(v))

    # The reference driver from init_params(key(0)); its step-0 state
    # saved for the port.
    jparams = jinit_params(japi.layout(jcfg), jax.random.key(0))
    jopt = jadamw.init(jparams, JAdamWConfig(lr=1e-2))
    ck = JCheckpointer(str(tdir))
    ck.save(0, {"params": jparams, "opt": jopt}, blocking=True)
    monkeypatch.setattr(sys, "argv", ["train"] + args +
                        ["--ckpt-dir", str(jdir)])
    jtrain.main()
    want = driver_losses(capsys.readouterr().out)
    ttrain.main(args + ["--ckpt-dir", str(tdir), "--resume",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 0" in out
    got = driver_losses(out)
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=1e-3)
    return got
