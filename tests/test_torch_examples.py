"""The port's examples (examples/torch_port/) on the CPU at their own
sizes: each join example's rows equal the JAX package's `reference_join`
on the same data, as the JAX examples check themselves against it; the
serving example's greedy tokens equal JAX's `build_decode_step` on the
same parameters; the MoE dispatch example's plans, costs, expert loads
and hot-expert split equal the JAX functions' on the same inputs; the
training example's losses equal the JAX example's over its first steps."""
import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core import canonical as jax_canonical
from repro.core import moe_shares as jms
from repro.core import reference_join as jax_reference_join
from repro.core import running_example as jax_running_example
from repro.core import two_way as jax_two_way
from repro.launch.mesh import make_mesh_compat
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models.common import init_params as jinit_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.serve import build_decode_step as jax_build_decode_step
from repro_torch.configs import ARCHS
from repro_torch.models.convert import params_from_jax

from _torch_family_cases import driver_losses

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch_port"


def _load(name, where=EXAMPLES):
    spec = importlib.util.spec_from_file_location(
        f"{where.name}_{name}", where / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,query", [
    ("skewed_join_demo", jax_running_example),
    ("quickstart", jax_two_way)])
def test_example_rows_equal_jax_reference_join(name, query, capsys):
    data, rows = _load(name).main(device="cpu")
    out = capsys.readouterr().out
    assert "exact match" in out and "compile_count=1" in out
    np.testing.assert_array_equal(jax_canonical(rows),
                                  jax_reference_join(query(), data))


def test_serve_decode_tokens_equal_jax_build_decode_step():
    """The JAX package's float32 parameters carried over: the example's
    prompts fed and 32 tokens decoded greedily, token for token the JAX
    step's (on a 1 x 1 mesh, with the example's bf16 cache)."""
    ex = _load("serve_decode")
    jcfg = JARCHS["qwen2-0.5b"].reduced()
    jparams = jinit_params(japi.layout(jcfg), jax.random.key(0), jnp.float32)
    model = params_from_jax(jax.device_get(jparams),
                            ARCHS["qwen2-0.5b"].reduced(), device="cpu")
    prompts, gen = ex.main(device="cpu", model=model)
    fns = jax_build_decode_step(jcfg, make_mesh_compat((1, 1),
                                                       ("data", "model")),
                                batch=ex.B, max_seq=ex.MAX_SEQ)
    params = jax.device_put(jparams, fns.param_shardings)
    cache = jax.device_put(japi.init_cache(jcfg, ex.B, ex.MAX_SEQ),
                           fns.cache_shardings)
    tok, out = jnp.asarray(prompts[:, :1]), []
    for t in range(ex.PROMPT + ex.GEN):          # as the JAX example runs
        pos = jnp.full((ex.B,), t, jnp.int32)
        if t < ex.PROMPT:
            tok = jnp.asarray(prompts[:, t:t + 1])
        nxt, cache = fns.decode(params, cache, tok, pos)
        if t >= ex.PROMPT:
            out.append(np.asarray(nxt))
        tok = nxt[:, None]
    np.testing.assert_array_equal(gen, np.stack(out, axis=1))


def test_moe_skew_dispatch_equals_jax():
    """The example's layer on the same float32 parameters and input (N(0,
    0.02) weights, a unit norm, from numpy) as JAX's `moe_ffn`: both plans
    field for field, their dispatch costs, the expert loads and dropped
    tokens, and the hot expert's split by `route_tokens`."""
    ex = _load("moe_skew_dispatch")
    cfg = ex.config()
    jcfg = dataclasses.replace(JARCHS["mixtral-8x22b"].reduced(),
                               n_layers=1, moe_slot_factor=1.5)
    rng = np.random.default_rng(2)
    p = {k: (np.ones(pd.shape, np.float32) if k == "norm" else
             0.02 * rng.standard_normal(pd.shape).astype(np.float32))
         for k, pd in jmoe.moe_layout(jcfg).items()}
    x = rng.standard_normal((4, 64, cfg.d_model)).astype(np.float32)
    got = ex.main(device="cpu",
                  params={k: torch.from_numpy(v) for k, v in p.items()},
                  x=torch.from_numpy(x))
    loads = got["loads"]
    wc = 3 * cfg.d_model * cfg.d_ff
    for name, n_slots in (("classical", cfg.n_experts),
                          ("skew", cfg.n_slots())):
        want = jms.plan_dispatch(loads, n_slots)
        for f in ("slots_of_expert", "group_size", "slot_to_expert"):
            np.testing.assert_array_equal(getattr(got[name], f),
                                          getattr(want, f))
        assert got[f"{name}_cost"] == jms.dispatch_cost(loads, want, wc)
    jskew = jms.plan_dispatch(loads, cfg.n_slots())
    assert int(jskew.group_size[0]) == 4
    stats = jax.jit(lambda p, x: jmoe.moe_ffn(p, jcfg, jskew, x)[1])(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_array_equal(got["expert_load"],
                                  np.asarray(stats["expert_load"]))
    assert got["dropped_tokens"] == int(stats["dropped_tokens"])
    slots = np.asarray(jax.jit(lambda e, t: jms.route_tokens(jskew, e, t))(
        jnp.zeros(ex.T, jnp.int32), jnp.arange(ex.T, dtype=jnp.int32)))
    uniq, cnt = np.unique(slots, return_counts=True)
    np.testing.assert_array_equal(got["split"][0], uniq)
    np.testing.assert_array_equal(got["split"][1], cnt)


def test_train_lm_losses_equal_the_jax_example(tmp_path, capsys, monkeypatch):
    """Both examples for 3 steps on the CPU with their own arguments
    (reduced qwen2-0.5b, batch 8 x 64, lr 1e-3): the JAX example from its
    driver's own init_params(key(0)), the port's resumed from a step-0
    checkpoint of those parameters and their state in the reference's
    format.  The bf16 losses agree within rtol 1e-3, the tolerance of
    `_torch_family_cases.check_driver`."""
    from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", "") +
                       " --xla_force_host_platform_device_count=8")
    jex = _load("train_lm", EXAMPLES.parent)
    ex = _load("train_lm")
    steps = ["--steps", "3", "--log-every", "1"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcfg = JARCHS["qwen2-0.5b"].reduced()
    jparams = jinit_params(japi.layout(jcfg), jax.random.key(0))
    jopt = jadamw.init(jparams, JAdamWConfig(lr=1e-3))
    JCheckpointer(str(tdir)).save(0, {"params": jparams, "opt": jopt},
                                  blocking=True)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *steps,
                                      "--ckpt-dir", str(jdir)])
    jex.main()
    want = driver_losses(capsys.readouterr().out)
    ex.main([*steps, "--ckpt-dir", str(tdir), "--resume", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 0" in out
    got = driver_losses(out)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)
