"""The port's dry run (`repro_torch.launch.dryrun`) and op analysis
(`repro_torch.launch.op_analysis`) against the JAX package's
`repro.launch.dryrun` and `repro.launch.hlo_analysis`.

`repro.launch.dryrun` sets XLA_FLAGS to 512 host devices when it is
imported; imported here it would change the device count of every later
test file on this worker, so its numbers are computed in a subprocess
(`reference`)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JARCHS
from repro.launch import hlo_analysis
from repro.models import api as japi
from repro.models.common import map_layout as jmap_layout
from repro_torch.configs import ARCHS, SHAPES, ShapeCell, input_specs
from repro_torch.launch import dryrun, op_analysis
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train import build_train_step
from repro_torch.tree import flatten

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference():
    """JAX's active_params and model_flops of every (arch, shape) cell,
    from `repro.launch.dryrun` in a subprocess."""
    code = (
        "import json\n"
        "from repro.configs import ARCHS, SHAPES\n"
        "from repro.launch import dryrun as D\n"
        "print(json.dumps({'active': {n: D.active_params(c) for n, c in "
        "ARCHS.items()}, 'flops': {n: {s: D.model_flops(c, s) for s in "
        "SHAPES} for n, c in ARCHS.items()}}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_active_params_and_model_flops_equal_jax(reference, shape):
    assert sorted(reference["active"]) == sorted(ARCHS)
    for name, cfg in ARCHS.items():
        assert dryrun.active_params(cfg) == reference["active"][name], name
        assert dryrun.model_flops(cfg, shape) == \
            reference["flops"][name][shape], name


def test_matmul_chain_flops_equal_analytic():
    """As the reference's `test_real_compile_matches_analytic`: a chain of
    L (D, D) matmuls is L·2·D³ FLOPs, here exactly, on fake tensors."""
    D, L = 64, 7

    def f(ws, x):
        for w in ws:
            x = x @ w
        return x.sum()

    with FakeTensorMode():
        tr = op_analysis.analyze(f, torch.empty(L, D, D), torch.empty(D, D))
    assert tr.terms.flops == L * 2 * D ** 3
    assert tr.terms.coll_bytes_total == 0
    assert tr.terms.coll_counts == dict.fromkeys(op_analysis.COLLECTIVES, 0)


def test_bytes_of_elementwise_views_and_indexed_writes():
    """An element-wise op reads its inputs (a broadcast operand's distinct
    elements once) and writes its output; views move nothing; an in-place
    indexed write moves its indices and the elements it writes, not its
    destination; the temporaries' peak is their bytes in 512-byte blocks."""
    a, b, c = torch.randn(1000, 64), torch.randn(1000, 64), torch.randn(64)
    tr = op_analysis.analyze(torch.add, a, b)
    assert tr.terms.hbm_bytes == 3 * a.nbytes and tr.terms.flops == 0
    assert tr.temp_bytes == a.nbytes                       # a 512 multiple
    tr = op_analysis.analyze(torch.mul, a, c)
    assert tr.terms.hbm_bytes == 2 * a.nbytes + c.nbytes
    tr = op_analysis.analyze(
        lambda t: (t.view(64_000), t.T, t[::2], t.unsqueeze(0), t.detach(),
                   t.expand(2, 1000, 64)), a)
    assert tr.terms.hbm_bytes == 0 and tr.temp_bytes == 0
    idx = torch.tensor([3, 7])
    vals = torch.ones(2, 64)
    tr = op_analysis.analyze(lambda t: t.index_put_((idx,), vals), a)
    assert tr.terms.hbm_bytes == idx.nbytes + 2 * vals.nbytes
    # The sum's scalar lives until the addition's is made; freed storages
    # count no more.
    tr = op_analysis.analyze(lambda t: t.sum(0) + 1, torch.randn(3))
    assert tr.temp_bytes == 1024
    tr = op_analysis.analyze(lambda t: [(t + 1).sum() for _ in range(4)],
                             torch.randn(1000))
    assert tr.temp_bytes == 4096 + 4 * 512       # 4,000 bytes in 8 blocks


def _jax_flops(jcfg, B, S) -> float:
    params = jmap_layout(japi.layout(jcfg), lambda p, _: jax.ShapeDtypeStruct(
        p.shape, jnp.bfloat16))
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    comp = jax.jit(lambda p, t: japi.forward(p, jcfg, {"tokens": t})[0]
                   ).lower(params, tokens).compile()
    return hlo_analysis.analyze(comp.as_text()).flops


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mixtral-8x22b"])
def test_forward_flops_match_hlo_analysis(name):
    """A forward pass of the reduced config (2 layers, d_model 128; S 256)
    on fake tensors counts within 2 % of the FLOPs `hlo_analysis` parses
    from the JAX forward compiled for one CPU device (its scanned layers
    weighted by their trip count).  Both count matmuls only: the
    projections, the attention's two grouped einsums, the router, the
    expert einsums over the same capacity buffers, the logits; on these
    two configs the counts are equal, so there is no gap to explain."""
    B, S = 2, 256
    cfg = ARCHS[name].reduced()
    with FakeTensorMode():
        model = dryrun._model(cfg)
        tokens = torch.empty((B, S), dtype=torch.int32)
        got = op_analysis.analyze(api.forward, model, cfg,
                                  {"tokens": tokens}).terms.flops
    want = _jax_flops(JARCHS[name].reduced(), B, S)
    assert abs(got / want - 1) <= 0.02, (got, want)


def test_microbatches_reckoned_from_one_equal_the_traced_step():
    """A train step of n_micro microbatches reckoned from one traced
    microbatch (n_micro x the counts before the update, the update once)
    has the FLOPs of the step traced with all n_micro, exactly."""
    cfg, n = ARCHS["qwen2-0.5b"].reduced(), 3
    cell = ShapeCell("t", 64, n, "train")
    got = dryrun.size(cfg, cell, n_micro=n)["parsed"]["flops"]
    ocfg = AdamWConfig()
    with FakeTensorMode():
        model = dryrun._model(cfg)
        opt = adamw.init(model.tree(), ocfg)
        fns = build_train_step(cfg, ocfg, n_micro=n, device="cpu")
        batch = {k: torch.empty(v.shape, dtype=v.dtype)
                 for k, v in input_specs(cfg, cell).items()}
        want = op_analysis.analyze(fns.step, model, opt, batch).terms.flops
    assert got == want > 0


@pytest.mark.parametrize("bits", [32, 8])
def test_argument_bytes_equal_real_tensors(bits):
    """A train step's predicted arguments are the bytes of the real CPU
    tensors: init_model's parameters, adamw.init's state, and the cell's
    batch."""
    cfg = ARCHS["mixtral-8x22b"].reduced()
    got = dryrun.trace_cell(cfg, "train_4k", SHAPES["train_4k"].global_batch,
                            bits)["argument_bytes"]
    model = api.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw.init(model.tree(), AdamWConfig(state_bits=bits))
    batch = [torch.zeros(v.shape, dtype=v.dtype)
             for v in input_specs(cfg, "train_4k").values()]
    want = sum(t.nbytes for t in [*model.parameters(), *flatten(opt).values(),
                                  *batch])
    assert got == want
