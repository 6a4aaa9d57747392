"""The port's dry run over a mesh (`repro_torch.launch.dryrun.run_cell(...,
mesh_kind)`, `--mesh`, `--override`) against the JAX package's dry run on a
mesh of the same shape over the test session's 8 virtual devices.

The port traces rank 0 of a fake world (`launch.mesh.fake_world`: torch's
fake process-group backend, fake tensors, no rank spawned); the reference
lowers and compiles its step through its own `build_lowered`, with its
`default_rules` and the config's hints.  `repro.launch.dryrun` sets
XLA_FLAGS to 512 host devices when imported: it is imported once the
session's devices exist, and the variable is put back for later
processes.

Reduced configs (dense qwen3-14b, MoE mixtral-8x22b with 8-bit states, SSM
mamba2-370m) on train_4k, one microbatch, at (2, 4) and (2, 2, 2):

  * rank 0's `argument_bytes` (its blocks of the parameters, the
    optimizer state and the batch) equal the reference's
    `memory_analysis().argument_size_in_bytes`, to the byte;
  * on (2, 2, 2), a dense and an MoE prefill_32k's FLOPs a rank within
    test_torch_dryrun.py's 2 % of `hlo_analysis`'s per device (both count
    matmuls only; the train steps differ by their recomputation);
  * cross-pod bytes: 0 with no pod axis; on (2, 2, 2) above 0, and no
    fewer than the gradient reduction over "pod" needs: every rank's block
    of every gradient (the parameters' blocks, `count_params` of the
    layout split by the placements), since "pod" splits no parameter and
    the batch's rows are split over it.  Where DTensor leaves a gradient
    split over fewer axes than its parameter, the pod all-reduce carries
    the larger block, so the step's figure is held between that and the
    whole gradients' bytes; a leaf whose gradient comes out in a known
    placement is held to its block exactly.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Partial, Replicate, Shard

from repro.configs import ARCHS as JARCHS
from repro.launch import hlo_analysis
from repro.models.common import default_rules as jdefault_rules
from repro_torch.configs import ARCHS, ShapeCell
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch import mesh as meshlib
from repro_torch.models import api
from repro_torch.models.common import (as_dtensor, count_params,
                                       local_block, map_layout,
                                       param_placements)
from repro_torch.tree import flatten

ROOT = Path(__file__).resolve().parents[1]
B, S = 8, 32
TRAIN = ShapeCell("t", S, B, "train")
CONFIGS = [("qwen3-14b", 32), ("mixtral-8x22b", 8), ("mamba2-370m", 32)]
MESHES = [(2, 4), (2, 2, 2)]
FLOP_TOL = 0.02


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _jax_mesh(shape):
    return Mesh(np.array(jax.devices()[:8]).reshape(shape), _axes(shape))


def _jax_rules(cfg, mesh):
    rules = jdefault_rules(mesh)
    if cfg.sharding_hints:
        rules = rules.override(**dict(cfg.sharding_hints))
    return rules


def _pod_size(shape):
    return int(np.prod(shape[1:])) if len(shape) == 3 else None


@pytest.fixture(scope="module")
def reference():
    """The reference's train_4k argument bytes a device for every
    (config, mesh) and its prefill_32k FLOPs a device for the dense and
    MoE configs on (2, 2, 2): one `build_lowered` and compile each."""
    jax.devices()                       # the session's 8 devices exist
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    out = {}
    for name, bits in CONFIGS:
        cfg = JARCHS[name].reduced()
        for shape in MESHES:
            mesh = _jax_mesh(shape)
            rules = _jax_rules(cfg, mesh)
            comp = jdryrun.build_lowered(cfg, "train_4k", mesh, rules, 1,
                                         bits).compile()
            out[name, shape, "args"] = (
                comp.memory_analysis().argument_size_in_bytes)
            if name != "mamba2-370m" and len(shape) == 3:
                comp = jdryrun.build_lowered(cfg, "prefill_32k", mesh,
                                             rules).compile()
                out[name, shape, "flops"] = hlo_analysis.analyze(
                    comp.as_text(), pod_size=_pod_size(shape)).flops
    return out


def _trace(name, cell, bits, shape):
    """Rank 0's record of the reduced config at `cell` over a fake world
    of `shape`, one microbatch."""
    cfg = ARCHS[name].reduced()
    with meshlib.fake_world(shape) as mesh:
        return dryrun.size(cfg, cell, 1, bits, mesh,
                           dryrun.cell_rules(cfg, mesh))


_size = functools.cache(_trace)       # the tests share a cell's trace


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name,bits", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_rank0_arguments_equal_the_reference_per_device(reference, name,
                                                        bits, shape):
    got = _size(name, "train_4k", bits, shape)
    assert got["memory"]["argument_bytes"] == reference[name, shape, "args"]
    if len(shape) == 2:
        assert got["parsed"]["coll_bytes_crosspod"] == 0.0
    else:
        assert got["parsed"]["coll_bytes_crosspod"] > 0
    if (name, shape, "flops") in reference:
        flops = _size(name, "prefill_32k", bits, shape)["parsed"]["flops"]
        want = reference[name, shape, "flops"]
        assert abs(flops / want - 1) <= FLOP_TOL, (flops, want)
    assert not dist.is_initialized()


def test_crosspod_bytes_are_the_gradient_reduction_over_pod():
    """A leaf replicated over "pod" and "data" and split over "model", its
    batch split over ("pod", "data"), the loss its output's sum: the
    backward leaves its gradient Partial over "pod" and "data" and whole
    over "model" (the sum's gradient is replicated), so bringing it to the
    leaf's placements all-reduces the whole (16, 32) float32 gradient over
    "pod" (and over "data", within a pod): 2,048 bytes cross the pods and
    nothing else does.  The reduced qwen3 train_4k step's cross-pod bytes lie
    between every rank's block of every gradient (`count_params` split by
    the placements) and the whole gradients, plus the loss's two float32
    scalars."""
    with meshlib.fake_world((2, 2, 2)) as mesh, FakeTensorMode():
        w = as_dtensor(torch.empty(16, 16), (16, 32),
                       (Replicate(), Replicate(), Shard(1)),
                       mesh).requires_grad_()
        x = as_dtensor(torch.empty(2, 16), (8, 16),
                       (Shard(0), Shard(0), Replicate()), mesh)

        def step(w, x):
            (x @ w).sum().backward()
            assert w.grad.placements == (Partial(), Partial(), Replicate())
            return w.grad.redistribute(mesh, w.placements)

        tr = op_analysis.analyze(step, w, x, pod_size=4)
    assert tr.terms.coll_counts["all-reduce"] == 2
    assert tr.terms.coll_bytes_crosspod == 16 * 32 * 4

    cfg = ARCHS["qwen3-14b"].reduced()
    got = _size("qwen3-14b", "train_4k", 32, (2, 2, 2))["parsed"]
    layout = api.layout(cfg)
    item = torch.tensor([], dtype=getattr(torch, cfg.param_dtype)
                        ).element_size()
    with meshlib.fake_world((2, 2, 2)) as mesh:
        pl = flatten(param_placements(layout, dryrun.cell_rules(cfg, mesh),
                                      mesh))
        blocks = sum(int(np.prod(local_block(p.shape, pl[k], mesh)[0]))
                     for k, p in flatten(map_layout(
                         layout, lambda p, _: p)).items())
    scalars = 2 * 4
    assert blocks * item + scalars <= got["coll_bytes_crosspod"] <= (
        count_params(layout) * item + scalars)


def test_one_by_one_record_equals_the_one_card_record():
    """`1x1` traces the one-card step and opens no process group: its
    memory, FLOPs and bytes are the one-card record's exactly, with no
    collective."""
    kw = dict(cfg_overrides={"n_layers": 2})
    one = dryrun.run_cell("qwen2-0.5b", "decode_32k", **kw)
    got = dryrun.run_cell("qwen2-0.5b", "decode_32k", "1x1", **kw)
    assert got["status"] == one["status"] == "ok", got.get("traceback")
    assert (got["mesh"], got["chips"], got["mesh_shape"]) == ("1x1", 1, [1, 1])
    for key in ("memory", "parsed", "roofline", "n_micro", "n_params"):
        assert got[key] == one[key], key
    assert got["parsed"]["coll_bytes_total"] == 0
    assert not dist.is_initialized()


def test_record_after_other_traces_equals_a_fresh_process():
    """DTensor propagates a sharding once per op and layout a process
    (running the op on fake global-shape tensors the first time): the
    counter skips it, so a record traced after other mesh traces (here
    the same cell twice, the second warm) equals one a fresh process
    traces cold."""
    def record():
        got = _trace("qwen3-14b", TRAIN, 32, (2, 4))
        got.pop("trace_s")
        return got

    _trace("mamba2-370m", TRAIN, 32, (2, 4))
    record()
    warm = record()
    code = ("import json\n"
            "from repro_torch.configs import ARCHS, ShapeCell\n"
            "from repro_torch.launch import dryrun, mesh\n"
            "cfg = ARCHS['qwen3-14b'].reduced()\n"
            f"cell = ShapeCell('t', {S}, {B}, 'train')\n"
            "with mesh.fake_world((2, 4)) as m:\n"
            "    got = dryrun.size(cfg, cell, 1, 32, m,\n"
            "                      dryrun.cell_rules(cfg, m))\n"
            "got.pop('trace_s')\n"
            "print(json.dumps(got))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    fresh = json.loads(out.stdout.splitlines()[-1])
    assert json.loads(json.dumps(warm)) == fresh


def test_override_is_parsed_as_the_reference_and_lands_in_the_rules(
        tmp_path):
    """`--override` items parse as the reference's `main` parses them
    (None / none / empty -> None, a comma -> a tuple of axes); through
    `main`, `act_seq=model` lands in the record and in the traced rules
    (the activations' sequence split over "model" changes what a rank
    holds), and no process group is left."""
    assert dryrun.parse_overrides(
        ["act_seq=model", "embed=None", "vocab=none", "ffn=",
         "experts=data,model"]) == {
        "act_seq": "model", "embed": None, "vocab": None, "ffn": None,
        "experts": ("data", "model")}
    cfg = ARCHS["qwen3-14b"].reduced()
    with meshlib.fake_world((2, 4)) as mesh:
        rules = dryrun.cell_rules(cfg, mesh, {"act_seq": "model"})
        assert rules.mesh_axes("act_seq") == "model"
        assert dryrun.cell_rules(cfg, mesh).mesh_axes("act_seq") is None
    out = tmp_path / "dryrun.json"
    args = ["--arch", "qwen3-14b", "--shape", "prefill_32k", "--mesh", "2x4",
            "--cfg-set", "n_layers=1", "--out", str(out)]
    dryrun.main(args)
    dryrun.main(args + ["--override", "act_seq=model", "--tag", "seq"])
    plain, seq = json.loads(out.read_text())
    assert not dist.is_initialized()
    assert plain["status"] == seq["status"] == "ok", seq.get("traceback")
    assert (seq["mesh"], seq["chips"], seq["tag"]) == ("2x4", 8, "seq")
    assert seq["overrides"] == {"act_seq": "model"} and "overrides" not in plain
    assert seq["memory"] != plain["memory"]
