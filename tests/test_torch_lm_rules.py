"""The port's sharding rules against the JAX package's, with no rank
spawned: for every registered architecture's layout on five (data, model)
mesh shapes and one (pod, data, model) shape,
`resolve_pspec` (the pspec form of `resolve_placements`) equals the
reference's PartitionSpec leaf by leaf, under the rules the train steps
build (`default_rules` overridden by the config's `sharding_hints`,
`common.rules_for`); the
placements are the pspecs' (a `Shard(d)` on each mesh dimension a spec
names at dimension d); the 8-bit optimizer states' specs equal
`state_pspecs`' and their placements `state_placements`'; and
`batch_placements` equals `batch_shardings` (long_500k's batch of 1
replicated).  A mesh's shape alone is given to both packages (the rules
read nothing else of it); the batch check builds the reference's meshes
over the test session's virtual devices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import ARCHS as JARCHS
from repro.configs.base import SHAPES
from repro.models import api as japi
from repro.models import common as jcommon
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.train.train_step import batch_shardings
from repro_torch.configs import ARCHS
from repro_torch.models import api
from repro_torch.models import common
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train.train_step import batch_placements, batch_pspecs
from repro_torch.tree import flatten

MESHES = [(2, 4), (4, 2), (2, 2), (1, 4), (8, 1), (2, 2, 2)]


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _id(shape):
    return "x".join(map(str, shape))


class FakeMesh:
    """A mesh's shape alone, as both packages' rules read it."""

    def __init__(self, shape):
        self.shape = dict(zip(_axes(shape), shape))


def _rules(cfg, mesh):
    """The reference's train-step rules (its build_train_step's)."""
    rules = jcommon.default_rules(mesh)
    if cfg.sharding_hints:
        rules = rules.override(**dict(cfg.sharding_hints))
    return rules


def _specs(tree):
    """{path: tuple} of a tree of PartitionSpecs or tuples."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k, sub in tree.items()
                for p, v in _specs(sub).items()}
    return {"": tuple(tree)}


@pytest.mark.parametrize("shape", MESHES, ids=_id)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_and_state_specs_equal_the_reference(name, shape):
    cfg, jcfg = ARCHS[name], JARCHS[name]
    mesh = FakeMesh(shape)
    rules, jrules = common.rules_for(cfg, mesh.shape), _rules(jcfg, mesh)
    assert dict(rules.table) == dict(jrules.table)
    assert rules.dp_axes == jrules.dp_axes
    layout = api.layout(cfg)
    got = common.param_pspecs(layout, rules, mesh.shape)
    want = jcommon.param_pspecs(japi.layout(jcfg), jrules, mesh)
    assert _specs(got) == _specs(want)

    # The placements are the specs', mesh dimension by mesh dimension (a
    # mesh axis of one rank replicates).
    placements = common.param_placements(layout, rules, mesh.shape)
    for key, pl in flatten(placements).items():
        spec = flatten(got)[key]
        for i, axis in enumerate(_axes(shape)):
            dims = [d for d, a in enumerate(spec)
                    if a == axis or (isinstance(a, tuple) and axis in a)]
            assert pl[i] == (common.Shard(dims[0])
                             if dims and mesh.shape[axis] > 1
                             else common.Replicate()), (key, axis)

    # 8-bit optimizer states: the scales drop the last axis's sharding.
    abstract = common.map_layout(layout, lambda p, _: torch.empty(
        p.shape, device="meta"))
    jabstract = jcommon.abstract_params(japi.layout(jcfg))
    for bits in (8, 32):
        st = adamw.state_pspecs(abstract, got, AdamWConfig(state_bits=bits))
        jst = jadamw.state_pspecs(jabstract, want,
                                  JAdamWConfig(state_bits=bits))
        assert _specs(st) == _specs(jst)
        st_pl = adamw.state_placements(abstract, placements,
                                       AdamWConfig(state_bits=bits))
        for key, spec in flatten(st).items():
            assert flatten(st_pl)[key] == common.placements_of(
                spec, mesh.shape), key


@pytest.mark.parametrize("shape", MESHES, ids=_id)
def test_batch_placements_equal_batch_shardings(shape):
    devices = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devices, _axes(shape))
    rules = common.default_rules(dict(mesh.shape))
    jrules = jcommon.default_rules(mesh)
    for cell in SHAPES.values():
        babs = {"tokens": jax.ShapeDtypeStruct(
                    (cell.global_batch, cell.seq_len), jnp.int32),
                "frames": jax.ShapeDtypeStruct((cell.global_batch, 4, 8),
                                               jnp.bfloat16)}
        want = {k: tuple(v.spec) for k, v in
                batch_shardings(babs, jrules, mesh).items()}
        got = batch_pspecs(babs, rules, dict(mesh.shape))
        # A PartitionSpec writes a one-axis tuple as the axis.
        assert {k: tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                         for a in v) for k, v in got.items()} == want, cell.name
        pl = batch_placements(babs, rules, dict(mesh.shape))
        for k, spec in got.items():
            assert pl[k] == common.placements_of(spec, dict(mesh.shape))
    one = {"tokens": jax.ShapeDtypeStruct((1, 524_288), jnp.int32)}
    if shape[-2] == 1:         # one data rank holds every batch
        return
    assert batch_pspecs(one, rules, dict(mesh.shape))["tokens"] == (None, None)
    assert batch_placements(one, rules, dict(mesh.shape))["tokens"] == (
        (common.Replicate(),) * len(shape))
