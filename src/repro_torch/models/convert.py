"""Carry the reference package's parameters and AdamW states over to the port.

`params_from_jax(tree, cfg)` takes the JAX parameter pytree as numpy arrays
(`jax.device_get(params)`; each stack on a leading layer axis) and returns
the port's model with the same values, walking the layout's paths.  `opt_state_from_jax(state,
cfg)` does the same for an AdamW state tree (`optim/adamw.py`'s layout:
{"mu": per-parameter {"m", "v"} or {"m_q", "m_s", "v_q", "v_s"}, "step"}).
bf16 leaves arrive as `ml_dtypes.bfloat16` arrays, which `torch.from_numpy`
refuses; their bytes are carried as 16-bit integers and viewed as bf16.

Over a mesh (`mesh=`, with the train step's `rules`, by default
`common.rules_for(cfg, mesh)` as the step's), every rank takes its own block of the same arrays
(`common.distribute_tree`): the parameters in `param_placements`, the
states in `adamw.state_placements`, so both packages start from the same
values however the mesh is laid out.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.executor import resolve_device
from ..tree import flatten
from . import api
from .common import (PDef, distribute_tree, map_layout, param_placements,
                     rules_for)

_STATE_KEYS = ({"m", "v"}, {"m_q", "m_s", "v_q", "v_s"})


def _leaf(tree, path: tuple[str, ...]):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise ValueError(f"leaf {'/'.join(path)} missing from the tree")
        tree = tree[key]
    return tree


def tensor_from_numpy(a) -> torch.Tensor:
    """A writable torch copy of a numpy array, bf16 included, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _placements(cfg, mesh, rules):
    layout = api.layout(cfg)
    return layout, param_placements(layout, rules or rules_for(cfg, mesh),
                                    mesh)


def params_from_jax(tree: dict, cfg, *, device=None,
                    dtype: torch.dtype | None = None, mesh=None, rules=None):
    """The port's model holding `tree`'s values, in `dtype` (default: each
    leaf's own) on `device` (the card unless the caller asks for the CPU),
    over `mesh` DTensors of the rules' placements.  Raises on a missing
    leaf or (in `build`) a shape that is not the layout's."""
    dev = resolve_device(device)

    def carry(p: PDef, path):
        t = tensor_from_numpy(_leaf(tree, path))
        return t.to(device=dev, dtype=dtype or t.dtype)

    tensors = map_layout(api.layout(cfg), carry)
    if mesh is not None:
        tensors = distribute_tree(tensors, _placements(cfg, mesh, rules)[1],
                                  mesh)
    return api.build(cfg, tensors)


def opt_state_from_jax(state: dict, cfg, *, device=None, mesh=None,
                       rules=None) -> dict:
    """The reference's AdamW state tree (numpy leaves) as the port's: the
    same keys, dtypes and values, on `device` (the card unless the caller
    asks for the CPU), over `mesh` DTensors of `adamw.state_placements`.
    Raises on a parameter of the layout without its states, or states of
    a shape that is not the parameter's."""
    dev = resolve_device(device)

    def carry(p: PDef, path):
        mu = _leaf(state["mu"], path)
        if not isinstance(mu, dict) or set(mu) not in _STATE_KEYS:
            raise ValueError(f"states of {'/'.join(path)}: "
                             f"{sorted(mu) if isinstance(mu, dict) else mu}")
        out = {k: tensor_from_numpy(v).to(dev) for k, v in mu.items()}
        want = p.shape if "m" in out else (p.shape or (1,))
        for k, t in out.items():
            shape = want[:-1] + (1,) if k.endswith("_s") else want
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"state {'/'.join(path)}/{k}: shape "
                                 f"{tuple(t.shape)}, expected {shape}")
        return out

    out = {"mu": map_layout(api.layout(cfg), carry),
           "step": tensor_from_numpy(state["step"]).to(dev)}
    if mesh is None:
        return out
    from ..optim import adamw
    layout, p_pl = _placements(cfg, mesh, rules)
    bits = 8 if any(k.endswith("/m_q") for k in flatten(out["mu"])) else 32
    abstract = map_layout(layout, lambda p, _: torch.empty(p.shape,
                                                           device="meta"))
    return distribute_tree(out, adamw.state_placements(
        abstract, p_pl, adamw.AdamWConfig(state_bits=bits)), mesh)
