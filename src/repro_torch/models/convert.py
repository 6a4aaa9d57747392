"""Carry the reference package's parameters over to the port's model.

`params_from_jax(tree, cfg)` takes the JAX parameter pytree as numpy arrays
(`jax.device_get(params)`; `"blocks"` stacked on a leading layer axis) and
returns the port's model with the same values.  bf16 leaves arrive as
`ml_dtypes.bfloat16` arrays, which `torch.from_numpy` refuses; they go
through float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.executor import resolve_device
from . import api
from .common import PDef, map_layout


def _leaf(tree, path: tuple[str, ...]):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise ValueError(f"parameter {'/'.join(path)} missing from the "
                             f"tree")
        tree = tree[key]
    return np.asarray(tree)


def params_from_jax(tree: dict, cfg, *, device=None,
                    dtype: torch.dtype | None = None):
    """The port's model holding `tree`'s values, in `dtype` (default: each
    leaf's own) on `device` (the card unless the caller asks for the CPU).
    Raises on a missing leaf or (in `build`) a shape that is not the
    layout's."""
    dev = resolve_device(device)

    def carry(p: PDef, path):
        a = _leaf(tree, path)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))      # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    return api.build(cfg, map_layout(api.layout(cfg), carry))
