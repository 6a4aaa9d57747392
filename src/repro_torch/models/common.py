"""Model substrate: declarative parameter layouts.

One source of truth per architecture: a *layout* — a nested dict mapping
parameter names to `PDef(shape, logical_axes)` — from which the parameters
are made (`init_params`), counted (`count_params`) and checked when carried
over from the reference package (`models/convert.py`).  The logical axis
names are kept as the reference package writes them; on one device they
shard nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable

import torch
from torch import nn

from ..core.executor import resolve_device


@dataclass(frozen=True)
class PDef:
    """One parameter: shape + logical axis names (len == ndim) + init scale."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"         # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Layout = dict[str, Any]   # nested dict of PDef


def map_layout(layout: Layout, fn: Callable[[PDef, tuple[str, ...]], Any],
               _path: tuple[str, ...] = ()) -> Any:
    if isinstance(layout, PDef):
        return fn(layout, _path)
    return {k: map_layout(v, fn, _path + (k,)) for k, v in layout.items()}


class ParamTree(nn.Module):
    """A layout subtree as a module: tensors become frozen parameters and
    dicts child modules, each under its layout key, so parameter names
    follow the layout's paths; `tree["wq"]` reads one as the reference's
    nested dicts do."""

    def __init__(self, tree: dict | None = None):
        super().__init__()
        for name, value in (tree or {}).items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, ParamTree(value))

    def __getitem__(self, name: str):
        return getattr(self, name)


def init_params(layout: Layout, generator: torch.Generator, *, device=None,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Parameters of `layout` (a nested dict of tensors of its shapes):
    N(0, 1)·scale, zeros or ones as each PDef says, drawn from `generator`
    leaf by leaf in layout order, in `dtype` on `device` (the card unless
    the caller asks for the CPU).  The generator must live on that device.
    The reference draws from JAX keys, so the values differ; tests carry the
    reference's parameters over with `convert.params_from_jax`."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: they must share a device")

    def make(p: PDef, _):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        # Drawn in place: no float32 copy of a large leaf.
        return torch.empty(p.shape, dtype=dtype, device=dev).normal_(
            0.0, p.scale, generator=generator)

    return map_layout(layout, make)


def stack_layers(layout: Layout, n: int) -> Layout:
    """Prepend a 'layers' dimension to every param of a block layout."""
    return map_layout(
        layout,
        lambda p, _: replace(p, shape=(n,) + p.shape, axes=("layers",) + p.axes))


def count_params(layout: Layout) -> int:
    total = 0

    def add(p: PDef, _):
        nonlocal total
        total += math.prod(p.shape)

    map_layout(layout, add)
    return total
