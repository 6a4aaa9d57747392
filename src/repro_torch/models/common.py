"""Model substrate: declarative parameter layouts and the model over them.

One source of truth per architecture: a *layout* — a nested dict mapping
parameter names to `PDef(shape, logical_axes)` — from which the parameters
are made (`init_params`), counted (`count_params`) and checked when carried
over from the reference package (`models/convert.py`).  The logical axis
names are kept as the reference package writes them; on one device they
shard nothing.

A `Model` holds the layout-shaped tree itself: `blocks` keeps every leaf
stacked on a leading layer axis, as the reference's scanned parameters,
and `model.tree()` is that tree (what the optimizer and the checkpoint
walk).  `model.blocks[i]` is layer i, views of the stacked leaves; with
`requires_grad` on, a layer's gradient is added into its slice of the
stacked leaf's `.grad` as soon as it is computed (`take_layer`), so
training holds one gradient the size of the parameters.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable

import torch
from torch import nn

from ..core.executor import resolve_device
from ..tree import tree_map


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
    """A layout subtree as a module: tensors become parameters (frozen
    until a trainer turns `requires_grad` on) and dicts child modules, each
    under its layout key, so parameter names follow the layout's paths;
    `tree["wq"]` reads one as the reference's nested dicts do."""

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

    def tree(self) -> dict:
        """The subtree as nested dicts of its parameters (the storage)."""
        out = dict(self.named_parameters(recurse=False))
        for name, child in self.named_children():
            out[name] = child.tree()
        return out


class TensorView:
    """One module's tensors by layout key, read as `p["wq"]` or `p.wq`;
    each layer of a `LayerStack` is one."""

    def __init__(self, tensors: dict):
        self._tensors = tensors

    def __getitem__(self, name: str):
        return self._tensors[name]

    def __getattr__(self, name: str):
        tensors = self.__dict__.get("_tensors", {})
        if name not in tensors:
            raise AttributeError(name)
        return tensors[name]

    def __contains__(self, name: str) -> bool:
        return name in self._tensors


def take_layer(t: torch.Tensor, i: int) -> torch.Tensor:
    """Layer i of a stacked leaf: a view of its storage.

    Under autograd (`t` requires grad, grad mode on) the view is a leaf of
    its own; as soon as autograd has its gradient (leaves' accumulation
    runs first), `_into_slice` adds it into `t.grad[i]` (zeroed at first
    use) and drops it.  Slicing `t` in the graph instead would give each
    layer a gradient of `t`'s full size, held until summed: at full width,
    a second copy of the largest leaves."""
    if not (t.requires_grad and torch.is_grad_enabled()):
        return t[i]
    layer = t[i].detach().requires_grad_()
    layer.register_post_accumulate_grad_hook(partial(_into_slice, t, i))
    return layer


def _into_slice(t: torch.Tensor, i: int, layer: torch.Tensor) -> None:
    if t.grad is None:
        t.grad = torch.zeros_like(t)
    t.grad[i] += layer.grad
    layer.grad = None


class LayerStack(ParamTree):
    """The layout's `blocks`: every leaf stacked on a leading layer axis and
    registered under its layout path (`blocks.attn.wq`).  `stack[i]` is
    layer i, `view` over the slices (the family's `Block`); iterating
    walks the layers in order; `stack["attn"]` is a stacked subtree."""

    def __init__(self, tensors: dict, view: Callable[[dict], Any]):
        super().__init__(tensors)
        self._view = view
        self._n = next(iter(self.parameters())).shape[0]

    def __getitem__(self, key):
        if isinstance(key, str):
            return getattr(self, key)
        if not -self._n <= key < self._n:
            raise IndexError(f"layer {key} of {self._n}")
        i = key % self._n
        return self._view(tree_map(lambda t: take_layer(t, i), self.tree()))

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return (self[i] for i in range(self._n))


class Model(ParamTree):
    """embed (tok, final_norm[, unembed]) and blocks (a `LayerStack`) of
    one family.  `forward` is the family's (`fn(model, cfg, tokens,
    **kw)`); `use_kernels` is the dispatch knob of the executor's config
    of that name (False runs every kernel's plain version)."""

    def __init__(self, cfg, tensors: dict, block: Callable, forward: Callable):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = True
        self._forward = forward
        self.embed = ParamTree(tensors["embed"])
        self.blocks = LayerStack(tensors["blocks"], lambda t: block(cfg, t))

    def forward(self, tokens, **kw):
        return self._forward(self, self.cfg, tokens, **kw)


def check_tree(layout: Layout, tensors: dict) -> None:
    """Raise on a leaf of `layout` missing from `tensors` or of another
    shape."""
    def check(p: PDef, path):
        t = tensors
        for key in path:
            if not isinstance(t, dict) or key not in t:
                raise ValueError(f"parameter {'/'.join(path)} missing")
            t = t[key]
        if tuple(t.shape) != p.shape:
            raise ValueError(f"parameter {'/'.join(path)}: shape "
                             f"{tuple(t.shape)}, layout {p.shape}")

    map_layout(layout, check)


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
