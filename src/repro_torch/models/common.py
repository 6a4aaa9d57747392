"""Model substrate: declarative parameter layouts and the model over them.

One source of truth per architecture: a *layout* — a nested dict mapping
parameter names to `PDef(shape, logical_axes)` — from which the parameters
are made (`init_params`), counted (`count_params`) and checked when carried
over from the reference package (`models/convert.py`).  The logical axis
names are kept as the reference package writes them, and over a mesh they
shard through a rules table, as the reference's do (below).

A `Model` holds the layout-shaped tree itself: each stack that
`stack_layers` made (`blocks`; `mamba_blocks` and `tail_blocks`;
`enc_blocks` and `dec_blocks`; ...) keeps every leaf stacked on a leading
layer axis, as the reference's scanned parameters, and `model.tree()` is
that tree, the layout's own paths (what the optimizer and the checkpoint
walk).  `model.blocks[i]` is layer i, views of the stacked leaves; with
`requires_grad` on, a layer's gradient is added into its slice of the
stacked leaf's `.grad` as soon as it is computed (`take_layer`), so
training holds one gradient the size of the parameters.  Unstacked
subtrees (zamba2's shared block, the encoder's final norm, the vision
projection) are plain parameters: a block applied several times gathers
its gradient from every application through autograd.

Sharding over a mesh.  The reference resolves each logical axis through a
rules table (`Rules`, `default_rules`: TP over "model", FSDP over "data",
DP over ("pod", "data")) into a PartitionSpec, with a divisibility
fallback and a mesh axis sharding one dimension at most; pjit lays the
parameters, states and batch out so, and `ShardCtx.shard` pins
activations with `with_sharding_constraint`.  Here the same table
resolves into `torch.distributed.tensor` placements on a 2-D ("data",
"model") or 3-D ("pod", "data", "model") `DeviceMesh`
(`resolve_placements`, one `Shard(d)` or `Replicate()` a mesh dimension;
the batch's rows `Shard(0)` on both "pod" and "data", pod-major as the
reference's tuple entry; `resolve_pspec` is the same resolution in the
reference's form, a mesh-axis name or tuple or None a dimension), the
parameters are DTensors (`distribute_tree`: each rank takes its own shard
of the same full tensors, no collective), the model code runs on them, and
`ShardCtx.shard(x, *logical)` is `x.redistribute(mesh, placements)`.
Changing the rules table, not the model code, changes the layout.
`NO_SHARD` (the default of every `shd` argument) shards nothing: the
one-device path is unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable, Mapping

import torch
from torch import nn

from torch.distributed.tensor import DTensor, Replicate, Shard

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


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rules:
    """logical axis -> mesh axis (or tuple of axes, or None = replicate)."""
    table: Mapping[str, Any]
    dp_axes: tuple[str, ...]          # all data-parallel mesh axes ("pod","data")

    def mesh_axes(self, logical: str | None) -> Any:
        if logical is None:
            return None
        if logical == "batch":
            return self.dp_axes
        return self.table.get(logical, None)

    def override(self, **kw) -> "Rules":
        t = dict(self.table)
        t.update(kw)
        return Rules(t, self.dp_axes)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of a mapping given as one (a
    mesh's shape alone is enough to resolve a layout)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def default_rules(mesh) -> Rules:
    """Baseline: TP over 'model', FSDP over 'data', DP over ('pod','data')."""
    shape = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in shape)
    return Rules({
        # parameters
        "vocab": "model",
        "embed": "data",          # FSDP axis of 2-D weights
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "experts": "model",
        "expert_ffn": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "conv_k": None,
        "layers": None,
        # activations
        "act_embed": None,
        "act_seq": None,          # flip to "model" for sequence parallelism
        "act_heads": "model",
        "act_experts": "model",
        "act_vocab": "model",
    }, dp)


def rules_for(cfg, mesh) -> Rules:
    """The train step's rules: `default_rules(mesh)` overridden by the
    config's `sharding_hints`, as the reference's `build_train_step`
    makes them."""
    rules = default_rules(mesh)
    if cfg.sharding_hints:
        rules = rules.override(**dict(cfg.sharding_hints))
    return rules


def _flat_axes(axes: Any) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes or ())


def resolve_pspec(shape: tuple[int, ...], logical: tuple[str | None, ...],
                  rules: Rules, mesh) -> tuple:
    """The reference's PartitionSpec of a dimension list, as a tuple (one
    mesh axis, tuple of axes or None a dimension, trailing Nones dropped):
    the divisibility fallback (replicate what doesn't divide) and
    first-wins duplicate-axis resolution (a mesh axis shards only one
    dimension)."""
    sizes = mesh_shape(mesh)
    out = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        axes = rules.mesh_axes(name)
        flat = _flat_axes(axes)
        if (axes is not None and dim > 0
                and dim % math.prod(sizes[a] for a in flat) == 0
                and not (set(flat) & used)):
            out.append(axes)
            used |= set(flat)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements_of(pspec: tuple, mesh) -> tuple:
    """One placement a mesh dimension from a pspec: `Shard(d)` where the
    spec names that mesh axis at dimension d, else `Replicate()`.  A
    dimension over several axes is sharded by each, the first major, as
    the reference's tuple entries are.  A mesh axis of one rank shards
    nothing: `Replicate()` (the same layout, and DTensor keeps no shard
    to track)."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(pspec):
        for a in _flat_axes(axes):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def resolve_placements(shape: tuple[int, ...],
                       logical: tuple[str | None, ...], rules: Rules,
                       mesh) -> tuple:
    """`resolve_pspec` as DTensor placements over `mesh`."""
    return placements_of(resolve_pspec(shape, logical, rules, mesh), mesh)


def param_pspecs(layout: Layout, rules: Rules, mesh):
    return map_layout(
        layout, lambda p, _: resolve_pspec(p.shape, p.axes, rules, mesh))


def param_placements(layout: Layout, rules: Rules, mesh):
    return map_layout(
        layout, lambda p, _: resolve_placements(p.shape, p.axes, rules, mesh))


def block_at(shape, placements, mesh_shape, coord) -> tuple[tuple, tuple]:
    """(shape, global offset) of the block at mesh coordinate `coord` of a
    tensor of `shape` under `placements`: each mesh dimension that shards a
    dimension splits it evenly (the rules shard only what divides), the
    earlier mesh dimensions the outer splits, as DTensor and the reference
    lay them out."""
    size, offset = list(shape), [0] * len(shape)
    for pl, n, c in zip(placements, mesh_shape, coord):
        if pl.is_shard():
            d = pl.dim
            if size[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split into {n}")
            size[d] //= n
            offset[d] += c * size[d]
    return tuple(size), tuple(offset)


def local_block(shape, placements, mesh) -> tuple[tuple, tuple]:
    """(local shape, global offset) of this rank's block."""
    return block_at(shape, placements, mesh.shape, mesh.get_coordinate())


def local_of(full: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's block of `full` (a view)."""
    local, offset = local_block(full.shape, placements, mesh)
    return full[tuple(slice(o, o + n) for o, n in zip(offset, local))]


def as_dtensor(local: torch.Tensor, shape, placements, mesh):
    """A DTensor of global `shape` from this rank's block, no collective."""
    t = torch.empty(shape, device="meta")
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def distribute_tree(tree, placements, mesh):
    """Each full tensor of `tree` (the same values on every rank) as a
    DTensor of its placements in `placements` (a tree of the same keys):
    every rank keeps its own block, a contiguous copy, and nothing is
    sent between ranks."""
    return tree_map(lambda t, pl: as_dtensor(
        local_of(t, pl, mesh).contiguous(), t.shape, pl, mesh),
        tree, placements)


def to_local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (its storage); a tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Activation sharding constraints (no-op without a mesh)
# ---------------------------------------------------------------------------

class ShardCtx:
    """Carries (mesh, rules) through model code; `shard(x, *logical)` pins
    an activation's placements (`x.redistribute`, the counterpart of
    `with_sharding_constraint`).  Without a mesh (one device) it is a
    no-op."""

    def __init__(self, mesh, rules: Rules | None):
        self.mesh, self.rules = mesh, rules

    def shard(self, x: torch.Tensor, *logical: str | None) -> torch.Tensor:
        if self.mesh is None or self.rules is None:
            return x
        return x.redistribute(self.mesh, self.placements(x.shape, *logical))

    def placements(self, shape, *logical: str | None) -> tuple:
        return resolve_placements(tuple(shape), tuple(logical), self.rules,
                                  self.mesh)


NO_SHARD = ShardCtx(None, None)


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
    """A stack of the layout (`blocks`, ...): every leaf stacked on a
    leading layer axis and registered under its layout path
    (`blocks.attn.wq`).  `stack[i]` is layer i, `view` over the slices (the
    family's `Block`); iterating walks the layers in order; `stack["attn"]`
    is a stacked subtree.  A stack may hold no layer (the reduced configs
    make such stacks)."""

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
    """One family's model over a layout's tree: each top-level key of the
    layout is a `LayerStack` where `stack_layers` made it (every leaf's
    first axis is "layers"), else a `ParamTree`, or a parameter where the
    layout has a leaf at the top.  `views` gives a stack's layer view by
    key (`TensorView` by default; the dense and MoE families' `Block`);
    `forward` is the family's (`fn(model, cfg, tokens, **kw)`);
    `use_kernels` is the dispatch knob of the executor's config of that
    name (False runs every kernel's plain version).  Raises on a leaf of
    the layout missing from `tensors` or of another shape."""

    def __init__(self, cfg, layout: Layout, tensors: dict, forward: Callable,
                 views: dict[str, Callable[[dict], Any]] | None = None):
        check_tree(layout, tensors)
        super().__init__()
        self.cfg = cfg
        self.use_kernels = True
        self._forward = forward
        views = views or {}
        for key, lay in layout.items():
            if isinstance(lay, PDef):
                self.register_parameter(
                    key, nn.Parameter(tensors[key], requires_grad=False))
            elif _stacked(lay):
                self.add_module(key, LayerStack(
                    tensors[key], views.get(key, TensorView)))
            else:
                self.add_module(key, ParamTree(tensors[key]))

    def forward(self, tokens, **kw):
        return self._forward(self, self.cfg, tokens, **kw)


def _stacked(layout: Layout) -> bool:
    """Whether `stack_layers` made this subtree."""
    axes = []
    map_layout(layout, lambda p, _: axes.append(p.axes[:1]))
    return all(a == ("layers",) for a in axes)


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
                dtype: torch.dtype = torch.bfloat16, placements=None,
                mesh=None) -> dict:
    """Parameters of `layout` (a nested dict of tensors of its shapes):
    N(0, 1)·scale, zeros or ones as each PDef says, drawn from `generator`
    leaf by leaf in layout order, in `dtype` on `device` (the card unless
    the caller asks for the CPU).  The generator must live on that device.
    The reference draws from JAX keys, so the values differ; tests carry the
    reference's parameters over with `convert.params_from_jax`.  Over a
    `mesh`, each leaf is drawn whole (the same values as on one device)
    and only this rank's block of it in `placements` is kept, a DTensor:
    one whole leaf lives at a time."""
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

    if mesh is None:
        return map_layout(layout, make)

    def make_block(p: PDef, path):
        pl = placements
        for key in path:
            pl = pl[key]
        return distribute_tree(make(p, path), pl, mesh)

    return map_layout(layout, make_block)


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
