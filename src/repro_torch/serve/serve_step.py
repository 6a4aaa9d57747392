"""Serve-step builders: prefill and batched greedy decode, on one device or
over a (data, model) or (pod, data, model) mesh of ranks.

`build_decode_step` / `build_prefill` return the functions the serving
engine calls, with the device they run on; they run without autograd, so
a model a trainer has made trainable serves as a frozen one does.

The compiled decode step.  The reference jits its decode step; here, on
the card with `params.use_kernels`, the step is a CUDA graph under the
policy of `graph.CapturedStep`: its first call runs eagerly (the warm-up:
the histogram kernel's build and attributes, the dispatch plan's tables
uploaded), its second captures the step into a memory pool of its own and
replays it, and later calls copy the tokens and positions into the graph's
buffers and replay, launching nothing else from the host.  The binding is
the parameters and the cache it ran on (every family writes its cache in
place).  A call on other tensors (another cache; encdec's `enc_out` or
vlm's `vis` replaced by `api.prefill`) never replays it: that call frees
the graph and runs eagerly, and the next call on the same tensors
captures anew.  The step holds one graph at a time, and its next tokens
come back as a fresh tensor, which no later replay overwrites.  `ServeFns`
counts the calls run eagerly, the captures and the replays.  A capture
that fails raises.  The CPU and the plain versions (`use_kernels=False`)
run every call eagerly.
`build_prefill` stays eager (the reference jits it): a prefill's time is
mostly device work, which a graph does not shorten, and a graph for each
prompt shape would pin that shape's activations.

Over a mesh (`mesh=`, a DeviceMesh of `launch.mesh.make_lm_mesh`) the
builders are the reference's pjit builders.  The rules (`rules`, by
default `rules_for(cfg, mesh)`; for MoE decode, given or not, the
reference's override `embed=None, expert_ffn="data"`) give the parameters' placements
(`ServeFns.param_placements`) and the cache's (`cache_placements`: each
family's `cache_axes`, the rows over DP ("pod" and "data"), the KV or SSM heads over
"model", and where the KV heads cannot take "model", the sequence when
`max_seq` divides).  Tokens, positions and prompts are split over DP when
the batch divides, else replicated.  The step runs eagerly (no graph over
the ranks' collectives): `ServeFns` counts eager calls, no capture and no
replay.  The next token of each row is the lowest index of its maximum
over the vocabulary split over "model" (as `torch.argmax` over the whole
row), the same tensor on every rank; prefill's logits come back whole on
every rank.  The model code imports torch.distributed.tensor: it is
imported at a builder's first call, not with this module.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig
from ..core.executor import mesh_device, resolve_device
from ..graph import CapturedStep


@dataclass
class ServeFns:
    decode: Callable | None
    prefill: Callable | None
    device: torch.device
    batch: int | None = None       # decode: the slots the cache holds
    max_seq: int | None = None     # decode: the cache's length
    compiled: CapturedStep | None = None   # decode: its graph, its counters
    mesh: Any = None               # over a mesh: the DeviceMesh,
    rules: Any = None              # its rules,
    param_placements: Any = None   # the parameters' placements
    cache_placements: Any = None   # and the cache's (decode)

    @property
    def eager_calls(self) -> int:
        """Decode calls that ran eagerly."""
        return self.compiled.eager_calls

    @property
    def captures(self) -> int:
        """Decode graphs captured."""
        return self.compiled.captures

    @property
    def replays(self) -> int:
        """Decode calls answered by a replay."""
        return self.compiled.replays


def serve_rules(cfg: ArchConfig, mesh, decode: bool, rules=None):
    """The builders' rules: `rules` (by default `rules_for(cfg, mesh)`);
    MoE decode keeps the experts' contraction dimension whole and splits
    their hidden dimension over "data" instead, given rules too (decode
    moves weights more than activations: the reference's override)."""
    from ..models.common import rules_for
    rules = rules or rules_for(cfg, mesh)
    if decode and cfg.family == "moe":
        rules = rules.override(embed=None, expert_ffn="data")
    return rules


def _over_mesh(cfg: ArchConfig, mesh, rules, decode: bool) -> dict:
    """ServeFns' mesh fields (none without a mesh); raises where this rank
    is not in the mesh."""
    if mesh is None:
        return {}
    from ..models import api
    from ..models.common import param_placements
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    rules = serve_rules(cfg, mesh, decode, rules)
    return dict(mesh=mesh, rules=rules, param_placements=param_placements(
        api.layout(cfg), rules, mesh))


def _device(mesh, device) -> torch.device:
    """The builders' device: `device`, else over a mesh the rank's, else
    the card (`resolve_device`)."""
    return resolve_device(mesh_device(mesh) if device is None and mesh
                          is not None else device)


def build_decode_step(cfg: ArchConfig, batch: int, max_seq: int, *,
                      mesh=None, rules=None, device=None) -> ServeFns:
    """decode(params, cache, tokens (B,1), pos (B,)) -> (next token (B,)
    int32, cache): one step of every slot, greedy on the last position.
    The cache (the family's `init_cache` tree for `batch` slots and
    `max_seq` positions; over a mesh, DTensors of `cache_placements`) is
    updated in place; one of other shapes or placements is refused.  On
    the card with kernels and no mesh the step is a CUDA graph (tokens and
    positions copied into the graph's buffers)."""
    dev = _device(mesh, device)
    want = cache_shapes(cfg, batch, max_seq)
    placed = _over_mesh(cfg, mesh, rules, decode=True)
    from ..models import api
    from ..models.common import NO_SHARD, ShardCtx
    shd = NO_SHARD
    if mesh is not None:
        shd = ShardCtx(mesh, placed["rules"])
        placed["cache_placements"] = cache_placements(
            cfg, batch, max_seq, placed["rules"], mesh)

    def step(params, cache, tokens, pos):
        tokens, pos = tokens.to(dev), pos.to(dev)
        if mesh is not None:
            tokens, pos = _rows(tokens, shd), _rows(pos, shd)
        lg, _ = api.decode_step(params, cfg, cache, {"tokens": tokens}, pos,
                                shd)
        # Greedy sampling on the card: serving returns token ids, not logits.
        return greedy(lg[:, -1], shd)

    # The graph's next tokens are cloned: no later replay overwrites them.
    compiled = CapturedStep(step, dev, own=torch.Tensor.clone)

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        got = cache_shapes_of(cache)
        if not _fits(got, want):
            raise ValueError(f"cache of shapes {got}; the step was built for "
                             f"{batch} slots and {max_seq} positions: {want}")
        if mesh is not None:
            _check_placements(cache, placed["cache_placements"])
        return compiled((params, cache), (tokens, pos),
                        params.use_kernels and mesh is None), cache

    return ServeFns(decode=decode, prefill=None, device=dev, batch=batch,
                    max_seq=max_seq, compiled=compiled, **placed)


def greedy(lg: torch.Tensor, shd) -> torch.Tensor:
    """(B,) int32: the lowest index of each row's maximum of lg (B, V), as
    `torch.argmax`.  Over a mesh (lg a DTensor, its vocabulary split over
    "model" where it divides) each rank takes its block's first maximum;
    the largest of them (a partial max), then the lowest index among the
    ranks that hold it (a partial min), replicated on every rank."""
    if shd.mesh is None:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    from ..models.common import local_block
    mesh, pl = shd.mesh, lg.placements
    V = lg.shape[-1]
    lo = local_block(lg.shape, pl, mesh)[1][-1]
    rows = tuple(p if p.is_shard(0) else Replicate() for p in pl)

    def over(op: str) -> tuple:
        return tuple(Partial(op) if p.is_shard(1) else r
                     for p, r in zip(pl, rows))

    def first_of_top(x, top):
        at = torch.argmax(x, dim=-1) + lo        # the block's first maximum
        return torch.where(x.amax(dim=-1) == top, at, V)

    top = local_map(lambda x: x.amax(dim=-1), out_placements=(over("max"),),
                    in_placements=(pl,), device_mesh=mesh)(lg)
    first = local_map(first_of_top, out_placements=(over("min"),),
                      in_placements=(pl, rows), device_mesh=mesh)(
        lg, top.redistribute(mesh, rows))
    every = (Replicate(),) * mesh.ndim
    return first.redistribute(mesh, every).to_local().to(torch.int32)


def _rows(t: torch.Tensor, shd):
    """A global tensor (the same on every rank) as a DTensor split over DP
    on its leading (batch) dimension where that divides, else replicated:
    this rank's rows, no collective."""
    from ..models.common import as_dtensor, local_of
    pl = shd.placements(t.shape, "batch", *(None,) * (t.dim() - 1))
    return as_dtensor(local_of(t, pl, shd.mesh), t.shape, pl, shd.mesh)


def cache_placements(cfg: ArchConfig, batch: int, max_seq: int, rules,
                     mesh) -> dict:
    """The placements of each leaf of the family's `init_cache(cfg, batch,
    max_seq)` over `mesh` (the reference's `cache_shardings`): its
    `cache_axes` through the rules, a tree of the cache's keys (None where
    the cache holds None).  Where the KV heads cannot take the "model"
    axis (fewer heads than ranks, or heads that do not divide), the
    cache's sequence dimension takes it (a ring's window), provided it
    divides: attention contracts over it, and each rank attends its part
    of the positions (`layers.decode_attention_over_mesh`); without the
    fallback a long cache would be held whole on every model rank."""
    from ..models import api
    from ..models.common import _flat_axes, mesh_shape, placements_of, resolve_pspec
    model = mesh_shape(mesh)["model"]

    def resolve(shape, ax):
        if ax is None:
            return None
        if isinstance(ax, dict):
            return {k: resolve(shape[k], a) for k, a in ax.items()}
        spec = list(resolve_pspec(shape, ax, rules, mesh))
        if (len(ax) == 5 and "kv_heads" in ax
                and not any("model" in _flat_axes(a) for a in spec)
                and shape[2] % model == 0):
            spec += [None] * (5 - len(spec))
            spec[2] = "model"
        return placements_of(tuple(spec), mesh)

    return resolve(cache_shapes(cfg, batch, max_seq),
                   api.family_module(cfg).cache_axes(cfg))


def _check_placements(cache, want, key: str = "cache") -> None:
    from torch.distributed.tensor import DTensor
    if isinstance(want, dict):
        for k, pl in want.items():
            _check_placements(cache[k], pl, f"{key}/{k}")
        return
    if want is None:
        return
    if not isinstance(cache, DTensor) or tuple(cache.placements) != tuple(want):
        got = cache.placements if isinstance(cache, DTensor) else "a tensor"
        raise ValueError(f"cache leaf {key}: {got}; the step was built "
                         f"for {tuple(want)}")


def mesh_cache(cfg: ArchConfig, fns: ServeFns,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """The family's zeroed `init_cache` (in `dtype`, as its own) as
    DTensors of `fns.cache_placements` on `fns.device`: each rank
    allocates its own block alone."""
    from ..models import api
    from ..models.common import as_dtensor, local_block

    def block(t, pl):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: block(v, pl[k]) for k, v in t.items()}
        local = local_block(t.shape, pl, fns.mesh)[0]
        return as_dtensor(torch.zeros(local, dtype=t.dtype,
                                      device=fns.device), t.shape, pl,
                          fns.mesh)

    return block(api.init_cache(cfg, fns.batch, fns.max_seq, dtype,
                                device="meta"), fns.cache_placements)


def mesh_params(cfg: ArchConfig, params, fns: ServeFns):
    """`params` as a model of DTensors in `fns.param_placements` on
    `fns.device`: the reference's numpy tree (`convert.params_from_jax`)
    or a one-process model, each rank keeping its block of each tensor (on
    one rank the same storage)."""
    from ..models import api
    from ..models.common import as_dtensor, local_of
    from ..tree import tree_map
    mesh = fns.mesh
    if isinstance(params, dict):
        from ..models.convert import params_from_jax
        return params_from_jax(params, cfg, device=fns.device, mesh=mesh,
                               rules=fns.rules)

    def place(t, pl):
        t = t.detach().to(fns.device)
        return as_dtensor(local_of(t, pl, mesh).contiguous(), t.shape, pl,
                          mesh)

    model = api.build(cfg, tree_map(place, params.tree(),
                                    fns.param_placements))
    model.use_kernels = params.use_kernels
    return model


def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The shapes of the family's `init_cache(cfg, batch, max_seq)` tree
    (None where it holds None), from meta tensors."""
    from ..models import api
    return cache_shapes_of(api.init_cache(cfg, batch, max_seq,
                                          device="meta"))


def cache_shapes_of(cache):
    if isinstance(cache, dict):
        return {k: cache_shapes_of(v) for k, v in cache.items()}
    return None if cache is None else tuple(cache.shape)


def _fits(got, want, key: str = "") -> bool:
    """`got` has `want`'s keys and shapes; the one exception is encdec's
    `enc_out`, whose rows prefill sets to the prompt's S // enc_ratio."""
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(_fits(got[k], want[k], k) for k in want))
    if key == "enc_out" and got is not None:
        return got[0] == want[0] and got[2:] == want[2:]
    return got == want


def build_prefill(cfg: ArchConfig, *, mesh=None, batch_shapes=None,
                  rules=None, device=None) -> ServeFns:
    """prefill(params, batch) -> last-position logits (B, padded_vocab): a
    full forward over the prompts that never makes full-sequence logits.
    `batch_shapes` ({key: shape}), where given, is the only batch taken.
    Over a mesh the prompts are split as `build_decode_step`'s tokens and
    the logits come back whole, a tensor on every rank."""
    dev = _device(mesh, device)
    from ..models import api
    from ..models.common import NO_SHARD, ShardCtx
    api.family_module(cfg)
    placed = _over_mesh(cfg, mesh, rules, decode=False)
    shd = NO_SHARD if mesh is None else ShardCtx(mesh, placed["rules"])
    want = (None if batch_shapes is None else
            {k: tuple(s) for k, s in batch_shapes.items()})

    @torch.no_grad()
    def prefill_fn(params, batch):
        if want is not None and {k: tuple(v.shape) for k, v in
                                 batch.items()} != want:
            raise ValueError(f"batch of shapes "
                             f"{ {k: tuple(v.shape) for k, v in batch.items()} }"
                             f"; the prefill was built for {want}")
        if mesh is None:
            batch = {k: v.to(dev) for k, v in batch.items()}
            logits, _ = api.forward(params, cfg, batch, last_only=True)
            return logits[:, -1]
        batch = {k: _rows(torch.as_tensor(v).to(dev), shd)
                 for k, v in batch.items()}
        logits, _ = api.forward(params, cfg, batch, last_only=True, shd=shd)
        return logits[:, -1].full_tensor()

    return ServeFns(decode=None, prefill=prefill_fn, device=dev, **placed)
