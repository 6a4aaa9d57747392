"""AdamW with optional 8-bit (block-quantized) moment states.

The state tree is the reference package's, so that checkpoints
interchange: {"mu": <the parameter tree with {"m", "v"} (float32) or
{"m_q", "m_s", "v_q", "v_s"} (int8 with a float32 absmax scale per row of
the last axis) at each leaf>, "step": int32 scalar}.  The 8-bit mode keeps
v in the square-root domain, as the reference does.

`apply` updates the parameters and the state (its `step` too) in place.
It walks each leaf in slices of whole rows (`_SLICE` elements): `_q8`
scales each row over the last axis only, so a sliced update gives the same
bits as the reference's whole-leaf one while its float32 temporaries stay
a slice's size.

Over a mesh the parameters and gradients are DTensors and the states
inherit each parameter's placements (`state_placements`, the reference's
`state_pspecs`: ZeRO, optimizer memory shards exactly like FSDP weights),
but for an 8-bit scale, whose trailing axis of one replaces the quantised
last axis and is replicated.  `apply` works on each rank's local blocks:
its slices are rows of the rank's block, an 8-bit row's absmax is the max
over the ranks that split the row (one all-reduce a slice over the mesh
dimensions that shard the last axis), and `global_norm` sums each leaf's
squares over the ranks that hold its shards, once each.  Nothing is
gathered.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from ..models.common import as_dtensor, local_block, to_local
from ..tree import flatten, tree_map

# Elements of one slice of the update: each float32 temporary of a slice
# holds 128 MB.  The gradient norm sums its squares in slices of its own
# size, so the update's slicing never changes a bit.
_SLICE = 1 << 25
_NORM_SLICE = 1 << 25


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_bits: int = 32          # 32 | 8


def _q8(x: torch.Tensor, groups=()) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise absmax int8 quantization (last axis = row).  torch.round
    rounds half to even, as jnp.round does.  `groups`: the process groups
    over which a row is split (its absmax is the max over them)."""
    x32 = x.float()
    row_max = x32.abs().amax(dim=-1, keepdim=True)
    for group in groups:
        dist.all_reduce(row_max, op=dist.ReduceOp.MAX, group=group)
    scale = row_max / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as the reference's.  The
    card's `torch.sqrt` is; the CPU's vectorized one is not on every host
    (AVX-512: ~1 in 6 results an ulp off), so there it is taken in float64
    and rounded once, which gives the correctly rounded float32 root."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def state_pspecs(params_abstract, param_pspecs, cfg: AdamWConfig):
    """The states' specs in the reference's form (`common.resolve_pspec`'s
    tuples) mirroring the parameters': an 8-bit scale drops the sharding
    of the quantised last axis."""
    def mk(p, spec):
        if cfg.state_bits == 8:
            full = tuple(spec) + (None,) * (max(p.ndim, 1) - len(spec))
            scale = full[:-1] + (None,)
            return {"m_q": full, "m_s": scale, "v_q": full, "v_s": scale}
        return {"m": spec, "v": spec}

    return {"mu": tree_map(mk, params_abstract, param_pspecs), "step": ()}


def state_placements(params_abstract, param_placements, cfg: AdamWConfig):
    """Each state's DTensor placements: the parameter's, but for an 8-bit
    scale, replicated where the parameter's last axis is sharded; the
    step counter replicated."""
    def mk(p, pl):
        if cfg.state_bits == 8:
            last = max(p.ndim, 1) - 1
            scale = tuple(Replicate() if x.is_shard(last) else x for x in pl)
            return {"m_q": pl, "m_s": scale, "v_q": pl, "v_s": scale}
        return {"m": pl, "v": pl}

    first = next(iter(flatten(param_placements).values()))
    return {"mu": tree_map(mk, params_abstract, param_placements),
            "step": (Replicate(),) * len(first)}


def init(params, cfg: AdamWConfig):
    """Zeroed states beside each parameter (on its device); a meta tensor
    gives meta states, the shapes alone.  DTensor parameters give DTensor
    states of `state_placements`, each rank's block allocated alone."""
    leaf = next(iter(flatten(params).values()))
    if isinstance(leaf, DTensor):
        return _init_over_mesh(params, cfg, leaf.device_mesh,
                               leaf.to_local().device)

    def mk(p):
        if cfg.state_bits == 8:
            shape = tuple(p.shape) if p.ndim else (1,)
            zeros = lambda s, dt: torch.zeros(s, dtype=dt, device=p.device)
            return {"m_q": zeros(shape, torch.int8),
                    "m_s": zeros(shape[:-1] + (1,), torch.float32),
                    "v_q": zeros(shape, torch.int8),
                    "v_s": zeros(shape[:-1] + (1,), torch.float32)}
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    dev = leaf.device
    return {"mu": tree_map(mk, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _init_over_mesh(params, cfg: AdamWConfig, mesh, dev) -> dict:
    def zeros(shape, dtype, pl):
        local, _ = local_block(shape, pl, mesh)
        return as_dtensor(torch.zeros(local, dtype=dtype, device=dev), shape,
                          pl, mesh)

    placements = state_placements(params, tree_map(lambda p: p.placements,
                                                    params), cfg)

    def mk(p, pl):
        if cfg.state_bits == 8:
            shape = tuple(p.shape) if p.ndim else (1,)
            scale = shape[:-1] + (1,)
            return {"m_q": zeros(shape, torch.int8, pl["m_q"]),
                    "m_s": zeros(scale, torch.float32, pl["m_s"]),
                    "v_q": zeros(shape, torch.int8, pl["v_q"]),
                    "v_s": zeros(scale, torch.float32, pl["v_s"])}
        return {k: zeros(tuple(p.shape), torch.float32, pl[k])
                for k in ("m", "v")}

    return {"mu": tree_map(mk, params, placements["mu"]),
            "step": zeros((), torch.int32, placements["step"])}


def _shard_groups(t: torch.Tensor, dim: int | None = None) -> list:
    """The process groups of the mesh dimensions of more than one rank
    that shard DTensor `t` (along `dim` only, when given); none for a
    tensor."""
    if not isinstance(t, DTensor):
        return []
    mesh = t.device_mesh
    return [mesh.get_group(i) for i, pl in enumerate(t.placements)
            if mesh.size(i) > 1
            and (pl.is_shard(dim) if dim is not None else pl.is_shard())]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as (rows, last axis) — a view; a scalar is one row of one."""
    return t.reshape(-1, t.shape[-1]) if t.ndim else t.reshape(1, 1)


def _slices(rows: torch.Tensor, size: int):
    step = max(1, size // max(rows.shape[1], 1))
    for lo in range(0, rows.shape[0], step):
        yield slice(lo, lo + step)


def global_norm(grads) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²), in float32, leaf by leaf in the
    reference's order; each leaf's squares are summed a slice at a time, so
    no float32 copy of a whole leaf is made.  Over a mesh each rank sums
    its blocks; the leaves sharded over the same mesh dimensions add up
    first and their sum is all-reduced over those dimensions, so every
    shard counts once and a replicated leaf is not counted again."""
    total = None
    by_groups: dict[tuple, torch.Tensor] = {}
    for g in flatten(grads).values():
        rows = _rows(to_local(g))
        sq = sum(torch.sum(rows[sl].float() ** 2) for sl in _slices(rows, _NORM_SLICE))
        groups = tuple(_shard_groups(g))
        if groups:
            by_groups[groups] = (sq if groups not in by_groups
                                 else by_groups[groups] + sq)
        else:
            total = sq if total is None else total + sq
    for groups, sq in by_groups.items():
        for group in groups:
            dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply(params, state, grads, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step, in place, the state's step counter too (a captured
    train step replaces no tensor it was given); returns (params, state,
    metrics)."""
    step = to_local(state["step"]).add_(1)
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip else 1.0)
    step32 = step.float()
    b1c = 1.0 - torch.full_like(step32, cfg.b1) ** step32
    b2c = 1.0 - torch.full_like(step32, cfg.b2) ** step32
    lr = cfg.lr * lr_scale

    def upd(p_s, g_s, mu_s):
        """One slice: its new parameters and states (float32 math)."""
        g = g_s.float() * clip
        if cfg.state_bits == 8:
            m = _dq8(mu_s["m_q"], mu_s["m_s"])
            # v is stored in sqrt domain: linear int8 rounds small second
            # moments to zero and the 1/sqrt(v) update explodes.
            v = _dq8(mu_s["v_q"], mu_s["v_s"]) ** 2
        else:
            m, v = mu_s["m"], mu_s["v"]
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        upd32 = (m / b1c) / (_sqrt(v / b2c) + cfg.eps)
        upd32 = upd32 + cfg.weight_decay * p_s.float()
        p_s.copy_((p_s.float() - lr * upd32).to(p_s.dtype))
        if cfg.state_bits == 8:
            m_q, m_s = q8(m)
            v_q, v_s = q8(_sqrt(v))
            return {"m_q": m_q, "m_s": m_s, "v_q": v_q, "v_s": v_s}
        return {"m": m, "v": v}

    flat_g = flatten(grads)
    flat_mu = flatten(state["mu"])
    for key, p in flatten(params).items():
        g = flat_g[key]
        if isinstance(p, DTensor) and g.placements != p.placements:
            raise ValueError(f"gradient of {key} in {g.placements}, its "
                             f"parameter in {p.placements}")
        groups = _shard_groups(p, max(p.ndim, 1) - 1)
        q8 = partial(_q8, groups=groups) if groups else _q8
        mu = {k: _rows(to_local(flat_mu[f"{key}/{k}"])) for k in
              (("m_q", "m_s", "v_q", "v_s") if cfg.state_bits == 8
               else ("m", "v"))}
        p_rows, g_rows = _rows(to_local(p)), _rows(to_local(g))
        for sl in _slices(p_rows, _SLICE):
            new = upd(p_rows[sl], g_rows[sl], {k: v[sl] for k, v in mu.items()})
            for k, v in new.items():
                mu[k][sl].copy_(v)
    return params, state, {"grad_norm": gnorm}
