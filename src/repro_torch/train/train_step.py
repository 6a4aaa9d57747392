"""Train-step builder: loss, microbatch accumulation, optimizer.

`build_train_step(cfg, ...)` returns a StepFns bundle:
  * `step(model, opt_state, batch) -> (model, opt_state, metrics)`, which
    updates the model's parameters and the state in place,
  * abstract params / opt-state (meta tensors — no allocation), which a
    checkpoint restore reads shapes and dtypes from,
  * the layout and the device.

The arithmetic is the reference's (`repro/train/train_step.py`); its
donation has no counterpart (the step updates in place).  The
gradient of every parameter is computed by autograd over the model's
layout-shaped tree (`model.tree()`, leaves with `requires_grad` on); the
stacked leaves get theirs slice by slice (`common.take_layer`).
Microbatching: the batch splits into `n_micro` slices along its leading
axis; their gradients accumulate in float32 and the metrics are means.

The compiled step.  The reference jits its step; here, on the card with
`model.use_kernels`, the whole step is one CUDA graph under the policy of
`graph.CapturedStep`, shared with the join and decode steps: the forward,
each layer's recompute (`remat="full"`), the backward, the microbatch
loop, the gradient norm, the sliced update and the schedule on the state's
step counter.  The binding is the parameters and the optimizer state
(addresses, shapes, strides, dtypes) and the batch's keys, shapes and
dtypes.  A binding's first call runs eagerly, its second captures the step
into a pool of its own and replays it, later calls copy the batch into the
graph's buffers (outside the captured region: nothing is uploaded from the
host inside it) and replay.  The step replaces none of the tensors it is
given (the update and the step counter are in place), so the driver and
the checkpointer read them where they lie; a restored model or state is
another binding, which runs eagerly once and then captures anew.  The
metrics come back as clones, which no later replay overwrites.  A capture
that fails raises.  The CPU and `use_kernels=False` run every call eagerly:
that is the reference.  `StepFns.compiled` holds the graph and its
counters (`eager_calls`, `captures`, `replays`).

Over a mesh (`mesh=`, a 2-D ("data", "model") or 3-D ("pod", "data",
"model") DeviceMesh from `launch.mesh.make_lm_mesh`, or the dry run's
`fake_world`) the step is the reference's pjit step: the
rules (`default_rules(mesh)` overridden by `cfg.sharding_hints`, or
`rules=`) give the parameters', states' and batch's placements
(`StepFns.param_placements`, `opt_placements`, `batch_placements`): DP
over ("pod", "data") (the batch's rows split pod-major), FSDP over
"data", TP over "model", expert slots over "model"; "pod" splits no
parameter, so each gradient is summed over it.  The model's parameters are DTensors of those placements
(`models.common.distribute_tree`, `convert.params_from_jax(mesh=)`), the
batch is distributed by the step (every rank gives the same global batch
and keeps its rows; a microbatch is the same rows of it as in the
reference), the model runs on DTensors with its activations pinned
(`ShardCtx`), each gradient is brought to its parameter's placements,
and the optimizer updates each rank's blocks.  The loss stays local to
each rank's vocabulary shard: the log-sum-exp from per-rank maxima and
sums, the label's logit taken on the rank that holds it, each summed over
"model"; the logits are never gathered.  A mesh step runs eagerly (a
graph over the ranks' collectives is later work), under the same
counters.  The metrics come back as plain tensors, equal on every rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..core.executor import mesh_device, resolve_device
from ..graph import CapturedStep
from ..models import api
from ..models.common import (NO_SHARD, Rules, ShardCtx, as_dtensor,
                             local_block, local_of, map_layout, mesh_shape,
                             param_placements, placements_of, rules_for)
from ..optim import adamw
from ..optim.schedule import warmup_cosine
from ..tree import flatten, tree_map


@dataclass
class StepFns:
    step: Callable                    # (model, opt, batch) -> ...
    params_abstract: Any
    opt_abstract: Any
    layout: Any
    device: torch.device
    compiled: CapturedStep            # the step's graph and its counters
    mesh: Any = None                  # over a mesh: the DeviceMesh,
    rules: Rules | None = None        # its rules and the placements of
    param_placements: Any = None      # the parameters, the optimizer
    opt_placements: Any = None        # state and (a function of the
    batch_placements: Any = None      # batch's shapes) the batch


def loss_fn(params, cfg: ArchConfig, batch: dict, shd: ShardCtx = NO_SHARD):
    """(total loss, metrics) of a batch {tokens, labels} (B,S) int32."""
    logits, aux = api.forward(params, cfg, batch, shd=shd)
    if shd.mesh is not None:
        with api.mesh_context(shd):
            return _mesh_loss(logits, aux, batch["labels"], shd)
    lg32 = logits.float()
    # logsumexp over the padded vocab (pad columns are NEG_INF) minus the
    # label's logit: a gather equals the reference's one-hot contraction
    # bit for bit (every other term of it is an exact zero).
    lse = torch.logsumexp(lg32, dim=-1)                            # (B,S)
    ll = torch.gather(lg32, -1, batch["labels"].long()[..., None])[..., 0]
    loss = (lse - ll).mean()
    # z-loss keeps the softmax normalizer bounded (production stability trick).
    zloss = 1e-4 * torch.mean(lse ** 2)
    total = loss + zloss + 0.01 * aux.get("aux_loss", 0.0)
    metrics = {"loss": loss.detach(), "zloss": zloss.detach()}
    if "expert_load" in aux:
        metrics["expert_load"] = aux["expert_load"].float()
    return total, metrics


def _mesh_loss(logits, aux: dict, labels, shd: ShardCtx):
    """`loss_fn`'s terms over a mesh, vocab-local: logits (B,S,V) sharded
    over "model" along V are never gathered.  The log-sum-exp is the
    maximum over every shard (detached, as logsumexp's own shift) plus the
    log of the shards' summed exponentials (where V is not sharded, each
    rank's `logsumexp`); the label's logit is taken on the rank whose
    shard holds it and summed over "model".  The total is
    replicated, so its backward starts from one everywhere."""
    mesh = shd.mesh
    lg32 = logits.float()
    rows = shd.placements(labels.shape, "batch", "act_seq")
    logit_pl = lg32.placements
    if any(pl.is_shard(2) for pl in logit_pl):
        m = lg32.detach().amax(dim=-1, keepdim=True).redistribute(mesh, rows)
        m = torch.where(torch.isfinite(m), m, 0.0)
        sumexp = torch.exp(lg32 - m).sum(dim=-1)
        lse = (torch.log(sumexp.redistribute(mesh, rows))
               + m[..., 0].redistribute(mesh, rows))
    else:                     # each rank holds its rows' whole vocabulary
        lse = torch.logsumexp(lg32, dim=-1).redistribute(mesh, rows)
    lo = local_block(lg32.shape, logit_pl, mesh)[1][-1]

    def label_logit(lg, lab):
        idx = lab.long() - lo
        mine = (idx >= 0) & (idx < lg.shape[-1])
        got = torch.gather(lg, -1, torch.where(mine, idx, 0)[..., None])
        return torch.where(mine, got[..., 0], 0.0)

    vocab_split = tuple(Partial() if pl.is_shard(2) else r
                        for pl, r in zip(logit_pl, rows))
    ll = local_map(label_logit, out_placements=(vocab_split,),
                   in_placements=(logit_pl, rows), device_mesh=mesh,
                   redistribute_inputs=True)(
        lg32, labels.redistribute(mesh, rows)).redistribute(mesh, rows)
    every = (Replicate(),) * mesh.ndim
    loss = (lse - ll).mean().redistribute(mesh, every)
    zloss = 1e-4 * torch.mean(lse ** 2).redistribute(mesh, every)
    total = loss + zloss
    if "aux_loss" in aux:
        total = total + 0.01 * aux["aux_loss"].redistribute(mesh, every)
    metrics = {"loss": loss.detach(), "zloss": zloss.detach()}
    if "expert_load" in aux:
        metrics["expert_load"] = aux["expert_load"].redistribute(
            mesh, every).float()
    return total, metrics


def batch_placements(batch_abstract: dict, rules: Rules, mesh) -> dict:
    """Every batch input shards on its leading (global-batch) axis over DP
    (replicated when the batch doesn't divide — e.g. long_500k's batch of
    1), as one placement a mesh dimension; `batch_abstract` maps each key
    to anything with a `.shape`."""
    return {k: placements_of(spec, mesh) for k, spec in
            batch_pspecs(batch_abstract, rules, mesh).items()}


def batch_pspecs(batch_abstract: dict, rules: Rules, mesh) -> dict:
    """The batch's specs in the reference's form (`batch_shardings`')."""
    sizes = mesh_shape(mesh)
    dp_size = math.prod(sizes[a] for a in rules.dp_axes)
    return {k: ((rules.dp_axes if v.shape[0] % dp_size == 0 else None),)
            + (None,) * (len(v.shape) - 1)
            for k, v in batch_abstract.items()}


def build_train_step(
    cfg: ArchConfig,
    opt_cfg: adamw.AdamWConfig | None = None,
    n_micro: int = 1,
    total_steps: int = 10_000,
    warmup_steps: int = 200,
    *,
    device=None,
    mesh=None,
    rules: Rules | None = None,
) -> StepFns:
    """The step on `device` (the card unless the caller asks for the CPU;
    over a `mesh`, the rank's device by default); batches may come as
    numpy arrays or tensors on any device.  Over a mesh `rules` default to
    `default_rules(mesh)` overridden by `cfg.sharding_hints`
    (`common.rules_for`); `StepFns.batch_placements(batch_abstract)` gives
    a batch's placements ({key: anything with a `.shape`})."""
    dev = resolve_device(mesh_device(mesh) if device is None and mesh
                         is not None else device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    layout = api.layout(cfg)
    params_abs = map_layout(layout, lambda p, _: torch.empty(
        p.shape, dtype=getattr(torch, cfg.param_dtype), device="meta"))
    opt_abs = adamw.init(params_abs, opt_cfg)
    shd = NO_SHARD
    placements = {}
    if mesh is not None:
        if mesh.get_coordinate() is None:
            raise ValueError("this rank is not in the mesh")
        rules = rules or rules_for(cfg, mesh)
        shd = ShardCtx(mesh, rules)
        p_pl = param_placements(layout, rules, mesh)
        placements = dict(
            mesh=mesh, rules=rules, param_placements=p_pl,
            opt_placements=adamw.state_placements(params_abs, p_pl, opt_cfg),
            batch_placements=partial(batch_placements, rules=rules,
                                     mesh=mesh))

    def distribute(batch: dict) -> dict:
        """A global batch's rows of this rank, as DTensors (over a mesh)."""
        if mesh is None:
            return batch
        pl = batch_placements(batch, rules, mesh)
        return {k: as_dtensor(local_of(v, pl[k], mesh), v.shape, pl[k], mesh)
                for k, v in batch.items()}

    def grads_of(model, tree, batch):
        for p in flatten(tree).values():
            p.grad = None
        total, metrics = loss_fn(model, cfg, distribute(batch), shd)
        with api.mesh_context(shd):
            total.backward()
        grads = tree_map(_grad_of, tree)
        for p in flatten(tree).values():
            p.grad = None
        return grads, metrics

    def run(model, opt_state, keys, *values):
        batch = {k: v.to(dev) for k, v in zip(keys, values)}
        tree = model.tree()
        model.requires_grad_(True)
        with torch.enable_grad():
            if n_micro == 1:
                grads, metrics = grads_of(model, tree, batch)
            else:
                # Microbatch i: rows [i·B/n, (i+1)·B/n) of the batch.
                mb = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                   *v.shape[1:]) for k, v in batch.items()}
                grads = tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), tree)
                ms = []
                for i in range(n_micro):
                    g, m = grads_of(model, tree, {k: v[i] for k, v in mb.items()})
                    tree_map(lambda a, b: a.add_(b.float()), grads, g)
                    ms.append(m)
                grads = tree_map(lambda g: g / n_micro, grads)
                metrics = {k: torch.stack([_plain(m[k]) for m in ms]).mean(0)
                           for k in ms[0]}

        lr_scale = warmup_cosine(_plain(opt_state["step"]),
                                 warmup=warmup_steps, total=total_steps)
        _, _, opt_metrics = adamw.apply(tree, opt_state, grads, opt_cfg,
                                        lr_scale)
        return {**{k: _plain(v) for k, v in metrics.items()}, **opt_metrics,
                "lr_scale": lr_scale}

    # A graph's metrics are cloned: no later replay overwrites them.
    compiled = CapturedStep(run, dev, own=lambda m: {k: v.clone()
                                                     for k, v in m.items()})

    def step(model, opt_state, batch):
        keys = tuple(batch)
        values = tuple(torch.as_tensor(v) for v in batch.values())
        metrics = compiled((model, opt_state, keys), values,
                           model.use_kernels and mesh is None)
        return model, opt_state, metrics

    return StepFns(step=step, params_abstract=params_abs,
                   opt_abstract=opt_abs, layout=layout, device=dev,
                   compiled=compiled, **placements)


def _grad_of(p: torch.Tensor) -> torch.Tensor:
    """p's gradient (zeros where it has none), over a mesh in p's own
    placements (autograd leaves a DTensor's where its last op put it)."""
    if p.grad is None:
        return torch.zeros_like(p)
    if isinstance(p, DTensor) and p.grad.placements != p.placements:
        return p.grad.redistribute(p.device_mesh, p.placements)
    return p.grad


def _plain(t):
    """A replicated DTensor's value as a tensor (a tensor as it is)."""
    return t.to_local() if isinstance(t, DTensor) else t
