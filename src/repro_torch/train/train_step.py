"""Train-step builder: loss, microbatch accumulation, optimizer.

`build_train_step(cfg, ...)` returns a StepFns bundle:
  * `step(model, opt_state, batch) -> (model, opt_state, metrics)`, which
    updates the model's parameters and the state in place,
  * abstract params / opt-state (meta tensors — no allocation), which a
    checkpoint restore reads shapes and dtypes from,
  * the layout and the device.

The arithmetic is the reference's (`repro/train/train_step.py`); its mesh,
sharding rules and donation have no counterpart on one card.  The
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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig
from ..core.executor import resolve_device
from ..graph import CapturedStep
from ..models import api
from ..models.common import map_layout
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


def loss_fn(params, cfg: ArchConfig, batch: dict):
    """(total loss, metrics) of a batch {tokens, labels} (B,S) int32."""
    logits, aux = api.forward(params, cfg, batch)
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


def build_train_step(
    cfg: ArchConfig,
    opt_cfg: adamw.AdamWConfig | None = None,
    n_micro: int = 1,
    total_steps: int = 10_000,
    warmup_steps: int = 200,
    *,
    device=None,
) -> StepFns:
    """The step on `device` (the card unless the caller asks for the CPU);
    batches may come as numpy arrays or tensors on any device."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    layout = api.layout(cfg)
    params_abs = map_layout(layout, lambda p, _: torch.empty(
        p.shape, dtype=getattr(torch, cfg.param_dtype), device="meta"))
    opt_abs = adamw.init(params_abs, opt_cfg)

    def grads_of(model, tree, batch):
        for p in flatten(tree).values():
            p.grad = None
        total, metrics = loss_fn(model, cfg, batch)
        total.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), tree)
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
                mb = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                   *v.shape[1:]) for k, v in batch.items()}
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), tree)
                ms = []
                for i in range(n_micro):
                    g, m = grads_of(model, tree, {k: v[i] for k, v in mb.items()})
                    tree_map(lambda a, b: a.add_(b.float()), grads, g)
                    ms.append(m)
                grads = tree_map(lambda g: g / n_micro, grads)
                metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                           for k in ms[0]}

        lr_scale = warmup_cosine(opt_state["step"], warmup=warmup_steps,
                                 total=total_steps)
        _, _, opt_metrics = adamw.apply(tree, opt_state, grads, opt_cfg,
                                        lr_scale)
        return {**metrics, **opt_metrics, "lr_scale": lr_scale}

    # A graph's metrics are cloned: no later replay overwrites them.
    compiled = CapturedStep(run, dev, own=lambda m: {k: v.clone()
                                                     for k, v in m.items()})

    def step(model, opt_state, batch):
        keys = tuple(batch)
        values = tuple(torch.as_tensor(v) for v in batch.values())
        metrics = compiled((model, opt_state, keys), values,
                           model.use_kernels)
        return model, opt_state, metrics

    return StepFns(step=step, params_abstract=params_abs,
                   opt_abstract=opt_abs, layout=layout, device=dev,
                   compiled=compiled)
