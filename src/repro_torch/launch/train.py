"""End-to-end training driver: data -> step -> metrics -> checkpoints -> FT.

The reference's loop (`repro/launch/train.py`) on one card:
  * deterministic restartable data pipeline (step-indexed),
  * the train step from train/train_step.py,
  * async checkpointing every --ckpt-every steps,
  * straggler watchdog + health monitor hooks (simulated failure injection
    via --fail-at-step exercises the elastic path end to end on a logical
    mesh of 8 ranks, ft/elastic.py),
  * MoE: SkewShares dispatch re-planning when observed expert skew drifts
    (printed, not fed into the step, as in the reference).

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --device cpu --steps 20 --batch 8 --seq 64
Without --device it runs on the card and refuses to start without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from ..ckpt.checkpoint import Checkpointer
from ..configs import get
from ..core.executor import resolve_device
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..ft import (HealthMonitor, StragglerWatchdog, logical_mesh,
                  survivors_mesh)
from ..models import api
from ..models.common import count_params
from ..optim import AdamWConfig, adamw
from ..train import build_train_step


def frontend_shapes(cfg, batch: int, seq: int) -> dict:
    """The stub frontends' inputs of the family (bf16), by key: encdec's
    `frames`, vlm's `vision_emb`."""
    if cfg.family == "encdec":
        return {"frames": (batch, max(seq // cfg.enc_ratio, 1), cfg.d_model)}
    if cfg.family == "vlm":
        return {"vision_emb": (batch, cfg.vision_tokens, cfg.vision_dim)}
    return {}


def make_batch(cfg, pipe, step, rng, device) -> dict:
    """The pipeline's tokens and labels at `step`, and the stub frontends'
    inputs drawn from `rng` (one generator for the whole run, as the
    reference's: `standard_normal` in float32, then bf16 on the device)."""
    data = pipe.global_batch_at(step)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in data.items()}
    c = pipe.cfg
    for k, shape in frontend_shapes(cfg, c.global_batch, c.seq_len).items():
        out[k] = torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(device).to(torch.bfloat16)
    return out


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--n-micro", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--opt-bits", type=int, default=32)
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--fail-at-step", type=int, default=None,
                   help="simulate a node failure at this step (FT demo)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; refuses to start without a card) "
                        "or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat="none" if args.reduced else cfg.remat)
    mesh = logical_mesh()
    opt_cfg = AdamWConfig(lr=args.lr, state_bits=args.opt_bits)
    # The step does not depend on the mesh (the global batch is the same at
    # any DP degree), so a re-mesh keeps it.
    fns = build_train_step(cfg, opt_cfg=opt_cfg, n_micro=args.n_micro,
                           device=dev)
    print(f"arch={cfg.name} params={count_params(fns.layout)/1e6:.1f}M "
          f"mesh={dict(mesh.shape)}")

    ckptr = Checkpointer(args.ckpt_dir)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, args.seq, args.batch))
    rng = np.random.default_rng(0)
    watchdog = StragglerWatchdog(n_nodes=mesh.size)
    health = HealthMonitor(n_nodes=mesh.size)

    def restore(step):
        state = ckptr.restore(step, {"params": fns.params_abstract,
                                     "opt": fns.opt_abstract}, dev)
        return api.build(cfg, state["params"]), state["opt"]

    start = 0
    if args.resume and ckptr.latest_step() is not None:
        start = ckptr.latest_step()
        model, opt = restore(start)
        print(f"resumed from step {start}")
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        model = api.init_model(cfg, gen, device=dev)
        opt = adamw.init(model.tree(), opt_cfg)

    expert_loads = None
    for step in range(start, args.steps):
        if args.fail_at_step is not None and step == args.fail_at_step:
            # ---- simulated node failure -> elastic restart path -------------
            print(f"[FT] injecting node failure at step {step}")
            health.inject_failure(0)
            ckptr.wait()
            last = ckptr.latest_step()
            if last is None:
                ckptr.save(step, {"params": model.tree(), "opt": opt},
                           blocking=True)
                last = step
            new_mesh = survivors_mesh(mesh, failed_dp_rows=[0])
            print(f"[FT] re-meshing {dict(mesh.shape)} -> {dict(new_mesh.shape)}"
                  f", restoring step {last}")
            mesh = new_mesh
            del model, opt
            model, opt = restore(last)
            args.fail_at_step = None

        t0 = time.time()
        batch = make_batch(cfg, pipe, step, rng, dev)
        model, opt, metrics = fns.step(model, opt, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        watchdog.record_step(np.full(watchdog.n_nodes, dt))
        for n in health.healthy_nodes():
            health.heartbeat(n)

        if cfg.family == "moe" and "expert_load" in metrics:
            loads = metrics["expert_load"].cpu().numpy()
            expert_loads = loads if expert_loads is None else \
                0.9 * expert_loads + 0.1 * loads
            # Re-plan when the hottest expert is >2x the mean (SkewShares).
            if expert_loads.max() > 2.0 * max(expert_loads.mean(), 1e-9):
                from ..models.moe import build_plan
                plan = build_plan(cfg, expert_loads)
                if plan.group_size.max() > 1:
                    print(f"[moe] skew detected (max/mean="
                          f"{expert_loads.max()/expert_loads.mean():.2f}); "
                          f"replicas={dict(enumerate(plan.group_size)) }")

        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  {dt*1000:.0f}ms")
        if step > start and step % args.ckpt_every == 0:
            ckptr.save(step, {"params": model.tree(), "opt": opt})
    t0 = time.time()
    ckptr.save(args.steps, {"params": model.tree(), "opt": opt}, blocking=True)
    print(f"[ckpt] final save (blocking) {time.time() - t0:.2f} s")
    print("done; final checkpoint at", args.steps)


if __name__ == "__main__":
    main()
