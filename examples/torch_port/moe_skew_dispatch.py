"""MoE hot-expert demo of the PyTorch + CUDA port: the paper's technique at
the expert-parallel layer.

A skewed router makes one expert "heavy"; classical EP assigns it one device
(the Example-1.1 straggler).  The SkewShares planner gives it 2^j replica
slots and hash-splits its tokens (Example 1.2's grid), collapsing the
straggle.  Shows plan + measured per-slot loads through the real MoE layer
(its expert loads counted by the segment_histogram kernel on the card).

Run:  PYTHONPATH=src python examples/torch_port/moe_skew_dispatch.py
      [--device cuda|cpu]   (default cuda; without a card it raises)
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.executor import resolve_device
from repro_torch.core.moe_shares import (dispatch_cost, plan_dispatch,
                                         route_tokens)
from repro_torch.models import moe
from repro_torch.models.common import init_params

T = 10_000       # the hot expert's tokens in the split


def config():
    return dataclasses.replace(ARCHS["mixtral-8x22b"].reduced(), n_layers=1,
                               moe_slot_factor=1.5)


def main(device: str = "cuda", params: dict | None = None,
         x: torch.Tensor | None = None) -> dict:
    """The plans, their dispatch costs, the layer's expert loads on `x`
    (4 x 64 tokens) and the hot expert's split; `params` (the MoE layer's
    tensors) and `x` default to seeded random ones on `device`.  Returns
    them all."""
    cfg = config()
    E, slots = cfg.n_experts, cfg.n_slots()
    dev = resolve_device(device)

    # Skewed observed loads: expert 0 takes ~50% of all tokens.
    loads = np.r_[[4000.0], np.random.default_rng(0).uniform(40, 120, E - 1)]
    classical = plan_dispatch(loads, E)
    skew = plan_dispatch(loads, slots)
    weight_cost = 3 * cfg.d_model * cfg.d_ff
    c = dispatch_cost(loads, classical, weight_cost=weight_cost)
    s = dispatch_cost(loads, skew, weight_cost=weight_cost)
    print(f"{E} experts, loads: hot={loads[0]:.0f} others~80")
    print(f"classical EP : max slot load {c['max_slot_load']:.0f} "
          f"(imbalance {c['imbalance']:.1f})")
    print(f"SkewShares   : max slot load {s['max_slot_load']:.0f} "
          f"(imbalance {s['imbalance']:.1f}), "
          f"hot expert gets {int(skew.group_size[0])} replicas\n")

    # Route real tokens through the layer with the skewed plan.
    g = torch.Generator(device=dev).manual_seed(0)
    if params is None:
        params = init_params(moe.moe_layout(cfg), g, device=dev)
    if x is None:
        x = torch.randn((4, 64, cfg.d_model), generator=g, device=dev
                        ).to(torch.bfloat16)
    y, stats = moe.moe_ffn(params, cfg, skew, x)
    load = stats["expert_load"].cpu().numpy()
    print(f"moe_ffn out: {tuple(y.shape)}, "
          f"dropped_tokens={int(stats['dropped_tokens'])}")
    print(f"expert load histogram (segment_histogram): {load}")

    # Show the hash split of the hot expert's tokens across its replicas.
    slots_of = route_tokens(skew, torch.zeros(T, dtype=torch.int32,
                                              device=dev),
                            torch.arange(T, dtype=torch.int32, device=dev))
    uniq, cnt = np.unique(slots_of.cpu().numpy(), return_counts=True)
    print(f"hot expert's {T} tokens split over slots {uniq.tolist()} "
          f"-> counts {cnt.tolist()}")
    return dict(loads=loads, classical=classical, skew=skew,
                classical_cost=c, skew_cost=s, expert_load=load,
                dropped_tokens=int(stats["dropped_tokens"]),
                split=(uniq, cnt))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
