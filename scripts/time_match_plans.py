#!/usr/bin/env python3
"""Time the PyTorch + CUDA port's match_counts and first_match on one
NVIDIA GPU over the plans around the one `kernels/build_probe.py::
match_plan` picks.

    python3 scripts/time_match_plans.py

Pairs (n_p, n_b) at the kernel library's shapes and at the edges of the
plan: the tail cell's 16,287 x 16,287 (keys over 8,192 values: about two
matches a probe), the random 16,384 x 4,096 (30-bit keys), the heavy
cell's 1,536 x 767 (one key), 2^21 x 3,000 (n_p >> n_b) and 300,000 x
17,919 (the shared arm's largest build side).  Keys come from a seeded
generator on the card.  For each pair: the shared arm with P = 1 to 128
partitions (P = 1: every block builds the whole table) at its default
table and at load 0.7, each with as many probe slices as the SMs hold
blocks beside the partitions; the device arm; and the default plan.  Each
output is held against the plain version (`torch.equal`); then the device
time a call of each kernel (torch.profiler: kernels and memsets) is
printed, and one JSON line of them.  Exits non-zero without a CUDA device
or when an output differs.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PAIRS = {"tail": (16287, 16287, 1 << 13), "random": (16384, 4096, 1 << 30),
         "heavy": (1536, 767, 1), "np>>nb": (1 << 21, 3000, 1 << 12),
         "limit": (300000, 17919, 1 << 15)}


def plans(bpr, n_p: int, n_b: int) -> dict:
    """Named (arm, slots, pbits, blocks) plans for one pair."""
    out = {}
    default = bpr.match_plan(n_p, n_b)
    load7 = bpr.MATCH_LOAD_DEN * n_b // bpr.MATCH_LOAD_NUM + 1
    for slots in sorted({default[1], load7}):
        fit = bpr.SM_COUNT * max(1, min(2, bpr.SM_SHARED_BYTES
                                        // (8 * slots + 1024)))
        for pbits in (0, 2, 4, 5, 6, 7):
            if 1 << pbits > min(n_b, fit):
                continue
            slices = max(1, min(-(-n_p // bpr.MATCH_SHARED_THREADS),
                                fit >> pbits))
            out[f"shared S={slots} P={1 << pbits} R={slices}"] = (
                bpr.MATCH_SHARED, slots, pbits, slices << pbits)
    out["device"] = (bpr.MATCH_DEVICE, load7, 0, max(1, min(
        max(-(-n_b // (4 * bpr.MATCH_DEVICE_THREADS)),
            -(-n_p // bpr.MATCH_DEVICE_THREADS)), 8 * bpr.SM_COUNT)))
    out["default"] = default
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_match_plans: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import build_probe as bpr

    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for label, (n_p, n_b, dom) in PAIRS.items():
        probe, build = (torch.randint(0, dom, (n,), generator=gen, device=dev,
                                      dtype=torch.int32) for n in (n_p, n_b))
        want = {kern: plain(probe, build) for kern, plain in (
            (bpr.match_counts_cuda, bpr.match_counts_host),
            (bpr.first_match_cuda, bpr.first_match_host))}
        row = {}
        for name, plan in plans(bpr, n_p, n_b).items():
            times = []
            for kern, w in want.items():
                if not torch.equal(kern(probe, build, plan=plan), w):
                    print(f"time_match_plans: {label} {name} {plan}: "
                          f"{kern.__name__} differs from plain",
                          file=sys.stderr)
                    return 1
                times.append(cs.device_ms(
                    lambda k=kern, p=plan: k(probe, build, plan=p), 20))
            row[name] = times
            print(f"[plans] {label} {n_p} x {n_b}, {name} {plan}: device "
                  f"match_counts {times[0]:.4f} ms, first_match "
                  f"{times[1]:.4f} ms")
        out[label] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
