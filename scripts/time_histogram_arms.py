#!/usr/bin/env python3
"""Time each arm of the PyTorch + CUDA port's segment_histogram on one
NVIDIA GPU, at the shapes that set its arm choice
(`kernels/segment_histogram.py::histogram_plan`).

    python3 scripts/time_histogram_arms.py

For each (values, bins) the one-block arm (up to 16 values a thread) and
the grid arm where the bins fit one block (the crossing sets
ONE_BLOCK_VALUES), and the cluster arm at 1 to 32 clusters beside the
device-atomic arm where they do not (they set MAX_CLUSTERS); the default
plan's too.  Values are
uniform over [-2, bins + 2) from a seeded generator on the card.  Each
output is held against the plain version (`torch.equal`); then the device
time a call (torch.profiler: kernels and memsets) is printed, and one JSON
line of them.  Exits non-zero without a CUDA device or when an output
differs.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ONE_SHAPES = [(n, bins) for bins in (8, 384)
              for n in (16, 1 << 10, 1 << 12, 1 << 13, 1 << 14, 1 << 16)]
ONE_MAX = 16 * 1024          # the one-block arm's most values (16 a thread)
CLUSTER_SHAPES = [(1 << 20, 1 << 16), (1 << 22, 1 << 16), (1 << 24, 1 << 16),
                  (1 << 22, 1 << 18)]


def main() -> int:
    if not torch.cuda.is_available():
        print("time_histogram_arms: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_histogram as sh

    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for n, bins in ONE_SHAPES + CLUSTER_SHAPES:
        vals = torch.randint(-2, bins + 2, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        want = sh.segment_histogram_host(vals, bins)
        if bins <= sh.SHARED_BINS:
            per_block = max(4 * bins, 8 * sh.GRID_THREADS)
            plans = {"grid": (sh.SH_GRID, max(1, min(-(-n // per_block),
                                                     sh.MAX_GRID_BLOCKS)),
                              sh.GRID_THREADS)}
            if n <= ONE_MAX:
                plans["one"] = (sh.SH_ONE, 1, min(1024, 32 * -(-n // 128)))
        else:
            plans = {f"cluster x{c}": (sh.SH_CLUSTER, c * sh.CLUSTER_BLOCKS,
                                       sh.CLUSTER_THREADS)
                     for c in (1, 2, 4, 8, 12, 16, 20, 24, 32)}
            plans["global"] = (sh.SH_GLOBAL, sh.MAX_GRID_BLOCKS,
                               sh.GRID_THREADS)
        plans["default"] = sh.histogram_plan(n, bins)
        row = {}
        for name, plan in plans.items():
            got = sh.segment_histogram_cuda(vals, bins, plan=plan)
            if not torch.equal(got, want):
                print(f"time_histogram_arms: {n} x {bins} {name} {plan}: "
                      f"differs from plain", file=sys.stderr)
                return 1
            fn = (lambda p=plan: sh.segment_histogram_cuda(vals, bins,
                                                          plan=p))
            try:
                row[name] = cs.device_ms(fn, 20)
                how = "device"
            except SystemExit:           # the profiler kept no device event
                row[name] = cs.time_ms(fn, 20)
                how = "events"
            print(f"[arms] {n} values, {bins} bins, {name} {plan}: {how} "
                  f"{row[name]:.4f} ms")
        out[f"{n}x{bins}"] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
