#!/usr/bin/env python3
"""Time the PyTorch + CUDA port's probe_tables on one NVIDIA GPU, for the
port under a given source tree, at the full-size cell's shape with
random keys (8 x 2^20 rows a side, w = 2, 16 bits) and at chip_smoke.py's
deep-round shapes (DEEP_PROBES).

    python3 scripts/time_probe_tables.py [--src DIR] [--split]

DIR is the `src` directory whose `repro_torch` is built and timed (default:
this checkout's), so that two versions of the kernels can be compared in
one run on one card.  The inputs come from chip_smoke.py's generator (this
checkout's).  For each shape: the output held against the plain version
(`torch.equal`), the device time a call (torch.profiler) and the event
time a call (with --split, each kernel's device time too); then one JSON
line of them.  Exits non-zero without a CUDA device or when an output
differs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--split", action="store_true",
                    help="print each kernel's device time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_probe_tables: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import join_probe as jp

    _build.lib()
    dev = torch.device("cuda")
    out = {}
    # (kind, shape, seed): the deep shapes with chip_smoke.py's seeds.
    shapes = [("cell-like", (8, 1 << 20, 1 << 20, 2, 16, "wide"), 100)] + [
        ("deep", shape, i) for i, shape in enumerate(cs.DEEP_PROBES)]
    for kind, (b, n_l, n_r, w, bits, keys), seed in shapes:
        probe = cs.deep_probe_inputs(dev, b, n_l, n_r, w, bits, keys, seed)
        label = f"{kind} {b}x{n_r} w={w} bits={bits} {keys}"
        got, want = jp.probe_tables_cuda(*probe), jp.probe_tables_host(*probe)
        if not all(torch.equal(g, x) for g, x in zip(got, want)):
            print(f"time_probe_tables: {label}: differs from plain",
                  file=sys.stderr)
            return 1
        out[label] = dict(
            device_ms=cs.device_ms(lambda p=probe: jp.probe_tables_cuda(*p),
                                   5, split=label if args.split else ""),
            ms=cs.time_ms(lambda p=probe: jp.probe_tables_cuda(*p), 5))
        print(f"[probe] {args.src} {label}: equal to plain; device "
              f"{out[label]['device_ms']:.4f} ms, events "
              f"{out[label]['ms']:.4f} ms")
    print(json.dumps({"src": args.src, "probe_tables": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
