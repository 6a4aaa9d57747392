#!/usr/bin/env python3
"""Time the train step of chip_smoke.py's training cells on one NVIDIA GPU,
step by step, for the port under a given source tree.

    python3 scripts/time_train_steps.py [--src DIR] [--cells 10b,10d]
                                        [--steps N]

DIR is the `src` directory whose `repro_torch` is timed (default: this
checkout's).  A cell is 9a (mixtral-8x22b at chip_smoke.py's TRAIN) or a
tag of its FAMILIES (10a-10d, the training model at FAMILY_RUN's batch),
built as chip_smoke.py builds it (bf16 weights from its seed, one
TokenPipeline batch, stub frontends from the driver's make_batch).  Each
cell takes N steps on that batch; for each step: the host wall (from a
synchronized start to the metrics on the host), the stream time between
CUDA events recorded before and after the call (the device's work and its
idle gaps), and the host time spent in Python's garbage collector during
it (by generation, from `gc.callbacks`).  On a
tree whose step is a CUDA graph the first step is eager, the second
captures and the rest replay.  Prints a line a step and one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--cells", default="10b,10d")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_train_steps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.launch.train import make_batch
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    gc_s = {0: 0.0, 1: 0.0, 2: 0.0}
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            gc_s[info["generation"]] += time.perf_counter() - started["t"]

    gc.callbacks.append(on_gc)
    out = {"src": args.src}
    for tag in args.cells.split(","):
        if tag == "9a":
            t = cs.TRAIN
            cfg = dataclasses.replace(ARCHS[t["arch"]],
                                      n_layers=t["n_layers"])
            B, S, bits, seed = t["batch"], t["seq"], t["state_bits"], t["seed"]
            lr, warmup, gate = t["lr"], t["warmup"], None
        else:
            spec = next(f for f in cs.FAMILIES if f["tag"] == tag)
            R = cs.FAMILY_RUN
            full = ARCHS[spec["arch"]]
            layers = spec.get("train_layers", spec.get("layers"))
            cfg = (full if layers is None
                   else dataclasses.replace(full, n_layers=layers))
            B, S, bits, seed = R["batch"], R["seq"], spec["state_bits"], \
                R["seed"]
            lr, warmup, gate = R["lr"], R["warmup"], spec.get("gate")
        model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(
            seed), device=dev)
        if gate is not None:
            model.ca_blocks.gate.fill_(gate)
        ocfg = AdamWConfig(lr=lr, state_bits=bits)
        opt = adamw.init(model.tree(), ocfg)
        fns = build_train_step(cfg, ocfg, total_steps=args.steps,
                               warmup_steps=warmup, device=dev)
        pipe = TokenPipeline(PipelineConfig(cfg.vocab, S, B, seed=seed))
        batch = make_batch(cfg, pipe, 0, np.random.default_rng(seed), dev)
        steps = []
        for i in range(args.steps):
            torch.cuda.synchronize()
            before = dict(gc_s)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0 = time.perf_counter()
            e0.record()
            model, opt, m = fns.step(model, opt, batch)
            e1.record()
            loss = float(m["loss"])
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            row = dict(wall_ms=wall * 1e3, stream_ms=e0.elapsed_time(e1),
                       gc_ms={g: (gc_s[g] - before[g]) * 1e3 for g in gc_s},
                       loss=loss)
            steps.append(row)
            print(f"[steps] {tag} step {i}: wall {row['wall_ms']:.1f} ms, "
                  f"stream {row['stream_ms']:.1f} ms, gc "
                  + ", ".join(f"gen{g} {v:.1f}" for g, v in
                              row["gc_ms"].items()) + f" ms; loss {loss:.4f}",
                  flush=True)
        c = getattr(fns, "compiled", None)
        out[tag] = dict(steps=steps, counters=None if c is None else [
            c.eager_calls, c.captures, c.replays])
        del model, opt, fns, batch, m, c       # the graph and its pool too
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
