#!/usr/bin/env python3
"""Run chip_smoke.py's LM phases of each given source tree on one NVIDIA
GPU, one process a tree, in the order given:

    python3 scripts/time_lm_phases.py [--out DIR] [--phases 7,9,10] TREE ...

The phases are 7 (mixtral-8x22b serving), 9 (9a: mixtral-8x22b training;
9b: the training driver on qwen2-0.5b, then the driver's step alone on
its model and batch: 5 steps timed and a sixth profiled for its
device-busy share, with any tree's API) and 10 (the ssm, hybrid, encdec
and vlm families, serving and training); `--phases` picks them (7 and 10
by default) and they run in chip_smoke.py's order.  Each TREE is a
checkout (its own chip_smoke.py and src/), so two versions compare in one
call on one card (parent, change, change, parent).  Each run's output
goes to DIR/cmp_<i>_<name>.log (DIR defaults to build/lm_phases); its
last line is a JSON object of the phases' figures (phase 7's summary
where the tree's chip_smoke.py returns one).  Prints each run's exit
code.
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--out", default="build/lm_phases")
ap.add_argument("--phases", default="7,10")
ap.add_argument("trees", nargs="+")
args = ap.parse_args()
phases = set(args.phases.split(","))
os.makedirs(args.out, exist_ok=True)
for i, tree in enumerate(args.trees):
    tree = os.path.abspath(tree)
    code = f"""
import gc, json, sys, time, torch
import numpy as np
sys.path.insert(0, {tree!r} + "/src"); sys.path.insert(0, {tree!r})
import chip_smoke as cs
dev = torch.device("cuda")

def driver_step(cs, dev):
    from repro_torch.configs import get
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.launch.train import make_batch
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    D = cs.DRIVER
    cfg = get(D["arch"])
    ocfg = AdamWConfig(lr=D["lr"])
    fns = build_train_step(cfg, opt_cfg=ocfg, device=dev)
    model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = adamw.init(model.tree(), ocfg)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, D["seq"], D["batch"]))
    batch = make_batch(cfg, pipe, 0, np.random.default_rng(0), dev)
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, opt, m = fns.step(model, opt, batch)
        float(m["loss"])
        step_ms.append((time.perf_counter() - t) * 1e3)
    print("[driver] 9b step alone: steps " +
          ", ".join(f"{{t:.1f}}" for t in step_ms) + " ms")
    prof = {{}}
    cs.profile_calls(lambda: fns.step(model, opt, batch),
                     "9b one warm train step alone", 1, top=8,
                     tag="driver", sink=prof, cpu=False)
    del model, opt, fns, batch
    gc.collect(); torch.cuda.empty_cache()
    return dict(step_ms=step_ms, profile=prof)

out = {{"tree": {tree!r}}}
if "7" in {phases!r}:
    t0 = time.perf_counter()
    s = cs.moe_serve(dev)
    out.update(phase7_s=time.perf_counter() - t0,
               moe_summary=s.get("summary"))
    del s
    gc.collect(); torch.cuda.empty_cache()
if "9" in {phases!r}:
    t0 = time.perf_counter()
    out["moe_train"] = cs.moe_train(dev)
    out["driver"] = cs.train_driver(dev)
    out["phase9_s"] = time.perf_counter() - t0
    gc.collect(); torch.cuda.empty_cache()
    out["driver_step"] = driver_step(cs, dev)
    gc.collect(); torch.cuda.empty_cache()
if "10" in {phases!r}:
    out["families"] = cs.lm_families(dev)
print(json.dumps(out, default=str))
"""
    name = os.path.basename(tree.rstrip("/"))
    with open(os.path.join(args.out, f"cmp_{i}_{name}.log"), "w") as log:
        rc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                            stdout=log, stderr=subprocess.STDOUT).returncode
    print(f"run {i} {name}: rc {rc}", flush=True)
