#!/usr/bin/env python3
"""Run chip_smoke.py's LM phases, 7 (mixtral-8x22b serving) and 10 (the
ssm, hybrid, encdec and vlm families), of each given source tree on one
NVIDIA GPU, one process a tree, in the order given:

    python3 scripts/time_lm_phases.py [--out DIR] TREE [TREE ...]

Each TREE is a checkout (its own chip_smoke.py and src/), so two versions
compare in one call on one card (parent, change, change, parent).  Each
run's output goes to DIR/cmp_<i>_<name>.log (DIR defaults to
build/lm_phases); its last line is a JSON object of the phases' figures
(phase 7's summary where the tree's chip_smoke.py returns one).  Prints
each run's exit code.
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--out", default="build/lm_phases")
ap.add_argument("trees", nargs="+")
args = ap.parse_args()
os.makedirs(args.out, exist_ok=True)
for i, tree in enumerate(args.trees):
    tree = os.path.abspath(tree)
    code = f"""
import gc, json, sys, time, torch
sys.path.insert(0, {tree!r} + "/src"); sys.path.insert(0, {tree!r})
import chip_smoke as cs
dev = torch.device("cuda")
t0 = time.perf_counter()
s = cs.moe_serve(dev)
t7 = time.perf_counter() - t0
gc.collect(); torch.cuda.empty_cache()
f = cs.lm_families(dev)
print(json.dumps({{"tree": {tree!r}, "phase7_s": t7,
                  "moe_summary": s.get("summary"), "families": f}}))
"""
    name = os.path.basename(tree.rstrip("/"))
    with open(os.path.join(args.out, f"cmp_{i}_{name}.log"), "w") as log:
        rc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                            stdout=log, stderr=subprocess.STDOUT).returncode
    print(f"run {i} {name}: rc {rc}", flush=True)
