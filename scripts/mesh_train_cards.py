#!/usr/bin/env python3
"""The LM train step over a (2, 2) (data, model) mesh of NCCL ranks, one
rank a card, on four NVIDIA GPUs of one host: chip_smoke.py phase 9m's
rank body (`mesh_train_rank`) on the mesh that one card cannot hold (its
gloo ranks cannot share the card: see chip_smoke.py's MESH_TRAIN).

    python3 scripts/mesh_train_cards.py [--runs c,d,e]

Runs:
  c  reduced mixtral-8x22b in float32 with 8-bit states, 8 x 64 tokens, 3
     steps: every rank against the one-process eager step on its card
     (rtol 1e-5 on loss, zloss and grad_norm; expert_load equal),
     segment_histogram launched by each rank on its own rows and held
     against its plain version;
  d  qwen3-14b at its published size (40 layers, bf16, float32 AdamW
     states: 177 GB of parameters, gradients and states, more than one
     80 GB card holds), 8 x 512 tokens, 2 steps, no one-process reference;
     each rank's peak beside the prediction (those bytes over the shards
     the placements give) and beside the dry run's rank peak at 2x2 for
     the run's own config (`chip_smoke.mesh_prediction`, traced on fake
     tensors in a child process while the ranks run; held within ±10 %);
  e  the training driver, `torchrun --nproc-per-node 4 -m
     repro_torch.launch.train --mesh 2x2` (reduced qwen3-14b, NCCL), a
     DP row failing at step 6: it must exit 0, re-mesh (2, 2) -> (1, 2),
     log 10 finite losses, carry the optimizer's step over the restore
     (the first step on the survivors continues the checkpoint's count),
     and write its final checkpoint;
  f  the hybrid, enc-dec and VLM families, reduced (zamba2 and the VLM at
     4 layers, so the shared block and the gated cross-attention run, the
     VLM's gate at 0.5), in float32, 4 x 512 tokens with the frontend's
     input, 3 steps: chip_smoke.py phase 10m's training
     (`family_train`) at (2, 2), every rank within MESH_TRAIN_RTOL of the
     one-process eager step on its card.
Prints chip_smoke.py's `[mesh-train]` / `[mesh-family]` lines, the
driver's log and one JSON line; exits 1 if a check fails.  Needs four
cards.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
RUNS = dict(
    c=dict(arch="mixtral-8x22b", reduced=True, dtype="float32", bits=8,
           batch=8, seq=64, steps=3, lr=1e-2, shape=(2, 2),
           backend="nccl", exact=False, one=True),
    d=dict(arch="qwen3-14b", reduced=False, dtype="bfloat16", bits=32,
           batch=8, seq=512, steps=2, lr=3e-4, shape=(2, 2),
           backend="nccl", exact=False, one=False))
FAMILIES = {
    run: dict(arch=arch, layers=layers, reduced=True, dtype="float32",
              bits=32, shape=(2, 2), exact=False, train=True, serve=False,
              prefill=None, ring=None, **extra)
    for run, arch, layers, extra in (
        ("zamba2", "zamba2-7b", 4, {}),
        ("seamless", "seamless-m4t-medium", None, {}),
        ("vision", "llama-3.2-vision-90b", 4, {"gate": 0.5}))}
DRIVER = ("--arch", "qwen3-14b", "--reduced", "--mesh", "2x2", "--steps",
          "10", "--batch", "8", "--seq", "64", "--ckpt-every", "2",
          "--fail-at-step", "6", "--log-every", "1")
DRIVER_TIMEOUT_S = 600


def driver() -> dict:
    """Run "e": the driver under torchrun in its own process group (killed
    whole at the time limit); its log, wall and verdict."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
               *DRIVER, "--ckpt-dir", f"{tmp}/ckpt"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        t0 = time.monotonic()
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=DRIVER_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.monotonic() - t0
    lines = [ln for ln in log.splitlines()
             if ln.startswith(("step", "[FT]", "arch=", "done"))]
    print("\n".join(lines), flush=True)
    steps = [re.match(r"step\s+(\d+)\s+loss (\S+).*opt_step (\d+)", ln)
             for ln in lines if ln.startswith("step")]
    remesh = ("[FT] re-meshing {'data': 2, 'model': 2} -> "
              "{'data': 1, 'model': 2}")
    restored = [re.search(r"restoring step (\d+)", ln)[1] for ln in lines
                if ln.startswith(remesh)]
    checks = {
        "exit 0": proc.returncode == 0,
        "re-meshed": any(ln.startswith(remesh) for ln in lines),
        "10 finite losses": (len(steps) == 10 and all(
            m and math.isfinite(float(m[2])) for m in steps)),
        # A checkpoint of step N holds N + 1 updates: the first step on
        # the survivors makes the optimizer's step N + 2, not 1.
        "opt step carried": bool(restored) and len(steps) == 10 and all(
            steps) and int(steps[6][3]) == int(restored[0]) + 2,
        "final checkpoint": "done; final checkpoint at 10" in log}
    if not all(checks.values()):
        print(log[-6000:], flush=True)
    print(f"[mesh-train] driver --mesh 2x2 under torchrun: {checks}; "
          f"{wall:.1f} s", flush=True)
    return dict(wall_s=wall, checks=checks,
                steps=[[int(m[1]), float(m[2]), int(m[3])]
                       for m in steps if m])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="c,d,e,f")
    args = ap.parse_args()
    if torch.cuda.device_count() < 4:
        print("mesh_train_cards: needs four cards", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.lib()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    runs = args.runs.split(",")
    pred = None
    if "d" in runs:
        from repro_torch.configs import ShapeCell
        d = RUNS["d"]
        tracer = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
            "spawn"))
        pred = tracer.submit(
            cs.mesh_prediction, d["arch"],
            ShapeCell("d", d["seq"], d["batch"], "train"),
            "x".join(map(str, d["shape"])), dtype=d["dtype"], bits=d["bits"])
    out = cs.mesh_training(card, {r: RUNS[r] for r in runs if r in RUNS})
    if pred is not None:
        out["d"]["dryrun"] = cs.mesh_train_beside(
            pred.result(), "d", out["d"]["ranks"],
            "x".join(map(str, RUNS["d"]["shape"])), tol=0.10)
        tracer.shutdown()
    if "e" in runs:
        out["e"] = driver()
    if "f" in runs:
        out["f"] = cs.mesh_families(card, FAMILIES, deadline_s=900)
    print(json.dumps({"mesh_train_cards": out}))
    return 0 if all(out.get("e", {"checks": {}})["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
