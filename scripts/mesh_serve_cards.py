#!/usr/bin/env python3
"""The LM's serving over (data, model) meshes of NCCL ranks, one rank a
card, on four NVIDIA GPUs of one host: chip_smoke.py phase 7m's rank body
(`mesh_serve_rank`) on the meshes that one card cannot hold (a mesh axis
of one rank replicates, and gloo ranks cannot share a card: see
chip_smoke.py's MESH_TRAIN).

    python3 scripts/mesh_serve_cards.py [--runs c,d,e]

Runs (bf16 weights from a seeded generator, every rank against the
one-process engines on its own card from the same weights and requests):
  c  qwen3-14b at its published size (40 layers, 8 KV heads: the cache's
     KV heads split over "model") at (2, 2): a 4 x 2,048
     `build_prefill(mesh=)`, then 16 requests on 8 slots, max_seq 4,096;
  d  qwen2-0.5b at its published size (2 KV heads on a model axis of 4:
     the cache's sequence split over "model", each rank attending its
     part of the positions) at (1, 4): 16 requests on 8 slots, max_seq
     512;
  e  the hybrid, enc-dec and VLM families at chip_smoke.py phase 10m's
     sizes (zamba2-7b depth 16, seamless-m4t-medium, llama-3.2-vision-90b
     depth 5 with its gate at 0.5) at (2, 2), through phase 10m's serving
     (`family_serve`): 16 requests on 8 slots, max_seq 512, then the 4 x
     2,048 prefill and its 8 ticks, or the ring's 8 ticks across its wrap;
     each rank's resident params + cache beside the dry run's at 2x2 for
     the engine's own config (`chip_smoke.mesh_prediction`, traced on
     fake tensors in a child process while the ranks run; held to the
     byte).
Each rank's first tick's logits and ("c") prefill logits are held within
`MESH_SERVE_LOGIT_RTOL` of the largest logit of the one-process
engine's; the script prints, for each rank, its resident parameters and
cache beside what the placements predict, its peak, the median ticks
(over the mesh, eager; in one process, eager on the plain versions and
on the graph) and the tick at which its tokens first differ from the
one-process engine's, if they do ("e": the first request that differs,
the prefill's and the ticks' largest differences, and its resident bytes
held equal to the placements' prediction); then one JSON line.  Exits 1
if a check fails.  Needs four cards.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
RUNS = dict(
    c=dict(arch="qwen3-14b", layers=None, shape=(2, 2), slots=8,
           max_seq=4096, n_requests=16, prompt_len=(8, 32),
           new_tokens=(8, 24), prefill=(4, 2048), exact=False),
    d=dict(arch="qwen2-0.5b", layers=None, shape=(1, 4), slots=8,
           max_seq=512, n_requests=16, prompt_len=(8, 32),
           new_tokens=(8, 24), prefill=None, exact=False))


def families(cs) -> dict:
    """Run "e": phase 10m's serving runs at (2, 2), held within
    tolerance."""
    return {run: dict(spec, shape=(2, 2), exact=False, train=False)
            for run, spec in cs.MESH_FAMILY.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="c,d,e")
    args = ap.parse_args()
    if torch.cuda.device_count() < 4:
        print("mesh_serve_cards: needs four cards", file=sys.stderr)
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
    pred = {}
    if "e" in runs:
        from repro_torch.configs import ShapeCell
        R = cs.MESH_FAMILY_RUN
        tracer = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
            "spawn"))
        pred = {run: tracer.submit(
            cs.mesh_prediction, spec["arch"],
            ShapeCell(f"10m-{run}", R["max_seq"], R["slots"], "decode"),
            "2x2", layers=spec["layers"], dtype=spec["dtype"])
            for run, spec in cs.MESH_FAMILY.items()}
    out = cs.mesh_serving(card, {r: RUNS[r] for r in runs if r in RUNS})
    if "e" in runs:
        out["e"] = cs.mesh_families(card, families(cs), deadline_s=1500)
        out["e"]["dryrun"] = cs.mesh_dryrun_phase(
            card, {f"10m-{run}": {"2x2": f.result()} for run, f in
                   pred.items()}, None, out["e"], "2x2")
        tracer.shutdown()
    print(json.dumps({"mesh_serve_cards": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
