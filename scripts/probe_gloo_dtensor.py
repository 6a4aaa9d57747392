#!/usr/bin/env python3
"""Which collectives gloo carries for DTensor on CUDA tensors of one card.

    python3 scripts/probe_gloo_dtensor.py [--device cuda|cpu]

For each mesh of (1, 2), (2, 1) and (2, 2) gloo ranks sharing card 0 (or
on the CPU), spawns the ranks and runs, in order: gloo's own all_reduce
(sum, and max over the "model" group) and all_gather_into_tensor on an
(8, 8) tensor, then DTensor's redistributes (Shard -> Replicate: its
all_gather; Partial -> Replicate: all_reduce; Partial -> Shard:
reduce_scatter; Shard(0) -> Shard(1): all_to_all).  Each rank logs each
operation's start and end to results/probe/rank<r>.log, so a rank
that dies shows the operation it died in; rank 0 prints the outcomes.
Prints each group's logs and whether it ended; exits 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OUT = "results/probe"


def _log(rank: int, msg: str) -> None:
    with open(f"{OUT}/rank{rank}.log", "a") as f:
        f.write(msg + "\n")


def _rank(rank: int, world: int, store: str, dev: str, shape) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    mesh = DeviceMesh(dev, torch.arange(world).reshape(shape),
                      mesh_dim_names=("data", "model"))
    x = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)

    def raw(op, **kw):
        t = x.clone() + rank
        dist.all_reduce(t, op=op, **kw)
        return t

    def gather():
        out = torch.empty(8 * shape[1], 8, device=dev)
        dist.all_gather_into_tensor(out, x.clone(),
                                    group=mesh.get_group("model"))
        return out

    def redistribute(src, dst):
        return DTensor.from_local(x.clone(), mesh, src, run_check=False
                                  ).redistribute(mesh, dst).to_local()

    ops = [
        ("all_reduce", lambda: raw(dist.ReduceOp.SUM)),
        ("all_reduce_max", lambda: raw(dist.ReduceOp.MAX,
                                       group=mesh.get_group("model"))),
        ("all_gather_into_tensor", gather),
        ("dtensor_all_gather", lambda: redistribute(
            [Shard(0), Shard(1)], [Replicate(), Replicate()])),
        ("dtensor_all_reduce", lambda: redistribute(
            [Partial(), Partial()], [Replicate(), Replicate()])),
        ("dtensor_reduce_scatter", lambda: redistribute(
            [Partial(), Replicate()], [Shard(0), Replicate()])),
        ("dtensor_all_to_all", lambda: redistribute(
            [Shard(0), Shard(1)], [Shard(1), Shard(0)])),
    ]
    out = {}
    for name, fn in ops:
        _log(rank, f"start {name}")
        try:
            r = fn()
            if dev == "cuda":
                torch.cuda.synchronize()
            out[name] = ["ok", float(r.float().sum())]
        except Exception as e:            # a refusal is the finding
            out[name] = ["refused", repr(e)[:300]]
        _log(rank, f"done {name} {out[name]}")
        dist.barrier()
    if rank == 0:
        print(shape, json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    os.makedirs(OUT, exist_ok=True)
    for shape in [(1, 2), (2, 1), (2, 2)]:
        world = shape[0] * shape[1]
        with tempfile.TemporaryDirectory() as d:
            try:
                mp.start_processes(_rank, args=(world, f"{d}/store",
                                                args.device, shape),
                                   nprocs=world, join=True,
                                   start_method="spawn")
                print(shape, "ended", flush=True)
            except Exception as e:
                print(shape, "a rank died:", repr(e)[:200], flush=True)
        for r in range(world):
            path = f"{OUT}/rank{r}.log"
            print(f"--- rank {r} of {shape}:", open(path).read().strip()
                  .replace("\n", "; "), flush=True)
            os.remove(path)
        time.sleep(1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
