#!/usr/bin/env python3
"""The dry run over meshes of H100s (`repro_torch.launch.dryrun.run_cell(...,
mesh_kind)`) on many cells at once, on the CPU: no card is used.

    python3 scripts/dryrun_mesh_sweep.py --check
    python3 scripts/dryrun_mesh_sweep.py [--cells arch:shape ...]
        [--meshes single multi] [--ladder 1x8 2x8 4x8 8x8 16x16]
        [--jobs 8] [--deadline-s 1800] [--out results/dryrun_mesh.json]

`--check` is the check of this machine's torch before a sweep (its
DTensor and its fake process-group backend are torch internals that
change between releases): the fake backend and the counter's hook into
DTensor's sharding propagation exist; every family's reduced config
traces its train, prefill and decode steps at (2, 4) and (2, 2, 2) (8 x
32 tokens); a record traced warm equals one traced cold in a fresh
process.  One line a trace; exits 1 if any fails.

Without `--check`: for each cell (by default the 24 (arch, shape) cells
whose one-card record does not fit one 80 GB card), rank 0's record at
each of `--meshes`, then up the `--ladder` of meshes until one fits 80
GB a card (the smallest that fits; none where the last does not).  Each
cell's meshes run in order in one worker process of `--jobs`; records go
to `--out` as they come (the dry run's own JSON form, keyed (arch, shape,
mesh, tag)), and a cell already there is not traced again.  No trace
starts after `--deadline-s`; at the deadline the workers are stopped and
the table says how far the sweep got.  Prints one line a record and the
table of the cells.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import (ProcessPoolExecutor, TimeoutError,
                                as_completed)
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# The (arch, shape) cells whose one-card record does not fit one 80 GB
# card (`python -m repro_torch.launch.dryrun --all`).
TOO_BIG = [
    ("kimi-k2-1t-a32b", "train_4k"), ("kimi-k2-1t-a32b", "prefill_32k"),
    ("kimi-k2-1t-a32b", "decode_32k"),
    ("llama-3.2-vision-90b", "train_4k"),
    ("llama-3.2-vision-90b", "prefill_32k"),
    ("llama-3.2-vision-90b", "decode_32k"),
    ("mixtral-8x22b", "train_4k"), ("mixtral-8x22b", "prefill_32k"),
    ("mixtral-8x22b", "decode_32k"),
    ("phi3-medium-14b", "train_4k"), ("phi3-medium-14b", "prefill_32k"),
    ("phi3-medium-14b", "decode_32k"),
    ("qwen2-0.5b", "prefill_32k"),
    ("qwen3-14b", "train_4k"), ("qwen3-14b", "prefill_32k"),
    ("qwen3-14b", "decode_32k"),
    ("seamless-m4t-medium", "prefill_32k"),
    ("seamless-m4t-medium", "decode_32k"),
    ("starcoder2-15b", "train_4k"), ("starcoder2-15b", "prefill_32k"),
    ("starcoder2-15b", "decode_32k"),
    ("zamba2-7b", "train_4k"), ("zamba2-7b", "prefill_32k"),
    ("zamba2-7b", "decode_32k")]
LADDER = ["1x8", "2x8", "4x8", "8x8", "16x16"]


def check() -> int:
    """`--check` (module docstring)."""
    import subprocess

    import torch
    from repro_torch.configs import ARCHS, ShapeCell
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch import mesh as meshlib
    print(f"torch {torch.__version__}", flush=True)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    print(f"fake backend: {FakeStore.__module__}.FakeStore", flush=True)
    op_analysis._propagator()
    failed = 0
    cells = {kind: ShapeCell(kind, 32, 8, kind)
             for kind in ("train", "prefill", "decode")}
    for name in sorted(ARCHS):
        cfg = ARCHS[name].reduced()
        for kind, cell in cells.items():
            for shape in ((2, 4), (2, 2, 2)):
                t0 = time.perf_counter()
                try:
                    with meshlib.fake_world(shape) as mesh:
                        got = dryrun.size(cfg, cell, 1, 32, mesh,
                                          dryrun.cell_rules(cfg, mesh))
                    print(f"{name:22s} {kind:8s} {shape}: ok "
                          f"{time.perf_counter() - t0:5.1f} s, arguments "
                          f"{got['memory']['argument_bytes']} B, cross-pod "
                          f"{got['parsed']['coll_bytes_crosspod']:.0f} B",
                          flush=True)
                except Exception as e:  # noqa: BLE001 — reported, counted
                    failed += 1
                    print(f"{name:22s} {kind:8s} {shape}: FAIL "
                          f"{type(e).__name__}: {e}", flush=True)
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "from repro_torch.configs import ARCHS, ShapeCell\n"
            "from repro_torch.launch import dryrun, mesh\n"
            "cfg = ARCHS['qwen3-14b'].reduced()\n"
            "with mesh.fake_world((2, 2, 2)) as m:\n"
            "    got = dryrun.size(cfg, ShapeCell('t', 32, 8, 'train'), 1, "
            "32, m, dryrun.cell_rules(cfg, m))\n"
            "got.pop('trace_s')\n"
            "print(json.dumps(got))\n")
    cold = json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True).stdout.splitlines()[-1])
    cfg = ARCHS["qwen3-14b"].reduced()
    with meshlib.fake_world((2, 2, 2)) as mesh:
        warm = dryrun.size(cfg, cells["train"], 1, 32, mesh,
                           dryrun.cell_rules(cfg, mesh))
    warm.pop("trace_s")
    same = json.loads(json.dumps(warm)) == cold
    failed += not same
    print(f"a warm record equals a cold one from a fresh process: {same}",
          flush=True)
    return 1 if failed else 0


def cell_chain(arch: str, shape: str, meshes: list[str],
               ladder: list[str], have: dict, parts: str) -> None:
    """One worker's cell: its record at each of `meshes`, then up
    `ladder` until a mesh fits a card (records already in `have`, keyed by
    mesh, are reused, not traced), each written to `parts` as it comes."""
    from repro_torch.launch import dryrun

    def record(mk):
        if mk in have:
            return have[mk]
        t0 = time.time()
        rec = dryrun.run_cell(arch, shape, mk)
        rec["tag"] = None
        rec["wall_s"] = round(time.time() - t0, 1)
        (Path(parts) / f"{arch}_{shape}_{mk}.json").write_text(
            json.dumps(rec))
        print(_line(rec), flush=True)
        return rec

    for mk in meshes:
        record(mk)
    for mk in ladder:
        rec = record(mk)
        if rec.get("status") != "ok" or rec["memory"]["fits_80GB"]:
            break


def _line(rec) -> str:
    if rec.get("status") != "ok":
        return (f"{rec['arch']:22s} {rec['shape']:12s} {rec.get('mesh'):6s} "
                f"{rec.get('status')}: {rec.get('error', rec.get('reason'))}")
    mem, parsed = rec["memory"], rec["parsed"]
    return (f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:6s} "
            f"{mem['total_per_device'] / 1e9:9.2f} GB a card "
            f"({'fits' if mem['fits_80GB'] else 'no'}), collectives "
            f"{parsed['coll_bytes_total'] / 1e9:.2f} GB, cross-pod "
            f"{parsed['coll_bytes_crosspod'] / 1e9:.3f} GB, "
            f"{rec['roofline']['dominant']}, traced in {rec['trace_s']} s "
            f"({rec.get('wall_s')} s)")


def table(records: list[dict], cells, meshes, ladder) -> None:
    by = {(r["arch"], r["shape"], r.get("mesh")): r for r in records}
    print("| cell | " + " | ".join(meshes) + " | smallest of "
          + ", ".join(ladder) + " that fits 80 GB |")
    for arch, shape in cells:
        row = []
        for mk in meshes:
            r = by.get((arch, shape, mk))
            row.append("not traced" if r is None else
                       f"{r['memory']['total_per_device'] / 1e9:.2f} GB"
                       if r.get("status") == "ok" else r.get("status"))
        fit = "not reached"
        for mk in ladder:
            r = by.get((arch, shape, mk))
            if r is None:
                break
            if r.get("status") != "ok":
                fit = r.get("status")
                break
            if r["memory"]["fits_80GB"]:
                fit = (f"{mk} ({r['memory']['total_per_device'] / 1e9:.2f}"
                       f" GB)")
                break
            fit = "none"
        print(f"| {arch} x {shape} | " + " | ".join(row) + f" | {fit} |")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--cells", nargs="*", default=None,
                    help="arch:shape (default: the 24 that do not fit one "
                         "card)")
    ap.add_argument("--meshes", nargs="*", default=["single", "multi"])
    ap.add_argument("--ladder", nargs="*", default=LADDER)
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--deadline-s", type=float, default=1800.0)
    ap.add_argument("--out", default="results/dryrun_mesh.json")
    args = ap.parse_args()
    if args.check:
        return check()
    cells = ([tuple(c.split(":")) for c in args.cells] if args.cells
             else TOO_BIG)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    records = json.loads(out.read_text()) if out.exists() else []
    parts = out.with_name(out.stem + "_parts")
    parts.mkdir(exist_ok=True)
    t_end = time.monotonic() + args.deadline_s
    pool = ProcessPoolExecutor(args.jobs, mp_context=get_context("spawn"))
    pending = {}
    for arch, shape in cells:
        have = {r.get("mesh"): r for r in records
                if (r["arch"], r["shape"]) == (arch, shape)}
        pending[pool.submit(cell_chain, arch, shape, args.meshes,
                            args.ladder, have, str(parts))] = (arch, shape)
    left = set(pending)
    try:
        for fut in as_completed(pending, timeout=max(
                1.0, t_end - time.monotonic())):
            left.discard(fut)
            fut.result()
    except TimeoutError:
        print(f"deadline: {len(left)} of {len(pending)} cells unfinished: "
              f"{sorted(pending[f] for f in left)}", flush=True)
    finally:
        for proc in list(getattr(pool, "_processes", {}).values()):
            proc.kill()
        pool.shutdown(wait=False, cancel_futures=True)
    keys = {(r["arch"], r["shape"], r.get("mesh")) for r in records}
    for f in sorted(parts.glob("*.json")):
        rec = json.loads(f.read_text())
        if (rec["arch"], rec["shape"], rec.get("mesh")) not in keys:
            records.append(rec)
    out.write_text(json.dumps(records, indent=1))
    table(records, cells, args.meshes, args.ladder)
    return 0


if __name__ == "__main__":
    sys.exit(main())
