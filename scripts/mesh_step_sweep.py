#!/usr/bin/env python3
"""The LM mesh tests' cases without JAX: each case of
tests/_torch_lm_mesh_cases.py (its rank body, `lm_rank`, over 4 gloo ranks
on the CPU) run from seed-made parameters and fresh optimizer states, the
mesh step against the port's one-process step with the tests' own check
(`check_metrics`); with `--serve`, each case of
tests/_torch_serve_mesh_cases.py (`serve_rank`: decode, the engine, MoE
decode, prefill) from seed-made parameters, against the one-process port
(`check_one_process`).  The check of the mesh path on a machine whose
torch differs from the test container's (DTensor's strategies change
between torch releases) and which has no JAX.

    python3 scripts/mesh_step_sweep.py [--serve] [--cases qwen3_n1_2x2,...]

One line a case: the worst relative difference of loss, zloss and
grad_norm over the steps and the ranks (serving: the worst logit
difference), PASS or FAIL.  Exits 1 if a case fails; a rank that fails
raises.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import _torch_lm_mesh_cases as lc  # noqa: E402
import _torch_mesh_cases as mc  # noqa: E402
import _torch_serve_mesh_cases as sc  # noqa: E402


def start_of(case: str) -> dict:
    """The case's start without the reference: seed-made float32
    parameters as numpy, no optimizer state, the tests' batch."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map
    cfg = ARCHS[lc.CASES[case][0]].reduced()
    params = tree_map(lambda t: t.numpy(), init_params(
        api.layout(cfg), torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32))
    return {"states": [(params, None)], "batch": lc.batch(cfg.vocab)}


def serve_start(case: str) -> dict:
    """A serve case's start without the reference: seed-made float32
    parameters as numpy and the tests' inputs."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map
    cfg = sc.config(case, ARCHS)
    params = tree_map(lambda t: t.numpy(), init_params(
        api.layout(cfg), torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32))
    return {"params": params, "inputs": sc.inputs(cfg.vocab)}


def serve(cases: list[str]) -> int:
    with tempfile.TemporaryDirectory() as d:
        for case in cases:
            with open(Path(d) / f"{case}.pkl", "wb") as f:
                pickle.dump(serve_start(case), f)
        t0 = time.monotonic()
        ctx = mc.spawn_ranks(sc.serve_rank, 4, f"{d}/store", d, cases)
        mc.join_ranks(ctx, t0 + sc.DEADLINE_S)
        ranks = mc.load_ranks(d, 4)
    print(f"{len(cases)} serve cases over 4 ranks in "
          f"{time.monotonic() - t0:.1f} s with the spawn", flush=True)
    failed = 0
    for case in cases:
        try:
            worst = sc.check_one_process(ranks, case)
            verdict = f"worst logit diff {worst:.2e}: PASS"
        except AssertionError as e:
            verdict, failed = f"FAIL {e!r}"[:300], failed + 1
        print(f"{case} against the one-process port: {verdict}", flush=True)
    if "refusals" in ranks[0]:
        refused = all(all(v.values()) for r in ranks
                      for v in r["refusals"].values())
        failed += not refused
        print(f"hybrid, encdec and vlm refuse a mesh: "
              f"{'PASS' if refused else 'FAIL'}", flush=True)
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--cases", default=None)
    args = ap.parse_args()
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    print(sys.version.split()[0], torch.__version__, flush=True)
    if args.serve:
        return serve((args.cases or ",".join(sc.CASES)).split(","))
    cases = (args.cases or ",".join(lc.CASES)).split(",")
    with tempfile.TemporaryDirectory() as d:
        for case in cases:
            with open(Path(d) / f"{case}.pkl", "wb") as f:
                pickle.dump(start_of(case), f)
        t0 = time.monotonic()
        ctx = mc.spawn_ranks(lc.lm_rank, 4, f"{d}/store", d, cases)
        mc.join_ranks(ctx, t0 + lc.DEADLINE_S)
        ranks = mc.load_ranks(d, 4)
    print(f"{len(cases)} cases over 4 ranks in "
          f"{time.monotonic() - t0:.1f} s with the spawn", flush=True)
    failed = 0
    for case in cases:
        worst = max(abs(float(g[k]) - float(w[k])) / abs(float(w[k]))
                    for rank in ranks
                    for g, w in zip(rank[case]["metrics"], rank[case]["one"])
                    for k in ("loss", "zloss", "grad_norm"))
        try:
            for rank in ranks:
                lc.check_metrics(rank[case]["metrics"], rank[case]["one"],
                                 case)
            verdict = "PASS"
        except AssertionError as e:
            verdict, failed = f"FAIL {e!r}"[:300], failed + 1
        print(f"{case}: worst rel {worst:.2e} against the one-process "
              f"step: {verdict}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
