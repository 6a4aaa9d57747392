"""Dry run: size every (arch x shape) cell for one card, allocating nothing.

The counterpart of the reference package's `launch/dryrun.py`.  For each
cell it builds the REAL step (`build_train_step`'s forward, backward and
AdamW update; `build_prefill`; `build_decode_step` over
`models.api.init_cache`), the functions the trainer and the server run,
and runs it once on fake tensors (`FakeTensorMode`: shapes and dtypes, no
storage; the counterpart of lowering against `ShapeDtypeStruct`s) under
`launch.op_analysis`'s op counter.  Off the card each kernel wrapper runs
its plain version, of the same shapes; on a card a step is a CUDA graph
of the same function.  It records:

  * memory: the step's arguments (parameters, optimizer state or cache,
    inputs), its outputs, the peak of what it allocates above them
    (`temp_bytes`), and whether their sum fits one 80 GB card;
  * `op_analysis`'s FLOPs, HBM bytes and collective bytes, and the
    roofline terms on one NVIDIA H100 (`launch.mesh`'s rates);
  * the analytic MODEL_FLOPS (6·N_active·D train, 2·N_active·D inference)
    and the useful-compute ratio.

A train cell defaults to one sequence a microbatch (`n_micro` =
global_batch), as the reference's default is one sequence a device a
microbatch.  One microbatch's step is traced, and the rest are reckoned:
FLOPs and bytes are n_micro x what comes before the update (the update,
which begins where it advances the optimizer's step counter, counted
once, as traced on one microbatch's gradients), memory is what persists
across microbatches (parameters, optimizer state and, when n_micro > 1,
the float32 gradient accumulator of `train_step`) plus the traced step's
peak.

The reference's `--mesh` and `--override` have no counterpart: one card
holds no sharded layout, so there is no mesh to choose and no sharding
rule to override.  Nothing here needs a card or imports JAX.

Results append to a JSON file (resume-safe: a cell already in it is kept
unless `--force`).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import (ARCHS, SHAPES, ShapeCell, cell_applicable, get,
                       input_specs)
from ..models import api
from ..models.common import count_params, map_layout
from ..optim import AdamWConfig, adamw
from ..serve import build_decode_step, build_prefill
from ..train import build_train_step
from . import mesh as meshlib
from . import op_analysis

CARD_BYTES = 80e9


def active_params(cfg) -> float:
    """Per-token active parameter count (MoE counts topk experts once)."""
    total = count_params(api.layout(cfg))
    # subtract embedding + unembedding (not matmul-per-token in the 6ND sense;
    # the logits matmul is added explicitly below)
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "moe":
        n_slots = cfg.n_slots()
        expert_p = 3 * cfg.d_model * cfg.d_ff * n_slots * cfg.n_layers
        dense_p = total - emb - expert_p
        active_expert = 3 * cfg.d_model * cfg.d_ff * cfg.topk * cfg.n_layers
        return dense_p + active_expert
    return total - emb


def model_flops(cfg, shape: str | ShapeCell) -> float:
    """Analytic useful FLOPs per step."""
    cell = _cell(shape)
    n_act = active_params(cfg)
    logits_flops_per_tok = 2 * cfg.d_model * cfg.vocab
    if cell.kind == "train":
        toks = cell.global_batch * cell.seq_len
        return 6 * n_act * toks + 3 * logits_flops_per_tok * toks
    if cell.kind == "prefill":
        toks = cell.global_batch * cell.seq_len
        return 2 * n_act * toks + logits_flops_per_tok * toks
    # decode: one token per sequence (attention reads of the KV cache are
    # memory-, not FLOP-dominated; 2·N covers the matmuls)
    return (2 * n_act + logits_flops_per_tok) * cell.global_batch


def nbytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors in `trees` (dicts,
    tuples and lists of tensors; a module's parameters; None)."""
    seen: dict[int, int] = {}

    def walk(obj):
        if isinstance(obj, torch.nn.Module):
            obj = list(obj.parameters())
        if isinstance(obj, dict):
            obj = list(obj.values())
        if isinstance(obj, (tuple, list)):
            for v in obj:
                walk(v)
        elif isinstance(obj, torch.Tensor):
            s = obj.untyped_storage()
            seen[s._cdata] = s.nbytes()

    walk(trees)
    return sum(seen.values())


def _model(cfg):
    """The family's model over uninitialised parameters (fake, under the
    caller's FakeTensorMode)."""
    dtype = getattr(torch, cfg.param_dtype)
    return api.build(cfg, map_layout(api.layout(cfg), lambda p, _: torch.empty(
        p.shape, dtype=dtype)))


def _empty(specs: dict, rows: int | None = None) -> dict:
    """Tensors of `specs`' shapes and dtypes (`rows` leading rows)."""
    return {k: torch.empty(((rows or v.shape[0]),) + tuple(v.shape[1:]),
                           dtype=v.dtype) for k, v in specs.items()}


def _cell(shape: str | ShapeCell) -> ShapeCell:
    return shape if isinstance(shape, ShapeCell) else SHAPES[shape]


def trace_cell(cfg, shape: str | ShapeCell, n_micro: int = 1,
               opt_bits: int = 32) -> dict:
    """Trace the cell's step once on fake tensors.  Returns {trace (the
    step's `op_analysis.Trace`: a train step of one microbatch, its counts
    split where the update begins), argument_bytes, output_bytes,
    persistent_bytes (what a train step keeps across microbatches beyond
    its arguments)}."""
    cell = _cell(shape)
    specs = input_specs(cfg, cell)
    with FakeTensorMode():
        model = _model(cfg)
        if cell.kind == "train":
            B = cell.global_batch
            if B % n_micro:
                raise ValueError(f"global batch {B} does not split into "
                                 f"{n_micro} microbatches")
            ocfg = AdamWConfig(state_bits=opt_bits)
            opt = adamw.init(model.tree(), ocfg)
            fns = build_train_step(cfg, ocfg, device="cpu")
            batch = _empty(specs, B // n_micro)
            args = nbytes(model, opt) + nbytes(_empty(specs))
            # The counts split where the update advances the step counter.
            trace = op_analysis.analyze(fns.step, model, opt, batch,
                                        split_at=opt["step"])
            acc = 4 * count_params(api.layout(cfg)) if n_micro > 1 else 0
            return dict(trace=trace, argument_bytes=args,
                        output_bytes=nbytes(trace.out[2]),
                        persistent_bytes=acc)
        if cell.kind == "prefill":
            fns = build_prefill(cfg, device="cpu")
            batch = _empty(specs)
            args = nbytes(model, batch)
            trace = op_analysis.analyze(fns.prefill, model, batch)
            return dict(trace=trace, argument_bytes=args,
                        output_bytes=nbytes(trace.out), persistent_bytes=0)
        B, S = cell.global_batch, cell.seq_len
        fns = build_decode_step(cfg, B, S, device="cpu")
        cache = api.init_cache(cfg, B, S, device="cpu")
        inputs = _empty(specs)
        args = nbytes(model, cache, inputs)
        trace = op_analysis.analyze(fns.decode, model, cache,
                                    inputs["tokens"], inputs["pos"])
        return dict(trace=trace, argument_bytes=args,
                    output_bytes=nbytes(trace.out[0]), persistent_bytes=0)


def _per_step(terms, before, n_micro: int):
    """A train step's terms from one microbatch's step (`terms`) and its
    counts before the update (`before`): n_micro microbatches, the update
    once."""
    def steps(a, b):
        return a + (n_micro - 1) * b
    coll = {k: steps(v, before.coll_bytes.get(k, 0.0))
            for k, v in terms.coll_bytes.items()}
    return op_analysis.RooflineTerms(
        flops=steps(terms.flops, before.flops),
        hbm_bytes=steps(terms.hbm_bytes, before.hbm_bytes),
        coll_bytes=coll, coll_bytes_total=sum(coll.values()),
        coll_bytes_crosspod=0.0,
        coll_counts={k: steps(v, before.coll_counts[k])
                     for k, v in terms.coll_counts.items()})


def size(cfg, shape: str | ShapeCell, n_micro: int = 1, opt_bits: int = 32
         ) -> dict:
    """One step of the cell on one card: trace_s, n_ops, n_params and the
    record's memory, parsed and roofline fields (see the module's
    docstring).  `shape` is a name of SHAPES or a ShapeCell of other
    sizes."""
    t0 = time.time()
    got = trace_cell(cfg, shape, n_micro, opt_bits)
    t_trace = time.time() - t0
    trace = got["trace"]
    terms = trace.terms
    if trace.before is not None:
        terms = _per_step(terms, trace.before, n_micro)
    secs = terms.seconds(peak_flops=meshlib.PEAK_FLOPS_BF16,
                         hbm_bw=meshlib.HBM_BW,
                         ici_bw=meshlib.ICI_BW_PER_LINK)
    args, outs = got["argument_bytes"], got["output_bytes"]
    temp = got["persistent_bytes"] + trace.temp_bytes
    mf = model_flops(cfg, shape)
    ideal_compute_s = mf / meshlib.PEAK_FLOPS_BF16
    # Minimum-necessary HBM traffic: the step MUST read its arguments and
    # write its outputs once (params+opt for train; params+cache for
    # decode).  The binding roof is the larger of compute and that floor:
    # decode steps are legitimately memory-bound, not "bad compute".
    ideal_memory_s = (args + outs) / meshlib.HBM_BW
    ideal_s = max(ideal_compute_s, ideal_memory_s)
    bound_s = max(secs.values())
    dominant = max(secs, key=secs.get)
    return dict(
        trace_s=round(t_trace, 2), n_ops=trace.n_ops,
        n_params=count_params(api.layout(cfg)),
        memory={
            "argument_bytes": args,
            "output_bytes": outs,
            "temp_bytes": temp,
            "total_per_device": args + temp,
            "fits_80GB": (args + temp) < CARD_BYTES,
        },
        parsed={
            "flops": terms.flops,
            "hbm_bytes": terms.hbm_bytes,
            "coll_bytes": terms.coll_bytes,
            "coll_bytes_total": terms.coll_bytes_total,
            "coll_counts": {k: v for k, v in terms.coll_counts.items() if v},
        },
        roofline={
            "compute_s": secs["compute_s"],
            "memory_s": secs["memory_s"],
            "collective_s": secs["collective_s"],
            "dominant": dominant,
            "bound_s": bound_s,
            "model_flops_global": mf,
            "ideal_compute_s": ideal_compute_s,
            "ideal_memory_s": ideal_memory_s,
            "useful_flops_ratio": mf / max(terms.flops, 1.0),
            "roofline_fraction": ideal_s / max(bound_s, 1e-30),
        },
    )


def run_cell(arch: str, shape: str, n_micro: int | None = None,
             opt_bits: int | None = None,
             cfg_overrides: dict | None = None) -> dict:
    """The record of one (arch, shape) cell on one card (the module's
    docstring): status `ok`, `skipped` (`cell_applicable`'s reason) or
    `error` (the exception and its traceback: a failing cell is a
    finding)."""
    cfg = get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = SHAPES[shape]
    rec = {"arch": arch, "shape": shape, "chips": 1, "kind": cell.kind}
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    if n_micro is None:
        # One sequence a microbatch on the one device.
        n_micro = cell.global_batch if cell.kind == "train" else 1
    rec["n_micro"] = n_micro
    if opt_bits is None:
        # kimi-k2's 1T states need 8-bit moments (the reference's choice).
        opt_bits = 8 if cfg.name.startswith("kimi") else 32
    rec["opt_bits"] = opt_bits
    try:
        rec.update(status="ok", **size(cfg, shape, n_micro, opt_bits))
    except Exception as e:  # noqa: BLE001 — a failing cell is a finding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def _value(v: str):
    for kind in (int, float):
        try:
            return kind(v)
        except ValueError:
            pass
    return v


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="results/dryrun_torch.json")
    p.add_argument("--n-micro", type=int, default=None)
    p.add_argument("--opt-bits", type=int, default=None)
    p.add_argument("--cfg-set", nargs="*", default=[],
                   help="ArchConfig field overrides, e.g. n_layers=2")
    p.add_argument("--tag", default=None, help="variant tag of the records")
    p.add_argument("--force", action="store_true", help="rerun existing cells")
    args = p.parse_args(argv)

    cfg_overrides = {}
    for ov in args.cfg_set:
        k, v = ov.split("=", 1)
        cfg_overrides[k] = _value(v)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    done = {(r["arch"], r["shape"], r.get("tag")) for r in existing}

    for arch in archs:
        for shape in shapes:
            key = (arch, shape, args.tag)
            if key in done and not args.force:
                continue
            t0 = time.time()
            rec = run_cell(arch, shape, args.n_micro, opt_bits=args.opt_bits,
                           cfg_overrides=cfg_overrides or None)
            rec["tag"] = args.tag
            if cfg_overrides:
                rec["cfg_overrides"] = cfg_overrides
            existing = [r for r in existing
                        if (r["arch"], r["shape"], r.get("tag")) != key]
            existing.append(rec)
            with open(args.out, "w") as f:
                json.dump(existing, f, indent=1)
            status = rec.get("status")
            extra = ""
            if status == "ok":
                rl = rec["roofline"]
                extra = (f"dom={rl['dominant'][:-2]} "
                         f"bound={rl['bound_s'] * 1e3:.2f}ms "
                         f"frac={rl['roofline_fraction']:.3f} "
                         f"mem/dev={rec['memory']['total_per_device'] / 1e9:.2f}GB "
                         f"trace={rec['trace_s']}s")
            elif status == "error":
                extra = rec["error"][:120]
            print(f"[{time.time() - t0:6.1f}s] {arch:22s} {shape:12s} "
                  f"{status:8s} {extra}", flush=True)


if __name__ == "__main__":
    main()
