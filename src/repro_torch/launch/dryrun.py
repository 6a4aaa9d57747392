"""Dry run: size every (arch x shape x mesh) cell, allocating nothing.

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

Over a mesh of H100s (`--mesh`: the reference's "single" (16, 16)
("data", "model") and "multi" (2, 16, 16) ("pod", "data", "model"), or
"DxM" as `launch.train --mesh` takes it) the step runs over a fake world
of that many ranks (`launch.mesh.fake_world`: torch's fake process-group
backend, no card, nothing sent) with the rules the reference's run_cell
makes (`cell_rules`: the config's hints, then `--override`), as rank 0:
its blocks of the parameters, states and batch (DTensors), its own ops on
its local shards, its collectives by operand bytes and those whose group
spans pods (`coll_bytes_crosspod`).  The record is rank 0's, a card's:
`chips` is the mesh's size, `fits_80GB` a card's, `ideal_compute_s` the
model FLOPs over all the chips.  Every argument leaf splits evenly (the
rules shard only what divides), so each rank holds rank 0's argument
bytes (checked, `largest_rank`); a temporary DTensor split unevenly
follows torch.chunk, the first rank's chunk the largest, so rank 0's peak
is a rank's largest.  Collectives are timed at the card's NVLink rate
(`ICI_BW_PER_LINK`); a cross-pod rate is not modelled, as in the
reference.  On a CPU mesh DTensor moves a shard between dimensions by an
all-gather and a chunk (gloo has no all-to-all), so such a move counts as
an all-gather of the same operand bytes.

A train cell defaults to one sequence a DP rank a microbatch (`n_micro` =
global_batch // (pod·data); on one card, a sequence), the reference's
default.  One microbatch's step is traced, and the rest are reckoned:
FLOPs and bytes are n_micro x what comes before the update (the update,
which begins where it advances the optimizer's step counter, counted
once, as traced on one microbatch's gradients), memory is what persists
across microbatches (parameters, optimizer state and, when n_micro > 1,
the float32 gradient accumulator of `train_step`) plus the traced step's
peak.

With no `--mesh` the record is one card's, with no mesh key; `--mesh 1x1`
is the same trace (no process group opened) under the key "1x1".  The
reference's default mesh is "single".  Nothing here needs a card or
imports JAX.

Results append to a JSON file, keyed (arch, shape, mesh, tag) as the
reference's (resume-safe: a cell already in it is kept unless `--force`).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k \
      --mesh multi --override act_seq=model
  python -m repro_torch.launch.dryrun --all --mesh both \
      --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import (ARCHS, SHAPES, ShapeCell, cell_applicable, get,
                       input_specs)
from ..models import api
from torch.distributed.tensor import DTensor

from ..models.common import (ShardCtx, as_dtensor, count_params,
                             local_block, map_layout, mesh_shape, rules_for,
                             to_local)
from ..optim import AdamWConfig, adamw
from ..serve import build_decode_step, build_prefill
from ..serve.serve_step import mesh_cache
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


def _tensors(obj):
    """The tensors in `obj` (dicts, tuples and lists of tensors; a
    module's parameters; None)."""
    if isinstance(obj, torch.nn.Module):
        obj = list(obj.parameters())
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, torch.Tensor):
        yield obj


def nbytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors in `trees` (dicts,
    tuples and lists of tensors; a module's parameters; None); of a
    DTensor, this rank's block's."""
    seen: dict[int, int] = {}
    for t in _tensors(trees):
        s = to_local(t).untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _model(cfg, mesh=None, placements=None):
    """The family's model over uninitialised parameters (fake, under the
    caller's FakeTensorMode); over `mesh`, DTensors of `placements`, each
    this rank's block alone."""
    dtype = getattr(torch, cfg.param_dtype)

    def leaf(p, path):
        if mesh is None:
            return torch.empty(p.shape, dtype=dtype)
        pl = _at(placements, path)
        return as_dtensor(torch.empty(local_block(p.shape, pl, mesh)[0],
                                      dtype=dtype), p.shape, pl, mesh)

    return api.build(cfg, map_layout(api.layout(cfg), leaf))


def _empty(specs: dict, rows: int | None = None) -> dict:
    """Tensors of `specs`' shapes and dtypes (`rows` leading rows)."""
    return {k: torch.empty(((rows or v.shape[0]),) + tuple(v.shape[1:]),
                           dtype=v.dtype) for k, v in specs.items()}


def _rows_bytes(inputs: dict, mesh, rules, placements=None) -> int:
    """Bytes of this rank's rows of a step's global inputs over `mesh`:
    split by `placements` (a train batch's), else each input's rows over
    the DP axes where they divide (a serving input, `serve_step._rows`);
    all of them without a mesh."""
    if mesh is None:
        return nbytes(inputs)
    if placements is None:
        shd = ShardCtx(mesh, rules)
        placements = {k: shd.placements(v.shape, "batch",
                                        *(None,) * (v.dim() - 1))
                      for k, v in inputs.items()}
    return sum(math.prod(local_block(v.shape, placements[k], mesh)[0])
               * v.element_size() for k, v in inputs.items())


def _chunk(shape, placements, sizes, coord) -> int:
    """Elements of the block at mesh coordinate `coord` of a tensor of
    `shape` split by `placements` as DTensor splits (torch.chunk's: the
    first chunks the larger)."""
    size = list(shape)
    for pl, n, c in zip(placements, sizes, coord):
        if pl.is_shard():
            step = -(-size[pl.dim] // n)
            size[pl.dim] = max(0, min(step, size[pl.dim] - c * step))
    return math.prod(size)


def largest_rank(*trees) -> tuple[int, int]:
    """(rank, bytes beyond rank 0's) of the rank holding the most bytes of
    the DTensors in `trees` (the lowest such rank).  The rules shard only
    what divides, so every argument leaf splits evenly and rank 0 holds as
    much as any; a DTensor split unevenly takes torch.chunk's sizes, the
    first rank's the largest."""
    leaves = [t for t in _tensors(trees) if isinstance(t, DTensor)]
    if not leaves:
        return 0, 0
    sizes = tuple(leaves[0].device_mesh.shape)
    held = [sum(_chunk(t.shape, t.placements, sizes, coord)
                * t.element_size() for t in leaves)
            for coord in itertools.product(*map(range, sizes))]
    rank = max(range(len(held)), key=held.__getitem__)
    return rank, held[rank] - held[0]


def _cell(shape: str | ShapeCell) -> ShapeCell:
    return shape if isinstance(shape, ShapeCell) else SHAPES[shape]


def trace_cell(cfg, shape: str | ShapeCell, n_micro: int = 1,
               opt_bits: int = 32, mesh=None, rules=None) -> dict:
    """Trace the cell's step once on fake tensors, on one card or, over
    `mesh` (a DeviceMesh, usually `meshlib.fake_world`'s) in `rules`, as
    rank 0.  Returns {trace (the step's `op_analysis.Trace`: a train step
    of one microbatch, its counts split where the update begins),
    argument_parts (the bytes of this rank's parameters, its state (the
    optimizer's or the cache) and its inputs), argument_bytes (their
    sum), output_bytes, persistent_bytes (what a train step keeps across
    microbatches beyond its arguments), largest_rank (`largest_rank` of
    the parameters and the state)}."""
    cell = _cell(shape)
    specs = input_specs(cfg, cell)
    sizes = mesh_shape(mesh) if mesh is not None else {}
    pod_size = (math.prod(n for a, n in sizes.items() if a != "pod")
                if "pod" in sizes else None)
    acc = 0
    with FakeTensorMode():
        inputs = _empty(specs)           # the step's argument: every row
        if cell.kind == "train":
            B = cell.global_batch
            if B % n_micro:
                raise ValueError(f"global batch {B} does not split into "
                                 f"{n_micro} microbatches")
            ocfg = AdamWConfig(state_bits=opt_bits)
            fns = build_train_step(cfg, ocfg, device="cpu", mesh=mesh,
                                   rules=rules)
            model = _model(cfg, mesh, fns.param_placements)
            state = adamw.init(model.tree(), ocfg)
            # The counts split where the update advances the step counter.
            trace = op_analysis.analyze(
                fns.step, model, state, _empty(specs, B // n_micro),
                split_at=to_local(state["step"]), pod_size=pod_size)
            out = trace.out[2]
            if n_micro > 1:
                acc = 4 * sum(to_local(p).numel() for p in model.parameters())
        elif cell.kind == "prefill":
            fns = build_prefill(cfg, device="cpu", mesh=mesh, rules=rules)
            model, state = _model(cfg, mesh, fns.param_placements), None
            trace = op_analysis.analyze(fns.prefill, model, inputs,
                                        pod_size=pod_size)
            out = trace.out
        else:
            B, S = cell.global_batch, cell.seq_len
            fns = build_decode_step(cfg, B, S, device="cpu", mesh=mesh,
                                    rules=rules)
            model = _model(cfg, mesh, fns.param_placements)
            state = (api.init_cache(cfg, B, S, device="cpu") if mesh is None
                     else mesh_cache(cfg, fns))
            trace = op_analysis.analyze(fns.decode, model, state,
                                        inputs["tokens"], inputs["pos"],
                                        pod_size=pod_size)
            out = trace.out[0]
        placed = (fns.batch_placements(inputs)
                  if mesh is not None and cell.kind == "train" else None)
        parts = dict(params=nbytes(model), state=nbytes(state),
                     inputs=_rows_bytes(inputs, mesh, fns.rules, placed))
    return dict(trace=trace, argument_parts=parts,
                argument_bytes=sum(parts.values()), output_bytes=nbytes(out),
                persistent_bytes=acc, largest_rank=largest_rank(model, state))


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
        coll_bytes_crosspod=steps(terms.coll_bytes_crosspod,
                                  before.coll_bytes_crosspod),
        coll_counts={k: steps(v, before.coll_counts[k])
                     for k, v in terms.coll_counts.items()})


def size(cfg, shape: str | ShapeCell, n_micro: int = 1, opt_bits: int = 32,
         mesh=None, rules=None) -> dict:
    """One step of the cell on one card, or on rank 0 of `mesh` in
    `rules`: trace_s, n_ops, n_params and the record's memory, parsed and
    roofline fields (see the module's docstring).  `shape` is a name of
    SHAPES or a ShapeCell of other sizes."""
    t0 = time.time()
    got = trace_cell(cfg, shape, n_micro, opt_bits, mesh, rules)
    t_trace = time.time() - t0
    # Where a rank holds more than rank 0 (never under the rules: they
    # shard only what divides), its arguments are recorded.
    rank, beyond = got["largest_rank"]
    trace = got["trace"]
    terms = trace.terms
    if trace.before is not None:
        terms = _per_step(terms, trace.before, n_micro)
    secs = terms.seconds(peak_flops=meshlib.PEAK_FLOPS_BF16,
                         hbm_bw=meshlib.HBM_BW,
                         ici_bw=meshlib.ICI_BW_PER_LINK)
    args, outs = got["argument_bytes"] + beyond, got["output_bytes"]
    temp = got["persistent_bytes"] + trace.temp_bytes
    chips = 1 if mesh is None else mesh.size()
    mf = model_flops(cfg, shape)
    ideal_compute_s = mf / chips / meshlib.PEAK_FLOPS_BF16
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
            "argument_parts": got["argument_parts"],
            "largest_rank": rank,
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
            "coll_bytes_crosspod": terms.coll_bytes_crosspod,
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
            "useful_flops_ratio": (mf / chips) / max(terms.flops, 1.0),
            "roofline_fraction": ideal_s / max(bound_s, 1e-30),
        },
    )


def cell_rules(cfg, mesh, rules_overrides=None):
    """The rules of a cell over `mesh`, as the reference's `run_cell`
    makes them: `default_rules` overridden by the config's
    `sharding_hints`, then by `rules_overrides`.  The builders take them
    as given (MoE decode then adds its own override, as the reference's
    `build_decode_step` does)."""
    rules = rules_for(cfg, mesh)
    if rules_overrides:
        rules = rules.override(**rules_overrides)
    return rules


def run_cell(arch: str, shape: str | ShapeCell, mesh_kind: str | None = None,
             rules_overrides: dict | None = None, n_micro: int | None = None,
             opt_bits: int | None = None,
             cfg_overrides: dict | None = None) -> dict:
    """The record of one (arch, shape, mesh) cell (the module's
    docstring): status `ok`, `skipped` (`cell_applicable`'s reason) or
    `error` (the exception and its traceback: a failing cell is a
    finding).  `shape` is a name of SHAPES or a ShapeCell of other sizes.
    `mesh_kind` None (one card) or "1x1" traces the one-card step and
    opens no process group; "single", "multi", "DxM" or "PxDxM" trace
    rank 0 of that mesh in a fake world."""
    cfg = get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = _cell(shape)
    dims = (1, 1) if mesh_kind is None else meshlib.dryrun_shape(mesh_kind)
    chips = math.prod(dims)
    rec = {"arch": arch, "shape": cell.name, "chips": chips,
           "kind": cell.kind}
    if mesh_kind is not None:
        rec.update(mesh=mesh_kind, mesh_shape=list(dims))
    if rules_overrides:
        rec["overrides"] = {k: str(v) for k, v in rules_overrides.items()}
    ok, reason = (cell_applicable(cfg, cell.name) if cell.name in SHAPES
                  else (True, ""))
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    if n_micro is None:
        # The reference's deployable default: one sequence a DP rank a
        # microbatch (on one card, a sequence).
        dp = math.prod(dims[:-1])
        n_micro = (max(1, cell.global_batch // dp) if cell.kind == "train"
                   else 1)
    rec["n_micro"] = n_micro
    if opt_bits is None:
        # kimi-k2's 1T states need 8-bit moments (the reference's choice).
        opt_bits = 8 if cfg.name.startswith("kimi") else 32
    rec["opt_bits"] = opt_bits
    try:
        if chips == 1:
            rec.update(status="ok", **size(cfg, shape, n_micro, opt_bits))
        else:
            with meshlib.fake_world(dims) as mesh:
                rules = cell_rules(cfg, mesh, rules_overrides)
                rec.update(status="ok", **size(cfg, shape, n_micro, opt_bits,
                                               mesh, rules))
    except Exception as e:  # noqa: BLE001 — a failing cell is a finding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def parse_overrides(items) -> dict:
    """`--override` items (`act_seq=model embed=None`) as the reference
    parses them: None / none / empty for None, a comma for a tuple of
    axes, else the axis name."""
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        if v in ("None", "none", ""):
            overrides[k] = None
        elif "," in v:
            overrides[k] = tuple(v.split(","))
        else:
            overrides[k] = v
    return overrides


def _value(v: str):
    for kind in (int, float):
        try:
            return kind(v)
        except ValueError:
            pass
    return v


def _key(rec) -> tuple:
    """A record's key, the reference's (arch, shape, mesh, tag); a
    one-card record's mesh is None."""
    return rec["arch"], rec["shape"], rec.get("mesh"), rec.get("tag")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", default=None,
                   help="single | multi | both | DxM | PxDxM (default: one "
                        "card, no process group)")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="results/dryrun_torch.json")
    p.add_argument("--n-micro", type=int, default=None)
    p.add_argument("--opt-bits", type=int, default=None)
    p.add_argument("--override", nargs="*", default=[],
                   help="rules overrides, e.g. act_seq=model embed=None")
    p.add_argument("--cfg-set", nargs="*", default=[],
                   help="ArchConfig field overrides, e.g. n_layers=2")
    p.add_argument("--tag", default=None, help="variant tag of the records")
    p.add_argument("--force", action="store_true", help="rerun existing cells")
    args = p.parse_args(argv)

    overrides = parse_overrides(args.override)
    cfg_overrides = {}
    for ov in args.cfg_set:
        k, v = ov.split("=", 1)
        cfg_overrides[k] = _value(v)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    for mk in meshes:
        if mk is not None:
            meshlib.dryrun_shape(mk)          # refused before any trace

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    done = {_key(r) for r in existing}

    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                key = (arch, shape, mk, args.tag)
                if key in done and not args.force:
                    continue
                t0 = time.time()
                rec = run_cell(arch, shape, mk, overrides or None,
                               args.n_micro, opt_bits=args.opt_bits,
                               cfg_overrides=cfg_overrides or None)
                rec["tag"] = args.tag
                if cfg_overrides:
                    rec["cfg_overrides"] = cfg_overrides
                existing = [r for r in existing if _key(r) != key]
                existing.append(rec)
                with open(args.out, "w") as f:
                    json.dump(existing, f, indent=1)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    rl, mem = rec["roofline"], rec["memory"]
                    extra = (f"dom={rl['dominant'][:-2]} "
                             f"bound={rl['bound_s'] * 1e3:.2f}ms "
                             f"frac={rl['roofline_fraction']:.3f} "
                             f"mem/dev={mem['total_per_device'] / 1e9:.2f}GB "
                             f"coll={rec['parsed']['coll_bytes_total'] / 1e9:.3f}GB "
                             f"xpod={rec['parsed']['coll_bytes_crosspod'] / 1e9:.3f}GB "
                             f"trace={rec['trace_s']}s")
                elif status == "error":
                    extra = rec["error"][:120]
                print(f"[{time.time() - t0:6.1f}s] {arch:22s} {shape:12s} "
                      f"{mk or 'card':6s} {status:8s} {extra}", flush=True)


if __name__ == "__main__":
    main()
