"""Async, restart-safe checkpointing in the reference package's format.

Layout on disk (the reference's, `repro/ckpt/checkpoint.py`):
    <dir>/step_<N>/manifest.json        tree structure, shapes, dtypes, step
    <dir>/step_<N>/shard_0.npz          the leaves' raw bytes
    <dir>/step_<N>/COMMITTED            written LAST -> crash-atomic

The keys are the tree's `/`-joined dict keys, sorted at each level (the
order `jax.tree_util` flattens a dict in), each leaf stored as the raw
bytes of its one shard (`<key>::0`, index = the whole array).  So a
checkpoint written by either package restores in the other: dtypes are
named as numpy names them ("bfloat16" too) and read back without numpy
knowing bf16 (the bytes are viewed as the torch dtype).  A checkpoint the
reference wrote on several devices holds several shards a leaf, each with
its index; restore places each.

The save snapshots every leaf to host memory before it returns (a
blocking copy, so training may go on updating the tensors in place), and
writes on a background thread; `wait()` joins it before the next save or
at exit.

Over a mesh (a tree of DTensors) every rank writes only its own blocks,
`shard_<rank>.npz`, each block under `<key>::<rank>` with its global
index, as the reference's hosts write their addressable shards; a block
replicated over some mesh dimensions is written once, by the rank at
coordinate 0 along them.  No rank gathers a leaf.  When every rank of the
mesh has written (a barrier over the mesh), the rank at the mesh's origin
writes the manifest, whose indices it computes for every rank, and then
COMMITTED; a mesh save returns after that (it is blocking).  `restore(...,
placements=, mesh=)` rebuilds each leaf in the placements it is given on
any mesh shape: each rank reads only the stored blocks that meet its own
block and assembles that block alone.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.executor import mesh_device, resolve_device
from ..models.common import as_dtensor, block_at, local_block
from ..tree import flatten

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
           torch.float16: "float16", torch.float64: "float64",
           torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
           torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Snapshot the tree's tensors to host memory synchronously, write
        to disk async (over a mesh: each rank its blocks, blocking)."""
        self.wait()
        flat = flatten(tree)
        if any(isinstance(t, DTensor) for t in flat.values()):
            self._save_over_mesh(step, flat)
            return
        host: dict[str, torch.Tensor] = {}
        meta: dict[str, Any] = {}
        for key, leaf in flatten(tree).items():
            t = leaf.detach()
            host[key] = t.to("cpu", copy=True)
            meta[key] = {"shape": list(t.shape), "dtype": _DTYPES[t.dtype]}

        def write():
            path = os.path.join(self.dir, f"step_{step}")
            os.makedirs(path, exist_ok=True)
            arrays, index_meta = {}, {}
            for key, t in host.items():
                arrays[f"{key}::0"] = t.contiguous().reshape(-1).view(
                    torch.uint8).numpy()
                index_meta[f"{key}::0"] = [[[None, None, None]] * t.ndim,
                                           list(t.shape)]
            np.savez(os.path.join(path, "shard_0.npz"), **arrays)
            with open(os.path.join(path, "manifest.json"), "w") as f:
                json.dump({"step": step, "meta": meta,
                           "indices": index_meta}, f)
            with open(os.path.join(path, "COMMITTED"), "w") as f:
                f.write("ok")
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _save_over_mesh(self, step: int, flat: dict) -> None:
        mesh = next(t.device_mesh for t in flat.values()
                    if isinstance(t, DTensor))
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("save: this rank is not in the tree's mesh")
        path = os.path.join(self.dir, f"step_{step}")
        os.makedirs(path, exist_ok=True)
        rank = dist.get_rank()
        arrays, meta, indices = {}, {}, {}
        for key, leaf in flat.items():
            if not isinstance(leaf, DTensor) or leaf.device_mesh != mesh:
                raise ValueError(f"save: {key} is not a DTensor of the "
                                 f"tree's mesh")
            meta[key] = {"shape": list(leaf.shape),
                         "dtype": _DTYPES[leaf.dtype]}
            for r, c in _mesh_ranks(mesh):
                if not _writes(leaf.placements, c):
                    continue
                shape, offset = block_at(leaf.shape, leaf.placements,
                                         mesh.shape, c)
                indices[f"{key}::{r}"] = [
                    [[o, o + n, None] for o, n in zip(offset, shape)],
                    list(shape)]
                if r == rank:
                    arrays[f"{key}::{r}"] = leaf.to_local().detach().to(
                        "cpu").contiguous().reshape(-1).view(
                        torch.uint8).numpy()
        np.savez(os.path.join(path, f"shard_{rank}.npz"), **arrays)
        _mesh_barrier(mesh)
        if all(c == 0 for c in coord):
            with open(os.path.join(path, "manifest.json"), "w") as f:
                json.dump({"step": step, "meta": meta, "indices": indices},
                          f)
            with open(os.path.join(path, "COMMITTED"), "w") as f:
                f.write("ok")
            self._gc()
        _mesh_barrier(mesh)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, tree_abstract, device=None, *,
                placements=None, mesh=None) -> Any:
        """The tree of `tree_abstract`'s structure (tensors; meta tensors
        will do) rebuilt from step `step`, each leaf in the abstract leaf's
        dtype on `device` (the card unless the caller asks for the CPU).
        With `mesh` and `placements` (a tree of the abstract's keys), each
        leaf is a DTensor of its placements on `mesh` (on the rank's
        device by default), whatever mesh wrote the checkpoint."""
        if mesh is not None:
            return self._restore_over_mesh(step, tree_abstract, placements,
                                           mesh, device)
        dev = resolve_device(device)
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        # Every host file present (a single host loads all).
        chunks: dict[str, list[tuple[tuple, torch.Tensor]]] = {}
        for name in sorted(os.listdir(path)):
            if not name.startswith("shard_"):
                continue
            with np.load(os.path.join(path, name)) as z:
                for k in z.files:
                    key, _ = k.rsplit("::", 1)
                    idx_spec, shard_shape = manifest["indices"][k]
                    dtype = _BY_NAME[manifest["meta"][key]["dtype"]]
                    data = torch.from_numpy(np.array(z[k])).view(
                        dtype).reshape(shard_shape)
                    idx = tuple(slice(a, b, c) for a, b, c in idx_spec)
                    chunks.setdefault(key, []).append((idx, data))

        def rebuild(key, abs_leaf):
            if key not in chunks:
                raise KeyError(f"{key} not in the checkpoint of step {step}")
            shape = tuple(abs_leaf.shape)
            full = torch.empty(shape, dtype=chunks[key][0][1].dtype)
            for idx, data in chunks[key]:
                full[idx] = data
            return full.to(device=dev, dtype=abs_leaf.dtype)

        return _walk(tree_abstract, rebuild)

    def _restore_over_mesh(self, step, tree_abstract, placements, mesh,
                           device):
        if mesh.get_coordinate() is None:
            raise ValueError("restore: this rank is not in the mesh")
        dev = resolve_device(mesh_device(mesh) if device is None else device)
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_key: dict[str, list[tuple[str, str]]] = {}
        files = {}
        for name in sorted(os.listdir(path)):
            if name.startswith("shard_"):
                files[name] = np.load(os.path.join(path, name))
                for k in files[name].files:
                    by_key.setdefault(k.rsplit("::", 1)[0], []).append(
                        (name, k))
        flat_pl = flatten(placements)

        def rebuild(key, abs_leaf):
            if key not in by_key:
                raise KeyError(f"{key} not in the checkpoint of step {step}")
            shape = tuple(abs_leaf.shape)
            pl = flat_pl[key]
            local, offset = local_block(shape, pl, mesh)
            dtype = _BY_NAME[manifest["meta"][key]["dtype"]]
            out = torch.empty(local, dtype=dtype)
            for name, k in by_key[key]:
                idx_spec, stored = manifest["indices"][k]
                lo = [0 if a is None else a for a, _, _ in idx_spec]
                # The part of the stored block inside this rank's block.
                src, dst = [], []
                for d in range(len(shape)):
                    a = max(lo[d], offset[d])
                    b = min(lo[d] + stored[d], offset[d] + local[d])
                    if a >= b:
                        break
                    src.append(slice(a - lo[d], b - lo[d]))
                    dst.append(slice(a - offset[d], b - offset[d]))
                else:
                    data = torch.from_numpy(np.array(files[name][k])).view(
                        dtype).reshape(stored)
                    out[tuple(dst)] = data[tuple(src)]
            return as_dtensor(out.to(device=dev, dtype=abs_leaf.dtype),
                              shape, pl, mesh)

        try:
            return _walk(tree_abstract, rebuild)
        finally:
            for z in files.values():
                z.close()


def _walk(tree, rebuild, key=""):
    if isinstance(tree, dict):
        return {k: _walk(v, rebuild, f"{key}/{k}" if key else str(k))
                for k, v in tree.items()}
    return rebuild(key, tree)


def _mesh_ranks(mesh):
    """(global rank, coordinate) of every rank of a DeviceMesh."""
    grid = mesh.mesh.numpy()
    return [(int(grid[c]), c) for c in np.ndindex(grid.shape)]


def _writes(placements, coord) -> bool:
    """Whether the rank at `coord` writes its block: it is at 0 along every
    mesh dimension that replicates the leaf."""
    return all(c == 0 for c, pl in zip(coord, placements)
               if not pl.is_shard())


def _mesh_barrier(mesh) -> None:
    """Every rank of the mesh has arrived: a barrier along each of its
    dimensions in turn."""
    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))
