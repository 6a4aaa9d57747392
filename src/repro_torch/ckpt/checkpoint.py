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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..core.executor import resolve_device
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
        to disk async."""
        self.wait()
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

    def restore(self, step: int, tree_abstract, device=None) -> Any:
        """The tree of `tree_abstract`'s structure (tensors; meta tensors
        will do) rebuilt from step `step`, each leaf in the abstract leaf's
        dtype on `device` (the card unless the caller asks for the CPU)."""
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

        def walk(tree, key=""):
            if isinstance(tree, dict):
                return {k: walk(v, f"{key}/{k}" if key else str(k))
                        for k, v in tree.items()}
            return rebuild(key, tree)

        return walk(tree_abstract)
