"""Build and bind the CUDA kernels: nvcc -> one shared library -> ctypes.

The sources under `csrc/` expose a plain C interface (no PyTorch headers),
so each `.cu` compiles in seconds.  All sources compile in parallel, one
nvcc process each, and link into one `.so` named by a digest of the sources
and flags, under `build/kernels/` at the repository root (listed in
.gitignore).  A library whose digest matches is reused.  The build runs at
first use, never at import: `lib()` builds and loads on first call.

Every launch function returns a cudaError_t; `call` raises `KernelError`
on anything but success.  Nothing here falls back to the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# argtypes of every C entry point (pointers and the stream as c_void_p).
SIGNATURES = {
    "map_count_launch": [P, LL, I, P, I, I, I, I, LL, P, P],
    "scatter_pack_launch": [P, I, LL, I, P, I, I, P, I, I, I, I, LL, P, P, P,
                            P, P],
    "join_hash_launch": [P, P, LL, I, I, P, P],
    "build_table_launch": [P, P, I, I, I, I, I, I, P, P, P, P, P, P, P, P, P,
                           P],
    "probe_tables_launch": [P, P, I, I, P, P, P, P, LL, I, I, I, I, P, P, P,
                            P, P, P, P, P, P, P, P],
    "expand_rows_launch": [P, P, P, P, P, I, LL, I, LL, I, LL, P, I, P, I, I,
                           LL, P, P, P, P, LL, P, P, P, P],
    "route_cells_launch": [P, LL, I, P, I, P, P],
    "fold_cells_launch": [P, LL, P, I, P, P],
    "bucket_pack_launch": [P, P, I, LL, I, I, I, I, LL, I, P, P, P, P, P, P],
    "segment_scan_launch": [P, I, LL, I, I, LL, P, P, P, P, P, P],
    "map_pack_launch": [P, I, LL, I, P, I, I, I, P, I, I, I, LL, P, P, P, I,
                        I, P, P, P, P],
    "hash_partition_launch": [P, LL, LL, I, P, P, P],
    "match_counts_launch": [P, LL, P, LL, I, LL, I, I, P, P, P],
    "first_match_launch": [P, LL, P, LL, I, LL, I, I, P, P, P],
    "segment_histogram_launch": [P, LL, I, I, I, I, P, P, P],
}


# Kernel launches per wrapper, keyed by the entry point's name without
# `_launch`: `call` adds one after each successful launch, and nothing else
# does.  Wrappers skip the call when their input is empty.
LAUNCHES: dict[str, int] = {name.removesuffix("_launch"): 0
                            for name in SIGNATURES}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


_lib: ctypes.CDLL | None = None
build_seconds = 0.0     # wall time of the last build (0 when reused)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels build only on a "
                          "machine with the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Path of the built library, building it first if needed."""
    global build_seconds
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode() + f.read_bytes())
    so = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    if so.exists():
        build_seconds = 0.0
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise KernelError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(library_path()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.repro_cuda_error_string.argtypes = [ctypes.c_int]
        handle.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def as_i32(t, name: str):
    """A contiguous int32 CUDA tensor for a kernel argument, else raise."""
    if t.device.type != "cuda":
        raise KernelError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise KernelError(f"{name}: expected int32, got {t.dtype}")
    return t.contiguous()


def as_bool(t, name: str):
    """A contiguous one-byte (bool) CUDA tensor for a kernel argument."""
    if t.device.type != "cuda":
        raise KernelError(f"{name}: expected a CUDA tensor, got {t.device}")
    return t.to(torch.bool).contiguous()


def stream(t) -> int:
    """The current CUDA stream of `t`'s device, as the integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def call(name: str, *args) -> None:
    """Launch one C entry point; raise `KernelError` if it reports an error."""
    handle = lib()
    rc = getattr(handle, name)(*args)
    if rc != 0:
        msg = handle.repro_cuda_error_string(rc).decode()
        raise KernelError(f"{name} failed: cudaError {rc} ({msg})")
    LAUNCHES[name.removesuffix("_launch")] += 1
