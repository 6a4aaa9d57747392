"""The join mesh: a 1-D `torch.distributed` DeviceMesh of ranks.

`ShardedJoinExecutor(plan, n_devices, ..., mesh=make_join_mesh(...))` runs
the executor's n_devices logical devices over the mesh's W ranks, the
counterpart of the reference executor's `(mesh, axis)`: rank r owns the
logical devices [r·L, (r+1)·L), L = n_devices / W, and the exchange is one
`all_to_all` over the mesh's group.

One rank a process.  A rank's device is `cuda:LOCAL_RANK` by default and
its backend NCCL; two NCCL ranks never share a card (refused before any
collective).  gloo is taken only when the caller names it: on the CPU, or
for ranks that share one card.  No backend or device is switched quietly.

Launch on several cards with torchrun, which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc-per-node 4 my_join.py   # make_join_mesh() in each

or give `init_method` (`tcp://localhost:<port>`, `file://<path>`), `rank`
and `world_size` yourself.
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from ..core.executor import ExecutorError, resolve_device

AXIS = "cells"
BACKENDS = ("nccl", "gloo")


def _setting(value, name: str, default=None):
    if value is not None:
        return int(value)
    if name in os.environ:
        return int(os.environ[name])
    if default is None:
        raise ExecutorError(
            f"make_join_mesh: no {name.lower()} given and ${name} unset "
            f"(launch with torchrun, or pass init_method, rank and "
            f"world_size)")
    return default


def _card_id(device: torch.device) -> str:
    """The host and the card a CUDA device is, across processes."""
    props = torch.cuda.get_device_properties(device)
    card = getattr(props, "uuid", None) or f"index {device.index}"
    return f"{socket.gethostname()} / {card}"


def _refuse_shared_cards(store, rank: int, world_size: int,
                         device: torch.device, timeout) -> None:
    """Every NCCL rank posts its card to the rendezvous store before the
    process group exists; a card posted twice is refused on every rank."""
    keys = dist.PrefixStore("join_mesh/card", store)
    keys.set(str(rank), _card_id(device))
    names = [str(r) for r in range(world_size)]
    keys.wait(names, timeout)
    cards = [keys.get(name).decode() for name in names]
    mine = [r for r, card in enumerate(cards) if card == cards[rank]]
    if len(mine) > 1:
        raise ExecutorError(
            f"make_join_mesh: NCCL ranks {mine} would share the card "
            f"{cards[rank]}; NCCL takes one rank a card (name "
            f"backend='gloo' for ranks that share one)")


def make_join_mesh(backend: str | None = None, *, device=None,
                   init_method: str | None = None, rank: int | None = None,
                   world_size: int | None = None,
                   timeout_s: float = 300.0):
    """Initialise the default process group and return a 1-D DeviceMesh
    over all its ranks, the dimension named "cells".

    `rank` and `world_size` default to torchrun's RANK and WORLD_SIZE,
    `init_method` to `env://`.  `device` defaults to `cuda:LOCAL_RANK`
    ($LOCAL_RANK, else the rank; pass `device` for another card) and
    raises without a card; `backend` defaults to NCCL on the card, and
    must be named (`"gloo"`) on the CPU.  Refused: NCCL on the CPU, NCCL
    ranks sharing a card, a default group that exists already.  Every
    collective of the group waits at most `timeout_s`."""
    rank = _setting(rank, "RANK")
    world_size = _setting(world_size, "WORLD_SIZE")
    local_rank = _setting(None, "LOCAL_RANK", rank)
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "meta":
        raise ExecutorError("make_join_mesh: a rank needs a real device")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if backend is None:
        if dev.type != "cuda":
            raise ExecutorError(
                f"make_join_mesh: no backend named for a rank on {dev}; "
                f"name backend='gloo' (NCCL needs a card)")
        backend = "nccl"
    if backend not in BACKENDS:
        raise ExecutorError(f"make_join_mesh: backend {backend!r} is not "
                            f"one of {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ExecutorError(
                f"make_join_mesh: NCCL runs on the card, not on {dev}; "
                f"name backend='gloo' for ranks on the CPU")
        if dev.index >= torch.cuda.device_count():
            raise ExecutorError(
                f"make_join_mesh: rank {rank}'s card cuda:{dev.index} does "
                f"not exist ({torch.cuda.device_count()} cards): NCCL ranks "
                f"would share a card (one rank a card, or name "
                f"backend='gloo')")
    if dist.is_initialized():
        raise ExecutorError("make_join_mesh: the default process group "
                            "exists already")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(
        init_method or "env://", rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    if backend == "nccl":
        _refuse_shared_cards(store, rank, world_size, dev, timeout)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (world_size,), mesh_dim_names=(AXIS,))
