"""The meshes of ranks: the join's 1-D mesh, the LM's (data, model) or
(pod, data, model) mesh, and the dry run's fake world.

`ShardedJoinExecutor(plan, n_devices, ..., mesh=make_join_mesh(...))` runs
the executor's n_devices logical devices over the mesh's W ranks, the
counterpart of the reference executor's `(mesh, axis)`: rank r owns the
logical devices [r·L, (r+1)·L), L = n_devices / W, and the exchange is one
`all_to_all` over the mesh's group.

One rank a process.  A rank's device is `cuda:LOCAL_RANK` by default and
its backend NCCL; two NCCL ranks never share a card (refused before any
collective).  gloo is taken only when the caller names it: on the CPU, or
for ranks that share one card.  No backend or device is switched quietly.

`make_lm_mesh(shape)` is the counterpart of the reference's
`make_test_mesh` / `make_mesh_compat` for the LM scaffold: a 2-D mesh
("data", "model") or a 3-D one ("pod", "data", "model") over the same
process-group set-up (`init_ranks`), ranks laid out row-major (rank r at
(r // model, r % model) on two axes), the reference's device order.  The
train step lays the parameters, optimizer states and batch out over it
through the sharding rules (`models.common`: DP over ("pod", "data")).

`fake_world(shape)` is the dry run's counterpart of the reference's
`make_production_mesh` (`dryrun_shape`: "single" (16, 16), "multi" (2,
16, 16), or "DxM"): torch's fake process group of the mesh's size, this
process rank 0, and the DeviceMesh over it.  Nothing is sent and no card
is needed; the steps run on fake tensors over it (`launch.dryrun`).

Launch on several cards with torchrun, which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc-per-node 4 my_join.py   # make_join_mesh() in each

or give `init_method` (`tcp://localhost:<port>`, `file://<path>`), `rank`
and `world_size` yourself.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import socket

import torch
import torch.distributed as dist

from ..core.executor import ExecutorError, resolve_device

# One NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, NVIDIA's data sheet
# (dense rates): the roofline rates of `launch.dryrun`, under the
# reference's names.  ICI_BW_PER_LINK is the card's NVLink, 450 GB/s each
# way (18 links).
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
ICI_BW_PER_LINK = 450e9           # B/s

AXIS = "cells"
BACKENDS = ("nccl", "gloo")


def _setting(value, name: str, who: str, default=None):
    if value is not None:
        return int(value)
    if name in os.environ:
        return int(os.environ[name])
    if default is None:
        raise ExecutorError(
            f"{who}: no {name.lower()} given and ${name} unset "
            f"(launch with torchrun, or pass init_method, rank and "
            f"world_size)")
    return default


def _card_id(device: torch.device) -> str:
    """The host and the card a CUDA device is, across processes."""
    props = torch.cuda.get_device_properties(device)
    card = getattr(props, "uuid", None) or f"index {device.index}"
    return f"{socket.gethostname()} / {card}"


def _refuse_shared_cards(store, rank: int, world_size: int,
                         device: torch.device, timeout, who: str) -> None:
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
            f"{who}: NCCL ranks {mine} would share the card "
            f"{cards[rank]}; NCCL takes one rank a card (name "
            f"backend='gloo' for ranks that share one)")


def init_ranks(backend: str | None = None, *, device=None,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None, timeout_s: float = 300.0,
               who: str = "init_ranks") -> tuple[torch.device, int]:
    """Initialise the default process group; returns (this rank's device,
    the world size).

    `rank` and `world_size` default to torchrun's RANK and WORLD_SIZE,
    `init_method` to `env://`.  `device` defaults to `cuda:LOCAL_RANK`
    ($LOCAL_RANK, else the rank; pass `device` for another card) and
    raises without a card; `backend` defaults to NCCL on the card, and
    must be named (`"gloo"`) on the CPU.  Refused: NCCL on the CPU, NCCL
    ranks sharing a card, a default group that exists already.  Every
    collective of the group waits at most `timeout_s`.  `who` names the
    caller in the refusals."""
    rank = _setting(rank, "RANK", who)
    world_size = _setting(world_size, "WORLD_SIZE", who)
    local_rank = _setting(None, "LOCAL_RANK", who, rank)
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "meta":
        raise ExecutorError(f"{who}: a rank needs a real device")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if backend is None:
        if dev.type != "cuda":
            raise ExecutorError(
                f"{who}: no backend named for a rank on {dev}; "
                f"name backend='gloo' (NCCL needs a card)")
        backend = "nccl"
    if backend not in BACKENDS:
        raise ExecutorError(f"{who}: backend {backend!r} is not "
                            f"one of {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ExecutorError(
                f"{who}: NCCL runs on the card, not on {dev}; "
                f"name backend='gloo' for ranks on the CPU")
        if dev.index >= torch.cuda.device_count():
            raise ExecutorError(
                f"{who}: rank {rank}'s card cuda:{dev.index} does "
                f"not exist ({torch.cuda.device_count()} cards): NCCL ranks "
                f"would share a card (one rank a card, or name "
                f"backend='gloo')")
    if dist.is_initialized():
        raise ExecutorError(f"{who}: the default process group "
                            "exists already")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(
        init_method or "env://", rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    if backend == "nccl":
        _refuse_shared_cards(store, rank, world_size, dev, timeout, who)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    return dev, world_size


def make_join_mesh(backend: str | None = None, *, device=None,
                   init_method: str | None = None, rank: int | None = None,
                   world_size: int | None = None,
                   timeout_s: float = 300.0):
    """Initialise the default process group (`init_ranks`, its arguments
    and refusals) and return a 1-D DeviceMesh over all its ranks, the
    dimension named "cells"."""
    dev, world_size = init_ranks(backend, device=device,
                                 init_method=init_method, rank=rank,
                                 world_size=world_size, timeout_s=timeout_s,
                                 who="make_join_mesh")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (world_size,), mesh_dim_names=(AXIS,))


LM_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def lm_axes(ndim: int) -> tuple[str, ...]:
    """The axis names of an LM mesh of `ndim` dimensions."""
    if ndim not in (2, 3):
        raise ExecutorError(f"an LM mesh has 2 or 3 dimensions, not {ndim}")
    return LM_AXES if ndim == 2 else POD_AXES


def make_lm_mesh(shape: tuple[int, ...], backend: str | None = None, *,
                 device=None, init_method: str | None = None,
                 rank: int | None = None, world_size: int | None = None,
                 timeout_s: float = 300.0):
    """Initialise the default process group (`init_ranks`, its arguments
    and refusals) and return a DeviceMesh of `shape` over its ranks, named
    `lm_axes`, laid out row-major (rank r at (r // model, r % model) on two
    axes).  The product of `shape` must be the world size."""
    dev, world_size = init_ranks(backend, device=device,
                                 init_method=init_method, rank=rank,
                                 world_size=world_size, timeout_s=timeout_s,
                                 who="make_lm_mesh")
    shape = tuple(shape)
    if math.prod(shape) != world_size or len(shape) not in (2, 3):
        dist.destroy_process_group()
        raise ExecutorError(
            f"make_lm_mesh: a mesh of shape {shape} over axes "
            f"{LM_AXES} or {POD_AXES} does not hold the {world_size} ranks")
    return lm_mesh(dev.type, shape)


def lm_mesh(device_type: str, shape: tuple[int, ...], ranks=None):
    """A DeviceMesh of `shape` over `ranks` (default: every rank of the
    default group, in order), laid out row-major and named `lm_axes`.
    Every rank of the default group must call it (each builds the
    sub-groups); a rank outside `ranks` gets no coordinate."""
    from torch.distributed.device_mesh import DeviceMesh
    ids = (torch.arange(math.prod(shape)) if ranks is None
           else torch.as_tensor(ranks))
    return DeviceMesh(device_type, ids.reshape(tuple(shape)),
                      mesh_dim_names=lm_axes(len(shape)))


# The reference's production meshes (`make_production_mesh`), by its names.
PRODUCTION_MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def dryrun_shape(kind: str) -> tuple[int, ...]:
    """The mesh shape the dry run's `--mesh` names: "single" (16, 16) or
    "multi" (2, 16, 16), as the reference's `make_production_mesh`, or
    "DxM" (data x model, as `launch.train --mesh`) or "PxDxM"."""
    if kind in PRODUCTION_MESHES:
        return PRODUCTION_MESHES[kind]
    try:
        shape = tuple(int(n) for n in kind.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ExecutorError(f"mesh {kind!r}: not 'single', 'multi', 'DxM' "
                            f"or 'PxDxM'")
    return shape


@contextlib.contextmanager
def fake_world(shape: tuple[int, ...]):
    """A fake world of prod(shape) ranks and the DeviceMesh of `shape`
    over it (named `lm_axes`, on the CPU), this process rank 0, at
    position (0, ..., 0): torch's "fake" process-group backend, whose
    collectives move nothing (over fake tensors they never reach it).
    Refused while a default process group exists; the world is destroyed
    on leaving, so a later process group in this process starts clean."""
    if dist.is_initialized():
        raise ExecutorError("fake_world: the default process group exists "
                            "already")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = tuple(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield lm_mesh("cpu", shape)
    finally:
        dist.destroy_process_group()
