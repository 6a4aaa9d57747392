"""Elastic re-meshing: rebuild the mesh from surviving ranks and restore.

Over ranks the mesh is a `DeviceMesh` ("data", "model") of
`launch.mesh.make_lm_mesh`; on one card the reference's device mesh is a
logical grid of rank ids (`LogicalMesh`), which the one-device driver
keeps.  The failure response path (as in the reference):
  1. HealthMonitor reports failed nodes;
  2. `survivors_mesh` builds the largest power-of-two DP mesh from the
     surviving rows (the model axis kept: a node loss removes whole DP
     rows);
  3. `elastic_remesh` restores the latest committed checkpoint (over a
     DeviceMesh in the placements the new mesh gives, the resharding
     restore), and the caller rebuilds its step functions.
The step's arithmetic does not depend on the DP degree: the global batch
is a pure function of (seed, step) (data/pipeline.py), so a re-mesh
changes no number.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:      # the checkpointer imports DTensor and the LM's layouts
    from ..ckpt.checkpoint import Checkpointer


@dataclass(frozen=True)
class LogicalMesh:
    """A named grid of rank ids: `devices` (an int array), `axis_names`."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def logical_mesh(shape: tuple[int, ...] = (2, 4),
                 axis_names: tuple[str, ...] = ("data", "model")
                 ) -> LogicalMesh:
    """Ranks 0 .. prod(shape) - 1 laid out row-major over `axis_names` (the
    default is the reference's test mesh on 8 devices)."""
    return LogicalMesh(np.arange(int(np.prod(shape))).reshape(shape),
                       tuple(axis_names))


def survivors_mesh(mesh, failed_dp_rows: list[int]):
    """New mesh without the failed data-parallel rows (power-of-two
    trimmed), the model axis kept.  A DeviceMesh gives a DeviceMesh over
    the kept ranks: every rank of the default group must call this (each
    builds the new mesh's groups), and a rank outside the new mesh gets no
    coordinate (`get_coordinate()` is None) and leaves the step."""
    if not isinstance(mesh, LogicalMesh):
        from ..launch.mesh import lm_mesh
        kept = survivors_mesh(LogicalMesh(mesh.mesh.numpy(),
                                          tuple(mesh.mesh_dim_names)),
                              failed_dp_rows)
        return lm_mesh(mesh.device_type, kept.devices.shape,
                       ranks=kept.devices.reshape(-1))
    axes = list(mesh.axis_names)
    devs = np.asarray(mesh.devices)
    dp_axis = axes.index("data")
    keep = [i for i in range(devs.shape[dp_axis]) if i not in failed_dp_rows]
    # Largest power of two ≤ survivors keeps shardings divisible.
    n = 1
    while n * 2 <= len(keep):
        n *= 2
    keep = keep[:n]
    return LogicalMesh(np.take(devs, keep, axis=dp_axis), mesh.axis_names)


def elastic_remesh(ckptr: Checkpointer, tree_abstract, device=None, *,
                   placements=None, mesh=None):
    """Restore the latest committed checkpoint (onto `device`: the card
    unless the caller asks for the CPU; over `mesh`, each leaf in its
    `placements`, on the rank's device by default); returns (step,
    tree)."""
    step = ckptr.latest_step()
    if step is None:
        raise RuntimeError("no committed checkpoint to restore from")
    return step, ckptr.restore(step, tree_abstract, device,
                               placements=placements, mesh=mesh)
