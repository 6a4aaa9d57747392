"""Elastic re-meshing: rebuild the mesh from surviving ranks and restore.

On one card the reference's (data, model) device mesh is a logical grid
of rank ids (`LogicalMesh`), the n_dev axis the executor keeps as a
tensor axis.  The failure response path (as in the reference):
  1. HealthMonitor reports failed nodes;
  2. `survivors_mesh` builds the largest power-of-two DP mesh from the
     surviving rows (the model axis kept: a node loss removes whole DP
     rows);
  3. `elastic_remesh` restores the latest committed checkpoint, and the
     caller rebuilds its step functions.
The step's arithmetic does not depend on the DP degree: the global batch
is a pure function of (seed, step) (data/pipeline.py), so a re-mesh
changes no number.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


def survivors_mesh(mesh: LogicalMesh, failed_dp_rows: list[int]
                   ) -> LogicalMesh:
    """New mesh without the failed data-parallel rows (power-of-two trimmed)."""
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


def elastic_remesh(ckptr: Checkpointer, tree_abstract, device=None):
    """Restore the latest committed checkpoint (onto `device`: the card
    unless the caller asks for the CPU); returns (step, tree)."""
    step = ckptr.latest_step()
    if step is None:
        raise RuntimeError("no committed checkpoint to restore from")
    return step, ckptr.restore(step, tree_abstract, device)
