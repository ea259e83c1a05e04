"""Device meshes on ``torch.distributed``.

A ``Mesh`` lays the processes of one job out on named axes, ("data",
"model") or ("pod", "data", "model"), in row-major rank order, as
``jax.make_mesh`` lays out its devices: the last axis varies fastest.  It
holds this rank's coordinates and one process group per axis, plus one
over the machine axes (every axis but "model"), the group that the
MapReduce gathers run over.  The model axis splits the feature dimension
of the oracle (``functions.TPOracle``).

The caller initializes the default process group and picks its backend:
NCCL for one rank per card, gloo for the CPU and for several ranks that
share one card.  Nothing here switches backend or device when the one
asked for fails.  Every rank builds the same meshes in the same order:
``dist.new_group`` is a collective call of the whole job.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Tuple

import numpy as np
import torch.distributed as dist

#: the axis the oracle's features are split over; every other axis holds
#: MapReduce machines
MODEL_AXIS = "model"


class Mesh:
    """This rank's place on a mesh of ``shape`` over ``axis_names``.

    ``shape`` and ``coords`` map each axis to its size and to this rank's
    index along it; ``group(axes)`` is the process group of the ranks that
    share this rank's coordinates on every other axis, ordered by their
    index along ``axes`` (row-major over several axes), so a rank's rank
    in that group is its index along the axes."""

    def __init__(self, shape, axis_names):
        if not dist.is_initialized():
            raise RuntimeError("Mesh: initialize the default process group "
                               "first (torch.distributed.init_process_group)")
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"Mesh: shape {shape} does not name its axes "
                             f"{axis_names}")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"Mesh: shape {shape} holds {math.prod(shape)} "
                             f"ranks, the job has {world}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.rank = dist.get_rank()
        self.coords: Dict[str, int] = self.coords_of(self.rank)
        self._groups: Dict[Tuple[str, ...], object] = {}
        for a in axis_names:
            self.group((a,))
        self.group(self.machine_axes)

    @property
    def machine_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a != MODEL_AXIS)

    @property
    def tp(self) -> int:
        """The model axis's size (1 when the mesh has none)."""
        return self.shape.get(MODEL_AXIS, 1)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of ``rank`` (row-major, as ``coords``)."""
        dims = tuple(self.shape[a] for a in self.axis_names)
        return {a: int(c) for a, c in zip(self.axis_names,
                                          np.unravel_index(rank, dims))}

    def index(self, axes) -> int:
        """This rank's row-major index along ``axes``."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group over ``axes`` that holds this rank.  The first
        call for a set of axes is a collective call on every rank."""
        axes = _axes(axes)
        if axes not in self._groups:
            self._groups[axes] = self._new_groups(axes)
        return self._groups[axes]

    def _new_groups(self, axes):
        # one group for every combination of the other axes' coordinates,
        # created in the same order on every rank
        others = [a for a in self.axis_names if a not in axes]
        dims = tuple(self.shape[a] for a in self.axis_names)
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            at = dict(zip(others, fixed))
            ranks = []
            for moving in itertools.product(*(range(self.shape[a])
                                              for a in axes)):
                at.update(zip(axes, moving))
                ranks.append(int(np.ravel_multi_index(
                    tuple(at[a] for a in self.axis_names), dims)))
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords})")


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_mesh_for(devices: int, model_parallel: int = 16,
                  pods: int = 1) -> Mesh:
    """``devices`` ranks over (pod, data, model) with a fixed model size:
    (data, model) with one pod, (pod, data, model) with more."""
    if devices % (model_parallel * pods):
        raise ValueError(f"make_mesh_for: {devices} ranks do not split into "
                         f"{pods} pods of model axis {model_parallel}")
    data = devices // (model_parallel * pods)
    if pods > 1:
        return Mesh((pods, data, model_parallel), ("pod", "data", "model"))
    return Mesh((data, model_parallel), ("data", "model"))


def make_smoke_mesh() -> Mesh:
    """A 1 x 1 mesh with the production axis names, for a job of one
    rank."""
    return Mesh((1, 1), ("data", "model"))
