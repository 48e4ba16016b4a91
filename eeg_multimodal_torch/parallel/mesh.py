"""The (data, model) mesh over ``torch.distributed`` ranks.

Port of the JAX package's ``parallel/mesh.py``. There, a ``jax.sharding.Mesh``
over the slice's chips carries a ``data`` axis (batch parallelism) and a
``model`` axis (Megatron tensor parallelism over BERT's heads and FFN), and
XLA's GSPMD inserts the collectives. Here the mesh is a grid over the ranks of
an initialised process group (the caller's ``torchrun`` or spawn, any
backend): rank r sits at (r // model, r % model), row-major as the JAX
package reshapes its device list, and the mesh holds the rank's coordinates
and its two sub-groups: the ranks that share its model index (its data group,
over which gradients and batch shards combine) and those that share its data
index (its model group, over which a layer's shards combine). The model code
runs on plain local shards, with ``all_reduce`` as its one collective
(``parallel/sharding.py``): gloo offers only ``broadcast`` and ``all_reduce``
on CUDA tensors, and the kernels, launched through ctypes, cannot see into a
wrapper tensor.

With no process group, or a world of 1, the mesh is (1, 1) and every
collective is a no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def factorize(n: int, max_model: int = 4) -> Tuple[int, int]:
    """Split n ranks into (data, model) with the largest model degree that
    divides both n and BERT's 12 heads (and is <= max_model)."""
    for m in range(min(max_model, n), 0, -1):
        if n % m == 0 and 12 % m == 0:
            return n // m, m
    return n, 1


class PartitionSpec(tuple):
    """A leaf's layout, one entry per dimension: ``MODEL_AXIS`` (or
    ``DATA_AXIS``) where the dimension is split over that axis, None where
    it is whole; trailing whole dimensions may be left out, and ``P()`` is
    replicated, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a (data, model) grid of ranks and its groups."""

    data: int
    model: int
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[object] = None  # None: a group of one
    model_group: Optional[object] = None
    group: Optional[object] = None  # the whole mesh's group

    @property
    def shape(self):
        """``{"data": data, "model": model}``, as ``jax.sharding.Mesh.shape``."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def is_lead(self) -> bool:
        """Whether this is rank (0, 0), the one that writes files."""
        return self.data_rank == 0 and self.model_rank == 0


def _world(group):
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0, [0]
    return (dist.get_world_size(group), dist.get_rank(group),
            dist.get_process_group_ranks(group or dist.group.WORLD))


def make_mesh(data: Optional[int] = None, model: Optional[int] = None, group=None) -> Mesh:
    """The (data, model) mesh over the ranks of ``group`` (default: the
    world), factorized as :func:`factorize` when either count is None. Every
    rank of the group must call it, in the same order as any other
    ``new_group``: it creates the data and model sub-groups."""
    n, rank, ranks = _world(group)
    if data is None or model is None:
        data, model = factorize(n)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    if n == 1:
        return Mesh(1, 1)
    d, m = divmod(rank, model)
    data_groups = [dist.new_group([ranks[i * model + j] for i in range(data)])
                   for j in range(model)] if data > 1 else [None] * model
    model_groups = [dist.new_group([ranks[i * model + j] for j in range(model)])
                    for i in range(data)] if model > 1 else [None] * data
    return Mesh(data, model, d, m, data_groups[m], model_groups[d], group)


def replicated(mesh: Mesh) -> PartitionSpec:
    """The layout of a leaf every rank holds whole."""
    return P()


def batch_sharding(mesh: Mesh) -> PartitionSpec:
    """Shard the leading (batch) dimension over the data axis."""
    return P(DATA_AXIS)
