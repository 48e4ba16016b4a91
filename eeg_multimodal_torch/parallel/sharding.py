"""How the fusion model's params and batches lay out on the mesh, and the
collectives that join the shards.

Port of the JAX package's ``parallel/sharding.py``: the same rules on the same
path strings (Megatron tensor parallelism for the transformer blocks),

  - BERT's query / key / value / intermediate kernels and biases:
    column-parallel (the output dimension split over 'model');
  - BERT's attention-output and FFN-output kernels: row-parallel (the input
    dimension split), their biases whole;
  - the cross block: ``in_proj_kernel`` whole (its packed q|k|v output is not
    contiguous per head group across the three sections), ``out_proj``
    row-parallel, ``linear1`` column- and ``linear2`` row-parallel;
  - ``fc1`` column- and ``fc2`` row-parallel;
  - all else (embeddings, LayerNorms, the head's classifier, ``DP``) whole.

Batches split their leading dimension over 'data'. Where JAX's GSPMD inserts
the collectives, here the model code runs on each rank's local shards and
joins them with Megatron's two conjugate operators over the model group
(:func:`copy_to_model` before a column-parallel layer, :func:`reduce_from_model`
after a row-parallel one, its bias added once after the sum), and the
trainer sums gradients over the data group (:func:`all_reduce_data`). A
forward's place on the mesh, with which its draws stay those of the meshless
run, is a :class:`Layout`. Every collective is an ``all_reduce``: a gather is
the sum of zero-padded shards, exact, and gloo offers no other collective on
CUDA tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..utils.trees import tree_map_with_path
from .mesh import MODEL_AXIS, Mesh, P


# ---------------------------------------------------------------------------
# The rules (the JAX package's, path for path)
# ---------------------------------------------------------------------------

def _bert_layer_rule(path: str):
    # paths like bert/layers/3/attn/query/kernel
    if path.endswith("/kernel"):
        if any(f"/{n}/" in path for n in ("query", "key", "value", "intermediate")):
            return P(None, MODEL_AXIS)  # column-parallel
        if "/attn/output/" in path or "/ffn/output/" in path:
            return P(MODEL_AXIS, None)  # row-parallel
    if path.endswith("/bias"):
        if any(f"/{n}/" in path for n in ("query", "key", "value", "intermediate")):
            return P(MODEL_AXIS)
    return P()


def _cross_layer_rule(path: str):
    # paths like cross/layers/0/self_attn/in_proj_kernel
    if path.endswith("in_proj_kernel"):
        return P()
    if path.endswith("out_proj/kernel"):
        return P(MODEL_AXIS, None)
    if "linear1/kernel" in path:
        return P(None, MODEL_AXIS)
    if "linear1/bias" in path:
        return P(MODEL_AXIS)
    if "linear2/kernel" in path:
        return P(MODEL_AXIS, None)
    return P()


def param_pspec(path: str) -> P:
    """The layout of the leaf at ``path`` (a '/'-joined tree path)."""
    if path.startswith("bert/layers/"):
        return _bert_layer_rule(path)
    if path.startswith("cross/layers/"):
        return _cross_layer_rule(path)
    if path.startswith("fc1/kernel"):
        return P(None, MODEL_AXIS)
    if path.startswith("fc1/bias"):
        return P(MODEL_AXIS)
    if path.startswith("fc2/kernel"):
        return P(MODEL_AXIS, None)
    return P()


def model_dim(path: str) -> Optional[int]:
    """The dimension of the leaf at ``path`` split over 'model', or None."""
    spec = param_pspec(path)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


# ---------------------------------------------------------------------------
# Slicing and gathering
# ---------------------------------------------------------------------------

def shard_leaf(mesh: Mesh, path: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the whole leaf ``t`` at ``path``: its own copy
    (Adam updates it in place), or ``t`` itself where the leaf is whole."""
    dim = model_dim(path)
    if dim is None or mesh.model == 1:
        return t
    if t.shape[dim] % mesh.model:
        raise ValueError(f"{path}: dimension {dim} of {tuple(t.shape)} does not split "
                         f"over {mesh.model} model ranks")
    return t.chunk(mesh.model, dim)[mesh.model_rank].clone()


def shard_params(mesh: Mesh, params: Any):
    """The rank's shard of every leaf of the whole tree ``params``."""
    return tree_map_with_path(lambda path, t: shard_leaf(mesh, path, t), params)


def rows_of(mesh: Mesh, n: int):
    """(r0, rows) of this rank's share of ``n`` rows split over 'data'."""
    if n % mesh.data:
        raise ValueError(f"{n} rows do not split over {mesh.data} data ranks")
    rows = n // mesh.data
    return mesh.data_rank * rows, rows


def shard_batch(mesh: Mesh, batch: Any):
    """Every array's leading dimension split over 'data': this rank's rows."""
    def take(t):
        r0, rows = rows_of(mesh, t.shape[0])
        return t[r0:r0 + rows]

    return {k: take(v) for k, v in batch.items()}


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


def gather_leaf(mesh: Mesh, path: str, t: torch.Tensor) -> torch.Tensor:
    """The whole leaf from each model rank's shard ``t``: the shards placed
    in a zero tensor and summed over the model group (exact)."""
    dim = model_dim(path)
    if dim is None or mesh.model == 1:
        return t.detach().clone()
    shape = list(t.shape)
    shape[dim] *= mesh.model
    whole = torch.zeros(shape, dtype=t.dtype, device=t.device)
    whole.narrow(dim, mesh.model_rank * t.shape[dim], t.shape[dim]).copy_(t.detach())
    return _all_reduce(whole, mesh.model_group)


def gather_params(mesh: Mesh, params: Any):
    """The whole tree from this rank's shards, on every rank (a collective:
    every rank calls it)."""
    return tree_map_with_path(lambda path, t: gather_leaf(mesh, path, t), params)


# ---------------------------------------------------------------------------
# Megatron's conjugate operators over the model group
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward, all_reduce backward: a whole activation entering a
    column-parallel layer, whose gradient each model rank holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """all_reduce forward, identity backward: the partial sums of a
    row-parallel layer, whose whole output every model rank then holds."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, mesh: Mesh):
    return x if mesh.model == 1 else _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x, mesh: Mesh):
    return x if mesh.model == 1 else _ReduceFromModel.apply(x, mesh.model_group)


class _GatherRows(torch.autograd.Function):
    """The whole batch's rows from each data rank's: forward the zero-padded
    shards summed over the data group, backward this rank's rows of the
    gradient (every data rank computes the same gradient of the whole)."""

    @staticmethod
    def forward(ctx, x, r0, n, group):
        ctx.r0, ctx.rows = r0, x.shape[0]
        whole = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        whole[r0:r0 + x.shape[0]] = x
        return _all_reduce(whole, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.r0:ctx.r0 + ctx.rows], None, None, None


def all_reduce_data(tensors, mesh: Mesh):
    """Sum each tensor of the list over the data group, in place, through one
    flat buffer per dtype; returns the list."""
    if mesh.data == 1 or not tensors:
        return tensors
    for dtype in {t.dtype for t in tensors}:
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        _all_reduce(flat, mesh.data_group)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))
    return tensors


# ---------------------------------------------------------------------------
# A forward's place on the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """One forward on this rank: its rows are rows ``b0`` .. of the
    forward's ``rows`` global rows (split over 'data'), its column- and
    row-parallel layers hold the rank's model shards. With ``groups`` G > 1
    the forward runs G stacked batches of ``rows`` global rows each (the
    paired step's batch stacked twice, each copy drawing from its own
    generator of a group): the rank holds rows ``b0`` .. of each, batch
    after batch.

    Every draw of the forward is drawn at its global shape from the same
    generator on every rank (one per stacked batch), and the rank keeps its
    block (:meth:`draw`), so the draws are those of the meshless forward
    whatever the layout; the kernels draw their blocks of the global call
    themselves (the attention kernels' ``Block``, the DP kernels' ``r0``)."""

    mesh: Mesh
    b0: int
    rows: int
    groups: int = 1

    @staticmethod
    def of(mesh: Mesh, n: int, groups: int = 1) -> "Layout":
        """The layout of a forward over ``groups`` stacked batches of ``n``
        global rows each on this rank."""
        return Layout(mesh, rows_of(mesh, n)[0], n, groups)

    @property
    def model(self) -> int:
        return self.mesh.model

    @property
    def local(self) -> int:
        """The rank's rows of each stacked batch."""
        return self.rows // self.mesh.data

    def take(self, x):
        """The rank's rows of the global rows ``x`` (of each stacked batch)."""
        if self.groups == 1:
            return x[self.b0:self.b0 + self.local]
        return torch.cat([part[self.b0:self.b0 + self.local] for part in x.chunk(self.groups)])

    def local_rows(self, batch):
        """The rank's rows of every array of a global batch."""
        return {k: self.take(v) for k, v in batch.items()}

    def gather_rows(self, x):
        """The global rows of ``x`` from every data rank's (differentiable)."""
        if self.groups != 1:
            raise ValueError("rows of stacked batches are gathered batch by batch")
        if self.mesh.data == 1:
            return x
        return _GatherRows.apply(x, self.b0, self.rows, self.mesh.data_group)

    def draw(self, fn: Callable, shape, gen, model_axis: Optional[int] = None):
        """``fn(global_shape, gen)`` sliced to this rank's block of ``shape``:
        its rows of the leading (batch) axis and, where ``model_axis`` is
        given, its model shard of that axis. With G stacked batches ``gen``
        is a group of G generators, each drawing its batch's global rows."""
        if self.groups == 1:
            if gen is not None and not isinstance(gen, torch.Generator):
                raise ValueError("a draw under a mesh takes one generator, not a group")
            return self._draw_one(fn, shape, gen, model_axis)
        if isinstance(gen, torch.Generator) or len(gen) != self.groups:
            raise ValueError(f"a draw over {self.groups} stacked batches takes a group of "
                             f"{self.groups} generators")
        part = (shape[0] // self.groups, *shape[1:])
        return torch.cat([self._draw_one(fn, part, g, model_axis) for g in gen])

    def _draw_one(self, fn, shape, gen, model_axis):
        whole = list(shape)
        whole[0] = self.rows
        if model_axis is not None:
            whole[model_axis] *= self.model
        x = fn(tuple(whole), gen)[self.b0:self.b0 + shape[0]]
        if model_axis is not None and self.model > 1:
            x = x.narrow(model_axis, self.mesh.model_rank * shape[model_axis], shape[model_axis])
        return x

    def to_model(self, x):
        return copy_to_model(x, self.mesh)

    def from_model(self, x):
        return reduce_from_model(x, self.mesh)

    def columns(self, x):
        """The rank's model shard of the last axis of the whole ``x``,
        entering a row-parallel layer: its gradient joins over the model
        group."""
        if self.model == 1:
            return x
        w = x.shape[-1] // self.model
        return self.to_model(x)[..., self.mesh.model_rank * w:(self.mesh.model_rank + 1) * w]


def global_numel(path: str, t: torch.Tensor, mesh: Mesh) -> int:
    """The element count of the whole leaf whose shard ``t`` is."""
    dim = model_dim(path)
    return t.numel() * (mesh.model if dim is not None else 1)


def shard_of_whole(mesh: Mesh, path: str, flat: torch.Tensor, like: torch.Tensor):
    """This rank's shard of a whole leaf given flat (its global elements in
    order), shaped as the shard ``like``."""
    dim = model_dim(path)
    if dim is None or mesh.model == 1:
        return flat.view_as(like)
    shape = list(like.shape)
    shape[dim] *= mesh.model
    return flat.view(shape).narrow(dim, mesh.model_rank * like.shape[dim], like.shape[dim])
