"""Mesh-aware training: shard an existing trainer's state over the mesh.

Port of the JAX package's ``parallel/train.py``. There, ``shard_trainer``
lays the params out with the Megatron rules, re-inits the optimizer states so
that they inherit the layout, and ``Trainer.fit`` then runs the same jitted
epoch under GSPMD. Here every rank of the mesh holds its shards of the params
(``parallel/sharding.py``) and runs ``Trainer.fit`` unchanged: each forward
takes the rank's rows of the batch and joins the model shards with
``all_reduce``, the logits of every row are gathered so that the loss and the
metrics are the global batch's, each phase's gradients are summed over the
data group, and Adam updates each rank's shards (its moments inherit the
layout, as ``zeros_like`` does in JAX). Every rank returns the same history;
rank (0, 0) writes the records and the best checkpoint, from the gathered
tree, as the JAX package writes its global arrays once.

The layout does not change the math: every draw of a step is drawn at its
global shape on every rank and sliced (``parallel/sharding.Layout``), and the
kernels draw their blocks of the global call, so a meshed run equals the
meshless one up to the order of float sums.

Launch one process per rank (``torchrun --nproc-per-node N``, or a spawn that
calls ``torch.distributed.init_process_group``), then on every rank::

    mesh = make_mesh(data=2, model=2)
    trainer = Trainer(fusion_cfg, train_cfg, device=f"cuda:{local_rank}")
    shard_trainer(trainer, mesh)
    trainer.fit(train, test, epsilon)
"""
from __future__ import annotations

from typing import Optional

from ..models import fusion
from ..train.trainer import Trainer
from ..utils.trees import tree_items
from . import mesh as mesh_mod
from . import sharding as shard_mod
from .mesh import Mesh


def _adam_shards(mesh: Mesh, params, select):
    """``Adam.shards`` for the leaves of ``params`` that ``select`` picks."""
    out = []
    for path, leaf in tree_items(params):
        if select(path):
            out.append((shard_mod.global_numel(path, leaf, mesh),
                        lambda flat, path=path, leaf=leaf:
                        shard_mod.shard_of_whole(mesh, path, flat, leaf)))
    return out


def shard_trainer(trainer: Trainer, mesh: Optional[Mesh] = None) -> Mesh:
    """Shard the trainer's params in place over ``mesh`` (default: every rank
    of the world, :func:`mesh.factorize`d), re-init its optimizer states from
    the shards and set ``trainer.mesh``; returns the mesh. Every rank calls
    it with the same whole params (the same seed, or the same weights).
    Every step mode runs under any mesh."""
    if mesh is None:
        mesh = mesh_mod.make_mesh()
    trainer.params = shard_mod.shard_params(mesh, trainer.params)
    steps = trainer.steps
    steps.mesh = mesh
    trainer.dp_os, trainer.model_os = steps.init_opt_states(trainer.params)
    steps.model_opt.shards = _adam_shards(mesh, trainer.params,
                                          lambda path: not fusion.dp_param_predicate(path))
    trainer.mesh = mesh
    return mesh


def shard_dpsgd_trainer(trainer, mesh: Optional[Mesh] = None) -> Mesh:
    """Shard a ``DPSGDTrainer``'s params over the mesh in place; returns the
    mesh. The Poisson window's rows then split over 'data', each rank's
    per-example gradients are its rows' of its shards, the clip norms sum
    the squared shard norms over the model group (whole leaves counted
    once), the one Gaussian draw is drawn whole and sliced, and the clipped
    sum is summed over the data group (``dp/dpsgd.py``). The optimizer state
    is made inside ``fit`` from the sharded trainable leaves."""
    if mesh is None:
        mesh = mesh_mod.make_mesh()
    trainer.params = shard_mod.shard_params(mesh, trainer.params)
    trainer.mesh = mesh
    trainer.eval_steps.mesh = mesh
    return mesh


def shard_data(mesh: Mesh, arrays):
    """This rank's rows of a ``MultiModalArrays`` (or a dict of arrays),
    the leading dimension split over 'data', as device-ready arrays."""
    if hasattr(arrays, "to_device"):
        arrays = {"eeg_input": arrays.eeg_input, "eeg_mask": arrays.eeg_mask,
                  "act_input": arrays.act_input, "act_mask": arrays.act_mask,
                  "labels": arrays.labels}
    return shard_mod.shard_batch(mesh, arrays)
