"""DP-SGD: per-example gradients, clipping, Gaussian noise, Poisson sampling.

Port of the JAX package's ``dp/dpsgd.py`` (reference: the Opacus integration,
base_train.py:320-434):

- everything is frozen but the last BERT layer, the pooler, ``fc1``,
  ``fc2``, the classifier and the visual encoder (base_train.py:322-333);
- the training set is Poisson-subsampled at rate q = B / N: a Bernoulli(q)
  draw over all N rows, compacted into a window of fixed width with 0/1
  weights (b_max = qN + 6 sigma, truncation probability < 1e-8, and never
  wider than N);
- each row's gradient of the trainable subtree is clipped to global L2 norm
  ``max_grad_norm`` = 0.1 (base_train.py:338); the weighted sum plus
  N(0, (sigma C)^2) per coordinate is divided by the expected batch size;
- sigma is calibrated to (target epsilon, delta = 1 / len(loader)) by the
  RDP accountant (``accountant.get_noise_multiplier``), as
  ``make_private_with_epsilon`` does (base_train.py:340-348).

The per-example gradients. The JAX package takes them with
``jax.vmap(jax.grad(example_loss))``. ``torch.func.vmap`` cannot see into
the attention kernels, which are launched through ctypes on raw pointers,
so the port replicates each trainable leaf instead: a (B, ...) view of the
leaf (``expand``: no copy) is its own autograd leaf, and ``linear`` /
``layer_norm`` (``models/layers.py``) take row b of the activations through
row b of the weight. One forward and one backward of the sum of the B
per-example losses then give every row's gradient, exactly its own loss's,
since no op of TICA_DPSGD couples rows: the min-max is per row, LayerNorm
per token, attention within a row. The frozen leaves do not require grad,
so autograd stops at the last BERT layer: one attention backward a step.

Under a (data, model) mesh (``parallel/train.py::shard_dpsgd_trainer``) the
window's rows split over 'data' and the params are Megatron shards: each rank
takes its rows' per-example gradients of its shards, the clip norm of a row
sums the squared norms of the split leaves over the model group and adds the
whole leaves' once, the one Gaussian draw is drawn at the whole leaves'
shapes and sliced, and the clipped weighted sum is summed over the data
group before the noise is added, once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import torch

from ..parallel import sharding
from ..utils.trees import tree_items, tree_map_with_path
from . import accountant

MAX_GRAD_NORM = 0.1  # ref: base_train.py:338


def trainable_predicate(path: str, bert_layers: int = 12) -> bool:
    """The reference's trainable-layer set (base_train.py:322-333)."""
    last = f"bert/layers/{bert_layers - 1}/"
    return (
        path.startswith(last)
        or path.startswith("bert/pooler")
        or path.startswith("fc1/")
        or path.startswith("fc2/")
        or path.startswith("classifier/")
        or path.startswith("visual_encoder/")
    )


def window_size(n: int, q: float) -> int:
    """The Poisson window's width over ``n`` rows at rate ``q``: b_max =
    floor(nq + 6 sqrt(max(nq(1 - q), 1))) + 1 (dpsgd.py:56-58 there), and
    at most n, as JAX's slice of the n-row order gives."""
    mean = n * q
    return min(int(mean + 6 * math.sqrt(max(mean * (1 - q), 1.0))) + 1, n)


def poisson_batch_indices(gen: torch.Generator, n: int, q: float,
                          b_max: Optional[int] = None):
    """One Poisson-subsampled batch as (idx (b,) int64, weight (b,) f32) on
    ``gen``'s device, b = ``b_max`` or :func:`window_size`, at most n: every
    row is drawn with probability q, and a stable sort puts the drawn rows
    first, in order, then the others; the weight is 1 on a drawn row. All
    on the device, with no host sync."""
    b = window_size(n, q) if b_max is None else min(b_max, n)
    mask = torch.rand(n, generator=gen, device=gen.device) < q
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    idx = order[:b]
    return idx, mask[idx].to(torch.float32)


def clip_per_example(grads: List[torch.Tensor], max_norm: float, paths=None,
                     mesh=None) -> List[torch.Tensor]:
    """Clip each example's gradient to global L2 norm <= ``max_norm``:
    ``grads`` are the trainable leaves' gradients, each with a leading
    per-example axis; the norm is over all of them, in f32, and the scale
    min(1, C / (norm + 1e-12)). Under a ``mesh`` the leaves at ``paths``
    are shards: the split leaves' squares summed over the model group, the
    whole ones' counted once."""
    B = grads[0].shape[0]

    def sq(gs):
        return sum(torch.linalg.vecdot(g.reshape(B, -1).float(), g.reshape(B, -1).float())
                   for g in gs)

    if mesh is None or mesh.model == 1:
        total = sq(grads)
    else:
        split = [sharding.model_dim(p) is not None for p in paths]
        total = sharding.reduce_from_model(
            sq([g for g, s in zip(grads, split) if s]), mesh) + sq(
            [g for g, s in zip(grads, split) if not s])
    scale = torch.clamp(max_norm / (torch.sqrt(total) + 1e-12), max=1.0)
    return [g * scale.view((B,) + (1,) * (g.dim() - 1)) for g in grads]


def noisy_aggregate(clipped: List[torch.Tensor], weight, noise_multiplier: float,
                    max_norm: float, expected_batch: int,
                    gen: Optional[torch.Generator] = None, noise=None, paths=None,
                    mesh=None) -> List[torch.Tensor]:
    """sum_b weight_b clipped_b + sigma C N(0, 1) per coordinate, divided by
    the expected batch (not the rows drawn): the Opacus DPOptimizer's
    aggregation. The N(0, 1) draw is one call over every coordinate, from
    ``gen``; ``noise`` hands it in instead, one tensor per (whole) leaf
    (tests). Under a ``mesh`` (the leaves at ``paths`` shards, ``weight``
    the rank's rows) the sum is summed over the data group and the noise,
    drawn whole, sliced to the shards."""
    like = [g[0] for g in clipped]
    if mesh is None:
        sizes = [t.numel() for t in like]
    else:
        sizes = [sharding.global_numel(p, t, mesh) for p, t in zip(paths, like)]
    if noise is None:
        noise = torch.randn(sum(sizes), generator=gen, device=clipped[0].device).split(sizes)
    else:
        noise = [z.reshape(-1) for z in noise]
    if mesh is None:
        noise = [z.view_as(t) for z, t in zip(noise, like)]
    else:
        noise = [sharding.shard_of_whole(mesh, p, z, t) for p, z, t in zip(paths, noise, like)]
    sums = [torch.tensordot(weight, g, dims=1) for g in clipped]
    if mesh is not None:
        sums = sharding.all_reduce_data(sums, mesh)
    scale = noise_multiplier * max_norm
    return [(s + scale * z) / expected_batch for s, z in zip(sums, noise)]


@dataclasses.dataclass
class DPSGDConfig:
    target_epsilon: float
    epochs: int
    batch_size: int = 8
    max_grad_norm: float = MAX_GRAD_NORM
    learning_rate: float = 1e-6
    target_delta: Optional[float] = None  # default 1/len(loader), ref :337


def make_private(n_train: int, cfg: DPSGDConfig):
    """Privacy setup mirroring make_private_with_epsilon: returns
    (noise_multiplier, sample_rate, delta, steps_per_epoch)."""
    steps_per_epoch = -(-n_train // cfg.batch_size)
    delta = cfg.target_delta if cfg.target_delta is not None else 1.0 / steps_per_epoch
    q = cfg.batch_size / n_train
    sigma = accountant.get_noise_multiplier(
        target_epsilon=cfg.target_epsilon,
        target_delta=delta,
        sample_rate=q,
        steps=cfg.epochs * steps_per_epoch,
    )
    return sigma, q, delta, steps_per_epoch


def trainable_leaves(params, trainable_pred: Callable[[str], bool]) -> List[torch.Tensor]:
    """The leaves of ``params`` whose paths ``trainable_pred`` selects, in
    the order of ``tree_items``."""
    return [t for path, t in tree_items(params) if trainable_pred(path)]


def per_example_grads(losses_fn, params, trainable_pred: Callable[[str], bool],
                      batch_size: int) -> List[torch.Tensor]:
    """Each row's gradient of its own loss w.r.t. the trainable leaves, one
    (B, ...) tensor a leaf in the order of :func:`trainable_leaves`.

    ``losses_fn(tree)`` returns the B per-example losses of the forward
    over ``tree``, in which each trainable leaf is a (B, ...) expanded view
    (no copy) that requires grad and the frozen leaves are as given, not
    requiring grad; one backward of their sum gives the gradients."""
    replicas = []

    def replicate(path, t):
        if not trainable_pred(path):
            return t
        replicas.append(t.detach().expand(batch_size, *t.shape).requires_grad_())
        return replicas[-1]

    tree = tree_map_with_path(replicate, params)
    return list(torch.autograd.grad(losses_fn(tree).sum(), replicas))


def make_dpsgd_step(losses_fn, trainable_pred: Callable[[str], bool], optimizer,
                    noise_multiplier: float, max_norm: float, expected_batch: int, mesh=None):
    """Build the DP-SGD step (dpsgd.py:121-151 there).

    ``losses_fn(params, batch, gen) -> (B,)`` is the per-example loss of a
    forward over the batch; ``trainable_pred`` selects the private subtree
    (the rest stays frozen, as requires_grad=False in the reference).
    ``step(params, opt_state, batch, weight, gen, noise=None)`` updates the
    trainable leaves of ``params`` in place and returns the optimizer
    state: the forward's dropout draws from ``gen``, then the Gaussian
    noise (``noise``, one N(0, 1) tensor a trainable leaf, hands it in).
    Under a ``mesh`` ``losses_fn`` gives the rank's rows' losses (module
    docstring)."""

    def step(params, opt_state, batch, weight, gen, noise=None):
        paths = [p for p, _ in tree_items(params) if trainable_pred(p)]
        if mesh is not None:
            r0, rows = sharding.rows_of(mesh, weight.shape[0])
            weight = weight[r0:r0 + rows]
        grads = per_example_grads(lambda tree: losses_fn(tree, batch, gen), params,
                                  trainable_pred, weight.shape[0])
        clipped = clip_per_example(grads, max_norm, paths, mesh)
        agg = noisy_aggregate(clipped, weight, noise_multiplier, max_norm, expected_batch,
                              gen, noise, paths, mesh)
        return optimizer.update(trainable_leaves(params, trainable_pred), agg, opt_state)

    return step
