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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import torch

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


def clip_per_example(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """Clip each example's gradient to global L2 norm <= ``max_norm``:
    ``grads`` are the trainable leaves' gradients, each with a leading
    per-example axis; the norm is over all of them, in f32, and the scale
    min(1, C / (norm + 1e-12))."""
    B = grads[0].shape[0]
    sq = sum(torch.linalg.vecdot(g.reshape(B, -1).float(), g.reshape(B, -1).float())
             for g in grads)
    scale = torch.clamp(max_norm / (torch.sqrt(sq) + 1e-12), max=1.0)
    return [g * scale.view((B,) + (1,) * (g.dim() - 1)) for g in grads]


def noisy_aggregate(clipped: List[torch.Tensor], weight, noise_multiplier: float,
                    max_norm: float, expected_batch: int,
                    gen: Optional[torch.Generator] = None, noise=None) -> List[torch.Tensor]:
    """sum_b weight_b clipped_b + sigma C N(0, 1) per coordinate, divided by
    the expected batch (not the rows drawn): the Opacus DPOptimizer's
    aggregation. The N(0, 1) draw is one call over every coordinate, from
    ``gen``; ``noise`` hands it in instead, one tensor per leaf (tests)."""
    if noise is None:
        flat = torch.randn(sum(g[0].numel() for g in clipped), generator=gen,
                           device=clipped[0].device)
        noise = [n.view_as(g[0]) for n, g in zip(flat.split([g[0].numel() for g in clipped]),
                                                  clipped)]
    scale = noise_multiplier * max_norm
    return [(torch.tensordot(weight, g, dims=1) + scale * z) / expected_batch
            for g, z in zip(clipped, noise)]


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
                    noise_multiplier: float, max_norm: float, expected_batch: int):
    """Build the DP-SGD step (dpsgd.py:121-151 there).

    ``losses_fn(params, batch, gen) -> (B,)`` is the per-example loss of a
    forward over the batch; ``trainable_pred`` selects the private subtree
    (the rest stays frozen, as requires_grad=False in the reference).
    ``step(params, opt_state, batch, weight, gen, noise=None)`` updates the
    trainable leaves of ``params`` in place and returns the optimizer
    state: the forward's dropout draws from ``gen``, then the Gaussian
    noise (``noise``, one N(0, 1) tensor a trainable leaf, hands it in)."""

    def step(params, opt_state, batch, weight, gen, noise=None):
        grads = per_example_grads(lambda tree: losses_fn(tree, batch, gen), params,
                                  trainable_pred, weight.shape[0])
        clipped = clip_per_example(grads, max_norm)
        agg = noisy_aggregate(clipped, weight, noise_multiplier, max_norm, expected_batch,
                              gen, noise)
        return optimizer.update(trainable_leaves(params, trainable_pred), agg, opt_state)

    return step
