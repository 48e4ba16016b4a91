"""Adam with f32 or bf16 moment storage, equal to the JAX trainer's
optimizers; AdamW with a warmup-cosine schedule, equal to the pretext
trainers' ``optax.adamw``.

Port of the JAX package's ``ops/optim.py`` (``optim.adam``, which is
``optax.adam`` at f32 storage; train/trainer.py:157-161 there):

    mu = b1 mu + (1 - b1) g          nu = b2 nu + (1 - b2) g^2
    p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

The update runs in place on the parameter tensors (PyTorch's ``_foreach``
kernels over the whole list): the port keeps one copy of the parameters and
moments where the JAX package returns new arrays. The bias corrections are
computed in double, optax's in f32: they differ by ~1e-5 relative.

A bf16 moment is stored as views of one flat bf16 buffer. Each update casts
the buffer up to f32 in one pass, runs the math above in f32, steps the
parameters with those f32 moments, and only then stores them back
(``scale_by_adam_moment_dtypes`` there): mu rounded to nearest, nu by
default with stochastic rounding. A b2 = 0.999 EMA decays by ~0.1 % a step,
under bf16's half-ulp, so a round-to-nearest nu rounds back to its old
value when the gradient falls and can only ratchet upward; stochastic
rounding stores an unbiased value instead. Its random bits are a function
of (the run's seed, the step count), as the JAX package folds them.

Stacked members (``members=M``, the batched sweep): every leaf carries a
leading member axis, and the moments are elementwise, so each member's
update is the one its own optimizer would make. The rounding bits are not
drawn across the flat buffer of all members: the JAX sweep's one optimizer
folds (seed, count) alike for every member under ``vmap``, so every member
rounds with the bits of a single run at that seed, and so it does here (one
member's draw, laid out over each leaf's M slices).

``AdamW`` is ``optax.adamw(schedule, weight_decay, mask)``: ``scale_by_adam``,
then ``add_decayed_weights`` on the masked leaves, then the scheduled rate,

    p -= lr_t * (mu_hat / (sqrt(nu_hat) + eps) + wd * p),

lr_t the schedule at the step count before the update, so the first update of
a schedule that starts at 0 moves nothing. At ``weight_decay=0`` it is
``optax.adam(schedule)`` (the distiller's). Its moments are f32 and its bias
corrections f32, as optax computes them.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.seeding import derive_seed, generator

# the base seed of the second moment's rounding stream (ops/optim.py:81 there)
_SR_SEED = 0x0DD5EED


def stochastic_round_bits(x, rnd):
    """``x`` (f32) to bf16 by adding ``rnd`` (int32 in [0, 2^16)) to its bit
    pattern and keeping the high 16 bits. Torch has no uint32 arithmetic:
    the int32 sum wraps as the unsigned one does, and for a finite x the
    arithmetic shift leaves a value in int16's range whose bits are the
    unsigned shift's low 16 bits."""
    if x.dtype != torch.float32 or rnd.dtype != torch.int32:
        raise ValueError(f"need float32 values and int32 bits, got {x.dtype} and {rnd.dtype}")
    return (x.view(torch.int32) + rnd).bitwise_right_shift_(16).to(torch.int16).view(
        torch.bfloat16)


def stochastic_round_to_bf16(x, gen: torch.Generator):
    """Unbiased f32 -> bf16 rounding (``stochastic_round_to_bf16`` there):
    a uniform 16-bit draw from ``gen`` is added below the kept bits, so x
    rounds to each bf16 neighbour with probability proportional to its
    nearness, E[round(x)] = x. A value that bf16 holds exactly comes back
    unchanged."""
    rnd = torch.randint(0, 1 << 16, x.shape, generator=gen, dtype=torch.int32, device=x.device)
    return stochastic_round_bits(x, rnd)


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    # the flat buffer of a moment stored below f32 ("mu", "nu"); the list's
    # tensors are views of it
    packed: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def to_tree(self):
        """The state as a tree for ``train/checkpoint.py::save_pytree``: the
        count, an f32 moment's tensors, a packed moment's flat buffer alone
        (its list holds views of that buffer)."""
        return {"count": self.count, "packed": dict(self.packed),
                **{name: getattr(self, name) for name in ("mu", "nu") if name not in self.packed}}

    @staticmethod
    def from_tree(tree, params: List[torch.Tensor]) -> "AdamState":
        """The inverse of :meth:`to_tree` for the leaves ``params``: a packed
        moment's list rebuilt as views of its loaded buffer, so that updates
        of the buffer reach the list as they do in a live state."""
        packed = dict(tree["packed"])
        moments = {name: _views(packed[name], params) if name in packed else list(tree[name])
                   for name in ("mu", "nu")}
        return AdamState(int(tree["count"]), moments["mu"], moments["nu"], packed)


def _views(flat, like):
    """Views of the flat ``flat`` shaped as the tensors of ``like``."""
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in like]), like)]


class Adam:
    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype: torch.dtype = torch.float32,
                 nu_dtype: torch.dtype = torch.float32, nu_stochastic_rounding: bool = True,
                 sr_seed: Optional[int] = None, members: int = 1):
        """``mu_dtype`` / ``nu_dtype``: the moments' storage dtypes. A bf16
        nu is stored with stochastic rounding unless
        ``nu_stochastic_rounding=False`` (which warns); ``sr_seed``, the
        run's seed, decorrelates the rounding across runs. ``members``: the
        leading member axis of every leaf (module docstring)."""
        self.members = members
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.dtypes = {"mu": mu_dtype, "nu": nu_dtype}
        self.nu_sr = nu_stochastic_rounding and nu_dtype == torch.bfloat16
        self.sr_seed = sr_seed
        if nu_dtype == torch.bfloat16 and not self.nu_sr:
            warnings.warn(
                "bf16 nu storage with round-to-nearest cannot track the b2 EMA "
                "decay (sub-ulp per-step change always rounds back): nu will "
                "only ratchet upward (AMSGrad-like). Enable "
                "nu_stochastic_rounding for an unbiased stored EMA.",
                stacklevel=2,
            )

    # Under a mesh (parallel/train.py): per leaf, the whole leaf's element
    # count and the function that takes this rank's shard of the whole
    # leaf's flat draw, so that a shard rounds with its slice of the bits
    # the meshless run draws for the whole leaf.
    shards = None

    def init(self, params: List[torch.Tensor]) -> AdamState:
        moments, packed = {}, {}
        for name, dtype in self.dtypes.items():
            if dtype == torch.float32:
                moments[name] = [torch.zeros_like(p) for p in params]
            else:
                flat = torch.zeros(sum(p.numel() for p in params), dtype=dtype,
                                   device=params[0].device if params else None)
                packed[name] = flat
                moments[name] = _views(flat, params)
        return AdamState(0, moments["mu"], moments["nu"], packed)

    def _sr_generator(self, count: int, device) -> torch.Generator:
        """The rounding stream of step ``count``: _SR_SEED folded with the
        run's seed (its low 31 bits) and the count."""
        names = (() if self.sr_seed is None else (self.sr_seed & 0x7FFFFFFF,)) + (count,)
        return generator(derive_seed(_SR_SEED, *names), device)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState) -> AdamState:
        """One Adam step on ``params`` in place; returns the new state."""
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        # f32 moments update in place; a packed one through an f32 copy
        flat32 = {name: flat.float() for name, flat in state.packed.items()}
        mu = _views(flat32["mu"], params) if "mu" in flat32 else state.mu
        nu = _views(flat32["nu"], params) if "nu" in flat32 else state.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(params, mu, denom, value=-self.lr / (1.0 - b1 ** count))
        # the step above used the f32 moments; now store them
        for name, flat in flat32.items():
            if name == "nu" and self.nu_sr:
                flat = self._stochastic_round(flat, params, count)
            state.packed[name].copy_(flat)  # round to nearest, or the rounded nu
        return AdamState(count, state.mu, state.nu, state.packed)

    def _stochastic_round(self, flat, params, count: int):
        """The flat f32 nu stochastically rounded to bf16 with step
        ``count``'s bits: one draw over the flat buffer, or over one member's
        share of it, each leaf's chunk of that draw serving the leaf's M
        member slices alike."""
        gen = self._sr_generator(count, flat.device)
        if self.shards is not None:
            sizes = [n for n, _ in self.shards]
            rnd = torch.randint(0, 1 << 16, (sum(sizes),), generator=gen, dtype=torch.int32,
                                device=flat.device)
            rnd = torch.cat([take(c).reshape(-1) for (_, take), c in
                             zip(self.shards, rnd.split(sizes))])
            return stochastic_round_bits(flat, rnd)
        if self.members == 1:
            return stochastic_round_to_bf16(flat, gen)
        M = self.members
        sizes = [p.numel() // M for p in params]
        rnd = torch.randint(0, 1 << 16, (sum(sizes),), generator=gen, dtype=torch.int32,
                            device=flat.device)
        # leaf after leaf, its chunk once per member: the stacked buffer's order
        rnd = torch.cat([c for c in rnd.split(sizes) for _ in range(M)])
        return stochastic_round_bits(flat, rnd)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: from ``init_value`` linearly
    to ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value``
    at ``decay_steps`` (the warmup included), constant after it. A function
    of the step count (from 0) to a Python float: no device work."""
    decay = decay_steps - warmup_steps
    if decay <= 0:
        raise ValueError(f"decay_steps={decay_steps} must exceed warmup_steps={warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        t = min(count - warmup_steps, decay)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in f32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class AdamW:
    """``optax.adamw(schedule, weight_decay=weight_decay, mask=decay_mask)``
    over a list of leaves, updated in place (module docstring).
    ``decay_mask(leaf)`` says which leaves decay (optax's mask function over
    the tree's leaves; by default all)."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float = 0.0,
                 decay_mask: Optional[Callable[[torch.Tensor], bool]] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.decay_mask = decay_mask
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState) -> AdamState:
        """One step on ``params`` in place at the rate ``schedule(count)``;
        returns the new state."""
        b1, b2 = self.b1, self.b2
        lr = self.schedule(state.count)
        count = state.count + 1
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        upd = torch._foreach_div(mu, _bias_correction(b1, count))
        denom = torch._foreach_div(nu, _bias_correction(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            mask = self.decay_mask or (lambda p: True)
            decayed = [i for i, p in enumerate(params) if mask(p)]
            if decayed:
                torch._foreach_add_([upd[i] for i in decayed], [params[i] for i in decayed],
                                    alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        return AdamState(count, mu, nu)
