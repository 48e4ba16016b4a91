"""Deterministic seeding with explicit ``torch.Generator``s.

The reference seeds every run with 980616 (base_train.py:43). Where the JAX
package threads ``jax.random`` keys and folds names into them, the port
derives integer sub-seeds from the run's seed and a name path, and seeds one
``torch.Generator`` per consumer (init, shuffle, train noise, eval noise), so
adding randomness to one never perturbs another.
"""
from __future__ import annotations

import hashlib

import torch

DEFAULT_SEED = 980616  # ref: base_train.py:43


def _stable_hash(name: str) -> int:
    # Python's hash() is salted per process; FNV-1a is stable.
    h = 2166136261
    for b in name.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def derive_seed(seed: int, *names) -> int:
    """Sub-seed of ``seed`` for a path of names (strings or ints)."""
    h = seed & 0xFFFFFFFFFFFFFFFF
    for name in names:
        h = (h * 1099511628211 ^ _stable_hash(str(name))) & 0x7FFFFFFFFFFFFFFF
    return h


def generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def grouped(draw, shape, gen):
    """``draw(shape, gen)`` from one generator (or None, torch's default);
    from a group of G
    generators, G draws of shape[0] / G rows each, one per generator,
    stacked along the first axis. Each generator then draws what it would
    draw for its rows alone, so a forward over G stacked batches (sweep
    members, the paired phase encode's two phases) draws what G forwards
    would."""
    if gen is None or isinstance(gen, torch.Generator):
        return draw(shape, gen)
    rows = shape[0] // len(gen)
    return torch.cat([draw((rows, *shape[1:]), g) for g in gen])


def get_state(gen):
    """The state of a generator, or of each generator of a group (a list)."""
    if isinstance(gen, torch.Generator):
        return gen.get_state()
    return [g.get_state() for g in gen]


def set_state(gen, state):
    """Set the state :func:`get_state` read, into one generator or a group."""
    if isinstance(gen, torch.Generator):
        gen.set_state(state)
        return
    for g, st in zip(gen, state):
        g.set_state(st)


def child_generator(gen: torch.Generator, *names) -> torch.Generator:
    """A generator on ``gen``'s device, seeded from ``gen``'s current state
    and a path of names; ``gen`` does not move. The state is read on the
    host (a CUDA generator's is its (seed, offset) pair), so this costs no
    device sync."""
    digest = hashlib.blake2b(gen.get_state().numpy().tobytes(), digest_size=8).digest()
    return generator(derive_seed(int.from_bytes(digest, "little"), *names), gen.device)
