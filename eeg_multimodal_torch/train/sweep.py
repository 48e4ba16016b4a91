"""The batched ε×seed sweep: M members trained as one model with a member axis.

Port of the JAX package's ``train/sweep.py``. The reference runs its grids
one run after another (compare_privacy_budget.py:50-56, past_acc.py:255-258).
The JAX package stacks the members' params, Adam states, epsilons and keys on
a leading axis and ``vmap``s its jitted epoch over them. ``torch.func.vmap``
cannot see into the port's kernels, which are launched through ctypes, and a
loop over the members would multiply a step's launches by M (the single
model's step is already bound by the host's launch rate). So the members
ride a leading axis of the weights instead (``models/layers.py``): the batch
goes through the model repeated M times, member after member, each group of
rows through its own member's weights, DP row, epsilon and draws, in one set
of kernel launches a step, whatever M (``MemberSteps``).

- The loss of a step is the sum over members of each member's weighted mean,
  so each member's gradient is its own; Adam's moments are elementwise, so
  stacking them is free, and every member's bf16 moment rounds with the bits
  of a single run at ``train_cfg.seed``, as under the JAX ``vmap``
  (``ops/optim.py``).
- Seeds go as there: the epoch shuffle from ``members[0].seed`` (shared by
  every member), each member's train and eval draws and its init from its
  own seed, each as a ``Trainer`` with that seed draws them. A member equals
  its own ``Trainer.fit`` up to the order of float sums.
- An epoch runs with no host sync; its (M, 5) row is fetched once.
- Every step ``StepFunctions`` takes, as the JAX sweep ``vmap``s any
  ``TrainConfig``: the faithful alternating step (f32, or bf16 with the
  in-step cast or ``precast_params`` and bf16 moments) of every class and
  ``dp_mode``, TICA_DPSGD's class with the single-optimizer step (no ``DP``
  leaf), and the three fast modes: phase 2 replays each member generator's
  draws, the reuse step restores each member's post-encoder state before
  its head, and the paired step stacks each member's batch twice, its
  halves drawing from the member's generator and its phase-2 child.

Under a (data, model) mesh (``mesh=``, ``parallel/mesh.py``) the members lie
along the data axis, as the JAX sweep shards its member axis: each chunk
(a multiple of the data ranks, the grid padded with copies of its last
member labelled ``__pad__``, whose results and records are dropped) gives
data rank d its d-th share of members, which it trains as above; the model
ranks of a data rank train the same members (the members are replicated
there). Each epoch's (M, 5) rows are gathered over the data group (zero-padded
shares summed), so ``run`` returns the same list on every rank, and a member's
records are written by the data rank that trains it, at model rank 0.

Memory: a BERT-base member holds 0.44 GB of f32 params, as much again per
f32 Adam moment and for its gradient; grids larger than
``max_members_in_flight`` run in chunks, one after another, with a log line.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..data.datasets import MultiModalArrays, epoch_indices
from ..models import fusion
from ..parallel import sharding
from ..parallel.mesh import Mesh
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..utils.seeding import DEFAULT_SEED, child_generator, derive_seed
from .records import RunRecorder
from .trainer import StepFunctions, TrainConfig, epoch_generator

@dataclasses.dataclass
class SweepMember:
    epsilon: float
    seed: int = DEFAULT_SEED
    label: Optional[str] = None

    @property
    def name(self) -> str:
        return self.label or f"eps{self.epsilon}_seed{self.seed}"


class MemberSteps(StepFunctions):
    """``StepFunctions`` over M members stacked on a leading axis: the tree's
    leaves (M, ...), epsilon an (M,) float64 tensor, the generator a group of
    M, one per member. Every per-model number gets a leading M."""

    def __init__(self, fusion_cfg: fusion.FusionConfig, train_cfg: TrainConfig, members: int,
                 device=None):
        super().__init__(fusion_cfg, train_cfg, device, members=members)
        self.members = members
        self.lead = (members,)

    def forward(self, params, batch, epsilon, hard, gen, train, dp_noise=None):
        return super().forward(params, fusion.repeat_batch(batch, self.members), epsilon, hard,
                               gen, train, dp_noise)

    def encode(self, params, batch, gen, train, layout=None):
        return super().encode(params, fusion.repeat_batch(batch, self.members), gen, train,
                              layout)

    def objective(self, loss):
        """The sum of the members' losses: each member's gradient is its own."""
        return loss.sum()

    def phase_generators(self, gen):
        """Both phases from the members' generators, one after the other; in
        the paired mode phase 2 from a child of each member's state, as a
        ``Trainer`` at its seed draws it."""
        if self.paired:
            return gen, tuple(child_generator(g, "phase 2") for g in gen)
        return gen, gen

    def pair_generators(self, g1, g2):
        """Member after member, each member's 2B rows (its batch stacked
        twice) drawing from its phase 1 generator, then its phase 2 one."""
        return tuple(g for pair in zip(g1, g2) for g in pair)


class SweepRunner:
    """Train every member of a grid on one device, as one model with a member
    axis, or over the data axis of ``mesh`` (module docstring). Runs on the
    card unless ``device="cpu"``."""

    def __init__(
        self,
        fusion_cfg: fusion.FusionConfig,
        train_cfg: TrainConfig,
        members: Sequence[SweepMember],
        bert_params=None,
        max_members_in_flight: int = 10,
        mesh: Optional[Mesh] = None,
        device=None,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {type(mesh).__name__}")
        if fusion_cfg.dp_mode == "pri_gumbel":
            # fusion.apply refuses the PriGumbel head, as the JAX package's does
            raise ValueError("SweepRunner trains the classes of fusion.apply, not "
                             "dp_mode='pri_gumbel'")
        self.fusion_cfg = fusion_cfg
        self.train_cfg = train_cfg
        self.members = list(members)
        self.bert_params = bert_params
        self.chunk = max_members_in_flight
        self.mesh = mesh
        self.data = 1 if mesh is None else mesh.data
        if self.data > 1:  # chunks tile the data axis
            self.chunk = max(self.data, self.chunk - self.chunk % self.data)
        self.device = resolve_device(device)

    def init_members(self, members: Sequence[SweepMember]):
        """The stacked params, each member drawn from its seed as a
        ``Trainer`` with that seed draws its own, and their Adam states."""
        steps = MemberSteps(self.fusion_cfg, self.train_cfg, len(members), self.device)
        params = fusion.init_members(self.fusion_cfg,
                                     [derive_seed(m.seed, "init") for m in members],
                                     self.device, self.bert_params)
        dp_os, model_os = steps.init_opt_states(params)
        return steps, params, dp_os, model_os

    def run(
        self,
        train_data: MultiModalArrays,
        test_data: MultiModalArrays,
        log_root: Optional[str] = None,
        echo: bool = True,
    ) -> List[Dict[str, Any]]:
        """Train every member for ``train_cfg.epochs``; per member
        ``{"member", "history", "best", "f1_best"}``, records under
        ``<log_root>/<member.name>/``."""
        members = list(self.members)
        if len(members) % self.data:
            # pad the grid so that every chunk tiles the data axis; the
            # "__pad__" label keeps the copies out of the records and results
            pad = self.data - len(members) % self.data
            members += [dataclasses.replace(members[-1], label="__pad__")] * pad
        n_chunks = -(-len(members) // self.chunk)
        if echo and n_chunks > 1:
            print(
                f"[sweep] {len(self.members)} members exceed "
                f"max_members_in_flight={self.chunk}: running {n_chunks} "
                f"sequential chunks"
            )
        out: List[Dict[str, Any]] = []
        for i in range(0, len(members), self.chunk):
            out.extend(self._run_chunk(members[i: i + self.chunk], train_data, test_data,
                                       log_root, echo))
        return out

    def epoch_inputs(self, members: Sequence[SweepMember], epoch: int, n_train: int,
                     n_test: int, lead: Optional[int] = None):
        """Epoch ``epoch``'s inputs on the device: the train index matrix and
        weights from the seed ``lead`` (default ``members[0]``'s: the chunk's
        first member's), the members' train generators, the eval index
        matrix and weights, the members' eval generators; each drawn as
        ``Trainer.epoch_inputs`` draws it at the seed that owns it."""
        cfg, dev = self.train_cfg, self.device
        lead = members[0].seed if lead is None else lead
        with span("eeg.epoch.inputs"):
            idx, w = epoch_indices(n_train, cfg.batch_size, True,
                                   epoch_generator(lead, epoch, "shuffle"), dev)
            eidx, ew = epoch_indices(n_test, cfg.batch_size, cfg.shuffle_eval,
                                     epoch_generator(lead, epoch, "eval_shuffle")
                                     if cfg.shuffle_eval else None, dev)
            return (idx, w, tuple(epoch_generator(m.seed, epoch, "train", dev) for m in members),
                    eidx, ew,
                    tuple(epoch_generator(m.seed, epoch, "eval", dev) for m in members))

    def _run_chunk(self, members, train_data, test_data, log_root, echo):
        cfg = self.train_cfg
        S = len(members)
        # this data rank's share of the chunk's members (all of them without a mesh)
        share = S // self.data
        first = 0 if self.mesh is None else self.mesh.data_rank * share
        mine = members[first:first + share]
        steps, params, dp_os, model_os = self.init_members(mine)
        # float64: each member's epsilon keeps its float's value
        epsilons = torch.tensor([m.epsilon for m in mine], dtype=torch.float64,
                                device=self.device)
        train_dev = train_data.to_device(self.device)
        test_dev = test_data.to_device(self.device)
        n_train, n_test = len(train_data), len(test_data)
        writes = self.mesh is None or self.mesh.model_rank == 0
        recorders = [RunRecorder(f"{log_root}/{m.name}/", echo=False)
                     if log_root and writes and m.label != "__pad__" and
                     first <= s < first + share else None
                     for s, m in enumerate(members)]
        f1_best = [cfg.f1_best_init] * S
        best: List[Optional[Dict]] = [None] * S
        histories: List[List[Dict]] = [[] for _ in members]

        for epoch in range(cfg.epochs):
            t0 = time.time()
            idx, w, tgens, eidx, ew, egens = self.epoch_inputs(mine, epoch, n_train, n_test,
                                                               lead=members[0].seed)
            dp_os, model_os, rows = steps.epoch(params, dp_os, model_os, train_dev, test_dev,
                                                idx, w, tgens, eidx, ew, egens, epsilons)
            if self.data > 1:  # every member's rows, on every rank
                whole = rows.new_zeros((S, rows.shape[-1]))
                whole[first:first + share] = rows
                rows = sharding.all_reduce_data([whole], self.mesh)[0]
            rows = rows.tolist()  # the epoch's one host sync
            dt = time.time() - t0
            for s, m in enumerate(members):
                tr_loss, tr_acc, te_loss, te_acc, f1 = rows[s]
                row = dict(epoch=epoch + 1, train_loss=tr_loss, train_acc=tr_acc,
                           test_loss=te_loss, test_acc=te_acc, f1=f1, time_cost=dt,
                           epsilon=m.epsilon, seed=m.seed)
                histories[s].append(row)
                rec = None
                if recorders[s]:
                    rec = recorders[s].epoch(epoch, tr_loss, tr_acc, te_loss, te_acc, f1, dt,
                                             extra={"epsilon": m.epsilon, "seed": m.seed})
                if f1 > f1_best[s]:
                    f1_best[s] = f1
                    best[s] = row
                    if rec:
                        recorders[s].best_record(rec)
            if echo:
                accs = " ".join(f"{r[3]:.3f}" for r in rows)
                print(f"[sweep] epoch {epoch + 1}/{cfg.epochs} ({dt:.1f}s, {S} members) "
                      f"test_acc: {accs}")
        return [{"member": dataclasses.asdict(m), "history": histories[s], "best": best[s],
                 "f1_best": f1_best[s]} for s, m in enumerate(members) if m.label != "__pad__"]


def privacy_utility_frontier(
    epsilons: Sequence[float] = (0.1, 1.0, 3.0, 5.0, 10.0),
    seeds: Sequence[int] = (DEFAULT_SEED,),
) -> List[SweepMember]:
    """The BASELINE.json frontier grid: eps x seeds."""
    return [SweepMember(float(e), int(s)) for e in epsilons for s in seeds]
