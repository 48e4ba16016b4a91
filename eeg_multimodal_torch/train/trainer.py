"""The DP-MLD trainer: the alternating two-optimizer step and the
single-optimizer step.

Port of the JAX package's ``train/trainer.py`` (reference semantics:
base_train.py:167-255). Per batch, the faithful step of a class with the
learned DP block (``lapacian_dropout``):

1. forward with hard=False, the gradient w.r.t. ``DP`` only, Adam on ``DP``;
2. forward with hard=True, the gradient w.r.t. every other parameter, Adam.

The other classes (NDP, equal weight, ``feature_all_lap``) have no ``DP``
leaf and take step 2 alone over every parameter, the fast modes ignored
(base_train.py:436-553; trainer.py:321-340 there); so does TICA_DPSGD's
class given to this trainer, which ``TrainAndTest`` trains under DP-SGD
instead (``train/dpsgd_trainer.py``).

Then a stochastic eval epoch (hard=True, dropout off, DP noise on, each
batch under ``n_eval`` noise draws) and F1. PyTorch runs eagerly: an epoch is
a Python loop over the batches. Phase 1 marks only ``DP`` as requiring grad,
so the encoders record no graph and their backward never runs (the JAX
trainer gets the same from XLA's dead-code elimination). The two phases draw
their own dropout and DP noise, one after the other, from the epoch's
generator, as ``k1``/``k2`` do in the JAX step. ``Trainer.fit`` runs the
epochs with the legacy records and the best-F1 checkpoint (trainer.py:655-777
there); ``StepFunctions.cycle`` runs K of them with no host sync.

The fast modes of the JAX package (trainer.py:229-465 there) rewrite the
step:

- ``share_phase_dropout``: phase 2 replays phase 1's draws (every dropout
  mask, attention seed and DP noise), the generator's state saved before
  phase 1 and restored before phase 2;
- ``reuse_phase_features`` (by default on with sharing): the encoder runs
  once; phase 1 takes ``dDP`` through the head on the features held
  constant, phase 2 the head again (its DP noise replayed) and one backward
  into head and encoder. Equal to sharing without reuse;
- ``paired_phase_encode``: both phases' encoder forwards as one forward
  over the batch stacked twice, each half drawing from its own phase's
  generator (a group, ``models/layers.py``); phase 2's gradient goes back
  through the 2B forward with a zero cotangent on phase 1's half. Equal to
  the sequential step that draws phase 1 from one generator and phase 2
  from the other.

With ``compute_dtype="bfloat16"`` the forward runs on a bf16 copy of the f32
master tree, ``DP`` included, cast inside the step; the gradient goes back
through the cast to the masters, and Adam updates them in f32. With
``precast_params`` the bf16 copy of the model params is made once an epoch
and refreshed in place after every Adam update (trainer.py:216-291 there).
PyTorch keeps no excess precision at the cast, so the two give the same
numbers: the gradient reaching the cast is bf16 either way. The carried copy
does less work: on an H100 at S = 80 and batch 8 (``chip_smoke.py``'s
profile) its step launches 2816 kernels against the in-step cast's 3331 and
takes 16.8 ms of device time against 17.8. The fast modes cast the model
params once a step, inside it.
"""
from __future__ import annotations

import atexit
import dataclasses
import signal
import time
from typing import Any, Dict, Optional

import torch

from ..data.compact_vocab import CompactVocab
from ..data.datasets import MultiModalArrays, epoch_indices, gather_batch
from ..models import fusion
from ..ops.optim import Adam
from ..utils.device import resolve_device
from ..utils.seeding import DEFAULT_SEED, child_generator, derive_seed, generator
from ..utils.trees import tree_cast, tree_items, tree_map, tree_map_with_path
from . import checkpoint as ckpt
from . import metrics as M
from .records import RunRecorder


_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig`` (trainer.py:43-140 there), every
    field with its name and default."""

    batch_size: int = 8  # ref: base_train.py:49
    learning_rate: float = 1e-6  # ref: base_train.py:50
    epochs: int = 50  # ref: base_train.py:51
    seed: int = DEFAULT_SEED  # ref: base_train.py:43
    f1_best_init: float = 0.5  # ref: base_train.py:164
    # "bfloat16": the forward on a bf16 copy of the f32 master params
    compute_dtype: str = "float32"
    # shuffle the eval batches, from the epoch's own eval-order generator
    # (the reference shuffles them; no metric depends on the order)
    shuffle_eval: bool = False
    # stochastic eval repeats per batch: majority-voted predictions, mean
    # loss, accuracy and score (the legacy trainer's scheme, train.py:126-138)
    n_eval: int = 1
    # the fast modes (module docstring); reuse_phase_features None means
    # "as share_phase_dropout" (trainer.py:237-239 there)
    share_phase_dropout: bool = False
    reuse_phase_features: Optional[bool] = None
    # the Adam moments' storage dtypes; a bf16 nu is stored with stochastic
    # rounding (ops/optim.py)
    adam_mu_dtype: str = "float32"
    adam_nu_dtype: str = "float32"
    # carry the bf16 copy of the model params through the epoch, refreshed
    # after each update, instead of casting the masters inside every step;
    # nothing at compute_dtype float32
    precast_params: bool = False
    paired_phase_encode: bool = False
    # Write the best-F1 checkpoint once, at the end of fit(), from a
    # device-side copy of the best params, instead of on every improvement
    # (the same final file as the reference's per-improvement torch.save,
    # base_train.py:251). False writes on every improvement.
    defer_best_checkpoint: bool = True
    # With deferral on, flush a pending best to disk every N epochs, so a
    # run killed mid-loop keeps a recent best artifact. 0 = only at the end.
    defer_flush_epochs: int = 20
    # Evaluate all the eval batches as one batched forward (one 608-row
    # forward for the reference's 601 eval rows) instead of a loop of
    # batch-sized ones. The rows are independent, so the per-batch loss and
    # accuracy means are the loop's; the DP noise is drawn for all rows at
    # once, from the same generator (another draw of the same law). On an
    # H100, bf16 at S = 80, 601 rows take 42-43 ms batched against 976-1573
    # ms in the loop (chip_smoke.py's eval phase).
    eval_vmap_batches: bool = True

    def __post_init__(self):
        for name in ("compute_dtype", "adam_mu_dtype", "adam_nu_dtype"):
            if getattr(self, name) not in _DTYPES:
                raise ValueError(f"{name}={getattr(self, name)!r}: the port runs {_DTYPES}")
        if self.n_eval < 1:
            raise ValueError(f"n_eval={self.n_eval}: at least one eval pass")
        if self.reuse_phase_features and not self.share_phase_dropout:
            raise ValueError(  # trainer.py:240-244 there
                "reuse_phase_features requires share_phase_dropout: with "
                "fresh per-phase dropout the two phases' features differ")
        fast = [f for f in ("share_phase_dropout", "reuse_phase_features",
                            "paired_phase_encode") if getattr(self, f)]
        if self.precast_params and self.compute_dtype != "float32" and fast:
            raise ValueError(  # trainer.py:166-175 there
                "precast_params covers the faithful alternating and "
                "single-optimizer steps; the paired/shared fast modes keep "
                "the in-step cast")

    @property
    def reuses_features(self) -> bool:
        """``reuse_phase_features``, None meaning ``share_phase_dropout``."""
        if self.reuse_phase_features is None:
            return self.share_phase_dropout
        return self.reuse_phase_features


def epoch_generator(seed: int, epoch: int, name: str, device="cpu") -> torch.Generator:
    """The generator of epoch ``epoch``'s draws named ``name`` ("shuffle",
    "eval_shuffle", "train", "eval") for a run at ``seed``: each seeded
    from (seed, epoch, name), so that no draw moves another."""
    return generator(derive_seed(seed, "epoch", epoch, name), device)


def _is_model(path: str) -> bool:
    return not fusion.dp_param_predicate(path)


def _track(params, select):
    """The tree with the ``select``ed leaves swapped for aliases that require
    grad; returns (tree, aliases, the original leaves in the same order)."""
    aliases, originals = [], []

    def mark(path, t):
        if not select(path):
            return t
        originals.append(t)
        aliases.append(t.detach().requires_grad_())
        return aliases[-1]

    return tree_map_with_path(mark, params), aliases, originals


class StepFunctions:
    """Train and eval epochs for one (FusionConfig, TrainConfig) on one device.

    ``lead`` is the leading shape of every per-model number (losses,
    accuracies, predictions): () here, (M,) for the sweep's stacked
    members (``train/sweep.py::MemberSteps``)."""

    lead = ()

    def __init__(self, fusion_cfg: fusion.FusionConfig, train_cfg: TrainConfig,
                 device=None, members: int = 1):
        """``members``: the leading member axis of a stacked tree, for the
        model optimizer's rounding bits (``ops/optim.py``)."""
        self.fusion_cfg = fusion_cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, train_cfg.compute_dtype)
        self.precast = train_cfg.precast_params and self.compute_dtype != torch.float32
        # the alternating step needs the DP leaf; the other classes take the
        # single-optimizer step (trainer.py:154, :321-340 there)
        self.has_dp_param = fusion_cfg.dp_mode == "lapacian_dropout"
        # the step's mode, in the JAX package's order of precedence: the fast
        # modes act only on the alternating step
        self.reuse = train_cfg.reuses_features and self.has_dp_param
        self.paired = train_cfg.paired_phase_encode and not self.reuse and self.has_dp_param
        self.dp_opt = Adam(train_cfg.learning_rate)  # the (1, F) DP leaf: f32 moments
        self.model_opt = Adam(train_cfg.learning_rate,
                              mu_dtype=getattr(torch, train_cfg.adam_mu_dtype),
                              nu_dtype=getattr(torch, train_cfg.adam_nu_dtype),
                              sr_seed=train_cfg.seed, members=members)

    def init_opt_states(self, params):
        def leaves(select):
            return [t for path, t in tree_items(params) if select(path)]

        dp_os = self.dp_opt.init(leaves(fusion.dp_param_predicate)) if self.has_dp_param else None
        return dp_os, self.model_opt.init(leaves(_is_model))

    def compute(self, params):
        """``params`` in the compute dtype: the differentiable cast of
        trainer.py:179-182 there (the tree itself at float32)."""
        if self.compute_dtype == torch.float32:
            return params
        return tree_cast(params, self.compute_dtype)

    def precast_copy(self, params):
        """The compute-dtype copy of the model params that ``train_step``
        takes with ``precast_params`` (``DP`` stays out: each phase casts
        the live leaf)."""
        return tree_cast({k: v for k, v in params.items() if k != "DP"}, self.compute_dtype)

    def forward(self, params, batch, epsilon, hard, gen, train, dp_noise=None):
        """The logits of ``batch``'s rows (``fusion.apply``)."""
        return fusion.apply(params, batch, self.fusion_cfg, epsilon, hard, gen, train, dp_noise)

    def loss_fn(self, params, batch, weight, epsilon, gen, hard, train, dp_noise=None):
        labels = batch["labels"]
        logits = self.forward(params, batch, epsilon, hard, gen, train, dp_noise)
        logits = logits.reshape(*self.lead, *labels.shape, -1)
        loss, acc, pred, _ = M.cal_loss(logits, labels.expand(*self.lead, *labels.shape), weight)
        return loss, acc, pred, logits

    def objective(self, loss):
        """The scalar a phase differentiates: the loss itself here."""
        return loss

    def phase_generators(self, gen):
        """(phase 1's generator, phase 2's) for a step given ``gen``: a pair
        as given; else ``gen`` for both, one phase after the other, or, in
        the paired mode, ``gen`` and a child of its state (one generator for
        each half of the 2B forward)."""
        if not isinstance(gen, torch.Generator):
            return tuple(gen)
        if self.paired:
            return gen, child_generator(gen, "phase 2")
        return gen, gen

    def train_step(self, params, dp_os, model_os, batch, weight, epsilon, gen,
                   dp_noise=(None, None), dropout=True, params_c=None):
        """One step in the configured mode; updates ``params`` in place and
        returns (dp_os, model_os, loss, acc) with phase 2's loss and
        accuracy. Without a ``DP`` leaf the step is phase 2 alone, over
        every parameter, drawing from phase 2's generator (the
        single-optimizer regimes: NDP, equal weight, ``feature_all_lap``,
        and TICA_DPSGD's class outside DP-SGD; trainer.py:321-340 there).

        ``gen``: the step's generator, or a pair, phase 1's and phase 2's
        (:meth:`phase_generators`); with ``share_phase_dropout`` phase 2
        replays phase 1's draws, and the reuse step draws from phase 1's
        generator alone. ``params_c``: the :meth:`precast_copy` of ``params``
        (with ``precast_params``), which the forwards read and which is
        refreshed in place after the update (trainer.py:254-291 there);
        without it each phase casts the masters (a no-op at f32).

        Test-only keywords: ``dp_noise`` hands each phase its Laplace(0, 1)
        DP noise, and ``dropout=False`` turns dropout off, so that the step
        can be held against the JAX reference's.
        """
        g1, g2 = self.phase_generators(gen)
        if not self.has_dp_param:
            return (dp_os, *self._model_phase(params, model_os, batch, weight, epsilon, g2,
                                              dp_noise[1], dropout, params_c))
        if self.reuse:
            return self._shared_feature_step(params, dp_os, model_os, batch, weight, epsilon,
                                             g1, dp_noise, dropout)
        if self.paired:
            return self._paired_phase_step(params, dp_os, model_os, batch, weight, epsilon,
                                           g1, g2, dp_noise, dropout)
        cd = self.compute_dtype
        replay = g1.get_state() if self.train_cfg.share_phase_dropout else None

        def with_dp(dp):  # the precast copy with the given DP leaf, in params' order
            return {k: (dp if k == "DP" else params_c[k]) for k in params}

        # phase 1: DP only, hard=False (base_train.py:183-195)
        if params_c is None:
            p1, (dp_alias,), dp_leaves = _track(params, fusion.dp_param_predicate)
            p1 = self.compute(p1)
        else:
            dp_leaves = [params["DP"]]
            dp_alias = params["DP"].detach().requires_grad_()
            p1 = with_dp(dp_alias.to(cd))
        loss1 = self.loss_fn(p1, batch, weight, epsilon, g1, hard=False,
                             train=dropout, dp_noise=dp_noise[0])[0]
        g_dp = torch.autograd.grad(self.objective(loss1), [dp_alias])
        dp_os = self.dp_opt.update(dp_leaves, list(g_dp), dp_os)

        # phase 2: every other parameter, hard=True (base_train.py:197-210)
        if replay is not None:
            g2.set_state(replay)
        return (dp_os, *self._model_phase(params, model_os, batch, weight, epsilon, g2,
                                          dp_noise[1], dropout, params_c))

    def _model_phase(self, params, model_os, batch, weight, epsilon, gen, noise, dropout,
                     params_c):
        """The gradient w.r.t. every parameter but ``DP`` (hard=True) and
        Adam on them: phase 2 of the alternating step, or the whole
        single-optimizer step. With ``params_c`` the gradient is taken
        w.r.t. the compute-dtype copy and cast up, and the copy is refreshed
        from the updated masters. Returns (model_os, loss, acc)."""
        if params_c is None:
            p, aliases, model_leaves = _track(params, _is_model)
            p = self.compute(p)
        else:
            dp = {"DP": params["DP"].detach().to(self.compute_dtype)} if "DP" in params else {}
            p, aliases, copies = _track({**params_c, **dp}, _is_model)
            model_leaves = [t for path, t in tree_items(params) if _is_model(path)]
        loss, acc, _, _ = self.loss_fn(p, batch, weight, epsilon, gen, hard=True, train=dropout,
                                       dp_noise=noise)
        grads = [g.float() for g in torch.autograd.grad(self.objective(loss), aliases)]
        model_os = self.model_opt.update(model_leaves, grads, model_os)
        if params_c is not None:
            torch._foreach_copy_(copies, model_leaves)
        return model_os, loss.detach(), acc.detach()

    # -- the fast modes' two phases over features encoded once -----------------
    def _model_tree(self, params):
        """The model params (``DP`` left out) as aliases that require grad,
        cast to the compute dtype once: (tree, aliases, masters in order)."""
        tracked, aliases, masters = _track({k: v for k, v in params.items() if k != "DP"},
                                           lambda path: True)
        return self.compute(tracked), aliases, masters

    def _head_loss(self, pc, dp, feature, batch, weight, epsilon, hard, gen, noise):
        """(loss, acc) of the head over ``feature`` with the DP leaf ``dp``
        (cast to the compute dtype, as the whole tree is in the faithful
        step)."""
        params = {**pc, "DP": dp.to(self.compute_dtype)}
        logits = fusion.apply_head(params, feature, self.fusion_cfg, epsilon, hard, gen,
                                   train=True, dp_noise=noise)
        return M.cal_loss(logits, batch["labels"], weight)[:2]

    def _two_phases(self, params, dp_os, model_os, pc, aliases, masters, f1, f2, batch,
                    weight, epsilon, g1, g2, dp_noise, replay=None):
        """Phase 1 (``dDP`` on ``f1`` held constant, Adam on ``DP``), then
        phase 2 (the head on ``f2`` with the updated ``DP``, one backward
        into head and encoder, Adam); ``replay``, a state of ``g2`` to set
        before phase 2."""
        dp_alias = params["DP"].detach().requires_grad_()
        loss1 = self._head_loss(pc, dp_alias, f1.detach(), batch, weight, epsilon, False, g1,
                                dp_noise[0])[0]
        dp_os = self.dp_opt.update([params["DP"]], list(torch.autograd.grad(loss1, [dp_alias])),
                                   dp_os)
        if replay is not None:
            g2.set_state(replay)
        loss, acc = self._head_loss(pc, params["DP"].detach(), f2, batch, weight, epsilon, True,
                                    g2, dp_noise[1])
        grads = [g.float() for g in torch.autograd.grad(loss, aliases)]
        model_os = self.model_opt.update(masters, grads, model_os)
        return dp_os, model_os, loss.detach(), acc.detach()

    def _shared_feature_step(self, params, dp_os, model_os, batch, weight, epsilon, gen,
                             dp_noise, dropout):
        """Both phases over one encoder forward (trainer.py:414-465 there):
        the features never read ``DP``, and under shared dropout both phases
        draw the same ones, so phase 2's encoder gradient is the backward of
        the one forward. The generator's state after the encoder is restored
        before phase 2, so its head draws phase 1's DP noise again."""
        pc, aliases, masters = self._model_tree(params)
        feature = fusion.encode_features(pc, batch, self.fusion_cfg, gen, dropout)
        return self._two_phases(params, dp_os, model_os, pc, aliases, masters, feature,
                                feature, batch, weight, epsilon, gen, gen, dp_noise,
                                replay=gen.get_state())

    def _paired_phase_step(self, params, dp_os, model_os, batch, weight, epsilon, g1, g2,
                           dp_noise, dropout):
        """Both phases' encoder forwards as one forward over the batch
        stacked twice (trainer.py:350-412 there), the halves drawing from
        (g1, g2) as two sequential forwards would: the encoder never reads
        ``DP``, and phase 1 updates only ``DP``. Phase 1 takes ``dDP`` on
        half 0, phase 2 backs up through half 1 (a zero cotangent on half 0,
        the slice's gradient)."""
        if self.train_cfg.share_phase_dropout:
            g2.set_state(g1.get_state())
        pc, aliases, masters = self._model_tree(params)
        B = weight.shape[0]
        pair = {k: torch.cat([v, v]) for k, v in batch.items() if k != "labels"}
        feats = fusion.encode_features(pc, pair, self.fusion_cfg, (g1, g2), dropout)
        return self._two_phases(params, dp_os, model_os, pc, aliases, masters, feats[:B],
                                feats[B:], batch, weight, epsilon, g1, g2, dp_noise)

    # -- epochs -----------------------------------------------------------------
    def train_epoch(self, params, dp_os, model_os, data, idx, weight, epsilon, gen):
        """Every batch of ``idx`` once; returns (dp_os, model_os, mean loss,
        mean accuracy), the means of batch means (base_train.py:239-242)
        as device tensors of shape ``lead``."""
        params_c = self.precast_copy(params) if self.precast else None
        losses, accs = [], []
        for b_idx, w in zip(idx, weight):
            dp_os, model_os, loss, acc = self.train_step(
                params, dp_os, model_os, gather_batch(data, b_idx), w, epsilon, gen,
                params_c=params_c)
            losses.append(loss)
            accs.append(acc)
        return dp_os, model_os, torch.stack(losses).mean(0), torch.stack(accs).mean(0)

    @torch.no_grad()
    def eval_epoch(self, params, data, idx, weight, epsilon, gen, dp_noise=None):
        """Stochastic eval: hard=True, dropout off, DP noise on, the params
        cast to the compute dtype once, each batch under ``n_eval`` noise
        draws (trainer.py:468-513 there). Returns (loss, acc, preds, labels,
        scores, weights): loss and accuracy the means over repeats of the
        batch means, then over batches; per row the majority vote of the
        repeats' predictions (a tie votes 0) and the mean of their scores,
        logits[:, 1]; the per-row tensors flattened over the batches. With
        ``eval_vmap_batches`` every repeat of every batch goes through one
        forward of n_eval x n_batches x B rows (trainer.py:495-501 there),
        else each batch through one of n_eval x B rows. ``dp_noise`` (tests
        only) gives each batch its (B, F) noise, or its n_eval of them. The
        losses, accuracies, predictions and scores lead with ``lead``."""
        params = self.compute(params)
        n_eval = self.train_cfg.n_eval
        n_batches, B = idx.shape
        noise = None
        if dp_noise is not None:  # (n_eval, n_batches, B, F)
            noise = torch.stack([torch.stack(list(n)).reshape(n_eval, B, -1) for n in dp_noise],
                                dim=1)
        if self.train_cfg.eval_vmap_batches:
            parts = [slice(None)]
        else:
            parts = [slice(i, i + 1) for i in range(n_batches)]
        outs = [self._eval_batches(params, data, idx[c], weight[c], epsilon, gen,
                                   None if noise is None else noise[:, c]) for c in parts]
        # the batch axis of each: per batch (loss, acc), per row (vote, label, score)
        losses, accs, preds, labels, scores = (
            outs[0] if len(outs) == 1
            else (torch.cat(t, dim=d) for t, d in zip(zip(*outs), (-1, -1, -2, 0, -2))))
        lead = self.lead
        return (losses.mean(-1), accs.mean(-1), preds.reshape(*lead, -1), labels.reshape(-1),
                scores.reshape(*lead, -1), weight.reshape(-1))

    def _eval_batches(self, params, data, idx, weight, epsilon, gen, noise):
        """One forward over n_eval repeats of the (n, B) batches ``idx``:
        per-batch (loss, acc) means over the repeats, and per row the vote,
        the label and the mean score, each with a leading n."""
        n_eval = self.train_cfg.n_eval
        n, B = idx.shape
        rows = idx.reshape(-1)
        batch = gather_batch(data, rows if n_eval == 1 else rows.repeat(n_eval))
        logits = self.forward(params, batch, epsilon, True, gen, False,
                              None if noise is None else noise.reshape(n_eval * n * B, -1))
        logits = logits.reshape(*self.lead, n_eval, n, B, -1)
        labels = batch["labels"][:n * B].reshape(n, B)
        # per-batch means over each (repeat, batch), with the batch's weights
        losses, accs, pred, _ = M.cal_loss(logits, labels.expand(*self.lead, n_eval, n, B),
                                           weight)
        vote = (pred.to(torch.float32).mean(-3) > 0.5).to(pred.dtype)
        return losses.mean(-2), accs.mean(-2), vote, labels, logits[..., 1].mean(-3)

    def epoch(self, params, dp_os, model_os, train_data, test_data, idx, weight, train_gen,
              eidx, eweight, eval_gen, epsilon):
        """A train epoch, an eval epoch and F1, all on the device: returns
        (dp_os, model_os, row), the row a (*lead, 5) tensor (train loss,
        train accuracy, test loss, test accuracy, F1)."""
        dp_os, model_os, tr_loss, tr_acc = self.train_epoch(
            params, dp_os, model_os, train_data, idx, weight, epsilon, train_gen)
        te_loss, te_acc, preds, labels, _, ws = self.eval_epoch(
            params, test_data, eidx, eweight, epsilon, eval_gen)
        return dp_os, model_os, torch.stack([tr_loss, tr_acc, te_loss, te_acc,
                                             M.f1(labels, preds, ws)], dim=-1)

    def cycle(self, params, dp_os, model_os, train_data, test_data, idx_all, w_all,
              train_gens, eidx, ew, eval_gens, epsilon):
        """K train+eval epochs with F1 on the device and no host sync
        (trainer.py:516-561 there); updates ``params`` in place and returns
        (dp_os, model_os, rows), the rows one (K, 5) device tensor of
        (train loss, train accuracy, test loss, test accuracy, F1).

        Every input is ready on the device: ``idx_all`` / ``w_all`` (K,
        n_batches, B), the eval ``eidx`` / ``ew`` (n_batches, B), or (K,
        n_batches, B) for an order per epoch, and K train and K eval
        generators. ``Trainer.cycle_inputs`` builds them as K
        ``Trainer.run_epoch`` calls draw theirs, and the rows are then those
        calls' rows."""
        rows = []
        for k, (tg, eg) in enumerate(zip(train_gens, eval_gens)):
            ek, ewk = (eidx[k], ew[k]) if eidx.dim() == 3 else (eidx, ew)
            dp_os, model_os, row = self.epoch(params, dp_os, model_os, train_data, test_data,
                                              idx_all[k], w_all[k], tg, ek, ewk, eg, epsilon)
            rows.append(row)
        return dp_os, model_os, torch.stack(rows)


class Trainer:
    """Epoch orchestration (base_train.py:175-235): shuffled train epoch,
    stochastic eval epoch, F1. Runs on the card unless ``device="cpu"``."""

    def __init__(self, fusion_cfg: fusion.FusionConfig,
                 train_cfg: TrainConfig = TrainConfig(), params=None, bert_params=None,
                 device=None, vocab: Optional[CompactVocab] = None):
        """``vocab``: the compact vocabulary the token ids were remapped to
        (the word table has ``vocab.size`` rows); checkpoints then scatter
        the table back to full-vocab rows."""
        self.device = resolve_device(device)
        self.fusion_cfg = fusion_cfg
        self.train_cfg = train_cfg
        self.vocab = vocab
        if params is None:
            params = fusion.init(fusion_cfg, derive_seed(train_cfg.seed, "init"),
                                 self.device, bert_params=bert_params)
        self.params = params
        self.steps = StepFunctions(fusion_cfg, train_cfg, self.device)
        self.dp_os, self.model_os = self.steps.init_opt_states(params)

    def export_params(self, params=None):
        """Params for checkpoint export: ``params`` (by default the live
        tree), with a compact vocab's word table scattered back to the
        full-vocab rows (as a CPU tensor), so that state dicts keep the
        reference's layout (trainer.py:604-618 there)."""
        params = self.params if params is None else params
        if self.vocab is None or "bert" not in params:
            return params
        word = params["bert"]["embeddings"]["word"].detach().cpu().numpy()
        emb = {**params["bert"]["embeddings"],
               "word": torch.from_numpy(self.vocab.expand_embeddings(word))}
        return {**params, "bert": {**params["bert"], "embeddings": emb}}

    def epoch_inputs(self, epoch: int, n_train: int, n_test: int):
        """The inputs of epoch ``epoch``, on the device: the shuffled train
        index matrix and weights, the train generator, the eval index matrix
        (in order, or shuffled with ``shuffle_eval``) and weights, the eval
        generator. Each is drawn from its own generator, seeded from (seed,
        epoch, name): the eval order from a CPU generator of its own, so
        that ``shuffle_eval`` moves no other draw."""
        cfg = self.train_cfg

        def gen(name, device="cpu"):
            return epoch_generator(cfg.seed, epoch, name, device)

        idx, w = epoch_indices(n_train, cfg.batch_size, True, gen("shuffle"), self.device)
        eidx, ew = epoch_indices(n_test, cfg.batch_size, cfg.shuffle_eval,
                                 gen("eval_shuffle") if cfg.shuffle_eval else None, self.device)
        return idx, w, gen("train", self.device), eidx, ew, gen("eval", self.device)

    def cycle_inputs(self, epochs, n_train: int, n_test: int):
        """The inputs of ``StepFunctions.cycle`` for ``epochs``, each drawn
        as :meth:`epoch_inputs` draws it: (idx_all, w_all, train_gens,
        eidx, ew, eval_gens), the index matrices stacked on a leading K."""
        idx, w, tgens, eidx, ew, egens = zip(*(self.epoch_inputs(e, n_train, n_test)
                                                for e in epochs))
        return (torch.stack(idx), torch.stack(w), list(tgens), torch.stack(eidx),
                torch.stack(ew), list(egens))

    def run_epoch(self, epoch: int, train_dev, test_dev, n_train: int,
                  n_test: int, epsilon: float) -> Dict[str, Any]:
        """One train+eval epoch. Updates the trainer's parameters and
        optimizer states; returns the epoch's metric row."""
        t0 = time.time()
        idx, w, train_gen, eidx, ew, eval_gen = self.epoch_inputs(epoch, n_train, n_test)
        self.dp_os, self.model_os, row = self.steps.epoch(
            self.params, self.dp_os, self.model_os, train_dev, test_dev, idx, w, train_gen,
            eidx, ew, eval_gen, epsilon)
        # one host sync for the whole row
        tr_loss, tr_acc, te_loss, te_acc, f1 = row.tolist()
        return dict(
            epoch=epoch + 1, train_loss=tr_loss, train_acc=tr_acc,
            test_loss=te_loss, test_acc=te_acc, f1=f1, time_cost=time.time() - t0,
        )

    def fit(self, train_data: MultiModalArrays, test_data: MultiModalArrays,
            epsilon: float, log_path: Optional[str] = None,
            model_path: Optional[str] = None, echo: bool = True,
            epoch_end_hook=None) -> Dict[str, Any]:
        """Train ``epochs`` epochs (base_train.py:175-255): each epoch's
        legacy record to ``log_path``, and the best-F1 params to
        ``model_path`` in the reference's state-dict format. Returns
        ``{"history", "best", "f1_best"}``.

        With ``defer_best_checkpoint`` an improvement takes a device-side
        copy of the params; the copy goes to disk every
        ``defer_flush_epochs`` epochs and at the end, inside ``finally``, at
        exit and on SIGTERM, so a run that stops keeps its best.
        """
        cfg = self.train_cfg
        recorder = RunRecorder(log_path, echo=echo) if log_path else None
        train_dev = train_data.to_device(self.device)
        test_dev = test_data.to_device(self.device)
        n_train, n_test = len(train_data), len(test_data)
        f1_best = cfg.f1_best_init
        best_record = None
        history = []
        pending = {"params": None}  # a best not yet on disk

        def write_best(params):
            ckpt.save_torch_checkpoint(model_path, self.export_params(params), self.fusion_cfg)

        def flush_pending(*_args):
            p, pending["params"] = pending["params"], None
            if p is not None and model_path:
                write_best(p)

        # The reference persists every improvement (base_train.py:251);
        # deferral must not lose the pending best when the process ends:
        # atexit covers a normal exit, a SIGTERM handler (flush, then the
        # previous disposition) covers a kill. Handlers install only from
        # the main thread.
        atexit.register(flush_pending)
        prev_term = None
        try:
            prev_term = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                flush_pending()
                signal.signal(signal.SIGTERM,
                              prev_term if prev_term is not None else signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_term)
        except ValueError:  # not the main thread
            prev_term = None

        try:
            for epoch in range(cfg.epochs):
                row = self.run_epoch(epoch, train_dev, test_dev, n_train, n_test, epsilon)
                history.append(row)
                rec = None
                if recorder:
                    rec = recorder.epoch(epoch, row["train_loss"], row["train_acc"],
                                         row["test_loss"], row["test_acc"], row["f1"],
                                         row["time_cost"])
                if row["f1"] > f1_best:
                    f1_best = row["f1"]
                    best_record = row
                    if model_path:
                        if cfg.defer_best_checkpoint:
                            pending["params"] = tree_map(torch.clone, self.params)
                        else:
                            write_best(self.params)
                    if rec:
                        recorder.best_record(rec)
                if (pending["params"] is not None and cfg.defer_flush_epochs
                        and (epoch + 1) % cfg.defer_flush_epochs == 0):
                    flush_pending()
                if epoch_end_hook is not None:
                    epoch_end_hook(epoch)
        finally:
            # inside finally, so an exception or KeyboardInterrupt still
            # writes the pending best
            flush_pending()
            atexit.unregister(flush_pending)
            if prev_term is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_term)
                except ValueError:
                    pass

        return {"history": history, "best": best_record, "f1_best": f1_best}
