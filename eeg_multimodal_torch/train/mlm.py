"""Masked-language-model pretraining of the BERT encoder on sensor text.

Port of the JAX package's ``train/mlm.py``. The reference fine-tunes from
pretrained HF ``BertModel.from_pretrained`` weights (ref: models.py:40),
which are not available offline; the corpus the encoder sees is tiny and
purely numeric (space-joined ints, ref get_embedding.py:113-116), so domain
MLM pretraining on the serialized sensor rows manufactures the init.

Recipe (Devlin et al. 2018): 15 % of the non-special positions are
selected; of those 80 % become [MASK], 10 % a random id, 10 % stay; the
loss is the cross-entropy at the selected positions, the decoder tied to the
word table. Three pretexts ride along (``train/pretext.py``): row-value
regression from the pooled output, whole-number corruption, and a cosine
loss to the sample's act-CLIP embedding.

The corpus lives on the device; each step draws its batch indices and its
masking there from the run's generator, and a chunk of ``log_every`` steps
makes one host sync, for its mean loss. Every draw can also be handed in
(``mask_tokens``'s ``r``, ``kind``, ``rand_ids``; a step's batch indices),
so that the CPU tests give the port the JAX package's own draws. With
``compute_dtype="bfloat16"`` the whole ``{"bert", "head"}`` tree, word
table included, is cast inside the step; the vocabulary logits and the
log-softmax are f32, and AdamW updates the f32 masters.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data import datasets as D
from ..data.compact_vocab import build_compact_vocab, remap_pairing
from ..models import bert as bert_mod
from ..models.layers import layer_norm, linear
from ..ops.optim import AdamW, warmup_cosine_decay_schedule
from ..utils.device import resolve_device
from ..utils.seeding import derive_seed, generator
from ..utils.trees import tree_cast, tree_items, tree_map
from . import pretext
from .checkpoint import load_pytree, save_pytree


@dataclasses.dataclass(frozen=True)
class MLMConfig:
    """The JAX package's ``MLMConfig`` (mlm.py:37-75 there), every field
    with its name and default."""

    mask_prob: float = 0.15
    mask_token_frac: float = 0.8  # of the selected: replaced by [MASK]
    random_token_frac: float = 0.1  # of the selected: replaced by a random id
    # weight of the row-value regression from the pooled output (0 = off)
    row_reg_weight: float = 0.0
    # select corruption per word (needs a word-start index, pretext.py)
    whole_word: bool = False
    # weight of the cosine loss to the act-CLIP target (0 = off)
    clip_weight: float = 0.0
    batch_size: int = 64
    learning_rate: float = 1e-4
    warmup_steps: int = 200
    total_steps: int = 6000
    weight_decay: float = 0.01
    seed: int = 980616
    # token ids in the corpus's id space (compact or full)
    mask_id: int = 103
    cls_id: int = 101
    sep_id: int = 102
    pad_id: int = 0
    # steps per chunk: one host sync a chunk, for its loss
    log_every: int = 50
    compute_dtype: str = "bfloat16"


def head_init(gen: torch.Generator, config: bert_mod.BertConfig, device=None,
              n_values: int = 0, n_clip: int = 0):
    """HF ``BertOnlyMLMHead`` (dense, erf GELU, LayerNorm, the tied decoder's
    bias) at normal(0, initializer_range), with the pretexts' heads off the
    pooled output: ``reg`` (H, n_values) and ``clip`` (H, n_clip). Drawn
    from ``gen`` on its device, in that order, then moved to ``device``."""
    dev = resolve_device(device)
    H, std = config.hidden_size, config.initializer_range

    def dense(n_out):
        return {"kernel": std * torch.randn(H, n_out, generator=gen, device=gen.device),
                "bias": torch.zeros(n_out, device=gen.device)}

    head = {"transform": dense(H),
            "ln": {"scale": torch.ones(H, device=gen.device),
                   "bias": torch.zeros(H, device=gen.device)},
            "decoder_bias": torch.zeros(config.vocab_size, device=gen.device)}
    if n_values:
        head["reg"] = dense(n_values)
    if n_clip:
        head["clip"] = dense(n_clip)
    return tree_map(lambda t: t.to(dev), head)


def params_from_jax(tree, device=None):
    """The JAX package's ``{"bert": bert.init, "head": head_init}`` tree
    (numpy leaves) as the port's f32 tree on ``device`` (the card unless
    "cpu"). Raises ``ValueError`` where the head's layout is not
    :func:`head_init`'s for the tree's word table."""
    dev = resolve_device(device)
    params = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), tree)
    V, H = params["bert"]["embeddings"]["word"].shape
    head = params["head"]
    want = {"transform/kernel": (H, H), "transform/bias": (H,), "ln/scale": (H,),
            "ln/bias": (H,), "decoder_bias": (V,)}
    for name in ("reg", "clip"):
        if name in head:
            n = head[name]["bias"].shape[0]
            want.update({f"{name}/kernel": (H, n), f"{name}/bias": (n,)})
    got = {path: tuple(t.shape) for path, t in tree_items(head)}
    if got != want:
        raise ValueError(f"the head's layout {got} is not head_init's {want}")
    return params


def mlm_outputs(bert_params, head, input_ids, attention_mask, config, gen):
    """(vocabulary logits over the sequence, f32; pooled output) from one
    encoder pass; dropout from ``gen``, off when it is None. The tied
    decoder ``h word^T + decoder_bias`` accumulates in f32 and keeps f32
    (``preferred_element_type=float32`` there): bf16 operands are cast up,
    their products exact in f32."""
    seq, pooled = bert_mod.apply(bert_params, input_ids, attention_mask, config, gen)
    h = F.gelu(linear(head["transform"], seq))  # erf GELU
    h = layer_norm(head["ln"], h, config.layer_norm_eps)
    word = bert_params["embeddings"]["word"]
    logits = torch.matmul(h.float(), word.float().t()) + head["decoder_bias"].float()
    return logits, pooled


def mlm_logits(bert_params, head, input_ids, attention_mask, config, gen):
    return mlm_outputs(bert_params, head, input_ids, attention_mask, config, gen)[0]


def mask_tokens(gen, input_ids, attention_mask, cfg: MLMConfig, vocab_size: int,
                word_start=None, r=None, kind=None, rand_ids=None):
    """BERT masking on the device. Returns (corrupted ids, labels, selected).

    ``r`` and ``kind`` (uniforms in [0, 1)) and ``rand_ids`` (uniform in
    [0, vocab_size)), each of the ids' shape, are drawn from ``gen`` in that
    order where not given. With ``cfg.whole_word`` and a ``word_start``
    index (B, S; ``pretext.word_start_index``) the uniforms are gathered at
    each word's first piece, so that every piece of a number shares one
    decision (mlm.py:133-160 there)."""
    dev = input_ids.device
    special = (input_ids == cfg.cls_id) | (input_ids == cfg.sep_id) | (attention_mask == 0)
    if r is None:
        r = torch.rand(input_ids.shape, generator=gen, device=dev)
    if kind is None:
        kind = torch.rand(input_ids.shape, generator=gen, device=dev)
    if rand_ids is None:
        rand_ids = torch.randint(0, vocab_size, input_ids.shape, generator=gen, device=dev,
                                 dtype=input_ids.dtype)
    if cfg.whole_word and word_start is not None:
        r = torch.gather(r, -1, word_start)
        kind = torch.gather(kind, -1, word_start)
    selected = (r < cfg.mask_prob) & ~special
    use_mask = kind < cfg.mask_token_frac
    use_rand = (kind >= cfg.mask_token_frac) & (kind < cfg.mask_token_frac + cfg.random_token_frac)
    corrupted = torch.where(selected & use_mask, cfg.mask_id, input_ids)
    corrupted = torch.where(selected & use_rand, rand_ids.to(input_ids.dtype), corrupted)
    return corrupted, input_ids, selected


def mlm_loss(bert_params, head, batch_ids, batch_mask, bert_cfg, cfg: MLMConfig, gen,
             train: bool = True, values=None, value_mask=None, word_start=None,
             clip_targets=None, mask_draws=None):
    """The MLM cross-entropy over the selected positions, plus
    ``row_reg_weight`` x the masked MSE of ``values`` (B, V) regressed from
    the pooled output, plus ``clip_weight`` x the mean cosine distance to
    ``clip_targets`` (B, 512). The masking draws from ``gen`` first (or is
    given ``mask_draws``, ``(r, kind, rand_ids)``), then the encoder's
    dropout, which ``train=False`` turns off."""
    r, kind, rand_ids = mask_draws if mask_draws is not None else (None, None, None)
    corrupted, labels, selected = mask_tokens(gen, batch_ids, batch_mask, cfg,
                                              bert_cfg.vocab_size, word_start, r, kind, rand_ids)
    logits, pooled = mlm_outputs(bert_params, head, corrupted, batch_mask, bert_cfg,
                                 gen if train else None)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    w = selected.float()
    loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    if values is not None and cfg.row_reg_weight:
        pred = linear(head["reg"], pooled).float()
        vm = value_mask.float()
        mse = ((pred - values) ** 2 * vm).sum() / torch.clamp(vm.sum(), min=1.0)
        loss = loss + cfg.row_reg_weight * mse
    if clip_targets is not None and cfg.clip_weight:
        pred_c = linear(head["clip"], pooled).float()
        tgt = clip_targets.float()
        cos = (pred_c * tgt).sum(-1) / (
            torch.linalg.norm(pred_c, dim=-1) * torch.linalg.norm(tgt, dim=-1) + 1e-8)
        loss = loss + cfg.clip_weight * (1.0 - cos).mean()
    return loss


class MLMPretrainer:
    """MLM pretraining over a device-resident corpus, on the card unless
    ``device="cpu"``."""

    def __init__(self, bert_cfg: bert_mod.BertConfig, cfg: MLMConfig = MLMConfig(),
                 bert_params=None, n_values: int = 0, n_clip: int = 0, device=None):
        self.bert_cfg = bert_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        if bert_params is None:
            bert_params = bert_mod.init(generator(derive_seed(cfg.seed, "bert"), self.device),
                                        bert_cfg, self.device)
        self.bert_params = bert_params
        self.head = head_init(generator(derive_seed(cfg.seed, "head"), self.device), bert_cfg,
                              self.device, n_values=n_values, n_clip=n_clip)
        warmup = min(cfg.warmup_steps, max(1, cfg.total_steps // 2))
        self.opt = AdamW(warmup_cosine_decay_schedule(0.0, cfg.learning_rate, warmup,
                                                      cfg.total_steps), cfg.weight_decay)
        self.opt_state = self.opt.init(self._leaves())

    def _params(self):
        return {"bert": self.bert_params, "head": self.head}

    def _leaves(self):
        return [t for _, t in tree_items(self._params())]

    def step(self, corpus, gen, idx=None, mask_draws=None):
        """One AdamW step on a batch of the device corpus (a dict: ``ids``,
        ``mask`` and, where their pretexts are on, ``vals``, ``vmask``,
        ``ws``, ``clip``), the batch indices drawn from ``gen`` on the
        device unless ``idx`` is given. Updates the params in place and
        returns the loss as a device scalar (no host sync)."""
        cfg = self.cfg
        if idx is None:
            idx = torch.randint(0, corpus["ids"].shape[0], (cfg.batch_size,), generator=gen,
                                device=self.device)
        b = {k: v[idx] for k, v in corpus.items()}
        leaves = self._leaves()
        aliases = [t.detach().requires_grad_() for t in leaves]
        it = iter(aliases)
        params = tree_map(lambda _: next(it), self._params())
        if cfg.compute_dtype != "float32":
            params = tree_cast(params, getattr(torch, cfg.compute_dtype))
        loss = mlm_loss(params["bert"], params["head"], b["ids"], b["mask"], self.bert_cfg, cfg,
                        gen, values=b.get("vals"), value_mask=b.get("vmask"),
                        word_start=b.get("ws"), clip_targets=b.get("clip"),
                        mask_draws=mask_draws)
        # a leaf the loss does not reach (the pooler, or a pretext head with
        # its weight at 0) has a zero gradient and still decays, as in optax
        grads = [torch.zeros_like(a) if g is None else g
                 for a, g in zip(aliases, torch.autograd.grad(loss, aliases, allow_unused=True))]
        self.opt_state = self.opt.update(leaves, grads, self.opt_state)
        return loss.detach()

    def corpus_on_device(self, corpus_ids, corpus_mask, corpus_vals=None,
                         corpus_val_mask=None, corpus_word_start=None, corpus_clip=None):
        """The corpus as device tensors, each pretext's arrays only where its
        weight is on (mlm.py:295-306 there)."""
        cfg, dev = self.cfg, self.device

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        corpus = {"ids": put(corpus_ids, torch.int64), "mask": put(corpus_mask, torch.int64)}
        if corpus_vals is not None and cfg.row_reg_weight:
            corpus["vals"] = put(corpus_vals, torch.float32)
            corpus["vmask"] = put(corpus_val_mask, torch.float32)
        if corpus_word_start is not None and cfg.whole_word:
            corpus["ws"] = put(corpus_word_start, torch.int64)
        if corpus_clip is not None and cfg.clip_weight:
            corpus["clip"] = put(corpus_clip, torch.float32)
        return corpus

    def fit(self, corpus_ids: np.ndarray, corpus_mask: np.ndarray, echo: bool = True,
            corpus_vals: Optional[np.ndarray] = None,
            corpus_val_mask: Optional[np.ndarray] = None,
            corpus_word_start: Optional[np.ndarray] = None,
            corpus_clip: Optional[np.ndarray] = None):
        """``cfg.total_steps`` MLM steps; returns (bert_params, history), a
        history entry per chunk of ``log_every`` steps with the mean loss of
        its last 50 (one host sync a chunk).

        ``corpus_vals`` / ``corpus_val_mask`` (N, V): the standardized row
        values and their validity, for ``row_reg_weight``;
        ``corpus_word_start`` (N, S), for ``whole_word``; ``corpus_clip``
        (N, 512), for ``clip_weight``."""
        cfg = self.cfg
        corpus = self.corpus_on_device(corpus_ids, corpus_mask, corpus_vals, corpus_val_mask,
                                       corpus_word_start, corpus_clip)
        gen = generator(derive_seed(cfg.seed, "fit"), self.device)
        history, done, t0 = [], 0, time.time()
        while done < cfg.total_steps:
            n = min(cfg.log_every, cfg.total_steps - done)
            losses = [self.step(corpus, gen) for _ in range(n)]
            done += n
            loss = float(torch.stack(losses[-50:]).mean())
            history.append({"step": done, "loss": loss})
            if echo:
                print(f"[mlm] step {done}/{cfg.total_steps} loss {loss:.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        return self.bert_params, history

    @torch.no_grad()
    def eval_loss(self, corpus_ids, corpus_mask, n_batches: int = 20) -> float:
        """Mean MLM loss over ``n_batches`` batches of held-out rows, each
        from a generator of its own (batch indices, then masking): the
        masking stays random, the encoder's dropout is off, and the params
        stay f32 (mlm.py:330-351 there)."""
        cfg = self.cfg
        ids = torch.as_tensor(np.asarray(corpus_ids), dtype=torch.int64, device=self.device)
        mask = torch.as_tensor(np.asarray(corpus_mask), dtype=torch.int64, device=self.device)
        losses = []
        for i in range(n_batches):
            gen = generator(derive_seed(0, "eval", i), self.device)
            idx = torch.randint(0, ids.shape[0], (cfg.batch_size,), generator=gen,
                                device=self.device)
            losses.append(mlm_loss(self.bert_params, self.head, ids[idx], mask[idx],
                                   self.bert_cfg, cfg, gen, train=False))
        return float(torch.stack(losses).mean())


def build_corpus(token_dicts, max_len: Optional[int] = None, multiple: int = 128):
    """{input_ids, attention_mask} dicts stacked into one corpus, cut to the
    longest valid row rounded up to ``multiple`` (the exact truncation of
    ``data.datasets.truncate_tokens``)."""
    ids = np.concatenate([np.asarray(t["input_ids"]) for t in token_dicts])
    mask = np.concatenate([np.asarray(t["attention_mask"]) for t in token_dicts])
    if max_len is None:
        longest = int(mask.sum(axis=1).max())
        max_len = min(-(-longest // multiple) * multiple, ids.shape[1])
    return ids[:, :max_len].astype(np.int32), mask[:, :max_len].astype(np.int32)


def load_row_values(csv_path: str) -> np.ndarray:
    """A processed CSV's numeric rows (header skipped), f64: the values the
    serialized text spells (ref get_embedding.py:113-114)."""
    return np.loadtxt(csv_path, delimiter=",", skiprows=1, dtype=np.float64)


def standardize_rows(values: np.ndarray):
    """Per-column standardization over the given rows: (standardized f32,
    mean, std); a constant column gets std 1."""
    mean, std = values.mean(axis=0), values.std(axis=0)
    std = np.where(std < 1e-12, 1.0, std)
    return ((values - mean) / std).astype(np.float32), mean, std


def build_value_targets(per_modal_values):
    """Each modality's standardized rows, padded to the widest, stacked in
    the corpus's order (EEG rows, then act rows), with a validity mask."""
    vmax = max(v.shape[1] for v in per_modal_values)
    vals, masks = [], []
    for v in per_modal_values:
        std, _, _ = standardize_rows(v)
        vals.append(np.pad(std, ((0, 0), (0, vmax - std.shape[1]))))
        m = np.zeros((std.shape[0], vmax), np.float32)
        m[:, : std.shape[1]] = 1.0
        masks.append(m)
    return np.concatenate(vals), np.concatenate(masks)


def pretrain_finetune_mlm(
    data_root: str,
    out_root: str,
    mlm_steps: int = 8000,
    mlm_batch: int = 128,
    mlm_lr: float = 1e-4,
    epsilon: float = 0.1,
    epochs: int = 120,
    batch_size: int = 8,
    learning_rate: float = 1e-6,
    compute_dtype: str = "bfloat16",
    path_suffix: str = "DPMLD/",
    bert_ckpt: Optional[str] = None,
    bert_config: Optional[bert_mod.BertConfig] = None,
    echo: bool = True,
    row_reg_weight: float = 0.0,
    aug_factor: int = 0,
    aug_jitter: float = 0.03,
    whole_word: bool = False,
    clip_weight: float = 0.0,
    dp_mode: str = "lapacian_dropout",
    device=None,
):
    """The weights-free pipeline (mlm.py:400-586 there): MLM pretraining on
    the train split's serialized rows of both modalities (with the pretexts
    asked for), then the DP-MLD fine-tune through ``TrainAndTest.train_on``,
    on the compact vocabulary throughout. Writes ``compact_vocab.npz``,
    ``bert_mlm.pickle`` (``save_pytree``) and ``mlm_history.json`` under
    ``out_root``, and the fine-tune's records and best checkpoint there.
    ``bert_ckpt`` skips the MLM stage and loads the encoder from a
    ``save_pytree`` file. Runs on the card unless ``device="cpu"``. Returns
    the fine-tune's result dict."""
    from .api import TrainAndTest

    os.makedirs(out_root, exist_ok=True)
    job = TrainAndTest(batch_size=batch_size, learning_rate=learning_rate, epochs=epochs,
                       data_root=data_root, artifacts_root=out_root,
                       compute_dtype=compute_dtype, echo=echo, device=device)
    splits = [job._load_split(s, "ti", "bert", "bert-base-uncased", "clip", "ViT-B/32")
              for s in ("train", "test")]
    train, test = D.truncate_pair(*splits)

    emb_root = os.path.join(data_root, "data", "embedding")
    corpus_dicts, corpus_values, per_modal_counts = [], [], []
    for modal in ("EEG", "act"):
        path = os.path.join(emb_root, modal, "txt", "bert_bert_base_uncased", "train.pickle")
        if not os.path.exists(path):
            continue
        tok = D.load_bert_pickle(path)
        csv_path = os.path.join(data_root, "data", "processed", f"train_{modal}.csv")
        need_rows = bool(row_reg_weight) or aug_factor > 0
        if need_rows and not os.path.exists(csv_path):
            raise FileNotFoundError(
                f"row_reg_weight/aug_factor requested but {csv_path} is missing: the pretext "
                f"would train without its {modal} rows")
        vals = load_row_values(csv_path) if need_rows else None
        if vals is not None and vals.shape[0] != tok["input_ids"].shape[0]:
            # per modality: a total that matches could hide two mismatches
            raise ValueError(
                f"{modal}: {vals.shape[0]} csv rows vs {tok['input_ids'].shape[0]} token rows: "
                f"train_{modal}.csv and the token pickle disagree")
        if aug_factor > 0:
            aug = pretext.augment_rows(vals, aug_factor, aug_jitter,
                                       seed=0xA06 + (0 if modal == "EEG" else 1))
            aug_tok = pretext.tokenize_rows(aug, max_len=tok["input_ids"].shape[1])
            tok = {k: np.concatenate([tok[k], aug_tok[k]]) for k in ("input_ids",
                                                                    "attention_mask")}
            if row_reg_weight:
                vals = np.concatenate([vals, aug])
        corpus_dicts.append(tok)
        per_modal_counts.append(tok["input_ids"].shape[0])
        if row_reg_weight:
            corpus_values.append(vals)
    corpus_ids, corpus_mask = build_corpus(corpus_dicts)
    corpus_vals = corpus_vmask = corpus_ws = corpus_clip = None
    n_values = n_clip = 0
    if row_reg_weight:
        corpus_vals, corpus_vmask = build_value_targets(corpus_values)
        n_values = corpus_vals.shape[1]
        if corpus_vals.shape[0] != corpus_ids.shape[0]:
            raise ValueError("value rows misaligned with token rows")
    if whole_word:
        # from the full-vocab ids, before compaction; start indices only
        # point backwards, so the cut to the corpus's length keeps them
        cont = pretext.continuation_id_set()
        corpus_ws = np.concatenate([pretext.word_start_index(np.asarray(d["input_ids"]), cont)
                                    for d in corpus_dicts])[:, : corpus_ids.shape[1]]
    if clip_weight:
        corpus_clip = pretext.stack_clip_targets(per_modal_counts,
                                                 pretext.load_act_clip_targets(data_root))
        n_clip = corpus_clip.shape[1]
        if corpus_clip.shape[0] != corpus_ids.shape[0]:
            raise ValueError("CLIP targets misaligned with token rows")

    # over the corpus and both splits: a test-only id must not become [UNK]
    vocab = build_compact_vocab([d["input_ids"] for d in corpus_dicts]
                                + [train.eeg_input, test.eeg_input])
    if echo:
        print(f"[vocab] compact size {vocab.size} (full 30522)", flush=True)
    vocab.save(os.path.join(out_root, "compact_vocab.npz"))
    corpus_ids = vocab.remap(corpus_ids)
    train, test = remap_pairing(train, vocab), remap_pairing(test, vocab)
    bert_cfg = dataclasses.replace(bert_config or bert_mod.BertConfig(), vocab_size=vocab.size)

    if bert_ckpt:
        bert_params = load_pytree(bert_ckpt, job.device)
    else:
        cfg = MLMConfig(
            batch_size=mlm_batch, learning_rate=mlm_lr, total_steps=mlm_steps,
            warmup_steps=max(50, mlm_steps // 20), mask_id=vocab.mask_id,
            cls_id=vocab.cls_id, sep_id=vocab.sep_id, pad_id=vocab.pad_id,
            row_reg_weight=row_reg_weight, whole_word=whole_word, clip_weight=clip_weight,
        )
        pre = MLMPretrainer(bert_cfg, cfg, n_values=n_values, n_clip=n_clip, device=job.device)
        bert_params, history = pre.fit(corpus_ids, corpus_mask, echo=echo,
                                       corpus_vals=corpus_vals, corpus_val_mask=corpus_vmask,
                                       corpus_word_start=corpus_ws, corpus_clip=corpus_clip)
        save_pytree(os.path.join(out_root, "bert_mlm.pickle"), bert_params)
        with open(os.path.join(out_root, "mlm_history.json"), "w") as f:
            json.dump(history, f)

    job.bert_params = bert_params
    # the data and bert_params are compact already; the vocab makes the best
    # checkpoint scatter the word table back to full-vocab rows
    return job.train_on(train, test, "demo", path_suffix, "ti", dp_mode, epsilon=epsilon,
                        bert_config=bert_cfg, vocab=vocab)
