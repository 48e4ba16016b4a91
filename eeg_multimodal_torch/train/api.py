"""Public API facade: ``TrainAndTest`` with the reference's signature.

Port of the JAX package's ``train/api.py:27-228`` (reference:
python/src/custom_models/base_train.py:47-553): the same argument list, the
same path-based dataset resolution (base_train.py:77-125) and the same
on-disk layout,

  data/embedding/<modal>/<txt|img>/<model>_<coef_std>/{train,test}.pickle
  data/processed/{train,test}_label.csv
  models/custom/<train_type>/<path_suffix>best_f1.pickle
  logs/<train_type>/<path_suffix>{whole,best}_record.txt

with the port's trainers underneath, on the card unless ``device="cpu"``,
and ``predict``, which evaluates a trained checkpoint. Every class of the
model zoo trains and predicts: ``dp_mode="DPSGD"`` through the DP-SGD
trainer (``train/dpsgd_trainer.py``), in f32 whatever ``compute_dtype``
says and over the full vocabulary, every other mode through ``Trainer``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np

from ..data import datasets as D
from ..data.compact_vocab import build_compact_vocab, remap_pairing
from ..data.embedding import standardize_coef
from ..dp.dpsgd import DPSGDConfig
from ..models import fusion
from ..models.bert import BertConfig
from ..utils.device import resolve_device
from ..utils.seeding import DEFAULT_SEED, generator
from . import metrics as M
from .checkpoint import load_torch_checkpoint
from .dpsgd_trainer import DPSGDTrainer
from .trainer import StepFunctions, TrainConfig, Trainer


class TrainAndTest:
    """ref signature: TrainAndTest(batch_size=8, learning_rate=1e-6,
    epochs=50).train(train_type, path_suffix, multimodal_type, dp_mode,
    eeg_model, eeg_model_coef, act_model, act_model_coef, cross_atn_type,
    epsilon).

    ``compute_dtype`` keeps the JAX package's default, "bfloat16" (the
    forward on a bf16 copy of f32 master params); "float32" is the
    reference's own precision (and DP-SGD's, whatever this says).
    ``device`` is the card unless "cpu". After ``train_on`` the trainer of
    the run stays in ``self.trainer``.
    """

    def __init__(
        self,
        batch_size: int = 8,
        learning_rate: float = 1e-6,
        epochs: int = 50,
        data_root: str = ".",
        compute_dtype: str = "bfloat16",
        bert_params=None,
        echo: bool = True,
        artifacts_root: Optional[str] = None,
        seed: int = DEFAULT_SEED,  # ref: base_train.py:43 set_seed(980616)
        device=None,
    ):
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.data_root = data_root
        self.compute_dtype = compute_dtype
        self.bert_params = bert_params
        self.echo = echo
        self.seed = seed
        # logs and checkpoints go under artifacts_root, by default data_root
        self.artifacts_root = artifacts_root or data_root
        self.device = resolve_device(device)
        self.trainer = None  # a Trainer, or a DPSGDTrainer

    # -- dataset resolution (base_train.py:77-125) ---------------------------
    def _embedding_path(self, modal: str, repr_: str, model: str, coef: str, split: str):
        return os.path.join(
            self.data_root, "data", "embedding", modal, repr_,
            f"{model}_{standardize_coef(coef)}", f"{split}.pickle",
        )

    def _load_split(self, split, multimodal_type, eeg_model, eeg_model_coef,
                    act_model, act_model_coef):
        labels = D.load_label_csv(
            os.path.join(self.data_root, "data", "processed", f"{split}_label.csv"))
        kw: Dict[str, Any] = {}
        eeg_repr = "txt" if multimodal_type[0] == "t" else "img"
        act_repr = "txt" if multimodal_type[1] == "t" else "img"
        eeg_path = self._embedding_path("EEG", eeg_repr, eeg_model, eeg_model_coef, split)
        act_path = self._embedding_path("act", act_repr, act_model, act_model_coef, split)
        if eeg_repr == "txt":
            kw["eeg_txt"] = D.load_bert_pickle(eeg_path)
        else:
            kw["eeg_img"] = D.load_embedding_pickle(eeg_path)
        if act_repr == "txt":
            kw["act_txt"] = D.load_bert_pickle(act_path)
        else:
            kw["act_img"] = D.load_embedding_pickle(act_path)
        return D.build_pairing(multimodal_type, labels, **kw)

    # -- the public train entry ---------------------------------------------
    def train(self, train_type: str, path_suffix: str, multimodal_type: str, dp_mode: str,
              eeg_model: str, eeg_model_coef: str, act_model: str, act_model_coef: str,
              cross_atn_type: str, epsilon: float):
        splits = [self._load_split(split, multimodal_type, eeg_model, eeg_model_coef,
                                   act_model, act_model_coef) for split in ("train", "test")]
        return self.train_on(*splits, train_type, path_suffix, multimodal_type, dp_mode,
                             eeg_model_coef, cross_atn_type, epsilon)

    def train_on(
        self,
        train_data,
        test_data,
        train_type: str,
        path_suffix: str,
        multimodal_type: str,
        dp_mode: str,
        eeg_model_coef: str = "bert-base-uncased",
        cross_atn_type: str = "double_stream",
        epsilon: float = 0.1,
        bert_config=None,
        auto_truncate: bool = True,
        compact_vocab: bool = False,
        vocab=None,
    ):
        """In-memory variant of :meth:`train` (datasets already built).

        ``auto_truncate`` drops all-padding token columns (exact, see
        ``data.datasets.truncate_tokens``); with it off the encoder runs at
        the padded 512 tokens.

        ``compact_vocab`` remaps the token ids to the ones the data uses
        (``data/compact_vocab.py``), shrinking the word table to those rows:
        the trajectory is the same (rows never gathered get zero gradient,
        so Adam leaves them as they are), and checkpoints scatter the table
        back to full-vocab rows. ``vocab`` is a prebuilt ``CompactVocab``
        for data (and ``bert_params``) the caller remapped already; pass one
        or the other (api.py:118-228 of the JAX package). A setting of the
        run's ``FusionConfig`` or ``TrainConfig`` that these arguments do
        not reach is set by overriding :meth:`run_configs`.

        ``dp_mode="DPSGD"`` trains through ``DPSGDTrainer`` with
        ``DPSGDConfig(epsilon, epochs, batch_size, learning_rate)``, in f32
        over the full vocabulary, the compact one skipped (its trainable
        subtree leaves the word table frozen; api.py:165, :201-215 there).
        It takes no field of the ``TrainConfig``: the F1 an epoch must beat
        to be the best stays the JAX trainer's constant 0.5.
        """
        if compact_vocab and vocab is not None:
            raise ValueError("pass either compact_vocab=True or a prebuilt vocab")
        if auto_truncate:
            train_data, test_data = D.truncate_pair(train_data, test_data)

        bert_params = self.bert_params
        if compact_vocab and dp_mode != "DPSGD" and "t" in multimodal_type:
            base_cfg = bert_config or BertConfig.for_coef(eeg_model_coef)
            streams = []
            for d in (train_data, test_data):
                if multimodal_type[0] == "t":
                    streams.append(d.eeg_input)
                if multimodal_type[1] == "t":
                    streams.append(d.act_input)
            vocab = build_compact_vocab(streams, full_vocab=base_cfg.vocab_size)
            train_data = remap_pairing(train_data, vocab)
            test_data = remap_pairing(test_data, vocab)
            bert_config = dataclasses.replace(base_cfg, vocab_size=vocab.size)
            if bert_params is not None:
                emb = dict(bert_params["embeddings"])
                emb["word"] = vocab.compact_embeddings(emb["word"])
                bert_params = {**bert_params, "embeddings": emb}

        fc = fusion.config_for(multimodal_type, dp_mode, cross_atn_type,
                               bert_coef=eeg_model_coef, dtype="float32")
        if bert_config is not None:
            fc = dataclasses.replace(fc, bert_config=bert_config)
        fc, tc = self.run_configs(fc, TrainConfig(
            batch_size=self.batch_size, learning_rate=self.learning_rate, epochs=self.epochs,
            compute_dtype=self.compute_dtype, seed=self.seed))
        model_path = os.path.join(self.artifacts_root, "models", "custom", train_type,
                                  path_suffix, "best_f1.pickle")
        log_path = os.path.join(self.artifacts_root, "logs", train_type, path_suffix)
        if dp_mode == "DPSGD":
            self.trainer = DPSGDTrainer(
                fc, DPSGDConfig(target_epsilon=epsilon, epochs=self.epochs,
                                batch_size=self.batch_size, learning_rate=self.learning_rate),
                bert_params=self.bert_params, device=self.device)
            return self.trainer.fit(train_data, test_data, log_path=log_path,
                                    model_path=model_path, echo=self.echo)
        self.trainer = Trainer(fc, tc, bert_params=bert_params, device=self.device,
                               vocab=vocab)
        return self.trainer.fit(train_data, test_data, epsilon, log_path=log_path,
                                model_path=model_path, echo=self.echo)

    def run_configs(self, fusion_cfg: fusion.FusionConfig, train_cfg: TrainConfig):
        """The ``(FusionConfig, TrainConfig)`` a ``train_on`` run trains
        with, as built from its arguments and this object's. A subclass
        overrides it to change a field the API does not take, e.g. the DP
        block's ``fused_dp_kernel`` or ``TrainConfig.f1_best_init``. The
        DP-SGD trainer takes only the ``FusionConfig``."""
        return fusion_cfg, train_cfg

    # -- inference on a trained checkpoint (api.py:230-327 there) -------------
    def predict(
        self,
        checkpoint: str,
        multimodal_type: str = "ti",
        dp_mode: str = "lapacian_dropout",
        eeg_model: str = "bert",
        eeg_model_coef: str = "bert-base-uncased",
        act_model: str = "clip",
        act_model_coef: str = "ViT-B/32",
        cross_atn_type: str = "double_stream",
        epsilon: float = 0.1,
        split: str = "test",
        n_eval: int = 1,
        seed: int = DEFAULT_SEED,
        out_csv: Optional[str] = None,
        bert_config=None,
        device=None,
    ):
        """Evaluate a trained best_f1 checkpoint on a split (the reference's
        checkpoint evaluations, train_val.py:508-515 and test_0425.py): load
        the state dict, run the stochastic eval epoch (hard=True, batches in
        order, each under ``n_eval`` noise draws, majority-voted), and write
        per-row predictions to ``out_csv`` if given. Returns {"loss",
        "accuracy", "f1", "predictions", "labels", "scores"}. ``device``
        overrides the instance's.

        A token id past the checkpoint's word table raises ``ValueError``,
        checked on the host's arrays before any id reaches the device: the
        JAX package guards against XLA's silent clamping, and on the card an
        out-of-range gather is a device-side assert, which leaves the CUDA
        context unusable instead of raising.
        """
        data = D.truncate_tokens(self._load_split(split, multimodal_type, eeg_model,
                                                  eeg_model_coef, act_model, act_model_coef))
        fc = fusion.config_for(multimodal_type, dp_mode, cross_atn_type,
                               bert_coef=eeg_model_coef, dtype="float32")
        if bert_config is not None:
            fc = dataclasses.replace(fc, bert_config=bert_config)
        dev = self.device if device is None else resolve_device(device)
        params = load_torch_checkpoint(checkpoint, fc, dev)
        txt = [s for s, kind in zip((data.eeg_input, data.act_input), multimodal_type)
               if kind == "t"]
        for stream in txt:
            rows = params["bert"]["embeddings"]["word"].shape[0]
            if int(np.max(stream)) >= rows:
                raise ValueError(
                    f"token id {int(np.max(stream))} out of range for the checkpoint's "
                    f"{rows}-row embedding table: the checkpoint was trained on a "
                    "different (compact?) vocabulary than this data tree")
        tc = TrainConfig(batch_size=self.batch_size, compute_dtype=self.compute_dtype,
                         n_eval=n_eval)
        idx, w = D.epoch_indices(len(data), self.batch_size, False, device=dev)
        loss, _, preds, labels, scores, ws = StepFunctions(fc, tc, dev).eval_epoch(
            params, data.to_device(dev), idx, w, epsilon, generator(seed, dev))
        sel = ws.cpu().numpy() > 0
        preds_np, labels_np = preds.cpu().numpy()[sel], labels.cpu().numpy()[sel]
        out = {
            "loss": float(loss),
            "accuracy": float((preds_np == labels_np).mean()),
            "f1": float(M.f1_binary(preds_np, labels_np)),
            "predictions": preds_np,
            "labels": labels_np,
            "scores": scores.float().cpu().numpy()[sel],
        }
        if out_csv:
            os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
            with open(out_csv, "w") as f:
                f.write("index,prediction,label,score\n")
                for i, (p, l, s) in enumerate(zip(out["predictions"], out["labels"],
                                                  out["scores"])):
                    f.write(f"{i},{int(p)},{int(l)},{float(s):.6f}\n")
        return out
