"""GetEmbedding: processed CSVs -> the embedding tree every trainer reads.

Port of the JAX package's ``data/embedding.py`` (ref: get_embedding.py:50-144).
It writes the same tree with the same pickle contents,

  data/embedding/<modal>/img/<model>_<coef_std>/{train,test}.pickle
      an (N, 512) float32 numpy array
  data/embedding/<modal>/txt/<model>_<coef_std>/{train,test}.pickle
      a list of {"input_ids", "attention_mask"} int32 (512,) numpy arrays

numpy only, no torch objects, so each package's loaders read the other's
tree. The image path runs on the device: a split's rows go to the card in
one copy, each chunk of ``ENCODE_BATCH`` rows becomes images there
(``data/image_transform.py``) and goes through CLIP's visual tower
(``models/vit.py``, whose attention is the attention kernel) or ResNet-34
(``models/resnet.py``) under ``torch.inference_mode()``, and the split's
features come back in one copy. The last chunk is not padded: the JAX
package pads it to keep jit's shapes static, and rows are independent, so
its N mod 16 rows go through as they are. The text path is host work: each
row serialized and WordPiece-tokenized (``data/tokenizer.py``), by the C++
engine (``native/``) where it built, else by the Python engine, which gives
the same ids.

Weights load from local files when given (nothing is downloaded); else the
encoders start from a fixed random init, drawn on the CPU from seed 0 and
moved to the device, so the same tree comes out on the card and the CPU.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..models import resnet as resnet_mod
from ..models import vit as vit_mod
from ..utils.device import resolve_device
from . import image_transform
from .datasets import load_feature_csv
from .tokenizer import MAX_LEN, WordPiece, default_tokenizer_for_coef, serialize_row

ENCODE_BATCH = 16  # ref: get_embedding.py:66
INIT_SEED = 0  # the JAX package's PRNGKey(0)


def standardize_coef(coef: str) -> str:
    """'ViT-B/32' -> 'ViT_B_32', the tree's directory names (base_train.py:74-75;
    ``train/api.py`` reads the tree through it)."""
    return coef.replace("/", "_").replace("-", "_")


class GetEmbedding:
    """ref signature: GetEmbedding(modal_list, data_train_test_list)
    .run(img_process_coef_model_list, txt_process_coef_model_list).
    Runs on the card unless ``device="cpu"``."""

    def __init__(
        self,
        modal_list: Sequence[str],
        data_train_test_list: Sequence[str],
        data_root: str = ".",
        tokenizer: Optional[WordPiece] = None,
        clip_weights: Optional[str] = None,  # a pickled CLIP state dict, or a vit tree
        resnet_weights: Optional[str] = None,  # a pickled torchvision resnet34 state dict
        vocab_txts: Optional[Dict[str, str]] = None,  # coef -> HF vocab.txt
        device=None,
    ):
        self.modal_list = list(modal_list)
        self.data_train_test_list = list(data_train_test_list)
        self.data_root = data_root
        self.tokenizer = tokenizer  # an override for every coef
        self.vocab_txts = dict(vocab_txts or {})
        self.clip_weights = clip_weights
        self.resnet_weights = resnet_weights
        self.device = resolve_device(device)
        self._encoders: Dict[Tuple[str, str], object] = {}
        self._tokenizers: Dict[str, WordPiece] = {}
        self._native_toks: Dict[int, native.NativeWordPiece] = {}

    def tokenizer_for_coef(self, coef: str) -> WordPiece:
        """Per-coef tokenizer: the override > a user vocab.txt > the packaged
        recovered uncased vocab > the synthetic numeric vocab (the cased
        default; exact cased ids need a user-supplied vocab.txt)."""
        if self.tokenizer is not None:
            return self.tokenizer
        if coef not in self._tokenizers:
            if coef in self.vocab_txts:
                self._tokenizers[coef] = WordPiece.from_vocab_txt(self.vocab_txts[coef])
            else:
                self._tokenizers[coef] = default_tokenizer_for_coef(coef)
        return self._tokenizers[coef]

    # -- encoders ------------------------------------------------------------
    def _get_image_encoder(self, process_model: str, coef_model: str):
        """``fn(images) -> (B, 512)`` on the device, built once per
        (model, coef)."""
        key = (process_model, coef_model)
        if key in self._encoders:
            return self._encoders[key]
        gen = torch.Generator().manual_seed(INIT_SEED)
        if process_model == "clip":
            cfg = vit_mod.ViTConfig.for_coef(coef_model)
            if self.clip_weights and os.path.exists(self.clip_weights):
                with open(self.clip_weights, "rb") as f:
                    sd = pickle.load(f)
                if isinstance(sd, dict) and "conv" in sd:
                    # the JAX package's own tree (e.g. the contrastive-pretrained tower)
                    params = vit_mod.params_from_jax(sd, cfg, self.device)
                else:
                    params, cfg = vit_mod.from_clip_state_dict(sd, cfg, self.device)
            else:
                params = vit_mod.init(gen, cfg, self.device)

            def fn(images):
                return vit_mod.encode_image(params, images, cfg)
        elif process_model == "resnet":
            if self.resnet_weights and os.path.exists(self.resnet_weights):
                with open(self.resnet_weights, "rb") as f:
                    params = resnet_mod.from_torchvision_state_dict(pickle.load(f), self.device)
            else:
                params = resnet_mod.init(gen, self.device)

            def fn(images):
                return resnet_mod.features(params, images)
        else:
            raise ValueError(process_model)
        self._encoders[key] = fn
        return fn

    # -- img path ------------------------------------------------------------
    def img_encode(self, data_path: str, modal_type: str, process_model: str,
                   coef_model: str) -> np.ndarray:
        """(N, 512) float32 features of a processed CSV's rows."""
        to_img = (image_transform.act_to_images if modal_type == "act"
                  else image_transform.eeg_to_images)
        encoder = self._get_image_encoder(process_model, coef_model)
        rows = torch.from_numpy(load_feature_csv(data_path)).to(self.device)
        with torch.inference_mode():
            feats = torch.cat([encoder(to_img(rows[i:i + ENCODE_BATCH]))
                               for i in range(0, len(rows), ENCODE_BATCH)])
        return feats.cpu().numpy()

    def _save(self, modal: str, kind: str, process_model: str, coef_model: str, split: str,
              obj):
        save_dir = os.path.join(self.data_root, "data", "embedding", modal, kind,
                                f"{process_model}_{standardize_coef(coef_model)}")
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, f"{split}.pickle"), "wb") as f:
            pickle.dump(obj, f)

    def _csv(self, split: str, modal: str) -> str:
        return os.path.join(self.data_root, "data", "processed", f"{split}_{modal}.csv")

    def get_img_encode(self, img_process_coef_model_list):
        for modal in self.modal_list:
            for split in self.data_train_test_list:
                for process_model, coef_model in img_process_coef_model_list:
                    arr = self.img_encode(self._csv(split, modal), modal, process_model,
                                          coef_model)
                    self._save(modal, "img", process_model, coef_model, split, arr)

    # -- txt path ------------------------------------------------------------
    def text_encode(self, data_path: str, coef_model: str = "bert-base-uncased"):
        """Row -> space-joined int string -> WordPiece (ref :113-116), as the
        list of {"input_ids", "attention_mask"} the loaders read."""
        rows = load_feature_csv(data_path)
        texts = [serialize_row(int(v) for v in row) for row in rows]
        tok = self.tokenizer_for_coef(coef_model)
        if native.available():
            nt = self._native_toks.get(id(tok))
            if nt is None:
                nt = self._native_toks[id(tok)] = native.NativeWordPiece.from_wordpiece(tok)
            ids, mask = nt.encode_batch(texts, MAX_LEN)
        else:
            ids, mask = tok.encode_batch(texts, MAX_LEN)
        return [{"input_ids": ids[i], "attention_mask": mask[i]} for i in range(len(texts))]

    def get_text_encode(self, txt_process_coef_model_list):
        for modal in self.modal_list:
            for split in self.data_train_test_list:
                for process_model, coef_model in txt_process_coef_model_list:
                    emb = self.text_encode(self._csv(split, modal), coef_model)
                    self._save(modal, "txt", process_model, coef_model, split, emb)

    def run(self, img_process_coef_model_list, txt_process_coef_model_list):
        self.get_img_encode(img_process_coef_model_list)
        self.get_text_encode(txt_process_coef_model_list)
