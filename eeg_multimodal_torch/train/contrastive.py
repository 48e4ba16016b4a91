"""Self-supervised pretraining of the CLIP visual tower by rendering inversion.

Port of the JAX package's ``train/contrastive.py``. The reference's image
features come from pretrained OpenAI CLIP (ref get_embedding.py:62-71),
whose weights are not available offline. Each 224x224 image is a
deterministic rendering of its ~25-30 sensor values (get_embedding.py:18-48),
so regressing the standardized source row from the tower's embedding is a
dense pretext that makes the embedding carry what the classifier needs. A
CLIP-style symmetric InfoNCE over same-moment EEG/act pairs (one shared
tower, a learned temperature; Radford et al. 2021) rides along as a small
auxiliary.

The rows stay on the device; each step renders its batch's images there
(``data/image_transform.py``), so no image tensor is built on the host, and
the tower's self-attention runs the attention kernels forward and backward
(``models/vit.py``). A chunk of ``log_every`` steps makes one host sync, for
the loss of its last step. Batch indices are drawn on the device from the
run's generator, or handed in (tests).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data import image_transform
from ..models import vit as vit_mod
from ..ops.optim import AdamW, warmup_cosine_decay_schedule
from ..utils.device import resolve_device
from ..utils.seeding import derive_seed, generator
from ..utils.trees import tree_cast, tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    """The JAX package's ``ContrastiveConfig`` (contrastive.py:42-65 there),
    every field with its name and default."""

    batch_size: int = 128
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1500
    weight_decay: float = 0.1
    # CLIP's init temperature 0.07, as a learned log scale
    init_logit_scale: float = float(np.log(1.0 / 0.07))
    max_logit_scale: float = float(np.log(100.0))
    seed: int = 980616
    log_every: int = 25
    compute_dtype: str = "bfloat16"
    # different samples' renderings look alike (off-diagonal cosine 0.8624
    # against 0.8625 on the diagonal at init), so InfoNCE alone has no
    # negatives to learn from; the inversion carries the training
    inversion_weight: float = 1.0
    infonce_weight: float = 0.1


def clip_loss(z_a, z_b, logit_scale):
    """Symmetric InfoNCE over the in-batch similarity matrix."""
    z_a = z_a / torch.linalg.norm(z_a, dim=-1, keepdim=True)
    z_b = z_b / torch.linalg.norm(z_b, dim=-1, keepdim=True)
    logits = z_a @ z_b.t() * torch.exp(logit_scale)  # (B, B)
    labels = torch.arange(z_a.shape[0], device=z_a.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))


def standardize(x):
    """Per-column (x - mean) / max(std, 1e-6), the population std (ddof 0,
    as ``jnp.std``)."""
    sd = torch.clamp(x.std(dim=0, keepdim=True, correction=0), min=1e-6)
    return (x - x.mean(dim=0, keepdim=True)) / sd


class ContrastivePretrainer:
    """One shared ViT tower over both modalities' rendered images, with a
    rendering-inversion head per modality; on the card unless
    ``device="cpu"``."""

    def __init__(self, vit_cfg: vit_mod.ViTConfig = vit_mod.ViTConfig(),
                 cfg: ContrastiveConfig = ContrastiveConfig(), eeg_dim: int = 30,
                 act_dim: int = 25, device=None):
        self.vit_cfg = vit_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        # drawn on the CPU, then moved: the same init on the card and the CPU
        gen = generator(derive_seed(cfg.seed, "init"))
        D = vit_cfg.output_dim

        def head(n):
            return {"kernel": D ** -0.5 * torch.randn(D, n, generator=gen),
                    "bias": torch.zeros(n)}

        self.params = {
            "vit": vit_mod.init(gen, vit_cfg, self.device),
            "logit_scale": torch.tensor(cfg.init_logit_scale, device=self.device),
            **tree_map(lambda t: t.to(self.device),
                       {"head_eeg": head(eeg_dim), "head_act": head(act_dim)}),
        }
        schedule = warmup_cosine_decay_schedule(0.0, cfg.learning_rate, cfg.warmup_steps,
                                                cfg.total_steps)
        # decay the matrices only (contrastive.py:261-263 there)
        self.opt = AdamW(schedule, cfg.weight_decay, decay_mask=lambda p: p.dim() >= 2)
        self.opt_state = self.opt.init(self._leaves())

    def _leaves(self):
        return [t for _, t in tree_items(self.params)]

    def _loss_fn(self, params, eeg_rows, act_rows, eeg_targets, act_targets):
        """The loss of a batch: ``*_rows`` render the images, ``*_targets``
        are the standardized rows the inversion heads must recover."""
        cfg = self.cfg
        compute = getattr(torch, cfg.compute_dtype)
        vit_p = params["vit"] if compute == torch.float32 else tree_cast(params["vit"], compute)
        eeg_imgs = image_transform.eeg_to_images(eeg_rows)
        act_imgs = image_transform.act_to_images(act_rows)
        z_e = vit_mod.encode_image(vit_p, eeg_imgs.to(compute), self.vit_cfg).float()
        z_a = vit_mod.encode_image(vit_p, act_imgs.to(compute), self.vit_cfg).float()
        pred_e = z_e @ params["head_eeg"]["kernel"] + params["head_eeg"]["bias"]
        pred_a = z_a @ params["head_act"]["kernel"] + params["head_act"]["bias"]
        invert = ((pred_e - eeg_targets) ** 2).mean() + ((pred_a - act_targets) ** 2).mean()
        # the cap made on the device (a tensor from a Python number would be
        # a host copy and a sync each step)
        cap = torch.full_like(params["logit_scale"], cfg.max_logit_scale)
        scale = torch.minimum(params["logit_scale"], cap)
        nce = clip_loss(z_e, z_a, scale)
        return cfg.inversion_weight * invert + cfg.infonce_weight * nce

    def step(self, rows, idx):
        """One AdamW step on the batch ``idx`` of ``rows`` (the device dict
        of :meth:`fit`); updates the params in place and returns the loss as
        a device scalar."""
        leaves = self._leaves()
        aliases = [t.detach().requires_grad_() for t in leaves]
        it = iter(aliases)
        params = tree_map(lambda _: next(it), self.params)
        loss = self._loss_fn(params, rows["eeg"][idx], rows["act"][idx], rows["eeg_t"][idx],
                             rows["act_t"][idx])
        grads = torch.autograd.grad(loss, aliases)
        self.opt_state = self.opt.update(leaves, list(grads), self.opt_state)
        return loss.detach()

    def fit(self, eeg_rows: np.ndarray, act_rows: np.ndarray, echo: bool = True, idx=None):
        """``total_steps`` steps over the raw processed-CSV rows, eeg_rows
        (N, C_eeg) and act_rows (N, 25), on the device. Returns (the tower's
        params, history), an entry per chunk of ``log_every`` steps with its
        last step's loss. ``idx`` (tests): each step's batch indices."""
        cfg, dev = self.cfg, self.device
        rows = {"eeg": torch.as_tensor(eeg_rows, dtype=torch.float32, device=dev),
                "act": torch.as_tensor(act_rows, dtype=torch.float32, device=dev)}
        rows["eeg_t"], rows["act_t"] = standardize(rows["eeg"]), standardize(rows["act"])
        n = rows["eeg"].shape[0]
        gen = generator(derive_seed(cfg.seed, "fit"), dev)
        history, done, t0 = [], 0, time.time()
        while done < cfg.total_steps:
            m = min(cfg.log_every, cfg.total_steps - done)
            for s in range(done, done + m):
                b = idx[s] if idx is not None else torch.randint(
                    0, n, (cfg.batch_size,), generator=gen, device=dev)
                loss = self.step(rows, b)
            done += m
            history.append({"step": done, "loss": float(loss)})
            if echo:
                print(f"[clip] step {done}/{cfg.total_steps} loss {history[-1]['loss']:.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        return self.params["vit"], history
