"""The flagship fusion model, TICA_LapDropout, as plain functions on tensors.

Port of the JAX package's ``models/fusion.py`` for the ``ti`` double-stream
path (python/src/custom_models/models.py:28-82): EEG token ids through
BERT-base, the 512-d act embedding through a linear visual encoder, a 3-layer
cross-attention decoder over both, the (B, 2304) concat of pooled EEG, act
and decoder features, then the DP block and the fc1/fc2/classifier head.
The parameter tree has the JAX package's names and layouts.

``FusionConfig`` and ``config_for`` cover every reference class, as in the
JAX package; ``init`` and ``apply`` run the ``ti`` / double-stream /
``lapacian_dropout`` configuration and refuse the others.

Under the trainer's bf16 compute cast (a bf16 copy of the whole tree, ``DP``
included) the dtypes follow the JAX package's promotions: BERT runs in bf16;
the act stream is cast to ``config.dtype`` (f32), so the visual encoder and
the whole decoder run in f32 with bf16-rounded weights, over BERT's bf16
sequence as memory; the concat and the head are f32; on the composed path
``w = sigmoid(DP)`` is bf16 and eps_hat f32, and the fused path casts the
bf16 ``DP`` back to f32 (fusion.py:204, :281-284, :313 there).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import dp as dp_ops
from ..ops import dp_fused
from ..utils.device import resolve_device
from ..utils.seeding import generator as make_generator
from ..utils.trees import tree_map
from . import bert as bert_mod
from . import layers as L

D_MODEL = 768
N_HEADS = 12  # ref: models.py:44 nhead=12
N_CROSS_LAYERS = 3  # ref: models.py:45 num_layers=3
VISUAL_IN = 512  # ref: models.py:42 nn.Linear(512, 768)
N_CLASSES = 2


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Static architecture switches distinguishing the reference's classes."""

    name: str = "TICA_LapDropout"
    multimodal_type: str = "ti"  # "ti" | "tt" | "it" | "ii"
    cross_atn_type: str = "double_stream"  # or "single_stream" (TISC)
    dp_mode: str = "lapacian_dropout"
    with_cross_attention: bool = True  # False for TICA_DPSGD
    use_key_padding_masks: bool = True  # False for tt / ii (models.py:112-113)
    bert_coef: str = "bert-base-uncased"
    dtype: str = "float32"
    # BertConfig override (hidden_size must stay 768); small-model tests
    bert_config: Optional[bert_mod.BertConfig] = None
    # legacy pre-fix noise scale log((e^eps - w)/(1 - w)) (model.py:57)
    prefix_eps_hat: bool = False
    # Route the DP block through the fused kernels (ops/dp_fused.py): one
    # pass each way for minmax + eps_hat + in-kernel Laplace noise. Off by
    # default, as in the JAX package: its committed accuracy logs come from
    # the composed path's noise stream.
    fused_dp_kernel: bool = False

    def __post_init__(self):
        # the fused kernel hardcodes the post-fix 1/log(...) eps_hat
        if self.prefix_eps_hat and self.fused_dp_kernel:
            raise ValueError(
                "fused_dp_kernel only implements the post-fix eps_hat "
                "(1/log form); prefix_eps_hat=True requires the composed-op "
                "path (fused_dp_kernel=False)."
            )

    def bert_cfg(self):
        return self.bert_config or bert_mod.BertConfig.for_coef(self.bert_coef)

    @property
    def concat_width(self) -> int:
        return (2 if not self.with_cross_attention else 3) * D_MODEL


def config_for(multimodal_type: str, dp_mode: str, cross_atn_type: str = "double_stream",
               bert_coef: str = "bert-base-uncased", dtype: str = "float32") -> FusionConfig:
    """Mirror of the reference's model dispatch (base_train.py:127-150)."""
    masks = multimodal_type in ("ti", "it")
    name = {
        ("ti", "lapacian_dropout", "double_stream"): "TICA_LapDropout",
        ("tt", "lapacian_dropout", "double_stream"): "TTCA_LapDropout",
        ("it", "lapacian_dropout", "double_stream"): "ITCA_LapDropout",
        ("ii", "lapacian_dropout", "double_stream"): "IICA_LapDropout",
        ("ti", "lapacian_dropout", "single_stream"): "TISC_LapDropout",
        ("ti", "DPSGD", "double_stream"): "TICA_DPSGD",
        ("ti", "NDP", "double_stream"): "TICA_NonPrivate",
        ("ti", "lapacian_dropout_equal_weight", "double_stream"): "TISC_LapDropoutEquWeight",
    }.get((multimodal_type, dp_mode, cross_atn_type), "custom")
    return FusionConfig(
        name=name,
        multimodal_type=multimodal_type,
        cross_atn_type=cross_atn_type,
        dp_mode=dp_mode,
        with_cross_attention=(dp_mode != "DPSGD"),
        use_key_padding_masks=masks,
        bert_coef=bert_coef,
        dtype=dtype,
    )


def check_ported(config: FusionConfig):
    """Refuse the configurations this port does not run yet."""
    ported = (
        config.multimodal_type == "ti"
        and config.cross_atn_type == "double_stream"
        and config.with_cross_attention
        and config.use_key_padding_masks
        and config.dp_mode == "lapacian_dropout"
        and not config.prefix_eps_hat
        and config.dtype == "float32"
    )
    if not ported:
        raise NotImplementedError(
            f"{config.name}: the port runs the ti / double_stream / "
            "lapacian_dropout float32 model (TICA_LapDropout) only; the other "
            "classes and DPSGD wait (ROADMAP.md, queue 1, items 6 and 11)"
        )


def init(config: FusionConfig, seed: int, device=None, bert_params=None):
    """A fresh parameter tree on ``device`` (the card unless "cpu"), drawn
    from ``seed`` with the reference's init distributions. ``bert_params``
    (tensors or numpy arrays) injects pretrained BERT weights in place of
    the drawn ones (fusion.py:149-166 of the JAX package)."""
    check_ported(config)
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    width = config.concat_width
    if bert_params is None:
        bert = bert_mod.init(gen, config.bert_cfg(), dev)
    else:
        # a copy: the caller's tree survives the in-place updates
        bert = tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).clone(),
                        bert_params)
    return {
        "bert": bert,
        "visual_encoder": L.linear_init(gen, VISUAL_IN, D_MODEL, dev),
        "cross": L.decoder_init(gen, D_MODEL, N_CROSS_LAYERS, dev),
        "fc1": L.linear_init(gen, width, width, dev),
        "fc2": L.linear_init(gen, width, D_MODEL, dev),
        "classifier": L.linear_init(gen, D_MODEL, N_CLASSES, dev),
        # learnable per-feature logits, zeros init (models.py:53)
        "DP": torch.zeros((1, width), device=dev),
    }


def encode_features(params, batch, config: FusionConfig, gen, train: bool):
    """Everything upstream of the DP block: both streams, the decoder and
    the raw (B, F) f32 concat (models.py:56-69). Never reads ``DP``.
    Dropout draws from ``gen`` when ``train``: a generator, or a group of G
    generators for a batch of G stacked batches, each drawing for its own
    (``models/layers.py``)."""
    check_ported(config)
    drop = gen if train else None
    seq_a, feat_a = bert_mod.apply(
        params["bert"], batch["eeg_input"], batch["eeg_mask"], config.bert_cfg(),
        gen=drop,
    )
    act = batch["act_input"].to(getattr(torch, config.dtype))
    seq_b = L.linear(params["visual_encoder"], act)  # (B, 1, 768)
    feat_b = seq_b[:, 0, :]
    # decoder(tgt = act stream, memory = eeg stream), torch masks mask == 0
    cross = L.decoder(
        params["cross"], seq_b, seq_a, N_HEADS,
        tgt_key_padding_mask=batch["act_mask"] == 0,
        memory_key_padding_mask=batch["eeg_mask"] == 0,
        gen=drop,
    ).mean(dim=1)
    # the head after the concat stays f32 (fusion.py:281-284 there)
    return torch.cat([t.to(torch.float32) for t in (feat_a, feat_b, cross)], dim=1)


def apply_head(params, feature_raw, config: FusionConfig, epsilon: float,
               hard: bool, gen: Optional[torch.Generator], dp_noise=None):
    """min-max normalize -> DP block -> fc1/fc2 -> classifier (models.py:70-82).

    The DP noise is drawn from ``gen`` on every call, in eval too (the
    reference's eval is stochastic). With ``fused_dp_kernel`` the raw concat
    goes to the fused kernels with a seed drawn from ``gen``. ``dp_noise``
    hands in the Laplace(0, 1) draw instead (tests, CPU only on the fused
    path). ``hard`` selects the Gumbel mask's form, an exact identity in
    value and gradient, so it changes nothing here.
    """
    del hard
    if gen is None and dp_noise is None:
        raise ValueError("the DP block draws noise: pass a generator")
    dp = params["DP"]
    if config.fused_dp_kernel:
        seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device=feature_raw.device)
        feature = dp_fused.fused_lap_dropout(feature_raw, dp.float(), epsilon, seed,
                                             noise=dp_noise)
    else:
        if dp_noise is None:
            dp_noise = dp_fused.laplace_from_bits(
                dp_fused.random_bits(feature_raw.shape, gen, feature_raw.device))
        feature = dp_ops.lap_dropout_fast(
            dp_ops.minmax_normalize(feature_raw), dp, epsilon, dp_noise)
    h = torch.relu(L.linear(params["fc1"], feature))
    h = torch.tanh(L.linear(params["fc2"], h))
    return L.linear(params["classifier"], h)


def apply(params, batch, config: FusionConfig, epsilon: float, hard: bool,
          gen: Optional[torch.Generator], train: bool, dp_noise=None):
    """Forward pass -> logits (B, 2): encode_features then apply_head.
    ``gen`` seeds the dropout (``train`` only) and the DP noise (always)."""
    feature_raw = encode_features(params, batch, config, gen, train)
    return apply_head(params, feature_raw, config, epsilon, hard, gen, dp_noise)


def dp_param_predicate(path: str) -> bool:
    """Name predicate splitting DP params from model params
    (ref: base_train.py:168-169 ``'DP' in n``)."""
    return "DP" in path.split("/")
