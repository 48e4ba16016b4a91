"""The fusion model zoo as plain functions on tensors.

Port of the JAX package's ``models/fusion.py``: every class of the
reference (python/src/custom_models/models.py) as one configurable forward,

  TICA_LapDropout   :28   txt+img, cross-attention decoder, learned DP block
  TTCA_LapDropout   :84   txt+txt, one BERT run on both streams, no key masks
  ITCA_LapDropout   :130  img+txt
  IICA_LapDropout   :177  img+img, no BERT, no key masks
  TISC_LapDropout   :220  single stream: an encoder over [mean(eeg), act]
  TICA_DPSGD        :274  no cross block (F = 1536), trained under DP-SGD
  TICA_NonPrivate   :309  no DP block
  TISC_LapDropoutEquWeight :354  dropout + per-sample Laplace

plus the legacy heads ``feature_all_lap`` (PriConcat: per-sample Laplace on
the normalized concat) and PriGumbel (``legacy_pri_gumbel_*``). Stream a is
the EEG stream, stream b the act stream: a ``t`` stream goes through BERT
(sequence and pooled output), an ``i`` stream through the linear visual
encoder. The parameter tree has the JAX package's names and layouts.

Under the trainer's bf16 compute cast (a bf16 copy of the whole tree, ``DP``
included) the dtypes follow the JAX package's promotions: BERT runs in bf16;
an image stream is cast to ``config.dtype`` (f32), so the visual encoder
runs in f32 with bf16-rounded weights. The decoder computes in its query's
dtype: f32 for ``ti`` and ``it`` (an image query over a BERT memory), bf16
for ``tt`` (both streams BERT's), f32 for ``ii``. TISC's encoder input is
the bf16 mean of the EEG sequence beside the f32 act embedding, promoted to
f32. The concat and the head are f32; on the composed path ``w =
sigmoid(DP)`` is bf16 and eps_hat f32, and the fused path casts the bf16
``DP`` back to f32 (fusion.py:204, :249-284, :313 there).

Stacked members (the batched sweep, ``train/sweep.py``): :func:`init_members`
builds M members' trees stacked on a leading axis, and ``apply`` over such a
tree takes the batch repeated M times (:func:`repeat_batch`), a per-member
(M,) ``epsilon`` and a group of M generators: member m's rows go through
its own weights, DP row, epsilon and draws, one set of launches for all M
(``models/layers.py``, ``ops/dp.py``, ``ops/dp_fused.py``).

Under a (data, model) mesh (``parallel/``) ``apply`` takes a ``layout``
(``parallel/sharding.Layout``): the batch holds the rank's rows, BERT and the
cross block run on their Megatron shards, ``fc1`` is column- and ``fc2``
row-parallel, and every draw (dropout, the DP block's seed and noise) is the
rank's block of the meshless forward's; the fused DP kernels draw the rank's
rows as global rows (``r0``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import dp as dp_ops
from ..ops import dp_fused
from ..utils.device import resolve_device
from ..utils.seeding import derive_seed
from ..utils.seeding import generator as make_generator
from ..utils.trees import tree_cast, tree_items, tree_map
from . import bert as bert_mod
from . import layers as L

D_MODEL = 768
N_HEADS = 12  # ref: models.py:44 nhead=12
N_CROSS_LAYERS = 3  # ref: models.py:45 num_layers=3
VISUAL_IN = 512  # ref: models.py:42 nn.Linear(512, 768)
N_CLASSES = 2
DP_MODES = ("lapacian_dropout", "NDP", "DPSGD", "lapacian_dropout_equal_weight",
            "feature_all_lap", "pri_gumbel")


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Static architecture switches distinguishing the reference's classes."""

    name: str = "TICA_LapDropout"
    multimodal_type: str = "ti"  # "ti" | "tt" | "it" | "ii"
    cross_atn_type: str = "double_stream"  # or "single_stream" (TISC)
    dp_mode: str = "lapacian_dropout"  # one of DP_MODES
    with_cross_attention: bool = True  # False for TICA_DPSGD
    use_key_padding_masks: bool = True  # False for tt / ii (models.py:112-113)
    dropout_rate: float = 0.5  # equal-weight ablation (base_train.py:137)
    gumbel_tau: float = 0.1  # PriGumbel (train_val.py:95)
    bert_coef: str = "bert-base-uncased"
    dtype: str = "float32"  # the dtype init draws the params in
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
        if self.multimodal_type not in ("ti", "tt", "it", "ii"):
            raise ValueError(f"unknown multimodal_type {self.multimodal_type!r}")
        if self.dp_mode not in DP_MODES:
            raise ValueError(f"unknown dp_mode {self.dp_mode!r}, not one of {DP_MODES}")

    def bert_cfg(self):
        return self.bert_config or bert_mod.BertConfig.for_coef(self.bert_coef)

    @property
    def n_streams_txt(self) -> int:
        return self.multimodal_type.count("t")

    @property
    def uses_bert(self) -> bool:
        return self.multimodal_type != "ii"

    @property
    def uses_visual(self) -> bool:
        return self.multimodal_type != "tt"

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


def init(config: FusionConfig, seed: int, device=None, bert_params=None):
    """A fresh parameter tree on ``device`` (the card unless "cpu"), drawn
    from ``seed`` with the reference's init distributions, in
    ``config.dtype`` (fusion.py:149-184 of the JAX package): ``bert`` for a
    ``t`` stream, ``visual_encoder`` for an ``i`` stream, an encoder
    (single stream) or a decoder as ``cross`` unless the class has no cross
    block, the head, ``DP`` for ``lapacian_dropout`` and ``w`` for
    ``pri_gumbel``. ``bert_params`` (tensors or numpy arrays) injects
    pretrained BERT weights in place of the drawn ones."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    width = config.concat_width
    params = {}
    if config.uses_bert:
        if bert_params is None:
            params["bert"] = bert_mod.init(gen, config.bert_cfg(), dev)
        else:
            # a copy: the caller's tree survives the in-place updates
            params["bert"] = tree_map(
                lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).clone(),
                bert_params)
    if config.uses_visual:
        params["visual_encoder"] = L.linear_init(gen, VISUAL_IN, D_MODEL, dev)
    if config.with_cross_attention:
        stack = L.encoder_init if config.cross_atn_type == "single_stream" else L.decoder_init
        params["cross"] = stack(gen, D_MODEL, N_CROSS_LAYERS, dev)
    params["fc1"] = L.linear_init(gen, width, width, dev)
    params["fc2"] = L.linear_init(gen, width, D_MODEL, dev)
    params["classifier"] = L.linear_init(gen, D_MODEL, N_CLASSES, dev)
    if config.dp_mode == "lapacian_dropout":
        # learnable per-feature logits, zeros init (models.py:53)
        params["DP"] = torch.zeros((1, width), device=dev)
    if config.dp_mode == "pri_gumbel":
        # legacy: w = Parameter(rand(768)) applied after fc2 (train_val.py:136)
        params["w"] = torch.rand(D_MODEL, generator=gen, device=dev)
    dtype = getattr(torch, config.dtype)
    return params if dtype == torch.float32 else tree_cast(params, dtype)


def init_members(config: FusionConfig, seeds, device=None, bert_params=None):
    """M members' trees stacked on a leading axis, member m drawn by
    :func:`init` from ``seeds[m]`` (``bert_params`` injected into each).
    Each member is drawn and copied into its slot in turn, so the peak holds
    one member beside the stack."""
    stacked = None
    for m, seed in enumerate(seeds):
        one = init(config, seed, device, bert_params)
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((len(seeds), *t.shape)), one)
        for (_, dst), (_, src) in zip(tree_items(stacked), tree_items(one)):
            dst[m].copy_(src)
    return stacked


def repeat_batch(batch, members: int):
    """Every array of ``batch`` repeated ``members`` times along the rows,
    member after member: the input of ``apply`` over stacked members."""
    return {k: v.repeat(members, *(1,) * (v.dim() - 1)) for k, v in batch.items()}


def _encode_streams(params, batch, config: FusionConfig, gen, layout=None):
    """The two modality streams: (feat_a, seq_a, feat_b, seq_b), stream a
    the EEG stream, b the act stream (fusion.py:187-221 there). A ``t``
    stream is BERT's (pooled, sequence); ``tt`` runs the one BERT on both,
    each with its own mask and its own draws from ``gen`` (the EEG stream's
    first), so their gradients add. An ``i`` stream is the visual encoder
    over the (B, 1, 512) embedding, cast to ``config.dtype``."""
    dtype = getattr(torch, config.dtype)

    def stream(kind, x, mask):
        if kind == "t":
            seq, pooled = bert_mod.apply(params["bert"], x, mask, config.bert_cfg(), gen=gen,
                                         layout=layout)
            return pooled, seq
        emb = L.linear(params["visual_encoder"], x.to(dtype))  # (B, 1, 768)
        return emb[:, 0, :], emb

    feat_a, seq_a = stream(config.multimodal_type[0], batch["eeg_input"], batch["eeg_mask"])
    feat_b, seq_b = stream(config.multimodal_type[1], batch["act_input"], batch["act_mask"])
    return feat_a, seq_a, feat_b, seq_b


def encode_features(params, batch, config: FusionConfig, gen, train: bool, layout=None):
    """Everything upstream of the DP block: both streams, the cross block
    and the raw (B, F) f32 concat (models.py:56-69). Never reads ``DP``.
    Dropout draws from ``gen`` when ``train``: a generator, or a group of G
    generators for a batch of G stacked batches, each drawing for its own
    (``models/layers.py``)."""
    drop = gen if train else None
    feat_a, seq_a, feat_b, seq_b = _encode_streams(params, batch, config, drop, layout)
    parts = [feat_a, feat_b]
    if config.with_cross_attention:
        if config.cross_atn_type == "single_stream":
            # TISC (models.py:255-258): the encoder over [mean(seq_a), seq_b],
            # in their promoted dtype, as JAX's concat. The mean covers every
            # position of seq_a, padding included, as in the reference: it
            # moves with the token columns kept.
            mean = seq_a.mean(dim=1, keepdim=True)
            dt = torch.promote_types(mean.dtype, seq_b.dtype)
            src = torch.cat([mean.to(dt), seq_b.to(dt)], dim=1)
            cross = L.encoder(params["cross"], src, N_HEADS, gen=drop, layout=layout).mean(dim=1)
        else:
            # decoder(tgt, memory): ti/tt take the act stream as tgt, it/ii
            # the EEG stream (models.py:64-67, 157-160, 202-203); tt/ii pass
            # no masks (:112-113); torch masks mask == 0
            a_first = config.multimodal_type in ("ti", "tt")
            tgt, memory = (seq_b, seq_a) if a_first else (seq_a, seq_b)
            tgt_kpm = mem_kpm = None
            if config.use_key_padding_masks:
                eeg_kpm, act_kpm = batch["eeg_mask"] == 0, batch["act_mask"] == 0
                tgt_kpm, mem_kpm = (act_kpm, eeg_kpm) if a_first else (eeg_kpm, act_kpm)
            cross = L.decoder(params["cross"], tgt, memory, N_HEADS,
                              tgt_key_padding_mask=tgt_kpm, memory_key_padding_mask=mem_kpm,
                              gen=drop, layout=layout).mean(dim=1)
        parts.append(cross)
    # the head after the concat stays f32 (fusion.py:281-284 there)
    return torch.cat([t.to(torch.float32) for t in parts], dim=1)


def apply_head(params, feature_raw, config: FusionConfig, epsilon, hard: bool,
               gen, train: bool = False, dp_noise=None, return_features: bool = False,
               layout=None):
    """min-max normalize -> DP mechanism -> fc1/fc2 -> classifier
    (models.py:70-82; fusion.py:287-337 there).

    The mechanism by ``config.dp_mode``, its noise drawn from ``gen`` on
    every call, in eval too (the reference's eval is stochastic):
    ``lapacian_dropout`` the learned per-feature Laplace block (with
    ``fused_dp_kernel`` the raw concat goes to the fused kernels with a seed
    drawn from ``gen``; ``hard`` selects the Gumbel mask's form, an exact
    identity, so it changes nothing); ``lapacian_dropout_equal_weight``
    dropout (``train`` only: a forward in training passes True) and a
    per-sample Laplace draw;
    ``feature_all_lap`` one Laplace(0, 1/eps) draw per row, added to the
    feature already normalized; ``NDP`` and ``DPSGD`` draw nothing.
    ``dp_noise`` hands in the Laplace(0, 1) draw instead, (B, F) for the
    learned block, (B, 1) for the per-sample ones (tests; CPU only on the
    fused path). ``return_features`` returns the normalized concat (the
    feature-weight extraction, past_acc_feawei.py:103-124). Over stacked
    members ``epsilon`` is an (M,) float64 tensor and ``gen`` a group of M
    generators, one seed or noise draw each. A group of G generators over one
    model (the legacy trainer's eval repeats) gives each of G blocks of rows
    its own draws, the fused kernels the one ``DP`` row for each.
    """
    mode = config.dp_mode
    if return_features:
        return dp_ops.minmax_normalize(feature_raw)
    draws = mode in ("lapacian_dropout", "lapacian_dropout_equal_weight", "feature_all_lap")
    if draws and gen is None and dp_noise is None:
        raise ValueError(f"the {mode} block draws noise: pass a generator")
    if mode == "lapacian_dropout" and config.fused_dp_kernel:
        seed = L.draw_seeds(gen, feature_raw.device)
        dp = params["DP"].float()
        dp = dp.reshape(-1, dp.shape[-1])
        if dp.shape[0] < seed.shape[0]:  # G groups of draws over one model's DP row
            dp = dp.expand(seed.shape[0], -1).contiguous()
        feature = dp_fused.fused_lap_dropout(feature_raw, dp, epsilon, seed, noise=dp_noise,
                                             r0=0 if layout is None else layout.b0)
    else:
        feature = dp_ops.minmax_normalize(feature_raw)
        if mode == "lapacian_dropout":
            if dp_noise is None:
                dp_noise = dp_ops.laplace_noise(feature.shape, 1.0, gen, feature.device, layout)
            feature = dp_ops.lap_dropout_fast(feature, params["DP"], epsilon, dp_noise,
                                              prefix_eps_hat=config.prefix_eps_hat)
        elif mode == "lapacian_dropout_equal_weight":
            feature = dp_ops.equal_weight_dp(feature, epsilon, config.dropout_rate, train, gen,
                                             noise=dp_noise, layout=layout)
        elif mode == "feature_all_lap":
            # PriConcat (main_0425.py:111-121): the minmax is done above, so
            # not per_sample_laplace, which would normalize a second time
            if dp_noise is None:
                dp_noise = dp_ops.laplace_noise((feature.shape[0], 1), 1.0, gen, feature.device,
                                                layout)
            scale = dp_ops.member_scalar(epsilon, lambda e: 1.0 / e)
            feature = (dp_ops.by_member(feature, epsilon)
                       + dp_ops.by_member(dp_noise, epsilon) * scale).reshape(feature.shape)
    h = torch.relu(L.column_parallel(params["fc1"], feature, layout))
    h = torch.tanh(L.row_parallel(params["fc2"], h, layout))
    return L.linear(params["classifier"], h)


def apply(params, batch, config: FusionConfig, epsilon, hard: bool,
          gen, train: bool, dp_noise=None, return_features: bool = False, layout=None):
    """Forward pass -> logits (B, 2): encode_features then apply_head.
    ``gen`` seeds the dropout (``train`` only) and the DP noise (always);
    ``NDP`` and ``DPSGD`` out of training draw nothing and take None.
    ``layout``: the rank's rows and shards under a mesh (module docstring);
    the logits are then the rank's rows."""
    if config.dp_mode == "pri_gumbel":
        raise ValueError("use legacy_pri_gumbel_apply for the PriGumbel head")
    feature_raw = encode_features(params, batch, config, gen, train, layout)
    return apply_head(params, feature_raw, config, epsilon, hard, gen, train, dp_noise,
                      return_features, layout)


# ---------------------------------------------------------------------------
# The legacy PriGumbel head (root-script generation)
# ---------------------------------------------------------------------------

def legacy_pri_gumbel_init(config: FusionConfig, seed: int, device=None, bert_params=None):
    """The legacy PriGumbel ConcatModel (train_val.py:125-158): the NDP tree
    plus ``w`` ~ U(0, 1) of shape (768,), drawn from a generator of its own
    (fusion.py:371-377 there)."""
    params = init(dataclasses.replace(config, dp_mode="NDP"), seed, device, bert_params)
    gen = make_generator(derive_seed(seed, "w"), params["fc1"]["kernel"].device)
    params["w"] = torch.rand(D_MODEL, generator=gen, device=gen.device).to(
        params["fc1"]["kernel"].dtype)
    return params


def legacy_pri_gumbel_apply(params, batch, config: FusionConfig, epsilon: float,
                            tau: Optional[float] = None,
                            gen: Optional[torch.Generator] = None, train: bool = False,
                            gumbel=None, lap_noise=None):
    """Forward of the legacy PriGumbel head (train_val.py:144-158;
    fusion.py:380-399 there): the ``ti`` trunk with the decoder and its
    masks, fc1 (relu) and fc2 without tanh, ``gumbel_dropout(hard=not
    train)`` at temperature ``tau`` (``config.gumbel_tau`` unless given),
    ``per_sample_laplace``, the classifier. Draws the dropout (``train``
    only), then the (768, 2) Gumbel and the (B, 1) Laplace draws, from
    ``gen``; ``gumbel`` and ``lap_noise`` hand those two in."""
    tau = config.gumbel_tau if tau is None else tau
    drop = gen if train else None
    feat_a, seq_a, feat_b, seq_b = _encode_streams(params, batch, config, drop)
    cross = L.decoder(params["cross"], seq_b, seq_a, N_HEADS,
                      tgt_key_padding_mask=batch["act_mask"] == 0,
                      memory_key_padding_mask=batch["eeg_mask"] == 0, gen=drop).mean(dim=1)
    feature = torch.cat([t.to(torch.float32) for t in (feat_a, feat_b, cross)], dim=1)
    x = torch.relu(L.linear(params["fc1"], feature))  # train_val.py:153
    x = L.linear(params["fc2"], x)  # :154, no tanh in the legacy head
    x = dp_ops.gumbel_dropout(x, params["w"], tau=tau, hard=not train, gen=gen, gumbel=gumbel)
    x = dp_ops.per_sample_laplace(x, epsilon, gen, noise=lap_noise)  # Lap_noise, :156
    return L.linear(params["classifier"], x)


def dp_param_predicate(path: str) -> bool:
    """Name predicate splitting DP params from model params
    (ref: base_train.py:168-169 ``'DP' in n``)."""
    return "DP" in path.split("/")
