"""The plain reference: TICA_LapDropout's forward, loss, alternating step
and eval, in plain PyTorch.

It follows the published description and the reference code
(Rachfu/EEG-multimodal ``models.py:28-82``, ``base_train.py:167-255``), not
the program: the configuration's text encoder over the EEG tokens (its part
in ``encoders/<model_type>.py``; BERT-base, ``encoders/bert.py``, for
TICA_LapDropout); a linear act encoder; ``nn.TransformerDecoder`` (3 post-LN
layers, ReLU FFN of 2048, key-padding masks at -inf) with the act stream as
target and the EEG sequence as memory; the concat of the pooled EEG feature,
the act feature and the decoder's mean; row min-max; the learned Laplace
block ``norm + Laplace(0, 1) / log((e^eps - w) / (1 - w))``,
``w = sigmoid(DP)`` (the Gumbel mask of the reference's block is an exact
identity and is left out); fc1 (ReLU), fc2 (tanh), the classifier; cross-entropy
weighted over the batch's real rows. The step: phase 1 the gradient w.r.t.
``DP`` alone (hard=False) and Adam on it, phase 2 the gradient w.r.t. every
other parameter (hard=True) and Adam; the eval: dropout off, the DP noise
on, argmax votes and binary F1.

Every product goes through :class:`Precision`: float32 with TF32 off (the
reference's own numerics), or one step lower for the control (TF32, or
float8 e4m3 operands scaled per tensor, in the forward and the backward).
Draws come from :mod:`.draws`. Imports torch and this folder only.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from . import encoders
from .weights import leaves


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to float8 e4m3 after scaling each
    tensor's largest magnitude to 448; the backward's products likewise."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(fp8(a), fp8(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = fp8(g)
        da = torch.matmul(g8, fp8(b).transpose(-1, -2))
        db = torch.matmul(fp8(a).transpose(-1, -2), g8)
        # a broadcast operand's gradient sums over the broadcast axes
        while db.dim() > b.dim():
            db = db.sum(0)
        return da, db


def fp8(x):
    """``x`` rounded to float8 e4m3 at a per-tensor scale, back in f32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """The products' precision: "float32" (TF32 off), "tf32" or "fp8"."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def matmul(self, a, b):
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(a, b)

    @contextlib.contextmanager
    def scope(self):
        """TF32 on for the "tf32" control, off otherwise; restored after."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def linear(p, x, prec):
    return prec.matmul(x, p["kernel"]) + p["bias"]


def layer_norm(p, x, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def mha(p, query, kv, heads, kpm, draws, prec):
    """``nn.MultiheadAttention`` (batch first, key padding mask True where a
    key is ignored)."""
    B, Sq, E = query.shape
    Sk, D = kv.shape[1], E // heads
    w, b = p["in_proj_kernel"], p["in_proj_bias"]

    def proj(x, i):
        return prec.matmul(x, w[:, i * E:(i + 1) * E]) + b[i * E:(i + 1) * E]

    q, k, v = (t.reshape(B, -1, heads, D).transpose(1, 2)
               for t in (proj(query, 0), proj(kv, 1), proj(kv, 2)))
    scores = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    scores = scores.masked_fill(kpm[:, None, None, :], float("-inf"))
    attn = draws.dropout(torch.softmax(scores, -1))
    out = prec.matmul(attn, v).transpose(1, 2).reshape(B, Sq, E)
    return linear(p["out_proj"], out, prec)


def decoder(p, tgt, memory, heads, tgt_kpm, mem_kpm, draws, prec):
    """``nn.TransformerDecoder`` of post-LN ``TransformerDecoderLayer``s."""
    x = tgt
    for layer in p["layers"]:
        x = layer_norm(layer["norm1"], x + draws.dropout(
            mha(layer["self_attn"], x, x, heads, tgt_kpm, draws, prec)), 1e-5)
        x = layer_norm(layer["norm2"], x + draws.dropout(
            mha(layer["cross_attn"], x, memory, heads, mem_kpm, draws, prec)), 1e-5)
        h = draws.dropout(torch.relu(linear(layer["linear1"], x, prec)))
        x = layer_norm(layer["norm3"], x + draws.dropout(linear(layer["linear2"], h, prec)),
                       1e-5)
    return x


def forward(p, batch, cfg, epsilon: float, draws, prec):
    """The logits (B, 2) of ``batch`` (``input_ids``, ``attention_mask``,
    ``act`` (B, 512))."""
    fz = cfg["fusion"]
    enc = encoders.of(cfg)
    seq, pooled = enc.forward(p[enc.KEY], batch["input_ids"], batch["attention_mask"], cfg,
                              draws, prec)
    act = linear(p["visual_encoder"], batch["act"][:, None, :], prec)  # (B, 1, width)
    act_kpm = torch.zeros(act.shape[:2], dtype=torch.bool, device=act.device)
    cross = decoder(p["cross"], act, seq, fz["cross_heads"], act_kpm,
                    batch["attention_mask"] == 0, draws, prec).mean(1)
    feature = torch.cat([pooled, act[:, 0], cross], dim=1)
    lo, hi = feature.amin(-1, keepdim=True), feature.amax(-1, keepdim=True)
    norm = (feature - lo) / (hi - lo)
    w = torch.sigmoid(p["DP"])
    eps_hat = 1.0 / torch.log((math.exp(epsilon) - w) / (1.0 - w))
    feature = norm + draws.dp_noise(norm.shape) * eps_hat
    h = torch.relu(linear(p["fc1"], feature, prec))
    h = torch.tanh(linear(p["fc2"], h, prec))
    return linear(p["classifier"], h, prec)


def weighted_ce(logits, labels, weight):
    """The batch's weighted mean cross-entropy (``cal_loss``)."""
    ce = -torch.log_softmax(logits, -1).gather(-1, labels[:, None])[:, 0]
    return (ce * weight).sum() / weight.sum().clamp_min(1.0)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) on a list of f32 tensors in place,
    the bias corrections in double."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(t) for t in params]
        self.nu = [torch.zeros_like(t) for t in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / c1 * m / ((v / c2).sqrt() + self.eps))


def _split(tree, keep):
    """(tree with the leaves ``keep`` selects swapped for fresh leaves that
    require grad, those leaves, the originals) in leaf order."""
    tracked, orig = [], []

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        if keep(path):
            orig.append(t)
            tracked.append(t.detach().requires_grad_())
            return tracked[-1]
        return t.detach()

    return walk(tree, ""), tracked, orig


def is_dp(path: str) -> bool:
    return path == "DP"


class Stepper:
    """The alternating step of one model over its own params and Adam
    states; ``step`` returns (phase 2's loss, the gradients Adam got, by
    path, ``DP``'s included)."""

    def __init__(self, params, cfg, prec):
        self.params, self.cfg, self.prec = params, cfg, prec
        lr = cfg["train"]["learning_rate"]
        model = [(p, t) for p, t in leaves(params) if not is_dp(p)]
        self.paths_model = [p for p, _ in model]
        self.dp_opt = Adam([params["DP"]], lr)
        self.model_opt = Adam([t for _, t in model], lr)

    def step(self, batch, weight, epsilon, draws):
        p1, (dp,), (dp_master,) = _split(self.params, is_dp)
        with self.prec.scope():
            loss1 = weighted_ce(forward(p1, batch, self.cfg, epsilon, draws, self.prec),
                                batch["labels"], weight)
            (g_dp,) = torch.autograd.grad(loss1, [dp])
        self.dp_opt.step([dp_master], [g_dp])
        p2, tracked, masters = _split(self.params, lambda path: not is_dp(path))
        with self.prec.scope():
            loss2 = weighted_ce(forward(p2, batch, self.cfg, epsilon, draws, self.prec),
                                batch["labels"], weight)
            grads = torch.autograd.grad(loss2, tracked)
        self.model_opt.step(masters, grads)
        return loss2.detach(), {"DP": g_dp, **dict(zip(self.paths_model, grads))}


@torch.no_grad()
def eval_logits(params, batch, cfg, epsilon, draws, prec, block: int = 128):
    """The eval forward's logits over ``batch``'s rows, ``block`` rows at a
    time; the DP noise of all rows drawn first, as one draw, as the
    program's one batched eval forward draws it."""
    n = batch["labels"].shape[0]
    noise = draws.dp_noise((n, cfg["fusion"]["feature_width"]))

    class Given:  # the block's rows of the one draw
        def __init__(self, rows):
            self.rows = rows

        def dropout(self, x, p=None):
            return x

        def attention_keep(self, *shape):
            return None

        def dp_noise(self, shape):
            return noise[self.rows]

    out = []
    with prec.scope():
        for r0 in range(0, n, block):
            rows = slice(r0, min(n, r0 + block))
            sub = {k: v[rows] for k, v in batch.items()}
            out.append(forward(params, sub, cfg, epsilon, Given(rows), prec))
    return torch.cat(out)


def f1_binary(labels, votes, weight):
    """Binary F1 over the rows of weight > 0, in f32."""
    valid = weight > 0
    t1, p1 = (labels == 1) & valid, (votes == 1) & valid
    tp = (t1 & p1).sum().float()
    fp = (~t1 & p1).sum().float()
    fn = (t1 & ~p1).sum().float()
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / denom.clamp_min(1.0), torch.zeros_like(denom))
