"""The port's fused attention (ops/attention.py) and its BERT dispatch against
the JAX package, on the CPU: the kernels' plain versions against the Pallas
kernel in interpret mode (p = 0) and against its reference path with the
same keep mask (p > 0).

Tolerances: the JAX attention tests' own (tests/test_attention_kernel.py),
rtol 1e-4 / atol 1e-5 for outputs and rtol 2e-3 / atol 1e-4 for gradients
(f32, sums in another order); BERT at S = 512, rtol 1e-3 / atol 1e-4 as the
JAX test of its fused branch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.ops import attention as JA
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.ops import attention as TA

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
NEG = np.finfo(np.float32).min


def make_inputs(B, H, S, D=64, seed=0):
    """q, k, v, a cotangent (B, H, S, D) and a (B, 1, S) bias with a partly
    masked row, as numpy."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    bias = np.zeros((B, 1, S), np.float32)
    bias[0, 0, S // 2 + 3:] = NEG
    return q, k, v, g, bias


def jax_vjp(q, k, v, g, bias, seed, rate):
    out, vjp = jax.vjp(
        lambda q, k, v: JA.fused_attention(q, k, v, jnp.asarray(bias),
                                           jnp.asarray([seed], jnp.int32), rate),
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def port_vjp(q, k, v, g, bias, seed, rate, keep=None):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = TA.fused_attention(*leaves, torch.from_numpy(bias),
                             torch.tensor([seed], dtype=torch.int64), rate, keep)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("S", [80, 128, 512])
def test_forward_and_gradients_match_the_pallas_kernel(S):
    q, k, v, g, bias = make_inputs(2, 2, S)
    launches = [kern.launches for kern in TA.KERNELS]
    j_out, j_grads = jax_vjp(q, k, v, g, bias, 0, 0.0)
    p_out, p_grads = port_vjp(q, k, v, g, bias, 0, 0.0)
    assert [kern.launches for kern in TA.KERNELS] == launches  # CPU: no kernel
    np.testing.assert_allclose(p_out, j_out, **FWD_TOL)
    for name, a, b in zip("qkv", p_grads, j_grads):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)


def test_dropout_matches_jax_given_its_keep_mask():
    """p = 0.1: the JAX CPU path (attention.py:157-169) draws its mask with
    jax.random.bernoulli; the port's plain path is handed that mask."""
    B, H, S, seed, rate = 2, 2, 128, 42, 0.1
    q, k, v, g, bias = make_inputs(B, H, S, seed=1)
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, (B, H, S, S)))
    j_out, j_grads = jax_vjp(q, k, v, g, bias, seed, rate)
    p_out, p_grads = port_vjp(q, k, v, g, bias, seed, rate, torch.from_numpy(keep))
    np.testing.assert_allclose(p_out, j_out, **FWD_TOL)
    for name, a, b in zip("qkv", p_grads, j_grads):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)
    assert np.abs(p_out - port_vjp(q, k, v, g, bias, seed, 0.0)[0]).max() > 1e-3  # dropped


def test_cpu_mask_statistics_and_seed_determinism():
    shape, rate = (2, 4, 256, 256), 0.1
    keep = TA.seeded_keep(7, shape, rate)
    assert abs(float(keep.float().mean()) - (1 - rate)) < 3e-3  # 524288 draws, 7 sigma
    assert torch.equal(keep, TA.seeded_keep(7, shape, rate))
    assert not torch.equal(keep, TA.seeded_keep(8, shape, rate))
    # the backward regenerates the forward's mask from the seed
    q, k, v, g, bias = make_inputs(1, 2, 64, seed=2)
    out, grads = port_vjp(q, k, v, g, bias, 7, rate)
    drawn = TA.seeded_keep(7, (1, 2, 64, 64), rate)
    tensors = [torch.from_numpy(x) for x in (q, k, v)]
    want = TA.attention_plain(*tensors, torch.from_numpy(bias), drawn, rate)
    np.testing.assert_array_equal(out, want.numpy())
    want_g = TA.attention_bwd_plain(*tensors, torch.from_numpy(bias), drawn, rate,
                                    torch.from_numpy(g))
    for a, b in zip(grads, want_g):
        np.testing.assert_array_equal(a, b.numpy())
    assert not np.array_equal(out, port_vjp(q, k, v, g, bias, 8, rate)[0])


def test_fully_masked_key_row_gives_the_uniform_softmax():
    q, k, v, g, bias = make_inputs(2, 2, 128, seed=3)
    bias[1] = NEG  # every key of batch row 1 masked
    p_out, p_grads = port_vjp(q, k, v, g, bias, 0, 0.0)
    np.testing.assert_allclose(p_out[1], np.broadcast_to(v[1].mean(1, keepdims=True),
                                                         v[1].shape), **FWD_TOL)
    j_out, j_grads = jax_vjp(q, k, v, g, bias, 0, 0.0)
    np.testing.assert_allclose(p_out, j_out, **FWD_TOL)
    for a, b in zip(p_grads, j_grads):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_attention_available_is_the_jax_gate():
    for S in (80, 100, 128, 256, 384, 512, 1024):
        for D in (32, 48, 64, 128):
            assert TA.attention_available(S, D) == JA.attention_available(S, D), (S, D)
    assert TA.attention_available(512, 64) and not TA.attention_available(80, 64)
    assert not TA.attention_available(512, 192)  # no kernel built for D = 192


def test_bert_apply_at_512_tokens_matches_jax_fused_branch():
    cfg = dict(vocab_size=60, hidden_size=128, num_layers=2, num_heads=2,
               intermediate_size=64, max_position_embeddings=512)
    params = JB.init(jax.random.PRNGKey(0), JB.BertConfig(**cfg))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 60, (2, 512)).astype(np.int32)
    mask = np.ones((2, 512), np.int32)
    mask[0, 65:] = 0
    before = JB.USE_FUSED_ATTENTION
    JB.USE_FUSED_ATTENTION = True
    try:
        j_seq, j_pooled = JB.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                   JB.BertConfig(**cfg))
    finally:
        JB.USE_FUSED_ATTENTION = before
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    assert TA.attention_available(512, 64)  # the port takes its fused branch too
    seq, pooled = TB.apply(tparams, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                           TB.BertConfig(**cfg))
    np.testing.assert_allclose(seq.numpy(), np.asarray(j_seq), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(j_pooled), rtol=1e-3, atol=1e-4)
