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
from philox_ref import MASK32, philox_py

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
NEG = np.finfo(np.float32).min


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_attention_available_is_the_h100_gate():
    """Every S, D in HEAD_DIMS: the flagship's truncated S = 80 runs the
    kernels on the card, where the JAX gate (S >= 512) takes the einsum."""
    for S in (1, 21, 80, 100, 128, 256, 384, 512, 1024):
        for D in (32, 48, 64, 128, 192):
            assert TA.attention_available(S, D) == (D in TA.HEAD_DIMS), (S, D)
    assert TA.HEAD_DIMS == (64, 128)
    assert TA.attention_available(80, 64) and not JA.attention_available(80, 64)
    assert not TA.attention_available(0, 64)


def test_bert_apply_at_80_tokens_takes_the_fused_branch_and_matches_jax(monkeypatch):
    """BERT at the flagship's S = 80 goes through ``fused_attention`` (its
    plain twin on the CPU), never the unfused branch, and still matches the
    JAX package's einsum branch with dropout off (test_torch_layers.py's
    tolerance for two layers)."""
    cfg = dict(vocab_size=60, hidden_size=128, num_layers=2, num_heads=2,
               intermediate_size=64, max_position_embeddings=80)
    params = JB.init(jax.random.PRNGKey(1), JB.BertConfig(**cfg))
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 60, (2, 80)).astype(np.int32)
    mask = np.ones((2, 80), np.int32)
    mask[0, 65:] = 0
    j_seq, j_pooled = JB.apply(params, jnp.asarray(ids), jnp.asarray(mask), JB.BertConfig(**cfg))
    calls, fused_attention = [], TA.fused_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return fused_attention(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the unfused branch ran at S = 80")

    monkeypatch.setattr(TB.fused, "fused_attention", counted)
    monkeypatch.setattr(TB, "attention_unfused", refused)
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    seq, pooled = TB.apply(tparams, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                           TB.BertConfig(**cfg))
    assert calls == [(2, 2, 80, 64)] * 2
    np.testing.assert_allclose(seq.numpy(), np.asarray(j_seq), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(j_pooled), rtol=1e-4, atol=1e-5)


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


# ---------------------------------------------------------------------------
# The kernels' dropout mask, in its plain form (keep_mask_plain)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [21, 80])
def test_each_philox_call_serves_exactly_its_four_elements(S):
    """Element (i, j) reads word w of the call at (i0, j0); every (call, word)
    pair is used once, and a call's elements are rows {i0, i0 + 8} x columns
    {j0, j0 + 1} (inside S x S): the four one thread holds in a C fragment."""
    i0, j0, word = (x.numpy() for x in TA.mask_groups(S))
    i, j = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    assert ((i0 & 8) == 0).all() and (j0 % 2 == 0).all() and ((word >= 0) & (word < 4)).all()
    np.testing.assert_array_equal(i, i0 + 8 * (word >> 1))
    np.testing.assert_array_equal(j, j0 + (word & 1))
    pairs = set(zip((i0 * S + j0).ravel().tolist(), word.ravel().tolist()))
    assert len(pairs) == S * S


def test_keep_mask_plain_is_the_grouped_philox_of_each_element():
    B, H, S, seed, rate = 2, 2, 21, 2 ** 33 + 5, 0.1
    got = TA.keep_mask_plain(seed, B, H, S, rate).numpy()
    threshold = int((1.0 - rate) * (1 << 24))
    want = np.zeros((B, H, S, S), bool)
    for b in range(B):
        for h in range(H):
            for i in range(S):
                for j in range(S):
                    i0, j0 = (i & ~15) | (i & 7), j & ~1
                    counter = ((b * H + h) * S + i0) * S + j0
                    words = philox_py((counter & MASK32, counter >> 32, 0, 0),
                                      (seed & MASK32, seed >> 32))
                    want[b, h, i, j] = (words[2 * ((i >> 3) & 1) + (j & 1)] >> 8) < threshold
    np.testing.assert_array_equal(got, want)


def test_keep_mask_plain_statistics_and_seeds():
    B, H, S, rate = 2, 4, 256, 0.1
    keep = TA.keep_mask_plain(7, B, H, S, rate)
    n = keep.numel()  # 524288 draws: 7 sigma = 7 sqrt(p (1 - p) / n) = 2.9e-3
    assert abs(float(keep.float().mean()) - (1 - rate)) < 7 * np.sqrt(rate * (1 - rate) / n)
    assert torch.equal(keep, TA.keep_mask_plain(7, B, H, S, rate))
    assert not torch.equal(keep, TA.keep_mask_plain(8, B, H, S, rate))
    # the seed's high 32 bits are the key's second word
    assert not torch.equal(keep, TA.keep_mask_plain(7 + 2 ** 32, B, H, S, rate))
    assert bool(TA.keep_mask_plain(7, B, H, S, 0.0).all())


def test_kernels_refuse_views_their_16_byte_loads_cannot_read():
    B, S, H, D = 2, 16, 3, 64
    packed = torch.zeros(B, S, 3 * H * D)  # the BERT path's packed QKV
    q = packed[..., :H * D].reshape(B, S, H, D).transpose(1, 2)
    TA.check_vector_loads("q", q)  # row stride 3 H D floats: accepted
    TA.check_vector_loads("q", packed[..., H * D:2 * H * D].reshape(B, S, H, D).transpose(1, 2))
    buf = torch.zeros(B * H * S * D + 1)
    with pytest.raises(ValueError, match="16 bytes"):  # pointer off by 4 bytes
        TA.check_vector_loads("q", buf[1:].reshape(B, H, S, D))
    odd = torch.zeros(B, H, S, D + 1)[..., :D]  # row stride 65 floats
    with pytest.raises(ValueError, match="16 bytes"):
        TA.check_vector_loads("k", odd)
    with pytest.raises(ValueError, match="unit stride"):
        TA.check_vector_loads("v", q.transpose(2, 3))


def test_backward_realigns_an_output_gradient_the_16_byte_loads_cannot_read():
    B, H, S, D = 2, 3, 16, 64
    buf = torch.arange(B * H * S * D + 1, dtype=torch.float32)
    aligned = buf[:-1].reshape(B, H, S, D)
    assert TA.vector_loadable(aligned) is aligned  # no copy when none is needed
    shifted = buf[1:].reshape(B, H, S, D)  # unit strides, pointer off by 4 bytes
    expanded = torch.ones(()).expand(B, H, S, D)  # what sum().backward() hands on
    for dout in (shifted, expanded, aligned.transpose(2, 3)):
        got = TA.vector_loadable(dout)
        TA.check_vector_loads("dout", got)
        assert torch.equal(got, dout)
