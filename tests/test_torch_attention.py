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
from eeg_multimodal_torch.ops.philox import philox_words
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


def wgmma_accumulator(N):
    """The m64nN f32 accumulator of a warpgroup (PTX ISA, wgmma D fragment):
    (warp, lane, register) -> (row, column) as int arrays of shape (4, 32,
    N / 2). Warp w, lane t: rows 16 w + t / 4 and + 8, and in each 8-column
    group n columns 8 n + 2 (t mod 4) and + 1; register 4 n + e holds row
    + 8 (e >> 1), column + (e & 1)."""
    w = np.arange(4)[:, None, None]
    t = np.arange(32)[None, :, None]
    x = np.arange(N // 2)[None, None, :]
    n, e = x // 4, x % 4
    return 16 * w + t // 4 + 8 * (e >> 1), 8 * n + 2 * (t % 4) + (e & 1)


@pytest.mark.parametrize("N", [32, 64, 128])
def test_each_wgmma_accumulator_group_is_one_philox_call(N):
    """In every tile of a query-major score matrix (rows from a multiple of
    64, columns from a multiple of N, S = 197 for ragged edges), a thread's
    four registers of an 8-column group are one Philox call of
    ``mask_groups``, register e its word e: the forward and dQ kernels call
    keep_bits once per group and read bit e for register e."""
    S = 197
    i0, j0, word = (x.numpy() for x in TA.mask_groups(S))
    rows, cols = wgmma_accumulator(N)
    seen = set()
    for r0 in range(0, S, 64):
        for c0 in range(0, S, N):
            i, j = r0 + rows, c0 + cols
            inside = (i < S) & (j < S)
            ii, jj = np.minimum(i, S - 1), np.minimum(j, S - 1)
            call = i0[ii, jj] * S + j0[ii, jj]
            for n in range(N // 8):
                group = call[:, :, 4 * n:4 * n + 4]
                whole = inside[:, :, 4 * n:4 * n + 4].all(-1)
                # one call per thread and group, its words in register order
                assert (group[whole] == group[whole][:, :1]).all()
                np.testing.assert_array_equal(word[ii, jj][:, :, 4 * n:4 * n + 4][whole],
                                              np.broadcast_to(np.arange(4), (whole.sum(), 4)))
            seen.update(zip(call[inside].tolist(), word[ii, jj][inside].tolist()))
    assert len(seen) == S * S  # every element drawn, each (call, word) once


def mask_byte(bh, i0, j0, S):
    """``mask_byte`` of csrc/attention_bf16.cu: where the byte of the Philox
    groups of rows i0, i0 + 1 (i0 even, bit 3 clear) and columns {j0, j0 +
    1} lies in the backward's mask bytes."""
    tiles, jt = -(-S // 64), j0 & 63
    pair_row = bh * tiles * 16 + (i0 >> 4) * 4 + ((i0 & 7) >> 1)
    return (pair_row * tiles + (j0 >> 6)) * 32 + ((jt >> 1) & 3) * 8 + (jt >> 3)


def dkdv_mask_model(seed, B, H, S, rate):
    """The mask as the dK/dV kernel reads it, modelled thread by thread.
    The dQ kernel's threads (a block of 64 rows; warp w, lane t: rows i0 =
    16 w + t / 4 and + 8; in each 64-key tile, columns 8 n + 2 (t mod 4) and
    + 1) draw one Philox call per 8-column group, keep bit e for word e, and
    the thread of even t / 4 stores its nibbles ORed with those of lane
    t ^ 4 (row i0 + 1) shifted by 4 as one 8-byte word at the byte of
    column n = 0. A dK/dV thread (warp w, lane t: keys j = 16 w + t / 4 and
    + 8) reads, for queries a, a + 1, a + 8, a + 9 (a = q16 + 2 (t mod 4)),
    the byte of rows a, a + 1 and columns {j & ~1, +1}. Returns the
    (B, H, S, S) keep mask [b, h, query, key]."""
    thr = TA.keep_threshold(rate)
    tiles = -(-S // 64)
    buf = np.zeros(B * H * tiles * tiles * 512, np.uint8)
    w = np.arange(4)[:, None]
    t = np.arange(32)[None, :]
    for b in range(B):
        for h in range(H):
            bh = b * H + h
            for q0 in range(0, tiles * 64, 64):  # a dQ block
                i0 = q0 + 16 * w + t // 4  # (4, 32)
                for k0 in range(0, tiles * 64, 64):  # its key tiles
                    nibbles = np.zeros((4, 32), np.uint64)
                    for n in range(8):
                        j0 = k0 + 8 * n + 2 * (t % 4)
                        words = philox_words(torch.from_numpy((bh * S + i0) * S + j0),
                                             seed).numpy()
                        nib = sum(((words[..., e] >> 8) < thr).astype(np.uint64) << e
                                  for e in range(4))
                        nibbles |= nib << np.uint64(8 * n)
                    word = nibbles | (nibbles[:, np.arange(32) ^ 4] << np.uint64(4))
                    for ww in range(4):
                        for tt in range(0, 32):
                            if (tt // 4) % 2 == 0:
                                at = mask_byte(bh, int(i0[ww, tt]), k0 + 2 * (tt % 4), S)
                                buf[at:at + 8] = np.frombuffer(
                                    np.uint64(word[ww, tt]).tobytes(), np.uint8)
    keep = np.zeros((B, H, S, S), bool)
    for b in range(B):
        for h in range(H):
            for j in range(S):
                for a in [x for x in range(0, S, 2) if x & 8 == 0]:
                    byte = int(buf[mask_byte(b * H + h, a, j & ~1, S)]) >> (j & 1)
                    bits = (byte & 1) | ((byte >> 3) & 2) | (byte & 4) | ((byte >> 3) & 8)
                    for c, i in enumerate((a, a + 1, a + 8, a + 9)):
                        if i < S:
                            keep[b, h, i, j] = (bits >> c) & 1
    return keep


@pytest.mark.parametrize("S", [37, 80])
def test_the_dq_kernels_mask_bytes_give_dkdv_keep_mask_plain(S):
    """The dK/dV kernel, which holds the transposed tile and draws no Philox
    call, reads from the dQ kernel's bytes exactly ``keep_mask_plain``'s
    mask, every element."""
    seed, rate = 2 ** 35 + 11, 0.1
    np.testing.assert_array_equal(dkdv_mask_model(seed, 2, 2, S, rate),
                                  TA.keep_mask_plain(seed, 2, 2, S, rate).numpy())


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
