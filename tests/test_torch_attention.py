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
    """``mask_byte`` of csrc/attention.cuh: where the byte of the Philox
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


# ---------------------------------------------------------------------------
# The f32 kernels' 3xTF32 products on wgmma (csrc/attention_f32.cu)
# ---------------------------------------------------------------------------

def tf32_a_fragment():
    """The k8 TF32 A register fragment of a warpgroup's m64nNk8 wgmma (PTX
    ISA; CUTLASS's ALayout_64x8): (warp, lane, register) -> (row, k-slot)
    as int arrays of shape (4, 32, 4). Warp w, lane t: registers a0..a3 are
    (16 w + t / 4, t mod 4), (+ 8, t mod 4), (16 w + t / 4, t mod 4 + 4),
    (+ 8, t mod 4 + 4)."""
    w = np.arange(4)[:, None, None]
    t = np.arange(32)[None, :, None]
    r = np.arange(4)[None, None, :]
    return 16 * w + t // 4 + 8 * (r & 1), t % 4 + 4 * (r >> 1)


# split_a: A register r of k8 step kk is accumulator register 4 kk + E[r]
SPLIT_A_REGISTER = (0, 2, 1, 3)


def cols_slot_rows():
    """The source row (within its group of 8) that each k-slot of a
    transposed tile holds, as the kernels' Cols writes it: lane parity p
    loads rows p + 2i (i = 0..3) and stores them at slots 4p + i."""
    rows = np.empty(8, np.int64)
    for p in range(2):
        for i in range(4):
            rows[4 * p + i] = p + 2 * i
    return rows


@pytest.mark.parametrize("N", [32, 64, 128])
def test_a_split_accumulator_meets_the_b_rows_the_split_pass_writes(N):
    """A score accumulator of N columns, split in registers, is the A
    operand of the next k8 products (P V, dS K, P_drop^T dO, dS^T Q): in
    every k8 step kk, each thread's A register r is accumulator register 4 kk
    + SPLIT_A_REGISTER[r], of the same row as the fragment asks for, and its
    column is the source row that the transposed B tile holds at the k-slot
    the fragment gives that register, for every warp and lane; and each
    (row, column) of the accumulator enters exactly one product term."""
    acc_rows, acc_cols = wgmma_accumulator(N)
    a_rows, a_slots = np.broadcast_arrays(*tf32_a_fragment())
    slot_rows = cols_slot_rows()
    assert sorted(slot_rows) == list(range(8))  # a permutation of the group
    seen = set()
    for kk in range(N // 8):
        regs = 4 * kk + np.asarray(SPLIT_A_REGISTER)
        rows, cols = np.broadcast_arrays(acc_rows[:, :, regs], acc_cols[:, :, regs])
        np.testing.assert_array_equal(rows, a_rows)
        np.testing.assert_array_equal(cols, 8 * kk + slot_rows[a_slots])
        seen.update(zip(rows.ravel().tolist(), cols.ravel().tolist()))
    assert len(seen) == 64 * N


def tf32_hi(x):
    """The kernels' tf32_hi: x with its 13 low mantissa bits cleared."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_rna(x):
    """cvt.rna.tf32.f32: x rounded to TF32, ties away from zero, low bits
    cleared."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split3(x):
    """The kernels' split x = hi + lo (tf32_hi, tf32_lo)."""
    hi = tf32_hi(x)
    return hi, tf32_rna(x - hi)


def trunc_f32(x):
    """f64 values cut to f32 toward zero, as the tensor core's f32
    accumulation truncates."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y)


def mma3_model(a, b, tile, passes=3):
    """A @ B as the kernels compute it: over each tile of ``tile`` reduction
    indices a fresh accumulator takes, one k8 step at a time (each step's 8
    products exact, the accumulator truncated to f32 after it), hi.lo and
    lo.hi first and hi.hi last (``passes=1``: hi.hi alone, plain TF32); each
    tile's partial is added to the running f32 sum, rounded to nearest."""
    a_hi, a_lo = split3(a)
    b_hi, b_lo = split3(b)
    terms = ([(a_hi, b_lo), (a_lo, b_hi)] if passes == 3 else []) + [(a_hi, b_hi)]
    K = a.shape[-1]
    total = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for t0 in range(0, K, tile):
        part = np.zeros_like(total)
        for x, y in terms:
            for k0 in range(t0, min(t0 + tile, K), 8):
                step = np.matmul(x[..., k0:k0 + 8].astype(np.float64),
                                 y[..., k0:k0 + 8, :].astype(np.float64))
                part = trunc_f32(part.astype(np.float64) + step)
        total = (total + part).astype(np.float32)
    return total


def attention_model(q, k, v, dout, bias, passes=3, bk=32, bq=32):
    """The f32 kernels' forward and gradients with their products modelled
    (``mma3_model``): score chains over D, P V and dS K by key tiles of
    ``bk``, P^T dO and dS^T Q by query tiles of ``bq``; the softmax and the
    elementwise steps in f32."""
    D = q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(D))
    kt = np.swapaxes(k, -1, -2)
    s = mma3_model(q, kt, D, passes) * scale + bias[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    out = mma3_model(p, v, bk, passes)
    dp = mma3_model(dout, np.swapaxes(v, -1, -2), D, passes)
    delta = (dout * out).sum(-1, keepdims=True, dtype=np.float32)
    ds = (p * (dp - delta)).astype(np.float32)
    dq = mma3_model(ds, k, bk, passes) * scale
    dk = mma3_model(np.swapaxes(ds, -1, -2), q, bq, passes) * scale
    dv = mma3_model(np.swapaxes(p, -1, -2), dout, bq, passes)
    return out, (dq, dk, dv)


def attention_f64(q, k, v, dout, bias):
    q, k, v, dout, bias = (x.astype(np.float64) for x in (q, k, v, dout, bias))
    s = q @ np.swapaxes(k, -1, -2) / np.sqrt(q.shape[-1]) + bias[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = p @ v
    dp = dout @ np.swapaxes(v, -1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    scale = 1.0 / np.sqrt(q.shape[-1])
    return out, (ds @ k * scale, np.swapaxes(ds, -1, -2) @ q * scale,
                 np.swapaxes(p, -1, -2) @ dout)


def test_the_3xtf32_split_holds_the_jax_tolerances_and_plain_tf32_does_not():
    """The kernels' product arithmetic at (2, 2, 512, 64), modelled in numpy
    (hi truncated, lo rounded to TF32, the three products with the small
    terms first, each k8 step's sum truncated to f32, each tile's partial
    added in f32), against f64: the forward within the JAX attention tests'
    rtol 1e-4 / atol 1e-5 and the gradients within 2e-3 / 1e-4. Plain TF32
    (hi.hi alone) misses the forward's tolerance, so the check tells a
    split that is too lossy."""
    q, k, v, g, bias = make_inputs(2, 2, 512, seed=11)
    bias = bias[:, 0, :]
    want_out, want_grads = attention_f64(q, k, v, g, bias)
    out, grads = attention_model(q, k, v, g, bias)
    np.testing.assert_allclose(out, want_out, **FWD_TOL)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)
    assert np.abs(out - want_out).max() < 2e-6  # the card's f32 errors are of this order
    tf32_out, _ = attention_model(q, k, v, g, bias, passes=1)
    tol = FWD_TOL["atol"] + FWD_TOL["rtol"] * np.abs(want_out)
    assert (np.abs(tf32_out - want_out) > tol).any()


def staged_mask_bytes(buf, bh, S, k0, q0, BQ, NWG):
    """The dK/dV kernel's staging of the mask bytes (load_small): thread x <
    BQ NWG 2 copies 4 bytes of pair row x / (8 NWG) (query q0 + 16 (pr / 4)
    + 2 (pr mod 4)) and key tile x / 8 mod NWG (keys k0 + 64 kt ..), at its
    word x mod 8, to word x of the block's shared bytes; key tiles at or
    past S stage zeros."""
    staged = np.zeros(BQ * NWG * 8, np.uint8)
    for x in range(BQ * NWG * 2):
        pr, kt = x // (8 * NWG), x // 8 % NWG
        i0 = q0 + 16 * (pr // 4) + 2 * (pr % 4)
        if k0 + 64 * kt < S:
            at = mask_byte(bh, i0, k0 + 64 * kt, S) + 4 * (x % 8)
            staged[4 * x:4 * x + 4] = buf[at:at + 4]
    return staged


@pytest.mark.parametrize("S,BQ,NWG", [(80, 32, 2), (197, 32, 2), (512, 32, 2), (50, 16, 1),
                                      (197, 16, 1)])
def test_dkdv_staged_mask_bytes_equal_the_bytes_of_mask_byte(S, BQ, NWG):
    """The f32 dK/dV kernel copies each query tile's mask bytes (the dQ
    kernel's, in the bf16 kernels' geometry) to shared memory and reads a
    thread's byte for queries a, a + 1, a + 8, a + 9 and key j there: that
    byte is the one ``mask_byte`` gives, for every query tile, key block,
    thread and key inside S."""
    rng = np.random.RandomState(S + BQ)
    B, H = 1, 2
    tiles = -(-S // 64)
    buf = rng.randint(0, 256, B * H * tiles * tiles * 512).astype(np.uint8)
    for bh in range(B * H):
        for k0 in range(0, S, 64 * NWG):
            for q0 in range(0, S, BQ):
                staged = staged_mask_bytes(buf, bh, S, k0, q0, BQ, NWG)
                for wg in range(NWG):
                    for lane in range(128):
                        t, g, warp = lane % 4, (lane % 32) // 4, lane // 32
                        for u in range(BQ // 16):
                            a = q0 + 16 * u + 2 * t
                            base = (4 * u + t) * NWG * 32
                            for r in range(2):
                                j = k0 + 64 * wg + 16 * warp + g + 8 * r
                                if j >= S:
                                    continue
                                jj = j - k0
                                got = staged[base + (jj >> 6) * 32 + ((jj >> 1) & 3) * 8
                                             + ((jj & 63) >> 3)]
                                assert got == buf[mask_byte(bh, a, j & ~1, S)], (bh, a, j)


def test_attention_turns_refuses_to_run_without_a_card():
    """``tools/attention_turns.py`` times the kernels on the card only: it
    exits before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from eeg_multimodal_torch.tools import attention_turns

    with pytest.raises(SystemExit, match="needs a CUDA device"):
        attention_turns.main([])
    assert TA._lib.cache_info().currsize == 0


def dq_f32_mask_writes(S, H=2, B=1, BK=32, NWG=2):
    """The byte offsets the f32 dQ kernel writes to the backward's mask
    bytes, modelled thread by thread: blocks of 64 NWG query rows (warpgroup
    w, warp v, lane l: row q0 + 64 w + 16 v + l / 4, the lanes of even l / 4
    writing for rows i0 and i0 + 1), key tiles of BK, BK / 8 bytes a thread
    and tile at ``mask_byte`` of its first 8-key group, rows at or past S
    rounded up to 64 skipped (the scratch holds no more). Returns
    {(bh, offset): count}."""
    writes = {}
    for bh in range(B * H):
        for q0 in range(0, S, 64 * NWG):
            for w in range(NWG):
                for lane in range(128):
                    g, t = (lane % 32) // 4, lane % 4
                    i0 = q0 + 64 * w + 16 * (lane // 32) + g
                    if g % 2 or i0 >= -(-S // 64) * 64:
                        continue
                    for k0 in range(0, S, BK):
                        at = mask_byte(bh, i0, k0 + 2 * t, S)
                        for byte in range(at, at + BK // 8):
                            writes[(bh, byte)] = writes.get((bh, byte), 0) + 1
    return writes


@pytest.mark.parametrize("S", [1, 32, 50, 64, 65, 80, 150, 197])
def test_dq_f32_mask_writes_stay_in_their_head_and_cover_what_dkdv_reads(S):
    """The f32 dQ blocks of two warpgroups reach up to 64 query rows past S
    rounded up to 64, which the mask bytes do not hold. Every byte the
    kernel writes lies in its own head's 512 tiles^2 bytes, is written once,
    and every byte dK/dV reads (``mask_byte`` of each pair row a < S and key
    j < S) is written."""
    H, tiles = 2, -(-S // 64)
    writes = dq_f32_mask_writes(S, H)
    region = tiles * tiles * 512
    assert all(bh * region <= at < (bh + 1) * region for bh, at in writes)
    assert set(writes.values()) == {1}
    read = {(bh, mask_byte(bh, a, j & ~1, S)) for bh in range(H) for j in range(S)
            for a in range(0, S, 2) if a & 8 == 0}
    assert read <= set(writes)
