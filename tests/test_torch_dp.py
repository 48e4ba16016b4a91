"""The port's DP block (ops/dp.py, ops/dp_fused.py) and its noise
(ops/philox.py) against the JAX package and against loops over elements.

On the CPU the fused block runs its plain versions, with the kernels' exact
noise (``laplace_plain``). JAX's threefry noise cannot be reproduced by the
port, so the parity tests draw it the way ``dp_pallas._reference_impl``
does and hand it across. Tolerances: forward rtol 1e-5 / atol 1e-5,
gradients rtol 1e-4 / atol 1e-5 (f32, sums taken in another order); the
noise and the CPU path's use of it are exact.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.ops import dp as jdp
from eeg_multimodal_tpu.ops import dp_pallas as JK
from eeg_multimodal_torch.ops import dp as tdp
from eeg_multimodal_torch.ops import dp_fused as K
from eeg_multimodal_torch.ops import philox as P
from philox_ref import MASK32, philox_py

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(b, f, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    feat = rng.randn(b, f).astype(np.float32)
    if ties:  # tied minima and maxima in row 0
        feat[0, [3, 10]] = feat[0].min() - 1.0
        feat[0, [7, 20]] = feat[0].max() + 1.0
    return feat, rng.randn(1, f).astype(np.float32), rng.randn(b, f).astype(np.float32)


def jax_noise(seed, shape):
    """The noise ``_reference_impl`` draws for ``seed``."""
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    return np.asarray(jax.random.laplace(key, shape))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("shape", [(8, 256), (5, 100)])
def test_dp_math_matches_jax(shape):
    feat, dp, _ = inputs(*shape, seed=1)
    np.testing.assert_allclose(
        tdp.minmax_normalize(t(feat)).numpy(), np.asarray(jdp.minmax_normalize(feat)), **FWD)
    w = 1.0 / (1.0 + np.exp(-dp))
    np.testing.assert_allclose(
        tdp.eps_hat(t(w), 0.7).numpy(), np.asarray(jdp.eps_hat(jnp.asarray(w), 0.7)), **FWD)
    # JAX's lap_dropout_fast draws its noise from split(key)[0]
    key = jax.random.PRNGKey(3)
    j_noise = np.asarray(jdp.laplace_noise(jax.random.split(key)[0], shape))
    want = jdp.lap_dropout_fast(jnp.asarray(feat), jnp.asarray(dp), 0.7, key, hard=True)
    got = tdp.lap_dropout_fast(t(feat), t(dp), 0.7, t(j_noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("shape,ties", [((8, 256), False), ((4, 128), True), ((5, 100), True)])
def test_plain_block_forward_and_backward_match_reference_impl(shape, ties):
    feat, dp, g = inputs(*shape, seed=4, ties=ties)
    seed, eps = 11, 0.5
    noise = jax_noise(seed, shape)
    j_seed = jnp.asarray([seed], jnp.int32)

    def ref(f, d):
        return JK._reference_impl(f, d, jnp.float32(eps), j_seed)

    out, vjp = jax.vjp(ref, jnp.asarray(feat), jnp.asarray(dp))
    df_j, ddp_j = vjp(jnp.asarray(g))
    np.testing.assert_allclose(
        K.dp_block_plain(t(feat), t(dp), eps, t(noise)).numpy(), np.asarray(out), **FWD)
    df, ddp = K.dp_block_bwd_plain(t(feat), t(dp), eps, t(noise), t(g))
    np.testing.assert_allclose(df.numpy(), np.asarray(df_j), **GRAD)
    np.testing.assert_allclose(ddp.numpy(), np.asarray(ddp_j), **GRAD)


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)])
def test_fused_autograd_on_cpu_regenerates_noise_and_skips_unneeded_grads(need):
    feat, dp, g = inputs(6, 300, seed=5, ties=True)
    f = t(feat).requires_grad_(need[0])
    d = t(dp).requires_grad_(need[1])
    seed = torch.tensor([17])
    out = K.fused_lap_dropout(f, d, 0.3, seed)
    noise = K.laplace_plain(17, (6, 300))
    torch.testing.assert_close(out, K.dp_block_plain(t(feat), t(dp), 0.3, noise))
    want_df, want_ddp = K.dp_block_bwd_plain(t(feat), t(dp), 0.3, noise, t(g))
    wanted = [x for x, n in zip((f, d), need) if n]
    grads = torch.autograd.grad(out, wanted, t(g))
    for got, want in zip(grads, [w for w, n in zip((want_df, want_ddp), need) if n]):
        torch.testing.assert_close(got, want)
    # deterministic per seed, different across seeds
    torch.testing.assert_close(K.fused_lap_dropout(t(feat), t(dp), 0.3, seed), out.detach())
    other = K.fused_lap_dropout(t(feat), t(dp), 0.3, torch.tensor([18]))
    assert not torch.equal(other, out.detach())


def test_fused_autograd_takes_given_noise():
    feat, dp, g = inputs(4, 64, seed=6)
    noise = t(jax_noise(3, (4, 64)))
    f, d = t(feat).requires_grad_(), t(dp).requires_grad_()
    out = K.fused_lap_dropout(f, d, 1.0, torch.tensor([0]), noise=noise)
    torch.testing.assert_close(out, K.dp_block_plain(t(feat), t(dp), 1.0, noise))
    df, ddp = torch.autograd.grad(out, (f, d), t(g))
    want = K.dp_block_bwd_plain(t(feat), t(dp), 1.0, noise, t(g))
    torch.testing.assert_close(df, want[0])
    torch.testing.assert_close(ddp, want[1])


def test_laplace_from_bits_is_bounded_at_the_extreme_draws():
    """Draws 0 and 2**32 - 1 stay finite (the -inf bug of a zero draw) and
    within ln(2**23); a half-step offset keeps u off 0."""
    bits = torch.tensor([0, 1, 511, 512, 2**31, 2**32 - 1], dtype=torch.int64)
    x = K.laplace_from_bits(bits)
    assert torch.isfinite(x).all()
    assert x.abs().max() <= math.log(2**23) + 1e-3
    assert (x != 0).all()
    # same transform as the TPU kernel's _laplace_from_bits, written in numpy
    b = bits.numpy().astype(np.uint64)
    u = ((b >> 9).astype(np.float32) + np.float32(0.5)) * np.float32(2.0**-23) - np.float32(0.5)
    np.testing.assert_allclose(x.numpy(), -np.sign(u) * np.log1p(-2 * np.abs(u)), rtol=1e-6)


def test_seeded_noise_is_laplace():
    """``laplace_plain``, the noise of the kernels and of the CPU path, is
    Laplace(0, 1), finite and within ln 2^23."""
    noise = K.laplace_plain(7, (64, 2048)).double().numpy().ravel()  # 131072 draws
    qs = np.linspace(0.05, 0.95, 19)
    exact = -np.sign(qs - 0.5) * np.log1p(-2 * np.abs(qs - 0.5))
    np.testing.assert_allclose(np.quantile(noise, qs), exact, atol=0.05)
    assert abs(noise.var() - 2.0) < 0.1
    assert np.isfinite(noise).all() and np.abs(noise).max() <= math.log(2**23) + 1e-3


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    feat, dp, g = inputs(2, 16)
    before = (K.dp_fwd.launches, K.dp_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        K.dp_fwd(t(feat), t(dp), 0.5, torch.tensor([1]))
    with pytest.raises(ValueError, match="CUDA"):
        K.dp_bwd(t(feat), t(dp), 0.5, torch.tensor([1]), t(g))
    assert (K.dp_fwd.launches, K.dp_bwd.launches) == before


# ---------------------------------------------------------------------------
# The kernels' noise in its plain form (laplace_plain) and its Philox
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counter, key, want", [
    # Random123's known-answer vectors (kat_vectors, philox4x32 with 10 rounds)
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((MASK32,) * 4, (MASK32,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_matches_the_random123_known_answers(counter, key, want):
    assert tuple(int(w) for w in P.philox4x32_10(counter, key)) == want
    assert tuple(philox_py(counter, key)) == want


@pytest.mark.parametrize("shape", [(3, 10), (2, 7)])
def test_laplace_plain_is_the_grouped_philox_of_each_element(shape):
    """Element n takes word n & 3 of the call at counter n & ~3, keyed by the
    64-bit seed. F % 4 != 0 here, so groups of four cross row boundaries."""
    seed = 2 ** 35 + 123
    words = []
    for n in range(math.prod(shape)):
        g = n & ~3
        words.append(philox_py((g & MASK32, g >> 32, 0, 0), (seed & MASK32, seed >> 32))[n & 3])
    want = K.laplace_from_bits(torch.tensor(words, dtype=torch.int64)).reshape(shape)
    assert torch.equal(K.laplace_plain(seed, shape), want)
    # a function of (seed, n) alone: the rows of a taller draw hold the same noise
    taller = K.laplace_plain(seed, (shape[0] + 2, shape[1]))
    assert torch.equal(taller[:shape[0]], want)
    assert not torch.equal(K.laplace_plain(seed + 2 ** 32, shape), want)  # the key's high word


@pytest.mark.parametrize("shape,ties", [((3, 10), False), ((4, 64), True)])
def test_fused_cpu_path_draws_exactly_laplace_plain(shape, ties):
    """The CPU path of ``fused_lap_dropout`` draws ``laplace_plain(seed)``,
    the card's noise, in the forward and again in the backward."""
    feat, dp, g = inputs(*shape, seed=8, ties=ties)
    seed = 2 ** 33 + 9
    f, d = t(feat).requires_grad_(), t(dp).requires_grad_()
    out = K.fused_lap_dropout(f, d, 0.4, torch.tensor([seed]))
    noise = K.laplace_plain(seed, shape)
    assert torch.equal(out, K.dp_block_plain(t(feat), t(dp), 0.4, noise))
    df, ddp = torch.autograd.grad(out, (f, d), t(g))
    want_df, want_ddp = K.dp_block_bwd_plain(t(feat), t(dp), 0.4, noise, t(g))
    assert torch.equal(df, want_df) and torch.equal(ddp, want_ddp)
