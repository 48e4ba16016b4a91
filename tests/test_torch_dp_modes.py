"""The port's DP mechanisms (ops/dp.py) against the JAX package's
``ops/dp.py``, on the CPU.

Exact where the draw is handed across: each JAX function's threefry draws
(Laplace, Gumbel, the Bernoulli keep mask) are rebuilt from its key layout
and given to the port, which then computes the same function; values and
gradients at rtol 1e-5 / atol 1e-6 (f32 elementwise math, no long sums).
Statistical where the port draws for itself: quantiles of the Laplace and
Gumbel laws at the stated scale (max error 0.05 x scale over 2^18 draws,
where the sampling error of a quantile is below 0.01 x scale), the hard
Gumbel one-hot's frequencies (5 sigma), the equal-weight keep share.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.ops import dp as JD
from eeg_multimodal_torch.ops import dp as TD
from eeg_multimodal_torch.ops import dp_fused

TOL = dict(rtol=1e-5, atol=1e-6)
B, F = 4, 24
QS = np.linspace(0.05, 0.95, 19)
N_DRAWS = 1 << 18


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def normalized(seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(B, F).astype(np.float32)


def grads(fn, *xs):
    """(value, gradients of sum(value * c) w.r.t. ``xs``) of a torch ``fn``."""
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in xs]
    out = fn(*leaves)
    c = torch.from_numpy(np.asarray(np.random.RandomState(9).randn(*out.shape), np.float32))
    return out.detach().numpy(), [g.numpy() for g in torch.autograd.grad((out * c).sum(), leaves)]


def jax_grads(fn, *xs):
    """:func:`grads` of the JAX ``fn``, in one jitted call."""
    xs = [jnp.asarray(x) for x in xs]
    c = jnp.asarray(np.random.RandomState(9).randn(*jax.eval_shape(fn, *xs).shape),
                    jnp.float32)
    def loss(*a):
        out = fn(*a)
        return (out * c).sum(), out

    (_, out), gs = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(xs))),
                                              has_aux=True))(*xs)
    return np.asarray(out), [np.asarray(g) for g in gs]


def assert_same(port, want):
    (v, gs), (wv, wgs) = port, want
    np.testing.assert_allclose(v, wv, **TOL)
    for g, wg in zip(gs, wgs):
        np.testing.assert_allclose(g, wg, **TOL)


# -- the samplers -------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_laplace_noise_has_the_laplace_quantiles_at_its_scale(scale):
    x = TD.laplace_noise((N_DRAWS,), scale, gen(1)).double().numpy()
    exact = -scale * np.sign(QS - 0.5) * np.log1p(-2 * np.abs(QS - 0.5))
    assert np.abs(np.quantile(x, QS) - exact).max() <= 0.05 * scale
    assert np.isfinite(x).all() and np.abs(x).max() <= scale * math.log(2 ** 23) * (1 + 1e-6)


def test_gumbel_noise_has_the_gumbel_quantiles_and_is_finite():
    x = TD.gumbel_noise((N_DRAWS,), gen(2)).double().numpy()
    assert np.abs(np.quantile(x, QS) + np.log(-np.log(QS))).max() <= 0.05
    assert np.isfinite(x).all()
    # the extreme 23-bit draws stay finite
    lo_hi = torch.tensor([0, (1 << 32) - 1], dtype=torch.int64)
    assert torch.isfinite(-torch.log(-torch.log(TD._open_unit(lo_hi)))).all()


def test_the_port_has_one_laplace_sampler():
    """The fused kernels' plain twin and the composed path draw through the
    same transform of the same bits."""
    assert dp_fused.laplace_from_bits is TD.laplace_from_bits
    bits = TD.random_bits((B, F), gen(3))
    assert torch.equal(TD.laplace_noise((B, F), 1.0, gen(3)), TD.laplace_from_bits(bits))


# -- eps_hat and the Gumbel-softmax --------------------------------------------

@pytest.mark.parametrize("epsilon", [0.1, 1.0, 10.0])
def test_eps_hat_and_its_prefix_form_match_jax(epsilon):
    w = np.random.RandomState(0).uniform(0.01, 0.99, (1, F)).astype(np.float32)
    for ours, theirs in ((TD.eps_hat, JD.eps_hat), (TD.eps_hat_prefix, JD.eps_hat_prefix)):
        assert_same(grads(lambda x: ours(x, epsilon), w),
                    jax_grads(lambda x: theirs(x, epsilon), w))
    np.testing.assert_allclose(TD.eps_hat(torch.from_numpy(w), epsilon).numpy(),
                               1.0 / TD.eps_hat_prefix(torch.from_numpy(w), epsilon).numpy())


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_jax_with_the_draw_handed_in(hard):
    logits = np.random.RandomState(1).randn(B, 5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    g = np.array(jax.random.gumbel(key, logits.shape))
    port = grads(lambda x: TD.gumbel_softmax(x, 0.5, hard, gumbel=torch.from_numpy(g)), logits)
    assert_same(port, jax_grads(lambda x: JD.gumbel_softmax(x, key, 0.5, hard), logits))
    if hard:  # an exact one-hot forward
        assert set(np.unique(port[0]).tolist()) == {0.0, 1.0}
        assert (port[0].sum(-1) == 1.0).all()


def test_hard_gumbel_one_hot_frequencies_follow_the_softmax():
    logits = torch.tensor([0.3, -1.0, 1.2])
    n = 1 << 16
    y = TD.gumbel_softmax(logits.expand(n, 3), 1.0, True, gen=gen(5))
    freq = y.mean(0).numpy()
    p = torch.softmax(logits, 0).numpy()
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n))


# -- the learned Laplace block --------------------------------------------------

def lap_draws(key):
    """The JAX lap_dropout's draws for ``key``: Laplace (B, F), Gumbel (2, B, F)."""
    k_lap, k_gum = jax.random.split(key)
    return (np.array(jax.random.laplace(k_lap, (B, F))),
            np.array(jax.random.gumbel(k_gum, (2, B, F))))


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("prefix", [False, True])
def test_faithful_lap_dropout_matches_jax(hard, prefix):
    feature = normalized(1)
    dp = np.random.RandomState(2).randn(1, F).astype(np.float32)
    key = jax.random.PRNGKey(6)
    noise, gum = (torch.from_numpy(a) for a in lap_draws(key))
    port = grads(lambda f, d: TD.lap_dropout(f, d, 0.5, hard, noise=noise, gumbel=gum,
                                             prefix_eps_hat=prefix), feature, dp)
    want = jax_grads(lambda f, d: JD.lap_dropout(f, d, 0.5, key, hard, prefix_eps_hat=prefix),
                     feature, dp)
    assert_same(port, want)


@pytest.mark.parametrize("hard", [False, True])
def test_faithful_lap_dropout_equals_the_fast_form(hard):
    """The Gumbel mask's halves sum to one: drawn from one generator, the
    faithful block (Laplace first, then Gumbel) equals ``lap_dropout_fast``
    on the same Laplace draw, in value and gradient."""
    feature = normalized(3)
    dp = np.random.RandomState(4).randn(1, F).astype(np.float32)
    noise = TD.laplace_noise((B, F), 1.0, gen(7))
    faithful = grads(lambda f, d: TD.lap_dropout(f, d, 0.5, hard, gen=gen(7)), feature, dp)
    fast = grads(lambda f, d: TD.lap_dropout_fast(f, d, 0.5, noise), feature, dp)
    assert_same(faithful, fast)


# -- the per-sample mechanisms ---------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_equal_weight_dp_matches_jax(train, rate):
    feature = normalized(5)
    key = jax.random.PRNGKey(8)
    k_drop, k_lap = jax.random.split(key)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(k_drop, 1.0 - rate, (B, F))))
    noise = torch.from_numpy(np.array(jax.random.laplace(k_lap, (B, 1))))
    port = grads(lambda f: TD.equal_weight_dp(f, 0.5, rate, train, noise=noise, keep=keep),
                 feature)
    assert_same(port, jax_grads(lambda f: JD.equal_weight_dp(f, 0.5, rate, key, train),
                                feature))


def test_equal_weight_dp_draws_its_mask_and_a_noise_per_row():
    """Drawn from a generator, on rows of ones: in training each feature is
    dropped (0) or kept and scaled (2), about half each, plus one noise value
    per row at the scale lap_sigma = log((e^eps - r) / (1 - r)), which a
    dropped feature shows alone; in eval nothing is dropped."""
    eps, rate, n = 1.0, 0.5, 1 << 16
    out = TD.equal_weight_dp(torch.ones(n, 64), eps, rate, True, gen(9))
    low = out.amin(1, keepdim=True)
    spread = out - low
    assert ((spread < 1e-3) | ((spread - 2.0).abs() < 1e-3)).all()
    assert abs(float((spread > 1.0).float().mean()) - (1 - rate)) < 0.01
    sigma = math.log((math.exp(eps) - rate) / (1 - rate))
    exact = -sigma * np.sign(QS - 0.5) * np.log1p(-2 * np.abs(QS - 0.5))
    assert np.abs(np.quantile(low[:, 0].double().numpy(), QS) - exact).max() <= 0.05 * sigma
    ev = TD.equal_weight_dp(torch.ones(8, 64), eps, rate, False, gen(10))
    assert torch.equal(ev, ev[:, :1].expand(8, 64))


def test_per_sample_laplace_matches_jax():
    x = np.random.RandomState(6).randn(B, F).astype(np.float32)
    key = jax.random.PRNGKey(10)
    noise = torch.from_numpy(np.array(jax.random.laplace(key, (B, 1))))
    assert_same(grads(lambda f: TD.per_sample_laplace(f, 0.5, noise=noise), x),
                jax_grads(lambda f: JD.per_sample_laplace(f, 0.5, key), x))


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_dropout_matches_jax(hard):
    x = np.random.RandomState(7).randn(B, F).astype(np.float32)
    w = np.random.RandomState(8).uniform(0.05, 0.95, (F,)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (F, 2))))
    port = grads(lambda a, b: TD.gumbel_dropout(a, b, 0.1, hard, gumbel=g), x, w)
    assert_same(port, jax_grads(lambda a, b: JD.gumbel_dropout(a, b, key, 0.1, hard), x, w))


def test_privacy_regularized_loss_matches_jax():
    w = np.random.RandomState(9).rand(F).astype(np.float32)
    ce = np.float32(0.7)
    port = grads(lambda c, v: TD.privacy_regularized_loss(c, v, 0.3, 0.5), ce, w)
    assert_same(port, jax_grads(lambda c, v: JD.privacy_regularized_loss(c, v, 0.3, 0.5),
                                ce, w))
