"""The port's Adam (ops/optim.py) against the JAX package's ``ops/optim.py``
and ``optax.adam``, on the CPU: the f32 path unchanged, bf16 moment storage,
the second moment's stochastic rounding, and the trainer's config fields."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.ops import optim as JO
from eeg_multimodal_tpu.train.trainer import TrainConfig as JTrainConfig
from eeg_multimodal_torch.ops import optim as O
from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig
from test_torch_bf16 import configs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shapes():
    return [(16, 8), (8,), (3, 5, 7)]


def grads(n=25, seed=1):
    """``n`` steps of gradients for :func:`shapes`, made with numpy."""
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(np.float32) * rng.choice([1e-3, 1.0]) for s in shapes()]
            for _ in range(n)]


def initial():
    rng = np.random.RandomState(0)
    return [rng.randn(*s).astype(np.float32) for s in shapes()]


def run_port(opt, gs):
    params = [torch.from_numpy(p.copy()) for p in initial()]
    state = opt.init(params)
    for g in gs:
        state = opt.update(params, [torch.from_numpy(x) for x in g], state)
    return [p.numpy() for p in params], state


def run_jax(opt, gs):
    params = [jnp.asarray(p) for p in initial()]
    state = opt.init(params)
    for g in gs:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, upd)
    return [np.asarray(p) for p in params], state


def test_f32_adam_is_optax_adam_and_keeps_its_path():
    """f32 storage: no packed buffer, f32 moments updated in place, and the
    trajectory of optax.adam over 25 steps within rtol 1e-6 / atol 1e-7, a
    few f32 ulps of the params (the bias corrections are double here, f32
    there, and each step rounds the params)."""
    opt = O.Adam(1e-3)
    ours, state = run_port(opt, grads())
    want, _ = run_jax(optax.adam(1e-3), grads())
    assert state.packed == {} and state.count == 25
    assert all(m.dtype == torch.float32 for m in state.mu + state.nu)
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_bf16_moments_match_jax_with_round_to_nearest():
    """Both moments bf16, nu rounded to nearest on both sides (so no random
    bits): the params over 25 steps within rtol 1e-5 / atol 1e-7, the stored
    moments within one bf16 ulp (2^-7 relative; the f32 sums round in
    another order before the cast)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = O.Adam(1e-3, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16,
                     nu_stochastic_rounding=False)
        jopt = JO.adam(1e-3, mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16,
                       nu_stochastic_rounding=False)
    ours, state = run_port(opt, grads())
    want, jstate = run_jax(jopt, grads())
    assert set(state.packed) == {"mu", "nu"}
    assert all(m.dtype == torch.bfloat16 for m in state.mu + state.nu)
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    for ours_m, want_m in ((state.mu, jstate[0].mu), (state.nu, jstate[0].nu)):
        for a, b in zip(ours_m, want_m):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       rtol=2.0 ** -7, atol=1e-30)


def test_the_step_uses_the_moments_before_the_store_rounding():
    """One step from zero with stochastic rounding on both sides: the bits
    differ (another generator), but the step is taken with the f32 moments,
    so the params match at the f32 tolerance; the stored nu is within one
    bf16 ulp of JAX's, mu equal (round to nearest of the same f32)."""
    g = grads(1)
    ours, state = run_port(O.Adam(1e-3, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16,
                                  sr_seed=3), g)
    want, jstate = run_jax(JO.adam(1e-3, mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16,
                                   sr_seed=3), g)
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    for a, b in zip(state.mu, jstate[0].mu):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    for a, b in zip(state.nu, jstate[0].nu):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=2.0 ** -7, atol=1e-30)


def test_stochastic_rounding_bits_match_jax():
    """Handed JAX's random uint16 draws, the port's int32 arithmetic gives
    JAX's uint32 result bit for bit: negative values, values bf16 holds, the
    largest finite values, subnormals."""
    fmax = np.finfo(np.float32).max
    x = np.concatenate([np.random.RandomState(0).randn(4096).astype(np.float32) * 100,
                        np.float32([0.0, -0.0, 1.0, -2.5, fmax, -fmax, 1e-40, -1e-40])])
    key = jax.random.PRNGKey(11)
    want = np.asarray(JO.stochastic_round_to_bf16(jnp.asarray(x), key)).view(np.uint16)
    rnd = np.asarray(jax.random.bits(key, x.shape, jnp.uint16)).astype(np.int32)
    ours = O.stochastic_round_bits(torch.from_numpy(x), torch.from_numpy(rnd))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.view(torch.int16).numpy().view(np.uint16), want)


def test_stochastic_round_exact_and_unbiased():
    """tests/test_optim.py::test_stochastic_round_exact_and_unbiased on the
    port: held values come back exactly; 30 % into an ulp rounds up 30 % of
    the time (within 0.02 over 20000 draws) and the mean within rtol 3e-4."""
    gen = torch.Generator().manual_seed(0)
    exact = torch.tensor([1.0, -2.5, 0.0, 3.141592653589793]).to(torch.bfloat16).float()
    assert torch.equal(O.stochastic_round_to_bf16(exact, gen).float(), exact)
    x = torch.full((20000,), 1.0 + 0.3 * 2.0 ** -7)
    r = O.stochastic_round_to_bf16(x, gen).float()
    assert set(torch.unique(r).tolist()) <= {1.0, 1.0 + 2.0 ** -7}
    assert abs(float((r > 1.0).float().mean()) - 0.3) < 0.02
    np.testing.assert_allclose(float(r.double().mean()), float(x[0]), rtol=3e-4)


def test_rounding_stream_is_deterministic_per_seed_and_step():
    """Two runs with one seed give the same bits; another seed or another
    step count other bits (the JAX package folds _SR_SEED with both)."""
    y = torch.rand(4096, generator=torch.Generator().manual_seed(1))

    def bits(seed, count):
        gen = O.Adam(1e-3, nu_dtype=torch.bfloat16, sr_seed=seed)._sr_generator(count, "cpu")
        return O.stochastic_round_to_bf16(y, gen).view(torch.int16)

    assert torch.equal(bits(7, 3), bits(7, 3))
    assert not torch.equal(bits(7, 3), bits(7, 4))
    assert not torch.equal(bits(7, 3), bits(8, 3))
    runs = [run_port(O.Adam(1e-3, nu_dtype=torch.bfloat16, sr_seed=s), grads(5))[1].nu
            for s in (7, 7, 8)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(torch.equal(a, b) for a, b in zip(runs[0], runs[2]))


@pytest.mark.parametrize("sr", [False, True])
def test_round_to_nearest_nu_ratchets_stochastic_rounding_decays(sr):
    """tests/test_optim.py:101 on the port: nu built up by 50 unit
    gradients, then 400 zero ones. Round to nearest cannot store the
    sub-ulp decay and stays at its peak; stochastic rounding tracks
    0.999^400 of it within 5 % (the mean over 4096 elements)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = O.Adam(1e-3, nu_dtype=torch.bfloat16, nu_stochastic_rounding=sr)
    params = [torch.zeros(4096)]
    state = opt.init(params)
    for _ in range(50):
        state = opt.update(params, [torch.ones(4096)], state)
    peak = float(state.nu[0].float().mean())
    for _ in range(400):
        state = opt.update(params, [torch.zeros(4096)], state)
    end = float(state.nu[0].float().mean())
    if sr:
        np.testing.assert_allclose(end, peak * 0.999 ** 400, rtol=0.05)
    else:
        assert end == peak


def test_bf16_nu_without_stochastic_rounding_warns():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        O.Adam(1e-3, nu_dtype=torch.bfloat16, nu_stochastic_rounding=False)
        O.Adam(1e-3, nu_dtype=torch.bfloat16)
    assert ["ratchet" in str(w.message) for w in caught] == [True]


def test_train_config_has_every_field_of_the_jax_one():
    """The port's TrainConfig takes every JAX field by name, with its
    default; TrainConfig() runs (eval_vmap_batches=True is implemented, not
    refused)."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert ours == jax_fields
    assert TrainConfig(**{k: getattr(JTrainConfig(), k) for k in jax_fields}) == TrainConfig()
    assert TrainConfig().eval_vmap_batches is True
    with pytest.raises(ValueError, match="compute_dtype"):
        TrainConfig(compute_dtype="float16")


def test_the_trainer_stores_bf16_model_moments_and_f32_dp_moments():
    """adam_mu_dtype / adam_nu_dtype reach the model optimizer (sr_seed =
    the run's seed); the DP leaf keeps f32 Adam, as ``optax.adam`` there."""
    cfg = TrainConfig(batch_size=4, compute_dtype="bfloat16", adam_mu_dtype="bfloat16",
                      adam_nu_dtype="bfloat16", seed=5)
    steps = StepFunctions(configs()[1], cfg, device="cpu")
    assert steps.model_opt.nu_sr and steps.model_opt.sr_seed == 5
    dp_os, model_os = steps.init_opt_states(
        {"DP": torch.zeros(1, 4), "fc1": {"kernel": torch.zeros(3, 2)}})
    assert dp_os.mu[0].dtype == torch.float32 and dp_os.packed == {}
    assert model_os.mu[0].dtype == model_os.nu[0].dtype == torch.bfloat16
