"""The port's bf16 compute cast against the JAX package's, on the CPU: the
dtype of every stage, the forward, one alternating step and the eval, on
one weight set, with the DP noise handed across and dropout off.

Tolerance. JAX keeps excess precision inside its jitted fusions (it rounds
to bf16 where a fusion ends) and PyTorch rounds after every operation, so
the two bf16 forwards do not agree bit for bit, and the port's has more
roundings. The yardstick is JAX's own bf16 distance from its f32 forward
on the same inputs: each bf16-trail stage of the port must sit within 2x
that distance of JAX's f32 (max abs) and within 1.5x in RMS (measured:
1.2-1.5x and 1.1-1.3x). The act stream (f32 against bf16-rounded weights)
keeps the f32 tests' rtol 1e-4 / atol 1e-5. At S < 512 JAX multiplies f32
probabilities by V where the port's kernels round P to bf16 first: the
yardstick covers that one rounding too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.models import layers as JL
from eeg_multimodal_tpu.ops import optim as JO
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_tpu.utils.trees import tree_cast as jax_cast
from eeg_multimodal_torch.data.datasets import epoch_indices
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models import layers as TL
from eeg_multimodal_torch.models.convert import params_to_numpy
from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig
from eeg_multimodal_torch.utils.trees import tree_cast, tree_items, tree_map
from test_torch_fusion import batch_np, jax_dp_noise, to_port_batch
from test_torch_trainer import arrays

F32_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(vocab_size=50, hidden_size=768, num_layers=1, num_heads=12,
            intermediate_size=64, max_position_embeddings=512)
B, EPS = 4, 0.5
BF16 = dict(compute_dtype="bfloat16", adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(fused=False):
    jc = dataclasses.replace(JF.config_for("ti", "lapacian_dropout"),
                             bert_config=JB.BertConfig(**TINY), fused_dp_kernel=fused)
    tc = dataclasses.replace(TF.config_for("ti", "lapacian_dropout"),
                             bert_config=TB.BertConfig(**TINY), fused_dp_kernel=fused)
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    return params_to_numpy(TF.init(configs()[1], seed=0, device="cpu"))


def port_params(weights):
    return tree_map(lambda a: torch.from_numpy(a.copy()), weights)


def f32(x):
    x = x.detach().float().numpy() if isinstance(x, torch.Tensor) else x
    return np.asarray(x, np.float32)


def within_yardstick(name, port, j16, j32):
    """The port's bf16 distance from JAX's f32 within 2x (max abs) and 1.5x
    (RMS) JAX's own bf16 distance from it."""
    port, j16, j32 = f32(port), f32(j16), f32(j32)
    ours, yard, mutual = np.abs(port - j32), np.abs(j16 - j32), np.abs(port - j16)

    def rms(x):
        return float(np.sqrt((x ** 2).mean()))

    print(f"{name}: port - jax f32 max {ours.max():.3g} rms {rms(ours):.3g}; jax bf16 - f32 "
          f"max {yard.max():.3g} rms {rms(yard):.3g}; port - jax bf16 max {mutual.max():.3g}")
    assert ours.max() <= 2.0 * yard.max(), name
    assert rms(ours) <= 1.5 * rms(yard), name


@pytest.mark.parametrize("S", [8, 512])
def test_every_stage_has_the_jax_dtype_and_values(weights, S):
    """BERT's sequence and pooled output bf16; the visual encoder, the decoder,
    the concat and the logits f32; each within the yardstick."""
    jc, tc = configs()
    batch = batch_np(s=S)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    pb = to_port_batch(batch)
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    jp16 = jax_cast(jp, jnp.bfloat16)
    pp16 = tree_cast(port_params(weights), torch.bfloat16)

    bert = jax.jit(lambda p: JB.apply(p, jb["eeg_input"], jb["eeg_mask"], jc.bert_cfg()))
    j32, j16 = bert(jp["bert"]), bert(jp16["bert"])
    ours = TB.apply(pp16["bert"], pb["eeg_input"], pb["eeg_mask"], tc.bert_cfg())
    for name, a, b32, b16 in zip(("sequence", "pooled"), ours, j32, j16):
        assert a.dtype == torch.bfloat16 and b16.dtype == jnp.bfloat16
        within_yardstick(name, a, b16, b32)

    act = TL.linear(pp16["visual_encoder"], pb["act_input"])
    want = JL.linear(jp16["visual_encoder"], jb["act_input"].astype(jnp.float32))
    assert act.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(f32(act), f32(want), **F32_TOL)

    memory = ours[0]
    cross = TL.decoder(pp16["cross"], act, memory, 12, tgt_key_padding_mask=pb["act_mask"] == 0,
                       memory_key_padding_mask=pb["eeg_mask"] == 0)
    dec = jax.jit(lambda p, mem: JL.decoder(p, want, mem, 12, jb["act_mask"] == 0,
                                            jb["eeg_mask"] == 0))
    want16 = dec(jp16["cross"], j16[0])
    assert cross.dtype == torch.float32 and want16.dtype == jnp.float32
    within_yardstick("decoder", cross, want16, dec(jp["cross"], j32[0]))

    enc = jax.jit(lambda p: JF.encode_features(p, jb, jc, JF.split_rng(None)[0], train=False))
    feat = TF.encode_features(pp16, pb, tc, None, train=False)
    assert feat.dtype == torch.float32 and enc(jp16).dtype == jnp.float32
    within_yardstick("concat", feat, enc(jp16), enc(jp))

    rng = jax.random.PRNGKey(1)
    noise = torch.from_numpy(jax_dp_noise(rng, (B, tc.concat_width), False))
    fwd = jax.jit(lambda p: JF.apply(p, jb, jc, EPS, True, rng, train=False))
    logits = TF.apply(pp16, pb, tc, EPS, True, None, False, dp_noise=noise)
    assert logits.dtype == torch.float32 and fwd(jp16).dtype == jnp.float32
    within_yardstick("logits", logits, fwd(jp16), fwd(jp))


@pytest.mark.parametrize("fused", [False, True])
def test_dp_leaf_is_cast_with_the_tree(weights, fused):
    """A bf16 ``DP`` with nonzero logits. The fused path casts the leaf back
    to f32: the f32 tolerance. On the composed path sigmoid(DP) is bf16,
    1 - w rounds in bf16 and e^eps - w is f32: a one-ulp change of w moves
    1 - w by up to 8 % where w is near 1, and XLA's bf16 sigmoid is off the
    nearest bf16 value on about 30 % of these inputs where PyTorch's is
    rounded once from f32, so the composed path takes the yardstick (JAX's
    bf16 head against its f32 head on the f32 ``DP``)."""
    jc, tc = configs(fused)
    feature = np.random.RandomState(3).rand(B, tc.concat_width).astype(np.float32)
    dp = np.random.RandomState(4).randn(1, tc.concat_width).astype(np.float32)
    p16 = tree_cast({**port_params(weights), "DP": torch.from_numpy(dp)}, torch.bfloat16)
    j16 = jax_cast({**jax.tree_util.tree_map(jnp.asarray, weights), "DP": jnp.asarray(dp)},
                   jnp.bfloat16)
    rng = jax.random.PRNGKey(2)
    _, k_dp = JF.split_rng(rng)
    want = JF.apply_head(j16, jnp.asarray(feature), jc, EPS, True, k_dp, train=False)
    noise = torch.from_numpy(jax_dp_noise(rng, feature.shape, fused))
    got = TF.apply_head(p16, torch.from_numpy(feature), tc, EPS, True, None, dp_noise=noise)
    assert got.dtype == torch.float32 and p16["DP"].dtype == torch.bfloat16
    if fused:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    else:
        j32 = {**j16, "DP": jnp.asarray(dp)}
        within_yardstick("head", got, want,
                         JF.apply_head(j32, jnp.asarray(feature), jc, EPS, True, k_dp, False))


def jax_step(weights, data, weight, k1, k2, dtype):
    """JAX's faithful alternating step (trainer.py:292-321) under a compute
    cast to ``dtype``, dropout off: (loss, DP grad, model grads, the params
    after the step, the model optimizer's state)."""
    jc, _ = configs()
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    jb = {k: jnp.asarray(getattr(data, k)) for k in
          ("eeg_input", "eeg_mask", "act_input", "act_mask", "labels")}

    def loss(params, rng, hard):
        logits = JF.apply(jax_cast(params, dtype), jb, jc, EPS, hard, rng, train=False)
        return JM.cal_loss(logits, jb["labels"], jnp.asarray(weight))[:2]

    rest = {k: v for k, v in jp.items() if k != "DP"}
    dp_opt = optax.adam(1e-6)
    g_dp = jax.jit(jax.grad(lambda dp, r: loss({**r, "DP": dp}, k1, False)[0]))(jp["DP"], rest)
    dp1 = optax.apply_updates(jp["DP"], dp_opt.update(g_dp, dp_opt.init(jp["DP"]))[0])
    (j_loss, _), g = jax.jit(jax.value_and_grad(
        lambda r, dp: loss({**r, "DP": dp}, k2, True), has_aux=True))(rest, dp1)
    opt = JO.adam(1e-6, mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16, sr_seed=7)
    upd, state = opt.update(g, opt.init(rest), rest)
    rest1 = optax.apply_updates(rest, upd)
    flat = dict(tree_items(jax.tree_util.tree_map(f32, {**rest1, "DP": dp1})))
    return float(j_loss), f32(g_dp), dict(tree_items(jax.tree_util.tree_map(f32, g))), flat, \
        state[0]


def test_bf16_alternating_step_matches_jax(weights):
    """Loss within the yardstick; each model gradient's relative L2 error
    (read back from the stored bf16 mu = RTN(0.1 g)) within JAX's own bf16
    error against f32, plus mu's rounding 2^-8; the DP gradient likewise;
    the Adam step (the update over lr, +-1 at a first step where |g| >> eps)
    of the same sign on all but 1 % of the elements where JAX's f32 and bf16
    steps agree."""
    data = arrays(B, seed=1)
    weight = np.array([1, 1, 1, 0], np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    l16, gdp16, g16, p16, state16 = jax_step(weights, data, weight, k1, k2, jnp.bfloat16)
    l32, gdp32, g32, p32, _ = jax_step(weights, data, weight, k1, k2, jnp.float32)
    assert all(l.dtype == jnp.bfloat16 for l in jax.tree_util.tree_leaves(state16.nu))

    steps = StepFunctions(configs()[1], TrainConfig(batch_size=B, seed=7, **BF16), device="cpu")
    params = port_params(weights)
    dp_os, model_os = steps.init_opt_states(params)
    noise = tuple(torch.from_numpy(jax_dp_noise(k, (B, 2304), False)) for k in (k1, k2))
    dp_os, model_os, loss, _ = steps.train_step(
        params, dp_os, model_os, data.to_device("cpu"), torch.from_numpy(weight), EPS,
        torch.Generator().manual_seed(0), dp_noise=noise, dropout=False)

    print(f"loss: port {float(loss):.7f}, jax bf16 {l16:.7f}, jax f32 {l32:.7f}")
    assert abs(float(loss) - l16) <= abs(l16 - l32)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    assert rel(f32(dp_os.mu[0]) / 0.1, gdp16) <= rel(gdp16, gdp32) + 2.0 ** -8
    paths = [p for p, _ in tree_items(params) if p != "DP"]
    assert all(m.dtype == torch.bfloat16 for m in model_os.mu + model_os.nu)
    worst = 0.0
    for path, mu in zip(paths, model_os.mu):
        if not np.any(g16[path]):
            assert not mu.any(), path  # no gradient, no moment
            continue
        ours, yard = rel(f32(mu) / 0.1, g16[path]), rel(g16[path], g32[path])
        worst = max(worst, ours / (yard + 2.0 ** -8))
        assert ours <= yard + 2.0 ** -8, (path, ours, yard)
    print(f"gradients: worst relative L2 error / (jax bf16 - f32 + 2^-8) = {worst:.3f}")
    p0 = dict(tree_items(weights))
    flips = total = 0
    for path, leaf in tree_items(params):
        ours, want, ref = ((x - p0[path]) / 1e-6 for x in (f32(leaf), p16[path], p32[path]))
        stable = np.sign(want) == np.sign(ref)
        flips += int((np.sign(ours) != np.sign(want))[stable].sum())
        total += int(stable.sum())
    print(f"Adam step: {flips} sign flips of {total} stable elements")
    assert flips <= 0.01 * total


def test_precast_params_equals_the_in_step_cast_over_an_epoch(weights):
    """Carrying the bf16 copy (``precast_params``) and casting inside every
    step give the same epoch on JAX's terms (tests/test_optim.py::
    test_precast_params_matches: rtol 2^-8 and 99.9 % equal); in the port
    they are equal bit for bit, since PyTorch keeps no excess precision at
    the cast."""
    data = arrays(8, seed=3).to_device("cpu")

    def epoch(precast):
        cfg = TrainConfig(batch_size=B, learning_rate=1e-3, precast_params=precast, **BF16)
        steps = StepFunctions(configs()[1], cfg, device="cpu")
        params = port_params(weights)
        dp_os, model_os = steps.init_opt_states(params)
        idx, w = epoch_indices(8, B, True, torch.Generator().manual_seed(1))
        out = steps.train_epoch(params, dp_os, model_os, data, idx, w, 0.1,
                                torch.Generator().manual_seed(2))
        return [t for _, t in tree_items(params)] + out[0].mu + out[1].mu + out[1].nu \
            + list(out[2:])

    ref, pre = epoch(False), epoch(True)
    n_eq = n_tot = 0
    for a, b in zip(ref, pre):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(f32(a), f32(b), rtol=2.0 ** -8, atol=1e-7)
        n_eq += int((a == b).sum())
        n_tot += a.numel()
    assert n_eq == n_tot


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_batched_eval_equals_the_loop(weights, compute_dtype):
    """``eval_vmap_batches``: one forward over every eval batch against one
    forward each, the same noise handed to both: the loss and accuracy as
    means of per-batch weighted means, the padding weights kept. Rows are
    independent, so only GEMM blocking differs (rtol 1e-5 in f32; bf16
    within one rounding, 2^-7)."""
    test = arrays(6, seed=2)
    idx = torch.tensor([[0, 1, 2, 3], [4, 5, 0, 0]])
    w = torch.tensor([[1, 1, 1, 1], [1, 1, 0, 0]], dtype=torch.float32)
    noise = [torch.from_numpy(np.random.RandomState(i).laplace(size=(B, 2304))).float()
             for i in range(2)]
    outs = []
    for batched in (True, False):
        cfg = TrainConfig(batch_size=B, compute_dtype=compute_dtype, eval_vmap_batches=batched)
        outs.append(StepFunctions(configs()[1], cfg, device="cpu").eval_epoch(
            port_params(weights), test.to_device("cpu"), idx, w, EPS, None, dp_noise=noise))
    tol = dict(rtol=1e-5, atol=1e-6) if compute_dtype == "float32" else dict(rtol=2.0 ** -7,
                                                                           atol=1e-3)
    for a, b in zip(*outs):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, **tol)
        else:
            assert torch.equal(a, b)
    assert outs[0][0].dim() == 0 and tuple(outs[0][2].shape) == (8,)
