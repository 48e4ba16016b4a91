"""One faithful alternating step of the port at the untruncated S = 512
against the JAX package, on the CPU: BERT's self-attention runs through
``fused_attention`` (the kernels' plain versions here) against the Pallas
kernel in interpret mode. Dropout is off and the DP noise handed across, as
threefry cannot be reproduced. Tolerance: rtol 1e-4 / atol 1e-5 for the
loss, the gradients and the Adam step (f32, sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_torch.ops import attention as TA
from eeg_multimodal_torch.ops import dp_fused
from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig
from eeg_multimodal_torch.utils.trees import tree_items
from test_torch_api import EPS, JCFG, PCFG, port_params, rows, weights  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_faithful_step_at_512_tokens_matches_jax(weights):
    B = 2
    data = rows(B, seed=1)
    jb = {k: jnp.asarray(getattr(data, k)) for k in
          ("eeg_input", "eeg_mask", "act_input", "act_mask", "labels")}
    weight = np.ones(B, np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    jp = jax.tree_util.tree_map(jnp.asarray, weights)

    def noise(rng):  # the fused DP block's draw for a forward keyed by rng
        seed = jax.random.randint(JF.split_rng(rng)[1], (1,), 0, 2**31 - 1, jnp.int32)
        key = jax.random.PRNGKey(seed.reshape(()).astype(jnp.uint32))
        return np.array(jax.random.laplace(key, (B, PCFG.concat_width)))

    def loss(params, rng, hard):  # JAX's two phases (trainer.py:292-321), dropout off
        logits = JF.apply(params, jb, JCFG, EPS, hard, rng, train=False)
        return JM.cal_loss(logits, jb["labels"], jnp.asarray(weight))[:2]

    rest = {k: v for k, v in jp.items() if k != "DP"}
    opt = optax.adam(1e-6)
    g_dp = jax.jit(jax.grad(lambda dp, r: loss({**r, "DP": dp}, k1, False)[0]))(
        jp["DP"], rest)
    dp1 = optax.apply_updates(jp["DP"], opt.update(g_dp, opt.init(jp["DP"]))[0])
    (j_loss, _), g = jax.jit(jax.value_and_grad(
        lambda r, dp: loss({**r, "DP": dp}, k2, True), has_aux=True))(rest, dp1)
    rest1 = optax.apply_updates(rest, opt.update(g, opt.init(rest))[0])

    steps = StepFunctions(PCFG, TrainConfig(batch_size=B), device="cpu")
    params = port_params(weights)
    dp_os, model_os = steps.init_opt_states(params)
    launches = [k.launches for k in TA.KERNELS + dp_fused.KERNELS]
    dp_os, model_os, p_loss, _ = steps.train_step(
        params, dp_os, model_os, data.to_device("cpu"), torch.from_numpy(weight), EPS,
        torch.Generator().manual_seed(0),
        dp_noise=(torch.from_numpy(noise(k1)), torch.from_numpy(noise(k2))), dropout=False)
    assert [k.launches for k in TA.KERNELS + dp_fused.KERNELS] == launches  # CPU: no kernel

    np.testing.assert_allclose(float(p_loss), float(j_loss), **TOL)
    np.testing.assert_allclose(dp_os.mu[0].numpy() / 0.1, np.asarray(g_dp), **TOL)
    grads = dict(tree_items(jax.tree_util.tree_map(np.asarray, g)))
    paths = [p for p, _ in tree_items(params) if p != "DP"]
    for path, mu in zip(paths, model_os.mu):
        np.testing.assert_allclose(mu.numpy() / 0.1, grads[path], err_msg=path, **TOL)
    q_grad = grads["bert/layers/0/attn/query/kernel"]
    assert np.abs(q_grad).max() > 1e-6  # the attention backward is not vacuous
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, {**rest1, "DP": dp1})))
    for path, leaf in tree_items(params):
        np.testing.assert_allclose(leaf.numpy(), want[path], err_msg=path, **TOL)
