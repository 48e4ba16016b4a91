"""The port's fusion model (models/fusion.py, models/convert.py) against the
JAX package: one weight set for both, carried across by ``params_from_jax``,
the DP noise handed across (threefry cannot be reproduced), dropout off. Tolerance for the whole forward: rtol 1e-4 /
atol 1e-5 (f32, matmul sums in another order)."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models.convert import params_from_jax, params_to_numpy
from eeg_multimodal_torch.ops import dp_fused
from eeg_multimodal_torch.utils.trees import tree_items

TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(vocab_size=50, hidden_size=768, num_layers=1, num_heads=12,
            intermediate_size=64, max_position_embeddings=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(fused):
    jc = dataclasses.replace(JF.config_for("ti", "lapacian_dropout"),
                             bert_config=JB.BertConfig(**TINY), fused_dp_kernel=fused)
    tc = dataclasses.replace(TF.config_for("ti", "lapacian_dropout"),
                             bert_config=TB.BertConfig(**TINY), fused_dp_kernel=fused)
    return jc, tc


def batch_np(b=4, s=8, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    mask[1, 5:] = 0
    mask[3, 2:] = 0
    return {
        "eeg_input": rng.randint(0, 50, (b, s)).astype(np.int32),
        "eeg_mask": mask,
        "act_input": rng.randn(b, 1, 512).astype(np.float32),
        "act_mask": np.ones((b, 1), np.int32),
        "labels": rng.randint(0, 2, (b,)).astype(np.int32),
    }


def to_port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def jax_dp_noise(rng, shape, fused):
    """The DP noise JAX's apply draws from ``rng`` (fusion.split_rng layout)."""
    _, k_dp = JF.split_rng(rng)
    if fused:  # dp_pallas._reference_impl's draw for the kernel's seed
        seed = jax.random.randint(k_dp, (1,), 0, 2**31 - 1, jnp.int32)
        key = jax.random.PRNGKey(seed.reshape(()).astype(jnp.uint32))
    else:  # ops/dp.py lap_dropout: split(k_dp)[0]
        key = jax.random.split(k_dp)[0]
    return np.array(jax.random.laplace(key, shape))


@pytest.fixture(scope="module")
def jax_params():
    """One weight set for both sides (drawn by the port's init, which is
    cheaper here than JAX's; the round-trip test below covers JAX's tree)."""
    tree = params_to_numpy(TF.init(configs(True)[1], seed=0, device="cpu"))
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("fused", [True, False])
def test_fusion_forward_matches_jax(jax_params, fused):
    jc, tc = configs(fused)
    batch = batch_np()
    rng = jax.random.PRNGKey(1)
    want = jax.jit(lambda p, b: JF.apply(p, b, jc, 0.5, True, rng, train=False))(
        jax_params, jax.tree_util.tree_map(jnp.asarray, batch))
    noise = jax_dp_noise(rng, (4, tc.concat_width), fused)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), tc, device="cpu")
    got = TF.apply(params, to_port_batch(batch), tc, 0.5, True, None, False,
                   dp_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_features_match_jax(jax_params):
    jc, tc = configs(True)
    batch = batch_np(seed=1)
    enc_keys, _ = JF.split_rng(None)
    want = jax.jit(lambda p, b: JF.encode_features(p, b, jc, enc_keys, train=False))(
        jax_params, jax.tree_util.tree_map(jnp.asarray, batch))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), tc, device="cpu")
    got = TF.encode_features(params, to_port_batch(batch), tc, None, train=False)
    assert got.dtype == torch.float32 and got.shape == (4, 2304)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_jax_round_trips_the_flagship_tree():
    """The full flagship tree (BERT-base, 3 decoder layers, F = 2304)
    crosses leaf for leaf, and has the structure of the port's own init."""
    cfg_j = JF.config_for("ti", "lapacian_dropout")
    cfg_t = TF.config_for("ti", "lapacian_dropout")
    tree = jax.tree_util.tree_map(np.asarray, JF.init(jax.random.PRNGKey(0), cfg_j))
    params = params_from_jax(tree, cfg_t, device="cpu")
    back = params_to_numpy(params)
    want, got = dict(tree_items(tree)), dict(tree_items(back))
    assert got.keys() == want.keys() and len(got) > 200
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    shapes = {k: tuple(v.shape) for k, v in tree_items(TF.init(cfg_t, seed=0, device="cpu"))}
    assert shapes == {k: v.shape for k, v in want.items()}


def test_params_from_jax_refuses_a_tree_of_another_config(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    with pytest.raises(ValueError, match="bert/embeddings/word"):
        params_from_jax(tree, TF.config_for("ti", "lapacian_dropout"), device="cpu")


def test_config_for_matches_jax_and_unported_configs_are_refused():
    """``config_for`` gives the JAX package's fields for every combination;
    every class of the JAX package's list (tests/test_fusion.py:115-128)
    inits with its leaf names and shapes (a tiny BERT); a configuration
    neither package has is refused."""
    for mt, dp, cross in itertools.product(
            ("ti", "tt", "it", "ii"),
            ("lapacian_dropout", "NDP", "DPSGD", "lapacian_dropout_equal_weight"),
            ("double_stream", "single_stream")):
        j, t = JF.config_for(mt, dp, cross), TF.config_for(mt, dp, cross)
        fields = ("name", "multimodal_type", "cross_atn_type", "dp_mode",
                  "with_cross_attention", "use_key_padding_masks", "dropout_rate",
                  "gumbel_tau", "n_streams_txt", "uses_bert", "uses_visual")
        assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
        assert t.fused_dp_kernel is False and not j.fused_dp_kernel
        assert t.concat_width == j.concat_width
    for mt, dp, cross in (("ti", "lapacian_dropout", "double_stream"),
                          ("tt", "lapacian_dropout", "double_stream"),
                          ("it", "lapacian_dropout", "double_stream"),
                          ("ii", "lapacian_dropout", "double_stream"),
                          ("ti", "lapacian_dropout", "single_stream"),
                          ("ti", "DPSGD", "double_stream"),
                          ("ti", "NDP", "double_stream"),
                          ("ti", "lapacian_dropout_equal_weight", "double_stream"),
                          ("ti", "feature_all_lap", "double_stream")):
        j = dataclasses.replace(JF.config_for(mt, dp, cross), bert_config=JB.BertConfig(**TINY))
        t = dataclasses.replace(TF.config_for(mt, dp, cross), bert_config=TB.BertConfig(**TINY))
        want = {path: leaf.shape for path, leaf in tree_items(
            jax.tree_util.tree_map(np.asarray, JF.init(jax.random.PRNGKey(0), j)))}
        got = {path: tuple(leaf.shape) for path, leaf in tree_items(TF.init(t, seed=0,
                                                                            device="cpu"))}
        assert got == want, t.name
    with pytest.raises(ValueError, match="post-fix"):
        TF.FusionConfig(prefix_eps_hat=True, fused_dp_kernel=True)
    for bad in (dict(multimodal_type="tx"), dict(dp_mode="laplace")):
        with pytest.raises(ValueError, match="unknown"):
            TF.FusionConfig(**bad)
    assert TF.dp_param_predicate("DP") and not TF.dp_param_predicate("fc1/kernel")


def test_dp_noise_is_drawn_on_every_forward():
    _, tc = configs(True)
    params = TF.init(tc, seed=3, device="cpu")
    batch = to_port_batch(batch_np())
    gen = torch.Generator().manual_seed(0)
    a = TF.apply(params, batch, tc, 1.0, True, gen, False)
    b = TF.apply(params, batch, tc, 1.0, True, gen, False)
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        TF.apply(params, batch, tc, 1.0, True, None, False)


def test_fused_head_draws_laplace_plain_of_the_generators_seed():
    """Out of training the fused path draws one thing from ``gen``, the DP
    seed, and its noise is ``laplace_plain(seed)``, as on the card: a twin
    generator recovers the seed, and the noise it gives reproduces the
    logits exactly."""
    _, tc = configs(True)
    params = TF.init(tc, seed=3, device="cpu")
    batch = to_port_batch(batch_np())
    got = TF.apply(params, batch, tc, 1.0, True, torch.Generator().manual_seed(7), False)
    seed = torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(7))
    noise = dp_fused.laplace_plain(int(seed), (4, tc.concat_width))
    assert torch.equal(got, TF.apply(params, batch, tc, 1.0, True, None, False, dp_noise=noise))
