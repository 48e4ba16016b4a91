"""The port's model zoo (models/fusion.py, the encoder in models/layers.py,
the single-optimizer step, checkpoints, ``params_from_jax``) against the JAX
package, on the CPU, at a tiny BERT (hidden 768, one layer), batch 3.

One weight set for both sides, drawn by the port's init; each class's DP
draw rebuilt from the JAX forward's key layout and handed to the port;
dropout off. Tolerance: rtol 1e-4 / atol 1e-5 for logits, gradients and the
Adam step (f32, matmul sums in another order), as test_torch_fusion.py. The
bf16 streams against the yardstick of JAX's own bf16 distance from its f32
forward (test_torch_bf16.py).
"""
import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.models import layers as JL
from eeg_multimodal_tpu.train import checkpoint as JCK
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_tpu.train.trainer import StepFunctions as JSteps
from eeg_multimodal_tpu.train.trainer import TrainConfig as JTrainConfig
from eeg_multimodal_tpu.utils.trees import tree_cast as jax_cast
from eeg_multimodal_torch.data import datasets as TD
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models import layers as TL
from eeg_multimodal_torch.models.convert import params_from_jax, params_to_numpy
from eeg_multimodal_torch.ops import dp as TDP
from eeg_multimodal_torch.train import api as TAPI
from eeg_multimodal_torch.train import checkpoint as TCK
from eeg_multimodal_torch.train import metrics as TM
from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig, Trainer
from eeg_multimodal_torch.utils.trees import tree_cast, tree_items, tree_map
from test_torch_bf16 import within_yardstick

TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(vocab_size=50, hidden_size=768, num_layers=1, num_heads=12,
            intermediate_size=64, max_position_embeddings=16)
B, S_EEG, S_ACT, EPS = 3, 8, 6, 0.5
# the JAX package's class list (tests/test_fusion.py:115-128)
CLASSES = [
    ("ti", "lapacian_dropout", "double_stream"),
    ("tt", "lapacian_dropout", "double_stream"),
    ("it", "lapacian_dropout", "double_stream"),
    ("ii", "lapacian_dropout", "double_stream"),
    ("ti", "lapacian_dropout", "single_stream"),
    ("ti", "DPSGD", "double_stream"),
    ("ti", "NDP", "double_stream"),
    ("ti", "lapacian_dropout_equal_weight", "double_stream"),
    ("ti", "feature_all_lap", "double_stream"),
]
TRAINABLE = [c for c in CLASSES if c[1] != "DPSGD"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ids(c):
    return "-".join(c)


def configs(mt, dp, cross, **kw):
    jc = dataclasses.replace(JF.config_for(mt, dp, cross), bert_config=JB.BertConfig(**TINY),
                             **kw)
    tc = dataclasses.replace(TF.config_for(mt, dp, cross), bert_config=TB.BertConfig(**TINY),
                             **kw)
    return jc, tc


def pairing(mt, n=B, seed=0):
    """``n`` rows of the ``mt`` pairing, made with numpy and paired as the
    reference's datasets pair them (the faithful ``tt`` act stream: its
    attention mask as ids). EEG tokens S = 8, act tokens S = 6, each with
    padded rows."""
    rng = np.random.RandomState(seed)

    def txt(s):
        mask = np.ones((n, s), np.int32)
        mask[1, s - 3:] = 0
        mask[-1, 2:] = 0
        return {"input_ids": rng.randint(0, 50, (n, s)).astype(np.int32) * mask,
                "attention_mask": mask}

    kw = {("eeg_txt" if mt[0] == "t" else "eeg_img"):
          txt(S_EEG) if mt[0] == "t" else rng.randn(n, 512).astype(np.float32),
          ("act_txt" if mt[1] == "t" else "act_img"):
          txt(S_ACT) if mt[1] == "t" else rng.randn(n, 512).astype(np.float32)}
    return TD.build_pairing(mt, rng.randint(0, 2, n).astype(np.int32), **kw)


def jax_batch(a):
    return {k: jnp.asarray(v) for k, v in port_batch(a).items()}


def port_batch(a):
    return a.to_device("cpu")


def head_noise(cfg, rng):
    """The DP draw JAX's apply makes from ``rng`` (fusion.split_rng and
    ops/dp.py there), as the port's ``dp_noise``: the (B, F) Laplace(0, 1)
    of the learned block, the (B, 1) one of the per-sample heads."""
    _, k_dp = JF.split_rng(rng)
    if cfg.dp_mode == "lapacian_dropout":
        return torch.from_numpy(np.array(jax.random.laplace(
            jax.random.split(k_dp)[0], (B, cfg.concat_width))))
    if cfg.dp_mode == "lapacian_dropout_equal_weight":
        return torch.from_numpy(np.array(jax.random.laplace(jax.random.split(k_dp)[1], (B, 1))))
    if cfg.dp_mode == "feature_all_lap":
        return torch.from_numpy(np.array(jax.random.laplace(k_dp, (B, 1))))
    return None


def weights(tc):
    return params_to_numpy(TF.init(tc, seed=0, device="cpu"))


def port_params(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


WEIGHT = np.array([1, 1, 0], np.float32)  # the batch's row weights: a padded last row
KEY = jax.random.split(jax.random.PRNGKey(7))[1]  # a step's phase-2 key, k2


def port_grads(forward, tree, labels):
    """(logits, {path: gradient}) of ``forward(params)``'s weighted
    cross-entropy (train/metrics.py::cal_loss) over the test batch."""
    params = tree_map(lambda t: t.requires_grad_(), port_params(tree))
    logits = forward(params)
    paths, leaves = zip(*tree_items(params))
    loss = TM.cal_loss(logits, labels, torch.from_numpy(WEIGHT))[0]
    return logits.detach().numpy(), {p: g.numpy() for p, g in zip(paths, torch.autograd.grad(
        loss, leaves))}


@functools.lru_cache(maxsize=None)
def jax_references():
    """JAX's side for every class of CLASSES on its test batch, at phase
    2's key: ``StepFunctions.loss_fn`` (hard, dropout off) and its gradient,
    shared by the forward test and the step test. The nine programs are
    traced one after another and compiled together on a thread pool (XLA
    compiles outside the interpreter lock), which takes about half the
    time of nine compiles in a row. Returns {class: (the JAX
    StepFunctions, the params, loss, accuracy, logits, the gradient
    tree)}."""
    programs = {}
    for cls in CLASSES:
        jc, tc = configs(*cls)
        jsteps = JSteps(jc, JTrainConfig(batch_size=B))
        jp = jax.tree_util.tree_map(jnp.asarray, weights(tc))
        jb = jax_batch(pairing(cls[0]))

        def loss(p, jsteps=jsteps, jb=jb):
            return jsteps.loss_fn(p, jb, jnp.asarray(WEIGHT), EPS, KEY, True, False)

        programs[cls] = jsteps, jp, jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(jp)
    with ThreadPoolExecutor(len(programs)) as pool:
        compiled = dict(zip(programs, pool.map(lambda v: v[2].compile(), programs.values())))
    out = {}
    for cls, (jsteps, jp, _) in programs.items():
        (loss, (acc, _, logits)), g = compiled[cls](jp)
        out[cls] = jsteps, jp, float(loss), float(acc), np.asarray(logits), g
    return out


def jax_reference(cls):
    return jax_references()[cls]


def by_path(tree):
    return dict(tree_items(jax.tree_util.tree_map(np.asarray, tree)))


def jax_grads(forward, tree, labels):
    """:func:`port_grads` on the JAX side (train/metrics.py::cal_loss there)."""
    def loss(p):
        logits = forward(p)
        return JM.cal_loss(logits, labels, jnp.asarray(WEIGHT))[0], logits

    (_, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return np.asarray(logits), dict(tree_items(jax.tree_util.tree_map(np.asarray, g)))


def assert_grads(got, want):
    (logits, g), (wl, wg) = got, want
    np.testing.assert_allclose(logits, wl, **TOL)
    assert sorted(g) == sorted(wg)
    for path in wg:
        np.testing.assert_allclose(g[path], wg[path], err_msg=path, **TOL)
    assert max(np.abs(v).max() for v in wg.values()) > 1e-3  # not vacuous


# -- every class: forward and gradients ----------------------------------------

@pytest.mark.parametrize("cls", CLASSES, ids=ids)
def test_class_logits_and_every_gradient_match_jax(cls):
    jc, tc = configs(*cls)
    tree = weights(tc)
    pb = port_batch(pairing(cls[0]))
    noise = head_noise(jc, KEY)
    got = port_grads(lambda p: TF.apply(p, pb, tc, EPS, True, None, False, dp_noise=noise), tree,
                     pb["labels"])
    logits, g = jax_reference(cls)[4:]
    assert_grads(got, (logits, by_path(g)))
    if tc.dp_mode in ("lapacian_dropout", "lapacian_dropout_equal_weight", "feature_all_lap"):
        with pytest.raises(ValueError, match="generator"):
            TF.apply(port_params(tree), pb, tc, EPS, True, None, False)


def test_pri_gumbel_head_matches_jax():
    """The legacy head (train_val.py:125-158) out of training, so with
    dropout off: the hard Gumbel gate (its straight-through gradient) over
    the handed-in (768, 2) draw, then the per-sample Laplace (B, 1) draw.
    The soft gate is held in test_torch_dp_modes.py."""
    jc, tc = configs("ti", "NDP", "double_stream")
    tree = params_to_numpy(TF.legacy_pri_gumbel_init(tc, seed=0, device="cpu"))
    assert tree["w"].shape == (768,) and 0.0 <= tree["w"].min() and tree["w"].max() < 1.0
    data = pairing("ti")
    rng = jax.random.PRNGKey(3)
    k_gum, k_lap = jax.random.split(rng, 5)[3:]
    gum = torch.from_numpy(np.array(jax.random.gumbel(k_gum, (768, 2))))
    lap = torch.from_numpy(np.array(jax.random.laplace(k_lap, (B, 1))))
    jb, pb = jax_batch(data), port_batch(data)
    # train=False on the JAX side turns dropout off and takes the hard gate;
    # the port takes the same gate with gen=None and the draws handed in
    got = port_grads(lambda p: TF.legacy_pri_gumbel_apply(p, pb, tc, EPS, 0.1, None, False,
                                                          gumbel=gum, lap_noise=lap), tree,
                     pb["labels"])
    want = jax_grads(lambda p: JF.legacy_pri_gumbel_apply(p, jb, jc, EPS, 0.1, rng, False), tree,
                     jb["labels"])
    assert_grads(got, want)
    with pytest.raises(ValueError, match="legacy_pri_gumbel_apply"):
        TF.apply(port_params(tree), pb, dataclasses.replace(tc, dp_mode="pri_gumbel"), EPS,
                 True, torch.Generator(), False)


def test_pri_gumbel_tau_defaults_to_the_config():
    """Without ``tau`` the PriGumbel head runs at ``config.gumbel_tau``: the
    same logits and gradients as that value passed in, and another ``w``
    gradient at another temperature (the hard gate's straight-through
    gradient is the soft gate's)."""
    _, tc = configs("ti", "NDP", "double_stream")
    tree = params_to_numpy(TF.legacy_pri_gumbel_init(tc, seed=0, device="cpu"))
    pb = port_batch(pairing("ti"))
    gum = TDP.gumbel_noise((768, 2), torch.Generator().manual_seed(1), "cpu")
    lap = torch.from_numpy(np.random.RandomState(2).laplace(size=(B, 1)).astype(np.float32))

    def run(cfg, **kw):
        return port_grads(lambda p: TF.legacy_pri_gumbel_apply(
            p, pb, cfg, EPS, gumbel=gum, lap_noise=lap, **kw), tree, pb["labels"])

    for tau in (0.1, 0.7):
        cfg = dataclasses.replace(tc, gumbel_tau=tau)
        (logits, g), (want_logits, want_g) = run(cfg), run(cfg, tau=tau)
        assert np.array_equal(logits, want_logits)
        assert all(np.array_equal(g[k], want_g[k]) for k in want_g)
    assert not np.allclose(run(tc)[1]["w"], run(tc, tau=0.7)[1]["w"])


def test_train_on_keeps_the_jax_signature():
    """``train_on`` takes the JAX package's arguments and no others (a
    setting beyond them goes through ``run_configs``)."""
    import inspect

    from eeg_multimodal_tpu.train import api as JAPI

    port = inspect.signature(TAPI.TrainAndTest.train_on).parameters
    jax_ = inspect.signature(JAPI.TrainAndTest.train_on).parameters
    assert list(port) == list(jax_)
    assert all(port[k].default == jax_[k].default for k in jax_)


def test_return_features_is_the_normalized_concat():
    """The feature-weight extraction's forward returns the min-max
    normalized concat (fusion.py:301-304 there), the DP block not applied."""
    _, tc = configs("tt", "lapacian_dropout", "double_stream")
    params, pb = port_params(weights(tc)), port_batch(pairing("tt"))
    got = TF.apply(params, pb, tc, EPS, True, None, False, return_features=True)
    want = TF.encode_features(params, pb, tc, None, False)
    assert got.shape == (B, 2304) and torch.equal(got.amin(1), torch.zeros(B))
    assert torch.equal(got, (want - want.amin(1, keepdim=True))
                       / (want.amax(1, keepdim=True) - want.amin(1, keepdim=True)))


# -- the encoder ----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_encoder_matches_jax(masked):
    params = TL.encoder_init(torch.Generator().manual_seed(0), 768, 3, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(params["layers"][0]),
                                                          tree_items(params["layers"][2])))
    tree = params_to_numpy(params)
    src = np.random.RandomState(1).randn(B, 5, 768).astype(np.float32)
    kpm = np.zeros((B, 5), bool)
    kpm[1, 3:] = True
    mask = kpm if masked else None
    got = TL.encoder(port_params(tree), torch.from_numpy(src), 12,
                     src_key_padding_mask=None if mask is None else torch.from_numpy(mask))
    want = jax.jit(lambda p, x: JL.encoder(p, x, 12, None if mask is None else jnp.asarray(mask)))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jtree = jax.tree_util.tree_map(np.asarray, JL.encoder_init(jax.random.PRNGKey(0), 768, 3))
    assert {p: v.shape for p, v in tree_items(jtree)} == {p: v.shape for p, v in tree_items(tree)}


# -- the bf16 dtype trails ---------------------------------------------------------

@pytest.mark.parametrize("cls", [("tt", "lapacian_dropout", "double_stream"),
                                 ("it", "lapacian_dropout", "double_stream"),
                                 ("ti", "lapacian_dropout", "single_stream")], ids=ids)
def test_bf16_streams_keep_the_jax_dtypes_within_the_yardstick(cls):
    """Under the bf16 cast: ``tt``'s decoder runs in bf16 (both streams are
    BERT's), ``it``'s in f32 (an f32 image query over a bf16 memory), TISC's
    encoder in f32 (the bf16 EEG mean beside the f32 act embedding); the
    concat and the logits are f32, the logits within 2x JAX's own bf16
    distance from its f32 forward."""
    jc, tc = configs(*cls)
    tree = weights(tc)
    data = pairing(cls[0])
    jb, pb = jax_batch(data), port_batch(data)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    p16 = tree_cast(port_params(tree), torch.bfloat16)

    feat_a, seq_a, feat_b, seq_b = TF._encode_streams(p16, pb, tc, None)
    want_dtypes = {"tt": (torch.bfloat16, torch.bfloat16), "it": (torch.float32, torch.bfloat16),
                   "ti": (torch.bfloat16, torch.float32)}[cls[0]]
    assert (seq_a.dtype, seq_b.dtype) == want_dtypes
    if cls[2] == "double_stream":
        tgt, memory = (seq_b, seq_a) if cls[0] == "tt" else (seq_a, seq_b)
        cross = TL.decoder(p16["cross"], tgt, memory, 12)
        assert cross.dtype == (torch.bfloat16 if cls[0] == "tt" else torch.float32)
    assert TF.encode_features(p16, pb, tc, None, train=False).dtype == torch.float32

    j16 = jax.jit(lambda p: JF.apply(p, jb, jc, EPS, True, KEY, train=False))(
        jax_cast(jp, jnp.bfloat16))
    logits = TF.apply(p16, pb, tc, EPS, True, None, False, dp_noise=head_noise(jc, KEY))
    assert logits.dtype == torch.float32
    within_yardstick("logits", logits, j16, jax_reference(cls)[4])  # JAX's f32 logits


# -- the single-optimizer step -------------------------------------------------------

@pytest.mark.parametrize("cls", [("ti", "NDP", "double_stream"),
                                 ("ti", "lapacian_dropout_equal_weight", "double_stream")],
                         ids=ids)
def test_single_optimizer_step_matches_jax(cls):
    """One step of a class without ``DP``: JAX's ``StepFunctions.loss_fn``
    at phase 2's key (k2) with dropout off, and its model optimizer; the
    port's ``train_step`` with the equal-weight noise of that key handed in.
    (Dropout off takes the equal-weight mask out, as a rate of 0 would.)"""
    jc, tc = configs(*cls)
    jsteps, jp, j_loss, j_acc, _, g = jax_reference(cls)
    dp_os, model_os = jsteps.init_opt_states(jp)
    assert dp_os is None
    stepped = jax.jit(lambda g, os_, p: optax.apply_updates(p, jsteps.model_opt.update(g, os_,
                                                                                      p)[0]))
    want, grads = by_path(stepped(g, model_os, jp)), by_path(g)

    steps = StepFunctions(tc, TrainConfig(batch_size=B), device="cpu")
    params = port_params(weights(tc))
    p_dp_os, p_model_os = steps.init_opt_states(params)
    assert p_dp_os is None and not steps.has_dp_param
    p_dp_os, p_model_os, loss, acc = steps.train_step(
        params, None, p_model_os, port_batch(pairing(cls[0])), torch.from_numpy(WEIGHT), EPS,
        torch.Generator().manual_seed(0), dp_noise=(None, head_noise(jc, KEY)), dropout=False)
    assert p_dp_os is None
    np.testing.assert_allclose(float(loss), j_loss, **TOL)
    np.testing.assert_allclose(float(acc), j_acc, **TOL)
    for (path, _), mu in zip(tree_items(params), p_model_os.mu):
        np.testing.assert_allclose(mu.numpy() / 0.1, grads[path], err_msg=path, **TOL)
    for path, leaf in tree_items(params):
        np.testing.assert_allclose(leaf.numpy(), want[path], err_msg=path, **TOL)


def test_single_step_precast_copy_equals_the_in_step_cast():
    """bf16, NDP: the carried bf16 copy (refreshed after each update) and
    the in-step cast give the same params, bit for bit, over three steps
    (PyTorch keeps no excess precision at the cast); the fast modes are
    ignored without a DP leaf, as in the JAX package."""
    _, tc = configs("ti", "NDP", "double_stream")
    tree = weights(tc)
    data = port_batch(pairing("ti", n=B, seed=5))
    weight = torch.ones(B)
    runs = {}
    for name, extra in (("in-step", {}), ("precast", dict(precast_params=True)),
                        ("fast", dict(share_phase_dropout=True, paired_phase_encode=True))):
        steps = StepFunctions(tc, TrainConfig(batch_size=B, compute_dtype="bfloat16",
                                              learning_rate=1e-3, **extra), "cpu")
        assert not (steps.reuse or steps.paired)
        params = port_params(tree)
        _, model_os = steps.init_opt_states(params)
        params_c = steps.precast_copy(params) if steps.precast else None
        gen = torch.Generator().manual_seed(3)
        for _ in range(3):
            _, model_os, loss, _ = steps.train_step(params, None, model_os, data, weight, EPS,
                                                    gen, params_c=params_c)
        if params_c is not None:
            assert all(torch.equal(c, p.to(torch.bfloat16)) for (_, c), (_, p) in zip(
                tree_items(params_c), tree_items(params)))
        runs[name] = params
    for name in ("precast", "fast"):
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(runs[name]),
                                                              tree_items(runs["in-step"])))


# -- checkpoints and the JAX tree ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def class_trees(cls):
    """(JAX config, port config, the JAX package's init tree as numpy) for a
    class of CLASSES, or the PriGumbel head's ("pri_gumbel")."""
    if cls == "pri_gumbel":
        jc, tc = configs("ti", "NDP", "double_stream")
        return jc, tc, jax.tree_util.tree_map(
            np.asarray, JF.legacy_pri_gumbel_init(jax.random.PRNGKey(0), jc))
    jc, tc = configs(*cls)
    return jc, tc, jax.tree_util.tree_map(np.asarray, JF.init(jax.random.PRNGKey(0), jc))


@pytest.mark.parametrize("cls", CLASSES + ["pri_gumbel"],
                         ids=lambda c: c if isinstance(c, str) else ids(c))
def test_state_dict_both_ways_matches_jax(cls):
    """The port writes the JAX package's state dict, key for key and value
    for value (``DP``, ``w``, BERT, the visual encoder, the decoder or the
    encoder with its prototype layer, as the class has them), and reads the
    JAX package's back into the same tree."""
    jc, tc, jtree = class_trees(cls)
    params = params_from_jax(jtree, tc, device="cpu")
    want = JCK.fusion_to_torch_state_dict(jtree, jc)
    got = TCK.fusion_to_torch_state_dict(params, tc)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    leaves = dict(tree_items(params))
    prefixed = {"_module." + k: v for k, v in want.items()}  # Opacus
    for sd in (want, prefixed):
        back = dict(tree_items(TCK.fusion_from_torch_state_dict(sd, tc, device="cpu")))
        assert back.keys() == leaves.keys()
        assert all(torch.equal(back[p], leaves[p]) for p in leaves)


@pytest.mark.parametrize("cls", CLASSES + ["pri_gumbel"],
                         ids=lambda c: c if isinstance(c, str) else ids(c))
def test_params_from_jax_takes_each_class_tree(cls):
    """The JAX package's init tree of each class crosses leaf for leaf, with
    the structure of the port's own init; a tree of another class is
    refused."""
    jc, tc, jtree = class_trees(cls)
    params = params_from_jax(jtree, tc, device="cpu")
    want, got = dict(tree_items(jtree)), dict(tree_items(params_to_numpy(params)))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    own = (TF.legacy_pri_gumbel_init(tc, 0, "cpu") if cls == "pri_gumbel"
           else TF.init(tc, 0, "cpu"))
    assert {p: tuple(v.shape) for p, v in tree_items(own)} == {k: v.shape
                                                               for k, v in want.items()}
    other = configs("ii", "NDP", "double_stream")[1] if tc.uses_bert else \
        configs("ti", "lapacian_dropout", "double_stream")[1]
    with pytest.raises(ValueError, match="parts"):
        params_from_jax(jtree, other, device="cpu")


# -- through the trainer and the API ------------------------------------------------------

@pytest.mark.parametrize("mt,dp_mode", [("ii", "lapacian_dropout"), ("ti", "NDP")])
def test_fit_writes_records_and_the_checkpoint(tmp_path, mt, dp_mode):
    """``Trainer.fit`` on a class without BERT (IICA) and one without
    ``DP`` (NonPrivate): the legacy records, and the best checkpoint, which
    loads back equal to the params of its epoch."""
    _, tc = configs(mt, dp_mode, "double_stream")
    train, test = pairing(mt, n=8, seed=6), pairing(mt, n=5, seed=7)
    tr = Trainer(tc, TrainConfig(batch_size=4, epochs=2, f1_best_init=-1.0,
                                 defer_best_checkpoint=False, learning_rate=1e-3),
                 device="cpu")
    assert ("bert" in tr.params) == (mt != "ii") and ("DP" in tr.params) == (dp_mode != "NDP")
    before = {p: t.clone() for p, t in tree_items(tr.params)}
    path = str(tmp_path / "best_f1.pickle")
    snaps = {}

    def snapshot(epoch):
        snaps[epoch + 1] = [t.clone() for _, t in tree_items(tr.params)]

    res = tr.fit(train, test, EPS, log_path=str(tmp_path / "logs"), model_path=path, echo=False,
                 epoch_end_hook=snapshot)
    assert [r["epoch"] for r in res["history"]] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["test_loss"])
               for r in res["history"])
    assert any(not torch.equal(t, before[p]) for p, t in tree_items(tr.params))
    assert os.path.exists(tmp_path / "logs" / "whole_record.txt")
    loaded = TCK.load_torch_checkpoint(path, tc, "cpu")
    assert [p for p, _ in tree_items(loaded)] == list(before)
    assert all(torch.equal(a, b) for (_, a), b in zip(tree_items(loaded),
                                                      snaps[res["best"]["epoch"]]))


@pytest.mark.parametrize("mt,dp_mode", [("ii", "lapacian_dropout"), ("tt", "NDP")])
def test_cycle_equals_run_epoch_rows_without_bert_or_dp(mt, dp_mode):
    """``StepFunctions.cycle`` over K = 2 epochs on a tree without BERT and
    on one without ``DP`` (two BERT streams): the rows and params of two
    ``run_epoch`` calls, exactly."""
    _, tc = configs(mt, dp_mode, "double_stream")
    train, test = pairing(mt, n=8, seed=10), pairing(mt, n=5, seed=11)
    cfg = TrainConfig(batch_size=4, learning_rate=1e-3)
    train_dev, test_dev = port_batch(train), port_batch(test)
    by_epoch = Trainer(tc, cfg, device="cpu")
    rows = [by_epoch.run_epoch(e, train_dev, test_dev, 8, 5, EPS) for e in range(2)]
    cycled = Trainer(tc, cfg, device="cpu")
    cycled.dp_os, cycled.model_os, out = cycled.steps.cycle(
        cycled.params, cycled.dp_os, cycled.model_os, train_dev, test_dev,
        *cycled.cycle_inputs(range(2), 8, 5), EPS)
    assert out.tolist() == [[row[k] for k in ("train_loss", "train_acc", "test_loss",
                                              "test_acc", "f1")] for row in rows]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(cycled.params),
                                                          tree_items(by_epoch.params)))
    assert (cycled.dp_os is None) == (dp_mode == "NDP")


def write_split(root, split, data: TD.MultiModalArrays):
    """A split in the reference's on-disk layout, whichever its streams."""
    import pickle

    processed = root / "data" / "processed"
    processed.mkdir(parents=True, exist_ok=True)
    (processed / f"{split}_label.csv").write_text(
        "label\n" + "".join(f"{x}\n" for x in data.labels))
    for modal, kind, x, m, sub in (("EEG", data.multimodal_type[0], data.eeg_input,
                                    data.eeg_mask, "bert_bert_base_uncased"),
                                   ("act", data.multimodal_type[1], data.act_input,
                                    data.act_mask, "clip_ViT_B_32")):
        obj = ([{"input_ids": i[None], "attention_mask": k[None]} for i, k in zip(x, m)]
               if kind == "t" else x[:, 0, :])
        path = root / "data" / "embedding" / modal / ("txt" if kind == "t" else "img") / sub
        path.mkdir(parents=True, exist_ok=True)
        with open(path / f"{split}.pickle", "wb") as f:
            pickle.dump(obj, f)


class FusedRun(TAPI.TrainAndTest):
    """``TrainAndTest`` through its ``run_configs`` hook: the DP block fused
    where the class has one, and the F1 threshold below any F1, so that
    one epoch of random weights writes its checkpoint (the reference
    starts it at 0.5, base_train.py:164)."""

    def run_configs(self, fusion_cfg, train_cfg):
        fused = fusion_cfg.dp_mode == "lapacian_dropout"
        return (dataclasses.replace(fusion_cfg, fused_dp_kernel=fused),
                dataclasses.replace(train_cfg, f1_best_init=-1.0))


@pytest.mark.parametrize("cls", TRAINABLE, ids=ids)
def test_train_on_and_predict_run_every_class(tmp_path, cls):
    """``TrainAndTest.train_on`` (bf16 default, compact vocab where there is
    text, the settings of ``run_configs``) writes the best checkpoint, and
    ``predict`` serves it; DPSGD alone stays refused (test_torch_api.py)."""
    mt, dp_mode, cross = cls
    bert = TB.BertConfig(**TINY)
    train, test = pairing(mt, n=8, seed=8), pairing(mt, n=6, seed=9)
    write_split(tmp_path, "test", test)
    api = FusedRun(batch_size=4, epochs=1, data_root=str(tmp_path), echo=False, device="cpu")
    res = api.train_on(train, test, "DPMLD", "zoo/", mt, dp_mode, cross_atn_type=cross,
                       bert_config=bert, compact_vocab=True)
    assert np.isfinite(res["history"][0]["train_loss"]) and res["best"]["epoch"] == 1
    assert (api.trainer.vocab is not None) == ("t" in mt)
    assert api.trainer.fusion_cfg.fused_dp_kernel == (dp_mode == "lapacian_dropout")
    assert api.trainer.train_cfg.f1_best_init == -1.0
    ckpt = tmp_path / "models" / "custom" / "DPMLD" / "zoo" / "best_f1.pickle"
    out = api.predict(str(ckpt), mt, dp_mode, cross_atn_type=cross, bert_config=bert)
    assert len(out["predictions"]) == 6 and np.isfinite(out["loss"])
    assert np.isfinite(out["scores"]).all()
