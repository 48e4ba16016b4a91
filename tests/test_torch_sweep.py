"""The port's batched sweep (train/sweep.py) and its member axis
(models/layers.py, models/bert.py, ops/dp.py, ops/dp_fused.py, ops/optim.py)
on the CPU, at a tiny BERT (hidden 768, two layers), 4 rows a batch.

- One 2-member step against the JAX alternating step under ``jax.vmap``,
  on the JAX init of two keys, with each member's DP noise handed across
  and dropout off: rtol 1e-4 / atol 1e-5 for losses, gradients and the Adam
  step (f32, matmul sums in another order), as test_torch_trainer.py.
- ``SweepRunner.run`` over members that share a seed against each member's
  own ``Trainer.fit``, row for row within 1e-5 (the batched GEMMs sum in
  another order), for every class and ``dp_mode`` the runner trains, and
  with bf16 Adam moments (every member rounds with a single run's bits).
- The member axis's primitives against M separate calls: the DP block's
  plain versions bit for bit, the layers within 1e-6.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_tpu.train import sweep as JS
from eeg_multimodal_torch.data.datasets import MultiModalArrays
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models import layers as TL
from eeg_multimodal_torch.ops import dp_fused as K
from eeg_multimodal_torch.train.sweep import (MemberSteps, SweepMember, SweepRunner,
                                              privacy_utility_frontier)
from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
from eeg_multimodal_torch.utils.trees import tree_items, tree_map

TOL = dict(rtol=1e-4, atol=1e-5)
ROW_TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=50, hidden_size=768, num_layers=2, num_heads=12,
            intermediate_size=64, max_position_embeddings=16)
B, S, EPS = 4, 8, (0.1, 5.0)
ROW = ("train_loss", "train_acc", "test_loss", "test_acc", "f1")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes these small ops wait on each other: a sweep case
    took 115 s against 11 s with one thread beside five busy processes on
    eight cores (1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(mt="ti", dp="lapacian_dropout", cross="double_stream", **kw):
    jc = dataclasses.replace(JF.config_for(mt, dp, cross), bert_config=JB.BertConfig(**TINY),
                             **kw)
    tc = dataclasses.replace(TF.config_for(mt, dp, cross), bert_config=TB.BertConfig(**TINY),
                             **kw)
    return jc, tc


def arrays(n, seed, mt="ti"):
    """``n`` rows of the ``mt`` pairing, made with numpy: token streams of S
    ids (row 1 padded after 5), image streams a (1, 512) embedding."""
    rng = np.random.RandomState(seed)

    def stream(kind):
        if kind == "t":
            mask = np.ones((n, S), np.int32)
            mask[1, 5:] = 0
            return rng.randint(0, 50, (n, S)).astype(np.int32), mask
        return rng.randn(n, 1, 512).astype(np.float32), np.ones((n, 1), np.int32)

    return MultiModalArrays(*stream(mt[0]), *stream(mt[1]),
                            rng.randint(0, 2, n).astype(np.int32), mt)


def quick_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with XLA's backend optimization off:
    a third of the CPU compile time, the same values within the tests'
    tolerances."""
    lowered = jax.jit(fn).lower(*args)
    return lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def jax_batch(a: MultiModalArrays):
    return {k: jnp.asarray(v.numpy()) for k, v in a.to_device("cpu").items()}


def jax_noise(rng, F):
    """The (B, F) Laplace(0, 1) draw of the learned DP block's composed path
    in a JAX forward keyed by ``rng`` (fusion.split_rng and ops/dp.py
    there), as test_torch_zoo.py's ``head_noise``."""
    _, k_dp = JF.split_rng(rng)
    return np.array(jax.random.laplace(jax.random.split(k_dp)[0], (B, F)))


def test_member_step_matches_jax_vmap():
    """A 2-member faithful step (epsilon 0.1 and 5.0, weights from the JAX
    init under vmap over two keys, a DP row of its own each) against the JAX
    alternating step under ``jax.vmap``, per member."""
    jc, tc = configs()
    M, F = len(EPS), tc.concat_width
    tree = jax.jit(jax.vmap(lambda k: JF.init(k, jc)))(jax.random.split(jax.random.PRNGKey(3), M))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tree["DP"] = np.random.RandomState(4).randn(M, 1, F).astype(np.float32) * 0.5
    data = arrays(B, seed=1)
    weight = np.array([1, 1, 1, 0], np.float32)  # a padded last row
    k1, k2 = (jax.random.split(k, M) for k in jax.random.split(jax.random.PRNGKey(5)))
    jb, jw = jax_batch(data), jnp.asarray(weight)
    opt = optax.adam(1e-6)

    def one(params, eps, k1, k2):  # train/trainer.py:292-321 there, dropout off
        def loss(p, rng, hard):
            logits = JF.apply(p, jb, jc, eps, hard, rng, train=False)
            return JM.cal_loss(logits, jb["labels"], jw)[:2]

        rest = {k: v for k, v in params.items() if k != "DP"}
        g_dp = jax.grad(lambda dp: loss({**rest, "DP": dp}, k1, False)[0])(params["DP"])
        upd, _ = opt.update(g_dp, opt.init(params["DP"]))
        dp1 = optax.apply_updates(params["DP"], upd)
        (j_loss, j_acc), g = jax.value_and_grad(
            lambda r: loss({**r, "DP": dp1}, k2, True), has_aux=True)(rest)
        upd, _ = opt.update(g, opt.init(rest))
        return j_loss, j_acc, g_dp, g, {**optax.apply_updates(rest, upd), "DP": dp1}

    want = quick_jit(jax.vmap(one), jax.tree_util.tree_map(jnp.asarray, tree),
                     jnp.asarray(EPS, jnp.float32), k1, k2)
    j_loss, j_acc, g_dp, g, new = jax.tree_util.tree_map(np.asarray, want)

    steps = MemberSteps(tc, TrainConfig(batch_size=B), M, device="cpu")
    params = tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    dp_os, model_os = steps.init_opt_states(params)
    noise = tuple(torch.from_numpy(np.concatenate([jax_noise(k[m], F) for m in range(M)]))
                  for k in (k1, k2))
    gens = tuple(torch.Generator().manual_seed(m) for m in range(M))
    dp_os, model_os, loss, acc = steps.train_step(
        params, dp_os, model_os, data.to_device("cpu"), torch.from_numpy(weight),
        torch.tensor(EPS, dtype=torch.float64), gens, dp_noise=noise, dropout=False)

    assert loss.shape == acc.shape == (M,)
    np.testing.assert_allclose(loss.numpy(), j_loss, **TOL)
    np.testing.assert_allclose(acc.numpy(), j_acc, **TOL)
    assert not np.allclose(j_loss[0], j_loss[1])  # the members differ
    # gradients, read back from the first Adam moment: mu = (1 - b1) g
    np.testing.assert_allclose(dp_os.mu[0].numpy() / 0.1, g_dp, **TOL)
    grads = dict(tree_items(g))
    model_paths = [p for p, _ in tree_items(params) if p != "DP"]
    for path, mu in zip(model_paths, model_os.mu):
        np.testing.assert_allclose(mu.numpy() / 0.1, grads[path], err_msg=path, **TOL)
    assert max(abs(grads[p]).max() for p in grads) > 1e-3  # not vacuous
    want_leaves = dict(tree_items(new))
    for path, leaf in tree_items(params):
        np.testing.assert_allclose(leaf.numpy(), want_leaves[path], err_msg=path, **TOL)


# every class and dp_mode the runner trains (config_for's, TICA_DPSGD's class
# with the single-optimizer step, as the JAX sweep trains it), the
# flagship's DP block also fused, and the flagship with bf16 Adam moments;
# the flagship for two epochs of two steps (the states carried across), the
# fused and bf16-moment cases one of two, the other classes one step
SWEEP_CASES = [
    ("ti", "lapacian_dropout", "double_stream", {"epochs": 2}),
    ("ti", "lapacian_dropout", "double_stream", {"fused_dp_kernel": True}),
    ("tt", "lapacian_dropout", "double_stream", {}),
    ("it", "lapacian_dropout", "double_stream", {}),
    ("ii", "lapacian_dropout", "double_stream", {}),
    ("ti", "lapacian_dropout", "single_stream", {}),
    ("ti", "NDP", "double_stream", {}),
    ("ti", "lapacian_dropout_equal_weight", "double_stream", {}),
    ("ti", "feature_all_lap", "double_stream", {}),
    ("ti", "DPSGD", "double_stream", {}),
    ("ti", "lapacian_dropout", "double_stream", {"bf16_moments": True}),
]


def case_id(c):
    return "-".join(c[:3]) + "".join(f"-{k}" for k in c[3])


def history(rows):
    return np.array([[r[k] for k in ROW] for r in rows])


@pytest.mark.parametrize("case", SWEEP_CASES, ids=case_id)
def test_sweep_equals_each_members_fit(case):
    """Members sharing a seed train as each alone: the sweep's rows equal
    ``Trainer.fit``'s at that member's epsilon, within 1e-5."""
    mt, dp, cross, kw = case
    kw = dict(kw)
    moments = "bfloat16" if kw.pop("bf16_moments", False) else "float32"
    epochs = kw.pop("epochs", 1)
    _, tc = configs(mt, dp, cross, **kw)
    cfg = TrainConfig(batch_size=B, learning_rate=1e-3, epochs=epochs, adam_mu_dtype=moments,
                      adam_nu_dtype=moments)
    # two steps an epoch where the states are carried, else one
    train, test = arrays(8 if epochs > 1 or kw or moments != "float32" else 4, 1, mt), \
        arrays(4, 2, mt)
    members = [SweepMember(e) for e in EPS]
    res = SweepRunner(tc, cfg, members, device="cpu").run(train, test, echo=False)
    for m, r in zip(members, res):
        alone = Trainer(tc, cfg, device="cpu").fit(train, test, m.epsilon, echo=False)
        np.testing.assert_allclose(history(r["history"]), history(alone["history"]),
                                   err_msg=f"epsilon {m.epsilon}", **ROW_TOL)
        assert r["f1_best"] == pytest.approx(alone["f1_best"], abs=1e-5)
    # NDP, and DPSGD's class outside DP-SGD, draw no noise: epsilon changes nothing
    assert not np.allclose(history(res[0]["history"]), history(res[1]["history"])) or \
        dp in ("NDP", "DPSGD")


def test_sweep_records_chunks_and_injected_bert(tmp_path, capsys):
    """Records under <log_root>/eps0.1_seed980616/ with the epsilon and seed
    in metrics.jsonl and a best record; one chunk of 3 equals three chunks
    of 1 (and says so in its log line); injected BERT weights start every
    member."""
    _, tc = configs()
    cfg = TrainConfig(batch_size=B, learning_rate=1e-3, epochs=1, f1_best_init=-1.0)
    train, test = arrays(4, 1), arrays(4, 2)
    # one seed: each chunk shuffles from its first member's seed, as in JAX
    members = [SweepMember(0.1), SweepMember(1.0), SweepMember(3.0, label="three")]
    bert = tree_map(lambda t: t.numpy(), TB.init(torch.Generator().manual_seed(9),
                                                 tc.bert_cfg(), "cpu"))
    whole = SweepRunner(tc, cfg, members, bert_params=bert, device="cpu")
    _, params, _, _ = whole.init_members([SweepMember(0.1), SweepMember(0.1, seed=7)])
    for (path, leaf), (_, want) in zip(tree_items(params["bert"]), tree_items(bert)):
        for m in range(2):
            np.testing.assert_array_equal(leaf[m].numpy(), want, err_msg=path)
    assert not torch.equal(params["fc1"]["kernel"][0], params["fc1"]["kernel"][1])

    res = whole.run(train, test, log_root=str(tmp_path), echo=False)
    capsys.readouterr()
    one_by_one = SweepRunner(tc, cfg, members, bert_params=bert, max_members_in_flight=1,
                             device="cpu").run(train, test, echo=True)
    assert "3 members exceed max_members_in_flight=1: running 3 sequential chunks" in \
        capsys.readouterr().out
    for a, b in zip(res, one_by_one):
        assert a["member"] == b["member"]
        np.testing.assert_allclose(history(a["history"]), history(b["history"]), **ROW_TOL)
    assert [r["member"]["epsilon"] for r in res] == [0.1, 1.0, 3.0]
    assert sorted(os.listdir(tmp_path)) == ["eps0.1_seed980616", "eps1.0_seed980616", "three"]
    logs = tmp_path / "eps0.1_seed980616"
    assert sorted(os.listdir(logs)) == ["best_record.txt", "metrics.jsonl", "whole_record.txt"]
    rec = json.loads((logs / "metrics.jsonl").read_text().splitlines()[0])
    assert (rec["epsilon"], rec["seed"], rec["epoch"]) == (0.1, 980616, 1)
    assert res[0]["best"]["epoch"] == 1 and res[0]["f1_best"] == res[0]["best"]["f1"]


def test_frontier_and_refusals():
    assert [dataclasses.asdict(m) for m in privacy_utility_frontier()] == \
        [dataclasses.asdict(m) for m in JS.privacy_utility_frontier()]
    grid = privacy_utility_frontier((1.0, 2.0), (1, 2))
    assert [m.name for m in grid] == [m.name for m in JS.privacy_utility_frontier((1.0, 2.0),
                                                                                  (1, 2))]
    _, tc = configs()
    if not torch.cuda.is_available():  # the card by default, never a quiet CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SweepRunner(tc, TrainConfig(), privacy_utility_frontier())
    with pytest.raises(NotImplementedError, match="item 15"):
        SweepRunner(tc, TrainConfig(), privacy_utility_frontier(), mesh=object(), device="cpu")
    for mode in ("share_phase_dropout", "paired_phase_encode"):
        with pytest.raises(ValueError, match="item 17"):
            SweepRunner(tc, TrainConfig(**{mode: True}), privacy_utility_frontier(),
                        device="cpu")
    with pytest.raises(ValueError, match="pri_gumbel"):  # fusion.apply refuses it
        SweepRunner(configs(dp="pri_gumbel")[1], TrainConfig(), privacy_utility_frontier(),
                    device="cpu")


@pytest.mark.parametrize("shape", [(5, 8, 2304), (3, 5, 1001)], ids=str)
def test_dp_block_plain_members_equal_single_calls(shape):
    """The DP block's plain versions over M members (an (M, F) DP row, an
    (M,) epsilon, M seeds) equal M single calls, bit for bit; so does the
    autograd Function's CPU path."""
    M, Bm, F = shape
    g = torch.Generator().manual_seed(0)
    f, g_out = torch.randn(M * Bm, F, generator=g), torch.randn(M * Bm, F, generator=g)
    dp = torch.randn(M, F, generator=g)
    eps = [0.1, 1.0, 3.0, 5.0, 10.0][:M]
    seeds = [1234 + 7 * m for m in range(M)]
    eps_t = torch.tensor(eps, dtype=torch.float64)
    noise = K.laplace_plain(seeds, (M * Bm, F))
    out = K.dp_block_plain(f, dp, eps_t, noise)
    df, ddp = K.dp_block_bwd_plain(f, dp, eps_t, noise, g_out)
    assert ddp.shape == (M, F)
    for m in range(M):
        r = slice(m * Bm, (m + 1) * Bm)
        one = K.laplace_plain(seeds[m], (Bm, F))
        assert torch.equal(noise[r], one)
        assert torch.equal(out[r], K.dp_block_plain(f[r], dp[m:m + 1], eps[m], one))
        d1, p1 = K.dp_block_bwd_plain(f[r], dp[m:m + 1], eps[m], one, g_out[r])
        assert torch.equal(df[r], d1) and torch.equal(ddp[m:m + 1], p1)
    fr, dpr = f.clone().requires_grad_(), dp.clone().requires_grad_()
    y = K.fused_lap_dropout(fr, dpr, eps_t, torch.tensor(seeds))
    assert torch.equal(y, out)
    gf, gdp = torch.autograd.grad(y, (fr, dpr), g_out)
    assert torch.equal(gf, df) and torch.equal(gdp, ddp)


def test_dp_mechanisms_per_member_equal_single_calls():
    """``ops/dp.py``'s mechanisms with a per-member epsilon, member-stacked
    ``DP`` / ``w`` and a group of generators equal each member's call with
    its float epsilon and generator (the CPU rounds a vector's tail in
    another path, so within 1e-6)."""
    from eeg_multimodal_torch.ops import dp as TDP

    M, R, F = 3, 4, 37
    eps = [0.1, 1.0, 5.0]
    eps_t = torch.tensor(eps, dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    feat = torch.rand(M * R, F, generator=g)
    dp = torch.randn(M, 1, F, generator=g)
    w = torch.rand(M, F, generator=g)
    close = dict(rtol=1e-6, atol=1e-6)

    def gens():
        return tuple(torch.Generator().manual_seed(80 + m) for m in range(M))

    groups = [slice(m * R, (m + 1) * R) for m in range(M)]
    cases = {
        "lap_dropout_fast": (
            lambda gs: TDP.lap_dropout_fast(feat, dp, eps_t, TDP.laplace_noise(
                feat.shape, 1.0, gs)),
            lambda m, gm: TDP.lap_dropout_fast(feat[groups[m]], dp[m], eps[m], TDP.laplace_noise(
                (R, F), 1.0, gm))),
        "lap_dropout": (
            lambda gs: TDP.lap_dropout(feat, dp, eps_t, False, gs),
            lambda m, gm: TDP.lap_dropout(feat[groups[m]], dp[m], eps[m], False, gm)),
        "equal_weight_dp": (
            lambda gs: TDP.equal_weight_dp(feat, eps_t, 0.5, True, gs),
            lambda m, gm: TDP.equal_weight_dp(feat[groups[m]], eps[m], 0.5, True, gm)),
        "per_sample_laplace": (
            lambda gs: TDP.per_sample_laplace(feat, eps_t, gs),
            lambda m, gm: TDP.per_sample_laplace(feat[groups[m]], eps[m], gm)),
    }
    for name, (members, single) in cases.items():
        torch.testing.assert_close(members(gens()), torch.cat(
            [single(m, gm) for m, gm in enumerate(gens())]), **close, msg=name)
    ce = torch.rand(M, generator=g)
    torch.testing.assert_close(TDP.privacy_regularized_loss(ce, w, 0.7, eps_t), torch.stack(
        [TDP.privacy_regularized_loss(ce[m], w[m], 0.7, eps[m]) for m in range(M)]), **close)


def test_layers_with_member_stacked_weights_equal_separate_calls():
    """``linear``, ``layer_norm`` and ``multi_head_attention`` (the decoder's,
    with key masks and dropout from a group of generators) over a
    member-stacked weight equal M separate calls, each group of rows
    through its own weights and generator."""
    M, R, Sq, E = 3, 2, 5, 768
    g = torch.Generator().manual_seed(0)
    lin = [TL.linear_init(g, E, 16, "cpu") for _ in range(M)]
    ln = [{"scale": torch.rand(E, generator=g), "bias": torch.randn(E, generator=g)}
          for _ in range(M)]
    mha = [TL.mha_init(g, E, "cpu") for _ in range(M)]
    for p in mha:
        p["in_proj_bias"] = torch.randn(3 * E, generator=g)

    def stack(trees):
        return {k: (stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                    else torch.stack([t[k] for t in trees])) for k in trees[0]}

    x = torch.randn(M * R, Sq, E, generator=g)
    kv = torch.randn(M * R, 7, E, generator=g)
    kpm = torch.zeros(M * R, 7, dtype=torch.bool)
    kpm[1, 4:] = kpm[4, 2:] = True
    groups = [slice(m * R, (m + 1) * R) for m in range(M)]
    close = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(TL.linear(stack(lin), x),
                               torch.cat([TL.linear(lin[m], x[r]) for m, r in enumerate(groups)]),
                               **close)
    torch.testing.assert_close(TL.linear(stack(lin), x[:, 0]), torch.cat(
        [TL.linear(lin[m], x[r, 0]) for m, r in enumerate(groups)]), **close)
    torch.testing.assert_close(TL.layer_norm(stack(ln), x), torch.cat(
        [TL.layer_norm(ln[m], x[r]) for m, r in enumerate(groups)]), **close)

    def gens():
        return tuple(torch.Generator().manual_seed(50 + m) for m in range(M))

    got = TL.multi_head_attention(stack(mha), x, kv, 12, key_padding_mask=kpm,
                                  dropout_rate=0.1, gen=gens())
    want = torch.cat([TL.multi_head_attention(mha[m], x[r], kv[r], 12,
                                              key_padding_mask=kpm[r], dropout_rate=0.1, gen=gm)
                      for (m, r), gm in zip(enumerate(groups), gens())])
    torch.testing.assert_close(got, want, **close)


def test_member_forward_equals_each_member_with_its_draws():
    """``fusion.apply`` over a stacked tree (BERT's own tables per member,
    every dropout mask, attention seed and fused-DP seed from the member's
    generator) equals each member's forward with its generator, epsilon
    and weights."""
    _, tc = configs(fused_dp_kernel=True)
    seeds = (11, 12)
    params = TF.init_members(tc, seeds, "cpu")
    assert params["bert"]["embeddings"]["word"].shape == (2, 50, 768)
    for m, seed in enumerate(seeds):
        for (path, leaf), (_, alone) in zip(tree_items(params), tree_items(TF.init(tc, seed,
                                                                                   "cpu"))):
            assert torch.equal(leaf[m], alone), path
    data = arrays(B, seed=3).to_device("cpu")

    def gens():
        return tuple(torch.Generator().manual_seed(70 + m) for m in range(2))

    eps_t = torch.tensor(EPS, dtype=torch.float64)
    got = TF.apply(params, TF.repeat_batch(data, 2), tc, eps_t, True, gens(), True)
    want = torch.cat([TF.apply(tree_map(lambda t: t[m], params), data, tc, EPS[m], True, gm,
                               True) for m, gm in enumerate(gens())])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
