"""The port's MLM pretrainer and its pretexts against the JAX package's, on
the CPU.

From the same numpy inputs and weights and with JAX's own random draws
handed to the port (batch indices, the masking uniforms and random ids,
made from JAX's keys exactly as mlm.py:141-157 and :253-257 there make
them): the pretext arrays byte for byte; ``mask_tokens`` exactly; the MLM
outputs, losses (each pretext alone and all together) and every gradient
within rtol 1e-5 / atol 1e-6 in f32 (atol 1e-5 for losses and gradients,
sums of a few hundred terms); five ``MLMPretrainer`` steps with dropout
off, the params after each step within rtol 1e-5 / atol 1e-6 in f32 and,
in bf16, the whole parameter vector within the yardstick of ``test_torch_bf16.py`` (the port's
distance from JAX's f32 trajectory within 2x, max, and 1.5x, RMS, JAX's own
bf16 distance from it); the schedule equal to optax's. BERT is 2 layers of
width 128 with 2 heads, so that the head width is 64 and self-attention
takes ``fused_attention``'s path as on the card (at width 32 the plain
branch would run); S = 16.
"""
import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.train import mlm as JM
from eeg_multimodal_tpu.train import pretext as JP
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.ops import attention as A
from eeg_multimodal_torch.ops import optim as O
from eeg_multimodal_torch.train import mlm as TM
from eeg_multimodal_torch.train import pretext as TP
from eeg_multimodal_torch.utils.trees import tree_items
from test_torch_bf16 import within_yardstick

F32 = dict(rtol=1e-5, atol=1e-6)
LOSS = dict(rtol=1e-5, atol=1e-5)
V, S, N = 60, 16, 24
TINY = dict(vocab_size=V, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=S, hidden_dropout=0.0, attention_dropout=0.0)
J_CFG, T_CFG = JB.BertConfig(**TINY), TB.BertConfig(**TINY)
MLM = dict(mask_id=3, cls_id=1, sep_id=2, pad_id=0, batch_size=8)
PRETEXTS = {"mlm": {}, "row_reg": {"row_reg_weight": 0.7}, "whole_word": {"whole_word": True},
            "clip": {"clip_weight": 0.5},
            "all": {"row_reg_weight": 0.7, "whole_word": True, "clip_weight": 0.5}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def corpus(seed=0, n=N):
    """Token rows [CLS] ids [SEP] pad, 8-14 valid; continuation pieces are
    the ids 40-59 (``CONT``), row values (n, 5) with a padded column and
    CLIP targets (n, 7)."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((n, S), np.int32)
    mask = np.zeros((n, S), np.int32)
    for i in range(n):
        L = rng.randint(8, 15)
        ids[i, 0], ids[i, L - 1] = 1, 2
        ids[i, 1:L - 1] = rng.randint(4, V, L - 2)
        mask[i, :L] = 1
    vals = rng.randn(n, 5).astype(np.float32)
    vmask = np.ones((n, 5), np.float32)
    vmask[: n // 2, 4] = 0.0
    return {"ids": ids, "mask": mask, "vals": vals, "vmask": vmask,
            "ws": JP.word_start_index(ids, CONT), "clip": rng.randn(n, 7).astype(np.float32)}


CONT = np.zeros(V, bool)
CONT[40:] = True


def jax_params(seed=0, n_values=5, n_clip=7):
    k_bert, k_head = jax.random.split(jax.random.PRNGKey(seed))
    tree = {"bert": JB.init(k_bert, J_CFG),
            "head": JM.head_init(k_head, J_CFG, n_values=n_values, n_clip=n_clip)}
    # a nonzero decoder bias and head biases, so their gradients are tested
    rng = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.01 * rng.randn(*a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), tree)


def port_params(tree):
    return TM.params_from_jax(tree, "cpu")


def jax_step_draws(key, B, n_rows, vocab):
    """One step's draws as the JAX chunk makes them from its step key:
    (batch indices, (r, kind, rand_ids))."""
    k_batch, k_loss = jax.random.split(key)
    idx = jax.random.randint(k_batch, (B,), 0, n_rows)
    return idx, jax_mask_draws(jax.random.split(k_loss)[0], (B, S), vocab)


def jax_mask_draws(k_mask, shape, vocab):
    k_sel, k_kind, k_rand = jax.random.split(k_mask, 3)
    return (jax.random.uniform(k_sel, shape), jax.random.uniform(k_kind, shape),
            jax.random.randint(k_rand, shape, 0, vocab, jnp.int32))


def t(a, dtype=None):
    a = torch.from_numpy(np.array(a))
    return a if dtype is None else a.to(dtype)


def test_corpus_pretexts_equal_the_jax_package_byte_for_byte(tmp_path):
    rng = np.random.RandomState(3)
    rows = rng.randint(-300, 300, (40, 30)).astype(np.float64)
    rows[:, 5] = 7.0  # a constant column stays constant
    for factor in (0, 2):
        a, b = TP.augment_rows(rows, factor, 0.03, 0xA06), JP.augment_rows(rows, factor, 0.03,
                                                                          0xA06)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    aug = TP.augment_rows(rows, 2, 0.03, 0xA07)
    for max_len in (512, 80):
        ours, want = TP.tokenize_rows(aug, max_len=max_len), JP.tokenize_rows(aug,
                                                                              max_len=max_len)
        for k in ("input_ids", "attention_mask"):
            assert ours[k].dtype == np.int32 and np.array_equal(ours[k], want[k])
    cont = TP.continuation_id_set()
    assert np.array_equal(cont, JP.continuation_id_set()) and cont.sum() > 0
    ids = TP.tokenize_rows(aug)["input_ids"]
    ws = TP.word_start_index(ids, cont)
    assert ws.dtype == np.int32 and np.array_equal(ws, JP.word_start_index(ids, cont))
    assert (ws < np.arange(ids.shape[1])).any()  # some numbers span pieces

    clip = rng.randn(6, 512).astype(np.float32)
    d = tmp_path / "data" / "embedding" / "act" / "img" / "clip_ViT_B_32"
    d.mkdir(parents=True)
    (d / "train.pickle").write_bytes(pickle.dumps(clip[:, None]))  # the (N, 1, 512) layout
    got = TP.load_act_clip_targets(str(tmp_path))
    assert np.array_equal(got, JP.load_act_clip_targets(str(tmp_path)))
    assert np.array_equal(TP.stack_clip_targets([6, 14], got), JP.stack_clip_targets([6, 14],
                                                                                      got))


def test_build_corpus_and_value_targets_equal_the_jax_package():
    rng = np.random.RandomState(1)
    dicts = []
    for n, L in ((5, 70), (4, 30)):
        ids = rng.randint(1, 100, (n, 512)).astype(np.int32)
        mask = np.zeros((n, 512), np.int32)
        mask[:, :L] = 1
        dicts.append({"input_ids": ids, "attention_mask": mask})
    for a, b in zip(TM.build_corpus(dicts), JM.build_corpus(dicts)):
        assert a.shape == (9, 128) and np.array_equal(a, b)
    values = [rng.randn(5, 30) * 50, rng.randn(4, 25)]
    values[1][:, 3] = 1.0  # a constant column: std 1
    for a, b in zip(TM.build_value_targets(values), JM.build_value_targets(values)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("whole_word", [False, True])
def test_mask_tokens_with_jax_draws_equals_jax(whole_word):
    c = corpus(2)
    cfg_j = JM.MLMConfig(whole_word=whole_word, **MLM)
    cfg_t = TM.MLMConfig(whole_word=whole_word, **MLM)
    key = jax.random.PRNGKey(5)
    ws = jnp.asarray(c["ws"]) if whole_word else None
    want = JM.mask_tokens(key, jnp.asarray(c["ids"]), jnp.asarray(c["mask"]), cfg_j, V,
                          word_start=ws)
    r, kind, rand_ids = jax_mask_draws(key, c["ids"].shape, V)
    got = TM.mask_tokens(None, t(c["ids"], torch.int64), t(c["mask"], torch.int64), cfg_t, V,
                         word_start=t(c["ws"], torch.int64) if whole_word else None,
                         r=t(r), kind=t(kind), rand_ids=t(rand_ids, torch.int64))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    sel = got[2].numpy()
    assert sel.any() and not sel[c["mask"] == 0].any()
    assert not sel[(c["ids"] == 1) | (c["ids"] == 2)].any()
    if whole_word:  # a continuation shares its word start's decision
        rows, cols = np.nonzero((c["ws"] != np.arange(S)) & (c["ws"] > 0))  # [CLS] is never
        assert np.array_equal(sel[rows, cols], sel[rows, c["ws"][rows, cols]])
    # drawn from a generator: same law, the special positions never selected
    drawn = TM.mask_tokens(torch.Generator().manual_seed(0), t(c["ids"], torch.int64),
                           t(c["mask"], torch.int64), cfg_t, V)[2].numpy()
    assert 0 < drawn.sum() and not drawn[c["mask"] == 0].any()


def test_head_init_layout_and_params_from_jax():
    tree = jax_params()
    ours = TM.head_init(torch.Generator().manual_seed(0), T_CFG, "cpu", n_values=5, n_clip=7)
    got = port_params(tree)
    assert sorted((p, tuple(x.shape)) for p, x in tree_items(ours)) == \
        sorted((p, tuple(x.shape)) for p, x in tree_items(got["head"]))
    for path, leaf in tree_items(got):
        assert leaf.dtype == torch.float32
    # HF's init scale; no pretext heads unless asked for
    assert abs(float(ours["transform"]["kernel"].std()) - T_CFG.initializer_range) < 2e-3
    assert set(TM.head_init(torch.Generator(), T_CFG, "cpu")) == {"transform", "ln",
                                                                 "decoder_bias"}
    bad = jax.tree_util.tree_map(np.asarray, tree)
    bad["head"]["reg"]["kernel"] = bad["head"]["reg"]["kernel"][:, :3]
    with pytest.raises(ValueError, match="not head_init's"):
        port_params(bad)


def test_mlm_outputs_equal_jax():
    tree, c = jax_params(), corpus()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    logits, pooled = JM.mlm_outputs(jt["bert"], jt["head"], jnp.asarray(c["ids"]),
                                    jnp.asarray(c["mask"]), J_CFG, None)
    p = port_params(tree)
    calls = []
    real = A.fused_attention
    A.fused_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        ours = TM.mlm_outputs(p["bert"], p["head"], t(c["ids"], torch.int64),
                              t(c["mask"], torch.int64), T_CFG, None)
    finally:
        A.fused_attention = real
    assert len(calls) == T_CFG.num_layers  # the kernels' path, as on the card
    assert ours[0].dtype == torch.float32 and ours[0].shape == (N, S, V)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(logits), **F32)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(pooled), **F32)
    assert torch.equal(TM.mlm_logits(p["bert"], p["head"], t(c["ids"], torch.int64),
                                     t(c["mask"], torch.int64), T_CFG, None), ours[0])


@pytest.mark.parametrize("pretext", sorted(PRETEXTS))
def test_mlm_loss_and_gradients_equal_jax(pretext):
    tree, c = jax_params(), corpus(1)
    cfg_j = JM.MLMConfig(**MLM, **PRETEXTS[pretext])
    cfg_t = TM.MLMConfig(**MLM, **PRETEXTS[pretext])
    key = jax.random.PRNGKey(11)
    kw_j = dict(values=jnp.asarray(c["vals"]), value_mask=jnp.asarray(c["vmask"]),
                word_start=jnp.asarray(c["ws"]), clip_targets=jnp.asarray(c["clip"]))

    def jloss(p):
        return JM.mlm_loss(p["bert"], p["head"], jnp.asarray(c["ids"]), jnp.asarray(c["mask"]),
                           J_CFG, cfg_j, key, **kw_j)

    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    want, jgrad = jax.jit(jax.value_and_grad(jloss))(jt)
    draws = jax_mask_draws(jax.random.split(key)[0], c["ids"].shape, V)

    p = port_params(tree)
    leaves = [x.requires_grad_() for _, x in tree_items(p)]
    loss = TM.mlm_loss(p["bert"], p["head"], t(c["ids"], torch.int64),
                       t(c["mask"], torch.int64), T_CFG, cfg_t, None,
                       values=t(c["vals"]), value_mask=t(c["vmask"]),
                       word_start=t(c["ws"], torch.int64), clip_targets=t(c["clip"]),
                       mask_draws=(t(draws[0]), t(draws[1]), t(draws[2], torch.int64)))
    np.testing.assert_allclose(float(loss.detach()), float(want), **LOSS)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    jflat = dict((JP_path(path), g) for path, g in
                 jax.tree_util.tree_flatten_with_path(jgrad)[0])
    for (path, _), g in zip(tree_items(p), grads):
        g = np.zeros_like(np.asarray(jflat[path])) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(jflat[path]), rtol=1e-5, atol=1e-5,
                                   err_msg=path)


def JP_path(path):
    from eeg_multimodal_tpu.utils.trees import path_str

    return path_str(path)


def jax_trajectory(tree, c, cfg, dtype, steps, key):
    """The JAX pretrainer's params after each of ``steps`` steps (its
    ``run_chunk`` one step a call, keys split as the chunk splits them) and
    each step's draws."""
    pre = JM.MLMPretrainer(J_CFG, dataclasses.replace(cfg, compute_dtype=dtype))
    pre.bert_params = jax.tree_util.tree_map(jnp.asarray, tree["bert"])
    pre.head = jax.tree_util.tree_map(jnp.asarray, tree["head"])
    params = {"bert": pre.bert_params, "head": pre.head}
    opt_state = pre.opt.init(params)
    run_chunk = pre._make_chunk(*(jnp.asarray(c[k]) for k in ("ids", "mask", "vals", "vmask",
                                                               "ws", "clip")))
    out, draws = [], []
    for s in range(steps):
        k = jax.random.fold_in(key, s)
        params, opt_state, _ = run_chunk(params, opt_state, k, jnp.zeros((1,)))
        out.append(jax.tree_util.tree_map(np.asarray, params))
        draws.append(jax_step_draws(jax.random.split(k, 1)[0], cfg.batch_size, N, V))
    return out, draws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_five_pretrainer_steps_follow_jax(dtype):
    """Every pretext on, dropout off; the port takes JAX's batch indices and
    mask draws. f32: each step's params within rtol 1e-5 / atol 1e-6; bf16:
    the whole parameter vector within the yardstick of JAX's own bf16
    trajectory."""
    tree, c = jax_params(3), corpus(4)
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=2, weight_decay=0.01,
              **MLM, **PRETEXTS["all"])
    key = jax.random.PRNGKey(21)
    steps = 5
    jax_by = {d: jax_trajectory(tree, c, JM.MLMConfig(**kw), d, steps, key)
              for d in sorted({"float32", dtype})}
    want, draws = jax_by[dtype]

    pre = TM.MLMPretrainer(T_CFG, TM.MLMConfig(compute_dtype=dtype, **kw), n_values=5, n_clip=7,
                           device="cpu")
    p = port_params(tree)
    pre.bert_params, pre.head = p["bert"], p["head"]
    pre.opt_state = pre.opt.init(pre._leaves())
    dev_corpus = pre.corpus_on_device(c["ids"], c["mask"], c["vals"], c["vmask"], c["ws"],
                                      c["clip"])
    assert sorted(dev_corpus) == ["clip", "ids", "mask", "vals", "vmask", "ws"]
    for s in range(steps):
        idx, md = draws[s]
        loss = pre.step(dev_corpus, None, t(idx, torch.int64),
                        (t(md[0]), t(md[1]), t(md[2], torch.int64)))
        assert loss.dim() == 0 and not loss.requires_grad
        flat = dict((JP_path(path), x) for path, x in
                    jax.tree_util.tree_flatten_with_path(want[s])[0])
        f32_traj = dict((JP_path(path), x) for path, x in
                        jax.tree_util.tree_flatten_with_path(jax_by["float32"][0][s])[0])
        moved = sum(pre.opt.schedule(i) for i in range(s + 1))
        rest = []  # bf16: (port, JAX bf16, JAX f32) of every other leaf
        for path, leaf in tree_items({"bert": pre.bert_params, "head": pre.head}):
            assert leaf.dtype == torch.float32
            if path.endswith("attn/key/bias"):
                # softmax is shift-invariant along a row, so the key bias's
                # gradient is 0 in exact arithmetic and Adam steps it by the
                # sign of each side's rounding noise: each stays within
                # Adam's step bound (lr_t a step) of the other
                assert np.abs(leaf.numpy() - flat[path]).max() <= 2 * moved, path
            elif dtype == "float32":
                np.testing.assert_allclose(leaf.numpy(), flat[path], **F32,
                                           err_msg=f"step {s + 1} {path}")
            else:
                rest.append((leaf.numpy().ravel(), flat[path].ravel(), f32_traj[path].ravel()))
        if rest:  # the whole parameter vector: a small leaf's RMS is too noisy alone
            within_yardstick(f"step {s + 1}", *(np.concatenate(x) for x in zip(*rest)))
    # updated in place: the tree handed in is the trained one
    assert pre.opt_state.count == steps and pre.bert_params is p["bert"]


def test_fit_makes_one_sync_a_chunk_and_records_chunk_losses(monkeypatch):
    c = corpus(5)
    cfg = TM.MLMConfig(total_steps=5, log_every=2, warmup_steps=1, compute_dtype="float32",
                       **MLM)
    pre = TM.MLMPretrainer(T_CFG, cfg, device="cpu")
    syncs = []
    real = torch.Tensor.__float__
    monkeypatch.setattr(torch.Tensor, "__float__", lambda x: syncs.append(1) or real(x))
    bert, hist = pre.fit(c["ids"], c["mask"], echo=False)
    assert [h["step"] for h in hist] == [2, 4, 5] and len(syncs) == 3
    assert all(np.isfinite(h["loss"]) for h in hist) and bert is pre.bert_params


@pytest.mark.parametrize("count", [0, 1, 3, 10, 11, 40, 1000])
def test_schedule_equals_optax(count):
    for args in ((0.0, 1e-4, 3, 40), (0.0, 3e-4, 100, 1500), (0.0, 1e-3, 1, 2)):
        np.testing.assert_allclose(O.warmup_cosine_decay_schedule(*args)(count),
                                   float(optax.warmup_cosine_decay_schedule(*args)(count)),
                                   rtol=1e-5, atol=1e-12)  # optax computes in f32
    assert O.warmup_cosine_decay_schedule(0.0, 1e-4, 3, 40)(0) == 0.0  # the first update is 0
    with pytest.raises(ValueError):
        O.warmup_cosine_decay_schedule(0.0, 1e-4, 5, 5)


def test_eval_loss_has_no_encoder_dropout():
    """``eval_loss`` runs the encoder without dropout: with a dropout config
    its loss equals the loss of the same draws at dropout 0."""
    c = corpus(6)
    drop = TB.BertConfig(**{**TINY, "hidden_dropout": 0.3, "attention_dropout": 0.3})
    cfg = TM.MLMConfig(compute_dtype="float32", **MLM)
    pre = TM.MLMPretrainer(drop, cfg, device="cpu")
    nodrop = TM.MLMPretrainer(T_CFG, cfg, bert_params=pre.bert_params, device="cpu")
    nodrop.head = pre.head
    e1 = pre.eval_loss(c["ids"], c["mask"], n_batches=3)
    assert e1 == pre.eval_loss(c["ids"], c["mask"], n_batches=3)
    assert e1 == nodrop.eval_loss(c["ids"], c["mask"], n_batches=3)
    gen = torch.Generator().manual_seed(0)
    ids, mask = t(c["ids"], torch.int64), t(c["mask"], torch.int64)
    train = TM.mlm_loss(pre.bert_params, pre.head, ids, mask, drop, cfg, gen)
    gen.manual_seed(0)
    assert float(train) != float(TM.mlm_loss(pre.bert_params, pre.head, ids, mask, drop, cfg,
                                             gen, train=False))


def write_tree(root, n=(10, 6), seed=0):
    """A reference-layout tree: label CSVs, processed EEG (30) and act (25)
    rows, their token pickles (the uncased tokenizer's ids of the rows'
    text) and the act CLIP arrays."""
    rng = np.random.RandomState(seed)
    proc = os.path.join(root, "data", "processed")
    os.makedirs(proc)
    for split, count in zip(("train", "test"), n):
        with open(os.path.join(proc, f"{split}_label.csv"), "w") as f:
            f.write("label\n" + "".join(f"{v}\n" for v in rng.randint(0, 2, count)))
        for modal, width, hi in (("EEG", 30, 300), ("act", 25, 2048)):
            rows = rng.randint(-hi, hi, (count, width))
            np.savetxt(os.path.join(proc, f"{split}_{modal}.csv"), rows, delimiter=",",
                       header=",".join(f"c{i}" for i in range(width)), comments="",
                       fmt="%d")
            tok = TP.tokenize_rows(rows)
            d = os.path.join(root, "data", "embedding", modal, "txt", "bert_bert_base_uncased")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{split}.pickle"), "wb") as f:
                pickle.dump([{"input_ids": i, "attention_mask": m}
                             for i, m in zip(tok["input_ids"], tok["attention_mask"])], f)
        d = os.path.join(root, "data", "embedding", "act", "img", "clip_ViT_B_32")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{split}.pickle"), "wb") as f:
            pickle.dump(rng.randn(count, 512).astype(np.float32), f)
    return root


def test_pretrain_finetune_mlm_writes_the_files_jax_writes(tmp_path):
    """Both pipelines on one tiny tree, every pretext on (2 MLM steps, one
    f32 fine-tune epoch, a 1-layer BERT of width 768, which the fusion
    head needs): the same files, the same compact vocabulary, histories of
    the same steps, encoders of the same tree; then the port resumes from
    its own encoder file, and refuses the JAX package's."""
    root = write_tree(str(tmp_path / "tree"))
    tiny = dict(num_layers=1, intermediate_size=64, max_position_embeddings=128)
    kw = dict(mlm_steps=2, mlm_batch=4, epochs=1, batch_size=4, learning_rate=1e-3,
              compute_dtype="float32", echo=False, row_reg_weight=1.0, aug_factor=1,
              whole_word=True, clip_weight=0.5)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    res_j = JM.pretrain_finetune_mlm(root, out_j, bert_config=JB.BertConfig(**tiny), **kw)
    res = TM.pretrain_finetune_mlm(root, out_t, bert_config=TB.BertConfig(**tiny),
                                   device="cpu", **kw)
    assert np.isfinite(res["history"][0]["train_loss"])

    def files(out, result):
        """The files written; the best record and checkpoint exist exactly
        when the epoch's F1 passed 0.5, which random inits decide apart."""
        got = sorted(os.path.relpath(os.path.join(d, f), out)
                     for d, _, fs in os.walk(out) for f in fs)
        best = {"logs/demo/DPMLD/best_record.txt", "models/custom/demo/DPMLD/best_f1.pickle"}
        assert (best <= set(got)) == (result["f1_best"] > 0.5), got
        return [f for f in got if f not in best]

    assert files(out_t, res) == files(out_j, res_j)
    assert {"bert_mlm.pickle", "mlm_history.json", "compact_vocab.npz",
            "logs/demo/DPMLD/whole_record.txt"} <= set(files(out_t, res))
    vj, vt = (np.load(os.path.join(o, "compact_vocab.npz")) for o in (out_j, out_t))
    assert sorted(vj.files) == sorted(vt.files)
    assert all(np.array_equal(vj[k], vt[k]) for k in vj.files)
    hj, ht = (json.load(open(os.path.join(o, "mlm_history.json"))) for o in (out_j, out_t))
    assert [h["step"] for h in ht] == [h["step"] for h in hj] == [2]
    from eeg_multimodal_tpu.train import checkpoint as JC
    from eeg_multimodal_torch.train import checkpoint as TC

    jb = JC.load_pytree(os.path.join(out_j, "bert_mlm.pickle"))
    tb = TC.load_pytree(os.path.join(out_t, "bert_mlm.pickle"), "cpu")
    assert sorted((JP_path(p), x.shape) for p, x in jax.tree_util.tree_flatten_with_path(jb)[0]) \
        == sorted((p, tuple(x.shape)) for p, x in tree_items(tb))

    res2 = TM.pretrain_finetune_mlm(root, str(tmp_path / "resume"),
                                    bert_config=TB.BertConfig(**tiny), device="cpu",
                                    bert_ckpt=os.path.join(out_t, "bert_mlm.pickle"),
                                    **{k: v for k, v in kw.items() if k != "mlm_steps"})
    assert np.isfinite(res2["history"][0]["train_loss"])
    with pytest.raises(ValueError, match="save_pytree"):
        TC.load_pytree(os.path.join(out_j, "bert_mlm.pickle"), "cpu")


def test_pretrain_refuses_misaligned_or_missing_rows(tmp_path):
    root = write_tree(str(tmp_path / "tree"))
    kw = dict(mlm_steps=2, mlm_batch=4, epochs=1, batch_size=4, echo=False, device="cpu",
              bert_config=TB.BertConfig(num_layers=1, intermediate_size=64))
    csv = os.path.join(root, "data", "processed", "train_act.csv")
    lines = open(csv).readlines()
    open(csv, "w").writelines(lines[:-1])
    with pytest.raises(ValueError, match="act: 9 csv rows vs 10 token rows"):
        TM.pretrain_finetune_mlm(root, str(tmp_path / "a"), row_reg_weight=1.0, **kw)
    os.remove(csv)
    with pytest.raises(FileNotFoundError, match="row_reg_weight/aug_factor"):
        TM.pretrain_finetune_mlm(root, str(tmp_path / "b"), aug_factor=1, **kw)
