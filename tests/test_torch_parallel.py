"""The port's (data, model) mesh (parallel/) on the CPU: the layout rules
against the JAX package's, the layout-invariant draws, and meshed runs on
gloo CPU ranks (tests/mesh_worker.py spawns them, a ``FileStore`` in
``tmp_path``, one torch thread a rank) against the meshless port run, at the
tiny BERT of test_torch_sweep.py (hidden 768, two layers, 12 heads).

Tolerances, as the JAX package's mesh tests (tests/test_parallel.py:91-92,
126-127): train and test losses within rtol 2e-4 of the meshless run's, F1
within 1e-6. The gathered params: each leaf's update (its change over the
run) within 1e-3 of the meshless update's L2 norm, and every element within
4 x the learning rate x the steps of the meshless value (Adam's scale: a
near-0 gradient summed in another order can flip an element's step).
The parts whose gradient is 0 in exact arithmetic (the attention key
biases, the key third of the cross block's ``in_proj_bias``), which Adam
moves by rounding noise alone, are held to the element bound only. A
meshed step with the draws handed in is held against the JAX step at rtol
1e-4 / atol 1e-5, as test_torch_sweep.py holds the sweep's step.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mesh_worker as W
from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.parallel import mesh as JMESH
from eeg_multimodal_tpu.parallel import sharding as JSH
from eeg_multimodal_tpu.train import metrics as JM
from eeg_multimodal_torch.dp.dpsgd import DPSGDConfig
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.ops import attention as TA
from eeg_multimodal_torch.ops import dp_fused as K
from eeg_multimodal_torch.parallel import mesh as TMESH
from eeg_multimodal_torch.parallel import sharding as TSH
from eeg_multimodal_torch.parallel.train import shard_trainer
from eeg_multimodal_torch.train import checkpoint as TCK
from eeg_multimodal_torch.train.dpsgd_trainer import DPSGDTrainer
from eeg_multimodal_torch.train.sweep import SweepMember, SweepRunner
from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
from eeg_multimodal_torch.utils.trees import tree_items

LOSS_RTOL, F1_ABS = 2e-4, 1e-6
UPDATE_RTOL = 1e-3  # of each leaf's update, in L2
LR = 1e-3
TOL = dict(rtol=1e-4, atol=1e-5)
ROW = ("train_loss", "test_loss")
MESHES = [(1, 2), (2, 1), (2, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_id(shape):
    return f"mesh{shape[0]}x{shape[1]}"


def key_part(path, a):
    """The part of leaf ``a`` at ``path`` whose exact gradient is 0 (a key
    bias) as a boolean mask, or None."""
    mask = np.zeros(a.shape, bool)
    if path.endswith("attn/key/bias"):
        mask[...] = True
    elif path.endswith("in_proj_bias"):
        E = a.shape[-1] // 3
        mask[..., E:2 * E] = True
    else:
        return None
    return mask


def assert_params_close(got, want, init, steps):
    """``got`` (gathered) against the meshless ``want``, both from ``init``
    (module docstring)."""
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert np.abs(g - w).max() <= 4 * LR * steps, path
        keep = key_part(path, w)
        keep = np.ones(w.shape, bool) if keep is None else ~keep
        dw = (w - init[path])[keep]
        err = np.linalg.norm((g - init[path])[keep] - dw)
        assert err <= UPDATE_RTOL * max(np.linalg.norm(dw), 1e-12), (path, err,
                                                                      np.linalg.norm(dw))


def assert_history_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ROW:
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL, err_msg=k)
        assert a["f1"] == pytest.approx(b["f1"], abs=F1_ABS)


# ---------------------------------------------------------------------------
# The layout rules
# ---------------------------------------------------------------------------

def test_factorize_equals_jax():
    for n in range(1, 17):
        for max_model in (1, 2, 3, 4, 6):
            assert TMESH.factorize(n, max_model) == JMESH.factorize(n, max_model), (n, max_model)


CLASSES = [("ti", "lapacian_dropout", "double_stream"), ("ti", "DPSGD", "double_stream"),
           ("tt", "lapacian_dropout", "double_stream"), ("it", "lapacian_dropout", "double_stream"),
           ("ii", "lapacian_dropout", "double_stream"), ("ti", "lapacian_dropout", "single_stream"),
           ("ti", "NDP", "double_stream"), ("ti", "feature_all_lap", "double_stream"),
           ("ti", "lapacian_dropout_equal_weight", "double_stream")]


@pytest.mark.parametrize("cls", CLASSES, ids=lambda c: "-".join(c))
def test_param_pspec_equals_jax_on_every_path(cls):
    """Every path of the class's tree at BERT-base (the flagship, the DP-SGD
    tree and every class the sweep trains) takes the JAX package's layout;
    the port's tree has the JAX tree's paths."""
    from eeg_multimodal_tpu.utils.trees import path_str

    shapes = jax.eval_shape(lambda: JF.init(jax.random.PRNGKey(0), JF.config_for(*cls)))
    jpaths = [path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    for path in jpaths:
        assert tuple(TSH.param_pspec(path)) == tuple(JSH.param_pspec(path)), path
    tiny = TF.init(W.config(*cls), 0, "cpu")
    jtiny = jax.eval_shape(lambda: JF.init(jax.random.PRNGKey(0), dataclasses.replace(
        JF.config_for(*cls), bert_config=JB.BertConfig(**W.TINY))))
    assert sorted(p for p, _ in tree_items(tiny)) == sorted(
        path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtiny)[0])
    assert any(TSH.model_dim(p) is not None for p in jpaths)


def test_descriptors_and_a_world_of_one():
    mesh = TMESH.make_mesh()  # no process group: the (1, 1) mesh
    assert (mesh.data, mesh.model, mesh.shape) == (1, 1, {"data": 1, "model": 1})
    assert tuple(TMESH.replicated(mesh)) == ()
    assert tuple(TMESH.batch_sharding(mesh)) == ("data",)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        TMESH.make_mesh(2, 1)
    # shard / gather on a (1, 2) mesh's rank 1 without collectives: the slices
    m = TMESH.Mesh(1, 2, 0, 1)
    whole = TF.init(W.config(), 0, "cpu")
    shard = TSH.shard_params(m, whole)
    q = whole["bert"]["layers"][0]["attn"]["query"]
    assert torch.equal(shard["bert"]["layers"][0]["attn"]["query"]["kernel"],
                       q["kernel"][:, 384:])
    assert torch.equal(shard["bert"]["layers"][0]["attn"]["output"]["kernel"],
                       whole["bert"]["layers"][0]["attn"]["output"]["kernel"][384:])
    assert torch.equal(shard["fc2"]["kernel"], whole["fc2"]["kernel"][1152:])
    assert shard["DP"] is whole["DP"]
    assert TSH.shard_batch(TMESH.Mesh(2, 1, 1, 0), {"x": torch.arange(8)})["x"].tolist() == \
        [4, 5, 6, 7]


# ---------------------------------------------------------------------------
# Draws that do not depend on the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeds", [[7], [7, 2 ** 40 + 3]], ids=["G1", "G2"])
def test_masks_with_block_offsets_are_slices_of_the_global_mask(seeds):
    """``keep_mask_plain`` (the kernels' mask) and ``seeded_keep`` (the CPU
    path's) of each block of a (2, 2) layout over (8, 12, S, S) equal the
    slices of the global call, bit for bit, with one seed and with a group."""
    B, H, rate = 8, 12, 0.1
    for S in (13, 80):
        whole = TA.keep_mask_plain(seeds, B, H, S, rate)
        cpu = TA.seeded_keep(torch.tensor(seeds), (B, H, S, S), rate)
        for b0 in (0, 4):
            for h0 in (0, 6):
                block = TA.Block(b0, B, h0, H)
                np.testing.assert_array_equal(
                    TA.keep_mask_plain(seeds, 4, 6, S, rate, block=block),
                    whole[b0:b0 + 4, h0:h0 + 6])
                np.testing.assert_array_equal(
                    TA.seeded_keep(torch.tensor(seeds), (4, 6, S, S), rate, block),
                    cpu[b0:b0 + 4, h0:h0 + 6])
        np.testing.assert_array_equal(TA.keep_mask_plain(seeds, B, H, S, rate, block=TA.Block()),
                                      whole)
    with pytest.raises(ValueError, match="outside the global call"):
        TA.keep_mask_plain(seeds, 4, 6, 8, rate, block=TA.Block(6, 8, 0, 12))


@pytest.mark.parametrize("F", [2304, 1001])
def test_dp_noise_with_a_row_offset_is_a_slice_of_the_global_noise(F):
    """``laplace_plain`` of rows r0 .. equals those rows of the global draw,
    bit for bit, per member too; the fused block's CPU path with ``r0``
    equals its rows of the global call, forward and dDP summed over the
    shards."""
    whole = K.laplace_plain(11, (8, F))
    for r0 in (0, 3, 4):
        np.testing.assert_array_equal(K.laplace_plain(11, (8 - r0, F), r0=r0), whole[r0:])
    members = K.laplace_plain([11, 12], (16, F))
    np.testing.assert_array_equal(K.laplace_plain([11, 12], (8, F), r0=4),
                                  torch.cat([members[4:8], members[12:16]]))
    gen = torch.Generator().manual_seed(0)
    f = torch.randn(8, F, generator=gen)
    dp = torch.randn(1, F, generator=gen, requires_grad=True)
    seed = torch.tensor([11])
    out = K.fused_lap_dropout(f, dp, 1.0, seed)
    (g_all,) = torch.autograd.grad(out.sum(), [dp])
    g_parts = 0
    for r0 in (0, 4):
        part = K.fused_lap_dropout(f[r0:r0 + 4], dp, 1.0, seed, r0=r0)
        np.testing.assert_array_equal(part.detach(), out.detach()[r0:r0 + 4])
        g_parts = g_parts + torch.autograd.grad(part.sum(), [dp])[0]
    np.testing.assert_allclose(g_parts, g_all, rtol=1e-5, atol=1e-6)


def test_layout_draws_are_blocks_of_the_global_draw():
    """``Layout.draw`` on each rank of a (2, 2) layout: its rows, and its
    model shard of a split axis, of the draw of the whole shape."""
    gen = torch.Generator()

    def rand(s, g):
        return torch.rand(s, generator=g)

    whole = rand((8, 5, 6), gen.manual_seed(3))
    for d in (0, 1):
        for m in (0, 1):
            lay = TSH.Layout(TMESH.Mesh(2, 2, d, m), 4 * d, 8)
            np.testing.assert_array_equal(lay.draw(rand, (4, 5, 6), gen.manual_seed(3)),
                                          whole[4 * d:4 * d + 4])
            np.testing.assert_array_equal(lay.draw(rand, (4, 5, 3), gen.manual_seed(3), 2),
                                          whole[4 * d:4 * d + 4, :, 3 * m:3 * m + 3])
    with pytest.raises(ValueError, match="one generator"):
        TSH.Layout(TMESH.Mesh(2, 1), 0, 8).draw(rand, (4, 2), (gen, gen))


# ---------------------------------------------------------------------------
# Meshed runs on gloo ranks
# ---------------------------------------------------------------------------

FIT_CASES = [
    ((1, 2), {"fused_dp_kernel": True}, {}),
    ((2, 1), {"fused_dp_kernel": True}, {}),
    ((2, 2), {}, {}),
    ((2, 2), {"fused_dp_kernel": True}, {"adam_mu_dtype": "bfloat16", "adam_nu_dtype": "bfloat16"}),
]


def fit_id(case):
    shape, fc, tc = case
    return mesh_id(shape) + ("-fused" if fc else "-composed") + ("-bf16moments" if tc else "")


@pytest.mark.parametrize("case", FIT_CASES, ids=fit_id)
def test_shard_trainer_fit_equals_the_meshless_fit(tmp_path, case):
    """``shard_trainer`` + ``Trainer.fit`` on every rank: two epochs of two
    steps, the same history on every rank, within the mesh tolerances of the
    meshless fit; the gathered params too; rank (0, 0) alone writes the
    records and the best checkpoint, the gathered tree."""
    shape, fc_kw, tc_kw = case
    tc_kw = dict(batch_size=4, learning_rate=LR, epochs=2, f1_best_init=-1.0, **tc_kw)
    res = W.spawn(tmp_path, shape[0] * shape[1], "fit", mesh_shape=shape, fc_kw=fc_kw,
                  tc_kw=tc_kw, epsilon=1.0, n_train=8, n_test=4, out_dir=str(tmp_path))
    tr = Trainer(W.config(**fc_kw), TrainConfig(**tc_kw), device="cpu")
    init = W.numpy_tree(tr.params)
    want = tr.fit(W.arrays(8, 1), W.arrays(4, 2), 1.0, echo=False)
    for r in res:
        assert_history_close(r["history"], want["history"])
        assert [h["train_loss"] for h in r["history"]] == \
            [h["train_loss"] for h in res[0]["history"]]
    assert res[0]["shard"] == (768, 768 // shape[1])
    assert_params_close(res[0]["params"], W.numpy_tree(tr.params), init, steps=4)
    assert sorted(os.listdir(tmp_path / "log")) == ["best_record.txt", "metrics.jsonl",
                                                    "whole_record.txt"]
    assert len((tmp_path / "log" / "metrics.jsonl").read_text().splitlines()) == 2
    back = TCK.load_torch_checkpoint(str(tmp_path / "best.pickle"), W.config(**fc_kw), "cpu")
    assert {p: t.shape for p, t in tree_items(back)} == \
        {p: t.shape for p, t in tree_items(tr.params)}
    os.remove(tmp_path / "best.pickle")  # ~150 MB: the suite keeps its tmp dirs


def jax_noise(rng, B, F):
    """The composed DP block's (B, F) Laplace(0, 1) draw of a JAX forward
    keyed by ``rng`` (as test_torch_sweep.py's)."""
    _, k_dp = JF.split_rng(rng)
    return np.array(jax.random.laplace(jax.random.split(k_dp)[0], (B, F)))


def test_meshed_step_matches_the_jax_step(tmp_path):
    """One faithful step on a (2, 2) mesh from the JAX init, dropout off and
    the JAX forward's DP noise handed in, against the JAX alternating step:
    loss, accuracy and every updated leaf (gathered)."""
    jc = dataclasses.replace(JF.config_for("ti", "lapacian_dropout"),
                             bert_config=JB.BertConfig(**W.TINY))
    B, F = 4, jc.concat_width
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: JF.init(k, jc))(
        jax.random.PRNGKey(3)))
    tree["DP"] = np.random.RandomState(4).randn(1, F).astype(np.float32) * 0.5
    data = W.arrays(B, 1)
    batch = {k: v.numpy() for k, v in data.to_device("cpu").items()}
    weight = np.array([1, 1, 1, 0], np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = optax.adam(1e-6)

    def loss(p, rng, hard):
        logits = JF.apply(p, jb, jc, 1.0, hard, rng, train=False)
        return JM.cal_loss(logits, jb["labels"], jnp.asarray(weight))[:2]

    def step(params):  # train/trainer.py:292-321 there, dropout off
        rest = {k: v for k, v in params.items() if k != "DP"}
        g_dp = jax.grad(lambda dp: loss({**rest, "DP": dp}, k1, False)[0])(params["DP"])
        dp1 = optax.apply_updates(params["DP"], opt.update(g_dp, opt.init(params["DP"]))[0])
        (j_loss, j_acc), g = jax.value_and_grad(lambda r: loss({**r, "DP": dp1}, k2, True),
                                                has_aux=True)(rest)
        return j_loss, j_acc, {**optax.apply_updates(rest, opt.update(g, opt.init(rest))[0]),
                               "DP": dp1}

    # compiled with XLA's backend optimization off, as test_torch_sweep.py's quick_jit
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_loss, j_acc, new = jax.jit(step).lower(params).compile(
        compiler_options={"xla_backend_optimization_level": 0})(params)
    want = {p: np.asarray(v) for p, v in tree_items(jax.tree_util.tree_map(np.asarray, new))}

    noise = tuple(jax_noise(k, B, F).astype(np.float32) for k in (k1, k2))
    res = W.spawn(tmp_path, 4, "step", mesh_shape=(2, 2), tree=tree, batch=batch,
                  weight=weight, epsilon=1.0, noise=noise)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(j_loss), **TOL)
        np.testing.assert_allclose(r["acc"], float(j_acc), **TOL)
    for path, w in want.items():
        np.testing.assert_allclose(res[0]["params"][path], w, err_msg=path, **TOL)


@pytest.fixture(scope="module")
def dpsgd_meshless():
    """The meshless DP-SGD fit of the mesh tests: (init, result, the
    trained params), once for the module (the accountant takes ~20 s)."""
    tr = DPSGDTrainer(W.config(dp="DPSGD"), DPSGDConfig(2.0, epochs=1, batch_size=2,
                                                        learning_rate=LR), device="cpu")
    init = W.numpy_tree(tr.params)
    want = tr.fit(W.arrays(16, 1), W.arrays(8, 2), echo=False)
    return init, want, W.numpy_tree(tr.params)


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_shard_dpsgd_trainer_fit_equals_the_meshless_fit(tmp_path, shape, dpsgd_meshless):
    """``shard_dpsgd_trainer`` + ``DPSGDTrainer.fit``: one epoch over the
    Poisson windows (16 rows, batch 2, q 1/8: windows of 10 rows; the
    accountant is slow at a large q), the clip norms over the model group,
    the noise drawn whole and sliced, the sum over the data group; sigma
    equal, the history and the gathered trainable leaves within the mesh
    tolerances of the meshless fit (eight steps)."""
    res = W.spawn(tmp_path, shape[0] * shape[1], "dpsgd", mesh_shape=shape, n_train=16,
                  n_test=8)
    init, want, moved = dpsgd_meshless
    for r in res:
        assert r["sigma"] == want["sigma"]
        assert_history_close(r["history"], want["history"])
    assert_params_close(res[0]["params"], moved, init, steps=8)
    assert np.abs(moved["fc1/kernel"] - init["fc1/kernel"]).max() > 1e-4  # it trained


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=mesh_id)
def test_sweep_under_a_mesh_equals_the_meshless_sweep(tmp_path, shape):
    """Three members on a data axis of 2: the grid padded with a fourth
    ``__pad__`` member, dropped from the results and the records; each data
    rank trains its two members, and every rank returns every member's
    rows, equal to the meshless sweep's within the mesh tolerances."""
    tc_kw = dict(batch_size=4, learning_rate=LR, epochs=2)
    eps = (0.1, 1.0, 5.0)
    res = W.spawn(tmp_path, shape[0] * shape[1], "sweep", mesh_shape=shape, epsilons=eps,
                  tc_kw=tc_kw, n_train=8, n_test=4, log_root=str(tmp_path / "logs"))
    plain = SweepRunner(W.config(), TrainConfig(**tc_kw), [SweepMember(e) for e in eps],
                        device="cpu").run(W.arrays(8, 1), W.arrays(4, 2), echo=False)
    for r in res:
        assert [m["member"] for m in r] == [m["member"] for m in plain]
        for a, b in zip(r, plain):
            assert_history_close(a["history"], b["history"])
            assert a["f1_best"] == pytest.approx(b["f1_best"], abs=F1_ABS)
    assert sorted(os.listdir(tmp_path / "logs")) == \
        ["eps0.1_seed980616", "eps1.0_seed980616", "eps5.0_seed980616"]
    for name in os.listdir(tmp_path / "logs"):  # one writer each: no repeated rows
        assert len((tmp_path / "logs" / name / "metrics.jsonl").read_text().splitlines()) == 2


def test_mesh_refusals():
    tr = Trainer(W.config(), TrainConfig(share_phase_dropout=True), device="cpu")
    with pytest.raises(NotImplementedError, match="fast phase modes under a mesh"):
        shard_trainer(tr, TMESH.Mesh(1, 2))
    with pytest.raises(ValueError, match="do not split over 3 data ranks"):
        TSH.rows_of(TMESH.Mesh(3, 1), 8)


# ---------------------------------------------------------------------------
# The DCP backend
# ---------------------------------------------------------------------------

def test_save_pytree_dcp_under_a_mesh_writes_the_whole_tree_once(tmp_path):
    """Each rank of a (2, 2) mesh hands its shards; the checkpoint holds the
    whole tree, bit for bit."""
    path = str(tmp_path / "dcp_mesh")
    whole = W.spawn(tmp_path, 4, "dcp", mesh_shape=(2, 2), path=path)[0]
    back = TCK.load_pytree_dcp(path, device="cpu")
    got = {p: t.numpy() for p, t in tree_items(back)}
    assert sorted(got) == sorted(whole)
    for p in whole:
        np.testing.assert_array_equal(got[p], whole[p], err_msg=p)
    shutil.rmtree(path)  # ~150 MB: the suite keeps its tmp dirs
