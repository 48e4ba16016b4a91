"""The port's embedding path against the JAX package's, on the CPU.

From the same numpy inputs and weights: ``process`` writes the same bytes;
the act images are bit for bit the JAX package's and the EEG images within
rtol 1e-5 / atol 1e-6 of it and of scipy's ``interp1d`` (NaN where it
gives NaN); CLIP's visual tower and one CLIP block within rtol 1e-4 /
atol 1e-5 (f32, matmul sums in another order), ResNet-34 and its basic
block within rtol 1e-4 / atol 1e-4 (activations in the hundreds at He
init); the CLIP and torchvision state-dict imports give the same outputs in
both packages; ``GetEmbedding.run`` writes equal token pickles and image
pickles within rtol 1e-4 / atol 1e-5, each tree read by the other package's
loaders. At small widths: the ViT at width 64 or 128, 1-2 layers, 64x64
images where the transforms' 224x224 are not needed; ResNet-34 at its real
channels on two 64x64 images.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.data import datasets as JD
from eeg_multimodal_tpu.data import embedding as JE
from eeg_multimodal_tpu.data import image_transform as JIT
from eeg_multimodal_tpu.data import process as JP
from eeg_multimodal_tpu.models import resnet as JR
from eeg_multimodal_tpu.models import vit as JV
from eeg_multimodal_torch.data import datasets as TD
from eeg_multimodal_torch.data import embedding as TE
from eeg_multimodal_torch.data import image_transform as TIT
from eeg_multimodal_torch.data import process as TP
from eeg_multimodal_torch.models import resnet as TR
from eeg_multimodal_torch.models import vit as TV
from eeg_multimodal_torch.ops import attention as A

VIT_TOL = dict(rtol=1e-4, atol=1e-5)
RESNET_TOL = dict(rtol=1e-4, atol=1e-4)
IMG_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quick_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with XLA's backend optimization off:
    ResNet-34 compiles in 0.5 s instead of 11, with the same values within
    the tests' tolerances."""
    lowered = jax.jit(fn).lower(*args)
    return lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def count_fused(monkeypatch):
    """Count the ViT's calls into ``fused_attention``."""
    calls = []
    real = A.fused_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(A, "fused_attention", counted)
    return calls


# ---------------------------------------------------------------------------
# raw rows -> CSVs -> images
# ---------------------------------------------------------------------------

def write_raw(path, n, seed):
    """A task txt of n rows: time, 25 act, 30 EEG values, a binary label;
    non-integer features (halves among them) so the rounding is exercised."""
    rng = np.random.RandomState(seed)
    feats = np.round(rng.randn(n, 55) * 50, 1)
    feats[:5, :5] = [[0.5, 1.5, 2.5, -0.5, -1.5]] * 5  # ties round to even
    data = np.concatenate([np.arange(n)[:, None], feats, rng.randint(0, 2, (n, 1))], axis=1)
    np.savetxt(path, data)


def test_process_writes_the_jax_packages_bytes(tmp_path):
    """Two task files through both packages' ``process``: the six CSVs
    byte for byte, the RandomState(42) split of 63 rows (13 test)."""
    raws = [str(tmp_path / f"task_{i}.txt") for i in (1, 2)]
    write_raw(raws[0], 40, 0)
    write_raw(raws[1], 23, 1)
    TP.process(raws, str(tmp_path / "port"))
    JP.process(raws, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(f"{s}_{m}.csv" for s in ("train", "test")
                           for m in ("EEG", "act", "label"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert TP.EEG_CHANNELS == JP.EEG_CHANNELS and TP.ACT_CHANNELS == JP.ACT_CHANNELS
    tr, te = TP.train_test_split(63)
    np.testing.assert_array_equal(tr, JP.train_test_split(63)[0])
    assert len(te) == 13


def test_feature_loaders_equal_jax(tmp_path):
    """``load_feature_csv`` (a one-row file is (1, C)) and
    ``load_eeg_feature_csv`` read what the JAX package's read."""
    one = tmp_path / "one.csv"
    one.write_text("a,b,c\n1,-2,3\n")
    many = tmp_path / "many.csv"
    many.write_text("a,b\n" + "".join(f"{i},{-i}\n" for i in range(5)))
    for path in (one, many):
        got, want = TD.load_feature_csv(str(path)), JD.load_feature_csv(str(path))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert TD.load_feature_csv(str(one)).shape == (1, 3)
    legacy = tmp_path / "eeg.csv"
    legacy.write_text("EEG,label\n1 2 -3,1\n4 5,\n6,nan\n7 8,0.0\n")
    texts, labels = TD.load_eeg_feature_csv(str(legacy))
    want_texts, want_labels = JD.load_eeg_feature_csv(str(legacy))
    assert texts == want_texts and labels.dtype == np.int32
    np.testing.assert_array_equal(labels, want_labels)


def test_act_images_are_the_jax_packages_bit_for_bit():
    rows = np.random.RandomState(0).randint(-3000, 3000, (7, 25)).astype(np.float32)
    got = TIT.act_to_images(torch.from_numpy(rows)).numpy()
    assert got.shape == (7, 3, 224, 224) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(JIT.act_to_images(jnp.asarray(rows))))


def test_eeg_images_match_jax_and_scipy():
    """Within rtol 1e-5 / atol 1e-6 of the JAX package and of scipy's
    linear ``interp1d`` in f64 at the f32 sample points both packages use
    (``jnp.linspace``'s: f64's points lie up to an f32 ulp away, which at a
    slope of 29 moves a value by up to 1.9e-6, in JAX's images as in the
    port's); a constant row is NaN everywhere, as in the JAX package."""
    from scipy.interpolate import interp1d

    rows = np.random.RandomState(1).randint(-500, 500, (5, 30)).astype(np.float32)
    rows[3] = 7.0  # constant: (x - min) / (max - min) = 0 / 0
    got = TIT.eeg_to_images(torch.from_numpy(rows)).numpy()
    want = np.asarray(JIT.eeg_to_images(jnp.asarray(rows)))
    assert got.shape == (5, 3, 224, 224)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3]).all() and not np.isnan(got[[0, 1, 2, 4]]).any()
    ok = [0, 1, 2, 4]
    np.testing.assert_allclose(got[ok], want[ok], **IMG_TOL)
    r64 = rows[ok].astype(np.float64)
    norm = (r64 - r64.min(1, keepdims=True)) / np.ptp(r64, axis=1, keepdims=True)
    x = TIT.linspace01(224 * 224, "cpu").numpy().astype(np.float64)
    np.testing.assert_array_equal(x, np.asarray(jnp.linspace(0.0, 1.0, 224 * 224)))
    scipy_img = np.stack([interp1d(np.linspace(0, 1, 30), n)(x).reshape(224, 224) for n in norm])
    for c in range(3):
        np.testing.assert_allclose(got[ok, c], scipy_img, **IMG_TOL)
    np.testing.assert_array_equal(TIT.linspace01(30, "cpu").numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, 30)))


# ---------------------------------------------------------------------------
# CLIP's visual tower
# ---------------------------------------------------------------------------

class TorchCLIPBlock(torch.nn.Module):
    """CLIP ResidualAttentionBlock replica (pre-LN, QuickGELU), as
    tests/test_embedding.py has it."""

    def __init__(self, w, heads):
        super().__init__()
        self.ln_1 = torch.nn.LayerNorm(w)
        self.attn = torch.nn.MultiheadAttention(w, heads, batch_first=True)
        self.ln_2 = torch.nn.LayerNorm(w)
        self.c_fc = torch.nn.Linear(w, 4 * w)
        self.c_proj = torch.nn.Linear(4 * w, w)

    def forward(self, x):
        y = self.ln_1(x)
        x = x + self.attn(y, y, y, need_weights=False)[0]
        y = self.ln_2(x)
        h = self.c_fc(y)
        h = h * torch.sigmoid(1.702 * h)
        return x + self.c_proj(h)


@pytest.mark.parametrize("W,H", [(64, 4), (128, 2)], ids=["D16_plain", "D64_kernel"])
def test_clip_block_matches_jax_and_torch(W, H, monkeypatch):
    """One block from the replica's weights: the port against the JAX
    package's block and the replica. At D = 64 the attention goes through
    ``fused_attention`` (the kernel on the card), at D = 16 the plain
    branch."""
    torch.manual_seed(0)
    blk = TorchCLIPBlock(W, H).eval()
    x = np.random.RandomState(2).randn(2, 9, W).astype(np.float32)
    with torch.no_grad():
        replica = blk(torch.from_numpy(x)).numpy()

    def t(p):
        return p.detach().numpy()

    tree = {
        "ln_1": {"scale": t(blk.ln_1.weight), "bias": t(blk.ln_1.bias)},
        "attn": {"in_proj_kernel": t(blk.attn.in_proj_weight).T,
                 "in_proj_bias": t(blk.attn.in_proj_bias),
                 "out_proj": {"kernel": t(blk.attn.out_proj.weight).T,
                              "bias": t(blk.attn.out_proj.bias)}},
        "ln_2": {"scale": t(blk.ln_2.weight), "bias": t(blk.ln_2.bias)},
        "mlp": {"c_fc": {"kernel": t(blk.c_fc.weight).T, "bias": t(blk.c_fc.bias)},
                "c_proj": {"kernel": t(blk.c_proj.weight).T, "bias": t(blk.c_proj.bias)}},
    }
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    xj = jnp.asarray(x)
    want = xj + JV._attn(jp["attn"], JV._ln(jp["ln_1"], xj), H)
    want = want + JV.linear(jp["mlp"]["c_proj"],
                            JV.quick_gelu(JV.linear(jp["mlp"]["c_fc"], JV._ln(jp["ln_2"], want))))
    calls = count_fused(monkeypatch)
    p = jax.tree_util.tree_map(lambda a: torch.tensor(np.array(a)), tree)
    with torch.inference_mode():
        got = TV.block(p, torch.from_numpy(x), H).numpy()
    assert calls == ([(2, H, 9, 64)] if W // H == 64 else [])
    np.testing.assert_allclose(got, np.asarray(want), **VIT_TOL)
    np.testing.assert_allclose(got, replica, **VIT_TOL)


def small_cfgs(patch, width=64, heads=4, layers=2):
    kw = dict(patch_size=patch, width=width, layers=layers, heads=heads, image_size=64)
    return JV.ViTConfig(**kw), TV.ViTConfig(**kw)


@pytest.mark.parametrize("patch", [32, 16])
def test_vit_encode_image_matches_jax(patch, monkeypatch):
    """``encode_image`` from the JAX init's weights through
    ``params_from_jax``: (3, 512) features within rtol 1e-4 / atol 1e-5,
    at S = 5 (patch 32) and S = 17 (patch 16)."""
    jc, tc = small_cfgs(patch)
    tree = np_tree(JV.init(jax.random.PRNGKey(patch), jc))
    imgs = np.random.RandomState(patch).randn(3, 3, 64, 64).astype(np.float32)
    want = np.asarray(quick_jit(lambda p, x: JV.encode_image(p, x, jc), tree, imgs))
    params = TV.params_from_jax(tree, tc, device="cpu")
    with torch.inference_mode():
        got = TV.encode_image(params, torch.from_numpy(imgs), tc).numpy()
    assert got.shape == (3, 512)
    np.testing.assert_allclose(got, want, **VIT_TOL)
    assert tc.seq_len == {32: 5, 16: 17}[patch]


def synthetic_clip_state_dict(cfg, seed):
    """An OpenAI CLIP visual state dict of ``cfg``'s shapes, numpy leaves,
    the nonzero biases and LayerNorms the init would leave at 0 and 1."""
    rng = np.random.RandomState(seed)
    W, P = cfg.width, cfg.patch_size

    def r(*shape, scale=None):
        return (rng.randn(*shape) * (scale or W ** -0.5)).astype(np.float32)

    sd = {"visual.conv1.weight": r(W, 3, P, P), "visual.class_embedding": r(W),
          "visual.positional_embedding": r(cfg.seq_len, W), "visual.proj": r(W, cfg.output_dim)}
    for name in ("ln_pre", "ln_post"):
        sd[f"visual.{name}.weight"] = 1 + r(W, scale=0.1)
        sd[f"visual.{name}.bias"] = r(W, scale=0.1)
    for i in range(cfg.layers):
        base = f"visual.transformer.resblocks.{i}."
        for name in ("ln_1", "ln_2"):
            sd[base + name + ".weight"] = 1 + r(W, scale=0.1)
            sd[base + name + ".bias"] = r(W, scale=0.1)
        sd[base + "attn.in_proj_weight"] = r(3 * W, W)
        sd[base + "attn.in_proj_bias"] = r(3 * W, scale=0.1)
        for name, (o, i_) in (("attn.out_proj", (W, W)), ("mlp.c_fc", (4 * W, W)),
                              ("mlp.c_proj", (W, 4 * W))):
            sd[base + name + ".weight"] = r(o, i_)
            sd[base + name + ".bias"] = r(o, scale=0.1)
    return sd


def test_clip_state_dict_import_matches_jax():
    """The same state dict (numpy leaves; and torch leaves for the port)
    through both packages' ``from_clip_state_dict``: equal trees, equal
    configs, the same features."""
    jc, tc = small_cfgs(32, width=128, heads=2)
    sd = synthetic_clip_state_dict(tc, 3)
    jparams, jcfg = JV.from_clip_state_dict(sd, jc)
    tparams, tcfg = TV.from_clip_state_dict(sd, tc, device="cpu")
    t2, _ = TV.from_clip_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, tc, "cpu")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for (a, b, c) in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(tparams),
                         jax.tree_util.tree_leaves(t2)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, c)
    imgs = np.random.RandomState(4).randn(2, 3, 64, 64).astype(np.float32)
    want = np.asarray(quick_jit(lambda p, x: JV.encode_image(p, x, jc), np_tree(jparams), imgs))
    with torch.inference_mode():
        got = TV.encode_image(tparams, torch.from_numpy(imgs), tc).numpy()
    np.testing.assert_allclose(got, want, **VIT_TOL)


# ---------------------------------------------------------------------------
# ResNet-34
# ---------------------------------------------------------------------------

def test_resnet_basic_block_matches_jax():
    """A strided block with a downsample and running statistics of its own."""
    rng = np.random.RandomState(3)

    def bn(c):
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.randn(c).astype(np.float32),
                "mean": rng.randn(c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}

    block = {"conv1": rng.randn(16, 8, 3, 3).astype(np.float32) * 0.2, "bn1": bn(16),
             "conv2": rng.randn(16, 16, 3, 3).astype(np.float32) * 0.2, "bn2": bn(16),
             "downsample": {"conv": rng.randn(16, 8, 1, 1).astype(np.float32) * 0.3,
                            "bn": bn(16)}}
    x = rng.randn(2, 8, 16, 16).astype(np.float32)
    want = np.asarray(quick_jit(lambda p, v: JR._basic_block(p, v, 2), block, x))
    p = jax.tree_util.tree_map(torch.from_numpy, block)
    got = TR._basic_block(p, torch.from_numpy(x), 2).numpy()
    assert got.shape == (2, 16, 8, 8)
    np.testing.assert_allclose(got, want, **RESNET_TOL)


def synthetic_torchvision_state_dict(seed):
    """A torchvision resnet34 state dict (numpy leaves) with running
    statistics away from the init's, and the fc the import leaves out."""
    rng = np.random.RandomState(seed)
    sd = {}

    def bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".bias"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[name + ".running_mean"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.array(7)

    def conv(name, o, i, k):
        sd[name] = (rng.randn(o, i, k, k) * np.sqrt(2.0 / (i * k * k))).astype(np.float32)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    in_c = 64
    for li, (n, c) in enumerate(zip(TR.LAYERS, TR.CHANNELS)):
        for b in range(n):
            base = f"layer{li + 1}.{b}."
            conv(base + "conv1.weight", c, in_c, 3)
            bn(base + "bn1", c)
            conv(base + "conv2.weight", c, c, 3)
            bn(base + "bn2", c)
            if b == 0 and li > 0:
                conv(base + "downsample.0.weight", c, in_c, 1)
                bn(base + "downsample.1", c)
            in_c = c
    sd["fc.weight"], sd["fc.bias"] = np.zeros((1000, 512), np.float32), np.zeros(1000, np.float32)
    return sd


def test_resnet34_features_match_jax():
    """ResNet-34 at its real channels on two 64x64 images, from the JAX
    init's tree (``params_from_jax``) and from one torchvision state dict
    read by both packages: (2, 512) features within rtol 1e-4 / atol 1e-4."""
    imgs = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    trees = [np_tree(JR.init(jax.random.PRNGKey(0)))]
    sd = synthetic_torchvision_state_dict(5)
    trees.append(np_tree(JR.from_torchvision_state_dict(sd)))
    lowered = jax.jit(JR.features).lower(trees[0], imgs)
    compiled = lowered.compile(compiler_options={"xla_backend_optimization_level": 0})
    ports = [TR.params_from_jax(trees[0], device="cpu"),
             TR.from_torchvision_state_dict(sd, device="cpu")]
    for tree, params in zip(trees, ports):
        want = np.asarray(compiled(tree, imgs))
        got = TR.features(params, torch.from_numpy(imgs)).numpy()
        assert got.shape == (2, 512) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **RESNET_TOL)
    with pytest.raises(ValueError, match="block"):
        bad = dict(trees[0], layers=[list(trees[0]["layers"][1])] + trees[0]["layers"][1:])
        TR.params_from_jax(bad, device="cpu")


def test_random_init_is_deterministic():
    """One generator seed, one tree; another seed, another tree."""
    cfg = TV.ViTConfig(patch_size=32, width=64, layers=1, heads=4, image_size=64)
    a, b = (TV.init(torch.Generator().manual_seed(0), cfg, "cpu") for _ in range(2))
    c = TV.init(torch.Generator().manual_seed(1), cfg, "cpu")
    la, lb = (jax.tree_util.tree_leaves(t) for t in (a, b))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["conv"], c["conv"])
    ra, rb = (TR.init(torch.Generator().manual_seed(0), "cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(ra),
                                                 jax.tree_util.tree_leaves(rb)))
    with pytest.raises(ValueError, match="blocks"):
        TV.params_from_jax(np_tree(JV.init(jax.random.PRNGKey(0), JV.ViTConfig(
            patch_size=32, width=64, layers=2, heads=4, image_size=64))), cfg, "cpu")


# ---------------------------------------------------------------------------
# GetEmbedding end to end
# ---------------------------------------------------------------------------

SMALL = dict(patch_size=32, width=128, layers=1, heads=2)  # S = 50, D = 64
N_ROWS = {"train": 18, "test": 5}  # 16 + 2 and a lone short chunk


def write_processed(root, seed):
    rng = np.random.RandomState(seed)
    out = os.path.join(root, "data", "processed")
    os.makedirs(out)
    for split, n in N_ROWS.items():
        for modal, c in (("EEG", 30), ("act", 25)):
            rows = rng.randint(-300, 300, size=(n, c))
            with open(os.path.join(out, f"{split}_{modal}.csv"), "w") as f:
                f.write(",".join(f"c{i}" for i in range(c)) + "\n")
                f.writelines(",".join(str(v) for v in row) + "\n" for row in rows)


def tree_files(root):
    base = os.path.join(root, "data", "embedding")
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, files in os.walk(base) for f in files)


def load(root, rel):
    with open(os.path.join(root, "data", "embedding", rel), "rb") as f:
        return pickle.load(f)


IMG = [["clip", "ViT-B/32"]]
TXT = [["bert", "bert-base-uncased"], ["bert", "bert-base-cased"]]


def test_get_embedding_matches_jax(tmp_path, monkeypatch):
    """Both packages' ``GetEmbedding.run`` over the same CSVs and the same
    CLIP weights file (a small tower: ``ViTConfig.for_coef`` patched in
    each): the same files; token pickles equal; image pickles (N, 512)
    float32 within rtol 1e-4 / atol 1e-5; numpy only; each package's
    loaders read the other's tree. The port's tower took ``fused_attention``
    (the kernel on the card) once a chunk and layer, the last chunk
    unpadded."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    for root in (jroot, troot):
        write_processed(root, 0)
    weights = str(tmp_path / "clip.pickle")
    with open(weights, "wb") as f:
        pickle.dump(synthetic_clip_state_dict(TV.ViTConfig(**SMALL), 6), f)
    monkeypatch.setattr(JV.ViTConfig, "for_coef", staticmethod(lambda c: JV.ViTConfig(**SMALL)))
    monkeypatch.setattr(TV.ViTConfig, "for_coef", staticmethod(lambda c: TV.ViTConfig(**SMALL)))
    JE.GetEmbedding(["act", "EEG"], ["train", "test"], data_root=jroot,
                    clip_weights=weights).run(IMG, TXT)
    calls = count_fused(monkeypatch)
    job = TE.GetEmbedding(["act", "EEG"], ["train", "test"], data_root=troot,
                          clip_weights=weights, device="cpu")
    job.run(IMG, TXT)
    # one call per chunk of 16 rows and layer: 2 + 1 chunks per modal
    assert sorted(calls) == sorted([(16, 2, 50, 64)] * 2 + [(2, 2, 50, 64)] * 2
                                   + [(5, 2, 50, 64)] * 2)
    files = tree_files(jroot)
    assert len(files) == 12 and tree_files(troot) == files
    for rel in files:
        got, want = load(troot, rel), load(jroot, rel)
        if "/img/" in rel:
            assert type(got) is np.ndarray and got.dtype == np.float32
            assert got.shape == (N_ROWS[os.path.basename(rel).split(".")[0]], 512)
            np.testing.assert_allclose(got, want, **VIT_TOL)
        else:
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert sorted(g) == ["attention_mask", "input_ids"]
                for k in g:
                    assert type(g[k]) is np.ndarray and g[k].dtype == np.int32
                    assert g[k].shape == (512,)
                    np.testing.assert_array_equal(g[k], w[k])
    # each package's loaders on the other's tree
    for rel in files:
        for a, b in ((troot, jroot), (jroot, troot)):
            path = os.path.join(a, "data", "embedding", rel)
            if "/img/" in rel:
                np.testing.assert_array_equal(TD.load_embedding_pickle(path),
                                              np.asarray(load(a, rel), np.float32))
                np.testing.assert_array_equal(JD.load_embedding_pickle(path),
                                              TD.load_embedding_pickle(path))
            else:
                for k in ("input_ids", "attention_mask"):
                    np.testing.assert_array_equal(TD.load_bert_pickle(path)[k],
                                                  JD.load_bert_pickle(path)[k])


def test_get_embedding_random_init_is_deterministic(tmp_path, monkeypatch):
    """No weights file: two runs into two roots write equal trees."""
    monkeypatch.setattr(TV.ViTConfig, "for_coef", staticmethod(lambda c: TV.ViTConfig(**SMALL)))
    roots = [str(tmp_path / r) for r in ("a", "b")]
    for root in roots:
        write_processed(root, 1)
        TE.GetEmbedding(["EEG"], ["test"], data_root=root, device="cpu").run(IMG, TXT[:1])
    files = tree_files(roots[0])
    assert files == tree_files(roots[1]) == ["EEG/img/clip_ViT_B_32/test.pickle",
                                             "EEG/txt/bert_bert_base_uncased/test.pickle"]
    a, b = (load(r, files[0]) for r in roots)
    assert np.isfinite(a).all() and a.shape == (5, 512)
    np.testing.assert_array_equal(a, b)
    assert TE.standardize_coef("ViT-B/16") == JE.standardize_coef("ViT-B/16") == "ViT_B_16"
    assert TE.ENCODE_BATCH == JE.ENCODE_BATCH == 16
