"""The PyTorch port stands alone: no JAX, no optax, nothing of the JAX
package, no Triton (its kernels are CUDA C++ built by nvcc), and no quiet
fallback to the CPU when the card is missing."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "eeg_multimodal_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "eeg_multimodal_tpu", "triton")


def package_files():
    return sorted(os.path.join(d, f) for d, _, files in os.walk(PKG)
                  for f in files if f.endswith(".py"))


def port_modules():
    mods = []
    for path in package_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    bad = []
    files = package_files() + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) >= 15
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_importing_every_port_module_loads_no_jax():
    mods = port_modules()
    assert {"eeg_multimodal_torch.ops.dp_fused", "eeg_multimodal_torch.ops.attention",
            "eeg_multimodal_torch.train.api", "eeg_multimodal_torch.dp.dpsgd",
            "eeg_multimodal_torch.train.dpsgd_trainer",
            "eeg_multimodal_torch.experiments.drivers",
            "eeg_multimodal_torch.data.embedding", "eeg_multimodal_torch.data.tokenizer",
            "eeg_multimodal_torch.data.process", "eeg_multimodal_torch.data.image_transform",
            "eeg_multimodal_torch.models.vit", "eeg_multimodal_torch.models.resnet",
            "eeg_multimodal_torch.native"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    from eeg_multimodal_torch.models import fusion
    from eeg_multimodal_torch.train.api import TrainAndTest
    from eeg_multimodal_torch.train.trainer import StepFunctions, TrainConfig, Trainer

    cfg = fusion.config_for("ti", "lapacian_dropout")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StepFunctions(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fusion.init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainAndTest(compute_dtype="float32")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    # bf16 GEMMs accumulate in f32, as preferred_element_type=float32 does there
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


def test_embedding_entry_points_refuse_to_run_without_a_card():
    """``GetEmbedding`` and the towers' init and imports take the card by
    default, as the trainers do; nothing was built for the kernels."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    from eeg_multimodal_torch.data.embedding import GetEmbedding
    from eeg_multimodal_torch.models import resnet, vit
    from eeg_multimodal_torch.ops import attention as A

    gen = torch.Generator().manual_seed(0)
    small = vit.ViTConfig(width=64, layers=1, heads=4)
    for call in (lambda: GetEmbedding(["act"], ["test"]), lambda: vit.init(gen, small),
                 lambda: resnet.init(gen), lambda: vit.params_from_jax({}, small),
                 lambda: resnet.params_from_jax({})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert A._lib.cache_info().currsize == 0


def test_the_port_reads_no_file_of_the_jax_package():
    """Its data and sources are its own copies: no module names a path into
    ``eeg_multimodal_tpu`` in code (docstrings and comments may cite it)."""
    bad = []
    for path in package_files():
        tree = ast.parse(open(path).read(), path)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
        bad += [(path, node.value) for node in ast.walk(tree)
                if isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs and "eeg_multimodal_tpu" in node.value]
    assert not bad


def test_attention_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes the plain
    version itself (only ``fused_attention`` takes that path, on CPU
    tensors). It raises before anything is built."""
    from eeg_multimodal_torch.ops import attention as A

    q = torch.zeros(1, 2, 8, 64)
    bias, seed = torch.zeros(1, 8), torch.zeros(1, dtype=torch.int64)
    stats = torch.zeros(2, 1, 2, 8)
    launches = [k.launches for k in A.KERNELS]
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.attn_fwd(q, q, q, bias, seed, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.attn_bwd(q, q, q, bias, seed, 0.1, q, stats, q)
    with pytest.raises(ValueError, match="CUDA seed"):
        A.attn_dropout_mask(seed, 1, 2, 8, 0.1)
    assert [k.launches for k in A.KERNELS] == launches
    assert A._lib.cache_info().currsize == 0  # nothing was built
