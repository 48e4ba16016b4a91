"""The PyTorch port stands alone: no JAX, no optax, nothing of the JAX
package, no Triton (its kernels are CUDA C++ built by nvcc), and no quiet
fallback to the CPU when the card is missing."""
import ast
import os
import pickle
import subprocess
import sys

import numpy as np
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
            "eeg_multimodal_torch.native", "eeg_multimodal_torch.cli",
            "eeg_multimodal_torch.train.mlm", "eeg_multimodal_torch.train.pretext",
            "eeg_multimodal_torch.train.contrastive", "eeg_multimodal_torch.train.distill",
            "eeg_multimodal_torch.train.pipeline", "eeg_multimodal_torch.train.checkpoint",
            "eeg_multimodal_torch.train.trainer", "eeg_multimodal_torch.ops.optim",
            "eeg_multimodal_torch.utils.profiling", "eeg_multimodal_torch.parallel.mesh",
            "eeg_multimodal_torch.parallel.sharding", "eeg_multimodal_torch.parallel.train",
            "eeg_multimodal_torch.visualization.plot",
            "eeg_multimodal_torch.visualization.plot_new",
            "eeg_multimodal_torch.tools.import_hf_bert", "eeg_multimodal_torch.tools.recover_vocab",
            "eeg_multimodal_torch.tools.r5_modal_seeds",
            "eeg_multimodal_torch.tools.repro_fused_dp_scan_nan",
            "eeg_multimodal_torch.tools.r5_accuracy", "eeg_multimodal_torch.graft_entry",
            "eeg_multimodal_torch.scripts", "eeg_multimodal_torch.scripts.data"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_parallel_imports_no_jax():
    """The mesh, the sharding rules and the meshed trainers import nothing
    of JAX (the JAX package's parallel/ is jax.sharding through and
    through)."""
    code = (
        "import sys\n"
        "import eeg_multimodal_torch.parallel.mesh, eeg_multimodal_torch.parallel.sharding\n"
        "import eeg_multimodal_torch.parallel.train\n"
        "from eeg_multimodal_torch.parallel.mesh import make_mesh\n"
        "assert make_mesh().shape == {'data': 1, 'model': 1}\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_importing_visualization_loads_no_matplotlib(tmp_path):
    """matplotlib is imported inside the figure functions only: importing
    both modules loads none, and the record readers run where it cannot be
    imported at all (the card machine has none)."""
    rec = tmp_path / "run"
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import eeg_multimodal_torch.visualization.plot as P\n"
        "import eeg_multimodal_torch.visualization.plot_new as PN\n"
        "assert 'matplotlib' not in sys.modules\n"
        "sys.modules['matplotlib'] = None  # any import of it now raises\n"
        "from eeg_multimodal_torch.train.records import RunRecorder\n"
        f"r = RunRecorder({str(rec) + '/'!r}, echo=False)\n"
        "r.epoch(0, 0.7, 0.5, 0.6, 0.55, 0.5, 1.0)\n"
        f"rows = P.load_run({str(rec)!r})\n"
        "assert P.best_row(rows)['f1'] == 0.5\n"
        "assert P.dp_param_stats(np.zeros((1, 4)), 1.0)['w'].shape == (4,)\n"
        "try:\n"
        "    P.plot_training_curves({'a': rows}, 'x.png')\n"
        "except ImportError:\n"
        "    print('figures need matplotlib')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "figures need matplotlib"


def test_the_command_line_loads_no_jax(tmp_path):
    """``python -m eeg_multimodal_torch.cli``: its backends are imported
    inside ``main``, past the import check above, so run two subcommands
    (``process``, and ``distill`` on the CPU) and look at what they loaded."""
    rng = np.random.RandomState(0)
    raw = tmp_path / "task_1.txt"
    np.savetxt(raw, np.concatenate([np.arange(30)[:, None], rng.randint(-9, 9, (30, 55)),
                                    rng.randint(0, 2, (30, 1))], axis=1), fmt="%.1f")
    root = tmp_path / "root"
    real = tmp_path / "real.pickle"
    real.write_bytes(pickle.dumps(rng.randn(6, 4).astype(np.float32)))
    runs = [["process", str(raw), "--out", str(root / "data" / "processed")],
            ["distill", "--data_root", str(root), "--out", str(tmp_path / "out"), "--steps",
             "101", "--real_test_pickle", str(real), "--device", "cpu"]]
    code = (
        "import runpy, sys\n"
        f"for argv in {runs!r}:\n"
        "    sys.argv = ['cli'] + argv\n"
        "    try:\n"
        "        runpy.run_module('eeg_multimodal_torch.cli', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "out" / "data" / "embedding" / "act" / "img" / "clip_ViT_B_32"
            / "train.pickle").exists()


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


@pytest.mark.parametrize("module", ["eeg_multimodal_torch.bench",
                                    "eeg_multimodal_torch.tools.roofline_step",
                                    "eeg_multimodal_torch.tools.bench_attention",
                                    "eeg_multimodal_torch.examples.train_demo"])
def test_measurement_entry_points_refuse_to_run_without_a_card(module):
    """The bench, the step roofline, the attention table and ``train_demo``
    take the card unless told otherwise, and raise before they read any
    data or build anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    import importlib

    from eeg_multimodal_torch.ops import attention as A

    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(module).main([])
    assert A._lib.cache_info().currsize == 0


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


def test_pretext_entry_points_refuse_to_run_without_a_card(tmp_path):
    """The pretext trainers, the distiller, the pipeline and ``load_pytree``
    take the card by default, as the trainers do."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    from eeg_multimodal_torch.models.bert import BertConfig
    from eeg_multimodal_torch.models.vit import ViTConfig
    from eeg_multimodal_torch.train import checkpoint, contrastive, distill, mlm, pipeline

    path = str(tmp_path / "t.pickle")
    checkpoint.save_pytree(path, {"a": torch.ones(1)})
    tiny = BertConfig(vocab_size=8, hidden_size=64, num_layers=1, num_heads=1,
                      intermediate_size=8)
    for call in (lambda: mlm.MLMPretrainer(tiny),
                 lambda: contrastive.ContrastivePretrainer(ViTConfig(width=64, layers=1, heads=1)),
                 lambda: distill.CLIPDistiller(), lambda: checkpoint.load_pytree(path),
                 lambda: pipeline.pretrain_finetune(None, None, str(tmp_path), load_stat=path),
                 lambda: mlm.pretrain_finetune_mlm(str(tmp_path), str(tmp_path / "o"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


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


def test_remaining_entry_points_refuse_to_run_without_a_card_and_load_no_jax(tmp_path):
    """``r5_modal_seeds``, the NaN repro, the graft entry (its check and
    its dry run), ``scripts.data`` and ``r5_accuracy`` take the card unless
    told otherwise: each raises before it writes a file, builds a kernel or
    spawns a rank, in an interpreter that then holds no JAX."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    work = tmp_path / "work"
    work.mkdir()
    code = (
        "import os, sys\n"
        f"os.chdir({str(work)!r})\n"
        "from eeg_multimodal_torch import graft_entry\n"
        "from eeg_multimodal_torch.ops import attention as A\n"
        "from eeg_multimodal_torch.scripts import data\n"
        "from eeg_multimodal_torch.tools import r5_accuracy, r5_modal_seeds\n"
        "from eeg_multimodal_torch.tools import repro_fused_dp_scan_nan as repro\n"
        "r5_accuracy.R5 = os.path.join(os.getcwd(), 'r5')\n"
        "calls = [lambda: r5_modal_seeds.main(['--run_dir', 'none']), lambda: repro.main([]),\n"
        "         lambda: graft_entry.main([]), lambda: graft_entry.main(['dryrun', '2']),\n"
        "         lambda: data.main(['task_1.txt']), lambda: r5_accuracy.main(['tree'])]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('ran without a card')\n"
        "assert os.listdir('.') == [], os.listdir('.')\n"
        "assert A._lib.cache_info().currsize == 0\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
