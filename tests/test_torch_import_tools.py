"""The port's host tools and data entry points against the JAX package's,
on the CPU: ``models/bert.py::from_torch_state_dict``, the
``import_hf_bert`` tool (its own ``.safetensors`` reader, ``.bin`` files,
``--vocab``, a ``gamma``/``beta`` state dict), ``recover_vocab``,
``r5_modal_seeds``, ``scripts.data`` and ``r5_accuracy`` (its commands
against the shell script's, run with a recording ``python``).

Tolerances: trees leaf for leaf bit for bit (the same f32 values copied);
the imported BERT's forward against JAX's at rtol 1e-5 / atol 1e-5 (f32,
12 narrow layers); files byte for byte; the seeds' rows exactly (the same
port code on the same CPU)."""
import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.train import checkpoint as JC
from eeg_multimodal_torch.data.compact_vocab import build_compact_vocab
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.train import checkpoint as TC
from eeg_multimodal_torch.utils.trees import tree_items
from test_torch_examples import arguments, jax_parser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# narrow BERT layers (one 64-wide head) at BERT-base's depth: the tool
# imports BertConfig(vocab_size=V), 12 layers
NARROW = dict(hidden_size=64, num_heads=1, intermediate_size=128, max_position_embeddings=40)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_file(path, name):
    """A module from a file of the repo (the JAX package's scripts)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chip_smoke():
    return load_file("chip_smoke.py", "chip_smoke_helpers")


def bert_state_dict(vocab, layers, seed, prefix="", ln=("weight", "bias")):
    """A synthetic HF ``BertModel`` state dict (torch tensors, f32) of the
    NARROW widths: every key of the layout, normal draws from ``seed``."""
    rng = np.random.RandomState(seed)
    H, I, P = NARROW["hidden_size"], NARROW["intermediate_size"], NARROW["max_position_embeddings"]
    sd = {}

    def put(name, *shape):
        sd[prefix + name] = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.1)

    def dense(name, n_in, n_out):
        put(name + ".weight", n_out, n_in)
        put(name + ".bias", n_out)

    def norm(name):
        put(f"{name}.{ln[0]}", H)
        put(f"{name}.{ln[1]}", H)

    put("embeddings.word_embeddings.weight", vocab, H)
    put("embeddings.position_embeddings.weight", P, H)
    put("embeddings.token_type_embeddings.weight", 2, H)
    norm("embeddings.LayerNorm")
    for i in range(layers):
        base = f"encoder.layer.{i}."
        for m in ("query", "key", "value"):
            dense(base + "attention.self." + m, H, H)
        dense(base + "attention.output.dense", H, H)
        norm(base + "attention.output.LayerNorm")
        dense(base + "intermediate.dense", H, I)
        dense(base + "output.dense", I, H)
        norm(base + "output.LayerNorm")
    dense("pooler.dense", H, H)
    return sd


def assert_same_tree(port, jax_tree):
    got = {p: t.numpy() for p, t in tree_items(port)}
    want = {p: np.asarray(a) for p, a in tree_items(jax_tree)}
    assert sorted(got) == sorted(want)
    for p in got:
        assert got[p].dtype == np.float32 and got[p].shape == want[p].shape, p
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


# ---------------------------------------------------------------------------
# from_torch_state_dict and the tools' arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", ["", "bert."])
def test_from_torch_state_dict_equals_jax(prefix):
    """A 2-layer synthetic BERT: tensors and numpy values alike, leaf for
    leaf the JAX tree; a key the layout needs raises the same KeyError."""
    sd = bert_state_dict(50, 2, 0, prefix)
    cfg = TB.BertConfig(vocab_size=50, num_layers=2, **NARROW)
    jcfg = JB.BertConfig(vocab_size=50, num_layers=2, **NARROW)
    want = JB.from_torch_state_dict(sd, jcfg, prefix=prefix)
    assert_same_tree(TB.from_torch_state_dict(sd, cfg, prefix=prefix, device="cpu"), want)
    as_numpy = {k: v.numpy() for k, v in sd.items()}
    assert_same_tree(TB.from_torch_state_dict(as_numpy, cfg, prefix=prefix, device="cpu"), want)
    del sd[prefix + "encoder.layer.1.output.dense.bias"]
    for fn, c in ((JB.from_torch_state_dict, jcfg),
                  (lambda *a, **k: TB.from_torch_state_dict(*a, **k, device="cpu"), cfg)):
        with pytest.raises(KeyError, match="encoder.layer.1.output.dense.bias"):
            fn(sd, c, prefix=prefix)


@pytest.mark.parametrize("name", ["import_hf_bert", "recover_vocab", "r5_modal_seeds"])
def test_tool_arguments_equal_the_jax_scripts(name, monkeypatch):
    """``r5_modal_seeds.py`` runs at import: its parser is taken by running
    it up to ``parse_args``. ``recover_vocab``'s ``--reference`` defaults to
    the port's ``reference_dir()``, the JAX tool's to the checkout named
    ``reference`` in its machine's home."""
    from eeg_multimodal_torch.data.datasets import reference_dir

    port = arguments(importlib.import_module(f"eeg_multimodal_torch.tools.{name}").parser())
    want = arguments(jax_parser(f"tools/{name}.py", monkeypatch))
    if name == "recover_vocab":
        (opts, default, *rest), (jopts, jdefault, *jrest) = port["reference"], want["reference"]
        assert default == reference_dir() and os.path.basename(jdefault) == "reference"
        assert (opts, *rest) == (jopts, *jrest)
        port["reference"] = want["reference"]
    assert port == want


# ---------------------------------------------------------------------------
# import_hf_bert
# ---------------------------------------------------------------------------

def test_safetensors_reader_equals_the_package(tmp_path):
    """Every dtype the reader reads, scalars and empty tensors among them,
    with metadata: the same names, dtypes, shapes and bits as
    ``safetensors.torch.load_file``."""
    from safetensors.torch import load_file, save_file

    from eeg_multimodal_torch.tools.import_hf_bert import SAFETENSORS_DTYPES, read_safetensors

    gen = torch.Generator().manual_seed(0)
    tensors = {}
    for name, dtype in SAFETENSORS_DTYPES.items():
        if dtype.is_floating_point:
            t = torch.randn(3, 5, generator=gen).to(dtype)
        elif dtype == torch.bool:
            t = torch.rand(3, 5, generator=gen) < 0.5
        else:
            low = 0 if dtype == torch.uint8 else -100
            t = torch.randint(low, 100, (3, 5), generator=gen, dtype=torch.int64).to(dtype)
        tensors[name] = t
        tensors[name + "_scalar"] = t[0, 0].clone()
        tensors[name + "_empty"] = t[:0].clone()
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def write_vocab_txt(path):
    """A BERT-like vocab.txt: [PAD], unused slots, the specials at 100-103,
    then numeric pieces; returns its size."""
    lines = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
    lines += ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "-"] + [str(n) for n in range(200)]
    lines += ["##" + d for d in "0123456789"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)


def run_main(main, argv, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", ["tool"] + argv)
        return main()


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_import_hf_bert_equals_the_jax_tool(fmt, tmp_path, monkeypatch, capsys):
    """An HF directory of a synthetic BERT-base-deep state dict (narrow
    widths) and its vocab.txt, as ``.bin`` and as ``.safetensors``: the
    port's tree (read back by ``load_pytree``) equals the JAX tool's leaf for
    leaf and JAX's ``from_torch_state_dict`` of the state dict; its forward
    through the port's BERT equals JAX's; the printed lines and the
    ``--vocab`` JSON are the JAX tool's."""
    from safetensors.torch import save_file

    from eeg_multimodal_torch.tools import import_hf_bert as T

    J = load_file("tools/import_hf_bert.py", "jax_import_hf_bert")
    hf = tmp_path / "hf"
    hf.mkdir()
    V = write_vocab_txt(hf / "vocab.txt")
    sd = bert_state_dict(V, 12, 1)
    if fmt.endswith(".bin"):
        torch.save(sd, hf / fmt)
    else:
        save_file(sd, str(hf / fmt))
    outs = {}
    for who, main in (("jax", J.main), ("port", T.main)):
        run_main(main, [str(hf), str(tmp_path / f"{who}.pickle"), "--vocab",
                        str(tmp_path / f"{who}.json")], monkeypatch)
        outs[who] = capsys.readouterr().out.replace(f"/{who}.", "/<who>.")
    assert outs["port"] == outs["jax"]
    assert outs["port"] == (f"wrote {tmp_path}/<who>.pickle (vocab_size={V})\n"
                            f"wrote {tmp_path}/<who>.json\n")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()

    port = TC.load_pytree(str(tmp_path / "port.pickle"), device="cpu")
    assert_same_tree(port, JC.load_pytree(str(tmp_path / "jax.pickle")))
    jcfg = JB.BertConfig(vocab_size=V, **NARROW)
    assert_same_tree(port, JB.from_torch_state_dict(sd, jcfg))

    rng = np.random.RandomState(2)
    ids = rng.randint(0, V, (3, 16))
    mask = np.ones((3, 16), np.int32)
    mask[1, 9:] = 0
    got = TB.apply(port, torch.from_numpy(ids), torch.from_numpy(mask),
                   TB.BertConfig(vocab_size=V, **NARROW))
    want = JB.apply(JC.load_pytree(str(tmp_path / "jax.pickle")), jnp.asarray(ids, jnp.int32),
                    jnp.asarray(mask), jcfg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)


@pytest.mark.parametrize("prefix", [[], ["--prefix", "bert."]])
def test_gamma_beta_state_dict_fails_as_in_the_jax_tool(prefix, tmp_path, monkeypatch):
    """The original ``bert-base-uncased`` checkpoint's layout (LayerNorms
    named gamma / beta, keys under ``bert.`` beside ``cls.*``): neither tool
    maps the names, so both raise the same KeyError (the first key the
    layout reads that the file lacks) and write nothing."""
    from eeg_multimodal_torch.tools import import_hf_bert as T

    J = load_file("tools/import_hf_bert.py", "jax_import_hf_bert")
    sd = bert_state_dict(60, 12, 3, prefix="bert.", ln=("gamma", "beta"))
    sd["cls.predictions.bias"] = torch.zeros(60)
    sd["cls.predictions.transform.dense.weight"] = torch.zeros(64, 64)
    path = tmp_path / "pytorch_model.bin"
    torch.save(sd, path)
    errors = {}
    for who, main in (("jax", J.main), ("port", T.main)):
        with pytest.raises(KeyError) as e:
            run_main(main, [str(path), str(tmp_path / f"{who}.pickle")] + prefix, monkeypatch)
        errors[who] = e.value.args
        assert not (tmp_path / f"{who}.pickle").exists()
    assert errors["port"] == errors["jax"]
    want = "bert.embeddings.LayerNorm.weight" if prefix else "embeddings.word_embeddings.weight"
    assert errors["port"] == (want,)


# ---------------------------------------------------------------------------
# recover_vocab
# ---------------------------------------------------------------------------

def test_recover_vocab_equals_the_jax_tool(tmp_path, monkeypatch, capsys):
    """A seeded mini-reference whose ids are its texts' encoding: the same
    JSON byte for byte and the same line, every row byte-exact."""
    from eeg_multimodal_torch.tools import recover_vocab as T

    J = load_file("tools/recover_vocab.py", "jax_recover_vocab")
    ref = chip_smoke().write_mini_reference(str(tmp_path / "ref"), n_rows=60, raw_rows=(20,))
    lines = {}
    for who, main in (("jax", J.main), ("port", T.main)):
        run_main(main, ["--reference", ref, "--out", str(tmp_path / f"{who}.json")],
                 monkeypatch)
        lines[who] = capsys.readouterr().out.replace(f"/{who}.", "/<who>.")
    assert lines["port"] == lines["jax"]
    assert lines["port"].strip().endswith("memoized words, 60/60 rows byte-exact")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_recover_vocab_names_a_class_it_cannot_unpickle(tmp_path, monkeypatch):
    """A pickle of objects of a package this interpreter lacks: the error
    names the class, and nothing is written."""
    from eeg_multimodal_torch.tools import recover_vocab as T

    ref = chip_smoke().write_mini_reference(str(tmp_path / "ref"), n_rows=4, raw_rows=(20,))
    path = os.path.join(ref, "feature", "EEG", "test_bert.pickle")
    # pickled while a module of that name exists, read after it is gone
    lookalike = types.ModuleType("transformers_lookalike")

    class BatchEncoding(dict):
        pass

    BatchEncoding.__module__ = lookalike.__name__
    BatchEncoding.__qualname__ = "BatchEncoding"
    lookalike.BatchEncoding = BatchEncoding
    monkeypatch.setitem(sys.modules, lookalike.__name__, lookalike)
    with open(path, "wb") as f:
        pickle.dump([BatchEncoding(input_ids=[101, 102])], f)
    monkeypatch.delitem(sys.modules, lookalike.__name__)
    with pytest.raises(ModuleNotFoundError, match="transformers_lookalike.BatchEncoding"):
        T.main(["--reference", ref, "--out", str(tmp_path / "v.json")])
    assert not (tmp_path / "v.json").exists()


# ---------------------------------------------------------------------------
# r5_modal_seeds
# ---------------------------------------------------------------------------

def write_ti_tree(root, n, seed):
    """The files the ti pairing reads: labels, the EEG token pickles
    (BERT uncased) and the act CLIP ViT-B/32 arrays, ``n[split]`` rows."""
    rng = np.random.RandomState(seed)
    ids_all = []
    for split, rows in n.items():
        os.makedirs(os.path.join(root, "data", "processed"), exist_ok=True)
        with open(os.path.join(root, "data", "processed", f"{split}_label.csv"), "w") as f:
            f.write("label\n" + "".join(f"{v}\n" for v in rng.randint(0, 2, rows)))
        items = []
        for _ in range(rows):
            k = rng.randint(4, 9)
            ids = np.zeros(512, np.int64)
            ids[:k] = [101, *rng.randint(1000, 1300, k - 2), 102]
            items.append({"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)})
            ids_all.append(ids)
        for rel, obj in (("EEG/txt/bert_bert_base_uncased", items),
                         ("act/img/clip_ViT_B_32", rng.randn(rows, 512).astype(np.float32))):
            d = os.path.join(root, "data", "embedding", rel)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{split}.pickle"), "wb") as f:
                pickle.dump(obj, f)
    return ids_all


def test_r5_modal_seeds_equals_train_and_test_per_seed(tmp_path, capsys):
    """One epoch at two seeds from a run directory of a compact-vocab
    BERT-base: each seed's row is ``TrainAndTest.train`` of CompareModal's ti
    config from the scattered encoder, exactly; summary.json has the JAX
    tool's keys."""
    from eeg_multimodal_torch.examples.pretrained import expanded_encoder, load_run
    from eeg_multimodal_torch.experiments.drivers import CompareModal
    from eeg_multimodal_torch.tools import r5_modal_seeds as T
    from eeg_multimodal_torch.train.api import TrainAndTest

    tree, run = str(tmp_path / "tree"), str(tmp_path / "run")
    vocab = build_compact_vocab(write_ti_tree(tree, {"train": 8, "test": 8}, 0))
    os.makedirs(run)
    TC.save_pytree(os.path.join(run, "bert_mlm.pickle"),
                   TB.init(torch.Generator().manual_seed(4), TB.BertConfig(vocab_size=vocab.size),
                           "cpu"))
    vocab.save(os.path.join(run, "compact_vocab.npz"))
    out = str(tmp_path / "out")
    summary = T.main(["--run_dir", run, "--data_root", tree, "--out", out, "--epochs", "1",
                      "--seeds", "1,2"], device="cpu")
    assert json.load(open(os.path.join(out, "summary.json"))) == summary
    assert sorted(summary) == ["acc_mean", "acc_std", "f1_mean", "f1_std", "reference", "rows"]
    assert summary["reference"] == 0.977
    assert "[modal3] seed 1: acc" in capsys.readouterr().out
    bert = expanded_encoder(*load_run(run, "cpu"))
    for row in summary["rows"]:
        job = TrainAndTest(epochs=1, data_root=tree, artifacts_root=str(tmp_path / "ref"),
                           bert_params=bert, seed=row["seed"], device="cpu")
        res = job.train(**CompareModal(python_job=job).configs()[0])
        best = res["best"] or max(res["history"], key=lambda h: h["f1"])
        assert row == {"seed": row["seed"], "best_acc": best["test_acc"],
                       "best_f1": best["f1"], "epoch": best["epoch"]}
    accs = [r["best_acc"] for r in summary["rows"]]
    assert summary["acc_mean"] == float(np.mean(accs))


# ---------------------------------------------------------------------------
# scripts.data
# ---------------------------------------------------------------------------

SMALL_VIT = dict(patch_size=32, width=128, layers=1, heads=2)  # S = 50, D = 64


def tree_files(root):
    base = os.path.join(root, "data")
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, files in os.walk(base) for f in files)


def test_scripts_data_writes_the_tree_cli_embed_writes(tmp_path, monkeypatch):
    """80 raw rows (64 / 16) through ``scripts.data`` in one directory and
    ``cli process`` + ``cli embed`` in another (small CLIP towers through a
    patched ``ViTConfig.for_coef``; ResNet-34 at its width): the same files,
    byte for byte."""
    from eeg_multimodal_torch import cli
    from eeg_multimodal_torch.models import vit
    from eeg_multimodal_torch.scripts import data

    monkeypatch.setattr(vit.ViTConfig, "for_coef",
                        staticmethod(lambda c: vit.ViTConfig(**SMALL_VIT)))
    raws = chip_smoke().write_raw_tasks(str(tmp_path), (40, 40))
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    monkeypatch.chdir(a)
    assert data.main(raws, device="cpu") == 0
    monkeypatch.chdir(b)
    cli.main(["process", *raws, "--out", "data/processed"])
    cli.main(["embed", "--data_root", ".", "--device", "cpu"])
    files = tree_files(str(a))
    assert files == tree_files(str(b))
    assert len(files) == 6 + 2 * 2 * 5  # the CSVs; 2 modals x 2 splits x 3 towers + 2 tokenizers
    for rel in files:
        assert (a / "data" / rel).read_bytes() == (b / "data" / rel).read_bytes(), rel


# ---------------------------------------------------------------------------
# r5_accuracy
# ---------------------------------------------------------------------------

FAKE_PYTHON = """#!/bin/sh
echo "PRECAST=${EEG_VALIDATE_PRECAST-unset} $*" >> "$RECORD"
echo "$*"
if [ -n "$FAIL_MATCH" ]; then
  case "$*" in *"$FAIL_MATCH"*) exit 1;; esac
fi
exit 0
"""
JAX_PROGRAMS = {"-m eeg_multimodal_tpu.cli": "cli",
                "tools/validate_bf16_moments.py": "validate_bf16_moments",
                "tools/r5_modal_seeds.py": "r5_modal_seeds"}


def normalize(line, root):
    line = line.replace(root, "<R5>")
    for prog, name in JAX_PROGRAMS.items():
        line = line.replace(prog, name)
    return line


def run_shell(tmp_path, ref, fail=None):
    """The JAX package's r5_accuracy.sh, its R5 moved under ``tmp_path``,
    with a recording ``python`` first on the PATH; returns (exit status,
    the normalized commands, R5)."""
    r5 = str(tmp_path / "sh_r5")
    text = open(os.path.join(ROOT, "tools", "r5_accuracy.sh")).read()
    assert "R5=/tmp/r5\n" in text
    script = tmp_path / "sh" / "tools" / "r5_accuracy.sh"
    script.parent.mkdir(parents=True, exist_ok=True)
    script.write_text(text.replace("R5=/tmp/r5\n", f"R5={r5}\n"))
    fake = tmp_path / "bin" / "python"
    fake.parent.mkdir(exist_ok=True)
    fake.write_text(FAKE_PYTHON)
    fake.chmod(0o755)
    record = tmp_path / "sh_record"
    record.write_text("")
    env = dict(os.environ, PATH=f"{fake.parent}:{os.environ['PATH']}", REFERENCE_DIR=ref,
               RECORD=str(record), FAIL_MATCH=fail or "")
    env.pop("EEG_VALIDATE_PRECAST", None)
    rc = subprocess.run(["bash", str(script)], env=env, capture_output=True, text=True).returncode
    return rc, [normalize(x, r5) for x in record.read_text().splitlines()], r5


def run_port(tmp_path, ref, monkeypatch, fail=None):
    """The port's r5_accuracy with its command runner stubbed as the
    recording ``python``: (exit status, the normalized commands, R5)."""
    from eeg_multimodal_torch.tools import r5_accuracy as T

    r5 = str(tmp_path / "port_r5")
    names = {T.CLI: "cli", T.VALIDATE: "validate_bf16_moments",
             T.MODAL_SEEDS: "r5_modal_seeds"}
    record = []

    def stub(module, argv, log_path=None, append=False, env=None, device=None):
        assert device == "cpu"
        line = f"{names[module]} {' '.join(argv)}"
        precast = (env or {}).get("EEG_VALIDATE_PRECAST", "unset")
        record.append(normalize(f"PRECAST={precast} {line}", r5))
        if log_path:
            with open(log_path, "a" if append else "w") as f:
                f.write(line + "\n")
        return 1 if fail and fail in line else 0

    monkeypatch.setattr(T, "R5", r5)
    monkeypatch.setattr(T, "run_command", stub)
    monkeypatch.setenv("REFERENCE_DIR", ref)
    return T.main([], device="cpu"), record, r5


def r5_files(r5):
    """Every file under ``r5``, relative, with its normalized text."""
    out = {}
    for d, _, files in os.walk(r5):
        for f in files:
            path = os.path.join(d, f)
            text = open(path, errors="replace").read()
            out[os.path.relpath(path, r5)] = normalize(text, r5)
    return out


def test_r5_accuracy_runs_the_shell_scripts_commands(tmp_path, monkeypatch, capsys):
    """Every command, in the shell script's order, with its arguments,
    environment and log file; the same markers and logs; a rerun skips
    every done phase; a failing command stops the run with exit 1 and
    ``phase base FAILED`` where the shell script stops."""
    ref = tmp_path / "ref" / "python" / "data" / "processed"
    ref.mkdir(parents=True)
    (ref / "train_label.csv").write_text("label\n1\n")
    ref = str(tmp_path / "ref")
    rc, want, sh_r5 = run_shell(tmp_path, ref)
    assert rc == 0
    got_rc, got, port_r5 = run_port(tmp_path, ref, monkeypatch)
    assert got_rc == 0
    assert got == want
    assert len(want) == 1 + 2 + 1 + 1 + 6 + 1 + 5
    assert want[0] == "PRECAST=unset cli embed --data_root <R5>/user_tree"
    assert r5_files(port_r5) == r5_files(sh_r5)
    assert sorted(f for f in r5_files(port_r5) if f.startswith(".done_")) == sorted(
        [f".done_{p}" for p in ("tree", "distill", "base", "half", "sr", "modal3")]
        + [f".done_ndp_{v}" for v in ("aug_ww_clip", "aug20", "ww", "clip", "base")])

    # a rerun: every phase is done
    rc, again, _ = run_shell(tmp_path, ref)
    assert rc == 0 and again == []
    got_rc, again, _ = run_port(tmp_path, ref, monkeypatch)
    assert got_rc == 0 and again == []

    # a failure in base: tree and distill done, base FAILED, exit 1
    shutil.rmtree(sh_r5)
    shutil.rmtree(port_r5)
    capsys.readouterr()
    rc, want, sh_r5 = run_shell(tmp_path, ref, fail=f"--out {tmp_path}/sh_r5/base ")
    got_rc, got, port_r5 = run_port(tmp_path, ref, monkeypatch, fail=f"--out {port_r5}/base ")
    assert rc == got_rc == 1
    assert got == want and len(got) == 4
    assert "phase base FAILED" in capsys.readouterr().out
    assert sorted(f for f in r5_files(port_r5) if f.startswith(".done_")) == [
        ".done_distill", ".done_tree"]
    assert r5_files(port_r5) == r5_files(sh_r5)
