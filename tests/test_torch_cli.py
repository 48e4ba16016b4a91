"""The port's command line against the JAX package's, on the CPU.

The same ten subcommands with the same arguments and defaults (the port
adds ``--device`` to every subcommand that computes); ``process`` and
``distill`` run for real with ``--device cpu`` and write what the JAX
package's write; ``pretrain`` reaches ``pretrain_finetune_mlm`` with the
JAX package's keyword arguments; the model subcommands hand ``--device``
to their backend.
"""
import argparse
import os
import pickle

import numpy as np
import pytest
import torch

from eeg_multimodal_tpu import cli as JCLI
from eeg_multimodal_torch import cli as TCLI

COMPUTES = {"demo", "train", "legacy", "compare", "sweep", "embed", "distill", "pretrain",
            "predict"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Parsed(Exception):
    pass


def jax_parser(monkeypatch):
    """The parser the JAX package's ``main`` builds (it builds it inside)."""
    got = {}

    def grab(self, args=None, namespace=None):
        got["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            JCLI.main(["process", "x"])
    return got["parser"]


def subcommands(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def arguments(sub, skip=("help", "device")):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs, a.required,
                     a.const, type(a).__name__)
            for a in sub._actions if a.dest not in skip}


def test_every_subcommand_has_the_jax_arguments_and_defaults(monkeypatch):
    jsubs, tsubs = subcommands(jax_parser(monkeypatch)), subcommands(TCLI.build_parser())
    assert list(tsubs) == list(jsubs) and len(tsubs) == 10
    for name in jsubs:
        assert arguments(tsubs[name]) == arguments(jsubs[name]), name
        device = [a for a in tsubs[name]._actions if a.dest == "device"]
        assert (len(device) == 1 and device[0].default is None) == (name in COMPUTES), name
    ns = TCLI.build_parser().parse_args(["pretrain", "--device", "cpu"])
    assert (ns.epochs, ns.mlm_steps, ns.mlm_batch, ns.device) == (120, 8000, 128, "cpu")


def write_raw(path, n, seed):
    rng = np.random.RandomState(seed)
    data = np.concatenate([np.arange(n)[:, None], rng.randint(-2048, 2048, (n, 25)),
                           rng.randint(-300, 300, (n, 30)), rng.randint(0, 2, (n, 1))], axis=1)
    np.savetxt(path, data, fmt="%.1f")


def tree_bytes(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def test_process_and_distill_run_for_real(tmp_path):
    raws = [str(tmp_path / f"task_{i}.txt") for i in (1, 2)]
    for i, path in enumerate(raws):
        write_raw(path, 30 + i, i)
    root_t, root_j = tmp_path / "port", tmp_path / "jax"
    assert TCLI.main(["process", *raws, "--out", str(root_t / "data" / "processed")]) == 0
    assert JCLI.main(["process", *raws, "--out", str(root_j / "data" / "processed")]) == 0
    assert tree_bytes(root_t) == tree_bytes(root_j) and len(tree_bytes(root_t)) == 6

    n_test = len(open(root_t / "data" / "processed" / "test_act.csv").readlines()) - 1
    real = tmp_path / "real.pickle"
    real.write_bytes(pickle.dumps(np.random.RandomState(5).randn(n_test, 16).astype(np.float32)))
    for cli, root, extra in ((TCLI, root_t, ["--device", "cpu"]), (JCLI, root_j, [])):
        assert cli.main(["distill", "--data_root", str(root), "--out", str(root / "out"),
                         "--real_test_pickle", str(real), "--steps", "110", *extra]) == 0
    got, want = tree_bytes(root_t / "out"), tree_bytes(root_j / "out")
    assert sorted(got) == sorted(want)
    train = "data/embedding/act/img/clip_ViT_B_32/train.pickle"
    assert all(got[k] == want[k] for k in got if k != train)  # the copies, the real array
    arr = pickle.loads(got[train])
    n_train = len(open(root_t / "data" / "processed" / "train_act.csv").readlines()) - 1
    assert arr.shape == (n_train, 16) and arr.dtype == np.float32 and np.isfinite(arr).all()


def test_pretrain_reaches_the_pipeline_with_the_jax_arguments(monkeypatch):
    from eeg_multimodal_tpu.train import mlm as JM
    from eeg_multimodal_torch.train import mlm as TM

    calls = {}
    for name, mod in (("jax", JM), ("port", TM)):
        def record(*args, _name=name, **kw):
            calls[_name] = (args, kw)
            return {"best": {"epoch": 1, "test_acc": 0.5}, "f1_best": 0.6}

        monkeypatch.setattr(mod, "pretrain_finetune_mlm", record)
    argv = ["pretrain", "--data_root", "d", "--out", "o", "--mlm_steps", "40", "--whole_word",
            "--row_reg_weight", "1.0", "--aug_factor", "1", "--clip_weight", "0.5", "-n", "1",
            "--dtype", "float32"]
    assert JCLI.main(argv) == 0 and TCLI.main(argv + ["--device", "cpu"]) == 0
    (ja, jkw), (ta, tkw) = calls["jax"], calls["port"]
    assert ta == ja == ("d", "o") and tkw.pop("device") == "cpu" and tkw == jkw
    assert tkw["mlm_steps"] == 40 and tkw["whole_word"] and tkw["epochs"] == 1


@pytest.mark.parametrize("argv,backend", [
    (["train"], "TrainAndTest"), (["demo"], "TrainAndTest"),
    (["predict", "ckpt"], "TrainAndTest"), (["compare", "modal"], "TrainAndTest"),
    (["embed"], "GetEmbedding")])
def test_model_subcommands_hand_the_device_to_their_backend(monkeypatch, argv, backend):
    from eeg_multimodal_torch.data import embedding
    from eeg_multimodal_torch.train import api

    seen = []

    class Stop(Exception):
        pass

    def fake(*args, device=None, **kw):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(api if backend == "TrainAndTest" else embedding, backend, fake)
    with pytest.raises(Stop):
        TCLI.main(argv + ["--device", "cpu"])
    assert seen == ["cpu"]
