"""The text encoder is a part that the configuration's ``model_type`` names:
a second architecture is added with new files alone, and a ``model_type``
without its two parts stops the run in ``cell_spec``, before any CUDA
work, naming the files it looked for."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from dpmld_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "dpmld_bench")

# a whole run of the copy's new cell on the CPU at the tiny sizes
RUN = """
import json, torch
from dpmld_bench import run
from dpmld_bench.tests.conftest import _tiny
result, lines = run.run_cell("tica_bert2.train_s80", 2**31 + 23, 0.2, False,
                             torch.device("cpu"), edit=_tiny)
parts = [m.__file__ for m in run.encoder_parts("bert2")]  # the parts the run took
print(json.dumps({"result": result, "parts": parts}))
"""


def tree_digests(top):
    return {os.path.relpath(os.path.join(d, f), top):
            hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for d, _, files in os.walk(top) for f in files}


def test_a_second_architecture_is_new_files_only(tmp_path):
    copy = tmp_path / "dpmld_bench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = tree_digests(copy)
    # the new architecture's files: its two parts (here BERT's, under
    # another name), a configuration, its cell's limits
    shutil.copy(copy / "encoders" / "bert.py", copy / "encoders" / "bert2.py")
    shutil.copy(copy / "reference" / "encoders" / "bert.py",
                copy / "reference" / "encoders" / "bert2.py")
    cfg = json.loads((copy / "configs" / "tica_f32.json").read_text())
    cfg["model_type"] = "bert2"
    (copy / "configs" / "tica_bert2.json").write_text(json.dumps(cfg))
    shutil.copy(copy / "limits" / "tica_f32.train_s512.json",
                copy / "limits" / "tica_bert2.train_s80.json")
    # and its entries in BENCHMARK.json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tica_bert2", "source": "a copy of tica_f32",
                             "file": "dpmld_bench/configs/tica_bert2.json", "reduced": [],
                             "why": "a second model_type"})
    bench["workloads"].append({"name": "tica_bert2.train_s80", "config": "tica_bert2",
                               "traffic": "train_s80", "chips": 1, "why": "the new part"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tica_f32.sweep5_s80" in m.get("workloads", []):
            m["workloads"].append("tica_bert2.train_s80")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = tree_digests(copy)
    assert {k: after[k] for k in before} == before  # no file of the copy changed
    assert set(after) - set(before) == {
        "encoders/bert2.py", "reference/encoders/bert2.py", "configs/tica_bert2.json",
        "limits/tica_bert2.train_s80.json"}

    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), ROOT]),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["result"]["correct"] is True, got["result"]["checks"]
    assert got["parts"] == [str(copy / "encoders" / "bert2.py"),
                            str(copy / "reference" / "encoders" / "bert2.py")]


def test_a_model_type_without_its_parts_stops_in_cell_spec(monkeypatch):
    load_json = run.load_json

    def other_type(*parts):
        out = load_json(*parts)
        return {**out, "model_type": "no_such_encoder"} if "model_type" in out else out

    monkeypatch.setattr(run, "load_json", other_type)
    with pytest.raises(SystemExit) as stop:
        run.cell_spec("tica_f32.sweep5_s80")
    message = str(stop.value)
    assert "dpmld_bench/encoders/no_such_encoder.py" in message
    assert "dpmld_bench/reference/encoders/no_such_encoder.py" in message
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("model_type", ["../bert", "bert.py", ""])
def test_a_model_type_is_a_name_not_a_path(model_type):
    with pytest.raises(SystemExit, match="no text encoder part"):
        run.encoder_parts(model_type)


def test_each_part_is_loaded_once():
    program, reference = run.encoder_parts("bert")
    assert run.encoder_parts("bert") == (program, reference)
    assert reference.KEY == "bert" and hasattr(program, "fusion_settings")
