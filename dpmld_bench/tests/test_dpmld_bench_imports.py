"""No process the benchmark starts loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "dpmld_bench")
JAX = {"jax", "jaxlib", "flax", "eeg_multimodal_tpu"}


def loaded_after(code):
    """The top-level names of the modules a fresh interpreter holds after
    ``code``."""
    probe = code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(out.stdout.split())


def imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_harness_loads_no_jax():
    names = loaded_after("import dpmld_bench.run, dpmld_bench.program, dpmld_bench.calibrate, "
                         "dpmld_bench.trace, dpmld_bench.drivers.train, "
                         "dpmld_bench.drivers.eval\n"
                         "from dpmld_bench import run\n"
                         "[run.reader(m) for m in ('mfu.train', 'attn_roofline.eval')]\n"
                         "run.encoder_parts('bert')")
    assert "eeg_multimodal_torch" in names  # the program is what is measured
    assert not names & JAX


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("import dpmld_bench.reference.follow, dpmld_bench.reference.check\n"
                         "from dpmld_bench.reference import encoders\n"
                         "encoders.part('bert')")
    assert not names & (JAX | {"eeg_multimodal_torch"})


@pytest.mark.parametrize("folder", ["", "reference", "reference/encoders", "encoders", "drivers",
                                    "metrics", "tests"])
def test_no_source_imports_jax(folder):
    for name in sorted(os.listdir(os.path.join(BENCH, folder))):
        if name.endswith(".py"):
            imported = imported_names(os.path.join(BENCH, folder, name))
            assert not imported & JAX, (folder, name)
            if folder.startswith("reference"):
                assert "eeg_multimodal_torch" not in imported, name


def test_a_run_refuses_a_loaded_jax_module(monkeypatch):
    from dpmld_bench import run

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    assert "eeg_multimodal_torch" not in run.forbidden_modules()
