"""The port's fused-DP NaN repro and graft entry against the JAX package's
``tools/repro_fused_dp_scan_nan.py`` and ``__graft_entry__.py``, on the
CPU.

Tolerances: the repro's composed step, given JAX's own Laplace draws,
follows JAX's DP-mean trace at rtol 1e-5 (f32; the bias corrections are
f32 in optax and double in the port, ~6e-6 relative on an update), the
``scale`` parameter, whose gradient is 0 in exact arithmetic, within Adam's
step bound; the
fused variant's CPU draw is ``laplace_plain``'s, bit for bit; the graft
entry's bf16 features before the DP block sit within the bf16 yardstick of
``test_torch_bf16.py`` (2x JAX's own bf16 distance from its f32 forward in
max abs, 1.5x in RMS); the dry run's stage-1 losses equal the meshless
port's at the mesh tests' rtol 2e-4."""
import ast
import dataclasses
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.models import fusion as JF
from eeg_multimodal_tpu.utils.trees import tree_cast as jax_cast
from eeg_multimodal_torch import graft_entry as G
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.models.bert import BertConfig
from eeg_multimodal_torch.models.convert import params_from_jax
from eeg_multimodal_torch.models.layers import draw_seeds
from eeg_multimodal_torch.ops.dp_fused import laplace_plain
from eeg_multimodal_torch.parallel.mesh import make_mesh
from eeg_multimodal_torch.tools import repro_fused_dp_scan_nan as R
from eeg_multimodal_torch.utils.seeding import generator
from eeg_multimodal_torch.utils.trees import tree_cast
from test_torch_bf16 import within_yardstick

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_RTOL = 1e-5
MESH_LOSS_RTOL = 2e-4
N_STEPS = 20


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
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_repro():
    """The JAX tool as a module (its table runs under ``__main__`` only),
    with its constants read at import at REPRO_STEPS = 20."""
    old = os.environ.get("REPRO_STEPS")
    os.environ["REPRO_STEPS"] = str(N_STEPS)
    try:
        return load_file("tools/repro_fused_dp_scan_nan.py", "jax_repro_fused_dp")
    finally:
        if old is None:
            os.environ.pop("REPRO_STEPS")
        else:
            os.environ["REPRO_STEPS"] = old


def test_repro_constants_and_variants_are_the_jax_tools(jax_repro):
    J = jax_repro
    assert (R.B, R.F, R.EPS) == (J.B, J.F, J.EPS) == (8, 2304, 0.1)
    assert J.STEPS == N_STEPS and J.LR == R.settings()[1] == 1e-2
    # the JAX tool's default list: ``sys.argv[1:] or [...]`` under __main__
    tree = ast.parse(open(os.path.join(ROOT, "tools", "repro_fused_dp_scan_nan.py")).read())
    lists = [ast.literal_eval(n.values[1]) for n in ast.walk(tree)
             if isinstance(n, ast.BoolOp) and isinstance(n.values[-1], ast.List)]
    assert lists == [list(R.VARIANTS)]


def test_composed_step_follows_the_jax_trace(jax_repro):
    """``dual-scan-jaxnoise`` for 20 steps: the JAX tool's scanned step from
    PRNGKey(0), and the port's step handed each phase's Laplace draw that
    JAX's ``lap_dropout_fast`` made (split(split(key)[i])[0])."""
    J = jax_repro
    opt, step = J.make_step(2, False, True)
    params = {"DP": jnp.zeros((1, J.F), jnp.float32), "scale": jnp.asarray(1.0, jnp.float32)}
    base = jnp.asarray(np.random.RandomState(0).randn(J.B, J.F), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), N_STEPS)
    (jparams, _, _), want = jax.jit(lambda c, k: jax.lax.scan(step, c, k))(
        (params, opt.init(params), base), keys)
    noises = []
    for k in keys:
        s1, s2 = jax.random.split(k)
        noises.append(tuple(torch.from_numpy(np.array(jax.random.laplace(
            jax.random.split(s)[0], (J.B, J.F), jnp.float32))) for s in (s1, s2)))

    topt, tstep = R.make_step(2, True, R.settings()[1], "cpu")
    tparams, tbase = R.init("cpu")
    np.testing.assert_array_equal(tbase.numpy(), np.asarray(base))
    state = topt.init(tparams)
    got = []
    for noise in noises:
        state, mean = tstep(tparams, state, tbase, None, noise=noise)
        got.append(float(mean))
    np.testing.assert_allclose(got, np.asarray(want), rtol=TRACE_RTOL, atol=0)
    np.testing.assert_allclose(tparams[0].numpy(), np.asarray(jparams["DP"]), rtol=TRACE_RTOL,
                               atol=1e-8)
    # min-max normalisation is invariant to a positive scale: its gradient
    # is 0 in exact arithmetic, and Adam moves it by rounding noise, which
    # differs between the packages; both stay within Adam's step bound
    lr = R.settings()[1]
    for scale in (float(tparams[1]), float(jparams["scale"])):
        assert abs(scale - 1.0) <= lr * N_STEPS * (1 + 1e-6)


@pytest.mark.parametrize("n_instances", [2, 1])
def test_fused_variant_draws_laplace_plain_on_the_cpu(n_instances):
    """Three steps of the fused variant drawing its seeds from a generator,
    and three handed ``laplace_plain`` of the same seeds as their noise:
    the params and the trace bit for bit."""
    lr = R.settings()[1]
    runs = []
    for given in (False, True):
        opt, step = R.make_step(n_instances, False, lr, "cpu")
        params, base = R.init("cpu")
        state = opt.init(params)
        gen, twin = generator(0, "cpu"), generator(0, "cpu")
        trace = []
        for _ in range(3):
            noise = (None, None)
            if given:  # the seeds the step draws, phase 1 first
                seeds = [draw_seeds(twin, "cpu") for _ in range(n_instances)]
                noise = tuple(laplace_plain(int(s), (R.B, R.F)) for s in seeds) + (None,)
            state, mean = step(params, state, base, gen, noise=noise)
            trace.append(mean)
        runs.append((params, torch.stack(trace)))
    (p0, t0), (p1, t1) = runs
    assert torch.equal(t0, t1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert float(p0[0].abs().max()) > 0  # DP moved


def test_repro_prints_the_jax_table(monkeypatch, capsys, jax_repro):
    monkeypatch.setenv("REPRO_STEPS", "3")
    out = R.main(["dual-scan", "dual-scan-jaxnoise"], device="cpu")
    assert out == {"dual-scan": True, "dual-scan-jaxnoise": True}
    lines = capsys.readouterr().out.splitlines()
    J = jax_repro
    assert lines[0] == f"backend={jax.default_backend()} steps=3 shape=({J.B},{J.F})"
    for line, v in zip(lines[1:], out):
        assert re.fullmatch(rf"{v}\s+PASS dp_mean_trace\[-1\]=[+-]\d\.\d{{5}}", line), line
        assert line.index("PASS") == 23


# ---------------------------------------------------------------------------
# graft entry
# ---------------------------------------------------------------------------

def test_entry_features_match_jax_before_the_dp_block():
    """``entry`` at 2 layers (bf16, batch 8, S = 512): its batch is JAX's
    ``_flagship`` batch, array for array; given JAX's bf16 params (through
    ``params_from_jax``) its concat before the DP block is within the bf16
    yardstick of JAX's; ``fn`` gives finite (8, 2) f32 logits."""
    J = load_file("__graft_entry__.py", "jax_graft_entry")
    jcfg, jparams, jbatch = J._flagship(bert_layers=2)
    fn, (params, batch, eps, gen) = G.entry(device="cpu", bert_layers=2)
    assert sorted(batch) == sorted(jbatch) and eps == 0.1
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v), err_msg=k)
    assert params["bert"]["layers"][0]["attn"]["query"]["kernel"].dtype == torch.bfloat16
    assert len(params["bert"]["layers"]) == 2 and jparams["DP"].dtype == jnp.bfloat16

    tcfg = dataclasses.replace(TF.config_for("ti", "lapacian_dropout", dtype="bfloat16"),
                               bert_config=BertConfig(num_layers=2))
    numpy_tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    pp16 = tree_cast(params_from_jax(numpy_tree, tcfg, "cpu"), torch.bfloat16)
    enc = jax.jit(lambda p: JF.encode_features(p, jbatch, jcfg, JF.split_rng(None)[0],
                                               train=False))
    feat = TF.encode_features(pp16, batch, tcfg, None, train=False)
    assert feat.dtype == torch.float32 and feat.shape == (8, 2304)
    within_yardstick("concat", feat, enc(jparams), enc(jax_cast(jparams, jnp.float32)))
    for p in (params, pp16):
        logits = fn(p, batch, eps, generator(1, "cpu"))
        assert logits.shape == (8, 2) and logits.dtype == torch.float32
        assert bool(torch.isfinite(logits).all())


def test_entry_check_prints_the_jax_line(capsys):
    out = G.main([], device="cpu")
    assert capsys.readouterr().out == "entry ok: (8, 2) float32\n"
    assert out.shape == (8, 2)


def test_dryrun_on_two_cpu_ranks_equals_the_meshless_run(capfd):
    """``dryrun_multichip(2, full_size=False)`` over gloo on the CPU: a
    (1, 2) mesh, JAX's line from rank 0, every rank's losses those of the
    same stage run meshless here."""
    results = G.dryrun_multichip(2, full_size=False, device="cpu")
    line = capfd.readouterr().out.strip().splitlines()
    assert len(line) == 1
    m = re.fullmatch(r"dryrun_multichip ok: mesh=\{'data': 1, 'model': 2\} "
                     r"train_loss=(\d+\.\d{4}) eval_loss=(\d+\.\d{4})", line[0])
    assert m, line
    tr, te, launches = G.tiny_stage(torch.device("cpu"), make_mesh())
    assert launches == {}  # the CPU takes the plain versions
    assert len(results) == 2
    for r in results:
        assert r["mesh"] == {"data": 1, "model": 2} and "loss_mesh" not in r
        np.testing.assert_allclose([r["train_loss"], r["eval_loss"]], [tr, te],
                                   rtol=MESH_LOSS_RTOL)
    assert m.groups() == (f"{results[0]['train_loss']:.4f}", f"{results[0]['eval_loss']:.4f}")
