"""The port's spans (``utils/profiling.span``) on the CPU: under
``torch.profiler`` each step mode, the member step and the eval epoch open
the ``eeg.*`` ranges in their nesting, every autograd node of a step has its
forward operator inside a span (so a backward can be put down to the layer
whose forward caused it), and the numbers are those of a run without the
profiler, bit for bit. With no profiler running, ``span`` is one shared
no-op. The model: the flagship class with a 1-layer BERT of width 768, S = 8.
"""
import contextlib
import dataclasses

import pytest
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

from eeg_multimodal_torch.data.datasets import gather_batch
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import fusion as TF
from eeg_multimodal_torch.ops.dp_fused import KernelWrapper
from eeg_multimodal_torch.train.sweep import MemberSteps, SweepRunner, privacy_utility_frontier
from eeg_multimodal_torch.train.trainer import TrainConfig, Trainer
from eeg_multimodal_torch.utils.profiling import span
from eeg_multimodal_torch.utils.trees import tree_items
from test_torch_trainer import TINY, arrays

CFG = dataclasses.replace(TF.config_for("ti", "lapacian_dropout"),
                          bert_config=TB.BertConfig(**TINY))
B, N, EPS = 4, 8, 0.5
NODE = "autograd::engine::evaluate_function: "
MODEL = ("eeg.model.encoder", "eeg.model.decoder", "eeg.model.dp_block", "eeg.model.head")
HEAD = ("eeg.model.dp_block", "eeg.model.head")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def profiled(fn, on):
    """``fn()`` under ``torch.profiler`` (``on``) or not: (its result, the
    events or None)."""
    if not on:
        return fn(), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _eeg_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("eeg."):
        p = p.cpu_parent
    return p


def nesting(events):
    """{(the innermost enclosing span's name or None, the span's name)}."""
    return {((_eeg_parent(e) or e).name if _eeg_parent(e) else None, e.name)
            for e in events if e.name.startswith("eeg.")}


def edges(parent, children):
    return {(parent, c) for c in children}


def step_nesting(phase1, phase2, encode=()):
    return ({(None, "eeg.step"), ("eeg.step", "eeg.step.phase1"), ("eeg.step", "eeg.step.phase2")}
            | edges("eeg.step.phase1", phase1 + ("eeg.backward", "eeg.optim.dp"))
            | edges("eeg.step.phase2", phase2 + ("eeg.backward", "eeg.optim.model"))
            | ({("eeg.step", "eeg.step.encode")} | edges("eeg.step.encode", encode)
               if encode else set()))


def assert_nodes_have_forwards(events):
    """Every autograd node with a sequence number has a forward operator of
    that number inside some span (``AccumulateGrad`` carries -1)."""
    def in_node(e):
        while e is not None:
            if e.name.startswith(NODE):
                return True
            e = e.cpu_parent
        return False

    nodes = {e.sequence_nr for e in events if e.name.startswith(NODE) and e.sequence_nr >= 0}
    forward = {e.sequence_nr for e in events
               if e.sequence_nr >= 0 and not in_node(e) and _eeg_parent(e) is not None}
    assert nodes and nodes <= forward, sorted(nodes - forward)


def assert_equal_trees(a, b):
    a, b = dict(tree_items(a)), dict(tree_items(b))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_span_is_one_no_op_without_the_profiler():
    assert not torch.autograd._profiler_enabled()
    off = span("eeg.step")
    assert off is span("eeg.model.head") and isinstance(off, contextlib.nullcontext)
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("eeg.step"), _RecordFunctionFast)


def test_spans_are_no_user_annotations():
    """A span is an operator-scope range, not a user annotation as a
    ``record_function`` range is. The profiler copies only user annotations
    onto the device's timeline, so a trace's device operations are the
    same with the spans as without them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.span"):
            with span("eeg.step"):
                torch.ones(3).sum()
    kinds = {e.name: e.is_user_annotation for e in prof.events()
             if e.name in ("bench.span", "eeg.step")}
    assert kinds == {"bench.span": True, "eeg.step": False}


def test_kernel_wrapper_is_its_span_inside_its_caller():
    probe = KernelWrapper("probe", lambda x: x + 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("eeg.model.encoder"):
            out = probe(torch.zeros(3))
    assert torch.equal(out, torch.ones(3)) and probe.launches == 1
    assert nesting(prof.events()) == {(None, "eeg.model.encoder"),
                                      ("eeg.model.encoder", "eeg.kernel.probe")}


def faithful_run(on):
    """The epoch loop's inputs, the precast copy, a gather and one faithful
    bf16 step on the precast copy (the users' default)."""
    cfg = TrainConfig(batch_size=B, learning_rate=1e-3, compute_dtype="bfloat16",
                      precast_params=True, adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16")
    tr = Trainer(CFG, cfg, device="cpu")
    data = arrays(N, seed=1).to_device("cpu")

    def run():
        idx, w, gen, _, _, _ = tr.epoch_inputs(0, N, N)
        params_c = tr.steps.precast_copy(tr.params)
        tr.dp_os, tr.model_os, loss, acc = tr.steps.train_step(
            tr.params, tr.dp_os, tr.model_os, gather_batch(data, idx[0]), w[0], EPS, gen,
            params_c=params_c)
        return loss, acc, params_c

    (loss, acc, params_c), events = profiled(run, on)
    return (loss, acc), {"params": tr.params, "params_c": params_c, "mu": tr.model_os.mu,
                         "nu": tr.model_os.nu, "dp_mu": tr.dp_os.mu}, events


def member_run(on):
    """One ``MemberSteps`` step of 2 members (f32), its inputs drawn by
    ``SweepRunner.epoch_inputs``."""
    members = privacy_utility_frontier((0.1, 5.0), (3,))
    runner = SweepRunner(CFG, TrainConfig(batch_size=B, learning_rate=1e-3), members,
                         device="cpu")
    steps, params, dp_os, model_os = runner.init_members(members)
    assert isinstance(steps, MemberSteps)
    data = arrays(N, seed=2).to_device("cpu")
    eps = torch.tensor([m.epsilon for m in members], dtype=torch.float64)

    def run():
        idx, w, gens, _, _, _ = runner.epoch_inputs(members, 0, N, N)
        _, _, loss, acc = steps.train_step(params, dp_os, model_os, gather_batch(data, idx[0]),
                                           w[0], eps, gens)
        return loss, acc

    out, events = profiled(run, on)
    return out, {"params": params, "mu": model_os.mu, "dp_mu": dp_os.mu}, events


def fast_run(mode, on):
    """One step of a fast mode (f32): the encoder once, or both phases'
    encoders as one forward over the batch stacked twice."""
    cfg = TrainConfig(batch_size=B, learning_rate=1e-3, **{
        "reuse": dict(share_phase_dropout=True),
        "paired": dict(paired_phase_encode=True)}[mode])
    tr = Trainer(CFG, cfg, device="cpu")
    assert (tr.steps.reuse, tr.steps.paired) == (mode == "reuse", mode == "paired")
    data = arrays(N, seed=3).to_device("cpu")
    idx, w, gen, _, _, _ = tr.epoch_inputs(0, N, N)
    batch = gather_batch(data, idx[0])

    def run():
        tr.dp_os, tr.model_os, loss, acc = tr.steps.train_step(
            tr.params, tr.dp_os, tr.model_os, batch, w[0], EPS, gen)
        return loss, acc

    out, events = profiled(run, on)
    return out, {"params": tr.params, "mu": tr.model_os.mu, "dp_mu": tr.dp_os.mu}, events


def eval_run(on):
    """One batched eval epoch at n_eval 2, bf16."""
    cfg = TrainConfig(batch_size=B, compute_dtype="bfloat16", n_eval=2)
    tr = Trainer(CFG, cfg, device="cpu")
    data = arrays(N, seed=4).to_device("cpu")
    _, _, _, eidx, ew, egen = tr.epoch_inputs(0, N, N)
    out, events = profiled(lambda: tr.steps.eval_epoch(tr.params, data, eidx, ew, EPS, egen), on)
    return out, {}, events


CASES = {
    "faithful bf16 precast": (
        faithful_run,
        {(None, "eeg.epoch.inputs"), (None, "eeg.epoch.precast"), (None, "eeg.data.gather")}
        | step_nesting(MODEL, MODEL)),
    "2 members": (
        member_run,
        {(None, "eeg.epoch.inputs"), (None, "eeg.data.gather")} | step_nesting(MODEL, MODEL)),
    "reuse": (lambda on: fast_run("reuse", on),
              step_nesting(HEAD, HEAD, ("eeg.model.encoder", "eeg.model.decoder"))),
    "paired": (lambda on: fast_run("paired", on),
               step_nesting(HEAD, HEAD, ("eeg.model.encoder", "eeg.model.decoder"))),
    "eval epoch": (
        eval_run,
        {(None, "eeg.eval"), ("eeg.eval", "eeg.data.gather"), ("eeg.eval", "eeg.eval.forward"),
         ("eeg.eval", "eeg.eval.metrics")} | edges("eeg.eval.forward", MODEL)),
}


@pytest.mark.parametrize("case", CASES)
def test_spans_nest_and_change_no_number(case):
    run, want = CASES[case]
    out_on, state_on, events = run(True)
    assert nesting(events) == want
    if case != "eval epoch":
        assert_nodes_have_forwards(events)
    out_off, state_off, none = run(False)
    assert none is None
    assert_equal_trees(out_on, out_off)
    assert_equal_trees(state_on, state_off)
