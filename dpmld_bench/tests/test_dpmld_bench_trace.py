"""The traced span as the readers get it: ``trace.summarize`` gives the
keys and values it gave before, and ``trace.program`` ``spans.reduce``'s
table over the span, which ``trace.profile`` adds as ``program``; the six layer readers read that table in ms a step and
are silent without it; the encoder part's counters reach ``ctx`` as their
change over the profiled span."""
import dataclasses
import json
import os
from typing import Optional

import pytest
import torch

from dpmld_bench import run, spans, trace
from dpmld_bench.metrics import program_spans
from dpmld_bench.reference import encoders
from dpmld_bench.tests.conftest import _tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
TOY = encoders.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy", "program"),
                    "toy.program", "toy_moe")


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Event:
    """The fields of a ``torch.profiler`` event that the reductions read."""
    name: str
    start: float
    end: float
    thread: int = 1
    id: int = 0
    sequence_nr: int = -1
    device_type: object = CPU
    cpu_parent: Optional["Event"] = None

    @property
    def time_range(self):
        return Range(self.start, self.end)


def span_events():
    """A span of 1000 us: an encoder forward and the optimizer, each
    launching one kernel from inside its ``eeg.*`` range, and a copy
    launched outside every range."""
    mm = Event("aten::mm", 30, 40, id=11)
    adam = Event("aten::_foreach_add_", 600, 620, id=12)
    copy = Event("aten::copy_", 900, 910, id=13)
    launches = [Event("cudaLaunchKernel", at, at + 1, id=id_)
                for at, id_ in ((32, 101), (602, 102), (902, 103))]
    host = [Event("bench.span", 0, 1000, id=1), Event("bench.train_step", 5, 990, id=2),
            Event("eeg.model.encoder", 20, 100, id=3), Event("eeg.optim.model", 590, 700, id=4),
            mm, adam, copy] + launches
    device = [Event("gemm_kernel", 50, 90, thread=0, id=101, device_type=CUDA),
              Event("multi_tensor_apply", 650, 670, thread=0, id=102, device_type=CUDA),
              Event("copy_kernel", 950, 960, thread=0, id=103, device_type=CUDA)]
    return host + device


# what ``summarize`` gave before the program's table: the parent's keys
BEFORE = {"kernels": [("gemm_kernel", 50, 90), ("multi_tensor_apply", 650, 670),
                      ("copy_kernel", 950, 960)],
          "launches": 3, "busy_s": 70e-6, "wall_s": 1000e-6}
IDLE = [(0, 50), (90, 650), (670, 950), (960, 1000)]


def test_summarize_keeps_its_keys_and_program_reduces_the_span():
    events = span_events()
    bare = trace.summarize(events)
    assert set(bare) == {"kernels", "launches", "busy_s", "wall_s", "device_ops", "idle_gaps"}
    assert {k: bare[k] for k in BEFORE} == pytest.approx(BEFORE)
    assert [name for name, _ in bare["device_ops"]] == ["gemm_kernel", "multi_tensor_apply",
                                                        "copy_kernel"]
    assert sum(s for _, s in bare["idle_gaps"]) == pytest.approx(930e-6)
    table = trace.program(events, bare["kernels"])
    assert table == spans.reduce(events, 0, 1000, trace.LAUNCHES, IDLE)
    assert table["layers"]["encoder"]["device_ms"] == pytest.approx(0.040)
    assert table["layers"]["optimizer"]["device_ms"] == pytest.approx(0.020)
    assert table["coverage"] == pytest.approx(60 / 70)


# (metric, the run's kind, the layer it reads)
READERS = [("encoder_device_ms.train", "train", "encoder"),
           ("decoder_device_ms.train", "train", "decoder"),
           ("dp_block_device_ms.train", "train", "DP block"),
           ("optimizer_device_ms.train", "train", "optimizer"),
           ("encoder_device_ms.eval", "eval", "encoder"),
           ("decoder_device_ms.eval", "eval", "decoder")]


def ctx_of(kind, layers, steps=4):
    table = {name: dict.fromkeys(spans.FIELDS, 0.0) | {"device_ms": ms}
             for name, ms in layers.items()}
    return {"kind": kind, "span": {"steps": steps, "program": {
        "layers": table, "spans": {}, "device_ms": sum(layers.values()), "coverage": 1.0}}}


@pytest.mark.parametrize("metric,kind,layer", READERS)
def test_each_reader_is_silent_without_its_span(metric, kind, layer):
    read = run.reader(metric).read
    assert read({"kind": kind, "span": None}) is None
    others = {name: 5.0 for _, _, name in READERS if name != layer}
    assert read(ctx_of(kind, others)) is None
    assert read(ctx_of(kind, {**others, layer: 0.0})) is None
    assert read(ctx_of("eval" if kind == "train" else "train", {layer: 8.0})) is None
    assert read(ctx_of(kind, {**others, layer: 8.0}, steps=4)) == pytest.approx(2.0)


def test_every_ms_reader_is_in_the_benchmark():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric, kind, layer in READERS:
        m = entries[metric]
        assert (m["unit"], m["better"], m["source"], m["layer"]) == (
            "ms", "lower", "device_trace", layer)
        cells = {w["name"] for w in bench["workloads"] if
                 run.load_json(run.HERE, "traffic", w["traffic"] + ".json")["driver"] == kind}
        assert m["workloads"] and set(m["workloads"]) <= cells


def test_span_ms_sums_the_spans_of_a_prefix():
    ctx = ctx_of("train", {"encoder": 6.0})
    ctx["span"]["program"]["spans"] = {
        name: dict.fromkeys(spans.FIELDS, 0.0) | {"device_ms": ms}
        for name, ms in (("eeg.moe.route", 1.0), ("eeg.moe.experts", 3.0),
                         ("eeg.model.encoder", 6.0))}
    assert program_spans.span_ms(ctx, "eeg.moe.") == pytest.approx(1.0)
    assert program_spans.span_ms(ctx, "eeg.dense.") is None
    assert program_spans.span_ms({"kind": "train", "span": None}, "eeg.moe.") is None


@pytest.fixture
def traced_on_the_cpu(monkeypatch):
    """A traced run on the CPU: the profiler's host events as the card's
    run has them, ``synchronize`` a no-op, and one stand-in kernel so that
    the span counts as seen; each reader hands back the ``ctx`` it got."""
    seen = []
    summarize = trace.summarize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(trace, "summarize", lambda events: {
        **summarize(events), "kernels": [("stand_in", 0.0, 1.0)]})

    class Reader:
        @staticmethod
        def read(ctx):
            seen.append(ctx)
            return None

    monkeypatch.setattr(run, "reader", lambda name: Reader)
    return seen


def test_counters_reach_ctx_as_their_change_over_the_span(traced_on_the_cpu, monkeypatch):
    """BERT's run with the toy program part's counter, which every train
    step advances by 3 rows."""
    from eeg_multimodal_torch.train.trainer import StepFunctions

    train_step = StepFunctions.train_step

    def counted_step(self, *a, **k):
        TOY.ROUTED["routed_rows"] += 3
        return train_step(self, *a, **k)

    monkeypatch.setitem(TOY.ROUTED, "routed_rows", 1000)
    monkeypatch.setattr(StepFunctions, "train_step", counted_step)
    monkeypatch.setattr(run.encoder_parts("bert")[0], "counters", TOY.counters, raising=False)
    result, lines = run.run_cell("tica_f32.sweep5_s80", 2**31 + 7, 0.2, True,
                                 torch.device("cpu"), edit=_tiny)
    ctx = traced_on_the_cpu[0]
    assert ctx["counters"] == {"routed_rows": 6}  # the tiny traffic's two span steps
    assert set(ctx["span"]) >= {"program", "kernels", "steps"}
    assert "counters" not in ctx["span"]
    assert result["correct"] is True, lines
    json.dumps(result)


@pytest.mark.parametrize("traced", [True, False])
def test_a_part_without_counters_gives_none(traced_on_the_cpu, traced):
    assert not hasattr(run.encoder_parts("bert")[0], "counters")
    run.run_cell("tica_bf16.eval_s80", 2**31 + 7, 0.2, traced, torch.device("cpu"), edit=_tiny)
    assert traced_on_the_cpu[0]["counters"] == {}
