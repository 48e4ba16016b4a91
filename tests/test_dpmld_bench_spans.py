"""The benchmark's reduction of the program's spans (``dpmld_bench/spans.py``)
on synthetic profiler events: a backward put down to the layer of its
forward by sequence number across threads, an idle gap to the autograd
thread's span, the coverage, and ``trace.summarize`` reading the same with
and without the program's ranges.
"""
import dataclasses
from typing import Optional

import pytest
import torch

from dpmld_bench import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Event:
    """The fields of a ``torch.profiler`` event that the reduction reads."""
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


def with_parents(events):
    """Each host event's ``cpu_parent``: the innermost host event around it on
    its thread, as the profiler links them."""
    for e in events:
        around = [p for p in events
                  if p is not e and p.device_type == CPU and e.device_type == CPU
                  and p.thread == e.thread and p.start <= e.start and e.end <= p.end
                  and (p.start, -p.end) < (e.start, -e.end)]
        e.cpu_parent = max(around, key=lambda p: (p.start, -p.end), default=None)
    return events


def launch(op, at):
    """A runtime call of ``op``'s at ``at`` (its correlation id, ``id``, is
    that of the device operation it launches)."""
    return Event("cudaLaunchKernel", at, at + 1, thread=op.thread, id=2000 + at)


def kernel(name, start, end, call):
    return Event(name, start, end, thread=0, id=call.id, device_type=CUDA)


def step_events(program=True):
    """A step of the bench's span: an encoder and a head forward on thread 1,
    their backward on autograd's thread 2 (one through a kernel wrapper's
    span), Adam, and an operator outside every span. ``program=False``
    leaves out the program's ranges. They have no copies on the device:
    ``span`` opens no user annotation (``tests/test_torch_spans.py``)."""
    mm = Event("aten::mm", 30, 40, id=11, sequence_nr=7)
    addmm = Event("aten::addmm", 115, 125, id=12, sequence_nr=8)
    mm_b = Event("aten::mm", 220, 230, thread=2, id=21)
    wrapper = Event("eeg.kernel.attn_bwd", 320, 380, thread=2, id=22)
    foreach = Event("aten::_foreach_add_", 660, 670, id=31)
    copy = Event("aten::copy_", 905, 910, id=41)
    calls = [launch(mm, 32), launch(addmm, 117), launch(mm_b, 222), launch(wrapper, 325),
             launch(foreach, 662), launch(copy, 906)]
    host = [Event("bench.span", 0, 1000, id=1), Event("bench.train_step", 5, 990, id=2),
            mm, addmm, mm_b, foreach, copy,
            Event("autograd::engine::evaluate_function: AddmmBackward0", 210, 300, thread=2,
                  id=23, sequence_nr=8),
            Event("autograd::engine::evaluate_function: MmBackward0", 310, 400, thread=2,
                  id=24, sequence_nr=7)] + calls
    device = [kernel(name, start, end, call) for (name, start, end), call in zip(
        (("gemm_fwd", 50, 60), ("gemm_head", 130, 135), ("gemm_bwd_head", 240, 260),
         ("attn_bwd_kernel", 330, 370), ("multi_tensor_apply", 700, 720),
         ("copy_kernel", 950, 960)), calls)]
    ranges = [Event("eeg.step", 8, 900, id=3), Event("eeg.step.phase2", 10, 890, id=4),
              Event("eeg.model.encoder", 20, 100, id=5), Event("eeg.model.head", 110, 150, id=6),
              Event("eeg.backward", 200, 600, id=7), Event("eeg.optim.model", 650, 800, id=8),
              wrapper]
    if not program:
        return with_parents(host) + device
    return with_parents(host + ranges) + device


def reduce(events, gaps=()):
    return spans.reduce(events, 0, 1000, trace.LAUNCHES, list(gaps))


def test_a_backward_goes_to_the_layer_of_its_forward_across_threads():
    p = reduce(step_events())
    layers, by_span = p["layers"], p["spans"]
    # encoder: its forward's 10 us and the wrapper's 40 us on autograd's thread
    assert layers["encoder"]["device_ms"] == pytest.approx(0.050)
    assert layers["head"]["device_ms"] == pytest.approx(0.025)
    assert layers["optimizer"]["device_ms"] == pytest.approx(0.020)
    assert by_span["eeg.model.encoder"]["device_ms"] == pytest.approx(0.010)
    assert by_span["eeg.kernel.attn_bwd"]["device_ms"] == pytest.approx(0.040)
    # thread 2 opened no span around the head's backward: the main thread's
    assert by_span["eeg.backward"]["device_ms"] == pytest.approx(0.020)
    assert by_span["eeg.model.head"]["launches"] == 1 and layers["head"]["launches"] == 2
    assert by_span["eeg.kernel.attn_bwd"]["launches"] == 1 and layers["encoder"]["launches"] == 2
    # host self time: a span less the spans it holds on its own thread
    assert by_span["eeg.step.phase2"]["host_self_ms"] == pytest.approx(
        (880 - 80 - 40 - 400 - 150) * 1e-3)
    assert by_span["eeg.backward"]["host_self_ms"] == pytest.approx(0.400)
    # the wrapper's 60 us go to the encoder, the layer of its autograd node
    assert layers["step"]["host_self_ms"] == pytest.approx((892 - 880 + 210 + 400) * 1e-3)
    assert layers["encoder"]["host_self_ms"] == pytest.approx((80 + 60) * 1e-3)


def test_the_coverage_counts_what_no_span_launched():
    p = reduce(step_events())
    assert p["device_ms"] == pytest.approx(0.105)
    assert p["coverage"] == pytest.approx(0.095 / 0.105)
    assert sum(v["device_ms"] for v in p["layers"].values()) == pytest.approx(0.095)
    bare = reduce(step_events(program=False))
    assert bare["spans"] == {} and bare["layers"] == {} and bare["coverage"] == 0.0
    assert reduce([])["coverage"] is None


def test_an_idle_gap_takes_the_autograd_threads_span():
    gaps = [(340, 360), (605, 615), (920, 940)]
    p = reduce(step_events(), gaps)
    # inside the wrapper on autograd's thread, not the main thread's backward
    assert p["gaps"] == ["eeg.kernel.attn_bwd", "eeg.step.phase2", None]
    assert p["spans"]["eeg.kernel.attn_bwd"]["idle_ms"] == pytest.approx(0.020)
    assert p["layers"]["encoder"]["idle_ms"] == pytest.approx(0.020)
    assert p["layers"]["step"]["idle_ms"] == pytest.approx(0.010)


def test_summarize_reads_the_same_without_the_program_ranges():
    ours, bare = trace.summarize(step_events()), trace.summarize(step_events(program=False))
    assert ours == bare
    assert ours["launches"] == 6 and len(ours["kernels"]) == 6
    assert [label for label, _ in ours["idle_gaps"]] == ["bench.train_step/python"]
