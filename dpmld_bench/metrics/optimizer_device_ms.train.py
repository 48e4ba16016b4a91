"""optimizer_device_ms.train: device ms a train step (every member's) put down to
the optimizer (``eeg.optim.*``: Adam on DP and on the model, the gradients'
upcast and the precast copy's refresh), over the profiled span."""
from . import program_spans


def read(ctx):
    return program_spans.layer_ms(ctx, "optimizer") if ctx["kind"] == "train" else None
