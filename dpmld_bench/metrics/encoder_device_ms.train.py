"""encoder_device_ms.train: device ms a train step (every member's) put down to the
encoder layer (``eeg.model.encoder``: the text encoder and the act encoder),
the backward its forwards caused included, over the profiled span."""
from . import program_spans


def read(ctx):
    return program_spans.layer_ms(ctx, "encoder") if ctx["kind"] == "train" else None
