"""decoder_device_ms.train: device ms a train step (every member's) put down to the
decoder layer (``eeg.model.decoder``: the cross-attention block and the
concat), the backward its forwards caused included, over the profiled span."""
from . import program_spans


def read(ctx):
    return program_spans.layer_ms(ctx, "decoder") if ctx["kind"] == "train" else None
