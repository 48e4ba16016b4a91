"""dp_block_device_ms.train: device ms a train step (every member's) put down to
the DP block (``eeg.model.dp_block``: min-max to the mechanism's output),
the backward its forwards caused included, over the profiled span."""
from . import program_spans


def read(ctx):
    return program_spans.layer_ms(ctx, "DP block") if ctx["kind"] == "train" else None
