"""encoder_device_ms.eval: device ms an eval epoch put down to the encoder layer
(``eeg.model.encoder``: the text encoder and the act encoder), over the
profiled span."""
from . import program_spans


def read(ctx):
    return program_spans.layer_ms(ctx, "encoder") if ctx["kind"] == "eval" else None
