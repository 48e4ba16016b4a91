"""decoder_device_ms.eval: device ms an eval epoch put down to the decoder layer
(``eeg.model.decoder``: the cross-attention block and the concat), over the
profiled span."""
from . import program_spans


def read(ctx):
    return program_spans.layer_ms(ctx, "decoder") if ctx["kind"] == "eval" else None
