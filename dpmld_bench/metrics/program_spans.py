"""The program's own spans in a traced run, as the readers take them:
``ctx["span"]["program"]``, ``spans.reduce``'s table of the profiled span,
in ms a step (every member's) or an eval epoch. A reader of a layer is
``layer_ms(ctx, <layer>)`` (the layers of ``spans.LAYERS``); a reader of the
spans of one part of the program, such as an expert layer's ``eeg.moe.*``,
is ``span_ms(ctx, <prefix>)``."""


def _program(ctx):
    span = ctx["span"]
    return None if span is None else span["program"]


def _per_step(ctx, ms):
    """``ms`` over the span's steps (or eval epochs); None where nothing ran
    on the device."""
    return ms / ctx["span"]["steps"] if ms > 0 else None


def layer_ms(ctx, layer: str):
    """Device ms a step put down to ``layer``, the backward its forwards
    caused included; None in an untraced run or where the layer did not
    run on the device."""
    program = _program(ctx)
    if program is None or layer not in program["layers"]:
        return None
    return _per_step(ctx, program["layers"][layer]["device_ms"])


def span_ms(ctx, prefix: str):
    """Device ms a step launched inside the spans whose names start with
    ``prefix``; None in an untraced run or where no such span ran on the
    device."""
    program = _program(ctx)
    if program is None:
        return None
    return _per_step(ctx, sum(v["device_ms"] for name, v in program["spans"].items()
                              if name.startswith(prefix)))
