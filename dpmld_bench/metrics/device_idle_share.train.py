"""device_idle_share.train: the share of the profiled span's wall time in
which no kernel, copy or set runs on the device, in percent: 1 - (the union
of the device operations' intervals in the span) / (the span's own wall
time), both from the one trace. The profiler slows the host, so in a cell
bound by the host this reads the idle share of a slower host; the run
prints on standard error how much slower a step of the span is than one of
the window."""


def read(ctx):
    span = ctx["span"]
    if ctx["kind"] != "train" or span is None:
        return None
    return (1.0 - span["busy_s"] / span["wall_s"]) * 100.0
