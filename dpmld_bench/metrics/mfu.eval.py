"""mfu.eval: the operations of the window's eval forwards over their real
rows (counted by ``counts``), over the window's seconds and the peak of the
configuration's precision, in percent."""
from . import counts


def read(ctx):
    if ctx["kind"] != "eval":
        return None
    cfg, w = ctx["config"], ctx["window"]
    ops = counts.eval_flops(cfg, ctx["seq_len"], 1) * w["rows"]
    return ops / w["seconds"] / counts.peak_flops(cfg["program"]["compute_dtype"]) * 100.0
