"""mfu.train: the operations the window's work requires (each step's two
forwards and two backwards over its real rows, and each eval epoch's
forward, counted by ``counts``), over the window's seconds and the peak
of the configuration's precision, in percent."""
from . import counts


def read(ctx):
    if ctx["kind"] != "train":
        return None
    cfg, S, w = ctx["config"], ctx["seq_len"], ctx["window"]
    ops = counts.step_flops(cfg, S, 1) * w["rows"]
    ops += counts.eval_flops(cfg, S, ctx["traffic"]["n_eval"]) * w["evals"] * ctx["members"]
    peak = counts.peak_flops(cfg["program"]["compute_dtype"])
    return ops / w["seconds"] / peak * 100.0
