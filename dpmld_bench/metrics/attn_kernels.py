"""The attention kernels of the program, by name (``csrc/attention_bf16.cu``,
``csrc/attention_f32.cu``), and their bound over a profiled span."""
import re

from . import counts

NAMES = re.compile(r"attn_(fwd|delta|dq|dkdv)_(bf16|f32)_kernel")


def share(ctx, train: bool):
    """The attention calls' bound over the span's rows, over the device time
    of the attention kernels, in percent; None without such kernels."""
    span = ctx["span"]
    busy = sum(e - s for name, s, e in span["kernels"] if NAMES.search(name)) * 1e-6
    if busy == 0:
        return None
    cfg, S = ctx["config"], ctx["seq_len"]
    rows = span["rows"] // span["steps"]  # a step's (or an eval epoch's) rows
    fwd, bwd = counts.attention_calls(cfg, train)
    bound = fwd * counts.attention_bound_s(cfg, S, rows, True)
    bound += bwd * counts.attention_bound_s(cfg, S, rows, False)
    return bound * span["steps"] / busy * 100.0
