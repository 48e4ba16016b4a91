"""gemm_roofline.train: the bound of the step's products outside the text
encoder's attention (each max(operations / peak of its dtype, bytes /
bandwidth), counted by ``counts``) over the device time of the GEMM kernels
(cuBLAS's, by the name patterns below) in the profiled span, in percent."""
import re

from . import counts

NAMES = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitK|sgemm|dot_kernel", re.IGNORECASE)
OURS = re.compile(r"attn_|dp_(fwd|bwd)")


def read(ctx):
    span = ctx["span"]
    if ctx["kind"] != "train" or span is None:
        return None
    busy = sum(e - s for name, s, e in span["kernels"]
               if NAMES.search(name) and not OURS.search(name)) * 1e-6
    if busy == 0:
        return None
    cfg, S = ctx["config"], ctx["seq_len"]
    rows = span["rows"] // span["steps"] // ctx["members"]  # one member's step
    bound = sum(counts.product_bound_s(cfg, p) for p in counts.step_products(cfg, S, rows)
                if p[4] != counts.ATTN)
    return bound * ctx["members"] * span["steps"] / busy * 100.0
