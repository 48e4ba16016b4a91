"""attn_roofline.train: the text encoder's attention calls' bound,
max(operations / peak, bytes / bandwidth) at the cell's shapes, over the
device time of the attention kernels in the profiled span, in percent."""
from . import attn_kernels


def read(ctx):
    if ctx["kind"] != "train" or ctx["span"] is None:
        return None
    return attn_kernels.share(ctx, train=True)
