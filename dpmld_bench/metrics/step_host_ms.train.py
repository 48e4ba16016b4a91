"""step_host_ms.train: the harness's host clock around each step call of
the window (the batch's gather, ``train_step``, and at an epoch's end its
eval epoch), summed and over the steps."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    w = ctx["window"]
    return w["step_host_s"] / w["steps"] * 1e3
