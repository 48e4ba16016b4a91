"""eval_rows_per_s: the eval rows completed in the window (601 an epoch)
over the window's wall time, closed by the device's completion of the
last; the harness's host clock."""


def read(ctx):
    if ctx["kind"] != "eval":
        return None
    w = ctx["window"]
    return w["rows"] / w["seconds"]
