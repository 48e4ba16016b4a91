"""train_samples_per_s: the train rows completed in the window (every
member's, padding rows left out) over the window's wall time, from the
first step issued to the device's completion of the last; eval epochs at
epoch ends are inside it. The harness's host clock."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    w = ctx["window"]
    return w["rows"] / w["seconds"]
