"""launches_per_step.train: the host's kernel-launch runtime calls
(cudaLaunchKernel, cuLaunchKernel and their Ex forms) in the profiled span,
over its train steps."""


def read(ctx):
    span = ctx["span"]
    if ctx["kind"] != "train" or span is None:
        return None
    return span["launches"] / span["steps"]
