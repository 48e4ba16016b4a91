"""setup_s: process start to the window's first step (imports, CUDA init,
loading or building the kernel library, rows, weights, the first steps or
eval epochs); the harness's host clock."""


def read(ctx):
    return ctx["setup_s"]
