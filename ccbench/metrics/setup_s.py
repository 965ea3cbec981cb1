"""Seconds from the moment PyTorch is loaded and the CUDA context made
to the start of the window: the program's import, the generation of the
data, the session and the warm-up (host clock)."""


def read(ctx):
    return ctx["setup_s"]
