"""Set-up seconds: from the process's start to the window's (imports,
CUDA start, kernels loaded or built, inputs made, warm-up, ``open``)."""


def read(run):
    """Host clock, seconds."""
    return run.setup_s
