"""Seconds from the process's start to the window: imports, the kernels'
build or load, the inputs made from the seed, the warm drain."""


def read(run):
    return run.get("setup_s")
