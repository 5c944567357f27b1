"""Seconds from the process's start to the window's: imports, CUDA init,
the kernels' build or load, weights from the seed, the frame bank,
initialize, the stagger and the warm-up steps (graph captures)."""


def read(run):
    return run.setup_s
