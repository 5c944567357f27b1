"""Seconds of set-up inside the program's set-up spans (setup.kernels,
setup.prepare, setup.initialize, setup.capture; their union) before the
window."""

from portbench.program import setup_s


def read(run):
    return setup_s(run)
