"""The re-mine region: device wall time between the marks around
remine_body inside the re-mine graph (utils/tracing.py), the gaps between
its kernels included; mean a re-mine replay in the window, ms."""

from portbench.program import region_ms


def read(run):
    return region_ms(run, "remine", "remine")
