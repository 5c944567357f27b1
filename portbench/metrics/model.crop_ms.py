"""The step's crop region: device wall time between the marks that bound
it inside the step graph (utils/tracing.py), the gaps between its kernels
included; mean a step-graph replay in the window, ms."""

from portbench.program import region_ms


def read(run):
    return region_ms(run, "step", "crop")
