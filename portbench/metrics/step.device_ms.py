"""Device busy time a step over the profiled steps: the union of the
intervals of every kernel, copy and memset, ms."""


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    return run.trace["busy_s"] / run.trace_steps * 1e3
