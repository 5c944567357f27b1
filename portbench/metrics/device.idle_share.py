"""The share of a step in which nothing runs on the device, %: 1 - the
device's busy time a profiled step (the union of its kernel, copy and
memset intervals) / the mean step of the untraced window. The profiled
window's own length is not the divisor: the profiler lengthens a traced
step by 1-38% (one H100; most at B=1), so it would read idle time that the
untraced loop does not have."""


def read(run):
    if run.trace is None or not run.trace_steps or not run.steps:
        return None
    busy = run.trace["busy_s"] / run.trace_steps
    return 100.0 * (1.0 - busy / (run.window_s / run.steps))
