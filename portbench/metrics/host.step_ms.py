"""Mean host time of the port's `step` span (LockstepTracker._graph_step:
the frames' and masks' staging, the state loads, the graph replays, the
clones out) over the untraced window's steps, ms: host.enqueue_ms timed
from inside the program."""

from portbench.program import per_step_ms


def read(run):
    return per_step_ms(run, "step")
