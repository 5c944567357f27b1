"""Mean host time of a step's call into the port until it returns with the
step enqueued (pinned staging of the frames, the graph replays), before
the read-back; over the window's steps (the profiled steps left out), ms."""


def read(run):
    return sum(run.enq_s) / len(run.enq_s) * 1e3 if run.enq_s else None
