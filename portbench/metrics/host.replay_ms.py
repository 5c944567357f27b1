"""Host time a window step in the CUDA graph launches (replay.step,
replay.remine), ms."""

from portbench.program import per_step_ms


def read(run):
    return per_step_ms(run, "replay.")
