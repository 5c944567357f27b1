"""Host time a window step in the pinned staging's spans (stage.wait,
stage.fill, stage.copy of utils/pinned.py: the buffer's event wait, the
host fill, the host-to-device enqueue; frames and masks), ms."""

from portbench.program import per_step_ms


def read(run):
    return per_step_ms(run, "stage.")
