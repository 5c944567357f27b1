"""Stream-frames completed in the window over the window's seconds."""


def read(run):
    return run.stream_frames / run.window_s
