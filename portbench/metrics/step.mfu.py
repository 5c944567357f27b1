"""The whole step's share of the card's bf16 dense peak: the frozen
operations of a tracked frame times the stream-frames of the window, over
the window, over the peak (costs/peaks.json), %."""

from portbench.costs.arith import PEAKS, frame_flops


def read(run):
    if not run.window_s:
        return None
    return 100.0 * frame_flops(run.dims) * run.stream_frames / run.window_s / PEAKS["bf16_flops_per_s"]
