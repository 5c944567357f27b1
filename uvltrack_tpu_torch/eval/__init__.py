"""Benchmark runners (copies of the framework-free modules of
uvltrack_tpu/eval/): sequence containers, the sequential runner over a
track.tracker.Tracker and the lockstep runner over a track.batch.BatchTracker."""

from .data import Sequence, SequenceList
from .running import run_dataset, run_sequence, save_results
from .running_batched import run_dataset_batched

__all__ = ["Sequence", "SequenceList", "run_dataset", "run_dataset_batched", "run_sequence",
           "save_results"]
