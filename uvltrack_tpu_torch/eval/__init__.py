"""Benchmark evaluation (copies of the framework-free modules of
uvltrack_tpu/eval/): sequence containers, the dataset adapters and their
registry, the metrics, the sequential runner over a track.tracker.Tracker
and the lockstep runner over a track.batch.BatchTracker."""

from .data import Sequence, SequenceList
from .datasets import DATASET_BUILDERS, get_dataset
from . import datasets_extra  # noqa: F401  (registers otb/nfs/uav/tc128/itb/avist)
from .metrics import aggregate_scores, calc_seq_err_robust, evaluate_results_dir, sequence_curves
from .running import run_dataset, run_sequence, save_results
from .running_batched import run_dataset_batched

__all__ = [
    "Sequence", "SequenceList", "DATASET_BUILDERS", "get_dataset",
    "aggregate_scores", "calc_seq_err_robust", "evaluate_results_dir",
    "sequence_curves", "run_dataset", "run_dataset_batched", "run_sequence", "save_results",
]
