"""The port's training dataset adapters (copies of uvltrack_tpu/data/datasets/)."""

from .base import BaseVideoDataset, opencv_loader
from .image_datasets import CocoSeq, RefCocoSeq
from .video_datasets import Got10k, Lasot, LasotExt, Otb99, Tnl2k, TrackingNet

__all__ = ["BaseVideoDataset", "opencv_loader", "CocoSeq", "RefCocoSeq",
           "Got10k", "Lasot", "LasotExt", "Otb99", "Tnl2k", "TrackingNet"]
