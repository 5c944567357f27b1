"""The 90th percentile of every step's latency in the window (host clock,
from the call to the boxes on the host), ms."""

import numpy as np


def read(run):
    return float(np.percentile(run.lat_s, 90)) * 1e3 if run.lat_s else None
