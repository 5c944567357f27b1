"""The blocks' weight products (qkv, projection, fc1, fc2) at their roofline
bound, as a share of the device time of the kernels roles/linear/ names, %."""

from portbench.readers import roofline


def read(run):
    return roofline(run, "linear")
