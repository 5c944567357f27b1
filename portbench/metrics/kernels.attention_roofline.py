"""The blocks' attention (4 B H N^2 D operations; bf16 qkv in, output out,
fp32 key bias) at its roofline bound, as a share of the device time of the
kernels roles/attention/ names, %."""

from portbench.readers import roofline


def read(run):
    return roofline(run, "attention")
