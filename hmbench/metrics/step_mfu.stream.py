"""The whole step's share (%) of the chip's peak: its kernels' least time at
the peaks (``hmbench/roofline.py``) over the wall time a step."""
from hmbench.layers import step_mfu_pct


def read(view):
    return step_mfu_pct(view)
