"""The median host time of a stream step (upload, ``process_chunk``,
``estimate_doa``, DoAs on the host) in the traced window: a steadier
statistic than the tail beside it."""
import numpy as np


def read(view):
    return float(np.median(view.step_ms)) if view.step_ms else None
