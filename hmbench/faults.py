"""Faults planted in the timed path underneath a run, to show that ``correct``
comes out false for each fault a cell can have (``tests/test_hmbench_faults.py``
on the CPU; ``python3 -m hmbench.control --fault <name>`` reads them on the
card).  Each is a context manager that patches the port while it is open."""
from __future__ import annotations

import contextlib
import math


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _turned(doa):
    import torch

    return torch.remainder(doa, 2 * math.pi) - math.pi  # half a circle away


def doa_turned():
    """Every DoA the entry hands back turned half a circle: an answer altered
    where it is produced."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo.pipeline import Demo
    from haghighatshoarmuir2024_tpu_torch.runtime.streaming import StreamingLocalizer

    stack = contextlib.ExitStack()

    def batch(orig):
        def f(self, x, method="peak"):
            doa, rate = orig(self, x, method)
            return _turned(doa), rate
        return f

    def stream(orig):
        return lambda self, state, method="peak": _turned(orig(self, state, method))

    stack.enter_context(_patched(Demo, "forward_batch", batch))
    stack.enter_context(_patched(StreamingLocalizer, "estimate_doa", stream))
    return stack


def half_batch():
    """Half of each batch left out: the first half computed, its answers
    handed back for the rest too."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo.pipeline import Demo

    def batch(orig):
        def f(self, x, method="peak"):
            doa, rate = orig(self, x[: x.shape[0] // 2], method)
            return doa.repeat(2), rate.repeat(2, 1)
        return f

    return _patched(Demo, "forward_batch", batch)


def state_unchanged():
    """A stream step that hands back the state it was given."""
    from haghighatshoarmuir2024_tpu_torch.runtime.streaming import StreamingLocalizer

    def finish(orig):
        def f(self, launched):
            _, kp, kn = orig(self, launched)
            return launched[0], kp, kn
        return f

    return _patched(StreamingLocalizer, "_step_finish", finish)


FAULTS = {"doa_turned": doa_turned, "half_batch": half_batch, "state_unchanged": state_unchanged}
