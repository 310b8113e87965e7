"""Attack/release envelope follower (counterpart of
``haghighatshoarmuir2024_tpu/ops/envelope.py``; reference:
micloc/utils.py:15-81).

The follower is a per-sample recurrence with no kernel behind it in either
package: here one loop over time, vectorized over channels, as the port's
IIR scan runs.  The state carries across calls.
"""
from __future__ import annotations

import numpy as np
import torch


class Envelope:
    def __init__(self, rise_time: float, fall_time: float, fs: float):
        if rise_time > fall_time:
            raise ValueError("for proper functioning, an envelope estimator should have a larger fall time!")
        self.rise_time = rise_time
        self.fall_time = fall_time
        self.fs = fs
        # [fall, rise] window lengths, indexed by the rise/fall flag
        self.win_lens = np.asarray([int(fs * fall_time), int(fs * rise_time)])

    def evolve(self, sig_in, state=None, return_state: bool = False):
        """The envelope of a ``T x C`` signal (JAX ``Envelope.evolve``):
        output ``t`` is the state before sample ``t + 1`` is absorbed; the
        update is ``(1 − 1/w)·state + (1/w)·|x|·rise`` with ``w`` the rise
        window where ``|x| ≥ state``, else the fall window.  The state starts
        at ``|x[0]|`` unless ``state`` is given; ``return_state`` also
        returns the final state, to carry into the next call."""
        x = torch.abs(torch.as_tensor(sig_in))
        win = torch.as_tensor(self.win_lens, dtype=x.dtype, device=x.device)
        s = x[0] if state is None else torch.as_tensor(state, dtype=x.dtype, device=x.device)
        out = torch.empty_like(x)
        for t in range(1, x.shape[0]):
            out[t - 1] = s
            rise = (x[t] >= s).to(x.dtype)
            w = win[0] * (1 - rise) + win[1] * rise
            s = (1 - 1 / w) * s + (1 / w) * x[t] * rise
        out[-1] = s
        return (out, s) if return_state else out
