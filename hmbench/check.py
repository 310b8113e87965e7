"""The numbers that decide ``correct``: what the timed path produced against
the plain reference (``reference/localizer.py``) on the same inputs.

- ``rate_gap`` (offline) / ``count_gap`` (streams): the summed absolute
  difference of the program's rates (its carried counts) from the
  reference's, over the reference's sum.  The RZCC spikes and the integer
  LIF are exact functions of the encode, so a sound float32 encode moves a
  count only where a peak of the integrated signal lies within float32
  rounding of its neighbour.
- ``score_gap``: the widest gap by which the reference's matched score at
  the program's DoA lies below the reference's best score (cosines).
- ``repeat_diff`` (offline): DoAs of a repeated batch that differ from that
  batch's last call in the window.
"""
from __future__ import annotations

import numpy as np

from .reference import localizer as ref


def draw(ctx, n: int, k: int) -> list:
    """``k`` of ``n`` indices drawn from the seed (the batches, groups or
    streams whose answers the reference checks), apart from the traffic's
    audio."""
    return sorted(np.random.default_rng([int(ctx.seed) % (2**63), 1]).choice(n, size=k, replace=False).tolist())


def grid_index(model: ref.Model, doa) -> np.ndarray:
    """The grid rows of DoAs that the program took from the grid."""
    d = np.asarray(doa, np.float64).reshape(-1)
    return np.abs(model.grid[None, :] - d[:, None]).argmin(axis=1)


def score_gap(model: ref.Model, ref_rates: np.ndarray, doa) -> float:
    """The widest gap, over the rows of ``ref_rates`` (..., F·G), between the
    reference's best matched score and its score at the program's DoA."""
    s = ref.scores(model, ref_rates).reshape(-1, len(model.grid))
    idx = grid_index(model, doa)
    return float((s.max(axis=1) - s[np.arange(len(idx)), idx]).max())


def relative_gap(got: np.ndarray, want: np.ndarray) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).sum() / max(want.sum(), 1e-300))


def offline(model: ref.Model, prog_folded: np.ndarray, prog_doa: np.ndarray, ref_rates: np.ndarray) -> dict:
    """``rate_gap`` and ``score_gap`` of (B, G) folded rates and (B,) DoAs
    against the reference's unfolded (B, F·G) rates."""
    return {"rate_gap": relative_gap(prog_folded, ref.folded(model, ref_rates)),
            "score_gap": score_gap(model, ref_rates, prog_doa)}


def stream(model: ref.Model, prog_counts: np.ndarray, prog_doa: np.ndarray, ref_counts: np.ndarray) -> dict:
    """``count_gap`` and ``score_gap`` of the carried (steps, S, N) counts
    and (steps, S) DoAs after each of a stream's first steps."""
    return {"count_gap": relative_gap(prog_counts, ref_counts),
            "score_gap": score_gap(model, ref_counts.astype(np.float64), prog_doa)}


def control_offline(model: ref.Model, x, device, ref_rates: np.ndarray) -> dict:
    """The control's numbers: the reference put in the program's place,
    computed in the next precision below the configuration's (float32 with
    the FIR's operands in TF32), its DoA the argmax of its own scores."""
    import torch

    got, _ = ref.offline_rates(model, x, device, dtype=torch.float32, tf32=True)
    doa = model.grid[ref.scores(model, got).argmax(axis=-1)]
    return offline(model, ref.folded(model, got), doa, ref_rates)


def control_stream(model: ref.Model, chunks, steps: int, device, ref_counts: np.ndarray, before: int = 0) -> dict:
    """:func:`control_offline` for the carried counts of streams after each
    of their ``steps`` first steps, the first ``before`` left out as the
    cell leaves them out."""
    import torch

    got, _ = ref.stream_counts(model, chunks, steps, device, dtype=torch.float32, tf32=True)
    got, want = got[before:], ref_counts[before:]
    doa = model.grid[ref.scores(model, got.astype(np.float64)).argmax(axis=-1)]
    return stream(model, got, doa, want)
