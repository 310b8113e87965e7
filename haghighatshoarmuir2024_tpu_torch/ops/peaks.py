"""Peak detection with scipy ``find_peaks(distance=...)`` semantics — the
plain PyTorch versions of what kernels K1/K2 compute, and the design path's
``find_peaks_mask`` (counterpart of ``haghighatshoarmuir2024_tpu/ops/peaks.py``;
reference: micloc/spike_encoder.py:115-137).

All functions work along the last axis with any leading batch dims, like
the JAX originals, and are bit-exact with them:

* :func:`local_extrema_mask_bounded` — plateau-midpoint maxima and minima
  with the plateau search bounded to ``max_plateau`` samples, from one pass
  over sign-encoded boundary indices (``2·i + 1`` rise, ``2·i`` fall);
* :func:`local_maxima_mask` — the same maxima with no bound on the plateau;
* :func:`select_by_distance` — scipy's greedy height-ordered suppression as a
  fixed point of rounds: window-maxima win, exact ties go to the rightmost
  index, winners delete their window, repeat until no candidates remain;
* :func:`find_peaks_mask` — candidates, then the suppression;
* :func:`top_k_peaks` — the k highest peaks, for the multi-source pickers.
"""
from __future__ import annotations

import math

import torch

_INT32_MAX = 2**31 - 1


def _shift(v: torch.Tensor, k: int, fill) -> torch.Tensor:
    """``out[..., i] = v[..., i - k]`` (k > 0 moves toward higher indices),
    ``fill`` where the source is out of range."""
    k = max(-v.shape[-1], min(v.shape[-1], k))
    if k == 0:
        return v
    pad = torch.full(v.shape[:-1] + (abs(k),), fill, dtype=v.dtype, device=v.device)
    if k > 0:
        return torch.cat([pad, v[..., :-k]], dim=-1)
    return torch.cat([v[..., -k:], pad], dim=-1)


def _running(v: torch.Tensor, L: int, fill, op, direction: int) -> torch.Tensor:
    """``op`` over the trailing window ``[i-L+1, i]`` (direction=+1) or the
    leading window ``[i, i+L-1]`` (direction=-1), by log-step doubling."""
    y = v
    k = 1
    while k < L:
        step = min(k, L - k)
        y = op(y, _shift(y, direction * step, fill))
        k += step
    return y


def _window_max(v: torch.Tensor, w: int) -> torch.Tensor:
    """Max over the centered window ``[i-w, i+w]``; out-of-range is ignored."""
    fill = -math.inf if v.is_floating_point() else torch.iinfo(v.dtype).min
    y = _running(v, w + 1, fill, torch.maximum, +1)
    return _running(y, w + 1, fill, torch.maximum, -1)


def local_extrema_mask_bounded(x: torch.Tensor, max_plateau: int):
    """Bounded-plateau local maxima AND minima of ``x`` along the last axis.

    A position p is a maximum iff the nearest boundary (nonzero diff) within
    ``max_plateau`` before it is a rise, the nearest at/after it within
    ``max_plateau`` is a fall, and p is the midpoint ``(l + r) >> 1`` of the
    run between them (scipy ``_local_maxima_1d``); minima flip the rise/fall
    test.  Returns ``(maxima, minima)`` bool masks of ``x``'s shape.
    """
    T = x.shape[-1]
    W = int(max_plateau)
    d = torch.sign(x[..., 1:] - x[..., :-1])
    idx = torch.arange(T - 1, dtype=torch.int32, device=x.device)
    code = 2 * idx + (d == 1).to(torch.int32)
    enc = torch.where(d != 0, code, torch.full_like(code, -1))
    encN = torch.where(d != 0, code, torch.full_like(code, _INT32_MAX))

    last = _running(enc, W, -1, torch.maximum, +1)
    edge = x.shape[:-1] + (1,)
    last = torch.cat([last.new_full(edge, -1), last], dim=-1)  # strictly before p
    nxt = _running(encN, W, _INT32_MAX, torch.minimum, -1)
    nxt = torch.cat([nxt, nxt.new_full(edge, _INT32_MAX)], dim=-1)

    has_last = last >= 0
    last_rise = has_last & ((last & 1) == 1)
    has_next = nxt < _INT32_MAX
    next_fall = has_next & ((nxt & 1) == 0)
    l = (last >> 1) + 1
    r = nxt >> 1
    p = torch.arange(T, dtype=torch.int32, device=x.device)
    mid_ok = p == ((l + r) >> 1)
    maxima = last_rise & next_fall & mid_ok
    minima = has_last & ~last_rise & has_next & ~next_fall & mid_ok
    return maxima, minima


def suppression_round(active: torch.Tensor, kept: torch.Tensor, height: torch.Tensor, w: int):
    """One greedy suppression round: returns the new ``(active, kept)``.

    A candidate is a window-max if its height equals the max over the active
    heights in ``[i-w, i+w]``; two window-maxima within w tie exactly, so the
    rightmost wins (no window-max strictly to its right within w).  Winners
    are kept and clear every candidate inside their window.
    """
    T = active.shape[-1]
    h = torch.where(active, height, torch.full_like(height, -math.inf))
    top = active & (h == _window_max(h, w)) & torch.isfinite(h)
    idx = torch.arange(T, dtype=torch.int32, device=active.device)
    tid = torch.where(top, idx, torch.full_like(idx, -1))
    winner = top & (_window_max(tid, w) == idx)
    in_win = _window_max(winner.to(torch.int8), w) > 0
    return active & ~in_win, kept | winner


def select_by_distance(cand_mask: torch.Tensor, height: torch.Tensor, distance) -> torch.Tensor:
    """Greedy height-ordered distance suppression (scipy
    ``_select_by_peak_distance``) along the last axis: candidates closer than
    ``ceil(distance)`` samples to a higher kept peak are removed."""
    w = int(math.ceil(distance)) - 1
    if w <= 0:
        return cand_mask
    height = height.to(torch.float32) if not height.is_floating_point() else height
    active, kept = cand_mask, torch.zeros_like(cand_mask)
    while True:
        active, kept = suppression_round(active, kept, height, w)
        if not bool(active.any()):
            return kept


def local_maxima_mask(x: torch.Tensor) -> torch.Tensor:
    """scipy-style local maxima (plateau midpoints) along the last axis with
    no bound on the plateau length (JAX ``peaks.py:41-81``): the run of equal
    values around p is ``[l, r]``, l − 1 the last nonzero diff before p
    (forward cummax of marked indices) and r the next at/after p (reverse
    cummin); p is a peak iff the run rises into it, falls out of it, and
    ``p == (l + r) // 2``.  Signal edges fail the rise/fall test."""
    T = x.shape[-1]
    d = torch.sign(x[..., 1:] - x[..., :-1])
    idx = torch.arange(T - 1, dtype=torch.int32, device=x.device).expand_as(d)
    none = torch.full_like(idx, -1)
    big = torch.full_like(idx, T)
    last_pos = torch.cummax(torch.where(d == 1, idx, none), dim=-1).values
    last_neg = torch.cummax(torch.where(d == -1, idx, none), dim=-1).values
    rev_cummin = lambda v: torch.cummin(v.flip(-1), dim=-1).values.flip(-1)
    next_pos = rev_cummin(torch.where(d == 1, idx, big))
    next_neg = rev_cummin(torch.where(d == -1, idx, big))
    edge = x.shape[:-1] + (1,)
    last_pos = torch.cat([last_pos.new_full(edge, -1), last_pos], dim=-1)
    last_neg = torch.cat([last_neg.new_full(edge, -1), last_neg], dim=-1)
    next_pos = torch.cat([next_pos, next_pos.new_full(edge, T)], dim=-1)
    next_neg = torch.cat([next_neg, next_neg.new_full(edge, T)], dim=-1)
    p = torch.arange(T, dtype=torch.int32, device=x.device)
    mid = torch.div(last_pos + 1 + next_neg, 2, rounding_mode="floor")
    return (last_pos > last_neg) & (next_neg < next_pos) & (p == mid)


def find_peaks_mask(x: torch.Tensor, distance=None, max_plateau=None) -> torch.Tensor:
    """``scipy.signal.find_peaks(x, distance=d)`` along the last axis as a
    bool mask (JAX ``peaks.py:291-306``); ``max_plateau`` bounds the plateau
    search (exact for continuous-valued signals)."""
    if max_plateau is None:
        cand = local_maxima_mask(x)
    else:
        cand = local_extrema_mask_bounded(x, max_plateau)[0]
    if distance is None or distance <= 1:
        return cand
    return select_by_distance(cand, x, distance)


def top_k_peaks(x: torch.Tensor, k: int, distance=None, max_plateau=None, rel_height: float = 0.0):
    """The ``k`` highest peaks of a profile along its last axis, (G,) or
    batched (B, G) (JAX ``peaks.py:309-338``; the multi-target harnesses of
    the reference pick the best-separated maxima by hand,
    paper_plots/multiple_targets_snn.py:194-246): :func:`find_peaks_mask`
    with ``distance``/``max_plateau``, peaks below ``rel_height`` times the
    row's maximum dropped, then the ``k`` highest survivors.

    Returns ``(idx, height, valid)``, each (..., k).  Equal heights come
    lower index first, as ``lax.top_k`` gives them: the selection is a
    stable descending sort.  Entries past the last peak have
    ``valid=False``, ``idx=0`` and height ``-inf``."""
    mask = find_peaks_mask(x, distance=distance, max_plateau=max_plateau)
    if rel_height > 0.0:
        mask = mask & (x >= rel_height * x.amax(dim=-1, keepdim=True))
    xf = x if x.is_floating_point() else x.to(torch.float32)
    vals = torch.where(mask, xf, torch.full_like(xf, -math.inf))
    height, idx = torch.sort(vals, dim=-1, descending=True, stable=True)
    height, idx = height[..., :k], idx[..., :k]
    valid = torch.isfinite(height)
    return torch.where(valid, idx, torch.zeros_like(idx)), height, valid
