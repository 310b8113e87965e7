"""Greedy distance suppression on the card: wrappers of kernels K1, K2 and K7
(``csrc/suppress.cu``), counterparts of the public ops of
``haghighatshoarmuir2024_tpu/ops/pallas/suppress_kernel.py``.

- :func:`rzcc_encode_bipolar_tm` (``:551``): fused bipolar RZCC spike
  extraction.  K1 (``_round_kernel_bipolar_first``, ``:334``) finds the
  bounded-plateau extrema of ±cs and runs suppression round 1 of both
  polarities from one read of cs.  K2 (``_round_kernel_bipolar``, ``:248``)
  runs one more round given the active masks; it always runs once — that
  launch is the TPU kernel's fused round 2, and tiles with no candidate left
  exit after reading the masks — and then repeats until every per-tile flag
  is 0, as the TPU's fixed-point loop does (``:537-547``).
- :func:`rzcc_select_bipolar_tm` (``:639``): the same suppression from given
  extrema, on K2 alone, from ``act = extrema`` and ``kept = 0``.
- :func:`select_by_distance_tm` (``:687``): one polarity with the heights as
  their own input, on K7 (``_round_kernel``, ``:124``), repeated to the
  fixed point (``:235-245``).

A block keeps every flag of its tile as a bit, 32 consecutive samples of a
row to a word, and does the round's neighbour logic on those words; heights
are read only where candidates are.  It stages ``TB`` samples of 32 rows with
the halo :func:`_margin` on both sides, rounded up to whole words: the staged
floats and six bit planes, 4.75 bytes a sample
(``hm_rzcc_smem_bytes`` is the one formula, the kernels' and the check's).
Where the rows are a multiple of 4 and the masks 4-byte aligned, four rows'
mask bytes move as one word; otherwise byte by byte.

The flag sum is read on the host after each K2/K7 launch.  A window too wide
for a block's shared memory (``TB + 2·_margin`` beyond 1504 samples: a
``distance`` above 162 for K2/K7, above 154 for K1 at ``max_plateau`` 24)
raises ``ValueError`` (the JAX ops fall back to XLA there, ``:708-722``).
Heights that are not finite at a candidate raise ``ValueError`` before any
work: the JAX ops never finish on them.

On CPU tensors the wrappers run the plain versions in ``ops/peaks.py``; on
CUDA tensors they launch the kernels or raise.
"""
from __future__ import annotations

import collections
import math

import torch

from .. import peaks
from ._build import check, launch_counts, library, require_cuda, stream_handle

TB = 512  # time samples a block owns (a multiple of 32); its halo is _margin on both sides
SMEM_MAX = 232_448  # shared memory a Hopper block may use (227 KB)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _margin(w: int, W: int = 0, rounds: int = 1) -> int:
    """Halo (samples) that makes a tile's outputs exact (``suppress_kernel.py:96-102``):
    each round chains three w-windows and the extrema reach ``W + 1``."""
    return _round_up(W + 1 + rounds * 3 * (w + 1) + 8, 8)


def _windows(distance, max_plateau: int):
    """(w, W) as the kernels take them: the suppression half-window
    ``ceil(distance) - 1`` (no suppression below 1) and the plateau bound
    (a window of at least one boundary, as the doubling passes give)."""
    return max(int(math.ceil(distance)) - 1, 0), max(int(max_plateau), 1)


def _check_smem(M: int) -> None:
    need = library().hm_rzcc_smem_bytes(TB, M)
    if need > SMEM_MAX:
        raise ValueError(
            f"suppression halo {M} needs {need} bytes of shared memory per block "
            f"(limit {SMEM_MAX}); window too wide for the suppression kernels"
        )


def _check_finite(cand: torch.Tensor, height: torch.Tensor, label: str) -> None:
    """Raise unless every candidate's height is finite.  A non-finite
    candidate never wins a round, so unless a finite winner's window covers
    it the fixed point is never reached (the JAX ops loop forever on it)."""
    if bool((cand & ~torch.isfinite(height)).any()):
        raise ValueError(f"{label}: a candidate has a non-finite height; heights at candidates must be finite")


# ------------------------------------------------------------- plain versions
def _k1_plain(cs_tm: torch.Tensor, w: int, W: int):
    """What K1 computes: extrema of ±cs, then one round per polarity.
    Returns (act_p, act_n, kept_p, kept_n), time-major bool."""
    x = cs_tm.T
    maxima, minima = peaks.local_extrema_mask_bounded(x, W)
    ap, kp = peaks.suppression_round(maxima, torch.zeros_like(maxima), x, w)
    an, kn = peaks.suppression_round(minima, torch.zeros_like(minima), -x, w)
    return ap.T, an.T, kp.T, kn.T


def _k2_plain(cs_tm, act_p, act_n, kept_p, kept_n, w: int):
    """What one K2 launch computes: one more round per polarity."""
    x = cs_tm.T
    ap, kp = peaks.suppression_round(act_p.T, kept_p.T, x, w)
    an, kn = peaks.suppression_round(act_n.T, kept_n.T, -x, w)
    return ap.T, an.T, kp.T, kn.T


def rzcc_encode_bipolar_tm_plain(cs_tm: torch.Tensor, distance, max_plateau: int):
    """``local_extrema_mask_bounded`` then ``select_by_distance`` on each
    polarity, time-major (T, rows) in and out."""
    x = cs_tm.T
    maxima, minima = peaks.local_extrema_mask_bounded(x, int(max_plateau))
    kp = peaks.select_by_distance(maxima, x, distance)
    kn = peaks.select_by_distance(minima, -x, distance)
    return kp.T, kn.T


def _k7_plain(height_tm, act, kept, w: int):
    """What one K7 launch computes: one round of one polarity."""
    a, k = peaks.suppression_round(act.T, kept.T, height_tm.T, w)
    return a.T, k.T


def select_by_distance_tm_plain(cand_tm: torch.Tensor, height_tm: torch.Tensor, distance):
    """``select_by_distance`` on the transposed arrays: (T, rows) in and out."""
    return peaks.select_by_distance(cand_tm.T, height_tm.T, distance).T


def rzcc_select_bipolar_tm_plain(cs_tm, maxima_tm, minima_tm, distance):
    """``select_by_distance`` of (maxima, cs) and (minima, -cs), time-major."""
    x = cs_tm.T
    return (peaks.select_by_distance(maxima_tm.T, x, distance).T,
            peaks.select_by_distance(minima_tm.T, -x, distance).T)


# ------------------------------------------------------------------- kernels
def rzcc_k1(cs_tm: torch.Tensor, w: int, W: int):
    """Launch K1 once: (act_p, act_n, kept_p, kept_n) as (T, R) bool."""
    require_cuda(cs_tm, "cs_tm", (torch.float32,), 2)
    T, R = cs_tm.shape
    M = _margin(w, W, rounds=1)
    _check_smem(M)
    outs = [torch.empty((T, R), dtype=torch.bool, device=cs_tm.device) for _ in range(4)]
    with torch.cuda.device(cs_tm.device):
        rc = library().hm_rzcc_k1(
            cs_tm.data_ptr(), *(o.data_ptr() for o in outs), T, R, w, W, M, TB,
            stream_handle(cs_tm.device),
        )
    check(rc, "rzcc_k1")
    launch_counts["rzcc_k1"] += 1
    return tuple(outs)


def rzcc_k2(cs_tm, act_p, act_n, kept_p, kept_n, w: int):
    """Launch K2 once.  ``kept_p``/``kept_n`` are updated in place; returns
    the new (act_p, act_n) and the per-tile flags (int32, 1 = candidates
    remain)."""
    require_cuda(cs_tm, "cs_tm", (torch.float32,), 2)
    for name, t in (("act_p", act_p), ("act_n", act_n), ("kept_p", kept_p), ("kept_n", kept_n)):
        require_cuda(t, name, (torch.bool,), 2)
        if t.shape != cs_tm.shape or t.device != cs_tm.device:
            raise ValueError(f"{name} must match cs_tm's shape {tuple(cs_tm.shape)} and device")
    T, R = cs_tm.shape
    M = _margin(w)
    _check_smem(M)
    rb = library().hm_rzcc_rows_per_block()
    flags = torch.empty((-(-T // TB), -(-R // rb)), dtype=torch.int32, device=cs_tm.device)
    ap_out = torch.empty_like(act_p)
    an_out = torch.empty_like(act_n)
    with torch.cuda.device(cs_tm.device):
        rc = library().hm_rzcc_k2(
            cs_tm.data_ptr(), act_p.data_ptr(), act_n.data_ptr(), ap_out.data_ptr(),
            an_out.data_ptr(), kept_p.data_ptr(), kept_n.data_ptr(), flags.data_ptr(),
            T, R, w, M, TB, stream_handle(cs_tm.device),
        )
    check(rc, "rzcc_k2")
    launch_counts["rzcc_k2"] += 1
    return ap_out, an_out, flags


def rzcc_encode_bipolar_tm(cs_tm: torch.Tensor, distance, max_plateau: int):
    """Bipolar RZCC spike extraction, time-major: bounded-plateau extrema of
    ±cs and scipy-exact greedy distance suppression of each polarity.

    ``cs_tm``: (T, rows) float32.  Returns ``(kept_pos, kept_neg)`` bool masks
    of shape (T, rows), exactly ``select_by_distance`` of
    ``local_extrema_mask_bounded(cs, max_plateau)`` on (maxima, cs) and
    (minima, -cs).
    """
    return rzcc_encode_bipolar_tm_finish(rzcc_encode_bipolar_tm_launch(cs_tm, distance, max_plateau))


def rzcc_encode_bipolar_tm_launch(cs_tm: torch.Tensor, distance, max_plateau: int):
    """The first half of :func:`rzcc_encode_bipolar_tm`: K1 and the first K2
    round launched, the host not yet waiting on the card.  Pass the result
    to :func:`rzcc_encode_bipolar_tm_finish`, which reads K2's flags; between
    the two a caller may launch other cards' work (a sharded step)."""
    if cs_tm.device.type == "cpu":
        return rzcc_encode_bipolar_tm_plain(cs_tm, distance, max_plateau)
    w, W = _windows(distance, max_plateau)
    act_p, act_n, kept_p, kept_n = rzcc_k1(cs_tm, w, W)
    act_p, act_n, flags = rzcc_k2(cs_tm, act_p, act_n, kept_p, kept_n, w)
    return _PendingRZCC(cs_tm, w, act_p, act_n, kept_p, kept_n, flags)


def rzcc_encode_bipolar_tm_finish(pending):
    """``(kept_pos, kept_neg)`` of a launched encode: K2 rounds until its
    flags say no candidate is left, each read on the host."""
    if not isinstance(pending, _PendingRZCC):  # the CPU's plain result
        return pending
    cs_tm, w, act_p, act_n, kept_p, kept_n, flags = pending
    # every round keeps at least the rightmost window-max of each row that
    # still has candidates, so T + 1 rounds always reach the fixed point
    for _ in range(cs_tm.shape[0]):
        if not bool(flags.any()):
            return kept_p, kept_n
        act_p, act_n, flags = rzcc_k2(cs_tm, act_p, act_n, kept_p, kept_n, w)
    if not bool(flags.any()):
        return kept_p, kept_n
    raise RuntimeError("RZCC suppression did not reach its fixed point")


_PendingRZCC = collections.namedtuple("_PendingRZCC", "cs_tm w act_p act_n kept_p kept_n flags")


def suppress_k7(height_tm: torch.Tensor, act: torch.Tensor, kept: torch.Tensor, w: int):
    """Launch K7 once.  ``kept`` is updated in place; returns the new
    ``act`` and the per-tile flags (int32, 1 = candidates remain)."""
    require_cuda(height_tm, "height_tm", (torch.float32,), 2)
    for name, t in (("act", act), ("kept", kept)):
        require_cuda(t, name, (torch.bool,), 2)
        if t.shape != height_tm.shape or t.device != height_tm.device:
            raise ValueError(f"{name} must match height_tm's shape {tuple(height_tm.shape)} and device")
    T, R = height_tm.shape
    M = _margin(w)
    _check_smem(M)
    rb = library().hm_rzcc_rows_per_block()
    flags = torch.empty((-(-T // TB), -(-R // rb)), dtype=torch.int32, device=height_tm.device)
    act_out = torch.empty_like(act)
    with torch.cuda.device(height_tm.device):
        rc = library().hm_suppress_k7(
            height_tm.data_ptr(), act.data_ptr(), act_out.data_ptr(), kept.data_ptr(),
            flags.data_ptr(), T, R, w, M, TB, stream_handle(height_tm.device),
        )
    check(rc, "suppress_k7")
    launch_counts["suppress_k7"] += 1
    return act_out, flags


def select_by_distance_tm(cand_tm: torch.Tensor, height_tm: torch.Tensor, distance) -> torch.Tensor:
    """Time-major greedy distance suppression: (T, rows) candidates (any
    dtype, nonzero = candidate) and heights in, (T, rows) bool out; exactly
    ``ops.peaks.select_by_distance`` on the transposed arrays.  Heights are
    taken as float32, as the Pallas op takes them."""
    w = _windows(distance, 1)[0]
    cand = cand_tm != 0
    if w <= 0:
        return cand
    height = height_tm.to(torch.float32).contiguous()
    _check_finite(cand, height, "select_by_distance_tm")
    if cand.device.type == "cpu":
        return select_by_distance_tm_plain(cand, height, distance)
    act, kept = cand.contiguous(), torch.zeros_like(cand)
    # every round keeps at least the rightmost window-max of each row that
    # still has candidates, so T rounds always reach the fixed point
    for _ in range(cand.shape[0] + 1):
        act, flags = suppress_k7(height, act, kept, w)
        if not bool(flags.any()):
            return kept
    raise RuntimeError("suppression did not reach its fixed point")


def rzcc_select_bipolar_tm(cs_tm: torch.Tensor, maxima_tm: torch.Tensor, minima_tm: torch.Tensor,
                           distance):
    """Bipolar RZCC suppression from given extrema, time-major: returns
    ``(kept_pos, kept_neg)`` bool masks of shape (T, rows), exactly
    ``select_by_distance`` of (maxima, cs) and (minima, -cs), cs taken as
    float32.  One read of cs serves both polarities in each K2 launch."""
    w = _windows(distance, 1)[0]
    act_p, act_n = maxima_tm != 0, minima_tm != 0
    if w <= 0:
        return act_p, act_n
    cs = cs_tm.to(torch.float32).contiguous()
    _check_finite(act_p | act_n, cs, "rzcc_select_bipolar_tm")
    if cs.device.type == "cpu":
        return rzcc_select_bipolar_tm_plain(cs, act_p, act_n, distance)
    act_p, act_n = act_p.contiguous(), act_n.contiguous()
    kept_p, kept_n = torch.zeros_like(act_p), torch.zeros_like(act_n)
    for _ in range(cs.shape[0] + 1):
        act_p, act_n, flags = rzcc_k2(cs, act_p, act_n, kept_p, kept_n, w)
        if not bool(flags.any()):
            return kept_p, kept_n
    raise RuntimeError("RZCC suppression did not reach its fixed point")
